#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from anywhere inside a checkout: ``python3 chip_smoke.py``. It puts
``src`` on ``sys.path`` itself, builds the hand-written CUDA kernels from
``src/repro_torch/csrc`` (``build/kernels/``), and then, with TF32 off for
both matrix products and cuDNN:

1. prints the card, its power limit, the toolchain and the build time;
2. holds the GEMM kernel against its plain version at main-path shapes
   and at the edges of its split-K loop (``csrc/tile_gemm_async.cuh``) on
   every tile the wrapper takes: M = K = N = 1, 17x33x9, K 70, 5b/1x1 and
   incC's 1x1 at bucket 1 (the deepest splits), operands one float off
   alignment, each with its number of K slices; two calls of a split
   product must be equal bit for bit; phase 1 prints each kernel's ptxas
   registers, spills and shared memory, per template instantiation;
3. holds the implicit-GEMM conv kernel (the same loop, A gathered from
   NHWC) against its plain version: the GoogleNet stem, a 3x3 SAME, a
   VALID and a 5x5 case, then on every tile the wrapper takes K 27,
   Inception-v4's stem/c1, a 1x1 on a 7x7 map and a 3x3 1536 -> 256 on an
   8x8 map at batch 1 (split K), Cout 30, weights one float off
   alignment and M = K = N = 1, each with its K slices; two calls of a
   split conv must be equal bit for bit;
4. runs full-width GoogleNet (224x224, scale 1.0; random weights from a
   seed) planned by the port's planner, kernels vs the plain path on the
   card, at every bucket with layout elision and once without. Each
   compiled program runs three times on one input — the eager warm pass,
   the CUDA-graph capture and a replay: the launch counters must read
   every kernel's launches per forward, as the lowering gives them, on
   the first two and 0 on the replay, both later outputs must equal the
   eager one bit for bit, and the profiler must find those launches,
   kernel by kernel, in one replay;
5. serves distinct requests through the port's ``CNNServingEngine`` (the
   main path: every count is reset before the engine is built, and its
   warm-up's eager and capture passes are the launches reported; the
   replayed ticks move no counter, and the profiler must find each
   kernel's launches per tick in them) and checks every result against a
   per-image plain forward;
6. times each kernel, its plain version and the library call at the
   main-path shapes beside the card's bound (the split 5b/1x1 GEMM also by
   queued launches: device time without host gaps; the conv at the
   GoogleNet stem, VGG16's conv0_0 and Inception-v4's stem/c1, bucket 8),
   and the replayed forward per bucket: CUDA events, device busy under the
   profiler, its share of the forward, and the memory reserved;
7. holds the four Winograd kernels (input transform from NHWC and from
   stored tiles, batched GEMM, output transform) against their plain
   versions at VGG16 shapes, F(2,3) and F(4,3), ragged cases included, the
   batched GEMM also on every tile at G 1, M = K = N = 1, N 30, B one
   float off alignment and Inception-v4's incA shape, and whole Winograd
   convs (3x3 and a 5x5 multi-round) against ``F.conv2d``;
8. runs full-width VGG16 (224x224, scale 1.0) under its exact plan of 8
   im2col + 5 Winograd F(4,3) layers, kernels vs the plain path on the
   card, at every bucket with layout elision and once without, and checks
   the launches of every kernel per forward;
9. serves distinct requests of VGG16 through ``CNNServingEngine`` and
   checks every result against a per-image plain forward;
10. times the Winograd kernels at VGG16's conv0_1 and conv2_1 (bucket 8)
    beside their bounds, the batched GEMM there and at Inception-v4's
    incA0/b4c (buckets 1 and 8) against ``torch.bmm`` by events and by
    queued launches, the transforms and their library calls also by
    profiler device time, each Winograd layer as the three-kernel sum vs
    cuDNN vs this port's im2col kernel, and the VGG16 forward per bucket;
11. holds the two kn2row kernels (unit-conv GEMMs, pad-and-accumulate)
    against their plain versions at Inception-v4 shapes (bucket 8), ragged
    tiles, 1x3 / 3x1 SAME pads, G = 1 and all four epilogues, the split
    unit-conv GEMMs (G 3 M 512 K 512 N 256, G 9 on a ragged M) on every
    tile, bit-identical from call to call, pad-and-accumulate at the edges
    of its paths (``PA_EDGE_CASES``: C 30 and p one float off alignment on
    the one-channel path, batch 1, the generic 1x7 / 7x1 / 5x5 offsets,
    SAME at stride 2 on an odd map; each case's path printed), and whole
    kn2row convs against ``F.conv2d`` on the reference's seven cases at
    batch 1 and 3;
12. runs full-width Inception-v4 (299x299, scale 1.0, 4/7/3 blocks) under
    its exact plan of 117 im2col + 16 kn2row + 16 Winograd F(4,3) layers,
    kernels vs the plain path on the card, at every bucket with layout
    elision and once without, and checks the launches of all eight kernels
    per forward;
13. serves distinct Inception-v4 requests through ``CNNServingEngine`` and
    checks every result against a per-image plain forward;
14. times the unit-conv GEMMs at stem/c4, stem/c5 and incC0/b4d (bucket 8)
    beside their bounds and library calls, pad-and-accumulate at every
    distinct launch of the f32 forward at buckets 1 and 8
    (``time_pad_accumulate``: events, queued launches and profiler device
    time beside the bound and the grouped ``F.conv2d``, and the sums
    weighted by launches), each distinct kn2row layer as
    the two-kernel sum vs cuDNN vs this port's im2col kernel, the
    Inception-v4 forward per bucket, and every distinct Toeplitz GEMM of
    its f32 lowering at buckets 1 and 8 against ``torch.matmul`` and its
    bound (the ten slowest, and the sums weighted by launches);
15. holds the four int8 kernels (int8 GEMM, int8 implicit-GEMM conv, int8
    unit-conv GEMMs with exact int32 partials, int32 pad-and-accumulate)
    against their plain versions at Inception-v4's int8 shapes (bucket 8)
    and on a ragged G 3, M 333, K 70, N 100 over all four tiles, f32 and
    requantized int8 outputs, all four epilogues, and the three kernels on
    the int8 tensor cores (``csrc/tile_mma_i8.cuh``) at the edges of their
    mma.sync loop on every tile the wrapper takes at each shape: for the
    GEMMs M = K = N = 1, ragged fragments, a K one k32 step past a chunk,
    operands 1 byte off alignment, +-127 at the deepest K; for the conv
    stem/c1 and redA/b3b at bucket 8 and ``CONV_I8_EDGE_CASES`` (Cin 3,
    8, 16 and 32, x 1 byte off alignment, Cout 30 and 7, 1x7 / 7x1 SAME,
    SAME at stride 2 on an odd map, a 1x1x1 output, +-127 at the deepest
    K with Cin a multiple of 16), each case's A path printed; and the int32
    pad-and-accumulate at ``PA_EDGE_CASES``. The GEMM, the conv and the
    unit-conv GEMMs must equal their plain versions bit for bit, f32
    outputs included; the int32 pad-and-accumulate's f32 outputs within
    1e-4, its int8 ones exactly;
16. runs the accuracy gate on the card: ``plan_mixed_precision`` plans
    full-width Inception-v4 at tol 0.02 on two calibration images and
    must keep int8 im2col and int8 kn2row layers, each within tol; its
    isolated errors must not move when TF32 is on globally;
17. runs the gated plan, int8 kernels vs the plain path (the int8
    emulation), at every bucket with layout elision and at bucket 8
    without (whose fused int8 edges carry int8 between layers), checks
    the launches of all twelve kernels per forward as the lowering gives
    them and the logits against the f32 plan (``INT8_VS_F32``, set from
    the JAX reference's own int8-vs-f32 reading), and times the int8
    kernels (beside their bounds and cuBLASLt's int8 GEMM; the int32
    pad-and-accumulate also at stem/c4 and stem/c5 with f32 and int8
    outputs; the int8 conv at stem/c1 and redA/b3b by queued launches, the
    latter beside ``gemm_i8`` on the same layer's Toeplitz matrix), the
    unelided forward's device split at bucket 8 (the ``conv_im2col_i8``
    group over its 85 launches) and the elided forward per bucket;
18. serves distinct Inception-v4 requests through ``CNNServingEngine``
    with the gate's ``act_scales`` and checks every result against a
    per-image plain forward;
19. serves full-width GoogleNet through the pipelined and robust engine
    (this slice's main path: every count is reset before the depth-2
    engine is built): a 29-request burst in waves of buckets 8, 8, 4, 4,
    2, 1, 1, 1 at pipeline depths 1, 2 and 4 must dispatch the same
    (bucket, requests) sequence, each result bit-equal to depth 1's and
    within rtol 2e-2 / atol 2e-3 of a per-image plain forward, at depth 2
    and 4 with a tick in flight after every ``step()`` and one capture per
    bucket program; a ``FaultPlan`` with a completion-surfaced and a
    dispatch-surfaced fault that recover and one that exhausts
    ``max_retries`` (recovered results bit-equal to a clean engine's, the
    exhausted tick's requests ``failed``, later ticks unaffected,
    outcomes conserved); a tick that exhausts its dispatch retries while
    a completion-faulted tick is held in flight, whose pipeline slot the
    next tick must take (results bit-equal to the clean engine's); an
    overload burst under ``max_queue``,
    ``shed_deadline`` and ``degrade`` with exact outcome counts; and
    ``tools/bench_serving.py``'s wall-clock Poisson replays at 0.6x and
    1.2x of saturation at depths 1 and 2, 200 requests each, whose
    latency and throughput rows are printed, not gated;
20. tunes full-width GoogleNet on the card (this slice's main path: every
    count is reset before the tuning and before each tuned engine):
    ``core.autotune.autotune_buckets`` at buckets 1, 2, 4 and 8 over the
    four kernel tiles, kernels only, the plan's binding the hysteresis
    baseline, each candidate timed as a CUDA-graph replay; the six kernels
    of the candidates must have launched; every entry must be its fastest
    candidate or the baseline kept by the 5% hysteresis, and the record
    must reload from JSON unchanged. Programs compiled from the record at
    buckets 1 and 8 must run every conv on a kernel, launch what their
    lowering gives, replay bit-equal to their eager pass and match the
    untuned program (rtol 2e-2, atol 2e-3; both forwards timed, not
    gated). ``CNNServingEngine(tuning=record)`` serves phase 19's burst at
    depths 1 and 2: the same ticks, bit-equal results within the whole-plan
    tolerance of the untuned per-image plain forward, launches and kernel
    rows per tick as each bucket's lowering gives them;
    ``refresh_from_service``'s ratios are printed. ``tune_elision`` runs at
    buckets 1 and 8 (57 programs each, each dropped before the next), and
    a program with its overrides must match the all-elided one within
    1e-4. A report tunes bucket 8 over all three backends (printed, not
    gated), and ``tune_layer`` in int8 on Inception-v4's stem/c1 and
    redA/b3b must time no Winograd candidate and its winner must equal
    its plain version bit for bit;
21. serves several tenants and re-plans under load (this slice's main
    path: every count is reset before the first engine): full-width
    GoogleNet planned for serving (``use_on_chip=False``: plan A, 41 im2col
    + 14 kn2row + 2 Winograd F(4,3)) and re-solved under a 6x transition
    calibration (plan B, 38 im2col + 19 kn2row). A ``MultiModelEngine``
    with a global queue cap serves two GoogleNet tenants (seed-0 and
    seed-1 params) and VGG16 under phase 8's plan: the second GoogleNet
    tenant adds no cache entry and each bucket program holds one capture
    per params; a burst of 24 requests a tenant in waves is bit-equal to
    solo engines and within rtol 2e-2 / atol 2e-3 of a plain forward, its
    joint ticks move no counter and run each tenant's lowering per tick
    (profiler); scripted arrivals tick in oldest-deadline order; the cap
    rejects into the owning tenant's ledger; swapping one tenant to plan B
    leaves the other's ladder, captures and results unchanged. A
    ``PlanSupervisor`` (4 ms injected device time per tick) then adopts
    plan B and swaps exactly once, in the foreground and with the compile
    (eager pass and capture) on a background thread while ticks are
    served: results before the swap bit-equal to a fresh plan-A engine's,
    after it to a fresh plan-B engine's, no tick after the swap moves a
    counter, kernel rows per tick follow each lowering; a tick in flight
    at a depth-2 swap retires on plan A; under an injected 0.2 s
    regression, with the first post-swap tick failing, probation rolls
    back once to plan A. Plans A and B are timed against phase 4's plan
    per bucket (printed, not gated), beside capture times, the background
    compile's seconds and the memory reserved;
22. serves data-parallel on a mesh (this slice's main path: every count is
    reset before 22.2 and read after 22.4), full-width GoogleNet under
    plan A. On one card a real mesh has one device, and a mesh naming
    ``cuda:0`` k times runs the whole split path (split, per-shard
    captures and replays, gather): it tests placement, never speed.
    22.1 prints the cards, their power limits and ``make_data_mesh()``,
    and ``make_data_mesh(count + 1)`` must raise. 22.2: ``make_data_mesh(1)``'s
    program at buckets 1, 2, 4, 8 must equal the unsharded program bit for
    bit after the eager pass, the capture and a replay, launching plan A's
    lowering on the first two and nothing on the replay. 22.3: on 2- and
    4-shard meshes of ``cuda:0``, at every bucket of ``batch_buckets(8,
    k)``, each shard's rows must equal the unsharded program at the
    per-chip batch bit for bit and the whole bucket the unsharded program
    at rtol 2e-2 / atol 2e-3, with k captures per bucket, k times the
    launches, and an indivisible batch raising. 22.4: engines on the
    mesh-1 and the 2-shard mesh at depths 1 and 2 under a tuning record
    whose per-chip buckets 1 and 2 bind different tiles (each bucket
    program's lowering must take its per-chip entries; warm-up launches
    two passes of every shard's lowering) serve waves of 8, 8 and 2:
    ``stats()["sharding"]``, ``last_tick["per_chip_batch"]``, zeroed stale
    staging rows, no counter moving over the ticks, results bit-equal to
    an unsharded engine's (mesh-1) or within the whole-plan tolerance
    (2-shard); two ``MultiModelEngine`` tenants on the 2-shard mesh share
    every program with 2 x 2 captures per bucket; a foreground
    ``swap_plan`` to plan B on a mesh-1 engine serves its next tick from a
    replay, bit-equal to plan B's unsharded program. 22.5 times the
    unsharded, mesh-1 and 2-shard forwards at buckets 2, 4 and 8 by events,
    interleaved (printed, not gated). 22.6 runs 22.2-22.4 on a mesh of two
    real cards where two are visible, and otherwise prints why it did not;
23. runs the two user examples in-process through their ``main(argv)`` on
    the card, every count reset before each: ``examples/quickstart_torch.py``
    at full width, then ``examples/serve_cnn_torch.py --record <tmp>``
    (tunes buckets 1 and 2 over cuDNN and the plain oracles and saves
    the record), and, loading that record, ``--models 2``,
    ``--pipeline-depth 2 --chaos --max-queue 16`` and ``--precision
    auto``. Each must return 0 (its spot checks at rtol 2e-2 / atol 2e-3
    and outcome conservation), its printed ledger must conserve, and the
    kernels its lowerings run must have launched (for ``--precision
    auto``, an int8 kernel); each run's seconds are printed;
24. the fused-epilogue options on the card, kernel path against plain
    path: (a) ``layers.avg_pool(via="overlay")`` at bucket 8 on
    Inception-v4's three pool shapes (35², 17², 8²; 3x3 s1 SAME) and a
    3x3 s2 VALID map, one ``conv_im2col_f32`` launch each, within 1e-4 of
    the pooling path and of its plain path, timed beside the pool and the
    conv's bound; (b) full-width f32 Inception-v4 under its plan compiled
    with ``avg_pool_via="overlay"`` at buckets 1 and 8: launches the
    lowering's plus its 14 pool convs (eager and capture passes, the
    captured graph's kernel nodes, one replay's profiler rows), logits
    against the plain path and the pooling program, both forwards timed
    interleaved; (c) full-width GoogleNet with no plan and
    ``default_algo=KN2ROW`` at buckets 1 and 8: the same launch checks,
    logits against its plain path and the all-im2col program, the
    all-im2col, all-kn2row and phase 4 plan forwards timed (printed), and
    ``unit_conv_gemms_f32`` / ``pad_accumulate_f32`` at conv1 (K 3, G 49)
    and inception_3a/5x5 against their plain versions and bounds;
25. the LM serving path at full width and depth, h2o-danube-1.8b and
    mamba2-370m from a seeded CUDA generator: in f32, 12 token-by-token
    ``decode_step`` calls reproduce the teacher-forced ``forward`` logits
    at rtol/atol 2e-3; in bf16, ``launch.serve``'s defaults (6 requests,
    batch 4, prompt 12, 8 new tokens) give every request 8 tokens in the
    vocabulary; tokens/s, one decode step's ms by events and the memory
    reserved are printed.
26. the LM decode step captured as one CUDA graph by ``ServingEngine``
    (h2o-danube-1.8b, mamba2-370m, full width and depth): in f32 the
    captured step's logits equal the eager ``decode_step``'s on a cloned
    cache bit for bit over a 12-token prompt and 8 greedy tokens at batch
    4; in bf16 ``launch.serve``'s defaults through the captured engine;
    one replay's ms, kernel rows and device-busy share printed; every
    architecture's reduced decode captured and bit-equal to eager in f32;
27. LM training through the compiled train step (``compile_train_step``:
    two eager passes, one CUDA-graph capture, replays), after phases
    1-25's programs are dropped and the cache emptied: full-width
    h2o-danube-1.8b through ``launch.train.main`` (batch 8, seq 128, two
    microbatches; finite losses and grad norms), then 8 compiled steps on
    one batch whose loss must fall by 0.5; the compiled step against the
    eager ``train_step`` in f32 (2-layer h2o, full-width mamba2-370m,
    reduced deepseek-v2-236b), bit-equal or within
    ``mesh_check.check_rule``, the graph's kernel nodes equal to one eager
    pass's kernel rows; the eager and the replayed full-width bf16 h2o
    step (batch 8 x 128: ms, device busy, host share, capture seconds,
    kernel nodes, memory reserved, printed); full-width mamba2-370m
    trained, checkpointed, resumed and recovered from a failure injected
    after the capture, each restore bit-equal to the saved state and
    copied into the compiled step's buffers; one f32 train step at 2
    layers, full width, on the card against the CPU within 1e-4 of each
    leaf's max.
28. the LM mesh, its dry run and roofline: (a) on ``make_smoke_mesh()``
    (NCCL, world 1) one train step (two microbatches) of h2o-danube-1.8b
    at 2 layers, full width, f32, against the unsharded step on the same
    weights and batch, at the full learning rate from step 1: loss and
    every updated leaf within 1e-5 of the leaf's max (a param leaf's max
    taken as at least 1), the deviation, bit-equality and the smallest
    leaf's step printed (it must be over 2e-5, so that a missing update
    would show); then the train step compiled on the smoke mesh
    (``compile_train_step`` on ``DTensor`` state: two eager passes, the
    capture, its replay) against three eager sharded steps in f32, on
    that configuration and on reduced deepseek-v2-236b (MLA, MoE):
    bit-equal, or within ``mesh_check.check_rule`` of the step's float
    noise measured then (the line says which); the activation plan's
    head-parallel attention core must have run; (b) on full-width,
    full-depth h2o-danube-1.8b the sharded and the unsharded eager
    ``train_step`` timed on one batch (ms, the host's share, memory) with
    no other process running, then the same sharded step compiled on the
    mesh: its eager passes, the capture (seconds; its kernel nodes must
    equal one eager pass's kernel rows) and five replays (events, median),
    device busy, host share and ``max_memory_reserved`` per stage, against
    the eager sharded step; then ``launch.train --mesh smoke`` (every
    step through the compiled mesh step) checkpointed and resumed into
    the compiled step's own shards (``load_state`` of the checkpoint
    mapped on the host), then the same checkpoint resumed with ``--mesh
    none``, each resumed run's ``max_memory_reserved`` held to
    ``RESUME_PEAK_GIB``; one f32 full-depth decode step on the
    smoke mesh with ``cache_shardings`` against the unsharded eager step
    within 1e-5; and ``serve_step`` compiled on the smoke mesh
    (``mesh_check.compiled_decode_check``: two eager passes, the capture,
    a replay) on 2-layer h2o-danube-1.8b (its 4096-slot window wrapping),
    reduced deepseek-v2-236b and 2-layer mamba2-370m, f32: bit-equal to
    the eager sharded decode, logits and caches, and within 1e-5 of the
    unsharded decode; and ``prefill_step`` compiled on the smoke mesh
    (``mesh_check.compiled_prefill_check``: two eager passes, the
    capture, three replays on fresh tokens) on 2-layer h2o-danube-1.8b
    (2 x 2048), reduced deepseek-v2-236b, 2-layer mamba2-370m (2 x 2048)
    and reduced internvl2-2b (its front end), f32: every call bit-equal
    to the eager sharded prefill and replicated, within
    ``mesh_check.check_rule`` of the unsharded prefill's own noise
    (``mesh_check.prefill_noise``); (c) in processes of their own (CPU
    only, each on its own fake process group), started once (b)'s steps are timed (the
    compiled mesh checks of (a) run beside them) and joined last, the dry-run cells
    deepseek-v2-236b × train_4k × pod, llama4-maverick-400b-a17b ×
    decode_32k × multipod and zamba2-2.7b × long_500k × pod, and the
    roofline of qwen2.5-14b × train_4k: per-chip parameter bytes against
    80 GB, the temp term, FLOPs, collective bytes by op and the roofline
    terms printed; a failed cell fails the phase.
29. the CNN path in bf16 (``init_params(dtype=torch.bfloat16)``, the
    engine's ``dtype=``): (a) ptxas registers, spills and shared memory
    of each bf16 instantiation (``gemm_bf16``, ``conv_im2col_bf16`` and
    the bf16 stores of the f32 GEMMs); (b) ``gemm_bf16`` on every tile at
    M = K = N = 1, 17x33x9, K 70, B one element off alignment, 5b/1x1 at
    bucket 1 and conv2 at bucket 8, and ``conv_im2col_bf16`` at the
    GoogleNet stem (its element path), a 3x3 SAME with Cin % 8 == 0, a
    VALID stride 2, a 5x5, Cout 30 and a 1x1x1, each within one bf16 ulp
    of its plain version (rtol 2^-7, atol 1e-4 of the output's max; the
    largest deviation printed) and equal bit for bit from call to call;
    ``out_dtype`` both ways; (c) full-width GoogleNet with bf16 params at
    every bucket, elided (1 conv + 56 GEMM launches) and not (57 conv):
    kernels against the plain path on the card within 5e-2 of its
    largest logit, eager, capture and replay bit-equal, the counters, the
    captured graph's kernel nodes and a replay's profiler rows (a short
    window retaken, as phase 4 does) equal to the lowering's launches (and
    no other kernel launched), and within
    5e-2 of the f32 forward of the same weights widened; (d)
    ``CNNServingEngine(dtype=torch.bfloat16)`` serving 13 distinct
    requests at depths 1 and 2, every count reset just before each engine
    is built (depth 1's run gives the JSON line's launches), each result
    an f32 row within 5e-2 of a plain bf16 forward of its image; (e)
    printed, not gated: both kernels against their bounds (989 TFLOP/s
    bf16, 3.35 TB/s), ``torch.matmul`` at conv2 and ``F.conv2d`` at the
    stem in bf16 (bucket 8), and the replayed bf16 forward per bucket
    beside the f32 one with ``max_memory_reserved``;
30. the Winograd path in bf16 on full-width VGG16 (``phase_30_bf16_
    winograd``'s docstring);
31. the kn2row path in bf16: ``unit_conv_gemms_bf16`` and
    ``pad_accumulate_bf16`` within one bf16 ulp of their plain versions
    at Inception-v4's bucket-8 kn2row shapes and at the edges, full-width
    Inception-v4 with bf16 params at every bucket, elided and not (16
    launches of each a forward), the gated plan of the same bf16 params
    (f32 logits held to its plain path, the kernels it launched printed
    by dtype, an engine serving it), the bf16 engine at depths 1 and 2,
    and, printed, each kernel against its bound, plain version and
    library call and the replayed bf16 forward beside the f32 one
    (``phase_31_bf16_kn2row``'s docstring).

Phases 8, 12 and 17 check their forwards as phase 4 does, phases 9, 13
and 18 serve as phase 5 does, and every forward timed is a replay. Each
of those checks counts the kernel nodes of a capture of the same walk
through the driver API (``graph_kernel_nodes``), which must equal the
lowering's launches; only then is a profiler window whose rows come back
short of them (the profiler dropped rows) taken again, up to three in
all, and every window accepted holds the exact count.

Every check raises on failure, so the script exits nonzero without its
final line. The line before the last is one JSON object of per-kernel
numbers; the last is ``{"ok": true, "device": {...}}``. With no CUDA
device, or outside a checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, dense int8
# and bf16 tensor cores, HBM3 (``repro_torch/hw.py``, which the roofline
# shares). Outside a checkout there is no such module: ``main`` then says
# so and exits 2.
sys.path.insert(0, str(SRC))
try:
    from repro_torch.hw import (HBM_BYTES_PER_S, PEAK_BF16_FLOPS,
                                PEAK_F32_FLOPS, PEAK_INT8_OPS)
except ModuleNotFoundError:
    HBM_BYTES_PER_S = PEAK_BF16_FLOPS = PEAK_F32_FLOPS = PEAK_INT8_OPS = None

BUCKETS = (1, 2, 4, 8)
FORWARD_TOL = dict(rtol=2e-2, atol=2e-3)    # the reference's whole-plan tol
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)     # the reference's f32 kernel tol
EXACT = dict(rtol=0.0, atol=0.0)            # int32 sums, int8 outputs
GATE_TOL = 0.02                             # the gate's error budget
# The gated Inception-v4's logits against the f32 plan's: max|int8 - f32| /
# max|f32| below "rel" and every image's cosine similarity above "cos".
# The deviation is the int8 semantics' own and grows with depth: at tol
# 0.02 the JAX reference's emulation, against its own f32 plan, reads
# 0.138 / 0.262 / 0.338 (cosine 0.990 / 0.948 / 0.934) at blocks 1/1/1,
# 2/3/1 and 4/7/3 of width 0.25 and 0.418 (0.895) at 4/7/3 of width 0.5,
# the port the same to 1e-4 (``python tests/test_torch_quant.py``, 299²,
# batch 8; PERF.md section 6). The bounds leave room above those readings
# and the card's at full width (0.428, 0.892).
INT8_VS_F32 = {"rel": 0.6, "cos": 0.8}
N_REQUESTS = 13
N_VGG_REQUESTS = 12
N_IV4_REQUESTS = 11
N_IV4_I8_REQUESTS = 11
# Phase 19: the burst's waves (29 requests; a bucket twice and thrice in a
# row), the pipeline depths served, the faulted run's waves (35 requests,
# 7 ticks) and the replayed rates of ``tools/bench_serving.py``.
WAVES = (8, 8, 4, 4, 2, 1, 1, 1)
PIPELINE_DEPTHS = (1, 2, 4)
FAULT_WAVES = (8, 4, 8, 2, 8, 1, 4)
N_LOAD_REQUESTS = 200
# Phase 21: the burst's waves per tenant (24 requests), the global queue
# cap (36 submitted at once, so the last tenant's 6 are rejected), the
# scripted arrivals of the deadline check ((base time, {tenant: offset}),
# SLOs 0.5 / 0.3 / 0.2 s: orders vgg16, gnet_b, gnet_a; gnet_a, gnet_b,
# vgg16; gnet_b, vgg16, gnet_a) and the seven f32 entry points the path
# launches.
MULTI_WAVES = (8, 8, 4, 2, 1, 1)
GLOBAL_CAP = 30
DEADLINE_SCRIPT = ((0.0, {"gnet_a": 0.0, "gnet_b": 0.0, "vgg16": 0.0}),
                   (10.0, {"gnet_a": 0.0, "gnet_b": 0.25, "vgg16": 0.4}),
                   (20.0, {"gnet_a": 0.1, "gnet_b": 0.0, "vgg16": 0.35}))
PATH21 = ("conv", "gemm", "input_transform", "input_transform_tiles",
          "batched_gemm", "output_transform", "unit_conv_gemms",
          "pad_accumulate")
# FLOP per (tile, channel) of the Winograd transforms as csrc/winograd.cu
# writes them: two passes of 1-D transforms (adds and small-constant
# FMAs), plus bias and ReLU on the m x m outputs of the output transform.
TRANSFORM_FLOPS = {("in", 2): 32, ("in", 4): 336,
                   ("out", 2): 24 + 8, ("out", 4): 130 + 32}


def use_source_tree(src) -> None:
    """Import ``repro_torch`` from ``src`` (a checkout's ``src`` directory)
    from now on. Importing this module put its own checkout's ``src``
    first on the path and imported ``repro_torch`` from there, so a tool
    that times another tree (``--src``) drops those modules and puts that
    tree first before it imports anything of the port."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(src).resolve()))

class CheckFailed(AssertionError):
    pass


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Raise unless ``got`` matches ``want`` elementwise; returns max|Δ|."""
    import torch
    if tuple(got.shape) != tuple(want.shape):
        raise CheckFailed(f"{name}: shape {tuple(got.shape)} != "
                          f"{tuple(want.shape)}")
    if got.dtype != want.dtype:
        raise CheckFailed(f"{name}: dtype {got.dtype} != {want.dtype}")
    if not got.is_floating_point():      # int32 partials, int8 outputs
        got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        raise CheckFailed(f"{name}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    bad = int((diff > atol + rtol * want.abs()).sum())
    if bad:
        raise CheckFailed(f"{name}: {bad} elements outside rtol={rtol} "
                          f"atol={atol} (max |diff| {err:.3e})")
    return err


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Time of one call in ms: CUDA events around ``reps`` back-to-back
    calls, divided by ``reps``; the median of ``rounds`` such runs, after
    three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def queued_ms(fn, reps: int = 10) -> float:
    """Device time of one call in ms with no host gap in it: ``reps`` calls
    are enqueued behind a spin kernel (``torch.cuda._sleep``), so they run
    back to back once it ends, and CUDA events time them from its end.
    The spin is lengthened until it outlasts the host's enqueueing (the
    start event must still be pending when the last call is enqueued)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for cycles in (2 * 10 ** 7, 2 * 10 ** 8, 2 * 10 ** 9):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
    raise CheckFailed("the host enqueues slower than a 2e9-cycle spin")


def device_time(fn, reps: int = 1):
    """(device ms summed over every kernel one call runs, that time split
    into this port's kernels by tile or F(m,3) (the split-K reduce kernels
    of the f32 and bf16 GEMMs and the f32 conv under keys of their own; a
    wgmma GEMM's split partials under its tile), torch's
    index gathers — the Toeplitz and Winograd-tile layout conversions —
    and all other torch kernels, as text and as a dict of ms) from
    ``torch.profiler``, over
    ``reps`` calls in one profiled window, divided by ``reps``. Only the
    kernels' own rows are summed: an aten op's row repeats the time of the
    kernels it launched. The window opens as ``opened_window`` says; one
    whose opener or kernels came back with no row (both seen on the card)
    is taken again, up to five in all."""
    import re

    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    for _ in range(5):
        _, averages = opened_window(calls)
        groups = {}
        for e in averages or ():
            ms = getattr(e, "self_device_time_total", 0) / 1e3 / reps
            if (e.device_type != DeviceType.CUDA or ms <= 0
                    or "spin_kernel" in e.key):
                continue
            gemm = re.search(r"\b(batched_gemm_f32|gemm_f32|conv_im2col_f32|"
                             r"unit_conv_gemms_f32|gemm_i8|conv_im2col_i8|"
                             r"unit_conv_gemms_i8|batched_gemm_bf16|gemm_bf16|"
                             r"conv_im2col_bf16|unit_conv_gemms_bf16|"
                             r"batched_gemm_bf16_mma|gemm_bf16_mma)"
                             r"_kernel<(\d+), (\d+)(?:, \d+)?>", e.key)
            wino = re.search(r"\b((?:input_transform_tiles|input_transform|"
                             r"output_transform)(?:_bf16)?)_kernel<(\d+)>",
                             e.key)
            reduce = re.search(r"\b(gemm_f32|unit_conv_gemms_f32|"
                               r"conv_im2col_f32|gemm_bf16|gemm_bf16_out_f32)"
                               r"_reduce_kernel", e.key)
            key = (f"{gemm[1]}<{gemm[2]}x{gemm[3]}>" if gemm
                   else f"{reduce[1]}_reduce" if reduce
                   else f"{wino[1]}<F{wino[2]}>" if wino
                   else "pad_accumulate_f32" if "pad_accumulate_f32_kernel"
                   in e.key
                   else "pad_accumulate_i32" if "pad_accumulate_i32_kernel"
                   in e.key
                   else "pad_accumulate_bf16" if "pad_accumulate_bf16_kernel"
                   in e.key
                   else "torch index/gather" if re.search(r"index|gather",
                                                          e.key)
                   else "torch other")
            groups[key] = groups.get(key, 0.0) + ms
        if groups:
            break
        if averages is not None:
            print("[profiler] a window came back with its opener's rows and "
                  "none of its kernels'; the window is taken again")
    else:
        raise CheckFailed("the profiler recorded no kernel time in five "
                          "windows")
    split = ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    return sum(groups.values()), split, groups


# The __global__ function each kernel entry point launches once per call
# (a split product's reduce kernel aside), under the short names of the
# launch counts (``main``'s KERNELS).
KERNEL_SYMBOLS = {"conv": "conv_im2col_f32_kernel", "gemm": "gemm_f32_kernel",
                  "input_transform": "input_transform_kernel",
                  "input_transform_tiles": "input_transform_tiles_kernel",
                  "batched_gemm": "batched_gemm_f32_kernel",
                  "output_transform": "output_transform_kernel",
                  "unit_conv_gemms": "unit_conv_gemms_f32_kernel",
                  "pad_accumulate": "pad_accumulate_f32_kernel",
                  "gemm_i8": "gemm_i8_kernel",
                  "conv_im2col_i8": "conv_im2col_i8_kernel",
                  "unit_conv_gemms_i8": "unit_conv_gemms_i8_kernel",
                  "pad_accumulate_i32": "pad_accumulate_i32_kernel",
                  "conv_im2col_bf16": "conv_im2col_bf16_kernel",
                  "gemm_bf16": "gemm_bf16_kernel",
                  "input_transform_bf16": "input_transform_bf16_kernel",
                  "input_transform_tiles_bf16":
                      "input_transform_tiles_bf16_kernel",
                  "batched_gemm_bf16": "batched_gemm_bf16_kernel",
                  "output_transform_bf16": "output_transform_bf16_kernel",
                  "unit_conv_gemms_bf16": "unit_conv_gemms_bf16_kernel",
                  "pad_accumulate_bf16": "pad_accumulate_bf16_kernel"}


# Spin kernels (``torch.cuda._sleep``) that open every profiled window
# whose kernel rows a check counts. On the card the profiler has dropped
# the first kernels of a window, more of them later in the script (3-4
# rows of phase 27's deepseek-v2 eager step past an opener of sixteen;
# 25 in phase 29), so a window's rows are trusted only where some of its
# opener's rows came back.
OPENER_SPINS = 512


def opened_window(fn):
    """(``fn()``'s result, ``key_averages()``) of one call of ``fn`` under
    ``torch.profiler``, the window opened by ``OPENER_SPINS`` spin kernels
    (rows named ``spin_kernel``, which no count reads). The averages are
    None where none of the opener's rows came back: the profiler may then
    have dropped ``fn``'s first kernels too, and the caller takes the
    window again. A window whose opener lost rows is reported on a line
    of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(OPENER_SPINS):
            torch.cuda._sleep(1000)
        out = fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    spins = sum(e.count for e in averages if e.device_type == DeviceType.CUDA
                and "spin_kernel" in e.key)
    if spins < OPENER_SPINS:
        print(f"[profiler] a window's opener came back with {spins} of its "
              f"{OPENER_SPINS} spin rows"
              + ("; the window is taken again" if not spins else ""))
    return out, (averages if spins else None)


def profiled_launches(fn):
    """(``fn()``'s result, {short name: rows}) from ``torch.profiler``: the
    device rows of each ``KERNEL_SYMBOLS`` kernel one call of ``fn`` ran —
    for a replayed CUDA graph, the kernels the graph holds, which the
    host's launch counters never see. Each window opens as
    ``opened_window`` says: late in the script the profiler dropped the
    first kernels of a window on the card (a served tick's stem conv among
    them). A window without any kernel row (seen on the card for short
    windows) or whose opener came back with no row is taken again, up to
    three in all, so ``fn`` must be safe to call again."""
    import re

    from torch.autograd import DeviceType
    for _ in range(3):
        out, averages = opened_window(fn)
        if averages is None:
            continue
        rows, kernels = Counter(), 0
        for e in averages:
            if e.device_type != DeviceType.CUDA or "Memcpy" in e.key \
                    or "Memset" in e.key or "spin_kernel" in e.key:
                continue
            kernels += e.count
            for name, symbol in KERNEL_SYMBOLS.items():
                if re.search(rf"\b{symbol}\b", e.key):
                    rows[name] += e.count
        if kernels:
            return out, rows
    raise CheckFailed("the profiler recorded no kernel rows in three "
                      "windows")


def graph_kernel_nodes(cuda_graph):
    """{short name: kernel nodes} of a captured ``torch.cuda.CUDAGraph``
    made with ``keep_graph=True``: the ``KERNEL_SYMBOLS`` kernels among
    ``graph_kernel_symbols``. Each replay of the graph runs each of its
    kernel nodes once."""
    rows = Counter()
    by_symbol = {symbol: name for name, symbol in KERNEL_SYMBOLS.items()}
    for symbol in graph_kernel_symbols(cuda_graph):
        symbol = symbol.split("<")[0]
        if symbol in by_symbol:
            rows[by_symbol[symbol]] += 1
    return rows


def graph_kernel_symbols(cuda_graph):
    """The kernel name (``kernel_name``) of every kernel node of a
    captured ``torch.cuda.CUDAGraph`` made with ``keep_graph=True``, child
    graphs' nodes included, read through the driver API
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphChildGraphNodeGetGraph``, ``cuGraphKernelNodeGetParams_v2``
    and ``cuFuncGetName`` or ``cuKernelGetName``), so a count that never
    goes through the profiler."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p),
                    ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                    ("shared_mem_bytes", ctypes.c_uint),
                    ("kernel_params", ctypes.c_void_p),
                    ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                    ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        err = getattr(cu, fn)(*args)
        if err != 0:
            raise CheckFailed(f"{fn} failed with CUresult {err}")

    def walk(graph):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", graph, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
        for node in nodes:
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", ctypes.c_void_p(node),
                 ctypes.byref(kind))
            if kind.value == 4:                   # CU_GRAPH_NODE_TYPE_GRAPH
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", ctypes.c_void_p(node),
                     ctypes.byref(child))
                yield from walk(child)
            if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            params = KernelNodeParams()
            call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
                 ctypes.byref(params))
            name = ctypes.c_char_p()
            if params.func:
                call("cuFuncGetName", ctypes.byref(name),
                     ctypes.c_void_p(params.func))
            else:
                call("cuKernelGetName", ctypes.byref(name),
                     ctypes.c_void_p(params.kern))
            yield kernel_name(name.value.decode())

    return list(walk(ctypes.c_void_p(cuda_graph.raw_cuda_graph())))


def kernel_name(mangled: str) -> str:
    """``name<A, B, ...>`` of a mangled kernel symbol: the nested names
    (``_ZN<len><namespace><len><name>``, the anonymous namespace included)
    are read by their lengths up to the one ending in ``_kernel``, then its
    integer template arguments (``I Li3E Li3E ... E``). A name that is
    not mangled comes back as it is."""
    import re
    if not mangled.startswith("_Z"):
        return mangled
    pos = 3 if mangled.startswith("_ZN") else 2
    while True:
        size = re.match(r"\d+", mangled[pos:])
        if size is None:
            return mangled
        start = pos + len(size[0])
        pos = start + int(size[0])
        ident = mangled[start:pos]
        if ident.endswith("_kernel"):
            args = re.match(r"I((?:Li\d+E)+)E", mangled[pos:])
            return ident + ("" if args is None else "<" + ", ".join(
                re.findall(r"Li(\d+)E", args[1])) + ">")


def ptxas_report(log: str):
    """[(kernel, "R registers, S B spill stores, M B smem")] from nvcc's
    ``-Xptxas -v`` output, one per compiled kernel, the kernel named with
    its integer template arguments (``name<BM, BN>`` for a tile template,
    ``name<K1, K2, V>`` for pad-and-accumulate)."""
    import re
    rows, kernel, spill = [], "?", "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = kernel_name(entry[1])
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores:
            spill = stores[1]
        used = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                         line)
        if used:
            rows.append((kernel, f"{used[1]} registers, {spill} B spill "
                                 f"stores, {used[2] or 0} B smem"))
    return rows


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(least ms the card could take, what bounds it) for f32 work, or at
    another ``peak`` rate of operations (``PEAK_INT8_OPS`` for int8)."""
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


# Inception-v4's distinct kn2row layer shapes at full width: (map, K1, K2,
# stride, padding, Cin, Cout).
KN2ROW_LAYERS = {
    "stem/c4": (147, 3, 3, 2, "VALID", 64, 96),
    "stem/c5": (71, 3, 3, 2, "VALID", 192, 192),
    "redA/b2": (35, 3, 3, 2, "VALID", 384, 384),
    "redA/b3a": (35, 1, 1, 1, "SAME", 384, 192),
    "incC/b3b": (8, 1, 3, 1, "SAME", 384, 256),
    "incC/b3c": (8, 3, 1, 1, "SAME", 384, 256),
    "incC/b4d": (8, 3, 1, 1, "SAME", 512, 256),
    "incC/b4e": (8, 1, 3, 1, "SAME", 512, 256),
}
# The distinct pad_accumulate launches of the f32 Inception-v4 forward
# (p's shape does not depend on Cin) and their launches per forward:
# incC/b3b stands for the six 1x3 launches of the three Inception-C
# blocks (b3b, b4e), incC/b4d for the six 3x1 (b3c, b4d).
PAD_ACCUMULATE_LAUNCHES = {"stem/c4": 1, "stem/c5": 1, "redA/b2": 1,
                           "redA/b3a": 1, "incC/b3b": 6, "incC/b4d": 6}


def pad_accumulate_geometry(label: str):
    """(p's shape (G, 1, H, W, C) for batch 1, the geometry keywords of
    ``pad_accumulate_call``) of Inception-v4's kn2row layer ``label``."""
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    hw, k1, k2, stride, pad, _, c = KN2ROW_LAYERS[label]
    o1, o2, pt, _, pl, _ = conv_geometry(hw, hw, k1, k2, stride, pad)
    return (k1 * k2, 1, hw, hw, c), dict(k1=k1, k2=k2, o1=o1, o2=o2,
                                          stride=stride, pad_top=pt,
                                          pad_left=pl)


def pad_accumulate_reads(p5, geo) -> int:
    """The values of p the sum needs: for each offset, the in-map rows and
    columns its strided window touches."""
    _, batch, h, w, c = p5.shape
    n = 0
    for g in range(geo["k1"] * geo["k2"]):
        dk1, dk2 = divmod(g, geo["k2"])
        rows = sum(0 <= geo["stride"] * y + dk1 - geo["pad_top"] < h
                   for y in range(geo["o1"]))
        cols = sum(0 <= geo["stride"] * x + dk2 - geo["pad_left"] < w
                   for x in range(geo["o2"]))
        n += rows * cols
    return n * batch * c


def time_pad_accumulate(kn2, label: str, bsz: int, rng, quant=None,
                        plain: bool = False) -> dict:
    """One main-path pad_accumulate launch, Inception-v4's ``label`` at
    batch ``bsz`` with the bias epilogue, p drawn on the card from the CUDA
    generator ``rng``: f32, or, with ``quant`` "f32" or "int8", int32
    partials flushed to that output. ``kn2`` is the kn2row wrapper module
    of the tree under test. The kernel is held to its plain version
    (rtol/atol 1e-4; int8 outputs exactly), then timed by CUDA events, by
    queued launches and by profiler device time beside its bound; an f32
    p also beside the library call, one grouped ``F.conv2d`` over p as (B,
    C·G, H, W) with a one-hot (C, G, K1, K2) weight, groups=C (cuDNN, no
    TF32), by events and by profiler device time. ``plain`` adds the plain
    version's time by events. Returns the numbers as a dict."""
    import torch
    import torch.nn.functional as F
    shape, geo = pad_accumulate_geometry(label)
    g, _, hw, _, c = shape
    dev = rng.device
    bias = torch.randn(c, generator=rng, device=dev) * 0.1
    kw = dict(epilogue="bias", bias=bias, **geo)
    if quant is None:
        p = torch.randn((g, bsz, hw, hw, c), generator=rng, device=dev)
    else:
        p = torch.randint(-30000, 30000, (g, bsz, hw, hw, c), generator=rng,
                          device=dev, dtype=torch.int32)
        kw.update(scale=(torch.rand(c, generator=rng, device=dev) + 0.5)
                  / 3e4, out_scale=None if quant == "f32" else 0.05)

    def kern():
        return kn2.pad_accumulate_call(p, **kw)

    want = kn2.pad_accumulate_plain(p, **kw)
    row = dict(max_abs_err=check_close(
        f"pad_accumulate {label} b{bsz} {quant or 'f32 p'} timed", kern(),
        want, **(EXACT if quant == "int8" else KERNEL_TOL)))
    n_out = bsz * geo["o1"] * geo["o2"] * c
    out_bytes = 1 if quant == "int8" else 4
    if quant is None:
        row["bound_ms"], row["bound_by"] = bound(
            1.0 * g * n_out, 4.0 * (pad_accumulate_reads(p, geo) + c)
            + out_bytes * n_out)
    else:
        row["bound_ms"], row["bound_by"] = bound(
            1.0 * g * n_out, 4.0 * pad_accumulate_reads(p, geo) + 8.0 * c
            + out_bytes * n_out, PEAK_INT8_OPS)
    row.update(ms=time_ms(kern), queued_ms=queued_ms(kern),
               device_ms=device_time(kern, reps=20)[0])
    if plain:
        row["plain_ms"] = time_ms(lambda: kn2.pad_accumulate_plain(p, **kw))
    if quant is None:
        p_nchw = p.permute(1, 4, 0, 2, 3).reshape(bsz, c * g, hw, hw
                                                  ).contiguous()
        onehot = torch.zeros(c, g, geo["k1"], geo["k2"], device=dev)
        for gg in range(g):
            onehot[:, gg, gg // geo["k2"], gg % geo["k2"]] = 1.0

        def grouped():
            return F.conv2d(p_nchw, onehot, bias, stride=geo["stride"],
                            padding=(geo["pad_top"], geo["pad_left"]),
                            groups=c)

        check_close(f"grouped F.conv2d pad_accumulate {label} b{bsz}",
                    grouped().permute(0, 2, 3, 1), want, **KERNEL_TOL)
        row.update(library_ms=time_ms(grouped),
                   library_device_ms=device_time(grouped, reps=20)[0])
    return row


# The edges of the pad_accumulate kernels' paths: (label, p (G, B, H, W,
# C), K1, K2, stride, padding). C 30 and a p one element off 16-byte
# alignment take the one-channel path; batch 1 at redA/b2's shape, the
# generic offsets 1x7, 7x1 and 5x5, and SAME at stride 2 on an odd map
# (pads on both sides) the vector one.
PA_EDGE_CASES = [("C 30", (9, 2, 13, 13, 30), 3, 3, 1, "SAME"),
                 ("p offset", (9, 2, 13, 13, 96), 3, 3, 1, "SAME"),
                 ("batch 1", (9, 1, 35, 35, 384), 3, 3, 2, "VALID"),
                 ("1x7", (7, 2, 17, 17, 64), 1, 7, 1, "SAME"),
                 ("7x1", (7, 2, 17, 17, 64), 7, 1, 1, "SAME"),
                 ("5x5", (25, 2, 17, 17, 64), 5, 5, 1, "SAME"),
                 ("s2 SAME odd", (9, 2, 15, 15, 64), 3, 3, 2, "SAME")]


def check_pad_accumulate_edges(kn2, rng, quant: bool):
    """pad_accumulate at PA_EDGE_CASES under all four epilogues against
    its plain version, p drawn on the card from the CUDA generator
    ``rng``: f32 p within rtol/atol 1e-4, or int32 p with f32 outputs
    within 1e-4 and requantized int8 ones (at 0.05) exactly. Returns
    [(case, path the wrapper took, {"f32": max|diff|, "int8": ...})]."""
    import torch
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    dev = rng.device
    rows = []
    for label, shape, k1, k2, stride, pad in PA_EDGE_CASES:
        _, _, h, w, c = shape
        o1, o2, pt, _, pl, _ = conv_geometry(h, w, k1, k2, stride, pad)
        geo = dict(k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, pad_top=pt,
                   pad_left=pl)
        if quant:
            p = torch.randint(-30000, 30000, shape, generator=rng,
                              device=dev, dtype=torch.int32)
            scale = (torch.rand(c, generator=rng, device=dev) + 0.5) / 3e4
        else:
            p, scale = torch.randn(shape, generator=rng, device=dev), None
        if label == "p offset":
            buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=dev)
            buf[1:].copy_(p.reshape(-1))
            p = buf[1:].view(shape)
        bias = torch.randn(c, generator=rng, device=dev) * 0.1
        errs = {}
        for ep in ("none", "relu", "bias", "bias_relu"):
            for out_scale in (None, 0.05) if quant else (None,):
                kw = dict(epilogue=ep, bias=bias, scale=scale,
                          out_scale=out_scale, **geo)
                got = kn2.pad_accumulate_call(p, **kw)
                torch.cuda.synchronize()
                key = "f32" if out_scale is None else "int8"
                errs[key] = max(errs.get(key, 0.0), check_close(
                    f"pad_accumulate {label} {ep} {p.dtype} -> {key}", got,
                    kn2.pad_accumulate_plain(p, **kw),
                    **(KERNEL_TOL if out_scale is None else EXACT)))
        path = ("vector" if kn2.accumulate_vector_path(p, got) else
                "one-channel") + (" unrolled" if (k1, k2) in
                                  kn2.UNROLLED_OFFSETS else " generic")
        rows.append(((label, shape, k1, k2, stride, pad), path, errs))
    return rows


# The edges of conv_im2col_i8's two A paths (csrc/conv_im2col.cu): (label,
# x (B, H, W, Cin), w (K1, K2, Cin, Cout), stride, padding). Cin 3 at
# stem/c1's geometry, Cin 8, x one byte off 16-byte alignment, Cout 30 and
# 7 and a 1x1x1 output take the byte path; Cin 16 and 32 with K one k32
# step past a 64-deep chunk (144, 288), 1x7 / 7x1 SAME and SAME at stride 2
# on an odd map the 16-byte gather. The last case is +-127 at the deepest
# K the wrapper takes with Cin a multiple of 16, as a 1x1 conv.
CONV_I8_EDGE_CASES = [
    ("Cin 3 stem/c1 b1", (1, 299, 299, 3), (3, 3, 3, 32), 2, "VALID"),
    ("Cin 16 K 144", (2, 13, 13, 16), (3, 3, 16, 24), 1, "SAME"),
    ("Cin 32 K 288", (2, 11, 11, 32), (3, 3, 32, 136), 1, "SAME"),
    ("Cin 8", (2, 9, 9, 8), (3, 3, 8, 16), 1, "SAME"),
    ("x offset", (2, 13, 13, 16), (3, 3, 16, 24), 1, "SAME"),
    ("Cout 30", (2, 9, 9, 16), (3, 3, 16, 30), 1, "SAME"),
    ("Cout 7", (2, 9, 9, 16), (3, 3, 16, 7), 1, "SAME"),
    ("1x7 SAME", (2, 17, 17, 32), (1, 7, 32, 48), 1, "SAME"),
    ("7x1 SAME", (2, 17, 17, 32), (7, 1, 32, 80), 1, "SAME"),
    ("s2 SAME odd", (2, 17, 17, 32), (3, 3, 32, 32), 2, "SAME"),
    ("1x1x1 out", (1, 3, 3, 16), (3, 3, 16, 1), 1, "VALID"),
    ("+-127 K 133136", (1, 4, 4, 133136), (1, 1, 133136, 16), 1, "VALID")]
CONV_I8_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))


def i8_outputs(kern, plain, tol):
    """An int8 kernel vs its plain version under every epilogue, f32 out
    (within ``tol``) and requantized to int8 at 0.05 (exact); returns
    max|Δ| of each."""
    import torch
    errs = {"f32": 0.0, "int8": 0.0}
    for ep in ("none", "relu", "bias", "bias_relu"):
        for out_scale in (None, 0.05):
            got = kern(ep, out_scale)
            torch.cuda.synchronize()
            want = plain(ep, out_scale)
            key = "f32" if out_scale is None else "int8"
            errs[key] = max(errs[key], check_close(
                f"{ep} {key}", got, want,
                **(tol if out_scale is None else EXACT)))
    return errs


def check_conv_i8(conv, x, w, stride, pad, scale, bias):
    """conv_im2col_i8 against conv_i8_plain on every tile the wrapper
    takes at this shape (``kernel_tile`` clamps to the problem), under all
    four epilogues, f32 and requantized int8 outputs both bit for bit (the
    exact int32 sum, then the same single-rounded flush steps). Returns (A
    path the entry point takes, tiles, {"f32": max|diff|, "int8": ...})."""
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    from repro_torch.kernels.gemm.gemm import kernel_tile
    o1, o2 = conv_geometry(x.shape[1], x.shape[2], w.shape[0], w.shape[1],
                           stride, pad)[:2]
    m, n = x.shape[0] * o1 * o2, w.shape[3]
    tiles = sorted({kernel_tile(bm, bn, m, n) for bm, bn in CONV_I8_TILES})
    errs = {"f32": 0.0, "int8": 0.0}
    for bm, bn in tiles:
        kw = dict(stride=stride, padding=pad, bias=bias, scale=scale)
        e = i8_outputs(
            lambda ep, os: conv.conv_im2col_call(
                x, w, bm=bm, bn=bn, epilogue=ep, out_scale=os, **kw),
            lambda ep, os: conv.conv_i8_plain(x, w, epilogue=ep,
                                              out_scale=os, **kw), EXACT)
        errs = {key: max(errs[key], e[key]) for key in errs}
    path = ("16-byte gather" if conv.conv_i8_vector_path(
        x.shape[3], n, x.data_ptr(), w.data_ptr()) else "byte")
    return path, tiles, errs


def check_conv_i8_edges(conv, rng, dev):
    """``check_conv_i8`` at CONV_I8_EDGE_CASES, operands from the CPU
    generator ``rng``. Returns [(case, path, tiles, errs)]."""
    import torch
    from repro_torch.kernels.common import int8_product
    rows = []
    for label, xs, ws, stride, pad in CONV_I8_EDGE_CASES:
        k = ws[0] * ws[1] * ws[2]
        if label.startswith("+-127"):
            # Every product 127² with one sign per output: |sum| 127² K.
            pix = 1 - 2 * (torch.arange(xs[0] * xs[1] * xs[2]) % 2)
            x = (127 * pix).to(torch.int8)[:, None].expand(-1, xs[3])
            col = 1 - 2 * ((torch.arange(ws[3]) // 5) % 2)
            w = (127 * col).to(torch.int8).expand(k, -1)
            x, w = (x.reshape(xs).contiguous().to(dev),
                    w.reshape(ws).contiguous().to(dev))
            peak = int(int8_product(x.view(-1, k), w.view(k, -1)).abs().max())
            if peak != 127 ** 2 * k:
                raise CheckFailed(f"{label} sums to {peak}, not "
                                  f"{127 ** 2 * k}")
        else:
            x = torch.randint(-127, 128, xs, generator=rng,
                              dtype=torch.int8).to(dev)
            w = torch.randint(-127, 128, ws, generator=rng,
                              dtype=torch.int8).to(dev)
        if label == "x offset":
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            buf[1:].copy_(x.reshape(-1))
            x = buf[1:].view(xs)
        scale = ((torch.rand(ws[3], generator=rng) * 1.5 + 0.5)
                 / (127.0 ** 2 * k ** 0.5 / 3)).to(dev)
        bias = (torch.randn(ws[3], generator=rng) * 0.1).to(dev)
        rows.append(((label, xs, ws, stride, pad), *check_conv_i8(
            conv, x, w, stride, pad, scale, bias)))
    return rows


def pad_accumulate_text(label: str, bsz: int, row: dict) -> str:
    """One line of ``time_pad_accumulate``'s numbers."""
    lib = ("" if "library_ms" not in row else
           f"; grouped F.conv2d (cuDNN, no TF32) {row['library_ms']:.4f} ms "
           f"(profiler {row['library_device_ms']:.4f})")
    plain = ("" if "plain_ms" not in row else
             f", plain {row['plain_ms']:.4f} ms")
    return (f"{label} b{bsz}: kernel {row['ms']:.4f} ms (queued "
            f"{row['queued_ms']:.4f}, profiler {row['device_ms']:.4f}), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"{100 * row['bound_ms'] / row['queued_ms']:.0f}% of it queued)"
            f"{plain}{lib}; max|diff| {row['max_abs_err']:.3e}")


def phases_1_to_25() -> list:
    """Phases 1-25: the kernels, the CNN programs and engines, the LM
    serving path. Returns the per-kernel rows of the JSON line; every
    program, engine and captured graph they made dies with this frame, so
    the LM phases after it start from an empty pool."""
    import torch
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import googlenet, inception_v4, vgg16
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.layouts import LayoutSpec
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels import build
    from repro_torch.kernels.common import INT8_MAX_K, int8_product, pad_nhwc
    from repro_torch.core.quant import layer_errors, plan_mixed_precision
    from repro_torch.kernels.conv_im2col import conv_im2col as conv_mod
    from repro_torch.kernels.conv_im2col.conv_im2col import (
        CONV, CONV_I8, conv_i8_plain, conv_im2col_call, conv_plain)
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    from repro_torch.kernels.gemm.gemm import (BATCHED_GEMM, GEMM, GEMM_I8,
                                              batched_gemm_call,
                                              batched_gemm_plain, gemm_call,
                                              gemm_i8_plain, gemm_plain,
                                              grid_splits, kernel_tile,
                                              sm_count)
    from repro_torch.kernels.gemm.ops import dataflow_blocks
    from repro_torch.kernels.kn2row import kn2row as kn2
    from repro_torch.kernels.kn2row.ops import conv_kn2row
    from repro_torch.kernels.layouts import materialize
    from repro_torch.kernels.winograd import winograd as wino
    from repro_torch.kernels.winograd.ops import conv_winograd
    from repro_torch.distributed.fault import FaultPlan, TickFault
    from repro_torch.serving.cnn_engine import (
        OUTCOME_COMPLETED, OUTCOME_FAILED, OUTCOME_REJECTED, OUTCOME_SHED,
        CNNRequest, CNNServingEngine, DegradeConfig)
    from repro_torch.serving.multi_engine import MultiModelEngine
    from repro_torch.serving.supervisor import (COMPILING, MONITOR,
                                                PlanSupervisor)
    from repro_torch.cnn.executor import ExecutableCache
    from repro_torch.core.cost_model import TransitionCalibration
    from repro_torch.core.mapper import plan_fingerprint, replan
    from repro_torch.cnn import overlay
    from repro_torch.core.autotune import (BACKENDS, Binding, LayerTuning,
                                           TuningRecord, autotune_buckets,
                                           autotune_graph, record_key,
                                           refresh_from_service, tune_elision,
                                           tune_layer)
    from repro_torch.core.cost_model import FPGA_LIKE
    from repro_torch.distributed.sharding import data_shard_count, replicate
    from repro_torch.launch.mesh import DataMesh, make_data_mesh
    from repro_torch.serving.cnn_engine import batch_buckets
    from repro_torch.core.cost_model import Dataflow
    from repro_torch.kernels.common import quantize, weight_scales
    from repro_torch.kernels.conv_im2col.ops import conv_im2col
    sys.path.insert(0, str(SRC.parent / "tools"))
    from bench_autotune import FOUR_PAIRS, backend_report, tuning_summary
    from bench_serving import load_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale: float = 1.0, rng=None):
        rng = gen if rng is None else rng
        return (torch.randn(shape, generator=rng) * scale).to(dev)

    # Every kernel of the port; launch counts are tuples in this order.
    KERNELS = {"conv": CONV, "gemm": GEMM,
               "input_transform": wino.INPUT_TRANSFORM,
               "input_transform_tiles": wino.INPUT_TRANSFORM_TILES,
               "batched_gemm": BATCHED_GEMM,
               "output_transform": wino.OUTPUT_TRANSFORM,
               "unit_conv_gemms": kn2.UNIT_CONV_GEMMS,
               "pad_accumulate": kn2.PAD_ACCUMULATE,
               "gemm_i8": GEMM_I8, "conv_im2col_i8": CONV_I8,
               "unit_conv_gemms_i8": kn2.UNIT_CONV_GEMMS_I8,
               "pad_accumulate_i32": kn2.PAD_ACCUMULATE_I32}
    ALL_KERNELS = tuple(KERNELS.values())
    KERNEL_NAMES = tuple(KERNELS)

    def reset_counts():
        for kern in ALL_KERNELS:
            kern.launches = 0

    def counts():
        return tuple(kern.launches for kern in ALL_KERNELS)

    def launch_text(n):
        return " ".join(f"{k}={v}" for k, v in zip(KERNEL_NAMES, n))

    def expected_launches(lowering, graph):
        """Launches per forward in ALL_KERNELS order, derived from a
        lowering of ``graph``: an im2col layer runs the conv kernel on NHWC
        and the GEMM on its Toeplitz matrix; a Winograd layer the NHWC or
        the stored-tile input transform, the batched GEMM and the output
        transform, once per round (a K x K kernel larger than r runs
        ceil(K/r)^2 rounds, each from NHWC); a kn2row layer both kn2row
        kernels; an int8 layer the int8 form of each."""
        n = Counter()
        for nid, low in lowering.items():
            kind = "nhwc" if low.in_layout is None else low.in_layout.kind
            fam = low.algo.family
            i8 = "_i8" if low.precision == "int8" else ""
            if fam is AlgoFamily.IM2COL:
                n[("gemm" if kind == "toeplitz"
                   else "conv_im2col" if i8 else "conv") + i8] += 1
            elif fam is AlgoFamily.WINOGRAD:
                r = low.algo.r
                rounds = ((graph.nodes[nid].conv.k1 + r - 1) // r) ** 2
                n["input_transform_tiles" if kind == "winograd"
                  else "input_transform"] += rounds
                n["batched_gemm"] += rounds
                n["output_transform"] += rounds
            else:
                n["unit_conv_gemms" + i8] += 1
                n["pad_accumulate_i32" if i8 else "pad_accumulate"] += 1
        return tuple(n[k] for k in KERNEL_NAMES)

    def memory_text():
        return (f"max_memory_reserved "
                f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB")

    def launches_by_name(rows):
        return tuple(rows.get(k, 0) for k in KERNEL_NAMES)

    def graph_launches(graph, lowering, params, x, avg_pool_via="jnp"):
        """The kernel nodes (ALL_KERNELS order) of one CUDA-graph capture
        of the walk a compiled program captures (``capture_forward``'s),
        counted in the graph itself (``graph_kernel_nodes``), not by the
        profiler. The graph is dropped before returning."""
        from repro_torch.cnn.executor import _eval_graph
        static_in = x.clone()
        cuda_graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.inference_mode(), torch.cuda.graph(cuda_graph):
            _eval_graph(graph, lowering, params, static_in, None,
                        avg_pool_via)
        rows = graph_kernel_nodes(cuda_graph)
        del cuda_graph
        return launches_by_name(rows)

    def replay_rows(tag, run, params, x, derived, nodes):
        """The profiler's kernel rows of one replay of ``run``, which must
        equal ``derived``. ``nodes``, the kernel nodes of the same walk's
        capture (``graph_launches``), must equal ``derived`` first: then a
        window whose rows come back short of it (the profiler dropped
        rows; the graph holds them) is taken again, up to three in all,
        and a window with rows past it fails at once."""
        if nodes != derived:
            raise CheckFailed(f"{tag}: the captured graph holds {nodes} "
                              f"kernel nodes, the lowering gives {derived} "
                              f"{KERNEL_NAMES}")
        short = []
        for _ in range(3):
            _, rows = profiled_launches(lambda: run(params, x))
            got = launches_by_name(rows)
            if got == derived:
                return short
            if any(g > d for g, d in zip(got, derived)):
                break
            short.append(got)
        raise CheckFailed(f"{tag}: one replay ran {got} kernel rows, "
                          f"expected {derived} {KERNEL_NAMES} (the graph's "
                          f"kernel nodes {nodes}; short windows before it "
                          f"{short})")

    def staged_runs(tag, run, p, x, want_n, avg_pool_via="jnp"):
        """A compiled program's eager pass, capture and replay on one
        input: the counters read ``want_n`` on the first two and 0 on the
        replay, both later outputs equal the eager one bit for bit, the
        program holds one capture, and the kernel nodes of the captured
        walk and one more replay's profiler rows equal ``want_n``
        (``replay_rows``). Returns (eager output, short windows
        retaken)."""
        outs = []
        for stage, want_stage in (("eager", want_n), ("capture", want_n),
                                  ("replay", (0,) * len(ALL_KERNELS))):
            reset_counts()
            outs.append(run(p, x))
            torch.cuda.synchronize()
            if counts() != want_stage:
                raise CheckFailed(f"{tag} {stage} pass: launches {counts()}"
                                  f", expected {want_stage} {KERNEL_NAMES}")
        for stage, out in zip(("capture", "replay"), outs[1:]):
            if not torch.equal(out, outs[0]):
                raise CheckFailed(
                    f"{tag}: the {stage} pass's logits differ from the eager "
                    f"pass's (max|diff| "
                    f"{float((out - outs[0]).abs().max()):.3e})")
        if len(run.captures) != 1 or None in run.captures.values():
            raise CheckFailed(f"{tag}: not one capture after three calls")
        nodes = graph_launches(run.graph, run.lowering, p, x, avg_pool_via)
        torch.cuda.empty_cache()              # the counted graph's pool
        return outs[0], replay_rows(tag, run, p, x, want_n, nodes)

    def check_forwards(phase, tag, graph, plan, params, res, expect,
                       act_scales=None):
        """Kernels vs the plain path on the card, at every bucket with
        layout elision and at bucket 8 without: the lowering must give the
        launches ``expect[elide]`` (ALL_KERNELS order; None: whatever it
        derives). Each kernel program runs three times on one input — the
        eager warm pass, the CUDA-graph capture (which replays once) and a
        replay: the counters must read the derived launches on the first
        two and 0 on the replay, both later outputs must equal the eager
        one bit for bit, and the kernel nodes of the captured walk and the
        profiler's rows of one more replay must equal the derived launches,
        kernel by kernel (``staged_runs``). The logits must agree with
        the plain program's at the whole-plan tolerance. Returns
        {(elide, bucket): (run_k, run_p, x, logits)}."""
        runs = {}
        for elide, buckets in ((True, BUCKETS), (False, (8,))):
            for bsz in buckets:
                run_k = compile_plan(graph, plan, epilogue="bias_relu",
                                     tuning_batch=bsz, elide=elide,
                                     act_scales=act_scales, device=dev)
                run_p = compile_plan(graph, plan, epilogue="bias_relu",
                                     tuning_batch=bsz, elide=elide,
                                     use_pallas=False, act_scales=act_scales,
                                     device=dev)
                derived = expected_launches(run_k.lowering, graph)
                if expect is not None and derived != expect[elide]:
                    raise CheckFailed(
                        f"{tag} b{bsz} elide={elide}: the lowering gives "
                        f"{derived}, expected {expect[elide]} {KERNEL_NAMES}")
                x = randn(bsz, res, res, 3)
                got, short = staged_runs(f"{tag} b{bsz} elide={elide}",
                                         run_k, params, x, derived)
                retaken = (f"; {len(short)} short profiler window(s) "
                           f"retaken, rows {short}" if short else "")
                want = run_p(params, x)
                err = check_close(f"{tag} b{bsz} elide={elide}", got, want,
                                  **FORWARD_TOL)
                runs[(elide, bsz)] = (run_k, run_p, x, got)
                print(f"[{phase}] {tag} b{bsz} elide={elide}: logits "
                      f"{tuple(got.shape)} max|logit| "
                      f"{float(want.abs().max()):.3e} max|diff| vs plain "
                      f"{err:.3e} (rtol 2e-2 atol 2e-3); capture and replay "
                      f"equal to the eager pass bit for bit; launches on the "
                      f"eager and the capture pass {launch_text(derived)}, "
                      f"0 on a replay; the kernel nodes of the walk's "
                      f"captured graph (driver API) and the profiler's rows "
                      f"of one replay equal them{retaken}")
        return runs

    def serve_checked(phase, tag, graph, plan, params, res, n_requests,
                      seed, per_tick, run_p1, act_scales=None):
        """Serve distinct requests through ``CNNServingEngine``, every
        count reset just before the engine is built — the main path's
        run. Its warm-up dispatches each bucket three times (eager,
        capture, replay), so the counts must read ``per_tick`` twice per
        bucket after it; the served ticks replay, so the counts must not
        move over them, and the profiler must find ``per_tick`` rows of
        each kernel per tick. Each result must match a per-image plain
        forward. Returns the launches the counters read over the whole
        run (ALL_KERNELS order)."""
        reset_counts()
        engine = CNNServingEngine(graph, params, plan, batch_size=8,
                                  slo_s=0.25, warmup=True,
                                  act_scales=act_scales, device=dev)
        warm = counts()
        if warm != tuple(2 * len(engine.buckets) * k for k in per_tick):
            raise CheckFailed(f"{tag} warm-up launches {warm} over "
                              f"{len(engine.buckets)} buckets, expected two "
                              f"passes of {per_tick} each")
        rng = np.random.default_rng(seed)
        images = [rng.standard_normal((res, res, 3)).astype(np.float32)
                  for _ in range(n_requests)]
        windows = []

        def serve():
            """Submit the images under fresh rids and serve them all;
            returns ({image index: result}, ticks, requests served)."""
            base = len(windows) * n_requests
            ticks0 = sum(engine.dispatches.values())
            served0 = engine.served_total
            for i, img in enumerate(images):
                engine.submit(CNNRequest(rid=base + i, image=img))
            done = engine.run_until_done()
            windows.append(base)
            return ({i: done[base + i] for i in range(n_requests)
                     if base + i in done},
                    sum(engine.dispatches.values()) - ticks0,
                    engine.served_total - served0)

        (done, ticks, n_served), rows = profiled_launches(serve)
        served = counts()
        if n_served != n_requests or sorted(done) != list(range(n_requests)):
            raise CheckFailed(f"{tag}: served {n_served} of {n_requests}")
        if served != warm:
            raise CheckFailed(f"{tag}: the counters moved over the replayed "
                              f"ticks, {warm} -> {served}")
        if launches_by_name(rows) != tuple(ticks * k for k in per_tick):
            raise CheckFailed(f"{tag} served kernel rows "
                              f"{launches_by_name(rows)} over {ticks} ticks, "
                              f"expected {per_tick} per tick")
        err = 0.0
        for i, img in enumerate(images):
            want = run_p1(params, img[None])[0]
            got = torch.as_tensor(done[i], device=dev)
            err = max(err, check_close(f"served {tag} request {i}", got,
                                       want, **FORWARD_TOL))
        stats = engine.stats()
        # A correctness check, not a latency measurement: a handful of
        # requests flushed at once, so only each tick's wall time is shown.
        tick_ms = [(t.bucket, round(t.service_s * 1e3, 3))
                   for t in {t.t_dispatch: t
                             for t in engine.request_log}.values()]
        print(f"[{phase}] served {tag} {n_requests} requests in {ticks} "
              f"replayed ticks (profiler windows {len(windows)}), "
              f"dispatches per bucket {stats['dispatches']} (3 warm-up "
              f"each); wall time per tick (bucket, ms) {tick_ms}; "
              f"max|diff| vs per-image plain forward {err:.3e}; launches "
              f"counted over the run (warm-up eager and capture passes) "
              f"{launch_text(warm)}, 0 over the ticks; kernel rows of the "
              f"served ticks (profiler) {launch_text(launches_by_name(rows))}"
              f"; {memory_text()}")
        return served

    # ---- 1. card and toolchain -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    build_s = build.build_all()
    print(f"[1] built {', '.join(build.SOURCES)} in {build_s:.2f} s "
          f"({build.BUILD_DIR})")
    for name, log in build.BUILD_LOG.items():
        for kernel, info in ptxas_report(log):
            print(f"[1] ptxas {name}: {kernel}: {info}")

    # ---- 2. gemm kernel vs plain --------------------------------------
    all_tiles = ((64, 64), (64, 128), (128, 64), (128, 128))
    sms = sm_count(dev)

    def splits_of(m, n, k, tile, groups=1):
        """The K slices the f32 wrappers run for this shape and tile."""
        return grid_splits(m, n, k, tile, sms, groups)

    # Main-path shapes first (conv2: 392 blocks, one slice; a narrow N on a
    # ragged M), then the edges of the split K loop on every tile the
    # wrapper takes at each shape: one element, ragged everything, 5b/1x1
    # and incC's 1x1 at bucket 1 (3 and 2 blocks: the deepest splits), K 70
    # (not split), and 5b/1x1 on operands one float off alignment. The new
    # cases draw from a generator of their own, so the later phases draw
    # the same inputs as without them.
    edge_f32 = torch.Generator().manual_seed(17)
    gemm_cases = [("conv2", 8 * 3136, 576, 192, ((128, 128),), gen),
                  ("ragged", 49 * 8, 832, 32, all_tiles, gen),
                  ("1x1x1", 1, 1, 1, all_tiles, edge_f32),
                  ("17x33x9", 17, 33, 9, all_tiles, edge_f32),
                  ("5b/1x1 b1", 49, 832, 384, all_tiles, edge_f32),
                  ("incC 1x1 b1", 64, 1536, 256, all_tiles, edge_f32),
                  ("K 70", 333, 70, 100, all_tiles, edge_f32),
                  ("offset views", 49, 832, 384, all_tiles, edge_f32)]
    gemm_err = {}
    gemm_inputs = {}
    for label, m, k, n, tiles, rng in gemm_cases:
        a = randn(m, k, rng=rng)
        b = randn(k, n, scale=k ** -0.5, rng=rng)
        bias = randn(n, scale=0.1, rng=rng)
        if label == "offset views":
            a, b = offset_copy(a), offset_copy(b)
        want = gemm_plain(a, b, "bias_relu", bias)
        tiles = sorted({kernel_tile(bm, bn, m, n) for bm, bn in tiles})
        for bm, bn in tiles:
            got = gemm_call(a, b, bm=bm, bn=bn, epilogue="bias_relu",
                            bias=bias)
            torch.cuda.synchronize()
            err = check_close(f"gemm {label} M={m} K={k} N={n} tile "
                              f"({bm},{bn})", got, want, **KERNEL_TOL)
            gemm_err[label] = max(gemm_err.get(label, 0.0), err)
            if splits_of(m, n, k, (bm, bn)) > 1 and not torch.equal(
                    got, gemm_call(a, b, bm=bm, bn=bn, epilogue="bias_relu",
                                   bias=bias)):
                raise CheckFailed(f"gemm {label} tile ({bm},{bn}): two "
                                  "calls of a split product differ")
        got = gemm_call(a, b, epilogue="none")
        check_close(f"gemm {label} no epilogue", got, a @ b, **KERNEL_TOL)
        gemm_inputs[label] = (a, b, bias)
        print(f"[2] gemm {label} M={m} K={k} N={n} bias_relu, (tile): "
              f"K slices " + ", ".join(f"({bm},{bn}): "
                                       f"{splits_of(m, n, k, (bm, bn))}"
                                       for bm, bn in tiles)
              + f": max|diff| {gemm_err[label]:.3e} (rtol/atol 1e-4); split "
              f"outputs equal from call to call")

    # ---- 3. conv kernel vs plain --------------------------------------
    # The first four cases on the wrapper's default tile, from the shared
    # generator; then the edges of the gathered-A async loop on every tile
    # the wrapper takes at each shape, from a generator of their own (the
    # later phases draw the same inputs as without them): K 27 (one whole
    # and one ragged chunk), Iv4 stem/c1, GoogleNet 5b's 1x1 on the 7x7 map
    # at batch 1 (the deepest split), an 8x8 3x3 1536 -> 256 at batch 1
    # (split), Cout 30 (the 4-byte B path), w one float off 16-byte
    # alignment, and M = K = N = 1. Signed inputs and bias_relu throughout;
    # two calls of a split conv must be equal bit for bit.
    edge_conv = torch.Generator().manual_seed(18)
    conv_cases = [("stem", (8, 224, 224, 3), (7, 7, 3, 64), 2, "SAME",
                   ((128, 128),), gen),
                  ("3x3", (8, 56, 56, 64), (3, 3, 64, 192), 1, "SAME",
                   ((128, 128),), gen),
                  ("valid", (4, 17, 17, 32), (3, 3, 32, 48), 2, "VALID",
                   ((128, 128),), gen),
                  ("5x5", (2, 28, 28, 16), (5, 5, 16, 32), 1, "SAME",
                   ((128, 128),), gen),
                  ("K 27", (2, 15, 15, 3), (3, 3, 3, 16), 1, "SAME",
                   all_tiles, edge_conv),
                  ("stem/c1", (8, 299, 299, 3), (3, 3, 3, 32), 2, "VALID",
                   all_tiles, edge_conv),
                  ("5b/1x1 b1", (1, 7, 7, 832), (1, 1, 832, 384), 1, "SAME",
                   all_tiles, edge_conv),
                  ("8x8 3x3 b1", (1, 8, 8, 1536), (3, 3, 1536, 256), 1,
                   "SAME", all_tiles, edge_conv),
                  ("Cout 30", (2, 13, 13, 5), (3, 3, 5, 30), 2, "SAME",
                   all_tiles, edge_conv),
                  ("w offset", (2, 14, 14, 64), (3, 3, 64, 96), 1, "SAME",
                   all_tiles, edge_conv),
                  ("1x1x1", (1, 1, 1, 1), (1, 1, 1, 1), 1, "SAME", all_tiles,
                   edge_conv)]
    conv_err = {}
    conv_inputs = {}
    for label, xs, ws, stride, pad, tiles, rng in conv_cases:
        x = randn(*xs, rng=rng)
        w = randn(*ws, scale=(ws[0] * ws[1] * ws[2]) ** -0.5, rng=rng)
        bias = randn(ws[3], scale=0.1, rng=rng)
        if label == "w offset":
            w = offset_copy(w)
        want = conv_plain(x, w, stride=stride, padding=pad,
                          epilogue="bias_relu", bias=bias)
        o1, o2 = conv_geometry(xs[1], xs[2], ws[0], ws[1], stride, pad)[:2]
        m, k, n = xs[0] * o1 * o2, ws[0] * ws[1] * ws[2], ws[3]
        tiles = sorted({kernel_tile(bm, bn, m, n) for bm, bn in tiles})
        for bm, bn in tiles:
            def call():
                return conv_im2col_call(x, w, stride=stride, padding=pad,
                                        bm=bm, bn=bn, epilogue="bias_relu",
                                        bias=bias)
            got = call()
            torch.cuda.synchronize()
            conv_err[label] = max(conv_err.get(label, 0.0), check_close(
                f"conv {label} tile ({bm},{bn})", got, want, **KERNEL_TOL))
            if splits_of(m, n, k, (bm, bn)) > 1 and not torch.equal(
                    got, call()):
                raise CheckFailed(f"conv {label} tile ({bm},{bn}): two calls "
                                  "of a split conv differ")
        conv_inputs[label] = (x, w, bias, stride, pad)
        print(f"[3] conv {label} x{xs} w{ws} s{stride} {pad} bias_relu "
              f"(M {m} K {k} N {n}), (tile): K slices "
              + ", ".join(f"({bm},{bn}): {splits_of(m, n, k, (bm, bn))}"
                          for bm, bn in tiles)
              + f": max|diff| {conv_err[label]:.3e} (rtol/atol 1e-4); split "
              f"outputs equal from call to call")

    # ---- 4. full-width GoogleNet: kernels vs plain path ---------------
    g = googlenet(res=224, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    if not plan.solver.exact or any(
            a.family is not AlgoFamily.IM2COL
            for a in plan.assignment.values()):
        raise CheckFailed("the GoogleNet plan is not the all-im2col exact "
                          "plan this slice serves")
    params = init_params(g, seed=0, device=dev)
    for nid in sorted(params):
        params[nid]["b"].copy_(randn(*params[nid]["b"].shape, scale=0.05))
    # Launches per forward, in ALL_KERNELS order (KERNEL_NAMES). Elided:
    # 56 convs read their Toeplitz matrix (gemm), the stem reads the NHWC
    # image (conv). Not elided: every conv is NHWC.
    googlenet_expect = {True: (1, 56, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
                        False: (57, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)}
    runs = check_forwards(4, "googlenet 224", g, plan, params, 224,
                          googlenet_expect)

    # ---- 5. serving: the main path ------------------------------------
    gserve = serve_checked(5, "googlenet", g, plan, params, 224, N_REQUESTS,
                           1, googlenet_expect[True], runs[(True, 1)][1])
    gnet = g                    # served again in phase 19; ``g`` is reused

    # ---- 6. timings ---------------------------------------------------
    a, b, bias = gemm_inputs["conv2"]
    m, k = a.shape
    n = b.shape[1]
    g_ms = time_ms(lambda: gemm_call(a, b, epilogue="bias_relu", bias=bias))
    g_dev = queued_ms(lambda: gemm_call(a, b, epilogue="bias_relu",
                                        bias=bias))
    g_plain = time_ms(lambda: gemm_plain(a, b, "bias_relu", bias))
    g_lib = time_ms(lambda: torch.matmul(a, b))
    g_bound, g_by = bound(2.0 * m * n * k, 4.0 * (m * k + k * n + n + m * n))
    print(f"[6] gemm conv2 M={m} K={k} N={n} (K slices "
          f"{splits_of(m, n, k, kernel_tile(128, 128, m, n))}): kernel "
          f"{g_ms:.4f} ms (queued device {g_dev:.4f}), plain {g_plain:.4f} "
          f"ms, torch.matmul {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}; "
          f"67 TFLOP/s f32, 3.35 TB/s)")

    # The smallest-M main-path GEMM at bucket 1: inception 5b's 1x1 conv on
    # the 7x7 map (M = 49) runs on a grid of one tile row, K split S ways.
    # Two launches (GEMM and reduce) from the host take longer than the
    # device does, so the device time comes from queued launches too.
    a5, b5 = randn(49, 832), randn(832, 384, scale=832 ** -0.5)
    s_ms = time_ms(lambda: gemm_call(a5, b5, epilogue="relu"))
    s_dev = queued_ms(lambda: gemm_call(a5, b5, epilogue="relu"))
    s_lib = time_ms(lambda: torch.matmul(a5, b5))
    s_lib_dev = queued_ms(lambda: torch.matmul(a5, b5))
    s_bound, s_by = bound(2.0 * 49 * 832 * 384,
                          4.0 * (49 * 832 + 832 * 384 + 49 * 384))
    s_tile = kernel_tile(128, 128, 49, 384)
    print(f"[6] gemm inception_5b/1x1 b1 M=49 K=832 N=384 (tile {s_tile}, "
          f"grid {-(-384 // s_tile[1])}x1 blocks, K slices "
          f"{splits_of(49, 384, 832, s_tile)}): kernel {s_ms:.4f} ms "
          f"(queued device {s_dev:.4f}), torch.matmul {s_lib:.4f} ms "
          f"(queued device {s_lib_dev:.4f}), bound {s_bound:.4f} ms ({s_by})")

    # The conv at its three elided main-path launches, bucket 8: GoogleNet's
    # stem, VGG16's conv0_0 (the one conv of its device-bound forward) and
    # Inception-v4's stem/c1; the library call is cuDNN on the padded NCHW
    # map, no TF32.
    edge_time = torch.Generator().manual_seed(20)
    conv_times = {}
    for label, xs, ws, stride, pad in (
            ("googlenet stem", (8, 224, 224, 3), (7, 7, 3, 64), 2, "SAME"),
            ("vgg16 conv0_0", (8, 224, 224, 3), (3, 3, 3, 64), 1, "SAME"),
            ("iv4 stem/c1", (8, 299, 299, 3), (3, 3, 3, 32), 2, "VALID")):
        if label == "googlenet stem":
            x, w, cbias = conv_inputs["stem"][:3]
        else:
            x = randn(*xs, rng=edge_time)
            w = randn(*ws, scale=(ws[0] * ws[1] * ws[2]) ** -0.5,
                      rng=edge_time)
            cbias = randn(ws[3], scale=0.1, rng=edge_time)
        bsz, h, w_in, c_in = x.shape
        k1, k2, _, c_out = w.shape
        o1, o2, pt, pb, pl, pr = conv_geometry(h, w_in, k1, k2, stride, pad)
        xp_nchw = pad_nhwc(x, pt, pb, pl, pr).permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def kern():
            return conv_im2col_call(x, w, stride=stride, padding=pad,
                                    epilogue="bias_relu", bias=cbias)

        def lib():
            return F.conv2d(xp_nchw, w_oihw, stride=stride)

        err = check_close(f"conv {label} timed", kern(), conv_plain(
            x, w, stride=stride, padding=pad, epilogue="bias_relu",
            bias=cbias), **KERNEL_TOL)
        c_ms, c_dev = time_ms(kern), queued_ms(kern)
        c_plain = time_ms(lambda: conv_plain(
            x, w, stride=stride, padding=pad, epilogue="bias_relu",
            bias=cbias))
        c_lib = time_ms(lib)
        m = bsz * o1 * o2
        c_flops = 2.0 * m * c_out * k1 * k2 * c_in
        c_bytes = 4.0 * (x.numel() + w.numel() + c_out + m * c_out)
        c_bound, c_by = bound(c_flops, c_bytes)
        tile = kernel_tile(128, 128, m, c_out)
        conv_times[label] = (c_ms, c_plain, c_lib, c_bound, c_by, err)
        print(f"[6] conv {label} x{tuple(x.shape)} w{tuple(w.shape)} "
              f"s{stride} {pad} (tile {tile}, "
              f"{-(-m // tile[0]) * -(-c_out // tile[1])} blocks, K slices "
              f"{splits_of(m, c_out, k1 * k2 * c_in, tile)}): kernel "
              f"{c_ms:.4f} ms (queued device {c_dev:.4f}), plain "
              f"{c_plain:.4f} ms, F.conv2d (cuDNN, no TF32) {c_lib:.4f} ms, "
              f"bound {c_bound:.4f} ms ({c_by}); max|diff| {err:.3e}")

    for bsz in BUCKETS:
        run_k, run_p, x, _ = runs[(True, bsz)]
        f_ms = time_ms(lambda: run_k(params, x), reps=10, rounds=5)
        p_ms = time_ms(lambda: run_p(params, x), reps=10, rounds=5)
        dev_ms, split, _ = device_time(lambda: run_k(params, x))
        print(f"[6] googlenet 224 forward b{bsz} (elide, replay): kernels "
              f"{f_ms:.3f} ms, plain path {p_ms:.3f} ms; device busy "
              f"{dev_ms:.3f} ms of the kernels' forward "
              f"({100 * dev_ms / f_ms:.1f}%) = {split} (ms); "
              f"{memory_text()}")
    # Release GoogleNet's captured graphs and their memory pools.
    del runs, run_k, run_p

    # ---- 7. Winograd kernels vs plain ----------------------------------
    # (label, batch, map, Cin, Cout, m): VGG16's conv0_1 and conv2_1 at
    # bucket 8 in F(4,3), conv2_1 in F(2,3), and a 14x14 map whose 16x16
    # tile grid the output transform crops inside the kernel.
    wino_cases = [("conv0_1", 8, 224, 64, 64, 4),
                  ("conv2_1", 8, 56, 256, 256, 4),
                  ("conv2_1 F(2,3)", 8, 56, 256, 256, 2),
                  ("ragged 14x14", 2, 14, 32, 48, 4)]
    wino_err = {}
    wino_inputs = {}
    for label, bsz, hw, c_in, c_out, m in wino_cases:
        t = m + 2
        tiles_yx = -(-hw // m)
        geo = dict(m=m, tiles_y=tiles_yx, tiles_x=tiles_yx)
        x = randn(bsz, hw, hw, c_in)
        w = randn(3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5)
        bias = randn(c_out, scale=0.1)
        errs = {}
        v_p = wino.input_transform_plain(x, pad_top=1, pad_left=1, **geo)
        v_k = wino.input_transform_call(x, pad_top=1, pad_left=1, **geo)
        torch.cuda.synchronize()
        errs["input_transform"] = check_close(
            f"input_transform {label}", v_k, v_p, **KERNEL_TOL)
        spec = LayoutSpec("winograd", h=hw, w=hw, c=c_in, k1=3, k2=3, m=m,
                          r=3)
        tiles = materialize(x, spec).reshape(-1, t, t, c_in).contiguous()
        vt_k = wino.input_transform_tiles_call(tiles, m=m)
        torch.cuda.synchronize()
        errs["input_transform_tiles"] = check_close(
            f"input_transform_tiles {label}", vt_k,
            wino.input_transform_tiles_plain(tiles, m=m), **KERNEL_TOL)
        check_close(f"input_transform_tiles {label} vs NHWC transform",
                    vt_k, v_k, **KERNEL_TOL)
        u = wino.transform_kernel_weights(w, m, 3)
        mm_p = batched_gemm_plain(v_p, u)
        mm_k = batched_gemm_call(v_p, u)
        torch.cuda.synchronize()
        errs["batched_gemm"] = check_close(
            f"batched_gemm {label} G={t * t} M={v_p.shape[1]} K={c_in} "
            f"N={c_out}", mm_k, mm_p, **KERNEL_TOL)
        out_geo = dict(geo, o1=hw, o2=hw, epilogue="bias_relu", bias=bias)
        y_k = wino.output_transform_call(mm_p, **out_geo)
        torch.cuda.synchronize()
        errs["output_transform"] = check_close(
            f"output_transform {label}", y_k,
            wino.output_transform_plain(mm_p, **out_geo), **KERNEL_TOL)
        # The whole Winograd conv against the vendor conv (the reference's
        # Winograd tolerance).
        got = conv_winograd(x, w, m=m, epilogue="bias_relu", bias=bias)
        want = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), w.permute(
            3, 2, 0, 1), bias, padding=1).permute(0, 2, 3, 1))
        torch.cuda.synchronize()
        conv_e = check_close(f"conv_winograd {label} vs F.conv2d", got,
                             want, rtol=2e-3, atol=2e-3)
        wino_err[label] = errs
        wino_inputs[label] = (x, w, bias, m, v_p, tiles, u, mm_p)
        print(f"[7] winograd F({m},3) {label} x({bsz}, {hw}, {hw}, {c_in})"
              f" Cout {c_out}: max|diff| vs plain "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (rtol/atol 1e-4); whole conv vs F.conv2d {conv_e:.3e} "
              f"(2e-3)")
    # The batched GEMM at the edges of the async loop on every tile the
    # wrapper takes at each shape, bias_relu on signed inputs: the ragged
    # G 16 case from the shared generator, then, from a generator of their
    # own, G 1, M = K = N = 1, N 30 (the 4-byte B path and the scalar
    # flush), B one float off 16-byte alignment, and Inception-v4's incA
    # b4c at bucket 1 (G 36, M 81, K = N = 96: 36 blocks, K not split).
    edge_bg = torch.Generator().manual_seed(19)
    bg_err = {}
    for label, g_, m, k, n, rng in (("ragged", 16, 333, 70, 100, gen),
                                    ("G 1", 1, 200, 96, 64, edge_bg),
                                    ("1x1x1", 3, 1, 1, 1, edge_bg),
                                    ("N 30", 4, 70, 40, 30, edge_bg),
                                    ("B offset", 4, 100, 64, 64, edge_bg),
                                    ("incA b4c b1", 36, 81, 96, 96,
                                     edge_bg)):
        a = randn(g_, m, k, rng=rng)
        b = randn(g_, k, n, scale=k ** -0.5, rng=rng)
        bias = randn(n, scale=0.1, rng=rng)
        if label == "B offset":
            b = offset_copy(b)
        want = batched_gemm_plain(a, b, "bias_relu", bias)
        tiles = sorted({kernel_tile(bm, bn, m, n) for bm, bn in all_tiles})
        for bm, bn in tiles:
            got = batched_gemm_call(a, b, bm=bm, bn=bn, epilogue="bias_relu",
                                    bias=bias)
            torch.cuda.synchronize()
            bg_err[label] = max(bg_err.get(label, 0.0), check_close(
                f"batched_gemm {label} tile ({bm},{bn})", got, want,
                **KERNEL_TOL))
        print(f"[7] batched_gemm {label} G={g_} M={m} K={k} N={n} bias_relu "
              f"tiles {tiles} (K slices: 1): max|diff| {bg_err[label]:.3e} "
              f"(rtol/atol 1e-4)")
    x = randn(2, 28, 28, 16)
    w = randn(5, 5, 16, 32, scale=400 ** -0.5)
    got = conv_winograd(x, w, m=4)
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=2).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    mr_err = check_close("conv_winograd 5x5 multi-round vs F.conv2d", got,
                         want, rtol=2e-3, atol=2e-3)
    print(f"[7] conv_winograd 5x5 F(4,3) multi-round (4 rounds) x(2, 28, 28,"
          f" 16) Cout 32 vs F.conv2d: max|diff| {mr_err:.3e} (2e-3)")

    # ---- 8. full-width VGG16: kernels vs plain path --------------------
    gv = vgg16(res=224, scale=1.0)
    vplan = map_network(gv, hw=identify_parameters(gv, max_dim=512))
    algos = sorted(vplan.assignment[n.id].key for n in gv.conv_nodes())
    if not vplan.solver.exact or algos != ["im2col"] * 8 + [
            "winograd(F4x3)"] * 5:
        raise CheckFailed(f"the VGG16 plan is not the exact 8 im2col + 5 "
                          f"F(4,3) plan this slice serves: {algos}")
    vparams = init_params(gv, seed=1, device=dev)
    for nid in sorted(vparams):
        vparams[nid]["b"].copy_(randn(*vparams[nid]["b"].shape,
                                      scale=0.05))
    # Launches per forward, in ALL_KERNELS order (KERNEL_NAMES). Elided:
    # conv0_0 reads the image (conv), seven im2col layers their Toeplitz
    # matrix (gemm), the five Winograd layers their stored tiles; not
    # elided: every layer reads NHWC. No kn2row layer.
    vgg_expect = {True: (1, 7, 0, 5, 5, 5, 0, 0, 0, 0, 0, 0),
                  False: (8, 0, 5, 0, 5, 5, 0, 0, 0, 0, 0, 0)}
    vruns = check_forwards(8, "vgg16 224", gv, vplan, vparams, 224,
                           vgg_expect)

    # ---- 9. serving VGG16 ---------------------------------------------
    vserve = serve_checked(9, "vgg16", gv, vplan, vparams, 224,
                           N_VGG_REQUESTS, 2, vgg_expect[True],
                           vruns[(True, 1)][1])

    # ---- 10. Winograd timings ------------------------------------------
    wino_times = {}
    for label in ("conv0_1", "conv2_1"):
        x, w, bias, m, v_p, tiles, u, mm_p = wino_inputs[label]
        bsz, hw, _, c_in = x.shape
        c_out = w.shape[-1]
        t = m + 2
        n_tiles = v_p.shape[1]
        geo = dict(m=m, tiles_y=-(-hw // m), tiles_x=-(-hw // m))
        out_geo = dict(geo, o1=hw, o2=hw, epilogue="bias_relu", bias=bias)
        v_bytes = 4.0 * t * t * n_tiles * c_in
        m_bytes = 4.0 * t * t * n_tiles * c_out
        # The library calls: the tile transform is one einsum; the NHWC
        # transform is one depthwise conv (cuDNN) with the T² outer
        # products of Bᵀ's rows as filters, stride m, which gives V's
        # values in (B, C·T², tiles_y, tiles_x) order (checked below;
        # these maps need no bottom/right fill beyond the halo).
        bt, _, _ = wino.torch_matrices(m, 3, dev)
        filt = torch.einsum("ti,uj->tuij", bt, bt).reshape(
            t * t, 1, t, t).repeat(c_in, 1, 1, 1)
        x_nchw = x.permute(0, 3, 1, 2)

        def depthwise():
            return F.conv2d(x_nchw, filt, stride=m, padding=1, groups=c_in)

        check_close(f"depthwise-conv input transform {label}",
                    depthwise().reshape(bsz, c_in, t * t, -1).permute(
                        2, 0, 3, 1).reshape(t * t, n_tiles, c_in), v_p,
                    **KERNEL_TOL)
        # The output transform's: Aᵀ M A as one einsum, then bias and
        # ReLU, its (tile, m, m, C) result in tile order (checked against
        # the plain version once the blocks are put in place).
        _, _, at = wino.torch_matrices(m, 3, dev)
        mm4 = mm_p.reshape(t, t, n_tiles, c_out)

        def einsum_out():
            return torch.relu(torch.einsum("ai,ijnc,bj->nabc", at, mm4, at)
                              + bias)

        check_close(f"einsum output transform {label}",
                    einsum_out().reshape(
                        bsz, geo["tiles_y"], geo["tiles_x"], m, m,
                        c_out).permute(0, 1, 3, 2, 4, 5).reshape(
                        bsz, geo["tiles_y"] * m, geo["tiles_x"] * m,
                        c_out)[:, :hw, :hw],
                    wino.output_transform_plain(mm_p, **out_geo),
                    **KERNEL_TOL)
        rows = {
            "input_transform": (
                lambda: wino.input_transform_call(x, pad_top=1, pad_left=1,
                                                  **geo),
                lambda: wino.input_transform_plain(x, pad_top=1, pad_left=1,
                                                   **geo),
                ("F.conv2d depthwise (cuDNN, no TF32)", depthwise),
                bound(n_tiles * c_in * TRANSFORM_FLOPS[("in", m)],
                      4.0 * x.numel() + v_bytes)),
            "input_transform_tiles": (
                lambda: wino.input_transform_tiles_call(tiles, m=m),
                lambda: wino.input_transform_tiles_plain(tiles, m=m),
                ("torch.einsum", lambda: torch.einsum(
                    "ti,nijc,uj->tunc", bt, tiles, bt)),
                bound(n_tiles * c_in * TRANSFORM_FLOPS[("in", m)],
                      4.0 * tiles.numel() + v_bytes)),
            "output_transform": (
                lambda: wino.output_transform_call(mm_p, **out_geo),
                lambda: wino.output_transform_plain(mm_p, **out_geo),
                ("torch.einsum + bias + ReLU", einsum_out),
                bound(n_tiles * c_out * TRANSFORM_FLOPS[("out", m)],
                      m_bytes + 4.0 * (c_out + bsz * hw * hw * c_out))),
        }
        for name, (kern, plain, lib, (b_ms, b_by)) in rows.items():
            k_ms, p_ms = time_ms(kern), time_ms(plain)
            l_ms = time_ms(lib[1]) if lib is not None else None
            # Kernel and library also on one measure: profiler device time.
            k_dev = device_time(kern, reps=20)[0]
            wino_times[(name, label)] = (k_ms, p_ms, l_ms, b_ms, b_by)
            lib_txt = ("library: none" if lib is None else
                       f"{lib[0]} {l_ms:.4f} ms (profiler "
                       f"{device_time(lib[1], reps=20)[0]:.4f})")
            print(f"[10] {name} {label} b{bsz} F({m},3): kernel "
                  f"{k_ms:.4f} ms (profiler {k_dev:.4f}), plain {p_ms:.4f} "
                  f"ms, {lib_txt}, bound {b_ms:.4f} ms ({b_by}; "
                  f"{100 * b_ms / k_dev:.0f}% of it by the profiler)")

    # The batched GEMM beside torch.bmm and its bound at VGG16's conv0_1
    # and conv2_1 (bucket 8; their rows of wino_times) and Inception-v4's
    # incA0/b4c (35x35, 96 -> 96, F(4,3): G 36, M 81 per image) at buckets
    # 1 and 8, by events and by queued launches (device time without host
    # gaps).
    edge_bgt = torch.Generator().manual_seed(21)
    bg_shapes = [(f"{key} b8", key, *wino_inputs[key][4:7:2])
                 for key in ("conv0_1", "conv2_1")]
    for bsz in (1, 8):
        bg_shapes.append((f"incA0/b4c b{bsz}", None,
                          randn(36, 81 * bsz, 96, rng=edge_bgt),
                          randn(36, 96, 96, scale=96 ** -0.5,
                                rng=edge_bgt)))
    for label, key, v, u in bg_shapes:
        g_, m, k = v.shape
        n = u.shape[-1]
        check_close(f"batched_gemm {label} timed", batched_gemm_call(v, u),
                    batched_gemm_plain(v, u), **KERNEL_TOL)
        tile = kernel_tile(128, 128, m, n)
        k_ms = time_ms(lambda: batched_gemm_call(v, u))
        k_dev = queued_ms(lambda: batched_gemm_call(v, u))
        p_ms = time_ms(lambda: batched_gemm_plain(v, u))
        l_ms = time_ms(lambda: torch.bmm(v, u))
        l_dev = queued_ms(lambda: torch.bmm(v, u))
        b_ms, b_by = bound(2.0 * g_ * m * k * n,
                           4.0 * g_ * (m * k + k * n + m * n))
        if key is not None:
            wino_times[("batched_gemm", key)] = (k_ms, p_ms, l_ms, b_ms, b_by)
        print(f"[10] batched_gemm {label} G={g_} M={m} K={k} N={n} (tile "
              f"{tile}, {g_ * -(-m // tile[0]) * -(-n // tile[1])} blocks, "
              f"K not split): kernel {k_ms:.4f} ms (queued device "
              f"{k_dev:.4f}), plain {p_ms:.4f} ms, torch.bmm (no TF32) "
              f"{l_ms:.4f} ms (queued device {l_dev:.4f}), bound "
              f"{b_ms:.4f} ms ({b_by})")

    # Per Winograd layer of VGG16 at bucket 8: the three kernels of the
    # NHWC pipeline (each timed alone, summed) vs cuDNN vs this port's
    # im2col kernel on the same layer, all with bias.
    for name, hw, c_in, c_out in (("conv0_1", 224, 64, 64),
                                  ("conv1_0", 112, 64, 128),
                                  ("conv1_1", 112, 128, 128),
                                  ("conv2_1", 56, 256, 256),
                                  ("conv2_2", 56, 256, 256)):
        x = randn(8, hw, hw, c_in)
        w = randn(3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5)
        bias = randn(c_out, scale=0.1)
        geo = dict(m=4, tiles_y=-(-hw // 4), tiles_x=-(-hw // 4))
        u = wino.transform_kernel_weights(w, 4, 3)
        v = wino.input_transform_call(x, pad_top=1, pad_left=1, **geo)
        mm = batched_gemm_call(v, u)
        it_ms = time_ms(lambda: wino.input_transform_call(
            x, pad_top=1, pad_left=1, **geo))
        bg_ms = time_ms(lambda: batched_gemm_call(v, u))
        ot_ms = time_ms(lambda: wino.output_transform_call(
            mm, o1=hw, o2=hw, epilogue="bias_relu", bias=bias, **geo))
        layer_ms = time_ms(lambda: conv_winograd(
            x, w, m=4, epilogue="bias_relu", bias=bias))
        wt_ms = time_ms(lambda: wino.transform_kernel_weights(w, 4, 3))
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        cudnn_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw, bias,
                                            padding=1))
        im2col_ms = time_ms(lambda: conv_im2col_call(
            x, w, epilogue="bias_relu", bias=bias))
        l_bound, l_by = bound(2.0 * 8 * hw * hw * c_out * 9 * c_in,
                              4.0 * (x.numel() + w.numel() + c_out
                                     + 8 * hw * hw * c_out))
        print(f"[10] vgg16 {name} b8 {hw}x{hw} {c_in}->{c_out}: winograd "
              f"F(4,3) kernels {it_ms + bg_ms + ot_ms:.4f} ms (input "
              f"{it_ms:.4f} + gemm {bg_ms:.4f} + output {ot_ms:.4f}; the "
              f"call {layer_ms:.4f} with the weight transform, alone "
              f"{wt_ms:.4f}), F.conv2d "
              f"(cuDNN, no TF32) {cudnn_ms:.4f} ms, im2col kernel "
              f"{im2col_ms:.4f} ms; direct-conv bound {l_bound:.4f} ms "
              f"({l_by})")

    for bsz in BUCKETS:
        run_k, run_p, x, _ = vruns[(True, bsz)]
        f_ms = time_ms(lambda: run_k(vparams, x), reps=5, rounds=5)
        p_ms = time_ms(lambda: run_p(vparams, x), reps=5, rounds=5)
        dev_ms, split, _ = device_time(lambda: run_k(vparams, x))
        print(f"[10] vgg16 224 forward b{bsz} (elide, replay): kernels "
              f"{f_ms:.3f} ms, plain path {p_ms:.3f} ms; device busy "
              f"{dev_ms:.3f} ms of the kernels' forward "
              f"({100 * dev_ms / f_ms:.1f}%) = {split} (ms; the Winograd "
              f"tile and Toeplitz gathers are 'torch index/gather'); "
              f"{memory_text()}")
    # Release VGG16's captured graphs and their memory pools.
    del vruns, run_k, run_p

    def nchw_conv_inputs(x, w, stride, padding):
        """x (B, H, W, Cin) and w (K1, K2, Cin, Cout) as ``F.conv2d`` takes
        them: NCHW with the (asymmetric) SAME pad applied, and OIHW."""
        k1, k2 = int(w.shape[0]), int(w.shape[1])
        _, _, pt, pb, pl, pr = conv_geometry(x.shape[1], x.shape[2], k1, k2,
                                             stride, padding)
        return (pad_nhwc(x, pt, pb, pl, pr).permute(0, 3, 1, 2).contiguous(),
                w.permute(3, 2, 0, 1).contiguous())

    # ---- 11. kn2row kernels vs plain -----------------------------------
    kn2_err = {"unit_conv_gemms": {}, "pad_accumulate": {}}
    kn2_inputs = {}
    for label in ("stem/c4", "stem/c5", "incC/b4d", "incC/b4e", "redA/b3a"):
        hw, k1, k2, stride, pad, c_in, c_out = KN2ROW_LAYERS[label]
        x = randn(8, hw, hw, c_in)
        w = randn(k1, k2, c_in, c_out, scale=(k1 * k2 * c_in) ** -0.5)
        bias = randn(c_out, scale=0.1)
        x2d, wg = x.reshape(-1, c_in), w.reshape(k1 * k2, c_in, c_out)
        p_plain = kn2.unit_conv_gemms_plain(x2d, wg)
        p_kern = kn2.unit_conv_gemms_call(x2d, wg)
        torch.cuda.synchronize()
        kn2_err["unit_conv_gemms"][label] = check_close(
            f"unit_conv_gemms {label} G={k1 * k2} M={x2d.shape[0]} "
            f"K={c_in} N={c_out}", p_kern, p_plain, **KERNEL_TOL)
        del p_kern
        o1, o2, pt, _, pl, _ = conv_geometry(hw, hw, k1, k2, stride, pad)
        geo = dict(k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, pad_top=pt,
                   pad_left=pl)
        p5 = p_plain.view(k1 * k2, 8, hw, hw, c_out)
        pa_err = 0.0
        for ep in ("none", "relu", "bias", "bias_relu"):
            got = kn2.pad_accumulate_call(p5, epilogue=ep, bias=bias, **geo)
            torch.cuda.synchronize()
            pa_err = max(pa_err, check_close(
                f"pad_accumulate {label} {ep}", got,
                kn2.pad_accumulate_plain(p5, epilogue=ep, bias=bias, **geo),
                **KERNEL_TOL))
        kn2_err["pad_accumulate"][label] = pa_err
        kn2_inputs[label] = (x, w, bias, x2d, wg, p5, geo)
        path = ("vector" if kn2.accumulate_vector_path(p5, got)
                else "one-channel")
        print(f"[11] kn2row {label} b8 {hw}x{hw} {k1}x{k2} s{stride} {pad} "
              f"{c_in}->{c_out}: max|diff| vs plain unit_conv_gemms "
              f"{kn2_err['unit_conv_gemms'][label]:.3e}, pad_accumulate "
              f"{pa_err:.3e} (four epilogues, {path} path; rtol/atol 1e-4)")
    # pad_accumulate_f32 at the edges of its paths (p drawn on the card
    # from a generator of its own).
    edge_pa = torch.Generator(device=dev).manual_seed(23)
    for (label, shape, k1, k2, stride, pad), path, errs in \
            check_pad_accumulate_edges(kn2, edge_pa, quant=False):
        print(f"[11] pad_accumulate_f32 {label} p{shape} {k1}x{k2} s{stride} "
              f"{pad}, {path} path, four epilogues: max|diff| "
              f"{errs['f32']:.3e} (rtol/atol 1e-4)")
    a, b = randn(333, 70), randn(3, 70, 100, scale=70 ** -0.5)
    want = kn2.unit_conv_gemms_plain(a, b)
    ucg_ragged = 0.0
    for bm, bn in ((64, 64), (64, 128), (128, 64), (128, 128)):
        got = kn2.unit_conv_gemms_call(a, b, bm=bm, bn=bn)
        torch.cuda.synchronize()
        ucg_ragged = max(ucg_ragged, check_close(
            f"unit_conv_gemms ragged tile ({bm},{bn})", got, want,
            **KERNEL_TOL))
    print(f"[11] unit_conv_gemms ragged G=3 M=333 K=70 N=100 tiles "
          f"(64|128)x(64|128): max|diff| {ucg_ragged:.3e} (rtol/atol 1e-4)")
    # Split K on every tile the wrapper takes: incC0/b4d's shape at bucket 8
    # and G 9 on a ragged M and K (the last slice short), from the phase-2
    # edge generator.
    for label, g_, m, k, n in (("incC0/b4d", 3, 512, 512, 256),
                               ("G 9 ragged M", 9, 333, 264, 96)):
        a = randn(m, k, rng=edge_f32)
        b = randn(g_, k, n, scale=k ** -0.5, rng=edge_f32)
        want = kn2.unit_conv_gemms_plain(a, b)
        tiles = sorted({kernel_tile(bm, bn, m, n) for bm, bn in all_tiles})
        err = 0.0
        for bm, bn in tiles:
            got = kn2.unit_conv_gemms_call(a, b, bm=bm, bn=bn)
            torch.cuda.synchronize()
            err = max(err, check_close(
                f"unit_conv_gemms {label} tile ({bm},{bn})", got, want,
                **KERNEL_TOL))
            if splits_of(m, n, k, (bm, bn), g_) > 1 and not torch.equal(
                    got, kn2.unit_conv_gemms_call(a, b, bm=bm, bn=bn)):
                raise CheckFailed(f"unit_conv_gemms {label} tile ({bm},{bn})"
                                  ": two calls of a split product differ")
        print(f"[11] unit_conv_gemms {label} G={g_} M={m} K={k} N={n}, "
              f"(tile): K slices " + ", ".join(
                  f"({bm},{bn}): {splits_of(m, n, k, (bm, bn), g_)}"
                  for bm, bn in tiles)
              + f": max|diff| {err:.3e} (rtol/atol 1e-4); split outputs "
              f"equal from call to call")
    # Whole kn2row convs against cuDNN on the reference's seven cases
    # (tests/test_kernels.py), a distinct random image in every batch slot.
    conv_cases = [(14, 14, 8, 16, 3, 3, 1, "SAME"),
                  (28, 28, 4, 8, 5, 5, 1, "SAME"),
                  (15, 15, 3, 8, 3, 3, 2, "SAME"),
                  (14, 14, 8, 8, 1, 1, 1, "SAME"),
                  (16, 16, 6, 10, 7, 7, 2, "SAME"),
                  (14, 14, 8, 16, 3, 3, 1, "VALID"),
                  (10, 10, 6, 10, 1, 7, 1, "SAME")]
    kn2_conv_err = 0.0
    for h, w_in, c_in, c_out, k1, k2, stride, pad in conv_cases:
        for bsz in (1, 3):
            x = randn(bsz, h, w_in, c_in)
            w = randn(k1, k2, c_in, c_out, scale=(k1 * k2 * c_in) ** -0.5)
            bias = randn(c_out, scale=0.1)
            got = conv_kn2row(x, w, stride=stride, padding=pad,
                              epilogue="bias_relu", bias=bias)
            xp, wo = nchw_conv_inputs(x, w, stride, pad)
            want = torch.relu(F.conv2d(xp, wo, bias, stride=stride)
                              ).permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            kn2_conv_err = max(kn2_conv_err, check_close(
                f"conv_kn2row {h}x{w_in} {k1}x{k2} s{stride} {pad} "
                f"b{bsz} vs F.conv2d", got, want, **KERNEL_TOL))
    print(f"[11] conv_kn2row vs F.conv2d (cuDNN, no TF32), bias_relu, the "
          f"seven reference cases at batch 1 and 3: max|diff| "
          f"{kn2_conv_err:.3e} (rtol/atol 1e-4)")

    # ---- 12. full-width Inception-v4: kernels vs plain path ------------
    gi = inception_v4(res=299, scale=1.0)
    iplan = map_network(gi, hw=identify_parameters(gi, max_dim=512))
    mix = Counter(a.key for a in iplan.assignment.values())
    if not iplan.solver.exact or mix != {"im2col": 117, "kn2row": 16,
                                         "winograd(F4x3)": 16}:
        raise CheckFailed(f"the Inception-v4 plan is not the exact 117 "
                          f"im2col + 16 kn2row + 16 F(4,3) plan this slice "
                          f"serves: {dict(mix)}")
    gflop = Counter()
    for node in gi.conv_nodes():
        gflop[iplan.assignment[node.id].family.value] += 2e-9 * node.conv.macs
    print(f"[12] inception_v4 299 plan {dict(mix)}: conv GFLOP per image "
          f"(2·MACs of the direct conv) {sum(gflop.values()):.2f} = "
          + ", ".join(f"{k} {v:.2f}" for k, v in gflop.items()))
    iparams = init_params(gi, seed=2, device=dev)
    for nid in sorted(iparams):
        iparams[nid]["b"].copy_(randn(*iparams[nid]["b"].shape, scale=0.05))
    # Elided: stem/c1 reads the image (conv), 116 im2col layers their
    # Toeplitz matrix (gemm), the 16 Winograd layers their stored tiles;
    # not elided: every layer reads NHWC. Every kn2row layer reads NHWC.
    iv4_expect = {True: (1, 116, 0, 16, 16, 16, 16, 16, 0, 0, 0, 0),
                  False: (117, 0, 16, 0, 16, 16, 16, 16, 0, 0, 0, 0)}
    iruns = check_forwards(12, "inception_v4 299", gi, iplan, iparams, 299,
                           iv4_expect)

    # ---- 13. serving Inception-v4 --------------------------------------
    iserve = serve_checked(13, "inception_v4", gi, iplan, iparams, 299,
                           N_IV4_REQUESTS, 3, iv4_expect[True],
                           iruns[(True, 1)][1])

    # ---- 14. kn2row timings ---------------------------------------------
    kn2_times = {}
    for label in ("stem/c4", "stem/c5", "incC/b4d"):
        x, w, bias, x2d, wg, p5, geo = kn2_inputs[label]
        g_, bsz, hw, _, c_out = p5.shape
        m, c_in = x2d.shape
        check_close(f"torch.matmul unit_conv_gemms {label}",
                    torch.matmul(x2d, wg), p5.reshape(g_, m, c_out),
                    **KERNEL_TOL)

        def kern():
            return kn2.unit_conv_gemms_call(x2d, wg)

        def lib():
            return torch.matmul(x2d, wg)

        k_ms, l_ms = time_ms(kern), time_ms(lib)
        p_ms = time_ms(lambda: kn2.unit_conv_gemms_plain(x2d, wg))
        b_ms, b_by = bound(2.0 * g_ * m * c_in * c_out,
                           4.0 * (m * c_in + g_ * c_in * c_out
                                  + g_ * m * c_out))
        kn2_times[("unit_conv_gemms", label)] = (k_ms, p_ms, l_ms, b_ms, b_by)
        # Back-to-back launches of a small kernel measure the host's
        # launch rate; the profiler's kernel rows give the device time
        # (over 20 calls: a single call's one kernel row can be lost).
        k_dev, l_dev = (device_time(fn, reps=20)[0] for fn in (kern, lib))
        tile = kernel_tile(128, 128, m, c_out)
        print(f"[14] unit_conv_gemms {label} b{bsz} (K slices "
              f"{splits_of(m, c_out, c_in, tile, g_)}): kernel {k_ms:.4f} "
              f"ms, plain {p_ms:.4f} ms, torch.matmul (cuBLAS, no TF32) "
              f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); device time of "
              f"one call (profiler): kernel {k_dev:.4f}, library "
              f"{l_dev:.4f} ms")

    # pad_accumulate at every distinct launch of the f32 forward, buckets 1
    # and 8 (p drawn on the card from a generator of its own), and the
    # sums weighted by launches per forward.
    pa_rng = torch.Generator(device=dev).manual_seed(22)
    for bsz in (1, 8):
        sums = dict(queued_ms=0.0, bound_ms=0.0, device_ms=0.0,
                    library_device_ms=0.0)
        for label, count in PAD_ACCUMULATE_LAUNCHES.items():
            row = time_pad_accumulate(kn2, label, bsz, pa_rng,
                                      plain=(label, bsz) == ("stem/c4", 8))
            for key in sums:
                sums[key] += count * row[key]
            if (label, bsz) == ("stem/c4", 8):
                kn2_times[("pad_accumulate", label)] = tuple(
                    row[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by"))
            print(f"[14] pad_accumulate_f32 x{count} "
                  + pad_accumulate_text(label, bsz, row))
        gap = sums["queued_ms"] - sums["bound_ms"]
        print(f"[14] pad_accumulate_f32 b{bsz}, the 16 launches of a "
              f"forward: queued {sums['queued_ms']:.4f} ms, bound "
              f"{sums['bound_ms']:.4f} ms, gap {gap:.4f} ms; profiler: "
              f"kernel {sums['device_ms']:.4f} ms, grouped F.conv2d "
              f"{sums['library_device_ms']:.4f} ms")

    # Per distinct kn2row layer of Inception-v4 at bucket 8: the two
    # kernels (each timed alone, summed) vs cuDNN vs this port's im2col
    # kernel on the same layer, all with bias.
    for label, (hw, k1, k2, stride, pad, c_in, c_out) in \
            KN2ROW_LAYERS.items():
        x = randn(8, hw, hw, c_in)
        w = randn(k1, k2, c_in, c_out, scale=(k1 * k2 * c_in) ** -0.5)
        bias = randn(c_out, scale=0.1)
        x2d, wg = x.reshape(-1, c_in), w.reshape(k1 * k2, c_in, c_out)
        o1, o2, pt, _, pl, _ = conv_geometry(hw, hw, k1, k2, stride, pad)
        geo = dict(k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, pad_top=pt,
                   pad_left=pl)
        p5 = kn2.unit_conv_gemms_call(x2d, wg).view(k1 * k2, 8, hw, hw,
                                                    c_out)
        ucg_ms = time_ms(lambda: kn2.unit_conv_gemms_call(x2d, wg))
        pa_ms = time_ms(lambda: kn2.pad_accumulate_call(
            p5, epilogue="bias_relu", bias=bias, **geo))
        layer_ms = time_ms(lambda: conv_kn2row(
            x, w, stride=stride, padding=pad, epilogue="bias_relu",
            bias=bias))
        xp, wo = nchw_conv_inputs(x, w, stride, pad)
        cudnn_ms = time_ms(lambda: F.conv2d(xp, wo, bias, stride=stride))
        im2col_ms = time_ms(lambda: conv_im2col_call(
            x, w, stride=stride, padding=pad, epilogue="bias_relu",
            bias=bias))
        l_bound, l_by = bound(2.0 * 8 * o1 * o2 * c_out * k1 * k2 * c_in,
                              4.0 * (x.numel() + w.numel() + c_out
                                     + 8 * o1 * o2 * c_out))
        busy = {name: device_time(fn, reps=20)[0] for name, fn in (
            ("kn2row", lambda: conv_kn2row(
                x, w, stride=stride, padding=pad, epilogue="bias_relu",
                bias=bias)),
            ("cuDNN", lambda: F.conv2d(xp, wo, bias, stride=stride)),
            ("im2col", lambda: conv_im2col_call(
                x, w, stride=stride, padding=pad, epilogue="bias_relu",
                bias=bias)))}
        print(f"[14] inception_v4 {label} b8 {hw}x{hw} {k1}x{k2} s{stride} "
              f"{pad} {c_in}->{c_out}: kn2row kernels {ucg_ms + pa_ms:.4f} "
              f"ms (unit_conv_gemms {ucg_ms:.4f} + pad_accumulate "
              f"{pa_ms:.4f}; the call {layer_ms:.4f}), F.conv2d (cuDNN, no "
              f"TF32) {cudnn_ms:.4f} ms, im2col kernel {im2col_ms:.4f} ms; "
              f"direct-conv bound {l_bound:.4f} ms ({l_by}); p "
              f"{4.0 * p5.numel() / 1e6:.1f} MB; device time of one call "
              f"(profiler): "
              + ", ".join(f"{k} {v:.4f}" for k, v in busy.items()) + " ms")
        del p5

    for bsz in BUCKETS:
        run_k, run_p, x, _ = iruns[(True, bsz)]
        f_ms = time_ms(lambda: run_k(iparams, x), reps=5, rounds=5)
        p_ms = time_ms(lambda: run_p(iparams, x), reps=5, rounds=5)
        dev_ms, split, groups = device_time(lambda: run_k(iparams, x))
        kn2_ms = sum(v for k, v in groups.items()
                     if k.startswith(("unit_conv_gemms_f32",
                                      "pad_accumulate_f32")))
        dense_ms = sum(v for k, v in groups.items()
                       if k.startswith(("gemm_f32<", "gemm_f32_reduce")))
        print(f"[14] inception_v4 299 forward b{bsz} (elide, replay): "
              f"kernels {f_ms:.3f} ms, plain path {p_ms:.3f} ms; device busy "
              f"{dev_ms:.3f} ms of the kernels' forward "
              f"({100 * dev_ms / f_ms:.1f}%); kn2row kernels {kn2_ms:.3f} ms "
              f"({100 * kn2_ms / dev_ms:.1f}% of device busy), dense GEMM "
              f"{dense_ms:.3f} ms ({100 * dense_ms / dev_ms:.1f}%) = {split} "
              f"(ms); {memory_text()}")

    # Every distinct Toeplitz GEMM of the elided f32 lowering at buckets 1
    # and 8 (the layers gemm_f32 runs), each timed once as the forward
    # calls it (its plan's tile, bias_relu) and as one torch.matmul, both
    # by queued launches (device time without host gaps), beside its bound.
    # Its inputs come from a generator of its own.
    sweep_rng = torch.Generator().manual_seed(14)
    for bsz in (1, 8):
        shapes = Counter()
        for nid, low in iruns[(True, bsz)][0].lowering.items():
            if (low.algo.family is AlgoFamily.IM2COL
                    and low.in_layout is not None
                    and low.in_layout.kind == "toeplitz"):
                conv = gi.nodes[nid].conv
                m = bsz * conv.o1 * conv.o2
                k, n = conv.k1 * conv.k2 * conv.c_in, conv.c_out
                bm, bn, _ = dataflow_blocks(low.dataflow, low.p1, low.p2)
                shapes[(m, k, n, kernel_tile(bm, bn, m, n))] += 1
        rows = []
        for (m, k, n, tile), count in shapes.items():
            a = randn(m, k, rng=sweep_rng)
            b = randn(k, n, scale=k ** -0.5, rng=sweep_rng)
            bias = randn(n, scale=0.1, rng=sweep_rng)
            k_ms = queued_ms(lambda: gemm_call(
                a, b, bm=tile[0], bn=tile[1], epilogue="bias_relu",
                bias=bias), reps=5)
            l_ms = queued_ms(lambda: torch.matmul(a, b), reps=5)
            b_ms = bound(2.0 * m * n * k, 4.0 * (m * k + k * n + n + m * n))[0]
            rows.append((k_ms, l_ms, b_ms, m, k, n, tile, count))
        rows.sort(key=lambda r: -r[0] * r[7])
        sums = [sum(r[i] * r[7] for r in rows) for i in range(3)]
        print(f"[14] inception_v4 Toeplitz GEMMs b{bsz}: "
              f"{sum(shapes.values())} launches of {len(shapes)} shapes; "
              f"weighted by launches, "
              f"kernel {sums[0]:.4f} ms, torch.matmul {sums[1]:.4f} ms, bound "
              f"{sums[2]:.4f} ms (queued device time); ten slowest (M x K x "
              f"N tile S: launches x kernel / matmul / bound ms): "
              + "; ".join(f"{m}x{k}x{n} {t[0]}x{t[1]} "
                          f"S{splits_of(m, n, k, t)}: {c} x {km:.4f} / "
                          f"{lm:.4f} / {bm_:.4f}"
                          for km, lm, bm_, m, k, n, t, c in rows[:10]))
        del rows

    # ---- 15. int8 kernels vs plain ---------------------------------------
    def randi8(*shape, rng=None):
        rng = gen if rng is None else rng
        return torch.randint(-127, 128, shape, generator=rng,
                             dtype=torch.int8).to(dev)

    def dequant_scale(n, depth, rng=None):
        """Per-channel scales that bring a depth-``depth`` int8 sum to ~1
        (the role of in_scale · w_scale)."""
        rng = gen if rng is None else rng
        return ((torch.rand(n, generator=rng) * 1.5 + 0.5)
                / (127.0 ** 2 * depth ** 0.5 / 3)).to(dev)

    def extreme(rows, cols, period):
        """±127 everywhere, the sign alternating every ``period`` columns:
        every product of two such operands sums to ±127² K."""
        sign = 1 - 2 * ((torch.arange(cols) // period) % 2)
        return (127 * sign).to(torch.int8).expand(rows, cols).contiguous() \
            .to(dev)

    def check_gemm_i8(label, a, b, tiles, scale, bias):
        """gemm_i8 vs its plain version, bit for bit, on every tile of
        ``tiles`` the wrapper takes at this shape (kernel_tile clamps to
        the problem)."""
        (m, k), n = a.shape, b.shape[1]
        err = {"f32": 0.0, "int8": 0.0}
        tiles = sorted({kernel_tile(bm, bn, m, n) for bm, bn in tiles})
        for bm, bn in tiles:
            e = i8_outputs(
                lambda ep, os: gemm_call(a, b, bm=bm, bn=bn, epilogue=ep,
                                         bias=bias, scale=scale,
                                         out_scale=os),
                lambda ep, os: gemm_i8_plain(a, b, ep, bias, scale=scale,
                                             out_scale=os), EXACT)
            err = {key: max(err[key], e[key]) for key in err}
        i8_err[("gemm_i8", label)] = err
        i8_inputs[("gemm_i8", label)] = (a, b, scale, bias)
        print(f"[15] gemm_i8 {label} M={m} K={k} N={n} tiles {tiles}, four "
              f"epilogues: max|diff| vs plain f32 {err['f32']:.3e}, int8 "
              f"out {err['int8']:.0f} (both exact)")

    i8_err = {}
    i8_inputs = {}
    # gemm_i8: redA/b3b's Toeplitz layer at bucket 8 (the int8 Toeplitz
    # layer with the most MACs), the deepest int8 Toeplitz K (2880), and a
    # ragged problem.
    for label, m, k, n, tiles in (
            ("redA/b3b", 8 * 35 * 35, 9 * 192, 224, ((128, 128),)),
            ("K 2880", 8 * 8 * 8, 2880, 320, ((128, 128),)),
            ("ragged", 333, 70, 100, all_tiles)):
        a, b = randi8(m, k), randi8(k, n)
        check_gemm_i8(label, a, b, tiles, dequant_scale(n, k),
                      randn(n, scale=0.1))
    # The edges of the mma.sync loop: one element, ragged fragments, a K
    # one k32 step past a 64-deep chunk, operands 1 byte off alignment at
    # an aligned K (the byte-wise path), and +-127 everywhere at the
    # deepest K the wrappers take (the byte-wise path) and at the deepest
    # multiple of 16 (cp.async). Their inputs come from a generator of
    # their own, so the later phases draw the same inputs as without them.
    edge = torch.Generator().manual_seed(16)
    a128, b128 = randi8(200, 128, rng=edge), randi8(128, 96, rng=edge)
    for label, a, b in (
            ("1x1x1", randi8(1, 1, rng=edge), randi8(1, 1, rng=edge)),
            ("17x33x9", randi8(17, 33, rng=edge), randi8(33, 9, rng=edge)),
            ("K 96", randi8(64, 96, rng=edge), randi8(96, 8, rng=edge)),
            ("aligned", a128, b128),
            ("offset views", offset_copy(a128), offset_copy(b128)),
            ("+-127 K 133144", extreme(16, INT8_MAX_K, INT8_MAX_K).mul_(-1),
             extreme(INT8_MAX_K, 16, 3)),
            ("+-127 K 133136", extreme(16, 133136, 133136),
             extreme(133136, 16, 5))):
        k, n = b.shape
        check_gemm_i8(label, a, b, all_tiles, dequant_scale(n, k, rng=edge),
                      randn(n, scale=0.1, rng=edge))
    peak = int(int8_product(*i8_inputs[("gemm_i8", "+-127 K 133144")][:2])
               .abs().max())
    if peak != 127 ** 2 * INT8_MAX_K:
        raise CheckFailed(f"the +-127 case sums to {peak}, not "
                          f"{127 ** 2 * INT8_MAX_K}")
    # conv_im2col_i8: stem/c1 on the image at bucket 8 (the elided path's
    # one NHWC int8 layer; the byte path), and redA/b3b on its NHWC map (the
    # unelided path's largest; the 16-byte gather), on every tile the
    # wrapper takes; then the edges of both paths (CONV_I8_EDGE_CASES, from
    # a generator of their own).
    for label, xs, ws, stride, pad in (
            ("stem/c1", (8, 299, 299, 3), (3, 3, 3, 32), 2, "VALID"),
            ("redA/b3b", (8, 35, 35, 192), (3, 3, 192, 224), 1, "SAME")):
        x, w = randi8(*xs), randi8(*ws)
        scale = dequant_scale(ws[3], ws[0] * ws[1] * ws[2])
        bias = randn(ws[3], scale=0.1)
        path, tiles, err = check_conv_i8(conv_mod, x, w, stride, pad, scale,
                                         bias)
        i8_err[("conv_im2col_i8", label)] = err
        i8_inputs[("conv_im2col_i8", label)] = (x, w, scale, bias, stride,
                                                pad)
        print(f"[15] conv_im2col_i8 {label} x{xs} w{ws} s{stride} {pad}, "
              f"{path} path, tiles {tiles}, four epilogues: max|diff| vs "
              f"plain f32 {err['f32']:.3e}, int8 out {err['int8']:.0f} "
              f"(both exact)")
    for (label, xs, ws, stride, pad), path, tiles, err in \
            check_conv_i8_edges(conv_mod, torch.Generator().manual_seed(20),
                                dev):
        print(f"[15] conv_im2col_i8 {label} x{xs} w{ws} s{stride} {pad}, "
              f"{path} path, tiles {tiles}, four epilogues: max|diff| vs "
              f"plain f32 {err['f32']:.3e}, int8 out {err['int8']:.0f} "
              f"(both exact)")
    # unit_conv_gemms_i8 and pad_accumulate_i32: stem/c4 and incC0/b4d at
    # bucket 8 (int8 kn2row layers of the plan), a ragged problem on every
    # tile.
    for label in ("stem/c4", "incC/b4d"):
        hw, k1, k2, stride, pad, c_in, c_out = KN2ROW_LAYERS[label]
        x, w = randi8(8, hw, hw, c_in), randi8(k1, k2, c_in, c_out)
        scale = dequant_scale(c_out, k1 * k2 * c_in)
        bias = randn(c_out, scale=0.1)
        x2d, wg = x.reshape(-1, c_in), w.reshape(k1 * k2, c_in, c_out)
        p_kern = kn2.unit_conv_gemms_call(x2d, wg)
        torch.cuda.synchronize()
        p_plain = kn2.unit_conv_gemms_plain(x2d, wg)
        ucg = check_close(f"unit_conv_gemms_i8 {label}", p_kern, p_plain,
                          **EXACT)
        del p_kern
        o1, o2, pt, _, pl, _ = conv_geometry(hw, hw, k1, k2, stride, pad)
        geo = dict(k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, pad_top=pt,
                   pad_left=pl)
        p5 = p_plain.view(k1 * k2, 8, hw, hw, c_out)
        err = i8_outputs(
            lambda ep, os: kn2.pad_accumulate_call(
                p5, epilogue=ep, bias=bias, scale=scale, out_scale=os,
                **geo),
            lambda ep, os: kn2.pad_accumulate_plain(
                p5, epilogue=ep, bias=bias, scale=scale, out_scale=os,
                **geo), KERNEL_TOL)
        i8_err[("unit_conv_gemms_i8", label)] = {"int32": ucg}
        i8_err[("pad_accumulate_i32", label)] = err
        i8_inputs[("kn2row_i8", label)] = (x2d, wg, p5)
        print(f"[15] kn2row int8 {label} b8 {hw}x{hw} {k1}x{k2} s{stride} "
              f"{pad} {c_in}->{c_out}: unit_conv_gemms_i8 int32 p max|diff| "
              f"{ucg:.0f} (exact); pad_accumulate_i32, four epilogues: "
              f"f32 {err['f32']:.3e} (rtol/atol 1e-4), int8 out "
              f"{err['int8']:.0f} (exact)")
    for (label, shape, k1, k2, stride, pad), path, errs in \
            check_pad_accumulate_edges(kn2, edge_pa, quant=True):
        print(f"[15] pad_accumulate_i32 {label} p{shape} {k1}x{k2} s{stride} "
              f"{pad}, {path} path, four epilogues: max|diff| f32 out "
              f"{errs['f32']:.3e} (rtol/atol 1e-4), int8 out "
              f"{errs['int8']:.0f} (exact)")
    # unit_conv_gemms_i8 on every tile the wrapper takes: a ragged problem
    # (the byte-wise path); then, drawn from ``edge``, G 9 on a ragged M
    # (cp.async) and the same operands 1 byte off alignment (byte-wise).
    ragged = (randi8(333, 70), randi8(3, 70, 100))
    x9, w9 = randi8(333, 64, rng=edge), randi8(9, 64, 96, rng=edge)
    for label, a, b in (("ragged", *ragged), ("G 9 ragged M", x9, w9),
                        ("offset views", offset_copy(x9), offset_copy(w9))):
        want = kn2.unit_conv_gemms_plain(a, b)
        (m, k), (g, _, n) = a.shape, b.shape
        tiles = sorted({kernel_tile(bm, bn, m, n) for bm, bn in all_tiles})
        for bm, bn in tiles:
            got = kn2.unit_conv_gemms_call(a, b, bm=bm, bn=bn)
            torch.cuda.synchronize()
            check_close(f"unit_conv_gemms_i8 {label} tile ({bm},{bn})", got,
                        want, **EXACT)
        print(f"[15] unit_conv_gemms_i8 {label} G={g} M={m} K={k} N={n} "
              f"tiles {tiles}: int32 p equal (exact)")

    # ---- 16. the accuracy gate on the card -----------------------------
    samples = randn(2, 299, 299, 3)
    t0 = time.perf_counter()
    report = plan_mixed_precision(gi, iparams, samples, tol=GATE_TOL,
                                  hw=identify_parameters(gi, max_dim=512))
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    qplan, qscales = report.plan, report.act_scales
    qmix = Counter((qplan.assignment[n].key, p)
                   for n, p in qplan.precisions.items())
    int8_errs = sorted(report.errors[n] for n, p in qplan.precisions.items()
                       if p == "int8")
    if max(int8_errs) > GATE_TOL:
        raise CheckFailed(f"the gate kept an int8 layer at error "
                          f"{max(int8_errs):.4f} > {GATE_TOL}")
    if not (qmix[("im2col", "int8")] and qmix[("kn2row", "int8")]):
        raise CheckFailed(f"the gated plan lacks int8 im2col or int8 "
                          f"kn2row layers: {dict(qmix)}")
    # The gate measures in true f32 whatever the caller's TF32 flags: with
    # both turned on globally, its isolated errors stay the same.
    cuda_mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    cuda_mm.allow_tf32 = cudnn.allow_tf32 = True
    try:
        tf32_errs = layer_errors(gi, iparams, samples, qscales)
    finally:
        cuda_mm.allow_tf32 = cudnn.allow_tf32 = False
    tf32_diff = max(abs(tf32_errs[n] - e) for n, e in report.errors.items())
    if sorted(tf32_errs) != sorted(report.errors) or tf32_diff > 1e-6:
        raise CheckFailed(f"the gate's isolated errors move by {tf32_diff:.3e}"
                          f" with TF32 on globally")
    errs = sorted(report.errors.values())
    print(f"[16] gate on inception_v4 299 (tol {GATE_TOL}, 2 calibration "
          f"images, {gate_s:.2f} s): mix "
          + ", ".join(f"{a} {p} {c}" for (a, p), c in sorted(qmix.items()))
          + f"; demoted {len(report.demoted)} "
          f"({[gi.nodes[n].name for n in report.demoted]}), rounds "
          f"{report.rounds}; isolated errors of all {len(errs)} convs "
          f"{errs[0]:.4f}-{errs[-1]:.4f} (median "
          f"{statistics.median(errs):.4f}), max kept int8 "
          f"{int8_errs[-1]:.4f}; with TF32 on globally the errors move by "
          f"{tf32_diff:.3e}")

    # ---- 17. the gated plan: int8 kernels vs the plain path ------------
    qruns = check_forwards(17, "inception_v4 299 int8", gi, qplan, iparams,
                           299, None, act_scales=qscales)
    i8_idx = [KERNEL_NAMES.index(k) for k in (
        "gemm_i8", "conv_im2col_i8", "unit_conv_gemms_i8",
        "pad_accumulate_i32")]
    for (elide, bsz), (run_k, _, x, got) in qruns.items():
        n = expected_launches(run_k.lowering, gi)
        need = i8_idx if elide else i8_idx[1:]   # no Toeplitz edge: no GEMM
        if not all(n[i] for i in need):
            raise CheckFailed(f"int8 b{bsz} elide={elide}: an int8 kernel "
                              f"has no launch: {launch_text(n)}")
        f32 = iruns[(elide, bsz)][0](iparams, x)
        rel = float((got - f32).abs().max() / f32.abs().max())
        cos = float(F.cosine_similarity(got, f32, dim=-1).min())
        if not (rel < INT8_VS_F32["rel"] and cos > INT8_VS_F32["cos"]):
            raise CheckFailed(f"int8 b{bsz} elide={elide}: max|int8 - f32| "
                              f"/ max|f32| = {rel:.3e}, cosine {cos:.4f}, "
                              f"bounds {INT8_VS_F32}")
        fused = len(run_k.lowering.quantized_edges)
        print(f"[17] int8 b{bsz} elide={elide} vs the f32 plan: max|diff| / "
              f"max|f32 logit| {rel:.3e}, least cosine similarity of an "
              f"image's logits {cos:.4f}; fused int8 edges {fused}")

    def int_mm(a, b):
        """cuBLASLt's int8 GEMM (int8 x int8 -> int32) as one PyTorch call:
        the function taking b row-major, else column-major, whichever
        cuBLASLt accepts for these shapes; None if it takes neither."""
        for layout, bb in (("row-major", b), ("column-major",
                                               b.t().contiguous().t())):
            try:
                torch._int_mm(a, bb)
                torch.cuda.synchronize()
                return lambda: torch._int_mm(a, bb)
            except RuntimeError as exc:
                print(f"[17] torch._int_mm refused {tuple(a.shape)} x "
                      f"{tuple(b.shape)} {layout}: "
                      f"{str(exc).splitlines()[0][:160]}")
        return None

    i8_times = {}
    a, b, scale, bias = i8_inputs[("gemm_i8", "redA/b3b")]
    m, k = a.shape
    n = b.shape[1]
    lib = int_mm(a, b)
    if lib is not None:
        check_close("torch._int_mm gemm_i8 redA/b3b", lib(),
                    int8_product(a, b), **EXACT)
    i8_times["gemm_i8"] = (
        lambda a=a, b=b, s=scale, c=bias: gemm_call(
            a, b, epilogue="bias_relu", bias=c, scale=s),
        lambda a=a, b=b, s=scale, c=bias: gemm_i8_plain(
            a, b, "bias_relu", c, scale=s),
        lib,
        bound(2.0 * m * n * k, m * k + k * n + 8.0 * n + 4.0 * m * n,
              PEAK_INT8_OPS), "redA/b3b")
    x, w, scale, bias, stride, pad = i8_inputs[("conv_im2col_i8",
                                                "stem/c1")]
    bsz, h, w_in, c_in = x.shape
    k1, k2, _, c_out = w.shape
    o1, o2 = conv_geometry(h, w_in, k1, k2, stride, pad)[:2]
    ckw = dict(stride=stride, padding=pad, epilogue="bias_relu", bias=bias,
               scale=scale)
    i8_times["conv_im2col_i8"] = (
        lambda x=x, w=w, kw=ckw: conv_im2col_call(x, w, **kw),
        lambda x=x, w=w, kw=ckw: conv_i8_plain(x, w, **kw), None,
        bound(2.0 * bsz * o1 * o2 * c_out * k1 * k2 * c_in,
              x.numel() + w.numel() + 8.0 * c_out
              + 4.0 * bsz * o1 * o2 * c_out, PEAK_INT8_OPS), "stem/c1")
    x2d, wg, p5 = i8_inputs[("kn2row_i8", "stem/c4")]
    g_, m, c_in, c_out = wg.shape[0], x2d.shape[0], wg.shape[1], wg.shape[2]
    w_flat = wg.permute(1, 0, 2).reshape(c_in, g_ * c_out).contiguous()
    lib = int_mm(x2d, w_flat)
    if lib is not None:
        check_close("torch._int_mm unit_conv_gemms_i8 stem/c4",
                    lib().view(m, g_, c_out).permute(1, 0, 2),
                    p5.reshape(g_, m, c_out), **EXACT)
    i8_times["unit_conv_gemms_i8"] = (
        lambda x=x2d, w=wg: kn2.unit_conv_gemms_call(x, w),
        lambda x=x2d, w=wg: kn2.unit_conv_gemms_plain(x, w), lib,
        bound(2.0 * g_ * m * c_in * c_out,
              m * c_in + g_ * c_in * c_out + 4.0 * g_ * m * c_out,
              PEAK_INT8_OPS), "stem/c4")
    i8_rows = {}
    for name, (kern, plain, lib, (b_ms, b_by), label) in i8_times.items():
        k_ms, p_ms = time_ms(kern), time_ms(plain)
        l_ms = time_ms(lib) if lib is not None else None
        k_dev = device_time(kern, reps=20)[0]
        i8_rows[name] = (k_ms, p_ms, l_ms, b_ms, b_by, label)
        lib_txt = ("torch._int_mm (cuBLASLt int8) "
                   f"{l_ms:.4f} ms" if l_ms is not None else "library: none")
        print(f"[17] {name} {label} b8: kernel {k_ms:.4f} ms (device "
              f"{k_dev:.4f} ms, profiler), plain {p_ms:.4f} ms, {lib_txt}, "
              f"bound {b_ms:.4f} ms ({b_by}; 1,979 TOPS int8, 3.35 TB/s)")
    del i8_times, kern, plain, lib, p5, x2d, wg, w_flat
    # pad_accumulate_i32 at the gated plan's stride-2 layers, bucket 8, f32
    # and requantized int8 outputs (p drawn on the card); stem/c4's f32 out
    # is the kernel's row of the kernels line.
    for label in ("stem/c4", "stem/c5"):
        for quant in ("f32", "int8"):
            row = time_pad_accumulate(kn2, label, 8, pa_rng, quant=quant,
                                      plain=(label, quant) == ("stem/c4",
                                                               "f32"))
            if "plain_ms" in row:
                i8_rows["pad_accumulate_i32"] = (
                    row["ms"], row["plain_ms"], None, row["bound_ms"],
                    row["bound_by"], label)
            print(f"[17] pad_accumulate_i32 {quant} out "
                  + pad_accumulate_text(label, 8, row))

    # conv_im2col_i8 at stem/c1 (the byte path) and at redA/b3b on its
    # NHWC map (the 16-byte gather; the unelided path's largest int8
    # conv) by queued launches, beside gemm_i8 on redA/b3b's Toeplitz
    # matrix: the same MACs with A dense instead of gathered, and the same
    # outputs bit for bit.
    for label in ("stem/c1", "redA/b3b"):
        x, w, scale, bias, stride, pad = i8_inputs[("conv_im2col_i8", label)]
        bsz, h, w_in, c_in = x.shape
        k1, k2, _, c_out = w.shape
        o1, o2 = conv_geometry(h, w_in, k1, k2, stride, pad)[:2]
        m, k = bsz * o1 * o2, k1 * k2 * c_in
        ckw = dict(stride=stride, padding=pad, epilogue="bias_relu",
                   bias=bias, scale=scale)
        b_ms, b_by = bound(2.0 * m * c_out * k,
                           x.numel() + w.numel() + 8.0 * c_out
                           + 4.0 * m * c_out, PEAK_INT8_OPS)
        text = (f"[17] conv_im2col_i8 {label} b8: kernel queued "
                f"{queued_ms(lambda: conv_im2col_call(x, w, **ckw)):.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")
        if label == "redA/b3b":
            a_toe = materialize(x, LayoutSpec(
                kind="toeplitz", h=h, w=w_in, c=c_in, k1=k1, k2=k2,
                stride=stride, padding=pad)).reshape(m, k)
            w2d = w.reshape(k, c_out)
            check_close("gemm_i8 on redA/b3b's Toeplitz matrix",
                        gemm_call(a_toe, w2d, epilogue="bias_relu",
                                  bias=bias, scale=scale),
                        conv_im2col_call(x, w, **ckw).reshape(m, c_out),
                        **EXACT)
            gemm_fn = (lambda: gemm_call(a_toe, w2d, epilogue="bias_relu",
                                         bias=bias, scale=scale))
            text += (f"; gemm_i8 on its Toeplitz matrix queued "
                     f"{queued_ms(gemm_fn):.4f} ms (events "
                     f"{time_ms(gemm_fn):.4f}), the conv by events "
                     f"{time_ms(lambda: conv_im2col_call(x, w, **ckw)):.4f}")
            del a_toe, w2d, gemm_fn
        print(text)
    # The unelided gated forward at bucket 8: every NHWC int8 im2col layer
    # runs conv_im2col_i8.
    run_k, _, x, _ = qruns[(False, 8)]
    dev_ms, split, groups = device_time(lambda: run_k(iparams, x))
    n_conv = expected_launches(run_k.lowering, gi)[
        KERNEL_NAMES.index("conv_im2col_i8")]
    conv_ms = sum(v for g, v in groups.items()
                  if g.startswith("conv_im2col_i8"))
    print(f"[17] inception_v4 299 int8 forward b8 (no elision): device busy "
          f"{dev_ms:.3f} ms; conv_im2col_i8 group {conv_ms:.3f} ms over "
          f"{n_conv} launches a forward = {split} (ms)")

    for bsz in BUCKETS:
        run_k, run_p, x, _ = qruns[(True, bsz)]
        run_f = iruns[(True, bsz)][0]
        f_ms = time_ms(lambda: run_k(iparams, x), reps=5, rounds=5)
        p_ms = time_ms(lambda: run_p(iparams, x), reps=5, rounds=5)
        f32_ms = time_ms(lambda: run_f(iparams, x), reps=5, rounds=5)
        dev_ms, split, groups = device_time(lambda: run_k(iparams, x))
        i8_ms = {key: sum(v for g, v in groups.items() if g.startswith(key))
                 for key in ("gemm_i8", "conv_im2col_i8",
                             "unit_conv_gemms_i8", "pad_accumulate_i32")}
        i8_ms["gemm_f32 (+ reduce)"] = sum(
            v for g, v in groups.items()
            if g.startswith(("gemm_f32<", "gemm_f32_reduce")))
        print(f"[17] inception_v4 299 int8 forward b{bsz} (elide, replay): "
              f"kernels {f_ms:.3f} ms, plain path {p_ms:.3f} ms, f32 plan "
              f"{f32_ms:.3f} ms; device busy {dev_ms:.3f} ms of the "
              f"kernels' forward ({100 * dev_ms / f_ms:.1f}%); int8 and f32 "
              f"GEMM kernels "
              + ", ".join(f"{k} {v:.3f}" for k, v in i8_ms.items())
              + f" = {split} (ms); {memory_text()}")

    # ---- 18. serving the gated plan --------------------------------------
    qserve = serve_checked(18, "inception_v4 int8", gi, qplan, iparams, 299,
                           N_IV4_I8_REQUESTS, 4,
                           expected_launches(qruns[(True, 1)][0].lowering,
                                             gi),
                           qruns[(True, 1)][1], act_scales=qscales)

    # ---- 19. pipelined and robust serving: this slice's main path --------
    def serve_waves(engine, images, waves, base):
        """Submit ``waves`` of ``images`` under rids from ``base``, one
        ``step(flush=True)`` after each wave, then retire everything;
        returns the in-flight count read right after each step."""
        inflight, rid = [], base
        for n in waves:
            for _ in range(n):
                engine.submit(CNNRequest(rid=rid, image=images[rid - base]))
                rid += 1
            engine.step(flush=True)
            inflight.append(engine.stats()["pipeline"]["inflight"])
        engine.run_until_done()
        return inflight

    def tick_sequence(engine, first):
        """(bucket, requests) per completed tick, in dispatch order, from
        the request log (ticks retire in dispatch order)."""
        seq, last = [], None
        for t in list(engine.request_log)[first:]:
            if (t.t_dispatch, t.bucket) != last:
                seq.append([t.bucket, 0])
                last = (t.t_dispatch, t.bucket)
            seq[-1][1] += 1
        return [tuple(s) for s in seq]

    rng19 = np.random.default_rng(19)
    images = [rng19.standard_normal((224, 224, 3)).astype(np.float32)
              for _ in range(sum(WAVES))]
    run_p1 = compile_plan(gnet, plan, epilogue="bias_relu", tuning_batch=1,
                          use_pallas=False, device=dev)
    plain = [run_p1(params, img[None])[0] for img in images]
    per_tick = googlenet_expect[True]
    want_seq = [(next(b for b in BUCKETS if b >= n), n) for n in WAVES]
    results, main19 = {}, None
    for depth in PIPELINE_DEPTHS:
        reset_counts()
        engine = CNNServingEngine(gnet, params, plan, batch_size=8,
                                  pipeline_depth=depth, warmup=True,
                                  device=dev)
        warm = counts()
        if warm != tuple(2 * len(engine.buckets) * k for k in per_tick):
            raise CheckFailed(f"depth {depth} warm-up launches {warm}")
        bases = []

        def serve():
            bases.append(len(bases) * len(images))
            first = len(engine.request_log)
            return first, serve_waves(engine, images, WAVES, bases[-1])

        (first, inflight), rows = profiled_launches(serve)
        seq = tick_sequence(engine, first)
        if seq != want_seq:
            raise CheckFailed(f"depth {depth} dispatched {seq}, expected "
                              f"{want_seq}")
        if launches_by_name(rows) != tuple(len(seq) * k for k in per_tick):
            raise CheckFailed(f"depth {depth} served kernel rows "
                              f"{launches_by_name(rows)} over {len(seq)} "
                              f"ticks, expected {per_tick} per tick")
        if counts() != warm:
            raise CheckFailed(f"depth {depth}: the counters moved over the "
                              f"replayed ticks, {warm} -> {counts()}")
        if depth == 2:
            main19 = counts()
        if depth > 1 and min(inflight) < 1:
            raise CheckFailed(f"depth {depth}: in flight after each step "
                              f"{inflight}: a tick blocked its step")
        if any(len(run.captures) != 1 or None in run.captures.values()
               for run in engine._runs.values()):
            raise CheckFailed(f"depth {depth}: not one capture per bucket")
        results[depth] = [engine.done[bases[-1] + i]
                          for i in range(len(images))]
        st = engine.stats()["pipeline"]
        print(f"[19] googlenet depth {depth}: {len(seq)} ticks {seq}; in "
              f"flight after each step {inflight}; overlap_ratio "
              f"{st['overlap_ratio']:.4f}; one capture per bucket; launches "
              f"counted (warm-up eager and capture passes) "
              f"{launch_text(warm)}, 0 over the ticks; kernel rows of the "
              f"served ticks (profiler) {launch_text(launches_by_name(rows))}")
        del engine
    if main19[0] == 0 or main19[1] == 0:
        raise CheckFailed(f"the depth-2 run launched {launch_text(main19)}")
    err = 0.0
    for i, want in enumerate(plain):
        for depth in PIPELINE_DEPTHS[1:]:
            if not np.array_equal(results[depth][i], results[1][i]):
                raise CheckFailed(f"depth {depth} request {i} differs from "
                                  f"depth 1's")
        err = max(err, check_close(f"pipelined request {i}", torch.as_tensor(
            results[1][i], device=dev), want, **FORWARD_TOL))
    print(f"[19] depths {PIPELINE_DEPTHS}: every result bit-equal to depth "
          f"1's (bucket 8 and 4 twice, bucket 1 thrice in a row, one capture "
          f"each); max|diff| vs per-image plain forward {err:.3e}")

    def conserved(engine):
        rb = engine.stats()["robustness"]
        if sum(rb["outcomes"].values()) + rb["pending"] != \
                engine.submitted_total:
            raise CheckFailed(f"outcomes {rb['outcomes']} + pending "
                              f"{rb['pending']} != {engine.submitted_total}")
        return rb

    fimages = [rng19.standard_normal((224, 224, 3)).astype(np.float32)
               for _ in range(sum(FAULT_WAVES))]
    clean = CNNServingEngine(gnet, params, plan, batch_size=8, pipeline_depth=2,
                             warmup=True, device=dev)
    serve_waves(clean, fimages, FAULT_WAVES, 0)
    faults = {1: TickFault(failures=1), 3: TickFault(failures=1,
                                                     at_dispatch=True),
              4: TickFault(failures=3)}
    faulty = CNNServingEngine(gnet, params, plan, batch_size=8,
                              pipeline_depth=2, warmup=True,
                              fault_plan=FaultPlan(faults), max_retries=2,
                              device=dev)
    serve_waves(faulty, fimages, FAULT_WAVES, 0)
    rb = conserved(faulty)
    lost = set(range(sum(FAULT_WAVES[:4]), sum(FAULT_WAVES[:5])))
    if faulty.failed != {rid: 4 for rid in lost} or \
            faulty.failed_ticks != 1 or faulty.retries_total != 4:
        raise CheckFailed(f"faults: failed {faulty.failed}, failed ticks "
                          f"{faulty.failed_ticks}, retries "
                          f"{faulty.retries_total}")
    if set(faulty.done) != set(range(len(fimages))) - lost or any(
            not np.array_equal(faulty.done[r], clean.done[r])
            for r in faulty.done):
        raise CheckFailed("faults: a recovered or later result differs "
                          "from the clean engine's")
    print(f"[19] faults at depth 2 (ticks 1: completion, 3: dispatch, "
          f"recovered; 4: exhausts max_retries 2): outcomes "
          f"{rb['outcomes']}, retries {rb['retries']}, failed ticks "
          f"{rb['failed_ticks']}; {len(faulty.done)} results bit-equal to "
          f"the clean engine's")
    # A tick that exhausts its dispatch retries gives its pipeline slot
    # back: tick 0 (completion fault) is held in flight by the device
    # delay, tick 1 fails at dispatch, and tick 2 must take slot 1, not
    # tick 0's slot, whose staging buffer tick 0's replay reads again and
    # whose host output buffer tick 0's completion reads.
    del faulty
    slot = CNNServingEngine(
        gnet, params, plan, batch_size=8, pipeline_depth=2, warmup=True,
        device_delay_s=0.2, max_retries=2, device=dev,
        fault_plan=FaultPlan({0: TickFault(failures=1),
                              1: TickFault(failures=3, at_dispatch=True)}))
    rid = 0
    for n in FAULT_WAVES[:3]:
        for _ in range(n):
            slot.submit(CNNRequest(rid=rid, image=fimages[rid]))
            rid += 1
        slot.step(flush=True)
    held = [(t.tick_idx, t.buf_index) for t in slot._inflight]
    slot.drain()
    rb = conserved(slot)
    lost = set(range(FAULT_WAVES[0], sum(FAULT_WAVES[:2])))
    if held != [(0, 0), (2, 1)] or slot.failed != {r: 1 for r in lost} \
            or set(slot.done) != set(range(rid)) - lost or any(
                not np.array_equal(slot.done[r], clean.done[r])
                for r in slot.done):
        raise CheckFailed(f"slot reuse: (tick, slot) in flight {held}, "
                          f"failed {slot.failed}, done {sorted(slot.done)}, "
                          f"or a result differs from the clean engine's")
    print(f"[19] slot reuse at depth 2 (tick 0: completion fault, held in "
          f"flight; tick 1: dispatch retries exhausted): (tick, slot) in "
          f"flight {held}; outcomes {rb['outcomes']}; {len(slot.done)} "
          f"results bit-equal to the clean engine's")
    del slot
    slo_over = 0.25
    over = CNNServingEngine(
        gnet, params, plan, batch_size=8, pipeline_depth=2, warmup=True,
        slo_s=slo_over, max_queue=16, shed_deadline=True,
        degrade=DegradeConfig(enter_queue=12, exit_queue=4, exit_ticks=2),
        device=dev)
    now = time.monotonic()
    verdicts = [over.submit(CNNRequest(rid=i, image=fimages[i],
                                       t_submit=now - 40 * slo_over))
                for i in range(12)]
    verdicts += [over.submit(CNNRequest(rid=i, image=fimages[i]))
                 for i in range(12, len(fimages))]
    over.run_until_done()
    rb = conserved(over)
    # 12 hopeless requests and 4 fresh ones fill the queue of 16, the
    # rest is rejected; the first step enters degrade (queue 16 >= 12),
    # sheds the 12 and dispatches the 4 at once.
    n_rejected = len(fimages) - 16
    want_out = {OUTCOME_COMPLETED: 4, OUTCOME_REJECTED: n_rejected,
                OUTCOME_SHED: 12, OUTCOME_FAILED: 0}
    if rb["outcomes"] != want_out or rb["degrade"]["entries"] != 1 or \
            verdicts.count(OUTCOME_REJECTED) != n_rejected:
        raise CheckFailed(f"overload: outcomes {rb['outcomes']}, degrade "
                          f"{rb['degrade']}, expected {want_out} and one "
                          f"degrade entry")
    for rid, got in over.done.items():
        check_close(f"overload request {rid}", torch.as_tensor(
            got, device=dev), run_p1(params, fimages[rid][None])[0],
            **FORWARD_TOL)
    print(f"[19] overload at depth 2 (max_queue 16, shed_deadline, degrade "
          f"enter 12 / exit 4): outcomes {rb['outcomes']}, queue high water "
          f"{rb['queue_high_water']}, degrade {rb['degrade']}; completed "
          f"results within rtol 2e-2 atol 2e-3 of the plain forward")
    del clean, over
    torch.cuda.empty_cache()
    load = load_rows(gnet, params, plan, dev, rates=("mid", "high"),
                     n_requests=N_LOAD_REQUESTS,
                     log=lambda text: print(f"[19] load: {text}"))
    for row in load["rows"] + load["overload"]:
        if not np.isfinite([row["p50_ms"], row["p99_ms"], row["max_ms"],
                            row["throughput_rps"]]).all():
            raise CheckFailed(f"load row {row}: non-finite numbers")
    if any(row["served"] != N_LOAD_REQUESTS for row in load["rows"]):
        raise CheckFailed("load: a replay did not serve every request")
    print(f"[19] load rows (not gated): {json.dumps(load)}; {memory_text()}")

    # ---- 20. the measured autotuner: this slice's main path ------------
    t20 = time.perf_counter()
    torch.cuda.empty_cache()
    TUNED = ("conv", "unit_conv_gemms", "pad_accumulate", "input_transform",
             "batched_gemm", "output_transform")

    def count_of(name):
        return counts()[KERNEL_NAMES.index(name)]

    # 20.1 Tune every signature at every bucket, kernels only, the plan's
    # binding as the hysteresis baseline (the main path's first leg: every
    # count reset just before it).
    reset_counts()
    t0 = time.perf_counter()
    record = autotune_buckets(gnet, plan, buckets=BUCKETS,
                              backends=("pallas",), baseline_backend="pallas",
                              p1p2=FOUR_PAIRS, device=dev)
    tune_s = time.perf_counter() - t0
    tuned20 = counts()
    if any(count_of(name) == 0 for name in TUNED):
        raise CheckFailed(f"tuning launched {launch_text(tuned20)}: a kernel "
                          f"of the candidates never ran")
    print(f"[20] tuned googlenet 224 at buckets {BUCKETS} over tiles "
          f"{FOUR_PAIRS}, kernels only, in {tune_s:.1f} s "
          f"({sum(len(t.candidates) for t in record.entries.values())} "
          f"candidates, each a CUDA-graph replay); launches counted (eager "
          f"warm-ups and captures) {launch_text(tuned20)}; {memory_text()}")
    for key, ent in record.entries.items():
        times = [s for _, s in ent.candidates]
        base_label, base_s = ent.candidates[0]
        kept = (ent.binding.label() == base_label and ent.measured_s == base_s
                and min(times[1:], default=base_s) >= base_s * 0.95)
        if not (np.isfinite(times).all() and min(times) > 0
                and (ent.measured_s == min(times) or kept)):
            raise CheckFailed(f"record entry {key}: {ent.binding.label()} "
                              f"{ent.measured_s} is neither the fastest of "
                              f"{len(times)} candidates nor the baseline "
                              f"kept by the 5% hysteresis")
    for bsz in BUCKETS:
        summ = tuning_summary(record, gnet, plan, bsz, "pallas")
        print(f"[20] b{bsz}: {summ['moved']} of {summ['signatures']} "
              f"signatures left the plan's binding; winners by algorithm "
              f"{summ['by_algo']}, by kernel tile {summ['by_tile']}; winners "
              f"{summ['winners_ms']:.4f} ms against the baselines' "
              f"{summ['baselines_ms']:.4f} (summed over the 57 layers "
              f"{summ['winners_layers_ms']:.4f} against "
              f"{summ['baselines_layers_ms']:.4f})")
    record_path = SRC.parent / "build" / "autotune" / "googlenet_b1248.json"
    record_path.parent.mkdir(parents=True, exist_ok=True)
    record.save(record_path)
    if TuningRecord.load(record_path).to_json() != record.to_json():
        raise CheckFailed("the record's JSON reload differs from it")

    # 20.2 Tuned against untuned programs (replays), buckets 1 and 8.
    tuned_runs = {}
    for bsz in (1, 8):
        run_t = compile_plan(gnet, plan, epilogue="bias_relu", tuning=record,
                             tuning_batch=bsz, device=dev)
        run_u = compile_plan(gnet, plan, epilogue="bias_relu",
                             tuning_batch=bsz, device=dev)
        off = {low.backend for low in run_t.lowering.values()} - {"pallas"}
        if off:
            raise CheckFailed(f"the tuned b{bsz} lowering runs convs on {off}")
        x = randn(bsz, 224, 224, 3)
        derived = expected_launches(run_t.lowering, gnet)
        reset_counts()
        eager = run_t(params, x)
        if counts() != derived:
            raise CheckFailed(f"tuned b{bsz} eager pass launched {counts()}, "
                              f"the lowering gives {derived}")
        run_t(params, x)                          # capture, one replay
        got = run_t(params, x)                    # a replay
        for _ in range(3):
            want = run_u(params, x)               # eager, capture, replay
        if not torch.equal(got, eager):
            raise CheckFailed(f"tuned b{bsz}: the replay differs from the "
                              f"eager pass")
        err = check_close(f"tuned b{bsz} vs untuned", got, want,
                          **FORWARD_TOL)
        t_ms = time_ms(lambda: run_t(params, x), reps=10, rounds=5)
        u_ms = time_ms(lambda: run_u(params, x), reps=10, rounds=5)
        tuned_runs[bsz] = (t_ms, u_ms)
        print(f"[20] tuned b{bsz} (replay): launches per forward "
              f"{launch_text(derived)}; max|diff| vs untuned {err:.3e} (rtol "
              f"2e-2 atol 2e-3); forward {t_ms:.3f} ms, untuned {u_ms:.3f} ms "
              f"(events, not gated)")
        del run_t, run_u
    torch.cuda.empty_cache()

    # 20.3 The tuned engine serves phase 19's burst at depths 1 and 2 (the
    # main path's second leg: every count reset just before each engine).
    tuned_results, seqs = {}, {}
    for depth in (1, 2):
        reset_counts()
        engine = CNNServingEngine(gnet, params, plan, batch_size=8,
                                  pipeline_depth=depth, warmup=True,
                                  tuning=record, device=dev)
        per_bucket = {b: expected_launches(run.lowering, gnet)
                      for b, run in engine._runs.items()}
        warm = counts()
        want_warm = tuple(2 * sum(per_bucket[b][i] for b in engine.buckets)
                          for i in range(len(ALL_KERNELS)))
        if warm != want_warm:
            raise CheckFailed(f"tuned depth {depth} warm-up launches {warm}, "
                              f"expected two passes per bucket {want_warm}")
        if any(low.backend != "pallas" for run in engine._runs.values()
               for low in run.lowering.values()):
            raise CheckFailed(f"tuned depth {depth}: a bucket program runs a "
                              f"conv off the kernels")

        bases = []

        def serve():
            bases.append(len(bases) * len(images))
            first = len(engine.request_log)
            serve_waves(engine, images, WAVES, bases[-1])
            return first

        want_rows = tuple(sum(per_bucket[b][i] for b, _ in want_seq)
                          for i in range(len(ALL_KERNELS)))
        first, rows = profiled_launches(serve)
        seq = tick_sequence(engine, first)
        if seq != want_seq:
            raise CheckFailed(f"tuned depth {depth}: ticks {seq}, expected "
                              f"{want_seq}")
        if launches_by_name(rows) != want_rows:
            raise CheckFailed(f"tuned depth {depth}: kernel rows "
                              f"{launches_by_name(rows)}, expected "
                              f"{want_rows}")
        if counts() != warm:
            raise CheckFailed(f"tuned depth {depth}: the counters moved over "
                              f"the replayed ticks")
        seqs[depth] = seq
        tuned_results[depth] = [engine.done[bases[-1] + i]
                                for i in range(len(images))]
        svc = engine.stats()["service_ema_s"]
        print(f"[20] tuned engine depth {depth}: {len(seq)} ticks {seq}; "
              f"launches counted (warm-up eager and capture passes) "
              f"{launch_text(warm)}, 0 over the ticks; kernel rows of the "
              f"served ticks (profiler) {launch_text(launches_by_name(rows))}"
              f"; service EMA per bucket (ms) "
              f"{ {b: round(v * 1e3, 4) for b, v in svc.items()} }")
        del engine
    err = 0.0
    for i, want in enumerate(plain):
        if not np.array_equal(tuned_results[2][i], tuned_results[1][i]):
            raise CheckFailed(f"tuned engine request {i}: depth 2 differs "
                              f"from depth 1")
        err = max(err, check_close(f"tuned engine request {i}",
                                   torch.as_tensor(tuned_results[1][i],
                                                   device=dev), want,
                                   **FORWARD_TOL))
    ratios = refresh_from_service(record, gnet, svc)
    print(f"[20] tuned engine: depths 1 and 2 bit-equal, max|diff| vs the "
          f"per-image untuned plain forward {err:.3e}; refresh_from_service "
          f"ratios (service EMA / the record's conv sum, not gated) "
          f"{ {b: round(r, 4) for b, r in ratios.items()} }; {memory_text()}")

    # 20.4 Elision measured per edge, at buckets 1 and 8.
    for bsz in (1, 8):
        t0 = time.perf_counter()
        ov = tune_elision(gnet, plan, batch=bsz, params=params,
                          epilogue="bias_relu", device=dev)
        el_s = time.perf_counter() - t0
        x = randn(bsz, 224, 224, 3)
        run = compile_plan(gnet, plan, epilogue="bias_relu", tuning_batch=bsz,
                           device=dev)
        edges = sorted(run.lowering.elided_edges)
        for _ in range(3):
            want = run(params, x)
        del run
        # The per-edge round trip that tune_elision timed, held against the
        # all-elided program whatever it kept: the first elided edge forced
        # back alone, every elided edge forced back at once, and the
        # returned overrides where there are any.
        cases = {"first edge": {edges[0]: False},
                 "every edge": {edge: False for edge in edges}}
        if ov:
            cases["tuned"] = ov
        errs = {}
        for name, overrides in cases.items():
            run = compile_plan(gnet, plan, epilogue="bias_relu",
                               tuning_batch=bsz, elide_overrides=overrides,
                               device=dev)
            if set(run.lowering.elided_edges) != set(edges) - set(overrides):
                raise CheckFailed(f"elision b{bsz} {name}: the lowering "
                                  f"still elides a forced edge")
            for _ in range(3):
                out = run(params, x)
            del run
            errs[name] = check_close(f"elision b{bsz} {name} forced back",
                                     out, want, **KERNEL_TOL)
        print(f"[20] tune_elision b{bsz}: {len(ov)} of {len(edges)} edges "
              f"back to the NHWC round trip {sorted(ov)} in {el_s:.1f} s "
              f"({len(edges) + 1} programs, each dropped before the next); "
              f"max|diff| vs all-elided with edges forced back (1e-4): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; {memory_text()}")
    torch.cuda.empty_cache()

    # 20.5 Report (printed, not gated): all three backends at bucket 8.
    t0 = time.perf_counter()
    every = autotune_graph(gnet, plan, batch=8, backends=BACKENDS,
                           p1p2=FOUR_PAIRS, device=dev)
    rep = backend_report(every, gnet, 8)
    print(f"[20] backends at b8 (the plan's binding on the plain oracles "
          f"the baseline; {time.perf_counter() - t0:.1f} s): wins "
          f"{rep['wins']}; the five signatures where cuDNN or the plain "
          f"oracles beat the kernels most {json.dumps(rep['top'])}")

    # 20.6 int8 spot check: Inception-v4's stem/c1 and redA/b3b at bucket 8.
    reset_counts()
    spot = torch.Generator(device=dev).manual_seed(206)
    for name in ("stem/c1", "redA/b3b"):
        conv = next(n.conv for n in gi.conv_nodes() if n.name == name)
        tuned = tune_layer(conv, precision="int8", batch=8,
                           backends=("pallas",), device=dev)
        if any("winograd" in label for label, _ in tuned.candidates):
            raise CheckFailed(f"int8 {name}: a Winograd candidate was timed")
        b = tuned.binding
        x = torch.randn((8, conv.h1, conv.h2, conv.c_in), generator=spot,
                        device=dev)
        w = torch.randn((conv.k1, conv.k2, conv.c_in, conv.c_out),
                        generator=spot, device=dev) * 0.1
        in_scale = 3.0 / 127.0
        pad = "SAME" if conv.pad == "same" else "VALID"
        got = overlay.apply_conv(
            x, w, b.algo, Dataflow[b.dataflow], b.p1, b.p2,
            stride=conv.stride, padding=pad, backend="pallas",
            epilogue="relu", precision="int8", in_scale=in_scale)
        # The winner's kernels on the operands the overlay quantized on the
        # card, and the same wrapper on CPU copies of them: its plain
        # version (exact int32 sums, the same flush).
        w_scale = weight_scales(w)
        xq, wq = quantize(x, in_scale), quantize(w, w_scale)
        op = conv_kn2row if b.algo.family is AlgoFamily.KN2ROW \
            else conv_im2col
        kw = dict(stride=conv.stride, padding=pad,
                  dataflow=Dataflow[b.dataflow], p1=b.p1, p2=b.p2,
                  epilogue="relu")
        kern = op(xq, wq, scale=in_scale * w_scale, **kw)
        want = op(xq.cpu(), wq.cpu(), scale=(in_scale * w_scale).cpu(),
                  **kw)
        check_close(f"int8 {name} winner, overlay vs its kernels", got,
                    kern, **EXACT)
        check_close(f"int8 {name} winner vs its plain version", kern.cpu(),
                    want, **EXACT)
        print(f"[20] int8 {name} b8: {len(tuned.candidates)} candidates, no "
              f"Winograd; winner {b.label()} {tuned.measured_s * 1e3:.4f} ms; "
              f"its output equals the plain version bit for bit")
    if any(count_of(name) == 0 for name in (
            "conv_im2col_i8", "unit_conv_gemms_i8", "pad_accumulate_i32")):
        raise CheckFailed(f"the int8 spot check launched "
                          f"{launch_text(counts())}")
    print(f"[20] int8 spot check launches {launch_text(counts())}")
    print(f"[20] phase 20 took {time.perf_counter() - t20:.1f} s; "
          f"{memory_text()}")

    # ---- 21. multi-tenancy and the plan supervisor: this slice's main path
    # Full-width GoogleNet planned for serving (``use_on_chip=False``: plan
    # A, 41 im2col + 14 kn2row + 2 Winograd F(4,3)) and re-solved with every
    # transition priced 6x (plan B, 38 im2col + 19 kn2row); VGG16 under
    # phase 8's plan. Every count is reset before the first engine.
    t21 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hw_g = identify_parameters(gnet, max_dim=512)
    plan_a = map_network(gnet, hw=hw_g, use_on_chip=False)
    shift = TransitionCalibration(default=6.0)
    resolve = replan(gnet, plan_a, calibration=shift, hysteresis=0.05,
                     hw=hw_g, use_on_chip=False)
    plan_b = resolve.plan
    mix_a = Counter(a.key for a in plan_a.assignment.values())
    mix_b = Counter(a.key for a in plan_b.assignment.values())
    fp_a, fp_b = plan_fingerprint(plan_a), plan_fingerprint(plan_b)
    if mix_a != {"im2col": 41, "kn2row": 14, "winograd(F4x3)": 2} or \
            not resolve.adopted or mix_b != {"im2col": 38, "kn2row": 19} or \
            fp_b != plan_fingerprint(map_network(
                gnet, hw=hw_g, use_on_chip=False, calibration=shift)):
        raise CheckFailed(f"plans A {dict(mix_a)} and B {dict(mix_b)} "
                          f"(adopted {resolve.adopted}) are not the plans "
                          "this slice serves")
    per_a = expected_launches(compile_plan(
        gnet, plan_a, epilogue="bias_relu", device=dev).lowering, gnet)
    per_b = expected_launches(compile_plan(
        gnet, plan_b, epilogue="bias_relu", device=dev).lowering, gnet)
    per_v = vgg_expect[True]
    wino_names = ("input_transform", "input_transform_tiles",
                  "batched_gemm", "output_transform")
    if any(per_a[KERNEL_NAMES.index(k)] == 0 for k in wino_names) or any(
            per_b[KERNEL_NAMES.index(k)] for k in wino_names) or \
            per_b[KERNEL_NAMES.index("unit_conv_gemms")] <= \
            per_a[KERNEL_NAMES.index("unit_conv_gemms")]:
        raise CheckFailed(f"lowerings A {launch_text(per_a)} and B "
                          f"{launch_text(per_b)}")
    print(f"[21] plan A {dict(mix_a)} (modeled {resolve.deployed_cost_s * 1e3:.4f}"
          f" ms under the 6x calibration), plan B {dict(mix_b)} "
          f"({resolve.candidate_cost_s * 1e3:.4f} ms, adopted); launches per "
          f"forward A {launch_text(per_a)}; B {launch_text(per_b)}")

    def seeded_params(graph, seed):
        p = init_params(graph, seed=seed, device=dev)
        bias_gen = torch.Generator().manual_seed(1000 + seed)
        for nid in sorted(p):
            p[nid]["b"].copy_(torch.randn(p[nid]["b"].shape,
                                          generator=bias_gen) * 0.05)
        return p

    def images_of(seed, n, res=224):
        rng = np.random.default_rng(seed)
        return [rng.standard_normal((res, res, 3)).astype(np.float32)
                for _ in range(n)]

    def conserved(engine):
        rb = engine.stats()["robustness"]
        if sum(rb["outcomes"].values()) + rb["pending"] != \
                engine.submitted_total:
            raise CheckFailed(f"outcomes {rb['outcomes']} + pending "
                              f"{rb['pending']} != {engine.submitted_total}")
        return rb

    def solo_results(graph, p, pl, waves, images):
        """A solo engine (programs of its own, no cache) serving ``images``
        in ``waves``, one flush after each: {rid: logits}."""
        solo = CNNServingEngine(graph, p, pl, batch_size=8, device=dev)
        rid = 0
        for n in waves:
            for _ in range(n):
                solo.submit(CNNRequest(rid=rid, image=images[rid]))
                rid += 1
            solo.run_until_done()
        out = dict(solo.done)
        del solo
        return out

    # 21.1 Multi-tenancy: three tenants, one cache.
    params_b = seeded_params(gnet, 1)
    slo21 = {"gnet_a": 0.5, "gnet_b": 0.3, "vgg16": 0.2}
    reset_counts()
    multi = MultiModelEngine(global_max_queue=GLOBAL_CAP)
    t0 = time.perf_counter()
    multi.register_model("gnet_a", gnet, params, plan_a,
                         slo_s=slo21["gnet_a"], warmup=True, device=dev)
    reg_s = [time.perf_counter() - t0]
    after_a = dict(multi.cache.stats())
    t0 = time.perf_counter()
    multi.register_model("gnet_b", gnet, params_b, plan_a,
                         slo_s=slo21["gnet_b"], warmup=True, device=dev)
    reg_s.append(time.perf_counter() - t0)
    after_b = dict(multi.cache.stats())
    t0 = time.perf_counter()
    multi.register_model("vgg16", gv, vparams, vplan, slo_s=slo21["vgg16"],
                         warmup=True, device=dev)
    reg_s.append(time.perf_counter() - t0)
    after_v = dict(multi.cache.stats())
    eng_a, eng_b, eng_v = (multi.engines[n] for n in slo21)
    nb = len(BUCKETS)
    if after_a != {"entries": nb, "hits": 0, "misses": nb} or \
            after_b != {"entries": nb, "hits": nb, "misses": nb} or \
            after_v != {"entries": 2 * nb, "hits": nb, "misses": 2 * nb}:
        raise CheckFailed(f"cache after gnet_a {after_a}, gnet_b {after_b}, "
                          f"vgg16 {after_v}")
    for bsz in BUCKETS:
        run = eng_a._runs[bsz]
        if run is not eng_b._runs[bsz] or len(run.captures) != 2 or \
                None in run.captures.values() or \
                len(eng_v._runs[bsz].captures) != 1:
            raise CheckFailed(f"bucket {bsz}: gnet_a and gnet_b do not "
                              "share one program with one capture each")
    warm = counts()
    want = tuple(2 * nb * (2 * a + v) for a, v in zip(per_a, per_v))
    if warm != want or any(warm[KERNEL_NAMES.index(k)] == 0
                           for k in PATH21):
        raise CheckFailed(f"three warm-ups launched {launch_text(warm)}, "
                          f"expected {launch_text(want)}")
    print(f"[21] tenants registered in {', '.join(f'{s:.2f}' for s in reg_s)}"
          f" s; cache after gnet_a {after_a}, gnet_b {after_b} (no entry, a "
          f"hit per bucket), vgg16 {after_v}; each GoogleNet bucket program "
          f"shared, two captures (one per params); warm-up launches "
          f"{launch_text(warm)}")

    # Results: a mixed burst, 24 requests a tenant in waves, every joint
    # round in the profiler, against solo engines and a plain forward.
    burst = {"gnet_a": images_of(211, 24), "gnet_b": images_of(212, 24),
             "vgg16": images_of(213, 24)}
    windows = []

    def serve_burst():
        """Each wave: submit it for every tenant under fresh rids, then
        ``run_until_done``. Returns the ticks per tenant."""
        base = len(windows) * 24
        windows.append(base)
        ticks0 = {n: sum(multi.engines[n].dispatches.values())
                  for n in slo21}
        rid = 0
        for n in MULTI_WAVES:
            for name in slo21:
                for i in range(rid, rid + n):
                    verdict = multi.submit(name, CNNRequest(
                        rid=base + i, image=burst[name][i]))
                    if verdict != "queued":
                        raise CheckFailed(f"{name} request {i}: {verdict}")
            rid += n
            multi.run_until_done()
        return {n: sum(multi.engines[n].dispatches.values()) - ticks0[n]
                for n in slo21}

    ticks21, rows = profiled_launches(serve_burst)
    base = windows[-1]
    want_rows = tuple(ticks21["gnet_a"] * a + ticks21["gnet_b"] * a
                      + ticks21["vgg16"] * v for a, v in zip(per_a, per_v))
    if launches_by_name(rows) != want_rows:
        raise CheckFailed(f"burst kernel rows {launch_text(launches_by_name(rows))}"
                          f" over ticks {ticks21}, expected "
                          f"{launch_text(want_rows)}")
    if counts() != warm:
        raise CheckFailed(f"the counters moved over the replayed joint ticks"
                          f": {launch_text(warm)} -> {launch_text(counts())}")
    run_pa = compile_plan(gnet, plan_a, epilogue="bias_relu",
                          tuning_batch=1, use_pallas=False, device=dev)
    run_pv = compile_plan(gv, vplan, epilogue="bias_relu", tuning_batch=1,
                          use_pallas=False, device=dev)
    err21 = {}
    for name, p, graph, pl, run_p in (
            ("gnet_a", params, gnet, plan_a, run_pa),
            ("gnet_b", params_b, gnet, plan_a, run_pa),
            ("vgg16", vparams, gv, vplan, run_pv)):
        eng = multi.engines[name]
        solo = solo_results(graph, p, pl, MULTI_WAVES, burst[name])
        err21[name] = 0.0
        for i, img in enumerate(burst[name]):
            got = eng.done[base + i]
            if not np.array_equal(got, solo[i]):
                raise CheckFailed(f"{name} request {i}: differs from the "
                                  "solo engine's")
            err21[name] = max(err21[name], check_close(
                f"{name} request {i}", torch.as_tensor(got, device=dev),
                run_p(p, img[None])[0], **FORWARD_TOL))
        conserved(eng)
    print(f"[21] burst of {MULTI_WAVES} per tenant: ticks {ticks21}; every "
          f"result bit-equal to a solo engine's; max|diff| vs per-image "
          f"plain forward {', '.join(f'{k} {v:.3e}' for k, v in err21.items())}"
          f"; kernel rows of the joint ticks (profiler) "
          f"{launch_text(launches_by_name(rows))}, 0 launches counted")

    # Deadline order: scripted arrivals, one flushed joint step each; the
    # tenants must tick in oldest-deadline order (each later tick is
    # stamped later by the wall time of the ones before it).
    order_rid = 1000
    for t_base, offsets in DEADLINE_SCRIPT:
        for name, off in offsets.items():
            for k in range(2):
                multi.submit(name, CNNRequest(
                    rid=order_rid, image=burst[name][k],
                    t_submit=t_base + off))
                order_rid += 1
        deadlines = {n: multi.engines[n].oldest_deadline() for n in slo21}
        want_order = sorted(slo21, key=lambda n: deadlines[n])
        rank = multi._deadline_rank(t_base + 1.0)
        multi.step(now=t_base + 1.0, flush=True)
        stamped = {n: multi.engines[n].request_log[-1].t_dispatch
                   for n in slo21}
        got_order = sorted(slo21, key=lambda n: stamped[n])
        if rank != want_order or got_order != want_order or \
                multi.last_step["ticks"] != 3 or \
                len(set(stamped.values())) != 3:
            raise CheckFailed(f"deadline order: deadlines {deadlines}, rank "
                              f"{rank}, dispatched {stamped}, last_step "
                              f"{multi.last_step}")
        print(f"[21] deadlines {dict((n, round(d - t_base, 3)) for n, d in deadlines.items())}"
              f" (from t0): stepped {got_order}; last_step "
              f"{multi.last_step}")
    multi.run_until_done()

    # The global cap: past it, submissions land in the owning tenant's
    # ledger as rejected_full.
    before = {n: multi.engines[n].rejected_total for n in slo21}
    verdicts = Counter()
    for name in slo21:
        for i in range(12):
            verdicts[(name, multi.submit(name, CNNRequest(
                rid=2000 + i, image=burst[name][i])))] += 1
    multi.run_until_done()
    rejected = {n: multi.engines[n].rejected_total - before[n]
                for n in slo21}
    want_rej = {"gnet_a": 0, "gnet_b": 0, "vgg16": 36 - GLOBAL_CAP}
    if rejected != want_rej:
        raise CheckFailed(f"global cap {GLOBAL_CAP}: rejected {rejected}, "
                          f"expected {want_rej}")
    logged = sum(t.outcome == OUTCOME_REJECTED and t.rid >= 2000
                 for t in eng_v.request_log)
    if logged != want_rej["vgg16"]:
        raise CheckFailed(f"vgg16's ledger holds {logged} rejections")
    for name in slo21:
        conserved(multi.engines[name])
    print(f"[21] global cap {GLOBAL_CAP}: verdicts {dict(verdicts)}; "
          f"rejected into the owning ledger {rejected}; outcomes conserved "
          f"per tenant")

    # Swap isolation: gnet_a moves to plan B; gnet_b keeps its ladder, its
    # programs and their captures, and serves bit for bit as before.
    b_runs = eng_b._runs
    b_caps = {bsz: dict(run.captures) for bsz, run in b_runs.items()}
    entries = multi.cache.stats()["entries"]
    t0 = time.perf_counter()
    old = multi.swap_plan("gnet_a", plan_b)
    swap_s = time.perf_counter() - t0
    at_swap = counts()
    if plan_fingerprint(old[0]) != fp_a or \
            plan_fingerprint(eng_a.plan) != fp_b or eng_b._runs is not b_runs \
            or any(dict(run.captures) != b_caps[bsz]
                   for bsz, run in b_runs.items()) or \
            plan_fingerprint(eng_b.plan) != fp_a or \
            multi.cache.stats()["entries"] != entries + nb:
        raise CheckFailed("swap isolation: gnet_b's ladder, programs or "
                          "captures changed, or the cache lost an entry")
    again = {"gnet_a": images_of(214, 12), "gnet_b": burst["gnet_b"][:12]}
    for name in again:
        for i, img in enumerate(again[name]):
            multi.submit(name, CNNRequest(rid=3000 + i, image=img))
    multi.run_until_done()
    if counts() != at_swap:
        raise CheckFailed("a tick served after the swap moved a counter")
    solo_b = solo_results(gnet, params_b, plan_a, (8, 4), again["gnet_b"])
    solo_a = solo_results(gnet, params, plan_b, (8, 4), again["gnet_a"])
    for name, solo in (("gnet_b", solo_b), ("gnet_a", solo_a)):
        eng = multi.engines[name]
        if any(not np.array_equal(eng.done[3000 + i], solo[i])
               for i in range(12)):
            raise CheckFailed(f"after the swap {name}'s results differ from "
                              "its solo engine's")
    print(f"[21] gnet_a swapped to plan B in {swap_s:.2f} s (compile, eager "
          f"pass and capture per bucket): gnet_b's ladder, programs and "
          f"captures unchanged and its results bit-equal to before; cache "
          f"{multi.cache.stats()}; gnet_a's ticks on plan B bit-equal to a "
          f"solo plan-B engine's, no counter moved; {memory_text()}")
    del multi, eng_a, eng_b, eng_v, b_runs, b_caps, old, run

    # 21.2 The plan supervisor on one engine: foreground, background and a
    # rollback. 4 ms of injected device time per tick keeps the probation
    # ratios on the injected delays, not on kernel jitter.
    sup_waves = (8, 4, 2, 1)
    shared = ExecutableCache()

    def supervised(p, **kw):
        engine_kw = kw.pop("engine_kw", {})
        engine = CNNServingEngine(gnet, p, plan_a, batch_size=8, cache=shared,
                                  warmup=True, device=dev, **engine_kw)
        engine.device_delay_s = 0.004
        sup = PlanSupervisor(engine, gnet,
                             map_kwargs=dict(hw=hw_g, use_on_chip=False),
                             calibration_source=lambda: shift, **kw)
        return engine, sup

    def drive(engine, sup, images, n_ticks, trail, rid0=0):
        """``n_ticks`` ticks, one wave each (``sup_waves`` cycled by the
        engine's dispatch index), each followed by ``sup.tick()``; trail gets (tick, state, swaps,
        rollbacks, failed, probation samples, seconds in ``sup.tick()``)
        per tick. Returns {rid: (tick index, plan fingerprint at
        dispatch)}."""
        placed, rid = {}, rid0
        for _ in range(n_ticks):
            tick = engine._tick_seq
            n = sup_waves[tick % len(sup_waves)]
            fp = plan_fingerprint(engine.plan)
            for _ in range(n):
                engine.submit(CNNRequest(rid=rid, image=images[rid % len(images)]))
                placed[rid] = (tick, fp)
                rid += 1
            engine.step(flush=True)
            t0 = time.perf_counter()
            sup.tick()
            last = engine.last_tick or {}
            trail.append((tick, sup.state, sup.swaps, sup.rollbacks,
                          bool(last.get("failed")),
                          len(sup._probation_samples),
                          round(time.perf_counter() - t0, 4)))
        return placed

    params_s = seeded_params(gnet, 2)
    sup_images = images_of(215, 64)
    reset_counts()
    eng_s, sup_s = supervised(params_s, check_every=4, rollback_ticks=3)
    fg_base = counts()
    runs_a = dict(eng_s._runs)
    swap_counts = []
    sup_s.on_swap = lambda result: swap_counts.append(counts())
    fg_trail = []
    t_fg = time.perf_counter()
    placed = drive(eng_s, sup_s, sup_images, 20, fg_trail)
    fg_s = time.perf_counter() - t_fg
    if sup_s.swaps != 1 or sup_s.rollbacks != 0 or sup_s.state != MONITOR \
            or plan_fingerprint(eng_s.plan) != fp_b or \
            eng_s.stats()["plan"] != {"swaps": 1, "rollbacks": 0}:
        raise CheckFailed(f"foreground supervisor: swaps {sup_s.swaps}, "
                          f"rollbacks {sup_s.rollbacks}, state {sup_s.state}"
                          f"; trail {fg_trail}")
    swap_row = next(row for row in fg_trail if row[2])
    swap_tick, fg_compile_s = swap_row[0], swap_row[6]
    # The ladder's eager passes and captures are the only launches: one of
    # each per bucket of plan B, none in a served tick.
    ladder = tuple(2 * nb * k for k in per_b)
    if tuple(a - b for a, b in zip(swap_counts[0], fg_base)) != ladder or \
            swap_counts[0] != counts():
        raise CheckFailed(f"foreground launches: before the run "
                          f"{launch_text(fg_base)}, at the swap "
                          f"{launch_text(swap_counts[0])}, now "
                          f"{launch_text(counts())}; the ladder's two passes "
                          f"are {launch_text(ladder)}")
    runs_b = dict(eng_s._runs)
    fresh_a = solo_results(gnet, params_s, plan_a,
                           [sup_waves[k % 4] for k in range(20)],
                           [sup_images[r % 64] for r in range(len(placed))])
    fresh_b = solo_results(gnet, params_s, plan_b,
                           [sup_waves[k % 4] for k in range(20)],
                           [sup_images[r % 64] for r in range(len(placed))])
    n_before = 0
    for rid, (tick, fp) in placed.items():
        want_fp = fp_a if tick <= swap_tick else fp_b
        ref = fresh_a if tick <= swap_tick else fresh_b
        n_before += tick <= swap_tick
        if fp != want_fp or not np.array_equal(eng_s.done[rid], ref[rid]):
            raise CheckFailed(f"request {rid} (tick {tick}, swap after tick "
                              f"{swap_tick}) differs from the fresh plan-"
                              f"{'A' if tick <= swap_tick else 'B'} engine's")
    print(f"[21] supervisor, foreground: {len(fg_trail)} ticks in {fg_s:.2f} "
          f"s; re-solve adopted at the check after tick {swap_tick}, its "
          f"ladder compiled, warmed and captured in {fg_compile_s:.2f} s on "
          f"this thread and swapped in (plan B, fingerprint equal to map_network under the 6x "
          f"calibration), probation passed, no rollback; {n_before} "
          f"requests before the swap bit-equal to a fresh plan-A engine's, "
          f"{len(placed) - n_before} after it to a fresh plan-B engine's; "
          f"launches only the ladder's eager pass and capture per bucket, "
          f"none in a served tick; stats "
          f"{json.dumps(sup_s.stats()['last_replan'])}")

    # Kernel rows per served tick before and after the swap (one wave of
    # 8 each), against plans A's and B's lowerings.
    def one_tick(engine, base):
        def serve():
            base[0] += 8
            for i in range(8):
                engine.submit(CNNRequest(rid=base[0] + i,
                                         image=sup_images[i]))
            engine.run_until_done()
        return serve
    base_rid = [10 ** 6]
    _, rows_b = profiled_launches(one_tick(eng_s, base_rid))
    probe = CNNServingEngine(gnet, params_s, plan_a, batch_size=8,
                             cache=shared, warmup=True, device=dev)
    _, rows_a = profiled_launches(one_tick(probe, base_rid))
    if launches_by_name(rows_a) != per_a or launches_by_name(rows_b) != per_b:
        raise CheckFailed(f"kernel rows per tick: plan A "
                          f"{launch_text(launches_by_name(rows_a))} (want "
                          f"{launch_text(per_a)}), plan B "
                          f"{launch_text(launches_by_name(rows_b))} (want "
                          f"{launch_text(per_b)})")
    print(f"[21] kernel rows of one served tick (profiler): plan A "
          f"{launch_text(launches_by_name(rows_a))}; plan B "
          f"{launch_text(launches_by_name(rows_b))}")

    # A tick in flight at the swap (depth 2) retires on plan A: the new
    # ladder is compiled and warmed without retiring it.
    deep = CNNServingEngine(gnet, params_s, plan_a, batch_size=8,
                            pipeline_depth=2, cache=shared, warmup=True,
                            device_delay_s=0.25, device=dev)
    for i in range(8):
        deep.submit(CNNRequest(rid=i, image=sup_images[i]))
    deep.step(flush=True)
    held = [t.tick_idx for t in deep._inflight]
    deep.swap_plan(plan_b)
    still = [t.tick_idx for t in deep._inflight]
    for i in range(8, 16):
        deep.submit(CNNRequest(rid=i, image=sup_images[i]))
    deep.step(flush=True)
    deep.drain()
    want_b = runs_b[8](params_s, torch.as_tensor(
        np.stack(sup_images[8:16]), device=dev)).cpu().numpy()
    if held != [0] or still != [0] or any(
            not np.array_equal(deep.done[i], fresh_a[i]) for i in range(8)) \
            or any(not np.array_equal(deep.done[8 + i], want_b[i])
                   for i in range(8)):
        raise CheckFailed(f"depth 2: in flight before the swap {held}, after"
                          f" it {still}, or a result differs")
    print("[21] depth 2: the tick in flight at swap_plan (compiling its "
          "ladder itself) stayed in flight, retired on plan A bit-equal to "
          "the fresh plan-A engine's; the next tick bit-equal to plan B's "
          "program")
    del deep, probe

    # Background: the compile thread compiles, runs the eager pass and
    # captures the ladder while this thread serves; the test joins it.
    params_g = seeded_params(gnet, 3)
    eng_g, sup_g = supervised(params_g, check_every=4, rollback_ticks=3,
                              background=True)
    bg_base, bg_counts = counts(), []
    sup_g.on_swap = lambda result: bg_counts.append(counts())
    bg_trail = []
    rid = 0
    while sup_g.state != COMPILING:
        rid = max(drive(eng_g, sup_g, sup_images, 1, bg_trail, rid)) + 1
        if len(bg_trail) > 12:
            raise CheckFailed(f"background: no compile started {bg_trail}")
    t_bg = time.perf_counter()
    thread = sup_g._compile_thread
    served_meanwhile = 0
    while thread.is_alive():
        rid = max(drive(eng_g, sup_g, sup_images, 1, bg_trail, rid)) + 1
        served_meanwhile += 1
    thread.join()
    bg_s = time.perf_counter() - t_bg
    while sup_g.state == COMPILING:
        rid = max(drive(eng_g, sup_g, sup_images, 1, bg_trail, rid)) + 1
    drive(eng_g, sup_g, sup_images, 8, bg_trail, rid)
    if sup_g.swaps != 1 or sup_g.rollbacks != 0 or sup_g.state != MONITOR \
            or plan_fingerprint(eng_g.plan) != fp_b or bg_counts[0] != counts() \
            or tuple(a - b for a, b in zip(bg_counts[0], bg_base)) != ladder:
        raise CheckFailed(f"background supervisor: swaps {sup_g.swaps}, "
                          f"rollbacks {sup_g.rollbacks}, state {sup_g.state},"
                          f" counters before / at the swap / now {bg_base} / "
                          f"{bg_counts} / {counts()}; trail {bg_trail}")
    print(f"[21] supervisor, background: the compile thread took {bg_s:.2f} s"
          f" (compile, eager pass and thread-local capture of 4 buckets) "
          f"while this thread served {served_meanwhile} ticks, its launches "
          f"those of one eager pass and one capture per bucket "
          f"({launch_text(ladder)}); swapped once at the next tick boundary,"
          f" probation passed; no served tick moved a counter")
    del eng_g, sup_g

    # Rollback: the first post-swap tick fails (no probation sample), then
    # the new plan's ticks run 50x slower (0.2 s injected) and probation
    # re-arms plan A.
    box = {}

    def regress(_result):
        box["engine"].device_delay_s = 0.2
    eng_r, sup_r = supervised(
        params_s, check_every=3, rollback_ticks=3, rollback_factor=5.0,
        cooldown_checks=2, on_swap=regress,
        engine_kw=dict(max_retries=0,
                       fault_plan=FaultPlan({6: TickFault(failures=5)})))
    box["engine"] = eng_r
    rb_trail = []
    rid = 0
    while not sup_r.rollbacks:
        rid = max(drive(eng_r, sup_r, sup_images, 1, rb_trail, rid)) + 1
        if len(rb_trail) > 20:
            raise CheckFailed(f"rollback: none after 20 ticks {rb_trail}")
    swap_at = next(i for i, row in enumerate(rb_trail) if row[2])
    first_post = rb_trail[swap_at + 1]
    if first_post[0] != 6 or sup_r.swaps != 1 or sup_r.rollbacks != 1 or \
            plan_fingerprint(eng_r.plan) != fp_a or \
            eng_r.stats()["plan"] != {"swaps": 1, "rollbacks": 1} or \
            eng_r.failed_ticks != 1 or not first_post[4] or \
            first_post[5] != 0 or sup_r.state != MONITOR:
        raise CheckFailed(f"rollback: swaps {sup_r.swaps}, rollbacks "
                          f"{sup_r.rollbacks}, plan A re-armed "
                          f"{plan_fingerprint(eng_r.plan) == fp_a}, failed "
                          f"ticks {eng_r.failed_ticks}; trail {rb_trail}")
    eng_r.device_delay_s = 0.004
    after = images_of(216, 8)
    for i, img in enumerate(after):
        eng_r.submit(CNNRequest(rid=5000 + i, image=img))
    eng_r.run_until_done()
    want_a = runs_a[8](params_s, torch.as_tensor(np.stack(after),
                                                 device=dev)).cpu().numpy()
    if any(not np.array_equal(eng_r.done[5000 + i], want_a[i])
           for i in range(8)):
        raise CheckFailed("after the rollback a result differs from plan "
                          "A's program")
    conserved(eng_r)
    print(f"[21] rollback: trail (tick, state, swaps, rollbacks, failed, "
          f"samples) {rb_trail}; one swap, one rollback, plan A re-armed, "
          f"stats()['plan'] {eng_r.stats()['plan']}; the failed first "
          f"post-swap tick gave no probation sample; results after the "
          f"rollback bit-equal to plan A's program; {memory_text()}")
    del eng_r, sup_r

    # Printed, not gated: plans A and B beside phase 4's all-im2col plan,
    # each bucket program replayed and timed by events, interleaved; and
    # one capture per bucket of a fresh plan-B program.
    run_i = {bsz: compile_plan(gnet, plan, epilogue="bias_relu",
                               tuning_batch=bsz, device=dev)
             for bsz in BUCKETS}
    plan_ms = {}
    for bsz in BUCKETS:
        x = randn(bsz, 224, 224, 3)
        fns = {"A": lambda: runs_a[bsz](params_s, x),
               "B": lambda: runs_b[bsz](params_s, x),
               "im2col": lambda: run_i[bsz](params_s, x)}
        for order in (("A", "B", "im2col"), ("im2col", "B", "A")):
            for name in order:
                plan_ms.setdefault((bsz, name), []).append(time_ms(fns[name]))
    capture_ms = {}
    for bsz in BUCKETS:
        fresh = compile_plan(gnet, plan_b, epilogue="bias_relu",
                             tuning_batch=bsz, device=dev)
        x = torch.zeros((bsz, 224, 224, 3), device=dev)
        fresh(params_s, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh(params_s, x)
        torch.cuda.synchronize()
        capture_ms[bsz] = (time.perf_counter() - t0) * 1e3
        del fresh
    print("[21] replayed forward ms by events (A, B, all-im2col; two "
          "interleaved readings each): " + "; ".join(
              f"b{bsz} " + ", ".join(
                  f"{name} " + "/".join(f"{v:.4f}" for v in plan_ms[(bsz, name)])
                  for name in ("A", "B", "im2col")) for bsz in BUCKETS))
    print(f"[21] capture (+ one replay) of a fresh plan-B program, ms per "
          f"bucket {json.dumps({b: round(v, 2) for b, v in capture_ms.items()})}"
          f"; foreground supervisor run {fg_s:.2f} s; background compile "
          f"{bg_s:.2f} s; after both swaps {memory_text()}")
    print(f"[21] phase 21 took {time.perf_counter() - t21:.1f} s")

    # ---- 22. the data-parallel mesh: this slice's main path -------------
    # Full-width GoogleNet under plan A. On this card a real mesh has one
    # device; "virtual" meshes name cuda:0 two and four times, which runs
    # the whole split path (split, per-shard captures and replays, gather)
    # and tests placement, never speed. Every count is reset before 22.2
    # and read after 22.4; the stages' launches are read as differences.
    t22 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_cards = torch.cuda.device_count()
    smi_all = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    mesh_all = make_data_mesh()
    try:
        make_data_mesh(n_cards + 1)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise CheckFailed(f"make_data_mesh({n_cards + 1}) did not raise")
    if mesh_all.devices != tuple(torch.device("cuda", i)
                                 for i in range(n_cards)):
        raise CheckFailed(f"make_data_mesh() devices {mesh_all.devices}")
    print(f"[22] torch.cuda.device_count() {n_cards}: "
          + "; ".join(f"cuda:{i} {torch.cuda.get_device_name(i)} ({line})"
                      for i, line in enumerate(smi_all[:n_cards]))
          + f"; make_data_mesh() devices "
          f"{[str(d) for d in mesh_all.devices]}; make_data_mesh("
          f"{n_cards + 1}) raises ValueError: {refused}")
    none = (0,) * len(ALL_KERNELS)

    def launched(fn):
        """``fn()``'s result and the launches the counters read over it
        (no reset: the phase's total keeps counting)."""
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        return out, tuple(a - b for a, b in zip(counts(), before))

    def times(n, per):
        return tuple(n * k for k in per)

    def check_mesh_programs(tag, mesh, buckets):
        """Plan A's program on ``mesh`` at each bucket, three calls (the
        eager pass, the capture, a replay): the counters read every
        shard's lowering on the first two and 0 on the replay; every shard
        holds one capture; each shard's rows equal the unsharded program's
        at the per-chip batch bit for bit; with more than one shard the
        output is within the whole-plan tolerance of the unsharded program
        at the full bucket, and a batch that does not divide raises.
        Returns {bucket: program}."""
        k = data_shard_count(mesh)
        reps = replicate(params_s, mesh)
        programs = {}
        for bsz in buckets:
            per = bsz // k
            run_m = compile_plan(gnet, plan_a, epilogue="bias_relu",
                                 tuning_batch=per, mesh=mesh, device=dev)
            if expected_launches(run_m.lowering, gnet) != per_a:
                raise CheckFailed(f"{tag} b{bsz}: not plan A's lowering")
            x = randn(bsz, 224, 224, 3)
            outs = []
            for stage, want_n in (("eager", times(k, per_a)),
                                  ("capture", times(k, per_a)),
                                  ("replay", none)):
                out, n = launched(lambda: run_m(reps, x))
                if n != want_n:
                    raise CheckFailed(
                        f"{tag} b{bsz} {stage} pass: launches {n}, expected "
                        f"{want_n} {KERNEL_NAMES}")
                outs.append(out)
            caps = [list(s.captures.values()) for s in run_m.shards]
            if len(caps) != k or any(len(c) != 1 or None in c for c in caps):
                raise CheckFailed(f"{tag} b{bsz}: captures per shard "
                                  f"{[len(c) for c in caps]}, expected 1 each")
            run_c = compile_plan(gnet, plan_a, epilogue="bias_relu",
                                 tuning_batch=per, device=dev)
            for i in range(k):
                rows = slice(i * per, (i + 1) * per)
                want = run_c(params_s, x[rows])
                for stage, out in zip(("eager", "capture", "replay"), outs):
                    if not torch.equal(out[rows], want):
                        raise CheckFailed(
                            f"{tag} b{bsz} {stage} pass: shard {i}'s rows "
                            f"differ from the unsharded program at batch "
                            f"{per} (max|diff| "
                            f"{float((out[rows] - want).abs().max()):.3e})")
            text = (f"each of {k} shard(s) bit-equal to the unsharded "
                    f"program at batch {per} after the eager pass, the "
                    f"capture and a replay")
            if k > 1:
                run_f = compile_plan(gnet, plan_a, epilogue="bias_relu",
                                     tuning_batch=bsz, device=dev)
                err = check_close(f"{tag} b{bsz} vs unsharded", outs[2],
                                  run_f(params_s, x), **FORWARD_TOL)
                text += (f"; max|diff| vs the unsharded program at b{bsz} "
                         f"{err:.3e} (rtol 2e-2 atol 2e-3)")
                del run_f
            del run_c
            programs[bsz] = run_m
            print(f"[22] {tag} b{bsz}: per-chip batch {per}; launches on "
                  f"the eager and the capture pass {k} x plan A's lowering, "
                  f"0 on a replay; {k} capture(s); {text}")
        if k > 1:
            try:
                programs[buckets[0]](reps, randn(k + 1, 224, 224, 3))
            except ValueError as exc:
                if "data shards" not in str(exc):
                    raise
            else:
                raise CheckFailed(f"{tag}: a batch of {k + 1} did not raise")
            print(f"[22] {tag}: a batch of {k + 1} raises ValueError")
        return programs

    # 22.2 Mesh-1 against unsharded, at every bucket.
    reset_counts()
    mesh1 = make_data_mesh(1)
    if mesh1.devices != (torch.device("cuda", 0),):
        raise CheckFailed(f"make_data_mesh(1) devices {mesh1.devices}")
    progs22 = {1: check_mesh_programs("mesh-1", mesh1, BUCKETS)}
    # 22.3 Virtual meshes of 2 and 4 shards on cuda:0.
    virtual = {k: DataMesh(("cuda:0",) * k) for k in (2, 4)}
    for k, vm in virtual.items():
        progs = check_mesh_programs(f"virtual {k}-shard", vm,
                                    batch_buckets(8, k))
        if k == 2:
            progs22[2] = progs
        del progs

    # 22.4 Engines: a tuning record whose per-chip buckets 1 and 2 bind
    # different tiles, each engine's bucket programs taking the entries of
    # their per-chip batch; a burst of 8, another 8 and a tick of 2.
    rec22 = TuningRecord()
    for node in gnet.conv_nodes():
        algo = plan_a.assignment[node.id].key
        for per, tile in ((1, (64, 64)), (2, (128, 64))):
            rec22.entries.setdefault(record_key(node.conv, per), LayerTuning(
                binding=Binding(algo, "NS", tile[0], tile[1], "pallas"),
                measured_s=1.0, candidates=[], batch=per))
    eng_waves = (8, 8, 2)
    eng_images = images_of(221, sum(eng_waves))

    def check_mesh_engine(tag, mesh, depth):
        """Build a ``rec22``-tuned engine on ``mesh`` (None: unsharded) at
        ``depth``, hold its lowerings to the per-chip entries and its
        warm-up to two passes of every shard's lowering, serve
        ``eng_waves`` (replays: no counter moves) and check its sharding
        stats, ``last_tick`` and the zeroed stale staging rows. Returns
        {rid: logits}."""
        k = 1 if mesh is None else data_shard_count(mesh)
        eng, n_warm = launched(lambda: CNNServingEngine(
            gnet, params_s, plan_a, batch_size=8, tuning=rec22, mesh=mesh,
            warmup=True, pipeline_depth=depth, device=dev))
        want_warm = [0] * len(ALL_KERNELS)
        for bsz in eng.buckets:
            run = eng._runs[bsz]
            for node in gnet.conv_nodes():
                b = rec22.lookup(node.conv, batch=bsz // k).binding
                low = run.lowering[node.id]
                if (low.algo.key, low.p1, low.p2, low.backend) != \
                        (b.algo_key, b.p1, b.p2, b.backend):
                    raise CheckFailed(
                        f"{tag} depth {depth} b{bsz}: conv {node.id} lowers "
                        f"to {low.algo.key} {low.p1}x{low.p2} {low.backend}, "
                        f"not the per-chip b{bsz // k} entry {b.label()}")
            shards = getattr(run, "shards", (run,))
            if len(shards) != k or any(
                    len(s.captures) != 1 or None in s.captures.values()
                    for s in shards):
                raise CheckFailed(f"{tag} depth {depth} b{bsz}: not one "
                                  f"capture on each of {k} shard(s)")
            per_fwd = expected_launches(run.lowering, gnet)
            want_warm = [w + 2 * k * n for w, n in zip(want_warm, per_fwd)]
        if n_warm != tuple(want_warm):
            raise CheckFailed(f"{tag} depth {depth}: warm-up launches "
                              f"{n_warm}, expected {tuple(want_warm)}")
        rid = 0
        trail = []
        before = dict(eng.dispatches)

        def serve():
            nonlocal rid
            for n in eng_waves:
                for _ in range(n):
                    eng.submit(CNNRequest(rid=rid, image=eng_images[rid]))
                    rid += 1
                eng.step(flush=True)
                trail.append(eng._last_buf_index)
            eng.drain()

        _, n_served = launched(serve)
        if n_served != none:
            raise CheckFailed(f"{tag} depth {depth}: the served ticks moved "
                              f"the counters by {n_served}")
        last = eng.last_tick
        want_sh = None if mesh is None else {
            "data_shards": k, "mesh_devices": k,
            "per_chip_batch": {b: b // k for b in eng.buckets}}
        if eng.stats()["sharding"] != want_sh or \
                last["bucket"] != 2 or last["per_chip_batch"] != 2 // k or \
                {b: eng.dispatches[b] - before[b] for b in (2, 8)} != \
                {2: 1, 8: 2} or \
                sorted(eng.done) != list(range(sum(eng_waves))):
            raise CheckFailed(f"{tag} depth {depth}: sharding "
                              f"{eng.stats()['sharding']}, last_tick {last}, "
                              f"dispatches {eng.dispatches}")
        slot = trail[-1]
        if trail[0] != slot or bool(eng._batch_bufs[slot][2:].any()):
            raise CheckFailed(f"{tag} depth {depth}: the tick of 2 in slot "
                              f"{slot} (slots {trail}) left stale rows")
        conserved(eng)
        print(f"[22] {tag} engine depth {depth}: buckets {eng.buckets} "
              f"(per-chip {[b // k for b in eng.buckets]}), each lowering "
              f"on its per-chip entries; warm-up launches "
              f"{launch_text(n_warm)}, 0 over the served ticks; "
              f"stats()['sharding'] {eng.stats()['sharding']}; last_tick "
              f"bucket 2 per_chip_batch {last['per_chip_batch']}; the tick "
              f"of 2 in slot {slot} zeroed the 6 stale rows")
        out = {r: eng.done[r] for r in eng.done}
        del eng
        return out

    solo22 = {}

    def check_engines(tag, mesh, bit_equal):
        if not solo22:
            solo22.update(check_mesh_engine("unsharded", None, 1))
        solo = solo22
        err = 0.0
        for depth in (1, 2):
            got = check_mesh_engine(tag, mesh, depth)
            for r, want in solo.items():
                if bit_equal and not np.array_equal(got[r], want):
                    raise CheckFailed(f"{tag} depth {depth}: request {r} "
                                      f"differs from the unsharded engine's")
                err = max(err, check_close(
                    f"{tag} depth {depth} request {r}",
                    torch.as_tensor(got[r]), torch.as_tensor(want),
                    **FORWARD_TOL))
        print(f"[22] {tag} engines at depths 1 and 2: results "
              + ("bit-equal to" if bit_equal else "within rtol 2e-2 atol "
                 "2e-3 of") + f" the unsharded engine's (max|diff| "
              f"{err:.3e})")

    def check_tenants(tag, mesh):
        """Two tenants on ``mesh``: one program per bucket shared (cache
        hits), each shard holding one capture per params; a burst each,
        against the unsharded program."""
        k = data_shard_count(mesh)
        multi22 = MultiModelEngine()
        tenants = {"a": params_s, "b": seeded_params(gnet, 3)}
        for name, p in tenants.items():
            multi22.register_model(name, gnet, p, plan_a, batch_size=8,
                                   mesh=mesh, warmup=True, device=dev)
        ea, eb = multi22.engines["a"], multi22.engines["b"]
        nb = len(ea.buckets)
        if multi22.cache.stats() != {"entries": nb, "hits": nb,
                                     "misses": nb}:
            raise CheckFailed(f"{tag} tenants: cache "
                              f"{multi22.cache.stats()}")
        for bsz in ea.buckets:
            run = ea._runs[bsz]
            if run is not eb._runs[bsz] or len(run.shards) != k or any(
                    len(s.captures) != 2 or None in s.captures.values()
                    for s in run.shards):
                raise CheckFailed(f"{tag} tenants b{bsz}: not one shared "
                                  f"program with two captures a shard")
        images = images_of(222, 11)
        for name in tenants:
            for i, img in enumerate(images):
                multi22.submit(name, CNNRequest(rid=i, image=img))
        done = multi22.run_until_done()
        run_f = compile_plan(gnet, plan_a, epilogue="bias_relu",
                             tuning_batch=8, device=dev)
        err = 0.0
        for name, p in tenants.items():
            for lo in (0, 8):
                chunk = images[lo:lo + 8]
                want = run_f(p, torch.as_tensor(np.stack(chunk), device=dev))
                for i in range(len(chunk)):
                    err = max(err, check_close(
                        f"{tag} tenant {name} request {lo + i}",
                        torch.as_tensor(done[name][lo + i], device=dev),
                        want[i], **FORWARD_TOL))
            conserved(multi22.engines[name])
        print(f"[22] {tag} tenants: cache {multi22.cache.stats()} (the "
              f"second tenant compiled nothing); each bucket program shared, "
              f"{k} x 2 captures; 11 requests a tenant within rtol 2e-2 "
              f"atol 2e-3 of the unsharded program (max|diff| {err:.3e})")
        del multi22, ea, eb, run, run_f

    check_engines("mesh-1", mesh1, bit_equal=True)
    check_engines("virtual 2-shard", virtual[2], bit_equal=False)
    check_tenants("virtual 2-shard", virtual[2])
    # One foreground swap to plan B on a mesh-1 engine: its next tick is a
    # replay, bit-equal to plan B's unsharded program.
    eng_sw = CNNServingEngine(gnet, params_s, plan_a, batch_size=8,
                              mesh=mesh1, warmup=True, device=dev)
    eng_sw.swap_plan(plan_b)
    sw_images = images_of(223, 8)

    def serve_swapped():
        for i, img in enumerate(sw_images):
            eng_sw.submit(CNNRequest(rid=i, image=img))
        return eng_sw.run_until_done()

    done_sw, n_sw = launched(serve_swapped)
    want_sw = runs_b[8](params_s, torch.as_tensor(np.stack(sw_images),
                                                  device=dev)).cpu().numpy()
    if n_sw != none or eng_sw.dispatches[8] != 1 or any(
            not np.array_equal(done_sw[i], want_sw[i]) for i in range(8)):
        raise CheckFailed(f"mesh-1 swap to plan B: launches {n_sw}, "
                          f"dispatches {eng_sw.dispatches}, or results "
                          f"differ from plan B's unsharded program")
    print(f"[22] mesh-1 engine swapped to plan B in the foreground "
          f"(stats()['plan'] {eng_sw.stats()['plan']}): its first tick of 8 "
          f"a replay (no counter moved), bit-equal to plan B's unsharded "
          f"program")
    del eng_sw
    path22 = counts()
    if any(path22[KERNEL_NAMES.index(k)] == 0 for k in PATH21):
        raise CheckFailed(f"the mesh path launched {launch_text(path22)}")
    print(f"[22] launches over 22.2-22.4 (counts reset before 22.2): "
          f"{launch_text(path22)}")

    # 22.5 Printed, not gated: replayed forwards by events, interleaved —
    # unsharded (phase 21's plan-A programs), mesh-1 and the virtual
    # 2-shard mesh. One card runs the shards one after another: no
    # scaling can show here.
    mesh_ms = {}
    reps1 = replicate(params_s, mesh1)
    reps2 = replicate(params_s, virtual[2])
    for bsz in (2, 4, 8):
        x = randn(bsz, 224, 224, 3)
        fns = {"unsharded": lambda: runs_a[bsz](params_s, x),
               "mesh-1": lambda: progs22[1][bsz](reps1, x),
               "virtual 2": lambda: progs22[2][bsz](reps2, x)}
        for order in (("unsharded", "mesh-1", "virtual 2"),
                      ("virtual 2", "mesh-1", "unsharded")):
            for name in order:
                mesh_ms.setdefault((bsz, name), []).append(time_ms(fns[name]))
    print("[22] replayed forward ms by events (unsharded, mesh-1, virtual "
          "2-shard; two interleaved readings each): " + "; ".join(
              f"b{bsz} " + ", ".join(
                  f"{name} " + "/".join(f"{v:.4f}"
                                        for v in mesh_ms[(bsz, name)])
                  for name in ("unsharded", "mesh-1", "virtual 2"))
              for bsz in (2, 4, 8))
          + f"; virtual 2-shard b8 / (2 x unsharded b4) "
          f"{min(mesh_ms[(8, 'virtual 2')]) / (2 * min(mesh_ms[(4, 'unsharded')])):.3f}"
          f"; {memory_text()}")
    del progs22

    # 22.6 A mesh over two real cards, only where two are visible.
    if n_cards >= 2:
        real2 = make_data_mesh(2)
        progs = check_mesh_programs("real 2-card", real2, batch_buckets(8, 2))
        del progs
        check_engines("real 2-card", real2, bit_equal=False)
        check_tenants("real 2-card", real2)
    else:
        print(f"[22] 22.6 skipped: a mesh over two real cards needs two "
              f"visible cards and this machine shows {n_cards}; the one-card "
              f"meshes above ran every other check")
    print(f"[22] phase 22 took {time.perf_counter() - t22:.1f} s")

    # ---- 23. the two user examples, in-process through main(argv) --------
    t23 = time.perf_counter()
    sys.path.insert(0, str(SRC.parent / "examples"))
    import quickstart_torch
    import serve_cnn_torch

    def run_example(tag, main_fn, argv):
        """Run one example's ``main(argv)`` with every count reset, its
        output kept: (output, launches, seconds). Its text lines are
        printed; a nonzero return or a ``SystemExit`` fails the phase."""
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            try:
                rc = main_fn(argv)
            except SystemExit as exc:
                rc = exc.code if exc.code is not None else 0
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = counts()
        out = buf.getvalue()
        head = out.split("\n{", 1)[0].splitlines()
        for line in head:
            print(f"[23] {tag}: {line}")
        if rc != 0:
            raise CheckFailed(f"{tag} ended with {rc!r}")
        print(f"[23] {tag}: {secs:.1f} s; launches {launch_text(n)}")
        return out, n, secs

    def kernels_of(lowerings):
        """The kernels the layers of ``lowerings`` that run on kernels
        (backend auto or pallas, not cuDNN or the plain oracles)
        launch."""
        names = set()
        for low in lowerings:
            on_kernels = {nid: c for nid, c in low.items()
                          if c.backend in ("auto", "pallas")}
            names |= {k for k, v in zip(
                KERNEL_NAMES, expected_launches(on_kernels, gnet)) if v}
        return names

    def must_launch(tag, n, names):
        missed = sorted(k for k in names if n[KERNEL_NAMES.index(k)] == 0)
        if missed or not names:
            raise CheckFailed(f"{tag}: kernels {missed} of its path "
                              f"({sorted(names)}) never launched")

    def serve_stats(tag, out, n_models):
        stats = json.loads(out[out.index("\n{") + 1:])
        per = list(stats["models"].values()) if n_models > 1 else [stats]
        for s in per:
            rb = s["robustness"]
            if sum(rb["outcomes"].values()) + rb["pending"] != \
                    s["submitted"]:
                raise CheckFailed(f"{tag}: outcomes {rb['outcomes']} + "
                                  f"pending {rb['pending']} != "
                                  f"{s['submitted']}")
            print(f"[23] {tag}: outcomes {rb['outcomes']}, dispatches "
                  f"{s['dispatches']}, conserved")
        return stats

    hw_q = identify_parameters(gnet, spec=FPGA_LIKE, max_dim=512,
                               k_panel=256)
    plan_q = map_network(gnet, hw=hw_q, spec=FPGA_LIKE)
    _, n_q, s_q = run_example("quickstart", quickstart_torch.main, [])
    must_launch("quickstart", n_q, kernels_of([compile_plan(
        gnet, plan_q, epilogue="bias_relu", device=dev).lowering]))
    ex_s = {"quickstart": s_q}
    with tempfile.TemporaryDirectory() as tmp:
        rec_path = str(Path(tmp) / "serve_cnn_record.json")
        runs23 = (("serve", ["--record", rec_path], 1),
                  ("serve --models 2", ["--record", rec_path, "--models",
                                        "2"], 2),
                  ("serve --pipeline-depth 2 --chaos",
                   ["--record", rec_path, "--pipeline-depth", "2", "--chaos",
                    "--max-queue", "16"], 1),
                  ("serve --precision auto",
                   ["--record", rec_path, "--precision", "auto"], 1))
        for tag, argv, n_models in runs23:
            out, n, secs = run_example(tag, serve_cnn_torch.main, argv)
            ex_s[tag] = secs
            serve_stats(tag, out, n_models)
            if "--precision" in argv:
                # The gated plan's int8 layers keep the plan's binding (the
                # record holds bf16 entries only): at least one int8 kernel.
                must_launch(tag, n, {k for k in ("gemm_i8", "conv_im2col_i8",
                                                 "unit_conv_gemms_i8",
                                                 "pad_accumulate_i32")
                                     if n[KERNEL_NAMES.index(k)]})
                continue
            record = TuningRecord.load(rec_path)
            must_launch(tag, n, kernels_of(
                [compile_plan(gnet, plan, epilogue="bias_relu",
                              device=dev).lowering]
                + [compile_plan(gnet, plan, epilogue="bias_relu",
                                tuning=record, tuning_batch=b,
                                device=dev).lowering for b in BUCKETS]))
    print(f"[23] seconds per run {json.dumps({k: round(v, 1) for k, v in ex_s.items()})}; "
          f"phase 23 took {time.perf_counter() - t23:.1f} s")

    # ---- 24. the fused-epilogue options: this slice's main path ---------
    # (a) AvgPool as a 3x3 conv on the im2col kernel (§3.4) at bucket 8 on
    # Inception-v4's three pool shapes and a 3x3 s2 VALID map; (b) the
    # full-width f32 Inception-v4 under its plan with every POOL_AVG on the
    # kernel; (c) full-width GoogleNet with no plan, every conv kn2row
    # (``default_algo=KN2ROW``) against every conv im2col.
    t24 = time.perf_counter()
    torch.cuda.empty_cache()
    from repro_torch.cnn import layers as cnn_layers
    from repro_torch.core.algorithms import KN2ROW
    from repro_torch.core.graph import LayerKind
    conv_slot = KERNEL_NAMES.index("conv")

    def with_convs(n, extra):
        return tuple(v + extra * (i == conv_slot) for i, v in enumerate(n))

    def interleaved_ms(progs, order, p, x, reps=10):
        """{name: [ms, ...]} of replayed forwards by events, in ``order``
        (each program already captured)."""
        ms = {}
        for name in order:
            ms.setdefault(name, []).append(round(time_ms(
                lambda: progs[name](p, x), reps=reps, rounds=3), 4))
        return ms

    pool_cases = (("incA/ap 35x35x384 s1 SAME", 35, 384, 1, "SAME"),
                  ("incB/ap 17x17x1024 s1 SAME", 17, 1024, 1, "SAME"),
                  ("incC/ap 8x8x1536 s1 SAME", 8, 1536, 1, "SAME"),
                  ("35x35x384 s2 VALID", 35, 384, 2, "VALID"))
    one_conv = with_convs((0,) * len(ALL_KERNELS), 1)
    pool_rows = {}
    for label, hw, c, stride, pad in pool_cases:
        x = randn(8, hw, hw, c)

        def overlay_pool(use_pallas=None):
            return cnn_layers.avg_pool(x, 3, stride, pad, via="overlay",
                                       use_pallas=use_pallas)

        def jnp_pool():
            return cnn_layers.avg_pool(x, 3, stride, pad)

        reset_counts()
        got = overlay_pool()
        torch.cuda.synchronize()
        if counts() != one_conv:
            raise CheckFailed(f"overlay avg_pool {label}: launches "
                              f"{counts()}, expected one conv_im2col_f32")
        err = check_close(f"overlay avg_pool {label} vs the jnp pool", got,
                          jnp_pool(), **KERNEL_TOL)
        err_p = check_close(f"overlay avg_pool {label} vs its plain path",
                            got, overlay_pool(False), **KERNEL_TOL)
        o = int(got.shape[1])
        m, k, n = 8 * o * o, 9 * c, c
        b_ms, b_by = bound(2.0 * m * k * n, 4.0 * (8 * hw * hw * c + k * n
                                                    + m * n + o * o))
        pool_b_ms, pool_b_by = bound(9.0 * m * c, 4.0 * (8 * hw * hw * c
                                                         + m * c))
        o_ms = time_ms(overlay_pool, reps=5, rounds=3)
        j_ms = time_ms(jnp_pool, reps=5, rounds=3)
        pool_rows[label] = (o_ms, j_ms, b_ms)
        print(f"[24] avg_pool 3x3 b8 {label} via overlay (conv_im2col_f32 "
              f"M {m} K {k} N {n}, one launch): max|diff| vs the jnp pool "
              f"{err:.3e}, vs its plain path {err_p:.3e} (rtol/atol 1e-4); "
              f"events {o_ms:.4f} ms against the jnp pool's {j_ms:.4f} ms; "
              f"the conv's bound {b_ms:.4f} ms ({b_by}), the pool's own "
              f"{pool_b_ms:.4f} ms ({pool_b_by})")
    del x
    n_pools = sum(node.kind is LayerKind.POOL_AVG
                  for node in gi.nodes.values())
    for bsz in (1, 8):
        x = randn(bsz, 299, 299, 3)
        progs = {via: compile_plan(gi, iplan, epilogue="bias_relu",
                                   tuning_batch=bsz, avg_pool_via=via,
                                   device=dev)
                 for via in ("jnp", "overlay")}
        derived = expected_launches(progs["jnp"].lowering, gi)
        want_o = with_convs(derived, n_pools)
        tag = f"inception_v4 299 b{bsz} avg_pool_via=overlay"
        got, short = staged_runs(tag, progs["overlay"], iparams, x, want_o,
                                 "overlay")
        plain = compile_plan(gi, iplan, epilogue="bias_relu",
                             tuning_batch=bsz, use_pallas=False, device=dev)
        err = check_close(f"{tag} vs the plain path", got,
                          plain(iparams, x), **FORWARD_TOL)
        for _ in range(3):                        # eager, capture, replay
            jnp_out = progs["jnp"](iparams, x)
        err_j = check_close(f"{tag} vs the jnp-pool program", got, jnp_out,
                            **FORWARD_TOL)
        ms = interleaved_ms(progs, ("jnp", "overlay", "overlay", "jnp"),
                            iparams, x)
        print(f"[24] {tag}: {n_pools} POOL_AVG nodes; launches on the eager "
              f"and capture pass {launch_text(want_o)} (the lowering's "
              f"{launch_text(derived)} plus {n_pools} pool convs), 0 on a "
              f"replay; the captured graph's kernel nodes and one replay's "
              f"profiler rows equal them"
              + (f" ({len(short)} short window(s) retaken: {short})"
                 if short else "")
              + f"; max|diff| vs the plain path {err:.3e}, vs the jnp-pool "
              f"program {err_j:.3e} (rtol 2e-2 atol 2e-3); replayed forward "
              f"ms (events, interleaved jnp, overlay, overlay, jnp) "
              f"{json.dumps(ms)}")
        del progs, plain, got, jnp_out
        torch.cuda.empty_cache()

    for bsz in (1, 8):
        x = randn(bsz, 224, 224, 3)
        progs = {
            "im2col": compile_plan(gnet, None, epilogue="bias_relu",
                                   tuning_batch=bsz, device=dev),
            "kn2row": compile_plan(gnet, None, default_algo=KN2ROW,
                                   epilogue="bias_relu", tuning_batch=bsz,
                                   device=dev),
            "plan": compile_plan(gnet, plan, epilogue="bias_relu",
                                 tuning_batch=bsz, device=dev)}
        if {low.algo for low in progs["kn2row"].lowering.values()} != \
                {KN2ROW}:
            raise CheckFailed("default_algo=KN2ROW left a conv off kn2row")
        derived = expected_launches(progs["kn2row"].lowering, gnet)
        tag = f"googlenet 224 b{bsz} default_algo=KN2ROW"
        got, short = staged_runs(tag, progs["kn2row"], params, x, derived)
        plain = compile_plan(gnet, None, default_algo=KN2ROW,
                             epilogue="bias_relu", tuning_batch=bsz,
                             use_pallas=False, device=dev)
        err = check_close(f"{tag} vs the plain path", got, plain(params, x),
                          **FORWARD_TOL)
        for name in ("im2col", "plan"):
            for _ in range(3):
                out = progs[name](params, x)
            if name == "im2col":
                err_i = check_close(f"{tag} vs the all-im2col program", got,
                                    out, **FORWARD_TOL)
        ms = interleaved_ms(progs, ("im2col", "kn2row", "plan", "plan",
                                    "kn2row", "im2col"), params, x)
        print(f"[24] {tag}: launches on the eager and capture pass "
              f"{launch_text(derived)}, 0 on a replay; graph nodes and one "
              f"replay's profiler rows equal them"
              + (f" ({len(short)} short window(s) retaken: {short})"
                 if short else "")
              + f"; max|diff| vs the plain path {err:.3e}, vs the all-im2col "
              f"program {err_i:.3e} (rtol 2e-2 atol 2e-3); replayed forward "
              f"ms, printed not gated (all-im2col, all-kn2row, phase 4's "
              f"plan; events, interleaved) {json.dumps(ms)}")
        del progs, plain, got, out
        torch.cuda.empty_cache()

    # The kn2row kernels at shapes no plan had chosen: conv1 (7x7 s2, Cin
    # 3: K = 3 below one 16-deep chunk, G = 49, at full input resolution)
    # and inception_3a/5x5 (the generic 5x5 offsets).
    kn2_new = {}
    for label, hw, c_in, c_out, k, stride in (
            ("conv1", 224, 3, 64, 7, 2),
            ("inception_3a/5x5", 28, 16, 32, 5, 1)):
        for bsz in (1, 8):
            o1, o2, pt, _, pl, _ = conv_geometry(hw, hw, k, k, stride, "SAME")
            g_ = k * k
            m = bsz * hw * hw
            x2d = randn(m, c_in)
            wg = randn(g_, c_in, c_out, scale=(g_ * c_in) ** -0.5)
            bias = randn(c_out, scale=0.1)

            def unit():
                return kn2.unit_conv_gemms_call(x2d, wg)

            p = unit()
            u_err = check_close(f"unit_conv_gemms {label} b{bsz}", p,
                                kn2.unit_conv_gemms_plain(x2d, wg),
                                **KERNEL_TOL)
            u_bound = bound(2.0 * g_ * m * c_in * c_out,
                            4.0 * (m * c_in + g_ * c_in * c_out
                                   + g_ * m * c_out))
            u_ms = time_ms(unit, reps=5, rounds=3)
            u_lib = time_ms(lambda: torch.matmul(x2d, wg), reps=5, rounds=3)
            p5 = p.view(g_, bsz, hw, hw, c_out)
            geo = dict(k1=k, k2=k, o1=o1, o2=o2, stride=stride,
                       pad_top=pt, pad_left=pl, epilogue="bias_relu",
                       bias=bias)

            def pad_acc():
                return kn2.pad_accumulate_call(p5, **geo)

            a_err = check_close(f"pad_accumulate {label} b{bsz}", pad_acc(),
                                kn2.pad_accumulate_plain(p5, **geo),
                                **KERNEL_TOL)
            n_out = bsz * o1 * o2 * c_out
            a_bound = bound(1.0 * g_ * n_out,
                            4.0 * (pad_accumulate_reads(p5, geo) + c_out)
                            + 4.0 * n_out)
            a_ms = time_ms(pad_acc, reps=5, rounds=3)
            xin = x2d.view(bsz, hw, hw, c_in).permute(0, 3, 1, 2)
            wconv = wg.view(k, k, c_in, c_out).permute(3, 2, 0, 1)
            lib_ms = time_ms(lambda: F.conv2d(xin, wconv, bias, stride=stride,
                                              padding=k // 2),
                             reps=5, rounds=3)
            kn2_new[(label, bsz)] = (u_ms, u_bound, a_ms, a_bound, lib_ms)
            print(f"[24] kn2row {label} b{bsz}: unit_conv_gemms_f32 G {g_} M "
                  f"{m} K {c_in} N {c_out}: {u_ms:.4f} ms (events; max|diff| "
                  f"{u_err:.3e}), bound {u_bound[0]:.4f} ms ({u_bound[1]}), "
                  f"torch.matmul {u_lib:.4f} ms; pad_accumulate_f32 "
                  f"{k}x{k} s{stride} -> {o1}x{o2}: {a_ms:.4f} ms (max|diff| "
                  f"{a_err:.3e}), bound {a_bound[0]:.4f} ms ({a_bound[1]}); "
                  f"the whole conv by F.conv2d (cuDNN, no TF32) {lib_ms:.4f} "
                  f"ms")
            del p, p5, x2d, wg
    torch.cuda.empty_cache()
    print(f"[24] phase 24 took {time.perf_counter() - t24:.1f} s; "
          f"{memory_text()}")

    # ---- 25. the LM serving path: this slice's main path ----------------
    # h2o-danube-1.8b (dense, GQA, sliding window) and mamba2-370m (SSD) at
    # full width and depth, weights from a seeded CUDA generator: (a) in
    # f32, token-by-token decode reproduces the teacher-forced forward's
    # logits (the reference's serving invariant); (b) in the configs' bf16,
    # ``launch.serve``'s defaults through ``ServingEngine``.
    t25 = time.perf_counter()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import model as lm
    for name in ("h2o-danube-1.8b", "mamba2-370m"):
        cfg = get_config(name)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = lm.init_model(cfg32, torch.Generator(device=dev).manual_seed(0),
                            dev)
        tokens = torch.randint(0, cfg.vocab, (2, 12), device=dev,
                               generator=torch.Generator(
                                   device=dev).manual_seed(1))
        hidden, _ = lm.forward(p32, tokens, cfg32)
        ref = lm.logits_from_hidden(p32, cfg32, hidden)
        cache = lm.init_cache(cfg32, 2, 32, dev)
        steps = [lm.decode_step(p32, tokens[:, t:t + 1], cache, t, cfg32)[0]
                 for t in range(12)]
        err = check_close(f"{name} f32 decode vs forward",
                          torch.stack(steps, 1), ref, rtol=2e-3, atol=2e-3)
        print(f"[25] {name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.param_count() / 1e9:.3f} B params) f32: 12 decode steps "
              f"of batch 2 against the teacher-forced forward, logits max|"
              f"logit| {float(ref.abs().max()):.3e} max|diff| {err:.3e} "
              f"(rtol/atol 2e-3)")
        del p32, cache, steps, hidden, ref
        torch.cuda.empty_cache()

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = lm_serve.main(["--arch", name])
        lines = buf.getvalue().splitlines()
        streams = [json.loads(line.split(": ", 1)[1]) for line in lines
                   if line.startswith("request ")]
        if rc != 0 or len(streams) != 6 or any(
                len(s) != 8 or not all(0 <= t < cfg.vocab for t in s)
                for s in streams):
            raise CheckFailed(f"{name} served {streams} (rc {rc}); expected "
                              f"6 requests of 8 tokens in [0, {cfg.vocab})")
        pb = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
        cache = lm.init_cache(cfg, 4, 128, dev)
        tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
        step_ms = time_ms(lambda: lm.decode_step(pb, tok, cache, 12, cfg),
                          reps=5, rounds=3)
        print(f"[25] {name} bf16 launch.serve defaults (6 requests, batch 4, "
              f"prompt 12, 8 new, max_len 128): {lines[-1]}; every request "
              f"8 tokens in [0, {cfg.vocab}); one eager decode step of batch "
              f"4 {step_ms:.3f} ms (events); {memory_text()}")
        del pb, cache
        torch.cuda.empty_cache()
    print(f"[25] phase 25 took {time.perf_counter() - t25:.1f} s")

    def wino_entry(name, source, replaces, label, launches):
        k_ms, p_ms, l_ms, b_ms, b_by = wino_times[(name, label)]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": wino_err[label][name], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": l_ms}

    kernels = [
        {"name": "gemm_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm/gemm.py:117",
         "launches": gserve[1], "max_abs_err": gemm_err["conv2"],
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": g_lib},
        {"name": "conv_im2col_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/conv_im2col.cu",
         "replaces": "src/repro/kernels/conv_im2col/conv_im2col.py:89",
         "launches": gserve[0], "max_abs_err": conv_err["stem"],
         "ms": conv_times["googlenet stem"][0],
         "plain_ms": conv_times["googlenet stem"][1],
         "bound_ms": conv_times["googlenet stem"][3],
         "bound_by": conv_times["googlenet stem"][4],
         "library_ms": conv_times["googlenet stem"][2]},
        # Winograd kernels at VGG16's conv0_1, bucket 8. Launches: the
        # VGG16 serving run; the NHWC input transform is not on the elided
        # path, so its count is the unelided forward's.
        wino_entry("input_transform", "src/repro_torch/csrc/winograd.cu",
                   "src/repro/kernels/winograd/winograd.py:111", "conv0_1",
                   vgg_expect[False][2]),
        wino_entry("input_transform_tiles",
                   "src/repro_torch/csrc/winograd.cu",
                   "src/repro/kernels/winograd/winograd.py:141", "conv0_1",
                   vserve[3]),
        wino_entry("batched_gemm", "src/repro_torch/csrc/gemm.cu",
                   "src/repro/kernels/gemm/gemm.py:175", "conv0_1",
                   vserve[4]),
        wino_entry("output_transform", "src/repro_torch/csrc/winograd.cu",
                   "src/repro/kernels/winograd/winograd.py:192", "conv0_1",
                   vserve[5]),
    ]
    # kn2row kernels at Inception-v4's stem/c4, bucket 8; launches from the
    # Inception-v4 serving run.
    for name, symbol, line, idx in (
            ("unit_conv_gemms", "unit_conv_gemms_f32", 66, 6),
            ("pad_accumulate", "pad_accumulate_f32", 154, 7)):
        k_ms, p_ms, l_ms, b_ms, b_by = kn2_times[(name, "stem/c4")]
        kernels.append({
            "name": symbol, "route": "cuda",
            "source": "src/repro_torch/csrc/kn2row.cu",
            "replaces": f"src/repro/kernels/kn2row/kn2row.py:{line}",
            "launches": iserve[idx],
            "max_abs_err": kn2_err[name]["stem/c4"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms})
    # The int8 kernels at their phase-17 shapes, bucket 8; launches from
    # the gated plan's serving run.
    for name, source, replaces, err in (
            ("gemm_i8", "gemm.cu", "gemm/gemm.py:117",
             i8_err[("gemm_i8", "redA/b3b")]["f32"]),
            ("conv_im2col_i8", "conv_im2col.cu",
             "conv_im2col/conv_im2col.py:89",
             i8_err[("conv_im2col_i8", "stem/c1")]["f32"]),
            ("unit_conv_gemms_i8", "kn2row.cu", "kn2row/kn2row.py:66",
             i8_err[("unit_conv_gemms_i8", "stem/c4")]["int32"]),
            ("pad_accumulate_i32", "kn2row.cu", "kn2row/kn2row.py:154",
             i8_err[("pad_accumulate_i32", "stem/c4")]["f32"])):
        k_ms, p_ms, l_ms, b_ms, b_by, _ = i8_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": qserve[KERNEL_NAMES.index(name)],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    return kernels


def memory_line(dev) -> str:
    import torch
    return (f"memory_reserved {torch.cuda.memory_reserved(dev) / 2 ** 30:.2f}"
            f" GiB, max_memory_reserved "
            f"{torch.cuda.max_memory_reserved(dev) / 2 ** 30:.2f} GiB")


def kernel_rows(fn):
    """(kernel rows, device-busy ms, the five kernels of most device time
    as text) of one call of ``fn`` under ``torch.profiler``: every CUDA
    kernel the call ran, memcpys and memsets aside, and the sum of their
    own device time. Each window opens as ``opened_window`` says (an eager
    train step's rows came back 1-4 short of its graph's kernel nodes on
    the card behind an opener of sixteen); one whose opener came back with
    no row is taken again, up to three in all."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, averages = opened_window(fn)
        if averages is None:
            continue
        rows, busy, by_name = 0, 0.0, []
        for e in averages:
            if e.device_type != DeviceType.CUDA or "Memcpy" in e.key \
                    or "Memset" in e.key or "spin_kernel" in e.key:
                continue
            ms = getattr(e, "self_device_time_total", 0) / 1e3
            rows += e.count
            busy += ms
            by_name.append((ms, e.count, e.key[:120]))
        if rows:
            top = "; ".join(f"{name} x{n} {ms:.2f} ms" for ms, n, name in
                            sorted(by_name, reverse=True)[:5])
            return rows, busy, top
    raise CheckFailed("the profiler recorded no kernel rows in three "
                      "windows")


def served_streams(main_fn, argv, vocab: int):
    """Run ``launch.serve.main(argv)`` in-process; (its token streams, its
    last line). Fails unless it returns 0 with 6 requests of 8 tokens in
    the vocabulary (``launch.serve``'s defaults)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    lines = buf.getvalue().splitlines()
    streams = [json.loads(line.split(": ", 1)[1]) for line in lines
               if line.startswith("request ")]
    if rc != 0 or len(streams) != 6 or any(
            len(st) != 8 or not all(0 <= t < vocab for t in st)
            for st in streams):
        raise CheckFailed(f"served {streams} (rc {rc}); expected 6 requests "
                          f"of 8 tokens in [0, {vocab})")
    return streams, lines[-1]


def phase_26_decode_graph(dev) -> None:
    """26. The LM decode step captured as one CUDA graph (the reference's
    ``jax.jit(decode_step)``), h2o-danube-1.8b and mamba2-370m at full
    width and depth: (a) in f32, the engine's captured step (warm pass,
    capture, replays) over a 12-token prompt and 8 greedy tokens at batch
    4 gives the eager ``decode_step``'s logits on a cloned cache bit for
    bit, at every step; (b) in bf16, ``launch.serve``'s defaults through
    the captured engine give 6 requests of 8 tokens; printed, not gated:
    one replay's ms by events, its kernel rows and device-busy share under
    the profiler, the tokens/s and the memory reserved; (c) every
    architecture's reduced config captures and replays bit-equal to its
    eager step in f32."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import model as lm
    from repro_torch.models.scan_util import tree_leaves, tree_map
    from repro_torch.serving.engine import ServingEngine
    t26 = time.perf_counter()
    for name in ("h2o-danube-1.8b", "mamba2-370m"):
        cfg = get_config(name)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = lm.init_model(cfg32, torch.Generator(device=dev).manual_seed(0),
                            dev)
        eng = ServingEngine(cfg32, p32, batch_size=4, max_len=128,
                            device=dev)
        cache = tree_map(torch.clone, eng.cache)
        prompt = torch.randint(0, cfg.vocab, (12,), generator=torch.Generator(
            ).manual_seed(1)).tolist()
        slot, token, greedy = 1, prompt[0], []
        for pos in range(20):
            got = eng.decode_logits(slot, token, pos)
            tokens = torch.zeros((4, 1), dtype=torch.long, device=dev)
            tokens[slot, 0] = token
            with torch.no_grad():
                want, cache = lm.decode_step(p32, tokens, cache, pos, cfg32)
            if not torch.equal(got, want):
                raise CheckFailed(
                    f"[26] {name} f32 step {pos} ({'replay' if pos else 'warm'}"
                    f" pass): captured logits differ from the eager "
                    f"decode_step's, max|diff| "
                    f"{float((got - want).abs().max()):.3e}")
            if pos == 0 and eng._graph is None:
                raise CheckFailed(f"[26] {name}: no graph after the first "
                                  f"step on the card")
            if pos + 1 < len(prompt):
                token = prompt[pos + 1]
            else:
                token = int(torch.argmax(got[slot]))
                greedy.append(token)
        same_cache = all(torch.equal(a, b) for a, b in
                         zip(tree_leaves(eng.cache), tree_leaves(cache)))
        if not same_cache:
            raise CheckFailed(f"[26] {name}: the captured engine's cache "
                              f"differs from the eager one's")
        print(f"[26] {name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
              f"f32, batch 4, max_len 128: the captured step's logits equal "
              f"the eager decode_step's bit for bit at all 20 steps (warm "
              f"pass, then 19 replays: 12 prompt tokens, 8 greedy "
              f"{greedy}); caches equal")
        del eng, p32, cache, got, want
        torch.cuda.empty_cache()

        _, last = served_streams(
            lm_serve.main, ["--arch", name, "--device", str(dev)], cfg.vocab)
        pb = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
        eng = ServingEngine(cfg, pb, batch_size=4, max_len=128, device=dev)
        eng.decode_logits(0, 5, 12)                  # warm pass + capture
        replay_ms = time_ms(eng._graph.replay, reps=20, rounds=5)
        rows, busy, top = kernel_rows(eng._graph.replay)
        print(f"[26] {name} bf16 launch.serve defaults through the captured "
              f"engine: {last}; 6 requests of 8 tokens in [0, {cfg.vocab}); "
              f"one replayed decode step of batch 4 {replay_ms:.4f} ms "
              f"(events), {rows} kernel rows, device busy {busy:.4f} ms "
              f"({100 * busy / replay_ms:.1f}% of the replay; most: {top}); "
              f"{memory_line(dev)}")
        del eng, pb
        torch.cuda.empty_cache()
    # Every architecture's decode path captures (no host sync, no shape
    # that depends on data: the MLA latent cache, MoE routing and capacity,
    # the Zamba hybrid's shared block), reduced, f32, bit-equal to eager.
    for name in ARCH_NAMES:
        cfg32 = dataclasses.replace(get_config(name, reduced=True),
                                    dtype="float32")
        p32 = lm.init_model(cfg32, torch.Generator(device=dev).manual_seed(0),
                            dev)
        eng = ServingEngine(cfg32, p32, batch_size=3, max_len=16, device=dev)
        cache = tree_map(torch.clone, eng.cache)
        for pos in range(8):
            got = eng.decode_logits(pos % 3, 7 + pos, pos)
            tokens = torch.zeros((3, 1), dtype=torch.long, device=dev)
            tokens[pos % 3, 0] = 7 + pos
            with torch.no_grad():
                want, cache = lm.decode_step(p32, tokens, cache, pos, cfg32)
            if not torch.equal(got, want):
                raise CheckFailed(
                    f"[26] reduced {name} f32 step {pos}: captured logits "
                    f"differ from the eager decode_step's, max|diff| "
                    f"{float((got - want).abs().max()):.3e}")
    print(f"[26] every architecture's reduced decode step captured, 8 steps "
          f"of batch 3 each bit-equal to the eager step in f32: "
          f"{', '.join(ARCH_NAMES)}")
    print(f"[26] phase 26 took {time.perf_counter() - t26:.1f} s")


STEP_LOG = r"step\s+(\d+)\s+loss\s+(\S+)\s+gnorm\s+(\S+)\s+lr\s+(\S+)\s+dt\s+(\S+)s"


def run_train(argv):
    """``launch.train.main(argv)`` in-process: (its return code, its
    standard output, its logged steps as (step, loss, gnorm, lr, dt))."""
    import re

    from repro_torch.launch import train as lm_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lm_train.main(argv)
    out = buf.getvalue()
    logged = [(int(m[1]), float(m[2]), float(m[3]), float(m[4]),
               float(m[5])) for m in re.finditer(STEP_LOG, out)]
    return rc, out, logged


def event_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` between two CUDA events on the
    current stream (the call's work, and the host's gaps in it)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def clone_tree(tree):
    from repro_torch.models.scan_util import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])


def train_graph_check(dev, cfg, batch: int, seq: int,
                      microbatches: int) -> str:
    """27 (b): ``compile_train_step``'s first calls against as many eager
    ``train_step``s from the same weights and batches, at the mesh check's
    learning rate (``mesh_check.check_opt_config``). Calls 1-2 are the
    eager passes (the second under the profiler: its kernel rows), call 3
    captures and replays. Fails unless the graph's kernel
    nodes, every one counted, equal that eager pass's rows, and the
    params, moments, step and every call's metrics are bit-equal to the
    eager steps' or, where not, within ``mesh_check.check_rule`` of the
    step's own float noise, then measured, with that rule under the
    step's smallest param move. Returns the line to print."""
    import torch

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import mesh_check
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models import model as lm
    from repro_torch.models.scan_util import tree_leaves
    from repro_torch.optim.adamw import init_opt_state
    opt_cfg = mesh_check.check_opt_config(cfg)
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    state = init_opt_state(params, opt_cfg)
    batches = [make_batch(DataConfig(seed=3, global_batch=batch,
                                     seq_len=seq), cfg, i, device=dev)
               for i in range(4)]
    step = lm_steps.compile_train_step(
        clone_tree(params), clone_tree(state), batches[0], cfg=cfg,
        opt_cfg=opt_cfg, microbatches=microbatches)
    got = []

    def call():
        got.append({k: v.clone() for k, v in
                    step(batches[len(got)]).items()})

    rows, _, _ = kernel_rows(call)
    if len(got) != lm_steps.WARM_PASSES or step.graph is not None:
        raise CheckFailed(f"[27] {cfg.name}: {len(got)} calls before the "
                          f"capture (graph {step.graph}); expected "
                          f"{lm_steps.WARM_PASSES} eager passes")
    call()
    if step.graph is None:
        raise CheckFailed(f"[27] {cfg.name}: no graph after call "
                          f"{len(got)}")
    nodes = graph_kernel_symbols(step.graph)
    seen = [rows]
    while seen[-1] < len(nodes) and len(seen) < 4:
        # A window short of the graph's nodes: the profiler dropped rows
        # (2924 of 2925 once on the card), as phase 28's
        # mesh_graph_timing finds. Another eager pass of the body is read;
        # it is a real step, so the owned state is put back after it.
        saved = clone_tree((step.params, step.opt_state))
        seen.append(kernel_rows(step._warm_pass)[0])
        step.load_state(*saved)
        del saved
    if len(nodes) != seen[-1]:
        raise CheckFailed(f"[27] {cfg.name}: the captured step holds "
                          f"{len(nodes)} kernel nodes, eager passes of "
                          f"its body ran {seen} kernel rows")
    worst_metric, min_step = 0.0, None
    for i, metrics in enumerate(got):
        new_p, new_s, want = lm_steps.train_step(
            params, state, batches[i], cfg=cfg, opt_cfg=opt_cfg,
            microbatches=microbatches)
        if min_step is None:
            min_step = min(mesh_check.deviation(
                [old], [new], mesh_check.PARAM_FLOOR)["max_rel"]
                for old, new in zip(tree_leaves(params),
                                    tree_leaves(new_p)))
        if set(metrics) != set(want):
            raise CheckFailed(f"[27] {cfg.name}: metrics {sorted(metrics)}"
                              f", train_step's {sorted(want)}")
        for k, v in want.items():
            worst_metric = max(worst_metric, float(
                (metrics[k] - v).abs() / max(float(v.abs()), 1e-30)))
        params, state = new_p, new_s
    dev_p = mesh_check.deviation(step.params, params, mesh_check.PARAM_FLOOR)
    dev_s = mesh_check.deviation(step.opt_state, state)
    equal = dev_p["bit_equal"] and dev_s["bit_equal"] and worst_metric == 0
    worst = max(dev_p, dev_s, key=lambda d: d["max_rel"])
    held = "bit-equal"
    if not equal:
        noise = mesh_check.noise_floor(cfg, dev, batch=batch, seq=seq,
                                       microbatches=microbatches)
        rule = mesh_check.check_rule(noise, min_step)
        if max(worst["max_rel"], worst_metric) > rule["tol"] \
                or not rule["guarded"]:
            raise CheckFailed(
                f"[27] {cfg.name}: the compiled step is off the eager one by "
                f"{worst['max_rel']:.3e} at {worst['worst_leaf']} (metrics "
                f"{worst_metric:.3e}); the rule {rule}")
        held = (f"within the rule {rule['tol']:.2e} from the noise floor "
                f"{ {k: f'{v:.2e}' for k, v in noise['probes'].items()} }")
    return (f"[27] {cfg.name} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}), f32, batch {batch} x {seq}, {microbatches} "
            f"microbatches: {len(got)} calls of the compiled step (2 eager "
            f"passes, the capture and its replay) against train_step: "
            f"{held} (params, m, v, step: "
            f"{max(dev_p['max_rel'], dev_s['max_rel']):.3e}; metrics "
            f"{worst_metric:.3e}), the smallest step {min_step:.2e}; "
            f"{len(nodes)} kernel nodes = the eager pass's {seen[-1]} "
            f"kernel rows (windows read: {seen})")


def train_step_timing(dev) -> None:
    """27 (c): full-width bf16 h2o-danube-1.8b, batch 8 x 128, two
    microbatches: the eager ``train_step`` against the compiled step's
    warm passes, capture and replays. Printed, not gated, but the graph's
    kernel nodes must equal its second eager pass's kernel rows."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models import model as lm
    from repro_torch.optim.adamw import init_opt_state
    cfg = get_config("h2o-danube-1.8b")
    opt_cfg = lm_steps.make_opt_config(cfg, total_steps=30)
    batches = [make_batch(DataConfig(seed=0, global_batch=8, seq_len=128),
                          cfg, i, device=dev) for i in range(8)]

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        p = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
        return p, init_opt_state(p, opt_cfg)

    def gib():
        return torch.cuda.max_memory_reserved(dev) / 2 ** 30

    state = list(fresh())

    def eager():
        state[0], state[1], _ = lm_steps.train_step(
            state[0], state[1], batches[0], cfg=cfg, opt_cfg=opt_cfg,
            microbatches=2)

    eager_ms = [event_ms(eager) for _ in range(6)]
    e_rows, e_busy, _ = kernel_rows(eager)
    e_med, e_mem = statistics.median(eager_ms[1:]), gib()
    del state[:]
    step = lm_steps.compile_train_step(*fresh(), batches[0], cfg=cfg,
                                       opt_cfg=opt_cfg, microbatches=2)
    call_ms = []

    def call():
        call_ms.append(event_ms(
            lambda: step(batches[len(call_ms) % len(batches)])))

    rows, _, _ = kernel_rows(call)          # the two eager passes
    warm_mem = gib()
    if len(call_ms) != lm_steps.WARM_PASSES or step.graph is not None:
        raise CheckFailed(f"[27] {cfg.name} bf16: {len(call_ms)} calls "
                          f"before the capture")
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batches[len(call_ms)])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    call_ms.append(capture_s * 1e3)
    capture_mem = gib()
    nodes = graph_kernel_symbols(step.graph)
    seen = [rows]
    while seen[-1] < len(nodes) and len(seen) < 4:
        # A window short of the graph's nodes: the profiler dropped some
        # of the pass's kernels (1 of 16,546 on the card). Another eager
        # pass of the same body (a real step) is read, as phase 28 does.
        seen.append(kernel_rows(step._warm_pass)[0])
    rows = seen[-1]
    if len(nodes) != rows:
        raise CheckFailed(f"[27] {cfg.name} bf16: {len(nodes)} kernel nodes "
                          f"against the eager passes' {seen} rows")
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(5):
        call()
    replay_ms = call_ms[-5:]
    r_rows, r_busy, r_top = kernel_rows(call)
    r_med, r_mem = statistics.median(replay_ms), gib()
    tokens = 8 * 128
    flops = 6 * cfg.param_count() * tokens
    print(f"[27] {cfg.name} bf16, batch 8 x 128, 2 microbatches: eager "
          f"train_step {e_med:.1f} ms (events, median of steps 2-6: "
          f"{[round(v, 1) for v in eager_ms]}), device busy {e_busy:.1f} ms "
          f"in {e_rows} kernel rows, host share "
          f"{100 * (1 - e_busy / e_med):.1f}%, max_memory_reserved "
          f"{e_mem:.2f} GiB; the compiled step: eager passes "
          f"{call_ms[0]:.1f} and (profiled) {call_ms[1]:.1f} ms, "
          f"{rows} kernel rows, {warm_mem:.2f} GiB; the "
          f"capture and its first replay {capture_s:.2f} s, "
          f"{len(nodes)} kernel nodes, {capture_mem:.2f} GiB; a replay "
          f"{r_med:.1f} ms (events, median of "
          f"{[round(v, 1) for v in replay_ms]}), device busy {r_busy:.1f} "
          f"ms in {r_rows} kernel rows, host share "
          f"{100 * (1 - r_busy / r_med):.1f}%, {tokens / r_med * 1e3:.0f} "
          f"tokens/s, model {flops / r_med / 1e9:.2f} TFLOP/s = "
          f"{100 * flops / r_med * 1e3 / PEAK_BF16_FLOPS:.2f}% of the bf16 "
          f"dense peak, {r_mem:.2f} GiB; replay / eager "
          f"{r_med / e_med:.3f}; most: {r_top}")
    del step
    gc.collect()
    torch.cuda.empty_cache()


def phase_27_training(dev) -> None:
    """27. LM training on the card, through the compiled train step
    (``compile_train_step``: two eager passes, one CUDA-graph capture,
    then replays): (a) full-width h2o-danube-1.8b (24 layers, d 2560;
    bf16 params, f32 moments) through ``launch.train.main`` with
    ``examples/train_lm.py``'s settings (batch 8, seq 128, two
    microbatches, no checkpoint in the window): finite losses and grad
    norms; then the compiled step alone, 8 steps on one repeated batch
    (the overfit check of ``test_lm_train_loss_decreases``: batch 4, seq
    64, two microbatches, no warm-up; lr 1e-4, since 3e-3 diverges at full
    width): the loss falls by at least 0.5; (b) the compiled step against
    the eager ``train_step`` (``train_graph_check``) in f32: h2o at 2
    layers, full width, batch 2 x 64; full-width mamba2-370m, batch 2 x
    64; reduced deepseek-v2-236b (MLA, MoE), batch 4 x 32; (c) the timing
    of full-width bf16 h2o (``train_step_timing``); (d) full-width
    mamba2-370m, the resume flow of ``test_train_driver_with_resume``
    (``--steps 6 --ckpt-every 5``, then ``--steps 8 --resume``, in a
    temporary directory) with a failure injected at data step 6 of the
    second run, after the capture: rc 0, ``resumed from step 5``, the
    restored (params, OptState) bit-equal to the saved one, and both
    restores (the resume, before the first step, and the recovery, into
    the captured graph's buffers) read leaf by leaf from the host into
    the compiled step bit for bit, its graph kept; (e) one f32 train step
    of h2o-danube-1.8b at 2 layers, full width, on the card against the
    same step on the CPU: the loss and every updated leaf within rtol
    1e-4 of each leaf's max|.|."""
    import dataclasses
    import functools
    import gc
    import math

    import torch

    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import fault
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch import train as lm_train
    from repro_torch.models import model as lm
    from repro_torch.models.scan_util import tree_leaves, tree_map
    from repro_torch.optim.adamw import init_opt_state
    t27 = time.perf_counter()
    gc.collect()
    before = torch.cuda.memory_reserved(dev) / 2 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"[27] memory reserved {before:.2f} GiB after phases 1-26, "
          f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} GiB after "
          f"empty_cache")

    # (a) full-width h2o-danube-1.8b: the driver, then the overfit check.
    cfg = get_config("h2o-danube-1.8b")
    with tempfile.TemporaryDirectory() as tmp:
        rc, out, logged = run_train(
            ["--arch", cfg.name, "--steps", "4", "--batch", "8", "--seq",
             "128", "--microbatches", "2", "--ckpt-every", "1000",
             "--ckpt-dir", tmp, "--log-every", "1", "--device", str(dev)])
    if rc != 0 or [row[0] for row in logged] != [0, 1, 2, 3] or not all(
            math.isfinite(v) for row in logged for v in row[1:3]):
        raise CheckFailed(f"[27] {cfg.name} driver: rc {rc}, logged "
                          f"{logged}\n{out[-2000:]}")
    n_params = cfg.param_count()
    for step, loss, gnorm, lr, dt in logged:
        print(f"[27] {cfg.name} launch.train (batch 8, seq 128, 2 "
              f"microbatches; the compiled step: "
              f"{'eager pass' if step < lm_steps.WARM_PASSES else 'capture and replay' if step == lm_steps.WARM_PASSES else 'replay'}"
              f") step {step}: loss {loss:.4f} gnorm {gnorm:.3f} lr "
              f"{lr:.2e} dt {dt:.2f} s")
    print(f"[27] {cfg.name} driver: {out.splitlines()[-1]}; "
          f"{memory_line(dev)}")
    gc.collect()
    torch.cuda.empty_cache()

    # lr 1e-4, not the reduced test's 3e-3: AdamW moves every weight by
    # about lr a step, and a d-wide layer sums d such moves, so 3e-3 at
    # d 2560 (40x the reduced test's 64) drove the loss from 204 to 601
    # in three steps on an H100.
    opt_cfg = dataclasses.replace(lm_steps.make_opt_config(
        cfg, total_steps=30), warmup_steps=0, lr=1e-4)
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    batch = make_batch(DataConfig(seed=0, global_batch=4, seq_len=64), cfg,
                       step=0, device=dev)
    step_fn = lm_steps.compile_train_step(
        params, init_opt_state(params, opt_cfg), batch, cfg=cfg,
        opt_cfg=opt_cfg, microbatches=2)
    del params
    losses, step_s = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step_fn(batch)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    if step_fn.graph is None or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - 0.5:
        raise CheckFailed(f"[27] {cfg.name} overfit: losses {losses} "
                          f"(graph {step_fn.graph}); expected the last "
                          f"below the first - 0.5")
    tokens = 4 * 64
    med = statistics.median(step_s[lm_steps.WARM_PASSES + 1:])
    print(f"[27] {cfg.name} the compiled step x8 on one batch (batch 4, seq "
          f"64, 2 microbatches, lr 1e-4, no warm-up): losses "
          f"{[round(v, 4) for v in losses]} (fell by "
          f"{losses[0] - losses[-1]:.4f}); a replayed step "
          f"{med * 1e3:.1f} ms (median of steps 4-8; eager passes "
          f"{step_s[0] * 1e3:.1f}, {step_s[1] * 1e3:.1f}, capture and "
          f"replay {step_s[2] * 1e3:.1f}), {tokens / med:.0f} tokens/s, "
          f"model {6 * n_params * tokens / med / 1e12:.2f} TFLOP/s = "
          f"{100 * 6 * n_params * tokens / med / PEAK_BF16_FLOPS:.2f}% of "
          f"the bf16 dense peak")
    del step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[27] (a) took {time.perf_counter() - t27:.1f} s")

    # (b) the compiled step against the eager one, f32.
    for ccfg, bsz, seq in (
            (dataclasses.replace(cfg, dtype="float32", n_layers=2), 2, 64),
            (dataclasses.replace(get_config("mamba2-370m"),
                                 dtype="float32"), 2, 64),
            (dataclasses.replace(get_config("deepseek-v2-236b",
                                            reduced=True),
                                 dtype="float32"), 4, 32)):
        t0 = time.perf_counter()
        line = train_graph_check(dev, ccfg, bsz, seq, microbatches=2)
        print(f"{line}; {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the eager and the replayed step at full width.
    t0 = time.perf_counter()
    train_step_timing(dev)
    print(f"[27] (c) took {time.perf_counter() - t0:.1f} s")

    # (d) full-width mamba2-370m: train, checkpoint, resume, recover.
    t0 = time.perf_counter()
    mcfg = get_config("mamba2-370m")
    saved, restored, loads = [], [], []

    class Spy(ckpt_manager.CheckpointManager):
        def save(self, step, tree, extra=None):
            saved.append((step, [t.clone() for t in tree_leaves(tree)]))
            super().save(step, tree, extra)

        def restore(self, tree_like, step=None, shardings=None,
                    device="cuda"):
            # The driver restores to the host (files mapped) and its step
            # reads each leaf into its own buffer; the check copies the
            # leaves to the card once more, to compare them there.
            out = super().restore(tree_like, step, shardings, device)
            restored.append([t.to(dev) for t in tree_leaves(out[0])])
            return out

    def spy_compile(*args, **kw):
        step_obj = lm_steps.compile_train_step(*args, **kw)
        real_load = step_obj.load_state
        owned = tree_leaves((step_obj.params, step_obj.opt_state))

        def load_state(params, opt_state):
            graph = step_obj.graph
            real_load(params, opt_state)
            now = tree_leaves((step_obj.params, step_obj.opt_state))
            loads.append({
                "captured": graph is not None,
                "graph_kept": step_obj.graph is graph,
                "same_buffers": all(a is b for a, b in zip(now, owned)),
                "bit_equal": all(torch.equal(a, b.to(a.device)) for a, b
                                 in zip(now, tree_leaves(
                                     (params, opt_state))))})

        step_obj.load_state = load_state
        return step_obj

    failed = []

    def inject(step):
        if step == 6 and not failed:
            failed.append(step)
            raise RuntimeError("injected failure after the capture")

    real = (lm_train.CheckpointManager, lm_train.compile_train_step,
            lm_train.run_with_retries)
    lm_train.CheckpointManager = Spy
    lm_train.compile_train_step = spy_compile
    try:
        with tempfile.TemporaryDirectory() as tmp:
            base = ["--arch", mcfg.name, "--batch", "4", "--seq", "32",
                    "--ckpt-dir", tmp, "--ckpt-every", "5", "--log-every",
                    "5", "--device", str(dev)]
            rc1, out1, log1 = run_train(base + ["--steps", "6"])
            first_saves = [step for step, _ in saved]
            state5 = saved[-1][1] if saved else []
            saved.clear()
            lm_train.run_with_retries = functools.partial(
                fault.run_with_retries, failure_injector=inject)
            rc2, out2, log2 = run_train(base + ["--steps", "8", "--resume"])
    finally:
        (lm_train.CheckpointManager, lm_train.compile_train_step,
         lm_train.run_with_retries) = real
    if rc1 != 0 or rc2 != 0 or "resumed from step 5" not in out2 \
            or first_saves != [5] or len(restored) != 2 or failed != [6] \
            or "'restarts': 1" not in out2:
        raise CheckFailed(f"[27] {mcfg.name} resume: rc {rc1}/{rc2}, saved "
                          f"{first_saves}, restored {len(restored)}, "
                          f"failed {failed}\n{out1[-1500:]}\n{out2[-1500:]}")
    bad = [i for i, (a, b) in enumerate(zip(restored[0], state5))
           if a.dtype != b.dtype or a.device != b.device
           or not torch.equal(a, b)]
    again = [i for i, (a, b) in enumerate(zip(restored[1], saved[-1][1]))
             if not torch.equal(a, b)]
    if bad or again or len(restored[0]) != len(state5):
        raise CheckFailed(f"[27] {mcfg.name}: restored leaves {bad} / "
                          f"{again} differ from the saved ones")
    want = [{"captured": False, "graph_kept": True, "same_buffers": True,
             "bit_equal": True},
            {"captured": True, "graph_kept": True, "same_buffers": True,
             "bit_equal": True}]
    if loads != want:
        raise CheckFailed(f"[27] {mcfg.name}: the restores into the "
                          f"compiled step: {loads}; expected {want}")
    print(f"[27] {mcfg.name} ({mcfg.n_layers} layers, d_model "
          f"{mcfg.d_model}) launch.train --steps 6 --ckpt-every 5, then "
          f"--steps 8 --resume with a failure injected at data step 6 "
          f"(after the capture at step {lm_steps.WARM_PASSES}): "
          f"{out2.splitlines()[0]}; the restored params and OptState "
          f"({len(state5)} leaves) equal the saved ones bit for bit, at the "
          f"resume and at the recovery (step {saved[-1][0]}'s checkpoint); "
          f"both copied into the compiled step's own buffers bit for bit, "
          f"the second into the captured graph's, which replayed on; "
          f"logged (step, loss) {[(r[0], r[1]) for r in log1]} then "
          f"{[(r[0], r[1]) for r in log2]} (data steps from 0 again, as in "
          f"the reference); {out2.splitlines()[-1]}; "
          f"{time.perf_counter() - t0:.1f} s")
    del saved, restored, state5
    gc.collect()
    torch.cuda.empty_cache()

    # (e) one f32 step at 2 layers, full width: the card against the CPU.
    ccfg = dataclasses.replace(cfg, dtype="float32", n_layers=2)
    c_opt = lm_steps.make_opt_config(ccfg, total_steps=10)
    cpu_params = lm.init_model(ccfg, torch.Generator().manual_seed(0), "cpu")
    dcfg = DataConfig(seed=3, global_batch=2, seq_len=64)
    results = {}
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.to(where), cpu_params)
        new_p, new_s, met = lm_steps.train_step(
            p, init_opt_state(p, c_opt),
            make_batch(dcfg, ccfg, 0, device=where), cfg=ccfg,
            opt_cfg=c_opt)
        results[str(where)] = ([t.cpu() for t in tree_leaves((new_p, new_s))],
                          {k: float(v) for k, v in met.items()})
    worst = 0.0
    card, host = results[str(dev)], results["cpu"]
    for i, (a, b) in enumerate(zip(card[0], host[0])):
        if a.is_floating_point():
            scale = max(float(b.abs().max()), 1e-30)
            err = float((a - b).abs().max()) / scale
        else:
            err = 0.0 if torch.equal(a, b) else math.inf
        if err > 1e-4:
            raise CheckFailed(f"[27] f32 step, card vs CPU: leaf {i} off by "
                              f"{err:.3e} of its max")
        worst = max(worst, err)
    for k, v in card[1].items():
        ref = host[1][k]
        if abs(v - ref) > 1e-4 * max(abs(ref), 1e-30):
            raise CheckFailed(f"[27] f32 step, card vs CPU: {k} {v} vs {ref}")
    print(f"[27] {ccfg.name} at 2 layers, full width, f32, batch 2 x 64: "
          f"one train_step on the card against the CPU: loss "
          f"{card[1]['loss']:.6f} / {host[1]['loss']:.6f}"
          f", every updated param, m and v within {worst:.2e} of its leaf's "
          f"max|.| (rtol 1e-4); {memory_line(dev)}")
    print(f"[27] phase 27 took {time.perf_counter() - t27:.1f} s")


def mesh_graph_check(dev, mesh, cfg, batch: int, seq: int,
                     ref=None) -> str:
    """28 (a): the train step compiled on the smoke mesh
    (``mesh_check.compiled_check``: two eager passes, the capture and its
    replay) against three eager sharded ``train_step`` calls, in f32,
    after ``train_check`` has held one sharded step of ``cfg`` to the
    unsharded one (``ref``, run here when not given; its ``min_step``
    guards the rule). Fails unless a
    graph was captured, the owned leaves kept their placements and
    addresses, and every leaf and metric is bit-equal or, where not,
    within ``mesh_check.check_rule`` of the unsharded step's float noise
    measured here. Returns the line to print."""
    from repro_torch.launch import mesh_check
    if ref is None:
        ref = mesh_check.train_check(mesh, cfg, dev, batch=batch, seq=seq,
                                     microbatches=2)
    if ref["max_rel"] > 1e-5 or ref["loss_rel"] > 1e-5:
        raise CheckFailed(f"[28] {cfg.name}: the smoke-mesh step off the "
                          f"unsharded one: {ref}")
    r = mesh_check.compiled_check(mesh, cfg, dev, batch=batch, seq=seq)
    if not r["captured"] or not r["layout_kept"]:
        raise CheckFailed(f"[28] {cfg.name}: the compiled mesh step {r}")
    held = "bit-equal"
    if not r["bit_equal"]:
        noise = mesh_check.noise_floor(cfg, dev, batch=batch, seq=seq)
        rule = mesh_check.check_rule(noise, ref["min_step"])
        if max(r["max_rel"], r["metrics_rel"]) > rule["tol"] \
                or not rule["guarded"]:
            raise CheckFailed(
                f"[28] {cfg.name}: the compiled mesh step is off the eager "
                f"sharded one by {r['max_rel']:.3e} at {r['worst_leaf']} "
                f"(metrics {r['metrics_rel']:.3e}); the rule {rule}")
        held = (f"NOT bit-equal: within {r['max_rel']:.3e} (worst "
                f"{r['worst_leaf']}; metrics {r['metrics_rel']:.3e}), under "
                f"the rule {rule['tol']:.2e}")
    return (f"[28] {cfg.name} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}), f32, batch {batch} x {seq}, 2 microbatches, "
            f"on the smoke mesh: the sharded step against the unsharded "
            f"one within {ref['max_rel']:.3e} (the smallest step "
            f"{ref['min_step']:.2e}); {r['calls']} calls of the compiled "
            f"mesh step (2 eager passes, the capture and its replay) "
            f"against as many eager sharded train_steps: {held}; "
            f"{r['leaves']} leaves kept their placements and addresses; "
            f"{memory_line(dev)}")


def mesh_graph_timing(dev, mesh, cfg, opt_cfg, batch, eager_ms: float,
                      eager_busy: float, eager_rows: int) -> float:
    """28 (b): the full-width step compiled on the smoke mesh, from the
    same weights as the eager sharded step timed before it: two eager
    passes (the second under the profiler: its kernel rows), the capture
    (seconds) and five replays (events, median) with one replay's device
    busy and host share, ``max_memory_reserved`` over each stage, beside
    the eager sharded step's ``eager_ms`` / ``eager_busy``. Fails unless
    the graph's kernel nodes equal an eager pass's kernel rows: a window
    that comes back short of them is read again on up to three more
    eager passes of the body, one that holds more fails at once. Returns
    the replay's median ms."""
    import gc
    import math

    import torch

    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import activation_policy, policy_from_mesh
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models import model as lm
    from repro_torch.optim.adamw import init_opt_state

    def gib():
        return torch.cuda.max_memory_reserved(dev) / 2 ** 30

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    opt_state = init_opt_state(params, opt_cfg)
    state = sharding.distribute(
        (params, opt_state), (sharding.params_shardings(params, mesh),
                              sharding.params_shardings(opt_state, mesh)))
    del params, opt_state
    feed = sharding.distribute(batch, sharding.batch_shardings(batch, mesh))
    with activation_policy(policy_from_mesh(mesh)):
        step = lm_steps.compile_train_step(*state, feed, cfg=cfg,
                                           opt_cfg=opt_cfg, microbatches=2)
    del state
    call_ms = []

    def call():
        call_ms.append(event_ms(lambda: step(feed)))

    rows, _, _ = kernel_rows(call)          # the two eager passes
    warm_mem = gib()
    if len(call_ms) != lm_steps.WARM_PASSES or step.graph is not None:
        raise CheckFailed(f"[28] {cfg.name}: {len(call_ms)} calls of the "
                          f"compiled mesh step before the capture")
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(feed)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_mem = gib()
    nodes = graph_kernel_symbols(step.graph)
    seen = [rows]
    while seen[-1] < len(nodes) and len(seen) < 4:
        # A window short of the graph's nodes: the profiler dropped some
        # of a 2-3 s DTensor pass's kernels (8 of 16,546 on the card).
        # Another eager pass of the same body (a real step) is read.
        seen.append(kernel_rows(step._warm_pass)[0])
    rows = seen[-1]
    if len(nodes) != rows:
        raise CheckFailed(f"[28] {cfg.name}: the compiled mesh step's graph "
                          f"holds {len(nodes)} kernel nodes, its eager "
                          f"passes ran {seen} kernel rows")
    torch.cuda.reset_peak_memory_stats(dev)
    replay_ms = [event_ms(lambda: step(feed)) for _ in range(5)]
    r_rows, r_busy, r_top = kernel_rows(lambda: step(feed))
    r_med, r_mem = statistics.median(replay_ms), gib()
    loss = float(step(feed)["loss"])
    if not math.isfinite(loss):
        raise CheckFailed(f"[28] {cfg.name}: the replayed loss is {loss}")
    print(f"[28] {cfg.name} train step compiled on the smoke mesh (batch "
          f"8 x 128, 2 microbatches, bf16): eager passes "
          f"{call_ms[0]:.1f} and (profiled) {call_ms[1]:.1f} ms, {rows} "
          f"kernel rows, {warm_mem:.2f} GiB; the capture and its first "
          f"replay {capture_s:.2f} s, {len(nodes)} kernel nodes = the eager "
          f"pass's rows (windows read: {seen}), {capture_mem:.2f} GiB; a "
          f"replay {r_med:.1f} ms "
          f"(events, median of {[round(v, 1) for v in replay_ms]}), device "
          f"busy {r_busy:.1f} ms in {r_rows} kernel rows, host share "
          f"{100 * (1 - r_busy / r_med):.1f}%, {r_mem:.2f} GiB over the "
          f"replays; against the eager sharded step {eager_ms:.1f} ms "
          f"(device busy {eager_busy:.1f} ms in {eager_rows} rows, host "
          f"share {100 * (1 - eager_busy / eager_ms):.1f}%): replay / eager "
          f"{r_med / eager_ms:.3f}, busy {r_busy / eager_busy:.3f}; loss "
          f"{loss:.4f}; most: {r_top}")
    del step, feed
    gc.collect()
    torch.cuda.empty_cache()
    return r_med


# The resumed full-width h2o-danube-1.8b driver's peak: the compiled
# step's own state and one replay's working set (a replay holds 47.40-
# 50.07 GiB), with the restore read into the owned leaves leaf by leaf.
RESUME_PEAK_GIB = 54.0

DRYRUN_CELLS = (("deepseek-v2-236b", "train_4k", "pod"),
                ("llama4-maverick-400b-a17b", "decode_32k", "multipod"),
                ("zamba2-2.7b", "long_500k", "pod"))
ROOFLINE_CELL = ("qwen2.5-14b", "train_4k")


def phase_28_lm_mesh(dev) -> None:
    """28. The LM mesh on the card (see the module docstring)."""
    import dataclasses
    import gc
    import math
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import activation_policy, policy_from_mesh
    from repro_torch.launch import mesh_check
    from repro_torch.launch import steps as lm_steps
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as lm
    from repro_torch.optim.adamw import init_opt_state
    t28 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    # (c) the dry runs are CPU work in processes of their own, started
    # once (b)'s steps are timed (they would share the host's cores with
    # them) and joined last.
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    try:
        # (a) the smoke mesh against the unsharded step, 2 layers, f32.
        mesh = make_smoke_mesh(dev)
        print(f"[28] make_smoke_mesh(): {mesh} on backend "
              f"{dist.get_backend()}, world {dist.get_world_size()}")
        ccfg = mesh_check.check_config("h2o-danube-1.8b", layers=2)
        r = mesh_check.train_check(mesh, ccfg, dev, batch=2, seq=64,
                                   microbatches=2)
        if r["loss_rel"] > 1e-5 or r["max_rel"] > 1e-5:
            raise CheckFailed(f"[28] smoke-mesh train step off the "
                              f"unsharded one: {r}")
        if r["min_step"] <= 2e-5:
            raise CheckFailed(f"[28] the checked step moves a param leaf by "
                              f"{r['min_step']:.3e} of its scale: too little "
                              f"for the 1e-5 check to see a missing update")
        print(f"[28] {ccfg.name} at {ccfg.n_layers} layers, d_model "
              f"{ccfg.d_model}, f32, batch 2 x 64, 2 microbatches: the "
              f"smoke-mesh train_step against the unsharded one on the same "
              f"weights and batch: loss {r['loss']:.6f} / "
              f"{r['ref_loss']:.6f}, {r['leaves']} updated leaves within "
              f"{r['max_rel']:.3e} of their max (worst {r['worst_leaf']}; "
              f"bit-equal: {r['bit_equal']}), at lr 3e-4 from step 1: the "
              f"smallest leaf's step {r['min_step']:.3e} of its scale; "
              f"attention cores run: {r['cores']}; {memory_line(dev)}")
        if not r["cores"]["heads_parallel"]:
            raise CheckFailed(f"[28] the smoke mesh's step ran no head-"
                              f"parallel attention core: {r['cores']}")
        gc.collect()
        torch.cuda.empty_cache()
        # (b) full depth: the sharded and the unsharded step, timed with
        # no other process on the host's cores.
        cfg = get_config("h2o-danube-1.8b")
        opt_cfg = lm_steps.make_opt_config(cfg, total_steps=30)
        batch = make_batch(DataConfig(seed=0, global_batch=8, seq_len=128),
                           cfg, 0, device=dev)
        step_ms, busy_of, rows_of = {}, {}, {}
        for sharded in (False, True):
            params = lm.init_model(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            opt_state = init_opt_state(params, opt_cfg)
            feed = batch
            if sharded:
                params, opt_state = sharding.distribute(
                    (params, opt_state),
                    (sharding.params_shardings(params, mesh),
                     sharding.params_shardings(opt_state, mesh)))
                feed = sharding.distribute(
                    batch, sharding.batch_shardings(batch, mesh))
            policy = policy_from_mesh(mesh) if sharded else None

            def one_step():
                with activation_policy(policy):
                    return lm_steps.train_step(
                        params, opt_state, feed, cfg=cfg, opt_cfg=opt_cfg,
                        microbatches=2)

            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one_step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            rows, busy, top = kernel_rows(one_step)
            step_ms[sharded] = statistics.median(walls[1:])
            busy_of[sharded], rows_of[sharded] = busy, rows
            print(f"[28] {cfg.name} train_step (batch 8 x 128, 2 "
                  f"microbatches) {'on the smoke mesh' if sharded else 'unsharded'}: "
                  f"{step_ms[sharded]:.1f} ms (median of steps 2-3, first "
                  f"{walls[0]:.1f}), device busy {busy:.1f} ms in {rows} "
                  f"kernel rows: host share "
                  f"{100 * (1 - busy / step_ms[sharded]):.1f}%; "
                  f"{memory_line(dev)}")
            del params, opt_state, feed
            gc.collect()
            torch.cuda.empty_cache()
        print(f"[28] sharded / unsharded step: "
              f"{step_ms[True]:.1f} / {step_ms[False]:.1f} ms = "
              f"{step_ms[True] / step_ms[False]:.2f}x")
        replay = mesh_graph_timing(dev, mesh, cfg, opt_cfg, batch,
                                   step_ms[True], busy_of[True],
                                   rows_of[True])
        print(f"[28] the replayed mesh step / the eager sharded step / the "
              f"eager unsharded step: {replay:.1f} / {step_ms[True]:.1f} / "
              f"{step_ms[False]:.1f} ms")

        procs += [(cell, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[1], "--mesh", cell[2], "--out-dir",
             str(out_dir)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
            for cell in DRYRUN_CELLS]
        procs.append((ROOFLINE_CELL, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.roofline", "--arch",
             ROOFLINE_CELL[0], "--shape", ROOFLINE_CELL[1], "--out-dir",
             str(out_dir)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)))

        # (a) the train step compiled on the smoke mesh against the eager
        # sharded step, f32: 2-layer full-width h2o, reduced deepseek-v2
        # (beside (c): nothing here reads a clock or the profiler).
        print(mesh_graph_check(dev, mesh, ccfg, 2, 64, ref=r))
        print(mesh_graph_check(dev, mesh, mesh_check.check_config(
            "deepseek-v2-236b", layers=2, reduced=True), 4, 32))
        gc.collect()
        torch.cuda.empty_cache()

        # (b) launch.train with a checkpoint and a resume (beside (c)),
        # then the same checkpoint resumed with --mesh none; each resumed
        # run's peak (read into its own buffers: never twice on the card).
        torch.cuda.reset_peak_memory_stats(dev)
        peaks = {}
        with tempfile.TemporaryDirectory() as tmp:
            base = ["--arch", cfg.name, "--batch", "8", "--seq", "128",
                    "--microbatches", "2", "--ckpt-every", "2", "--ckpt-dir",
                    tmp, "--log-every", "1", "--device", str(dev)]
            t0 = time.perf_counter()
            rc1, out1, log1 = run_train(base + ["--mesh", "smoke",
                                                "--steps", "2"])
            t1 = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            rc2, out2, log2 = run_train(base + ["--mesh", "smoke", "--steps",
                                                "3", "--resume"])
            t2 = time.perf_counter()
            peaks["smoke"] = torch.cuda.max_memory_reserved(dev) / 2 ** 30
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            rc3, out3, log3 = run_train(base + ["--mesh", "none", "--steps",
                                                "3", "--resume"])
            t3 = time.perf_counter()
            peaks["none"] = torch.cuda.max_memory_reserved(dev) / 2 ** 30
        if rc1 or rc2 or rc3 or "resumed from step 2" not in out2 \
                or "resumed from step 2" not in out3 \
                or len(log1) != 2 or len(log2) != 3 or len(log3) != 3 \
                or not all(math.isfinite(v) for row in log1 + log2 + log3
                           for v in row[1:3]):
            raise CheckFailed(f"[28] launch.train --mesh smoke / none: rc "
                              f"{rc1}/{rc2}/{rc3}, logged {log1} / {log2} / "
                              f"{log3}\n{out1[-1500:]}\n{out2[-1500:]}\n"
                              f"{out3[-1500:]}")
        print(f"[28] {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}) launch.train --mesh smoke (the step "
              f"compiled on the mesh: 2 eager passes, then the capture in "
              f"the resumed run's third step) --steps 2 "
              f"--ckpt-every 2 ({t1 - t0:.1f} s with the ~18 GB "
              f"checkpoint), then --steps 3 --resume ({t2 - t1:.1f} s, "
              f"read from the host into the step's shards): "
              f"{out2.splitlines()[0]}; (step, loss, dt s) "
              f"{[(r[0], r[1], r[4]) for r in log1]} then "
              f"{[(r[0], r[1], r[4]) for r in log2]}; "
              f"{out2.splitlines()[-1]}")
        print(f"[28] {cfg.name} resumed launch.train peaks "
              f"(max_memory_reserved over the run): --mesh smoke "
              f"{peaks['smoke']:.2f} GiB, --mesh none {peaks['none']:.2f} GiB "
              f"({t3 - t2:.1f} s; the limit {RESUME_PEAK_GIB} GiB); steps "
              f"{[(r[0], r[1]) for r in log3]}")
        if max(peaks.values()) > RESUME_PEAK_GIB:
            raise CheckFailed(f"[28] a resumed launch.train peaked at "
                              f"{peaks} GiB, over {RESUME_PEAK_GIB}")
        gc.collect()
        torch.cuda.empty_cache()

        dcfg = dataclasses.replace(cfg, dtype="float32")
        d = mesh_check.decode_check(mesh, dcfg, dev, batch=4, max_len=64,
                                    steps=1)
        if d["logits"]["max_rel"] > 1e-5 or d["cache"]["max_rel"] > 1e-5:
            raise CheckFailed(f"[28] smoke-mesh decode off the unsharded "
                              f"step: {d}")
        print(f"[28] {cfg.name} full depth, f32, batch 4, cache 64: one "
              f"decode step on the smoke mesh (cache_shardings) against the "
              f"unsharded eager step: logits within "
              f"{d['logits']['max_rel']:.3e} of their max (bit-equal: "
              f"{d['logits']['bit_equal']}), caches within "
              f"{d['cache']['max_rel']:.3e}; {memory_line(dev)}")
        gc.collect()
        torch.cuda.empty_cache()

        # (a) serve_step compiled on the smoke mesh (two eager passes, one
        # CUDA graph, a replay) against the eager sharded decode, f32:
        # 2-layer h2o with its 4096-slot window wrapping, reduced
        # deepseek-v2 (MLA, MoE), 2-layer mamba2-370m.
        for dcfg, cache, start in (
                (ccfg, 4096, 4094),
                (mesh_check.check_config("deepseek-v2-236b", layers=2,
                                         reduced=True), 256, 0),
                (mesh_check.check_config("mamba2-370m", layers=2), 64, 0)):
            t0 = time.perf_counter()
            c = mesh_check.compiled_decode_check(mesh, dcfg, dev, batch=4,
                                                 max_len=cache, start=start)
            dv = c["deviation"]
            worst = max(dv["logits"]["max_rel"], dv["cache"]["max_rel"])
            if not (c["captured"] and c["bit_equal"] and c["layout_kept"]) \
                    or worst > 1e-5:
                raise CheckFailed(f"[28] {dcfg.name}: serve_step compiled "
                                  f"on the smoke mesh: {c}")
            print(f"[28] {dcfg.name} ({dcfg.n_layers} layers, d_model "
                  f"{dcfg.d_model}, f32, batch 4, cache {cache}): serve_step "
                  f"compiled on the smoke mesh (2 eager passes, one CUDA "
                  f"graph, a replay; positions {start}..{start + 2}) "
                  f"bit-equal to the eager sharded decode, logits and "
                  f"caches; within {worst:.3e} of the unsharded decode's "
                  f"max; placements and addresses kept "
                  f"({time.perf_counter() - t0:.1f} s; {memory_line(dev)})")
            gc.collect()
            torch.cuda.empty_cache()

        # (a) prefill_step compiled on the smoke mesh (two eager passes,
        # then one CUDA graph replayed three times) against the eager
        # sharded prefill, f32: 2-layer h2o, reduced deepseek-v2 (MLA,
        # MoE), 2-layer mamba2-370m, reduced internvl2-2b (its front end).
        t_pre = time.perf_counter()
        for pcfg, pbatch, pseq in (
                (ccfg, 2, 2048),
                (mesh_check.check_config("deepseek-v2-236b", layers=2,
                                         reduced=True), 4, 256),
                (mesh_check.check_config("mamba2-370m", layers=2), 2, 2048),
                (mesh_check.check_config("internvl2-2b", layers=2,
                                         reduced=True), 4, 256)):
            t0 = time.perf_counter()
            c = mesh_check.compiled_prefill_check(mesh, pcfg, dev,
                                                  batch=pbatch, seq=pseq)
            rule = mesh_check.check_rule(mesh_check.prefill_noise(
                pcfg, dev, batch=pbatch, seq=pseq), float("inf"))
            worst = c["deviation"]["max_rel"]
            if not (c["captured"] and c["bit_equal"] and c["replicated"]
                    and c["layout_kept"]) or worst > rule["tol"]:
                raise CheckFailed(f"[28] {pcfg.name}: prefill_step compiled "
                                  f"on the smoke mesh: {c}, rule {rule}")
            print(f"[28] {pcfg.name} ({pcfg.n_layers} layers, d_model "
                  f"{pcfg.d_model}, f32, batch {pbatch} x {pseq}): "
                  f"prefill_step compiled on the smoke mesh (2 eager "
                  f"passes, one CUDA graph, {c['calls'] - 2} replays on "
                  f"fresh tokens) bit-equal to the eager sharded prefill, "
                  f"logits replicated; within {worst:.3e} of the unsharded "
                  f"prefill's max (rule {rule['tol']:.1e}); attention cores "
                  f"{c['cores']}; placements and addresses kept "
                  f"({time.perf_counter() - t0:.1f} s; {memory_line(dev)})")
            gc.collect()
            torch.cuda.empty_cache()
        print(f"[28] the four compiled prefill checks took "
              f"{time.perf_counter() - t_pre:.1f} s")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

        # (c) the dry runs and the roofline: joined whatever happened.
        outs = {}
        for cell, proc in procs:
            try:
                outs[cell] = (proc.communicate(timeout=900)[0],
                              proc.returncode)
            except subprocess.TimeoutExpired:
                proc.kill()
                outs[cell] = (proc.communicate()[0], "timeout")
    for cell, (out, rc) in outs.items():
        if rc != 0:
            raise CheckFailed(f"[28] {' '.join(cell)}: rc {rc}\n"
                              f"{out[-3000:]}")
    for arch, shape, mesh_kind in DRYRUN_CELLS:
        name = "multipod_2x16x16" if mesh_kind == "multipod" else "pod_16x16"
        r = json.loads((out_dir / f"{arch}__{shape}__{name}.json")
                       .read_text())
        mem = r["memory_analysis"]
        print(f"[28] dry run {arch} x {shape} x {name} ({r['n_devices']} "
              f"fake ranks, traced in {r['compile_s']} s"
              + (f", microbatches {r['microbatches']} from probes "
                 f"{r['microbatches_traced']}" if r["microbatches"] else "")
              + f"): params {r['param_bytes_per_device'] / 1e9:.3f} GB a "
              f"chip of 80 GB ({'resident' if r['resident_weights'] else 'FSDP'}"
              f"), arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, "
              f"temp {mem['temp_size_in_bytes'] / 1e9:.3f} GB, FLOPs "
              f"{r['flops_total']:.4g} a chip, HBM bytes "
              f"{r['bytes_accessed_total']:.4g}, collective bytes "
              f"{r['collective_bytes_total'] / 1e9:.3f} GB by op "
              f"{ {k: round(v / 1e9, 3) for k, v in r['collective_bytes_by_op'].items() if v} } "
              f"counts { {k: v for k, v in r['collective_op_counts'].items() if v} }")
    r = json.loads((out_dir / f"{ROOFLINE_CELL[0]}__{ROOFLINE_CELL[1]}.json")
                   .read_text())
    print(f"[28] roofline {ROOFLINE_CELL[0]} x {ROOFLINE_CELL[1]} (16x16, "
          f"H100 terms: 989 TFLOP/s, 3.35 TB/s, 50 GB/s): compute "
          f"{r['compute_s'] * 1e3:.2f} ms, memory {r['memory_s'] * 1e3:.2f} "
          f"ms, collective {r['collective_s'] * 1e3:.2f} ms: bound by "
          f"{r['bound']}; per unit {r['per_unit']}, base {r['base']}, "
          f"{r['n_units']} units; model FLOPs a chip "
          f"{r['model_flops_per_chip']:.4g} = {r['useful_flops_ratio']:.3f} "
          f"of the counted ({r['probe_wall_s']} s)")
    print(f"[28] phase 28 took {time.perf_counter() - t28:.1f} s")


# Phase 29: the bf16 CNN path. One bf16 ulp: rtol 2^-7, atol at most 1e-4
# of the output's max; a whole forward within the reference's bf16
# tolerance (tests/test_kernels.py:41) of the plain forward's max.
BF16_ULP = 2.0 ** -7
BF16_ATOL_SHARE = 1e-4
BF16_FORWARD_REL = 5e-2
N_BF16_REQUESTS = 13


def bf16_close(name: str, got, want) -> float:
    """Raise unless ``got`` lies within one bf16 ulp of ``want`` (rtol
    2^-7, atol 1e-4 of max|want|), both of one dtype; returns max|diff|."""
    if got.dtype != want.dtype:
        raise CheckFailed(f"{name}: dtype {got.dtype} != {want.dtype}")
    atol = BF16_ATOL_SHARE * float(want.float().abs().max())
    return check_close(name, got.float(), want.float(), BF16_ULP, atol)


def rel_dev(got, want) -> float:
    """max|got - want| / max|want|, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def offset_copy(t):
    """``t`` copied into a contiguous view one element into a larger
    buffer on its device: not 16-byte aligned, so the f32 loop copies B 4
    bytes at a time, the int8 loop takes its byte path and the bf16 loop
    its element path."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


class Bf16Counts:
    """The launch counters of a bf16 phase's kernels: ``names`` (keys of
    ``KERNEL_SYMBOLS``) for the ``kernels`` of the port in that order.
    ``read`` raises if any other kernel of the port launched: a bf16 run
    launches its bf16 kernels and none of the others."""

    def __init__(self, names, kernels):
        from repro_torch.kernels import build
        from repro_torch.kernels.conv_im2col import conv_im2col as conv_mod
        from repro_torch.kernels.gemm import gemm as gemm_mod
        from repro_torch.kernels.kn2row import kn2row as kn2_mod
        from repro_torch.kernels.winograd import winograd as wino_mod
        self.names, self.kernels = tuple(names), tuple(kernels)
        self.every = [k for mod in (gemm_mod, conv_mod, kn2_mod, wino_mod)
                      for k in vars(mod).values()
                      if isinstance(k, build.CudaKernel)]

    def reset(self) -> None:
        for kern in self.every:
            kern.launches = 0

    def read(self) -> tuple:
        others = {k.symbol: k.launches for k in self.every
                  if k not in self.kernels and k.launches}
        if others:
            raise CheckFailed(f"a bf16 run launched other kernels {others}")
        return tuple(k.launches for k in self.kernels)


def bf16_window_rows(names, fn) -> tuple:
    """The ``names`` kernels' device rows of one call of ``fn`` under
    ``torch.profiler``, the window opened as ``opened_window`` says (after
    the LM phases the profiler dropped the first 25 kernels of a window on
    the card); one whose opener came back with no row is taken again, up
    to three in all."""
    import re

    from torch.autograd import DeviceType
    for _ in range(3):
        _, averages = opened_window(fn)
        if averages is not None:
            break
    else:
        raise CheckFailed("three profiled windows lost every row of their "
                          "opener")
    rows = Counter()
    for e in averages:
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if re.search(rf"\b{KERNEL_SYMBOLS[name]}\b", e.key):
                    rows[name] += e.count
    return tuple(rows[k] for k in names)


def bf16_graph_nodes(names, run, params, x) -> tuple:
    """The ``names`` kernels' nodes in a capture of the walk ``run``
    captures (``graph_kernel_nodes``)."""
    import torch

    from repro_torch.cnn.executor import _eval_graph
    static_in = x.clone()
    cuda_graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.inference_mode(), torch.cuda.graph(cuda_graph):
        _eval_graph(run.graph, run.lowering, params, static_in, None)
    rows = graph_kernel_nodes(cuda_graph)
    del cuda_graph
    torch.cuda.empty_cache()
    return tuple(rows.get(k, 0) for k in names)


def check_bf16_forwards(phase: int, tag: str, g, plan, p16, p32, res: int,
                        lc: Bf16Counts, derived, expect, limit: float,
                        randn, dev) -> dict:
    """A bf16 model (``p16``) at every bucket, elided and not: the
    lowering's launches (``derived(lowering)``, in ``lc.names`` order) must
    be ``expect[elide]``; the eager pass, the capture and a replay read
    them, them and 0 on the counters, their outputs are bit-equal, and the
    captured graph's kernel nodes and one replay's profiler rows equal
    them (a window short of them, the profiler's dropped rows, is taken
    again, up to three in all); the logits lie within ``limit`` of the
    plain path's largest logit and of the f32 forward's of the same
    weights widened (``p32``). Returns ({(elide, bucket): (run_k, run_32,
    x)}, the launches the counters read over every eager pass and
    capture, in ``lc.names`` order)."""
    import torch

    from repro_torch.cnn.executor import compile_plan
    from repro_torch.kernels.gemm import gemm as gemm_mod
    bf, names = torch.bfloat16, lc.names
    fwd, totals = {}, [0] * len(names)
    for elide in (True, False):
        for bsz in BUCKETS:
            label = f"{tag} b{bsz} elide={elide}"
            run_k, run_p, run_32 = (
                compile_plan(g, plan, epilogue="bias_relu", tuning_batch=bsz,
                             elide=elide, dtype=dtype, use_pallas=kernels,
                             device=dev)
                for dtype, kernels in ((bf, None), (bf, False),
                                       (torch.float32, None)))
            want_n = derived(run_k.lowering)
            if want_n != expect[elide]:
                raise CheckFailed(f"{label}: the lowering gives {want_n}, "
                                  f"expected {expect[elide]} {names}")
            x = randn(bsz, res, res, 3)
            outs = []
            for stage, want_stage in (("eager", want_n), ("capture", want_n),
                                      ("replay", (0,) * len(names))):
                lc.reset()
                outs.append(run_k(p16, x))
                torch.cuda.synchronize()
                if lc.read() != want_stage:
                    raise CheckFailed(f"{label} {stage}: launches "
                                      f"{lc.read()}, expected {want_stage} "
                                      f"{names}")
                totals = [t + n for t, n in zip(totals, lc.read())]
                if stage == "eager" and elide and bsz == 1:
                    BF16_LOOPS[tag] = gemm_mod.bf16_loop_launches()
            if outs[0].dtype != bf or not all(torch.equal(o, outs[0])
                                               for o in outs[1:]):
                raise CheckFailed(f"{label}: capture or replay differs from "
                                  "the eager pass")
            # The captured graph's kernel nodes must equal the lowering's;
            # only then is a profiler window whose rows come back short of
            # them (the profiler dropped rows) taken again, up to three in
            # all, as phase 4's ``replay_rows`` does.
            nodes = bf16_graph_nodes(names, run_k, p16, x)
            if nodes != want_n:
                raise CheckFailed(f"{label}: graph nodes {nodes}, expected "
                                  f"{want_n} {names}")
            short = []
            for _ in range(3):
                replayed = bf16_window_rows(names, lambda: run_k(p16, x))
                if replayed == want_n or any(
                        r > w for r, w in zip(replayed, want_n)):
                    break
                short.append(replayed)
            if replayed != want_n:
                raise CheckFailed(f"{label}: one replay ran {replayed} "
                                  f"kernel rows, expected {want_n} {names} "
                                  f"(short windows before it {short})")
            rel = rel_dev(outs[0], run_p(p16, x))
            rel32 = rel_dev(outs[0], run_32(p32, x.float()))
            if not (rel <= limit and rel32 <= BF16_FORWARD_REL):
                raise CheckFailed(f"{label}: max|diff| / max|want| {rel:.3e} "
                                  f"vs plain (limit {limit}), {rel32:.3e} vs "
                                  f"f32 (limit {BF16_FORWARD_REL})")
            fwd[(elide, bsz)] = (run_k, run_32, x)
            print(f"[{phase}] {label}: bf16 logits {tuple(outs[0].shape)}; "
                  f"max|diff| / max|plain| {rel:.3e} (limit {limit}), vs the "
                  f"f32 forward of the weights widened {rel32:.3e} (limit "
                  f"{BF16_FORWARD_REL}); capture and replay bit-equal to "
                  f"eager; launches {dict(zip(names, want_n))} on eager and "
                  f"capture, 0 on a replay, equal to the captured graph's "
                  f"kernel nodes and a replay's profiler rows"
                  + (f" ({len(short)} short window(s) retaken, rows {short})"
                     if short else ""))
            del run_p
    return fwd, tuple(totals)


def serve_bf16(phase: int, tag: str, g, plan, p16, res: int,
               lc: Bf16Counts, per_forward, n_requests: int, seed: int,
               limit: float, dev) -> dict:
    """``CNNServingEngine(dtype=bf16)`` at depths 1 and 2, every count
    reset just before each engine is built (depth 1's is the main path's
    run): its warm-up runs each bucket's eager pass and capture, so the
    counts read two elided forwards' ``per_forward`` a bucket and do not
    move over the replayed ticks; each result lies within ``limit`` of a
    plain bf16 forward of its image. Returns {depth: launches}."""
    import numpy as np
    import torch

    from repro_torch.cnn.executor import compile_plan
    from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine
    bf, names = torch.bfloat16, lc.names
    run_p1 = compile_plan(g, plan, epilogue="bias_relu", tuning_batch=1,
                          dtype=bf, use_pallas=False, device=dev)
    rng = np.random.default_rng(seed)
    images = [rng.standard_normal((res, res, 3)).astype(np.float32)
              for _ in range(n_requests)]
    served = {}
    for depth in (1, 2):
        lc.reset()
        engine = CNNServingEngine(g, p16, plan, batch_size=8, slo_s=0.25,
                                  warmup=True, pipeline_depth=depth,
                                  dtype=bf, device=dev)
        warm = lc.read()
        per_warmup = tuple(2 * len(engine.buckets) * v for v in per_forward)
        if warm != per_warmup:
            raise CheckFailed(f"{tag} bf16 engine depth {depth}: warm-up "
                              f"launches {warm}, expected {per_warmup} "
                              f"{names}")
        for i, img in enumerate(images):
            engine.submit(CNNRequest(rid=i, image=img))
        done = engine.run_until_done()
        if lc.read() != warm or sorted(done) != list(range(len(images))):
            raise CheckFailed(f"{tag} bf16 engine depth {depth}: served "
                              f"{len(done)} of {len(images)}, launches "
                              f"{lc.read()} after {warm}")
        worst = 0.0
        for i, img in enumerate(images):
            if done[i].dtype != np.float32:
                raise CheckFailed(f"bf16 engine result of {done[i].dtype}")
            want = run_p1(p16, torch.as_tensor(img[None]).to(dev, bf))[0]
            rel = rel_dev(torch.as_tensor(done[i], device=dev), want)
            worst = max(worst, rel)
            if rel > limit:
                raise CheckFailed(f"{tag} bf16 engine depth {depth} request "
                                  f"{i}: max|diff| / max|plain| {rel:.3e}")
        served[depth] = warm
        print(f"[{phase}] {tag} bf16 engine depth {depth}: {len(images)} "
              f"requests, dispatches {engine.stats()['dispatches']}; worst "
              f"max|diff| / max|plain| per image {worst:.3e} (limit "
              f"{limit}); launches counted over the run (warm-up eager and "
              f"capture passes) {dict(zip(names, warm))}, 0 over the "
              f"replayed ticks; {memory_line(dev)}")
        del engine
    return served


def phase_29_bf16(dev) -> list:
    """29. The CNN path in bf16: (a) ptxas of each bf16 instantiation; (b)
    gemm_bf16 and conv_im2col_bf16 against their plain versions within one
    bf16 ulp, two calls bit-equal, and ``out_dtype`` both ways; (c)
    full-width GoogleNet with bf16 params at every bucket, elided and not:
    kernels against the plain path on the card, eager, capture and replay
    bit-equal, the counters, the captured graph's kernel nodes and a
    replay's profiler rows equal to the lowering's launches, and against
    the f32 forward of the same weights widened; (d)
    ``CNNServingEngine(dtype=bf16)`` at depths 1 and 2, every count reset
    just before each engine is built (depth 1's is the main path's run),
    each result against a plain bf16 forward of its image; (e) printed, not
    gated: each kernel against its bound and its library call, and the
    replayed bf16 forward per bucket beside the f32 one. Returns the two
    kernels' rows of the JSON line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.cnn.executor import init_params
    from repro_torch.cnn.models import googlenet
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels import build
    from repro_torch.kernels.common import pad_nhwc
    from repro_torch.kernels.conv_im2col import conv_im2col as conv_mod
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    from repro_torch.kernels.gemm import gemm as gemm_mod

    t29 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    bf = torch.bfloat16
    gemm_call, gemm_plain = gemm_mod.gemm_call, gemm_mod.gemm_plain
    conv_call, conv_plain = conv_mod.conv_im2col_call, conv_mod.conv_plain
    names = ("conv_im2col_bf16", "gemm_bf16")
    lc = Bf16Counts(names, (conv_mod.CONV_BF16, gemm_mod.GEMM_BF16))

    gen = torch.Generator().manual_seed(29)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    # ---- (a) ptxas of each bf16 instantiation --------------------------
    if not build.BUILD_LOG:
        build.build_all()
    for source in ("gemm", "conv_im2col"):
        for kernel, info in ptxas_report(build.BUILD_LOG.get(source, "")):
            if "bf16" in kernel:
                print(f"[29] ptxas {source}: {kernel}: {info}")

    # ---- (b) each kernel vs its plain version --------------------------
    all_tiles = ((64, 64), (64, 128), (128, 64), (128, 128))
    err, inputs = {}, {}
    for label, m, k, n, tiles in (
            ("1x1x1", 1, 1, 1, all_tiles), ("17x33x9", 17, 33, 9, all_tiles),
            ("K 70", 333, 70, 100, all_tiles),
            ("B off alignment", 49, 832, 384, all_tiles),
            ("5b/1x1 b1", 49, 832, 384, all_tiles),
            ("conv2 b8", 8 * 3136, 576, 192, ((128, 128),))):
        a = randn(m, k)
        b = randn(k, n, scale=k ** -0.5)
        bias = randn(n, scale=0.1)
        if label == "B off alignment":
            b = offset_copy(b)
        want = gemm_plain(a, b, "bias_relu", bias)
        used = sorted({gemm_mod.kernel_tile(bm, bn, m, n)
                       for bm, bn in tiles})
        for bm, bn in used:
            got = gemm_call(a, b, bm=bm, bn=bn, epilogue="bias_relu",
                            bias=bias)
            again = gemm_call(a, b, bm=bm, bn=bn, epilogue="bias_relu",
                              bias=bias)
            torch.cuda.synchronize()
            e = bf16_close(f"gemm_bf16 {label} tile ({bm},{bn})", got, want)
            err[("gemm", label)] = max(err.get(("gemm", label), 0.0), e)
            if not torch.equal(got, again):
                raise CheckFailed(f"gemm_bf16 {label} tile ({bm},{bn}): two "
                                  "calls differ")
        bf16_close(f"gemm_bf16 {label} no epilogue", gemm_call(a, b),
                   gemm_plain(a, b))
        inputs[("gemm", label)] = (a, b, bias)
        vec = n % 2 == 0 and k % 8 == 0 and b.data_ptr() % 4 == 0
        loop = ("wgmma loop" if gemm_mod.wgmma_path(a, b, n, k) else
                f"mma.sync loop, {'vector' if vec else 'element'} path")
        print(f"[29] gemm_bf16 {label} M={m} K={k} N={n} bias_relu, tiles "
              f"{used} ({loop}): max|diff| "
              f"{err[('gemm', label)]:.3e} (rtol 2^-7, atol 1e-4 of max|out| "
              f"{float(want.float().abs().max()):.3e}); two calls equal bit "
              f"for bit; no epilogue within one ulp too")
    # out_dtype, a store of the flush: gemm_bf16's f32 sum stored as f32,
    # and the f32 kernels storing bf16 (split K and not, the batched GEMM).
    a, b, bias = inputs[("gemm", "5b/1x1 b1")]
    want = gemm_plain(a, b, "bias_relu", bias, torch.float32)
    e_f32 = check_close("gemm_bf16 out_dtype=f32", gemm_call(
        a, b, epilogue="bias_relu", bias=bias, out_dtype=torch.float32),
        want, 1e-4, 1e-4 * float(want.abs().max()))
    e_out = []
    for label, (m, k, n) in (("split", (49, 832, 384)),
                             ("unsplit", (333, 70, 100))):
        a32 = randn(m, k, dtype=torch.float32)
        b32 = randn(k, n, scale=k ** -0.5, dtype=torch.float32)
        bias32 = randn(n, scale=0.1, dtype=torch.float32)
        e_out.append(bf16_close(
            f"gemm_f32 out_dtype=bf16 {label}",
            gemm_call(a32, b32, epilogue="bias_relu", bias=bias32,
                      out_dtype=bf),
            gemm_plain(a32, b32, "bias_relu", bias32, bf)))
    ab = randn(4, 100, 64, dtype=torch.float32)
    bb = randn(4, 64, 48, scale=0.125, dtype=torch.float32)
    e_out.append(bf16_close(
        "batched_gemm_f32 out_dtype=bf16",
        gemm_mod.batched_gemm_call(ab, bb, out_dtype=bf),
        gemm_mod.batched_gemm_plain(ab, bb, out_dtype=bf)))
    print(f"[29] out_dtype: gemm_bf16 to f32 max|diff| {e_f32:.3e} (rtol "
          f"1e-4); gemm_f32 split, unsplit and batched_gemm_f32 to bf16 "
          f"max|diff| {', '.join(f'{e:.3e}' for e in e_out)} (one bf16 ulp)")

    for label, xs, ws, stride, pad in (
            ("stem b8", (8, 224, 224, 3), (7, 7, 3, 64), 2, "SAME"),
            ("3x3 SAME", (2, 28, 28, 96), (3, 3, 96, 128), 1, "SAME"),
            ("VALID s2", (2, 17, 17, 64), (3, 3, 64, 96), 2, "VALID"),
            ("5x5", (2, 28, 28, 16), (5, 5, 16, 32), 1, "SAME"),
            ("Cout 30", (2, 14, 14, 32), (3, 3, 32, 30), 1, "SAME"),
            ("1x1x1", (1, 1, 1, 1), (1, 1, 1, 1), 1, "SAME")):
        x = randn(*xs)
        w = randn(*ws, scale=(ws[0] * ws[1] * ws[2]) ** -0.5)
        cbias = randn(ws[3], scale=0.1)
        want = conv_plain(x, w, stride=stride, padding=pad,
                          epilogue="bias_relu", bias=cbias)
        o1, o2 = conv_geometry(xs[1], xs[2], ws[0], ws[1], stride, pad)[:2]
        tiles = ((128, 128),) if label == "stem b8" else all_tiles
        used = sorted({gemm_mod.kernel_tile(bm, bn, xs[0] * o1 * o2, ws[3])
                       for bm, bn in tiles})
        for bm, bn in used:
            got = conv_call(x, w, stride=stride, padding=pad, bm=bm, bn=bn,
                            epilogue="bias_relu", bias=cbias)
            again = conv_call(x, w, stride=stride, padding=pad, bm=bm,
                              bn=bn, epilogue="bias_relu", bias=cbias)
            torch.cuda.synchronize()
            e = bf16_close(f"conv_im2col_bf16 {label} tile ({bm},{bn})",
                           got, want)
            err[("conv", label)] = max(err.get(("conv", label), 0.0), e)
            if not torch.equal(got, again):
                raise CheckFailed(f"conv_im2col_bf16 {label} tile ({bm},"
                                  f"{bn}): two calls differ")
        bf16_close(f"conv_im2col_bf16 {label} no epilogue",
                   conv_call(x, w, stride=stride, padding=pad),
                   conv_plain(x, w, stride=stride, padding=pad))
        inputs[("conv", label)] = (x, w, cbias, stride, pad)
        path = ("16-byte gather" if conv_mod.conv_bf16_vector_path(
            ws[2], ws[3], x.data_ptr(), w.data_ptr()) else "element")
        print(f"[29] conv_im2col_bf16 {label} x{xs} w{ws} s{stride} {pad}, "
              f"tiles {used} ({path} path): max|diff| "
              f"{err[('conv', label)]:.3e} (one bf16 ulp); two calls equal "
              f"bit for bit; no epilogue within one ulp too")

    # ---- (c) full-width GoogleNet in bf16 ------------------------------
    g = googlenet(res=224, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    if any(a.family is not AlgoFamily.IM2COL
           for a in plan.assignment.values()):
        raise CheckFailed("the GoogleNet plan is not all im2col")
    p16 = init_params(g, seed=0, device=dev, dtype=bf)
    for nid in sorted(p16):
        p16[nid]["b"].copy_(randn(*p16[nid]["b"].shape, scale=0.05))
    p32 = {nid: {k: t.float() for k, t in layer.items()}
           for nid, layer in p16.items()}

    def derived(lowering):
        """(conv_im2col_bf16, gemm_bf16) launches per forward: a conv
        whose input edge carries its Toeplitz matrix runs the GEMM."""
        n = Counter()
        for low in lowering.values():
            toeplitz = (low.in_layout is not None
                        and low.in_layout.kind == "toeplitz")
            n["gemm_bf16" if toeplitz else "conv_im2col_bf16"] += 1
        return tuple(n[k] for k in names)

    expect = {True: (1, 56), False: (57, 0)}
    fwd, _ = check_bf16_forwards(29, "googlenet 224 bf16", g, plan, p16,
                                 p32, 224, lc, derived, expect,
                                 BF16_FORWARD_REL, randn, dev)

    # ---- (d) the engine in bf16: the main path -------------------------
    served = serve_bf16(29, "googlenet", g, plan, p16, 224, lc,
                        expect[True], N_BF16_REQUESTS, 29, BF16_FORWARD_REL,
                        dev)

    # ---- (e) timings, printed ------------------------------------------
    a, b, bias = inputs[("gemm", "conv2 b8")]
    m, k = a.shape
    n = b.shape[1]

    def gemm_fn():
        return gemm_call(a, b, epilogue="bias_relu", bias=bias)

    # The kernel and the library call by events, the kernels line's clock,
    # and by queued launches (device time without host gaps): the wgmma
    # loop takes less than a call's host time here.
    g_ms, g_q = time_ms(gemm_fn), queued_ms(gemm_fn)
    g_plain = time_ms(lambda: gemm_plain(a, b, "bias_relu", bias))
    g_lib = time_ms(lambda: torch.matmul(a, b))
    g_lib_q = queued_ms(lambda: torch.matmul(a, b))
    g_bound, g_by = bound(2.0 * m * n * k, 2.0 * (m * k + k * n + n + m * n),
                          PEAK_BF16_FLOPS)
    print(f"[29] gemm_bf16 conv2 b8 M={m} K={k} N={n}: kernel {g_ms:.4f} ms "
          f"(queued {g_q:.4f}), plain {g_plain:.4f} ms, torch.matmul bf16 "
          f"{g_lib:.4f} ms (queued {g_lib_q:.4f}), bound "
          f"{g_bound:.4f} ms ({g_by}; 989 TFLOP/s bf16, 3.35 TB/s): "
          f"{100 * g_bound / g_q:.1f}% of the bound queued; {smi}")
    x, w, cbias, stride, pad = inputs[("conv", "stem b8")]
    bsz, h, w_in, c_in = x.shape
    k1, k2, _, c_out = w.shape
    o1, o2, pt, pb, pl, pr = conv_geometry(h, w_in, k1, k2, stride, pad)
    xp = pad_nhwc(x, pt, pb, pl, pr).permute(0, 3, 1, 2).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    c_ms = time_ms(lambda: conv_call(x, w, stride=stride, padding=pad,
                                     epilogue="bias_relu", bias=cbias))
    c_plain = time_ms(lambda: conv_plain(x, w, stride=stride, padding=pad,
                                         epilogue="bias_relu", bias=cbias))
    c_lib = time_ms(lambda: F.conv2d(xp, w_oihw, stride=stride))
    m = bsz * o1 * o2
    c_bound, c_by = bound(2.0 * m * c_out * k1 * k2 * c_in,
                          2.0 * (x.numel() + w.numel() + c_out + m * c_out),
                          PEAK_BF16_FLOPS)
    print(f"[29] conv_im2col_bf16 stem b8 x{tuple(x.shape)} w{tuple(w.shape)}"
          f" s2 SAME: kernel {c_ms:.4f} ms, plain {c_plain:.4f} ms, F.conv2d "
          f"bf16 (cuDNN) {c_lib:.4f} ms, bound {c_bound:.4f} ms ({c_by}): "
          f"{100 * c_bound / c_ms:.1f}% of the bound; {smi}")
    # The smallest-M GEMM of the bucket-1 forward, inception 5b's 1x1 on
    # the 7x7 map: gemm_bf16 walks K serially on 3 blocks, where gemm_f32
    # splits it 13 ways.
    a, b, bias = inputs[("gemm", "5b/1x1 b1")]
    a32, b32, bias32 = a.float(), b.float(), bias.float()
    s16 = queued_ms(lambda: gemm_call(a, b, epilogue="bias_relu", bias=bias))
    s32 = queued_ms(lambda: gemm_call(a32, b32, epilogue="bias_relu",
                                      bias=bias32))
    s_lib = queued_ms(lambda: torch.matmul(a, b))
    m, k = a.shape
    n = b.shape[1]
    s_bound, s_by = bound(2.0 * m * n * k, 2.0 * (m * k + k * n + n + m * n),
                          PEAK_BF16_FLOPS)
    print(f"[29] 5b/1x1 b1 M={m} K={k} N={n} queued: gemm_bf16 {s16:.4f} "
          f"ms, gemm_f32 (K split) {s32:.4f} ms, torch.matmul bf16 "
          f"{s_lib:.4f} ms; bf16 bound {s_bound:.5f} ms ({s_by}); {smi}")
    torch.cuda.reset_peak_memory_stats()
    for bsz in BUCKETS:
        run_k, run_32, x = fwd[(True, bsz)]
        x32 = x.float()
        for _ in range(2):                 # the f32 capture and a replay
            run_32(p32, x32)
        b16 = time_ms(lambda: run_k(p16, x), reps=10, rounds=5)
        f32 = time_ms(lambda: run_32(p32, x32), reps=10, rounds=5)
        busy16, split16, _ = device_time(lambda: run_k(p16, x))
        busy32, _, _ = device_time(lambda: run_32(p32, x32))
        print(f"[29] googlenet 224 forward b{bsz} (elide, replay): bf16 "
              f"{b16:.3f} ms, f32 {f32:.3f} ms ({f32 / b16:.2f}x); device "
              f"busy bf16 {busy16:.3f} ms = {split16} (ms), f32 "
              f"{busy32:.3f} ms; {memory_line(dev)}; {smi}")
    del fwd
    torch.cuda.empty_cache()
    print(f"[29] phase 29 took {time.perf_counter() - t29:.1f} s")
    return [{"name": "conv_im2col_bf16", "route": "cuda",
             "source": "src/repro_torch/csrc/conv_im2col.cu",
             "replaces": "src/repro/kernels/conv_im2col/conv_im2col.py:89",
             "launches": served[1][0],
             "max_abs_err": err[("conv", "stem b8")],
             "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound,
             "bound_by": c_by, "library_ms": c_lib},
            {"name": "gemm_bf16", "route": "cuda",
             "source": "src/repro_torch/csrc/gemm.cu",
             "replaces": "src/repro/kernels/gemm/gemm.py:117",
             "launches": served[1][1],
             "max_abs_err": err[("gemm", "conv2 b8")],
             "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
             "bound_by": g_by, "library_ms": g_lib, "queued_ms": g_q,
             "library_queued_ms": g_lib_q}]

# Phase 30: full-width VGG16 in bf16 against its plain path on the card,
# the largest logit's share. Set before the first card run from the CPU
# reading: at 56² and 112² of width 0.25 the bf16 forward moves by
# 4.0e-3 and 4.1e-3 of its largest logit when only the batched GEMM's
# sums are taken in another order (f64, rounded once), so 5x that.
VGG_BF16_PLAIN_REL = 2e-2
N_VGG_BF16_REQUESTS = 12
# Phase 30 (b): the Winograd cases, (label, batch, H, W, Cin, Cout, m,
# padding); the first two are VGG16's conv0_1 and conv2_1 at bucket 8,
# timed in (e). Then the batched GEMM's edges, (label, G, M, K, N): G 1,
# 1x1x1, N 30 (n % 8 != 0: the element path for every g), a ragged M with
# K 72 (a k16 step past K), and B one element off alignment (the element
# path).
WINO_BF16_CASES = (("conv0_1 b8", 8, 224, 224, 64, 64, 4, "SAME"),
                   ("conv2_1 b8", 8, 56, 56, 256, 256, 4, "SAME"),
                   ("F2 SAME 13x11", 2, 13, 11, 24, 40, 2, "SAME"),
                   ("F4 SAME 13x11", 2, 13, 11, 24, 40, 4, "SAME"),
                   ("F2 VALID 14x14", 2, 14, 14, 16, 30, 2, "VALID"),
                   ("F4 VALID 9x10", 2, 9, 10, 8, 16, 4, "VALID"))
BG_BF16_EDGES = (("G 1", 1, 200, 96, 64), ("1x1x1", 3, 1, 1, 1),
                 ("N 30", 4, 70, 40, 30), ("ragged M", 16, 333, 72, 104),
                 ("B offset", 4, 100, 64, 64))


def phase_30_bf16_winograd(dev) -> list:
    """30. The Winograd path in bf16: (a) ptxas of each new instantiation;
    (b) ``batched_gemm_bf16`` and the three bf16 transforms against their
    plain versions within one bf16 ulp, two calls bit-equal, at VGG16's
    bucket-8 shapes (conv0_1 8x224²x64 -> 36x25088x64, conv2_1 8x56²x256)
    and at the edges (F(2,3) and F(4,3), SAME on an odd map, VALID, bias
    and none, ReLU and none; the GEMM at G 1, 1x1x1, N 30 and unaligned B
    on the element path, a ragged M and K on every tile); (c) full-width
    VGG16 with bf16 params at every bucket, elided (the tiles transform)
    and not (the NHWC transform): kernels against the plain path, eager,
    capture and replay bit-equal, the counters, the graph's kernel nodes
    and a replay's profiler rows equal to the lowering's launches, and
    against the f32 forward of the same weights widened; (d)
    ``CNNServingEngine(dtype=bf16)`` at depths 1 and 2; (e) printed, not
    gated: each kernel against its bound, plain version and library call,
    and the replayed bf16 forward per bucket beside the f32 one. The main
    path is (c) and (d)'s depth-1 engine, every count reset just before
    each of their runs. Returns the four kernels' rows of the JSON line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.cnn.executor import init_params
    from repro_torch.cnn.models import vgg16
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.layouts import LayoutSpec
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_im2col import conv_im2col as conv_mod
    from repro_torch.kernels.gemm import gemm as gemm_mod
    from repro_torch.kernels.layouts import materialize
    from repro_torch.kernels.winograd import winograd as wino

    t30 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    bf = torch.bfloat16
    bg_call, bg_plain = gemm_mod.batched_gemm_call, gemm_mod.batched_gemm_plain
    gen = torch.Generator().manual_seed(30)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    # ---- (a) ptxas of each new instantiation ---------------------------
    if not build.BUILD_LOG:
        build.build_all()
    for source in ("gemm", "winograd"):
        for kernel, info in ptxas_report(build.BUILD_LOG.get(source, "")):
            if "bf16" in kernel and (source == "winograd"
                                     or kernel.startswith("batched")):
                print(f"[30] ptxas {source}: {kernel}: {info}")

    # ---- (b) each kernel vs its plain version --------------------------
    err, inputs = {}, {}

    def held(name, label, call, plain):
        """Two calls of ``call`` bit-equal and within one bf16 ulp of
        ``plain()``; keeps the largest max|diff| of (name, label)."""
        got, again = call(), call()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise CheckFailed(f"{name} {label}: two calls differ")
        e = bf16_close(f"{name} {label}", got, plain())
        err[(name, label)] = max(err.get((name, label), 0.0), e)
        return got

    epilogues = (("bias_relu", True), ("bias", True), ("relu", False),
                 ("none", False))
    for label, bsz, h, w_in, c_in, c_out, m, pad in WINO_BF16_CASES:
        t = m + 2
        o1, o2 = (h, w_in) if pad == "SAME" else (h - 2, w_in - 2)
        p = 1 if pad == "SAME" else 0
        geo = dict(m=m, tiles_y=-(-o1 // m), tiles_x=-(-o2 // m))
        x = randn(bsz, h, w_in, c_in)
        w = randn(3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5)
        bias = randn(c_out, scale=0.1)
        v = held("input_transform_bf16", label,
                 lambda: wino.input_transform_call(x, pad_top=p, pad_left=p,
                                                   **geo),
                 lambda: wino.input_transform_plain(x, pad_top=p,
                                                    pad_left=p, **geo))
        spec = LayoutSpec("winograd", h=h, w=w_in, c=c_in, k1=3, k2=3,
                          padding=pad, m=m, r=3)
        tiles = materialize(x, spec).reshape(-1, t, t, c_in).contiguous()
        vt = held("input_transform_tiles_bf16", label,
                  lambda: wino.input_transform_tiles_call(tiles, m=m),
                  lambda: wino.input_transform_tiles_plain(tiles, m=m))
        bf16_close(f"input_transform_tiles_bf16 {label} vs the NHWC V", vt,
                   v)
        u = wino.transform_kernel_weights(w, m, 3).to(bf)
        mm = held("batched_gemm_bf16", label, lambda: bg_call(v, u),
                  lambda: bg_plain(v, u))
        vgg = label.startswith("conv")
        for epilogue, biased in (epilogues[:1] if vgg else epilogues):
            out_geo = dict(geo, o1=o1, o2=o2, epilogue=epilogue,
                           bias=bias if biased else None)
            held("output_transform_bf16", label,
                 lambda: wino.output_transform_call(mm, **out_geo),
                 lambda: wino.output_transform_plain(mm, **out_geo))
        inputs[label] = (x, tiles, v, u, mm, bias, geo, o1, o2)
        print(f"[30] winograd F({m},3) bf16 {label} x({bsz}, {h}, {w_in}, "
              f"{c_in}) {pad} Cout {c_out}: max|diff| vs plain "
              + ", ".join(f"{k} {err[(k, label)]:.3e}" for k in (
                  "input_transform_bf16", "input_transform_tiles_bf16",
                  "batched_gemm_bf16", "output_transform_bf16"))
              + f" (one bf16 ulp; output epilogues "
              f"{[e for e, _ in (epilogues[:1] if vgg else epilogues)]}); "
              f"two calls bit-equal; the tiles' V within one ulp of the "
              f"NHWC V")

    # The batched GEMM at its edges (BG_BF16_EDGES), bias_relu and no
    # epilogue on every tile the wrapper takes.
    all_tiles = ((64, 64), (64, 128), (128, 64), (128, 128))
    for label, g_, m, k, n in BG_BF16_EDGES:
        a = randn(g_, m, k)
        b = randn(g_, k, n, scale=k ** -0.5)
        bias = randn(n, scale=0.1)
        if label == "B offset":
            b = offset_copy(b)
        used = sorted({gemm_mod.kernel_tile(bm, bn, m, n)
                       for bm, bn in all_tiles})
        for bm, bn in used:
            held("batched_gemm_bf16", label,
                 lambda: bg_call(a, b, bm=bm, bn=bn, epilogue="bias_relu",
                                 bias=bias),
                 lambda: bg_plain(a, b, "bias_relu", bias))
            held("batched_gemm_bf16", label,
                 lambda: bg_call(a, b, bm=bm, bn=bn),
                 lambda: bg_plain(a, b))
        vec = (k % 8 == 0 and n % 8 == 0 and a.data_ptr() % 16 == 0
               and b.data_ptr() % 4 == 0)
        loop = ("wgmma loop" if gemm_mod.wgmma_path(a, b, n, k) else
                f"mma.sync loop, {'vector' if vec else 'element'} path")
        print(f"[30] batched_gemm_bf16 {label} G={g_} M={m} K={k} N={n}, "
              f"tiles {used} ({loop}), "
              f"bias_relu and none: max|diff| "
              f"{err[('batched_gemm_bf16', label)]:.3e} (one bf16 ulp); "
              f"two calls bit-equal")

    # ---- (c) full-width VGG16 in bf16 ----------------------------------
    g = vgg16(res=224, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    algos = sorted(plan.assignment[n.id].key for n in g.conv_nodes())
    if algos != ["im2col"] * 8 + ["winograd(F4x3)"] * 5:
        raise CheckFailed(f"the VGG16 plan is not 8 im2col + 5 F(4,3): "
                          f"{algos}")
    p16 = init_params(g, seed=1, device=dev, dtype=bf)
    for nid in sorted(p16):
        p16[nid]["b"].copy_(randn(*p16[nid]["b"].shape, scale=0.05))
    p32 = {nid: {k: t.float() for k, t in layer.items()}
           for nid, layer in p16.items()}
    names = ("conv_im2col_bf16", "gemm_bf16", "input_transform_bf16",
             "input_transform_tiles_bf16", "batched_gemm_bf16",
             "output_transform_bf16")
    lc = Bf16Counts(names, (conv_mod.CONV_BF16, gemm_mod.GEMM_BF16,
                            wino.INPUT_TRANSFORM_BF16,
                            wino.INPUT_TRANSFORM_TILES_BF16,
                            gemm_mod.BATCHED_GEMM_BF16,
                            wino.OUTPUT_TRANSFORM_BF16))

    def derived(lowering):
        """Launches per forward: an im2col layer runs the conv on NHWC or
        the GEMM on its Toeplitz matrix; a Winograd layer the NHWC or the
        stored-tile transform, the batched GEMM and the output
        transform."""
        n = Counter()
        for low in lowering.values():
            kind = "nhwc" if low.in_layout is None else low.in_layout.kind
            if low.algo.family is AlgoFamily.WINOGRAD:
                n["input_transform_tiles_bf16" if kind == "winograd"
                  else "input_transform_bf16"] += 1
                n["batched_gemm_bf16"] += 1
                n["output_transform_bf16"] += 1
            else:
                n["gemm_bf16" if kind == "toeplitz"
                  else "conv_im2col_bf16"] += 1
        return tuple(n[k] for k in names)

    expect = {True: (1, 7, 0, 5, 5, 5), False: (8, 0, 5, 0, 5, 5)}
    fwd, forward_launches = check_bf16_forwards(
        30, "vgg16 224 bf16", g, plan, p16, p32, 224, lc, derived, expect,
        VGG_BF16_PLAIN_REL, randn, dev)
    for key in [k for k in fwd if not k[0]]:
        del fwd[key]
    torch.cuda.empty_cache()

    # ---- (d) the engine in bf16 ----------------------------------------
    served = serve_bf16(30, "vgg16", g, plan, p16, 224, lc, expect[True],
                        N_VGG_BF16_REQUESTS, 30, VGG_BF16_PLAIN_REL, dev)
    main_path = dict(zip(names, (f + e for f, e in zip(forward_launches,
                                                       served[1]))))
    if not all(main_path[k] for k in names[2:]):
        raise CheckFailed(f"a Winograd kernel did not launch on the main "
                          f"path: {main_path}")
    print(f"[30] main path (the forwards' eager and capture passes, elided "
          f"and not, and the depth-1 engine's warm-up): launches "
          f"{main_path}")

    # ---- (e) timings, printed ------------------------------------------
    rows = {}
    for label in ("conv0_1 b8", "conv2_1 b8"):
        x, tiles, v, u, mm, bias, geo, o1, o2 = inputs[label]
        bsz, _, _, c_in = x.shape
        g_, n_tiles, c_out = mm.shape
        m = geo["m"]
        t = m + 2
        out_geo = dict(geo, o1=o1, o2=o2, epilogue="bias_relu", bias=bias)
        bt, _, at = (a.to(bf) for a in wino.torch_matrices(m, 3, dev))
        filt = torch.einsum("ti,uj->tuij", bt, bt).reshape(
            t * t, 1, t, t).repeat(c_in, 1, 1, 1)
        x_nchw = x.permute(0, 3, 1, 2)
        mm4 = mm.reshape(t, t, n_tiles, c_out)
        out_bytes = 2.0 * bsz * o1 * o2 * c_out
        cases = {
            "input_transform_bf16": (
                lambda: wino.input_transform_call(x, pad_top=1, pad_left=1,
                                                  **geo),
                lambda: wino.input_transform_plain(x, pad_top=1, pad_left=1,
                                                   **geo),
                lambda: F.conv2d(x_nchw, filt, stride=m, padding=1,
                                 groups=c_in),
                bound(n_tiles * c_in * TRANSFORM_FLOPS[("in", m)],
                      2.0 * (x.numel() + v.numel()))),
            "input_transform_tiles_bf16": (
                lambda: wino.input_transform_tiles_call(tiles, m=m),
                lambda: wino.input_transform_tiles_plain(tiles, m=m),
                lambda: torch.einsum("ti,nijc,uj->tunc", bt, tiles, bt),
                bound(n_tiles * c_in * TRANSFORM_FLOPS[("in", m)],
                      2.0 * (tiles.numel() + v.numel()))),
            "batched_gemm_bf16": (
                lambda: bg_call(v, u), lambda: bg_plain(v, u),
                lambda: torch.bmm(v, u),
                bound(2.0 * g_ * n_tiles * c_in * c_out,
                      2.0 * (v.numel() + u.numel() + mm.numel()),
                      PEAK_BF16_FLOPS)),
            "output_transform_bf16": (
                lambda: wino.output_transform_call(mm, **out_geo),
                lambda: wino.output_transform_plain(mm, **out_geo),
                lambda: torch.relu(torch.einsum("ai,ijnc,bj->nabc", at, mm4,
                                                at) + bias),
                bound(n_tiles * c_out * TRANSFORM_FLOPS[("out", m)],
                      2.0 * (mm.numel() + c_out) + out_bytes)),
        }
        libs = {"input_transform_bf16": "F.conv2d depthwise bf16 (cuDNN)",
                "input_transform_tiles_bf16": "torch.einsum bf16",
                "batched_gemm_bf16": "torch.bmm bf16 (cuBLAS)",
                "output_transform_bf16": "torch.einsum + bias + ReLU bf16"}
        for name, (kern, plain, lib, (b_ms, b_by)) in cases.items():
            k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain), time_ms(lib)
            extra = {}
            if name == "batched_gemm_bf16":
                # Also by queued launches: the wgmma loop takes less than
                # a call's host time at conv2_1.
                extra = {"queued_ms": queued_ms(kern),
                         "library_queued_ms": queued_ms(lib)}
            rows[(name, label)] = (k_ms, p_ms, l_ms, b_ms, b_by, extra)
            queued = ("" if not extra else
                      f" (queued {extra['queued_ms']:.4f} ms, library "
                      f"{extra['library_queued_ms']:.4f} ms)")
            print(f"[30] {name} {label}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, {libs[name]} {l_ms:.4f} ms{queued}, bound "
                  f"{b_ms:.4f} ms ({b_by}): {100 * b_ms / k_ms:.1f}% of the "
                  f"bound; {smi}")
    for bsz in BUCKETS:
        run_k, run_32, x = fwd[(True, bsz)]
        x32 = x.float()
        for _ in range(2):                 # the f32 capture and a replay
            run_32(p32, x32)
        b16 = time_ms(lambda: run_k(p16, x), reps=10, rounds=5)
        f32 = time_ms(lambda: run_32(p32, x32), reps=10, rounds=5)
        busy16, split16, _ = device_time(lambda: run_k(p16, x))
        busy32, _, _ = device_time(lambda: run_32(p32, x32))
        print(f"[30] vgg16 224 forward b{bsz} (elide, replay): bf16 "
              f"{b16:.3f} ms, f32 {f32:.3f} ms ({f32 / b16:.2f}x); device "
              f"busy bf16 {busy16:.3f} ms = {split16} (ms), f32 "
              f"{busy32:.3f} ms; {memory_line(dev)}; {smi}")
    del fwd
    torch.cuda.empty_cache()
    print(f"[30] phase 30 took {time.perf_counter() - t30:.1f} s")
    replaces = {
        "input_transform_bf16": "src/repro/kernels/winograd/winograd.py:111",
        "input_transform_tiles_bf16":
            "src/repro/kernels/winograd/winograd.py:141",
        "batched_gemm_bf16": "src/repro/kernels/gemm/gemm.py:175",
        "output_transform_bf16": "src/repro/kernels/winograd/winograd.py:192"}
    out = []
    for name, where in replaces.items():
        k_ms, p_ms, l_ms, b_ms, b_by, extra = rows[(name, "conv0_1 b8")]
        out.append({"name": name, "route": "cuda",
                    "source": ("src/repro_torch/csrc/gemm.cu"
                               if name.startswith("batched")
                               else "src/repro_torch/csrc/winograd.cu"),
                    "replaces": where, "launches": main_path[name],
                    "max_abs_err": err[(name, "conv0_1 b8")],
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": l_ms, **extra})
    return out


# Phase 31: the kn2row path in bf16. Full-width Inception-v4 in bf16
# against its plain path on the card, the largest logit's share (the
# bound of phases 29 and 30); its gated twin (f32 logits) the same.
IV4_BF16_PLAIN_REL = 2e-2
N_IV4_BF16_REQUESTS = 11
N_IV4_GATED_REQUESTS = 5
# Phase 31 (b): the kn2row cases, (label, x (B, H, W, Cin), K1, K2,
# stride, padding, Cout). First Inception-v4's kn2row layers at bucket 8
# (KN2ROW_LAYERS: stem/c4, stem/c5, redA/b2, redA/b3a and the Inception-C
# 1x3 and 3x1), bias_relu; then the edges under all four epilogues on
# every tile the wrapper takes: a ragged M, Cout 30 (phase 1's element
# path, phase 2's one-channel path), x, w and p one element off their
# alignment (the element and one-channel paths), the generic 5x5 and 7x1
# offsets and SAME at stride 2 on an odd map.
KN2ROW_BF16_MAIN = ("stem/c4", "stem/c5", "redA/b2", "redA/b3a", "incC/b3b",
                    "incC/b3c")
KN2ROW_BF16_EDGES = (("ragged M", (1, 13, 11, 64), 3, 3, 1, "SAME", 64),
                     ("Cout 30", (2, 9, 9, 32), 3, 3, 1, "SAME", 30),
                     ("offset views", (2, 9, 9, 32), 3, 3, 1, "SAME", 64),
                     ("5x5", (2, 17, 17, 32), 5, 5, 1, "SAME", 64),
                     ("7x1", (2, 17, 17, 32), 7, 1, 1, "SAME", 48),
                     ("s2 SAME odd", (2, 15, 15, 32), 3, 3, 2, "SAME", 64))


def phase_31_bf16_kn2row(dev) -> list:
    """31. The kn2row path in bf16: (a) ptxas of each new instantiation;
    (b) ``unit_conv_gemms_bf16`` and ``pad_accumulate_bf16`` against their
    plain versions within one bf16 ulp, two calls bit-equal, at
    Inception-v4's bucket-8 kn2row shapes and at the edges
    (``KN2ROW_BF16_EDGES``); (c) full-width Inception-v4 with bf16 params
    at every bucket, elided and not: kernels against the plain path,
    eager, capture and replay bit-equal, the counters, the graph's kernel
    nodes and a replay's profiler rows equal to the lowering's launches,
    and against the f32 forward of the same weights widened; (d) the gated
    plan of the same bf16 params (``plan_mixed_precision`` on the card):
    f32 logits held to the plain path at buckets 1 and 8, elided and not,
    eager, capture and replay bit-equal, the kernels it launched printed by
    dtype, and an engine serving it; (e) ``CNNServingEngine(dtype=bf16)``
    at depths 1 and 2; (f) printed, not gated: each kernel against its
    bound, plain version and library call, and the replayed bf16 forward
    per bucket beside the f32 one. The main path is (c) and (e)'s depth-1
    engine, every count reset just before each of their runs. Returns the
    two kernels' rows of the JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import inception_v4
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.core.quant import plan_mixed_precision
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_im2col import conv_im2col as conv_mod
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    from repro_torch.kernels.gemm import gemm as gemm_mod
    from repro_torch.kernels.kn2row import kn2row as kn2
    from repro_torch.kernels.winograd import winograd as wino
    from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine

    t31 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(31)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    # ---- (a) ptxas of each new instantiation ---------------------------
    if not build.BUILD_LOG:
        build.build_all()
    for kernel, info in ptxas_report(build.BUILD_LOG.get("kn2row", "")):
        if "bf16" in kernel:
            print(f"[31] ptxas kn2row: {kernel}: {info}")

    # ---- (b) each kernel vs its plain version --------------------------
    err, inputs = {}, {}

    def held(name, label, call, plain):
        """Two calls of ``call`` bit-equal and within one bf16 ulp of
        ``plain()``; keeps the largest max|diff| of (name, label)."""
        got, again = call(), call()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise CheckFailed(f"{name} {label}: two calls differ")
        e = bf16_close(f"{name} {label}", got, plain())
        err[(name, label)] = max(err.get((name, label), 0.0), e)
        return got

    all_tiles = ((64, 64), (64, 128), (128, 64), (128, 128))
    cases = []
    for label in KN2ROW_BF16_MAIN:
        hw, k1, k2, stride, pad, c_in, c_out = KN2ROW_LAYERS[label]
        cases.append((label, (8, hw, hw, c_in), k1, k2, stride, pad, c_out))
    for case in cases + list(KN2ROW_BF16_EDGES):
        label, xs, k1, k2, stride, pad, c_out = case
        bsz, h, w_in, c_in = xs
        g_, m = k1 * k2, bsz * h * w_in
        o1, o2, pt, _, pl, _ = conv_geometry(h, w_in, k1, k2, stride, pad)
        geo = dict(k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, pad_top=pt,
                   pad_left=pl)
        x2d = randn(m, c_in)
        w = randn(g_, c_in, c_out, scale=(g_ * c_in) ** -0.5)
        bias = randn(c_out, scale=0.1)
        if label == "offset views":
            x2d, w = offset_copy(x2d), offset_copy(w)
        main = label in KN2ROW_BF16_MAIN
        tiles = sorted({gemm_mod.kernel_tile(bm, bn, m, c_out)
                        for bm, bn in ((all_tiles[-1],) if main
                                       else all_tiles)})
        for bm, bn in tiles:
            p = held("unit_conv_gemms_bf16", label,
                     lambda: kn2.unit_conv_gemms_call(x2d, w, bm=bm, bn=bn),
                     lambda: kn2.unit_conv_gemms_plain(x2d, w))
        p5 = p.view(g_, bsz, h, w_in, c_out)
        if label == "offset views":
            p5 = offset_copy(p5)
        epilogues = ("bias_relu",) if main else (
            "none", "relu", "bias", "bias_relu")
        for ep in epilogues:
            kw = dict(geo, epilogue=ep, bias=bias if ep.startswith("bias")
                      else None)
            out = held("pad_accumulate_bf16", label,
                       lambda: kn2.pad_accumulate_call(p5, **kw),
                       lambda: kn2.pad_accumulate_plain(p5, **kw))
        vec1 = (c_in % 8 == 0 and c_out % 8 == 0
                and x2d.data_ptr() % 16 == 0 and w.data_ptr() % 4 == 0)
        vec2 = kn2.accumulate_vector_path(p5, out)
        path2 = ("vector" if vec2 else "one-channel") + (
            " unrolled" if (k1, k2) in kn2.UNROLLED_OFFSETS else " generic")
        inputs[label] = (x2d, w, p5, bias, geo)
        print(f"[31] kn2row bf16 {label} x{xs} {k1}x{k2} s{stride} {pad} "
              f"Cout {c_out}: unit_conv_gemms_bf16 G={g_} M={m} K={c_in} "
              f"N={c_out} tiles {tiles} ({'vector' if vec1 else 'element'} "
              f"path) max|diff| "
              f"{err[('unit_conv_gemms_bf16', label)]:.3e}; "
              f"pad_accumulate_bf16 ({path2} path, {list(epilogues)}) "
              f"max|diff| {err[('pad_accumulate_bf16', label)]:.3e} (one "
              f"bf16 ulp); two calls bit-equal")

    # ---- (c) full-width Inception-v4 in bf16 ---------------------------
    g = inception_v4(res=299, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    mix = Counter(a.key for a in plan.assignment.values())
    if mix != {"im2col": 117, "kn2row": 16, "winograd(F4x3)": 16}:
        raise CheckFailed(f"the Inception-v4 plan is not 117 im2col + 16 "
                          f"kn2row + 16 F(4,3): {dict(mix)}")
    p16 = init_params(g, seed=2, device=dev, dtype=bf)
    for nid in sorted(p16):
        p16[nid]["b"].copy_(randn(*p16[nid]["b"].shape, scale=0.05))
    p32 = {nid: {k: t.float() for k, t in layer.items()}
           for nid, layer in p16.items()}
    names = ("conv_im2col_bf16", "gemm_bf16", "input_transform_bf16",
             "input_transform_tiles_bf16", "batched_gemm_bf16",
             "output_transform_bf16", "unit_conv_gemms_bf16",
             "pad_accumulate_bf16")
    lc = Bf16Counts(names, (conv_mod.CONV_BF16, gemm_mod.GEMM_BF16,
                            wino.INPUT_TRANSFORM_BF16,
                            wino.INPUT_TRANSFORM_TILES_BF16,
                            gemm_mod.BATCHED_GEMM_BF16,
                            wino.OUTPUT_TRANSFORM_BF16,
                            kn2.UNIT_CONV_GEMMS_BF16,
                            kn2.PAD_ACCUMULATE_BF16))

    def derived(lowering):
        """Launches per forward: an im2col layer runs the conv on NHWC or
        the GEMM on its Toeplitz matrix; a Winograd layer (3x3: one
        round) the NHWC or the stored-tile transform, the batched GEMM
        and the output transform; a kn2row layer both kn2row kernels."""
        n = Counter()
        for low in lowering.values():
            kind = "nhwc" if low.in_layout is None else low.in_layout.kind
            if low.algo.family is AlgoFamily.WINOGRAD:
                n["input_transform_tiles_bf16" if kind == "winograd"
                  else "input_transform_bf16"] += 1
                n["batched_gemm_bf16"] += 1
                n["output_transform_bf16"] += 1
            elif low.algo.family is AlgoFamily.KN2ROW:
                n["unit_conv_gemms_bf16"] += 1
                n["pad_accumulate_bf16"] += 1
            else:
                n["gemm_bf16" if kind == "toeplitz"
                  else "conv_im2col_bf16"] += 1
        return tuple(n[k] for k in names)

    expect = {True: (1, 116, 0, 16, 16, 16, 16, 16),
              False: (117, 0, 16, 0, 16, 16, 16, 16)}
    fwd, forward_launches = check_bf16_forwards(
        31, "inception_v4 299 bf16", g, plan, p16, p32, 299, lc, derived,
        expect, IV4_BF16_PLAIN_REL, randn, dev)
    for key in [k for k in fwd if not k[0]]:
        del fwd[key]
    torch.cuda.empty_cache()

    # ---- (d) the gated plan of the bf16 params -------------------------
    samples = randn(2, 299, 299, 3)
    t0 = time.perf_counter()
    report = plan_mixed_precision(g, p16, samples, tol=GATE_TOL,
                                  hw=identify_parameters(g, max_dim=512))
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    qplan, qscales = report.plan, report.act_scales
    qmix = Counter((qplan.assignment[n].key, p)
                   for n, p in qplan.precisions.items())
    if not (qmix[("im2col", "int8")] and qmix[("kn2row", "int8")]):
        raise CheckFailed(f"the gated bf16 plan lacks int8 im2col or int8 "
                          f"kn2row layers: {dict(qmix)}")
    print(f"[31] gate on inception_v4 299 bf16 params (tol {GATE_TOL}, 2 "
          f"bf16 calibration images, {gate_s:.2f} s): mix "
          + ", ".join(f"{a} {p} {c}" for (a, p), c in sorted(qmix.items()))
          + f"; demoted {len(report.demoted)}, rounds {report.rounds}")
    every = lc.every
    for elide in (True, False):
        for bsz in (1, 8):
            label = f"inception_v4 299 gated bf16 b{bsz} elide={elide}"
            run_k, run_p = (
                compile_plan(g, qplan, epilogue="bias_relu",
                             tuning_batch=bsz, elide=elide, dtype=bf,
                             act_scales=qscales, use_pallas=kernels,
                             device=dev)
                for kernels in (None, False))
            x = randn(bsz, 299, 299, 3)
            outs = []
            for stage in ("eager", "capture", "replay"):
                lc.reset()
                outs.append(run_k(p16, x))
                torch.cuda.synchronize()
                ran = {k.symbol: k.launches for k in every if k.launches}
                if stage == "eager":
                    eager_ran = ran
                elif stage == "capture" and ran != eager_ran:
                    raise CheckFailed(f"{label}: the capture launched "
                                      f"{ran}, the eager pass {eager_ran}")
                elif stage == "replay" and ran:
                    raise CheckFailed(f"{label}: a replay moved the "
                                      f"counters {ran}")
            if outs[0].dtype != torch.float32 or not all(
                    torch.equal(o, outs[0]) for o in outs[1:]):
                raise CheckFailed(f"{label}: logits of {outs[0].dtype}, or "
                                  "capture or replay differs from eager")
            int8_sfx, bf16_sfx = ("_i8", "_i32"), ("_bf16", "_bf16_mma")
            by_dtype = {
                "f32": {s: n for s, n in eager_ran.items()
                        if not s.endswith(int8_sfx + bf16_sfx)},
                "bf16": {s: n for s, n in eager_ran.items()
                         if s.endswith(bf16_sfx)},
                "int8": {s: n for s, n in eager_ran.items()
                         if s.endswith(int8_sfx)}}
            if not (by_dtype["int8"] and by_dtype["f32"]):
                raise CheckFailed(f"{label}: no int8 or no f32 kernel "
                                  f"launched: {eager_ran}")
            rel = rel_dev(outs[0], run_p(p16, x))
            if rel > IV4_BF16_PLAIN_REL:
                raise CheckFailed(f"{label}: max|diff| / max|plain| "
                                  f"{rel:.3e} > {IV4_BF16_PLAIN_REL}")
            print(f"[31] {label}: f32 logits {tuple(outs[0].shape)}; "
                  f"max|diff| / max|plain| {rel:.3e} (limit "
                  f"{IV4_BF16_PLAIN_REL}); capture and replay bit-equal to "
                  f"eager, 0 launches counted on a replay; kernels launched "
                  f"a forward by dtype: "
                  + "; ".join(f"{d} {by_dtype[d]}" for d in
                              ("f32", "bf16", "int8")))
            del run_k, run_p
    torch.cuda.empty_cache()
    run_p1 = compile_plan(g, qplan, epilogue="bias_relu", tuning_batch=1,
                          dtype=bf, act_scales=qscales, use_pallas=False,
                          device=dev)
    engine = CNNServingEngine(g, p16, qplan, batch_size=8, slo_s=0.25,
                              warmup=True, act_scales=qscales, dtype=bf,
                              device=dev)
    rng = np.random.default_rng(31)
    images = [rng.standard_normal((299, 299, 3)).astype(np.float32)
              for _ in range(N_IV4_GATED_REQUESTS)]
    for i, img in enumerate(images):
        engine.submit(CNNRequest(rid=i, image=img))
    done = engine.run_until_done()
    if sorted(done) != list(range(len(images))):
        raise CheckFailed(f"gated bf16 engine served {sorted(done)}")
    worst = 0.0
    for i, img in enumerate(images):
        want = run_p1(p16, torch.as_tensor(img[None]).to(dev, bf))[0]
        if done[i].dtype != np.float32 or want.dtype != torch.float32:
            raise CheckFailed(f"gated bf16 engine result of "
                              f"{done[i].dtype}, plain {want.dtype}")
        worst = max(worst, rel_dev(torch.as_tensor(done[i], device=dev),
                                   want))
    if worst > IV4_BF16_PLAIN_REL:
        raise CheckFailed(f"gated bf16 engine: max|diff| / max|plain| "
                          f"{worst:.3e}")
    print(f"[31] gated bf16 engine (act_scales, depth 1): "
          f"{len(images)} requests, dispatches "
          f"{engine.stats()['dispatches']}, precision "
          f"{engine.stats()['precision']}; worst max|diff| / max|plain| "
          f"per image {worst:.3e} (limit {IV4_BF16_PLAIN_REL})")
    del engine, run_p1
    torch.cuda.empty_cache()

    # ---- (e) the engine in bf16: the main path -------------------------
    served = serve_bf16(31, "inception_v4", g, plan, p16, 299, lc,
                        expect[True], N_IV4_BF16_REQUESTS, 31,
                        IV4_BF16_PLAIN_REL, dev)
    main_path = dict(zip(names, (f + e for f, e in zip(forward_launches,
                                                       served[1]))))
    if not all(main_path[k] for k in names[-2:]):
        raise CheckFailed(f"a bf16 kn2row kernel did not launch on the main "
                          f"path: {main_path}")
    print(f"[31] main path (the forwards' eager and capture passes, elided "
          f"and not, and the depth-1 engine's warm-up): launches "
          f"{main_path}")

    # ---- (f) timings, printed ------------------------------------------
    rows = {}
    for label in ("stem/c4", "incC/b3b"):
        x2d, w, p5, bias, geo = inputs[label]
        g_, bsz, hw, _, c = p5.shape
        m, c_in = x2d.shape
        kw = dict(geo, epilogue="bias", bias=bias)   # the library's function
        n_out = bsz * geo["o1"] * geo["o2"] * c
        p_nchw = p5.permute(1, 4, 0, 2, 3).reshape(bsz, c * g_, hw, hw
                                                   ).contiguous()
        onehot = torch.zeros(c, g_, geo["k1"], geo["k2"], device=dev,
                             dtype=bf)
        for gg in range(g_):
            onehot[:, gg, gg // geo["k2"], gg % geo["k2"]] = 1.0

        def grouped():
            return F.conv2d(p_nchw, onehot, bias, stride=geo["stride"],
                            padding=(geo["pad_top"], geo["pad_left"]),
                            groups=c)

        want = kn2.pad_accumulate_plain(p5, **kw).float()
        check_close(f"grouped F.conv2d bf16 pad_accumulate {label}",
                    grouped().permute(0, 2, 3, 1).float(), want, BF16_ULP,
                    BF16_FORWARD_REL * float(want.abs().max()))
        timed = {
            "unit_conv_gemms_bf16": (
                lambda: kn2.unit_conv_gemms_call(x2d, w),
                lambda: kn2.unit_conv_gemms_plain(x2d, w),
                lambda: torch.matmul(x2d, w),
                bound(2.0 * g_ * m * c_in * c,
                      2.0 * (m * c_in + g_ * c_in * c + g_ * m * c),
                      PEAK_BF16_FLOPS)),
            "pad_accumulate_bf16": (
                lambda: kn2.pad_accumulate_call(p5, **kw),
                lambda: kn2.pad_accumulate_plain(p5, **kw), grouped,
                bound(1.0 * g_ * n_out,
                      2.0 * (pad_accumulate_reads(p5, geo) + c + n_out)))}
        libs = {"unit_conv_gemms_bf16": "torch.matmul bf16 (cuBLAS)",
                "pad_accumulate_bf16": "grouped F.conv2d bf16 (cuDNN)"}
        for name, (kern, plain, lib, (b_ms, b_by)) in timed.items():
            k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain), time_ms(lib)
            q_ms = queued_ms(kern)
            rows[(name, label)] = (k_ms, p_ms, l_ms, b_ms, b_by)
            print(f"[31] {name} {label} b8: kernel {k_ms:.4f} ms (queued "
                  f"{q_ms:.4f} ms), plain {p_ms:.4f} ms, {libs[name]} "
                  f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}): "
                  f"{100 * b_ms / k_ms:.1f}% of the bound; {smi}")
    for bsz in BUCKETS:
        run_k, run_32, x = fwd[(True, bsz)]
        x32 = x.float()
        for _ in range(2):                 # the f32 capture and a replay
            run_32(p32, x32)
        b16 = time_ms(lambda: run_k(p16, x), reps=10, rounds=5)
        f32 = time_ms(lambda: run_32(p32, x32), reps=10, rounds=5)
        busy16, split16, _ = device_time(lambda: run_k(p16, x))
        busy32, _, _ = device_time(lambda: run_32(p32, x32))
        print(f"[31] inception_v4 299 forward b{bsz} (elide, replay): bf16 "
              f"{b16:.3f} ms, f32 {f32:.3f} ms ({f32 / b16:.2f}x); device "
              f"busy bf16 {busy16:.3f} ms = {split16} (ms), f32 "
              f"{busy32:.3f} ms; {memory_line(dev)}; {smi}")
    del fwd
    torch.cuda.empty_cache()
    print(f"[31] phase 31 took {time.perf_counter() - t31:.1f} s")
    tpu = "src/repro/kernels/kn2row/kn2row.py"
    replaces = {"unit_conv_gemms_bf16": f"{tpu}:66",
                "pad_accumulate_bf16": f"{tpu}:154"}
    out = []
    for name, where in replaces.items():
        k_ms, p_ms, l_ms, b_ms, b_by = rows[(name, "stem/c4")]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/csrc/kn2row.cu",
                    "replaces": where, "launches": main_path[name],
                    "max_abs_err": err[(name, "stem/c4")],
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": l_ms})
    return out


# Phase 32: the two bf16 GEMMs redesigned for Hopper. Each wrapper picks its
# loop by shape and alignment (``gemm.wgmma_path``): the TMA / wgmma loop
# (``csrc/tile_wgmma_bf16.cuh``, entry points gemm_bf16 and
# batched_gemm_bf16) or the mma.sync loop (the ``_mma`` entry points). The
# cases, (label, M, K, N, B offset): GoogleNet's 5b/1x1 at bucket 1 (3
# blocks: K split) and conv2 at bucket 8, a ragged M, N and K (K 200: a
# chunk past K), a K of 8, a deep K on one block (64 slices), then the
# mma.sync loop, K never split: 1x1x1, K 830 (k % 8: the element path), B
# one element off alignment.
HOPPER_GEMM_CASES = (("5b/1x1 b1", 49, 832, 384, False),
                     ("conv2 b8", 25088, 576, 192, False),
                     ("ragged", 333, 200, 104, False),
                     ("K 8", 70, 8, 16, False),
                     ("deep K", 64, 4096, 64, False),
                     ("1x1x1", 1, 1, 1, False),
                     ("K 830", 49, 830, 384, False),
                     ("B offset", 49, 832, 384, True))
# (label, G, M, K, N, B offset): VGG16's conv0_1 and conv2_1 at bucket 8,
# G 1, a ragged M, N and K, then the mma.sync loop: N 30 and B off
# alignment.
HOPPER_BATCHED_CASES = (("conv0_1 b8", 36, 25088, 64, 64, False),
                        ("conv2_1 b8", 36, 1568, 256, 256, False),
                        ("G 1", 1, 200, 96, 64, False),
                        ("ragged", 16, 333, 72, 104, False),
                        ("N 30", 4, 70, 40, 30, False),
                        ("B offset", 4, 100, 64, 64, True))
# ptxas registers of the kernels that keep the mma.sync loop, by tile (64,
# 64), (64, 128), (128, 64), (128, 128), as built before the GEMMs moved to
# the wgmma loop: the redesign must leave them unchanged.
KEPT_BF16_REGISTERS = {"conv_im2col_bf16_kernel": (64, 98, 80, 128),
                       "unit_conv_gemms_bf16_kernel": (58, 89, 80, 128)}
# The main path's launches per forward of each bf16 model (elided), per
# entry point: all on the wgmma loop.
BF16_MAIN_LOOPS = {"googlenet 224 bf16": {"gemm_bf16": 56},
                   "vgg16 224 bf16": {"gemm_bf16": 7,
                                      "batched_gemm_bf16": 5},
                   "inception_v4 299 bf16": {"gemm_bf16": 116,
                                             "batched_gemm_bf16": 16}}
# {model tag: {entry point: launches}} of one elided bucket-1 eager
# forward, recorded by phases 29-31 (check_bf16_forwards).
BF16_LOOPS = {}


def phase_32_bf16_gemm_hopper(dev) -> None:
    """32. gemm_bf16 and batched_gemm_bf16 redesigned for Hopper: (a) the
    ptxas registers and spills of every bf16 instantiation of gemm.cu,
    conv_im2col.cu and kn2row.cu, no spill in the GEMMs and the kept
    mma.sync kernels' registers unchanged (``KEPT_BF16_REGISTERS``); (b)
    both kernels against their plain versions within one bf16 ulp at
    ``HOPPER_GEMM_CASES`` and ``HOPPER_BATCHED_CASES`` on every tile, both
    ``out_dtype``s of the GEMM, with and without the epilogue, the loop
    and the K slices of each case printed and checked, two calls bit-equal;
    (c) a CUDA graph of one launch of each loop, split and not, replayed
    bit-equal to the eager launches; (d) the main path's launches per loop
    (``BF16_LOOPS``, when phases 29-31 ran first): every one on the wgmma
    loop."""
    import re

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.gemm import gemm as gemm_mod

    t32 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(32)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, bf)

    # ---- (a) ptxas ------------------------------------------------------
    if not build.BUILD_LOG:
        build.build_all()
    regs = {}
    for source in ("gemm", "conv_im2col", "kn2row"):
        for kernel, info in ptxas_report(build.BUILD_LOG.get(source, "")):
            if "bf16" not in kernel:
                continue
            print(f"[32] ptxas {source}: {kernel}: {info}")
            used, spill = (int(v) for v in re.findall(r"(\d+) (?:registers|B "
                                                      r"spill)", info))
            regs[kernel] = used
            if spill:
                raise CheckFailed(f"{kernel} spills: {info}")
    for name, want in KEPT_BF16_REGISTERS.items():
        got = tuple(regs.get(f"{name}<{bm}, {bn}>")
                    for bm, bn in ((64, 64), (64, 128), (128, 64),
                                   (128, 128)))
        if got != want:
            raise CheckFailed(f"{name} registers {got}, want {want}")
    print(f"[32] the mma.sync loop's other kernels keep their registers "
          f"{KEPT_BF16_REGISTERS}; no bf16 kernel spills")

    # ---- (b) each kernel vs its plain version --------------------------
    all_tiles = ((64, 64), (64, 128), (128, 64), (128, 128))
    sms = gemm_mod.sm_count(dev)
    kerns = (gemm_mod.GEMM_BF16, gemm_mod.GEMM_BF16_MMA,
             gemm_mod.BATCHED_GEMM_BF16, gemm_mod.BATCHED_GEMM_BF16_MMA)
    for label, m, k, n, off in HOPPER_GEMM_CASES:
        a, b, bias = randn(m, k), randn(k, n, scale=k ** -0.5), randn(
            n, scale=0.1)
        if off:
            b = offset_copy(b)
        wgmma = gemm_mod.wgmma_path(a, b, n, k)
        tiles = ((128, 128),) if label == "conv2 b8" else all_tiles
        used = sorted({gemm_mod.kernel_tile(bm, bn, m, n)
                       for bm, bn in tiles})
        worst, cuts = 0.0, []
        for bm, bn in used:
            splits = (gemm_mod.grid_splits(m, n, k, (bm, bn), sms,
                                           chunk=gemm_mod.BF16_WGMMA_CHUNK)
                      if wgmma else 1)
            cuts.append(splits)
            for out_dtype in (bf, torch.float32):
                want = gemm_mod.gemm_plain(a, b, "bias_relu", bias, out_dtype)
                for kern in kerns:
                    kern.launches = 0
                got, again = (gemm_mod.gemm_call(
                    a, b, bm=bm, bn=bn, epilogue="bias_relu", bias=bias,
                    out_dtype=out_dtype) for _ in range(2))
                torch.cuda.synchronize()
                ran = [kern.launches for kern in kerns]
                if ran != ([2, 0, 0, 0] if wgmma else [0, 2, 0, 0]):
                    raise CheckFailed(f"gemm_bf16 {label}: launches {ran} of "
                                      f"{[k.symbol for k in kerns]}")
                tag = f"gemm_bf16 {label} ({bm},{bn}) S{splits} {out_dtype}"
                if out_dtype == bf:
                    worst = max(worst, bf16_close(tag, got, want))
                else:                      # f32 C: the f32 sums' order
                    worst = max(worst, check_close(
                        tag, got, want, 1e-4, 1e-4 * float(want.abs().max())))
                if not torch.equal(got, again):
                    raise CheckFailed(f"{tag}: two calls differ")
            bf16_close(f"gemm_bf16 {label} ({bm},{bn}) no epilogue",
                       gemm_mod.gemm_call(a, b, bm=bm, bn=bn),
                       gemm_mod.gemm_plain(a, b))
        if label == "5b/1x1 b1" and not (wgmma and max(cuts) == 13):
            raise CheckFailed(f"5b/1x1 b1: loop wgmma={wgmma}, slices "
                              f"{cuts}; want the wgmma loop, 13 slices on "
                              "the 64-row tiles")
        print(f"[32] gemm_bf16 {label} M={m} K={k} N={n}: "
              f"{'wgmma' if wgmma else 'mma.sync'} loop, tiles {used} with "
              f"K slices {cuts}; a bf16 C within one bf16 ulp, an f32 C "
              f"within 1e-4, bias_relu and none (max|diff| {worst:.3e}); two "
              f"calls equal bit for bit")
    for label, g, m, k, n, off in HOPPER_BATCHED_CASES:
        a, b, bias = randn(g, m, k), randn(g, k, n, scale=k ** -0.5), randn(
            n, scale=0.1)
        if off:
            b = offset_copy(b)
        wgmma = gemm_mod.wgmma_path(a, b, n, k)
        tiles = ((128, 128),) if label.endswith("b8") else all_tiles
        used = sorted({gemm_mod.kernel_tile(bm, bn, m, n)
                       for bm, bn in tiles})
        want = gemm_mod.batched_gemm_plain(a, b, "bias_relu", bias)
        worst = 0.0
        for bm, bn in used:
            for kern in kerns:
                kern.launches = 0
            got, again = (gemm_mod.batched_gemm_call(
                a, b, bm=bm, bn=bn, epilogue="bias_relu", bias=bias)
                for _ in range(2))
            torch.cuda.synchronize()
            ran = [kern.launches for kern in kerns]
            if ran != ([0, 0, 2, 0] if wgmma else [0, 0, 0, 2]):
                raise CheckFailed(f"batched_gemm_bf16 {label}: launches "
                                  f"{ran} of {[k.symbol for k in kerns]}")
            tag = f"batched_gemm_bf16 {label} ({bm},{bn})"
            worst = max(worst, bf16_close(tag, got, want))
            if not torch.equal(got, again):
                raise CheckFailed(f"{tag}: two calls differ")
        bf16_close(f"batched_gemm_bf16 {label} no epilogue",
                   gemm_mod.batched_gemm_call(a, b),
                   gemm_mod.batched_gemm_plain(a, b))
        print(f"[32] batched_gemm_bf16 {label} G={g} M={m} K={k} N={n}: "
              f"{'wgmma' if wgmma else 'mma.sync'} loop, tiles {used}; "
              f"within one bf16 ulp (max|diff| {worst:.3e}); two calls "
              f"equal bit for bit")

    # ---- (c) a captured replay, bit-equal to eager ---------------------
    a1, b1, bias1 = randn(49, 832), randn(832, 384, scale=832 ** -0.5), \
        randn(384, scale=0.1)
    a2, b2 = randn(333, 200), randn(200, 104, scale=200 ** -0.5)
    a3, b3 = randn(49, 830), randn(830, 384, scale=830 ** -0.5)
    ag, bg = randn(16, 333, 72), randn(16, 72, 104, scale=72 ** -0.5)

    def launches():
        return (gemm_mod.gemm_call(a1, b1, bm=64, bn=128,
                                   epilogue="bias_relu", bias=bias1),
                gemm_mod.gemm_call(a2, b2, epilogue="relu",
                                   out_dtype=torch.float32),
                gemm_mod.gemm_call(a3, b3, bm=64, bn=128),
                gemm_mod.batched_gemm_call(ag, bg, epilogue="relu"))

    eager = launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = launches()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(e, r) for e, r in zip(eager, static)):
        raise CheckFailed("a replay of the bf16 GEMMs differs from eager")
    del graph
    cut = [gemm_mod.grid_splits(m, n, k, tile, sms,
                                chunk=gemm_mod.BF16_WGMMA_CHUNK)
           for m, k, n, tile in ((49, 832, 384, (64, 128)),
                                 (333, 200, 104, (128, 128)))]
    print(f"[32] one CUDA graph of the wgmma loop in {cut[0]} slices "
          f"(bias_relu, bf16 C) and in {cut[1]} (ReLU, f32 C), the mma.sync "
          f"loop (K 830, one slice) and the batched wgmma loop: its replay "
          f"equals the eager launches bit for bit")

    # ---- (d) the main path's launches per loop -------------------------
    if BF16_LOOPS:
        for tag, want in BF16_MAIN_LOOPS.items():
            got = BF16_LOOPS.get(tag)
            if got is None:
                raise CheckFailed(f"phases 29-31 recorded no loops for {tag}")
            if {e: n for e, n in got.items() if n} != want:
                raise CheckFailed(f"{tag}: launches per loop {got}, want "
                                  f"{want} and none on the mma.sync loop")
            print(f"[32] {tag} forward b1 (elided, eager): launches per "
                  f"loop {got}: every bf16 GEMM on the wgmma loop")
    else:
        print("[32] the main path's launches per loop: phases 29-31 did not "
              "run")
    print(f"[32] phase 32 took {time.perf_counter() - t32:.1f} s")


def main() -> int:
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    kernels = phases_1_to_25()
    print(f"phases 1-25 took {time.perf_counter() - t_main:.1f} s")
    dev = torch.device("cuda")
    phase_26_decode_graph(dev)
    phase_27_training(dev)
    phase_28_lm_mesh(dev)
    kernels += phase_29_bf16(dev)
    kernels += phase_30_bf16_winograd(dev)
    kernels += phase_31_bf16_kn2row(dev)
    phase_32_bf16_gemm_hopper(dev)
    print(f"total {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
