"""CNN serving example on the PyTorch/CUDA port: GoogleNet through the
bucketed-SLO engine.

The twin of ``examples/serve_cnn.py``, on ``repro_torch``: build GoogleNet,
map it (PBQP), autotune-or-load a bucket-keyed tuning record, then push a
short burst+trickle trace through ``CNNServingEngine`` and print its
``stats()`` snapshot.

    python examples/serve_cnn_torch.py                     # the card, 224²
    python examples/serve_cnn_torch.py --device cpu --smoke

With more than one visible card (or ``--devices N``), the engine runs
mesh-sharded: each bucket's batch splits across the mesh's data axis, the
bucket ladder is built in multiples of the shard count, and tuning lookups
key off the per-chip batch — the same record works at any device count.

``--pipeline-depth 2`` turns on async tick dispatch: ``step()`` launches
and returns without blocking (one pinned staging buffer per slot, results
retired through CUDA events), and the completion loop must ``drain()``
once everything is dispatched — results may still be in flight when the
queue empties.

``--max-queue N`` bounds admission (overflow requests are rejected with a
first-class ``rejected_full`` outcome instead of growing the queue), and
``--chaos`` arms the full robustness stack: a seeded ``FaultPlan``
(transient injected device faults absorbed by the bounded retry loop),
deadline shedding, and the degrade-mode hysteresis controller. Either way
the serving loop below terminates on *outcome conservation* — every
submitted request accounted completed/rejected/shed/failed — not on every
request completing, and the ``stats()["robustness"]`` block in the report
shows the ledger.

``--precision auto`` serves the gated mixed-precision plan: the
precision-aware PBQP maps each layer int8-or-bf16 jointly with its
algorithm, a calibration batch fixes per-tensor activation scales, and the
accuracy gate demotes layers whose isolated int8 error exceeds the
tolerance back to bf16 before compiling. ``--precision int8`` keeps the
cost model's picks with the gate disarmed; the default ``bf16`` is the
classic plan. The spot check compares against the eager walk of the
*same* plan, so it stays tight at any precision.

``--models N`` (N >= 2) switches to multi-tenant serving: N copies of the
architecture with independent params register in one ``MultiModelEngine``
— tenant 2..N recompile nothing (shared executable cache) — and the same
burst+trickle trace replays per tenant through the joint deadline-ordered
scheduler. Per-tenant conservation and a per-tenant reference spot check
gate the run. ``--chaos`` and ``--pipeline-depth`` are single-model-only
knobs.

It runs on the card (``--device cuda``) at full width (224², scale 1.0)
by default; ``--smoke`` is the reference's smoke configuration (res 28,
scale 0.1, 12 requests, no tuning). A failed check exits nonzero.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

# The whole-plan tolerance of the spot checks.
SPOT_TOL = dict(rtol=2e-2, atol=2e-3)


def build_record(g, plan, path, buckets, device):
    """Autotune-or-load: records are keyed by (conv signature, bucket), so
    a record saved at one graph size transfers to any graph sharing layer
    shapes — and re-tuning is incremental if you pass it back in."""
    from repro_torch.core.autotune import TuningRecord, autotune_buckets

    if path and Path(path).exists():
        record = TuningRecord.load(path)
        print(f"loaded tuning record: {path} ({len(record.entries)} entries)")
        return record
    t0 = time.time()
    record = autotune_buckets(g, plan, buckets=buckets,
                              backends=("lax", "reference"), reps=1,
                              device=device)
    print(f"autotuned {len(record.entries)} (signature, bucket) pairs "
          f"in {time.time() - t0:.0f}s")
    if path:
        record.save(path)
        print(f"saved tuning record: {path}")
    return record


def _spot_check(name, got, want) -> bool:
    """Print ``got``'s max deviation from the eager ``want``; True when
    it is inside ``SPOT_TOL``."""
    want = want.cpu().numpy()
    err = float(np.max(np.abs(got - want)))
    print(f"{name} vs eager reference: max|delta| = {err:.2e}")
    return bool(np.allclose(got, want, **SPOT_TOL))


def _conserved(name, eng) -> None:
    rb = eng.stats()["robustness"]
    if sum(rb["outcomes"].values()) + rb["pending"] != eng.submitted_total:
        raise SystemExit(f"{name}: request accounting failed to conserve")


def serve_multi(args, g, plan, record, mesh, device) -> None:
    """N tenants, one engine: replay the burst+trickle trace per tenant
    through the joint scheduler, then gate per-tenant conservation and a
    per-tenant eager-reference spot check."""
    from repro_torch.cnn.executor import forward, init_params
    from repro_torch.serving.cnn_engine import CNNRequest
    from repro_torch.serving.multi_engine import MultiModelEngine

    names = [f"model_{chr(ord('a') + i)}" for i in range(args.models)]
    multi = MultiModelEngine()
    tenant_params = {}
    for i, name in enumerate(names):
        tenant_params[name] = init_params(g, seed=i, device=device)
        kw = {"max_queue": args.max_queue} if args.max_queue else {}
        multi.register_model(name, g, tenant_params[name], plan,
                             slo_s=args.slo_ms / 1e3, tuning=record,
                             batch_size=args.batch, mesh=mesh,
                             warmup=True, device=device, **kw)
    cs = multi.cache.stats()
    print(f"registered {len(names)} tenants, shared cache: "
          f"{cs['entries']} executables, {cs['hits']} hits "
          f"({cs['hits']} compiles avoided)")

    shape = tuple(g.nodes[g.source()].attrs["out_shape"])
    rng = np.random.default_rng(0)
    per = max(4, args.requests // args.models)
    imgs = {name: rng.standard_normal((per,) + shape).astype(np.float32)
            for name in names}
    n_burst = max(1, (2 * per) // 3)
    for name in names:
        for i in range(n_burst):
            multi.submit(name, CNNRequest(rid=i, image=imgs[name][i]))
    rid = n_burst

    def accounted() -> int:
        return sum(len(e.done) + len(e.failed) + len(e.shed_rids)
                   + e.rejected_total for e in multi.engines.values())

    while accounted() < per * len(names):
        if multi.step() == 0:
            if rid < per:                          # trickle one per tenant
                for name in names:
                    multi.submit(name, CNNRequest(rid=rid,
                                                  image=imgs[name][rid]))
                rid += 1
            elif multi.queued_total():             # waiting on SLO budget
                at = multi.next_dispatch_at()
                time.sleep(max(0.0, min(0.05, (at or 0) - time.monotonic())))
                multi.step(flush=True)
            else:
                multi.drain()

    # Shared programs must serve each tenant under its OWN weights.
    for name in names:
        want = forward(g, tenant_params[name], imgs[name][0], plan=plan,
                       epilogue="bias_relu", device=device)
        if not _spot_check(f"{name} request 0",
                           multi.engines[name].done[0], want):
            raise SystemExit(f"{name}: engine output diverged from reference")
        _conserved(name, multi.engines[name])
    print(json.dumps(multi.stats(), indent=2, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine serves (cuda, or cpu at a "
                         "reduced size such as --smoke)")
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--slo-ms", type=float, default=250.0)
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: all visible devices)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="async tick pipeline depth (1 = synchronous)")
    ap.add_argument("--record", type=str, default=None,
                    help="tuning-record JSON: loaded if it exists, else "
                         "autotuned and saved there")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: reject submits once this "
                         "many requests are queued")
    ap.add_argument("--chaos", action="store_true",
                    help="arm the robustness stack: seeded fault "
                         "injection + bounded retries, deadline "
                         "shedding, degrade mode")
    ap.add_argument("--precision", choices=("auto", "int8", "bf16"),
                    default="bf16",
                    help="auto: precision-aware PBQP + accuracy gate "
                         "(plan_mixed_precision); int8: precision-aware "
                         "PBQP with the gate disarmed; bf16: the classic "
                         "all-bf16 plan (default)")
    ap.add_argument("--models", type=int, default=1,
                    help="N >= 2 serves N tenants of the architecture "
                         "(independent params) through one "
                         "MultiModelEngine with a shared executable "
                         "cache and joint deadline-ordered ticks")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (res 28, scale 0.1, no tuning)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.res, args.scale, args.requests = 28, 0.1, 12
    if args.models > 1 and (args.chaos or args.pipeline_depth != 1
                            or args.precision != "bf16"):
        raise SystemExit("--models is incompatible with --chaos / "
                         "--pipeline-depth / --precision "
                         "(single-model knobs)")

    from repro_torch.cnn.executor import forward, init_params
    from repro_torch.cnn.models import googlenet
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine

    dev = resolve_device(args.device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_dev = args.devices or visible
    g = googlenet(res=args.res, scale=args.scale)
    print(f"googlenet res={args.res} scale={args.scale}: "
          f"{len(g.conv_nodes())} conv layers, serving on {n_dev} device(s)")
    hw = identify_parameters(g, max_dim=512)
    params = init_params(g, seed=0, device=dev)
    act_scales = None
    if args.precision == "bf16":
        plan = map_network(g, hw=hw)
    else:
        # Quantized serving: solve the precision-aware PBQP on a small
        # calibration batch. "auto" arms the accuracy gate (layers whose
        # isolated int8 error exceeds tol demote to bf16); "int8" keeps
        # whatever the cost model picked.
        from repro_torch.core.quant import calibrate_act_scales, \
            plan_mixed_precision
        shape0 = tuple(g.nodes[g.source()].attrs["out_shape"])
        calib = torch.randn((2,) + shape0,
                            generator=torch.Generator().manual_seed(7)).to(dev)
        if args.precision == "auto":
            rep = plan_mixed_precision(g, params, calib, tol=0.012, hw=hw)
            plan, act_scales = rep.plan, rep.act_scales
            print(f"precision gate: {rep.precision_mix}, "
                  f"demoted {rep.demoted} (tol {rep.tol})")
        else:
            plan = map_network(g, hw=hw, quantize=True)
            act_scales = calibrate_act_scales(g, params, calib)
            n8 = sum(1 for p in plan.precisions.values() if p == "int8")
            print(f"precision forced int8: {n8}/{len(plan.precisions)} "
                  f"layers int8 (gate disarmed)")
    record = None if args.smoke else \
        build_record(g, plan, args.record, buckets=(1, 2), device=dev)

    mesh = make_data_mesh(n_dev, device=dev) if n_dev > 1 else None
    if args.models > 1:
        serve_multi(args, g, plan, record, mesh, dev)
        return 0
    robustness = {}
    if args.max_queue is not None:
        robustness["max_queue"] = args.max_queue
    if args.chaos:
        from repro_torch.distributed.fault import FaultPlan
        from repro_torch.serving.cnn_engine import DegradeConfig
        # Transient faults only (the bounded retry loop absorbs every
        # one, so the reference spot check below still has results);
        # tick 0 is left clean.
        plan_f = FaultPlan.seeded(seed=1, n_ticks=2 * args.requests,
                                  fail_rate=0.2, failures=1)
        plan_f.faults.pop(0, None)
        robustness.update(shed_deadline=True, fault_plan=plan_f,
                          max_retries=2, degrade=DegradeConfig())
        print(f"chaos armed: {len(plan_f)} planned transient faults, "
              f"deadline shedding, degrade controller")
    eng = CNNServingEngine(g, params, plan, batch_size=args.batch,
                           slo_s=args.slo_ms / 1e3, tuning=record,
                           mesh=mesh, warmup=True,
                           pipeline_depth=args.pipeline_depth,
                           act_scales=act_scales, device=dev, **robustness)
    print(f"bucket ladder: {eng.buckets}"
          + (f" (per-chip {[b // eng.data_shards for b in eng.buckets]})"
             if mesh is not None else ""))

    # A short mixed trace: one burst (fills big buckets) then a trickle
    # (SLO-forced small dispatches) — real clock, so the stats below are
    # real queueing + real service time.
    shape = tuple(g.nodes[g.source()].attrs["out_shape"])
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((args.requests,) + shape).astype(np.float32)
    n_burst = max(1, (2 * args.requests) // 3)
    for i in range(n_burst):
        eng.submit(CNNRequest(rid=i, image=imgs[i]))
    rid = n_burst

    def accounted() -> int:
        # Outcome conservation is the loop invariant: with the
        # robustness knobs armed some requests end rejected/shed/failed
        # instead of completed — all four are terminal.
        return (len(eng.done) + len(eng.failed) + len(eng.shed_rids)
                + eng.rejected_total)

    while accounted() < args.requests:
        if eng.step() == 0:
            if rid < args.requests:                # trickle one more in
                eng.submit(CNNRequest(rid=rid, image=imgs[rid]))
                rid += 1
            elif eng.queue:                        # waiting on SLO budget
                at = eng.next_dispatch_at()
                time.sleep(max(0.0, min(0.05, (at or 0) - eng._clock())))
                eng.step(flush=True)
            else:            # all dispatched — retire in-flight ticks
                eng.drain()

    # Spot-check one output against the eager reference (same plan, same
    # activation scales — a quantized engine is checked against the
    # quantized eager walk, so the tolerance stays tight), then report.
    # The first request that completed: with deadline shedding armed a
    # slow host can shed the burst's head before its first tick.
    if not eng.done:
        raise SystemExit("no request completed")
    first = min(eng.done)
    want = forward(g, params, imgs[first], plan=plan, epilogue="bias_relu",
                   act_scales=act_scales, device=dev)
    ok = _spot_check(f"request {first}", eng.done[first], want)
    print(json.dumps(eng.stats(), indent=2, default=str))
    if not ok:
        raise SystemExit("engine output diverged from reference")
    _conserved("engine", eng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
