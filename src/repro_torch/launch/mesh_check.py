"""Holding the LM mesh to the unsharded step: one train step (and one
decode step) of the same weights and batch run twice, on plain tensors
and as ``DTensor``s on a mesh, and compared leaf by leaf.

``train_check`` also counts which attention core the sharded step ran
(``attention_cores``), and ``restore_check`` restores a checkpoint of
the sharded state as the train driver does (mapped on the host, each
rank copying only its shards), each rank's shard against the saved
array's slice, bit for bit.

``compiled_check`` holds the train step compiled on a mesh
(``compile_train_step`` on ``DTensor`` state: on a card two eager passes,
one CUDA graph, replays) to the eager sharded ``train_step``, call for
call; ``compiled_decode_check`` holds ``compile_serve_step`` on a mesh
to the eager sharded ``serve_step`` the same way, and to the unsharded
decode within ``check_rule`` of its own noise (``decode_noise``);
``prefill_check`` holds the sharded prefill to the unsharded one, and
``compiled_prefill_check`` holds ``compile_prefill_step`` on a mesh to
the eager sharded ``prefill_step`` call for call and to the unsharded
prefill within ``check_rule`` of its own noise (``prefill_noise``). Used
by ``tools/check_mesh.py --lm`` (1x2, 2x1 and 2x2 meshes of
cards under torchrun, or gloo processes on the CPU), by
``chip_smoke.py`` (the one-rank smoke mesh on the card, and the compiled
train step against the eager one under the same ``check_rule``) and by
the CPU tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed.api import activation_policy, policy_from_mesh
from repro_torch.distributed.sharding import (batch_shardings,
                                              cache_shardings, distribute,
                                              params_shardings)
from repro_torch.launch.steps import (WARM_PASSES, compile_prefill_step,
                                     compile_serve_step, compile_train_step,
                                     make_opt_config, prefill_step,
                                     serve_step, train_step)
from repro_torch.models.model import init_cache, init_model
from repro_torch.models.scan_util import (tree_leaves,
                                          tree_leaves_with_path, tree_map,
                                          tree_unflatten)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state


# The checked step runs at the full learning rate (``check_opt_config``:
# one warm-up step), so it moves the largest element of every param leaf
# by about lr = 3e-4: at least ~7e-5 of the leaf's scale (the embedding
# table, whose max is 3-4), 7x the 1e-5 tolerance or more. A sharded step
# that leaves a leaf unchanged, or updates it at half the rate, fails
# (``train_check`` reports the smallest such move, ``min_step``). A param
# leaf is held to its max or 1, whichever is larger (``PARAM_FLOOR``):
# AdamW's first step moves an element by lr·g/(|g| + eps), which turns
# the float noise of a gradient that sums to near zero into a large share
# of a zero-initialised leaf's (a bias's, ``conv_b``'s) tiny max. The
# check's eps is 1e-6 (the default's 1e-8 amplifies that noise by up to
# lr/eps = 3e4, which at full lr brought a reduced deepseek-v2's ``wq``
# near the tolerance). The gradients themselves are held strictly: the
# moments m and v, the gradients' statistics, to their own max.
PARAM_FLOOR = 1.0

# The rule a checked step's deviations are held to (``check_rule``): 1e-5
# of each leaf's max, or twice the unsharded step's own float noise
# measured in the same run where that is larger. On the card at full
# width the noise from kernel choice alone reached 2.25e-5 (cuBLASLt
# against cuBLAS), over 1e-5, so a fixed 1e-5 failed steps that are
# right; the noise is taken from ``noise_floor``'s probes, each exact in
# real arithmetic.
BASE_TOL = 1e-5


def check_opt_config(cfg: ModelConfig) -> AdamWConfig:
    """The checked step's optimizer: ``make_opt_config``'s at the full
    learning rate from step 1 (one warm-up step), eps 1e-6."""
    return dataclasses.replace(make_opt_config(cfg, total_steps=10),
                               warmup_steps=1, eps=1e-6)


def check_config(arch: str = "h2o-danube-1.8b", layers: int = 2,
                 reduced: bool = False, **overrides) -> ModelConfig:
    """``arch`` cut to ``layers`` (whole groups of a hybrid or
    interleaved stack) at full width (or its reduced width), in f32, with
    any other fields in ``overrides`` (``n_heads=3``: query heads that do
    not split over the model axis)."""
    cfg = get_config(arch, reduced=reduced)
    unit = cfg.attn_every or (cfg.moe_every if cfg.moe is not None else 1)
    return dataclasses.replace(cfg, dtype="float32",
                               n_layers=max(unit, layers // unit * unit),
                               **overrides)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gathered whole; any other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def deviation(got, want, floor: float = 1e-30) -> Dict:
    """Max over the leaves of two trees of max|got - want| / max(max|want|,
    ``floor``) (the leaf's max), the leaf it is at, and whether every leaf
    is bit-equal."""
    worst, at, equal = 0.0, None, True
    for (name, a), b in zip(tree_leaves_with_path(got), tree_leaves(want)):
        a = whole(a)
        equal = equal and a.dtype == b.dtype and torch.equal(a, b)
        if a.is_floating_point():
            scale = max(float(b.abs().max()), floor)
            err = float((a - b).abs().max()) / scale
        else:
            err = 0.0 if torch.equal(a, b) else float("inf")
        if err > worst:
            worst, at = err, name
    return {"max_rel": worst, "worst_leaf": at, "bit_equal": equal}


@contextlib.contextmanager
def attention_cores():
    """Counts of the attention cores the model runs meanwhile: a dict
    ``{"heads_parallel": n, "context_parallel": n}`` filled as
    ``models.attention`` calls them."""
    from repro_torch.models import attention
    counts = {"heads_parallel": 0, "context_parallel": 0}
    real = {k: getattr(attention, k) for k in counts}

    def spy(name):
        def run(*args):
            counts[name] += 1
            return real[name](*args)
        return run

    for k in counts:
        setattr(attention, k, spy(k))
    try:
        yield counts
    finally:
        for k, f in real.items():
            setattr(attention, k, f)


def train_check(mesh, cfg: ModelConfig, device, batch: int = 4,
                seq: int = 64, microbatches: int = 2,
                seed: int = 0) -> Dict:
    """One ``train_step`` on ``mesh`` against the unsharded step on the
    same weights (seed ``seed``, identical on every rank) and the same
    batch (``make_batch(mesh=)``'s, gathered whole for the unsharded
    step), at ``check_opt_config``'s learning rate. Returns the losses
    and the deviations of every updated param and optimizer leaf, each
    relative to the leaf's max; a param leaf's max is taken as at least 1
    (``PARAM_FLOOR``). ``min_step`` is the smallest move the unsharded
    step makes to a param leaf (its largest element's), on that scale:
    what a sharded step that left the leaf unchanged would be off by."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    opt_cfg = check_opt_config(cfg)
    sharded_batch = make_batch(DataConfig(seed=3, global_batch=batch,
                                          seq_len=seq), cfg, 0, mesh=mesh)
    plain_batch = {k: whole(v) for k, v in sharded_batch.items()}
    ref_p, ref_s, ref_m = train_step(
        params, init_opt_state(params, opt_cfg), plain_batch, cfg=cfg,
        opt_cfg=opt_cfg, microbatches=microbatches)
    opt_state = init_opt_state(params, opt_cfg)
    shardings = (params_shardings(params, mesh),
                 params_shardings(opt_state, mesh))
    d_p, d_s = distribute((params, opt_state), shardings)
    with activation_policy(policy_from_mesh(mesh)), \
            attention_cores() as cores:
        new_p, new_s, met = train_step(d_p, d_s, sharded_batch, cfg=cfg,
                                       opt_cfg=opt_cfg,
                                       microbatches=microbatches)
    dev_p = deviation(new_p, ref_p, PARAM_FLOOR)
    min_step = min(deviation([old], [new], PARAM_FLOOR)["max_rel"]
                   for old, new in zip(tree_leaves(params),
                                       tree_leaves(ref_p)))
    dev_s = deviation(new_s, ref_s)
    dev_leaves = max(dev_p, dev_s, key=lambda d: d["max_rel"])
    dev_leaves = dict(dev_leaves,
                      bit_equal=dev_p["bit_equal"] and dev_s["bit_equal"])
    loss, ref_loss = float(met["loss"]), float(ref_m["loss"])
    return {"loss": loss, "ref_loss": ref_loss,
            "loss_rel": abs(loss - ref_loss) / max(abs(ref_loss), 1e-30),
            "leaves": len(tree_leaves((new_p, new_s))),
            "min_step": min_step, "cores": dict(cores), **dev_leaves}


def compiled_check(mesh, cfg: ModelConfig, device, batch: int = 4,
                   seq: int = 64, microbatches: int = 2, calls: int = 3,
                   seed: int = 0) -> Dict:
    """``compile_train_step`` on ``train_check``'s sharded state (the
    same weights, ``check_opt_config``, the step made under
    ``policy_from_mesh(mesh)``) for ``calls`` calls on the batches of
    data steps 0, 1, ... (``make_batch(mesh=)``), against as many eager
    sharded ``train_step`` calls from the same state on the same batches.
    On a card the first two calls are the eager passes and the third
    captures and replays. Returns the deviations of every param and
    optimizer leaf after the last call (``deviation``: a param leaf's max
    taken as at least ``PARAM_FLOOR``) and of every call's metrics
    (relative to each metric's magnitude), whether all are bit-equal,
    whether a graph was captured, and whether the owned leaves kept
    their placements and the addresses of their local shards."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    opt_cfg = check_opt_config(cfg)
    opt_state = init_opt_state(params, opt_cfg)
    shardings = (params_shardings(params, mesh),
                 params_shardings(opt_state, mesh))
    batches = [make_batch(DataConfig(seed=3, global_batch=batch,
                                     seq_len=seq), cfg, i, mesh=mesh)
               for i in range(calls)]
    policy = policy_from_mesh(mesh)
    # The step owns its state: clones, since a DTensor of a one-rank
    # mesh may share storage with the tensor it was distributed from.
    owned = distribute(tree_unflatten((params, opt_state), [
        t.clone() for t in tree_leaves((params, opt_state))]), shardings)
    with activation_policy(policy):
        step = compile_train_step(*owned, batches[0], cfg=cfg,
                                  opt_cfg=opt_cfg, microbatches=microbatches)

    def layout():
        return [(t.placements, t.to_local().data_ptr()) for t in
                tree_leaves((step.params, step.opt_state))]

    before = layout()
    got = [{k: v.clone() for k, v in step(b).items()} for b in batches]
    kept = layout() == before
    p, s = distribute((params, opt_state), shardings)
    metric_rel, metric_equal = 0.0, True
    for b, g in zip(batches, got):
        with activation_policy(policy):
            p, s, want = train_step(p, s, b, cfg=cfg, opt_cfg=opt_cfg,
                                    microbatches=microbatches)
        metric_equal = metric_equal and set(g) == set(want) and all(
            torch.equal(g[k], want[k]) for k in want)
        metric_rel = max([metric_rel] + [
            float((g[k] - v).abs()) / max(float(v.abs()), 1e-30)
            for k, v in want.items()])
    dev_p = deviation(step.params, [whole(t) for t in tree_leaves(p)],
                      PARAM_FLOOR)
    dev_s = deviation(step.opt_state, [whole(t) for t in tree_leaves(s)])
    worst = max(dev_p, dev_s, key=lambda d: d["max_rel"])
    return {"calls": calls, "leaves": len(before),
            "max_rel": worst["max_rel"], "worst_leaf": worst["worst_leaf"],
            "metrics_rel": metric_rel,
            "bit_equal": dev_p["bit_equal"] and dev_s["bit_equal"]
            and metric_equal,
            "captured": step.graph is not None, "layout_kept": kept}


def noise_floor(cfg: ModelConfig, device, batch: int = 4, seq: int = 64,
                microbatches: int = 2, seed: int = 0) -> Dict:
    """The unsharded step's own float noise, on ``train_check``'s scale:
    ``train_check``'s unsharded step against the same step computed
    another way that is exact in real arithmetic. ``rows_reversed``: the
    rows of each microbatch in reverse order (the sums over the tokens
    taken in another order); on a card also ``cublaslt``: every matrix
    product through cuBLASLt instead of cuBLAS (other kernels, other
    reduction orders, as other shapes get on a mesh). Returns each
    probe's deviation and the largest."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    opt_cfg = check_opt_config(cfg)
    fwd = make_batch(DataConfig(seed=3, global_batch=batch, seq_len=seq),
                     cfg, 0, device=dev)
    rows = torch.arange(batch, device=dev).reshape(microbatches, -1)
    rev = {k: v[rows.flip(1).reshape(-1)] for k, v in fwd.items()}

    def step(b):
        return train_step(params, init_opt_state(params, opt_cfg), b,
                          cfg=cfg, opt_cfg=opt_cfg,
                          microbatches=microbatches)[:2]

    def dev_of(got, ref):
        return max(deviation(got[0], ref[0], PARAM_FLOOR),
                   deviation(got[1], ref[1]), key=lambda d: d["max_rel"])

    ref = step(fwd)
    probes = {"rows_reversed": dev_of(step(rev), ref)}
    if dev.type == "cuda":
        blas = torch.backends.cuda.preferred_blas_library()
        torch.backends.cuda.preferred_blas_library("cublaslt")
        try:
            probes["cublaslt"] = dev_of(step(fwd), ref)
        finally:
            torch.backends.cuda.preferred_blas_library(blas)
    worst = max(probes.values(), key=lambda d: d["max_rel"])
    return {"max_rel": worst["max_rel"], "worst_leaf": worst["worst_leaf"],
            "probes": {k: v["max_rel"] for k, v in probes.items()}}


def check_rule(noise: Dict, min_step: float) -> Dict:
    """The rule of a check in this run: ``tol`` = max(``BASE_TOL``, 2 x
    ``noise``'s largest probe, ``noise_floor``'s ``max_rel``), and
    whether it is ``guarded``: below ``min_step``, the move of the
    checked step's least-moved param leaf. A rule at or above
    ``min_step`` would pass a step that left that leaf unchanged, so the
    check then fails whatever the deviations."""
    tol = max(BASE_TOL, 2 * noise["max_rel"])
    return {"tol": tol, "noise": noise["max_rel"], "min_step": min_step,
            "guarded": tol < min_step}


def decode_check(mesh, cfg: ModelConfig, device, batch: int = 2,
                 max_len: int = 32, steps: int = 3, seed: int = 0,
                 start: int = 0) -> Dict:
    """``steps`` decode steps at positions ``start``, ``start + 1``, ...
    on ``mesh`` (params ``params_shardings``' resident placement, the
    caches ``cache_shardings``') against the unsharded eager steps: the
    logits of each and the caches after. A ``start`` past the ring's
    slots wraps it (a sliding window); the slots before ``start`` hold
    zeros on both sides."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    cache = init_cache(cfg, batch, max_len, device=dev)
    d_params = distribute(params, params_shardings(params, mesh,
                                                   fsdp=False))
    d_cache = distribute(tree_map(torch.clone, cache),
                         cache_shardings(cache, mesh))
    got, want = [], []
    with activation_policy(policy_from_mesh(mesh, seq_parallel=False)):
        for pos in range(start, start + steps):
            tokens = decode_tokens(cfg, batch, pos, dev)
            d_tok = tokens_on(mesh, tokens)
            want.append(serve_step(params, tokens, cache, pos, cfg=cfg)[0])
            got.append(serve_step(d_params, d_tok, d_cache, pos,
                                  cfg=cfg)[0])
    return {"logits": deviation(got, want), "cache": deviation(d_cache, cache)}


def decode_tokens(cfg: ModelConfig, batch: int, pos: int,
                  device) -> torch.Tensor:
    """The (B, 1) tokens of a checked decode step at ``pos``: a different
    token in each row and step."""
    return (torch.arange(batch, device=device)[:, None] * 7 + pos * 3
            + 1) % cfg.vocab


def tokens_on(mesh, tokens: torch.Tensor):
    """``tokens`` as ``batch_shardings`` places them on ``mesh``."""
    return distribute({"t": tokens}, batch_shardings({"t": tokens},
                                                     mesh))["t"]


def decode_noise(cfg: ModelConfig, device, batch: int = 4,
                 max_len: int = 64, steps: int = 3, seed: int = 0) -> Dict:
    """The unsharded decode's own float noise, on ``decode_check``'s
    scale: ``steps`` unsharded steps against the same steps with the
    batch rows reversed (``rows_reversed``; every row's arithmetic is its
    own, so this is exact in real arithmetic) and on a card through
    cuBLASLt (``cublaslt``). Returns ``noise_floor``'s keys."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)

    def run(flip: bool):
        cache = init_cache(cfg, batch, max_len, device=dev)
        out = []
        for pos in range(steps):
            tokens = decode_tokens(cfg, batch, pos, dev)
            if flip:
                tokens = tokens.flip(0)
            logits = serve_step(params, tokens, cache, pos, cfg=cfg)[0]
            out.append(logits.flip(0) if flip else logits)
        return out

    ref = run(False)
    probes = {"rows_reversed": deviation(run(True), ref)}
    if dev.type == "cuda":
        blas = torch.backends.cuda.preferred_blas_library()
        torch.backends.cuda.preferred_blas_library("cublaslt")
        try:
            probes["cublaslt"] = deviation(run(False), ref)
        finally:
            torch.backends.cuda.preferred_blas_library(blas)
    worst = max(probes.values(), key=lambda d: d["max_rel"])
    return {"max_rel": worst["max_rel"], "worst_leaf": worst["worst_leaf"],
            "probes": {k: v["max_rel"] for k, v in probes.items()}}


def compiled_decode_check(mesh, cfg: ModelConfig, device, batch: int = 4,
                          max_len: int = 64, calls: int = 3, seed: int = 0,
                          start: int = 0) -> Dict:
    """``compile_serve_step`` on ``mesh`` (the params resident, the
    caches ``cache_shardings``', a (1,) position; made under
    ``policy_from_mesh(mesh, seq_parallel=False)``) for ``calls`` calls
    at positions ``start``, ``start + 1``, ..., against as many eager
    sharded ``serve_step`` calls from the same params and caches, and
    against the unsharded eager steps. On a card the first two calls are
    the eager passes and the third captures and replays. Returns whether
    every call's logits and the caches after are bit-equal to the eager
    sharded steps' (``bit_equal``), their deviation from the unsharded
    steps' (``deviation``: ``logits`` and ``cache``), whether a graph was
    captured, and whether the owned leaves kept their placements and the
    addresses of their local shards."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    cache = init_cache(cfg, batch, max_len, device=dev)
    p_sh = params_shardings(params, mesh, fsdp=False)
    c_sh = cache_shardings(cache, mesh)
    policy = policy_from_mesh(mesh, seq_parallel=False)
    owned = distribute((params, cache), (p_sh, c_sh))    # copies
    feed = [(t, tokens_on(mesh, t)) for t in (
        decode_tokens(cfg, batch, pos, dev)
        for pos in range(start, start + calls))]
    with activation_policy(policy):
        step = compile_serve_step(*owned, feed[0][1], cfg=cfg)

    def layout():
        return [(t.placements, t.to_local().data_ptr()) for t in
                tree_leaves((step.params, step.cache))]

    before = layout()
    got = [whole(step(d_tok, pos)).clone()
           for pos, (_, d_tok) in zip(range(start, start + calls), feed)]
    kept = layout() == before
    got_cache = [whole(t).clone() for t in tree_leaves(step.cache)]
    captured = step.graph is not None
    del step, owned             # room for the eager sharded params
    d_params = distribute(params, p_sh)
    d_cache = distribute(tree_map(torch.clone, cache), c_sh)
    eager, plain = [], []
    with activation_policy(policy):
        for pos, (tok, d_tok) in zip(range(start, start + calls), feed):
            eager.append(whole(serve_step(d_params, d_tok, d_cache, pos,
                                          cfg=cfg)[0]))
            plain.append(serve_step(params, tok, cache, pos, cfg=cfg)[0])
    equal = deviation(got, eager)["bit_equal"] and deviation(
        got_cache, [whole(t) for t in tree_leaves(d_cache)])["bit_equal"]
    return {"calls": calls, "bit_equal": equal,
            "deviation": {"logits": deviation(got, plain),
                          "cache": deviation(got_cache, tree_leaves(cache))},
            "captured": captured, "layout_kept": kept}


def prefill_batches(mesh, cfg: ModelConfig, batch: int, seq: int,
                    calls: int = 1):
    """The (sharded, plain) batches of a checked prefill at data steps 0,
    1, ...: ``make_batch(mesh=)``'s ``DTensor`` tokens (and
    ``frontend_embeds`` where ``cfg`` has a front end), and the same
    gathered whole."""
    out = []
    for i in range(calls):
        b = make_batch(DataConfig(seed=5, global_batch=batch, seq_len=seq),
                       cfg, i, mesh=mesh)
        out.append((b, {k: whole(v) for k, v in b.items()}))
    return out


def replicated(t) -> bool:
    """Whether ``t`` is a ``DTensor`` whole on every mesh dim."""
    from torch.distributed.tensor import Replicate
    return hasattr(t, "placements") and all(
        isinstance(p, Replicate) for p in t.placements)


def prefill_check(mesh, cfg: ModelConfig, device, batch: int = 4,
                  seq: int = 64, seed: int = 0) -> Dict:
    """One ``prefill_step`` on ``mesh`` (the params under
    ``params_shardings``' FSDP rules, the batch ``batch_shardings``',
    under ``policy_from_mesh(mesh)``) against the unsharded prefill on
    the same weights and tokens: the logits' deviation (``deviation``),
    whether they came back replicated, and the attention cores run."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    (d_batch, plain), = prefill_batches(mesh, cfg, batch, seq)
    want = prefill_step(params, plain, cfg=cfg)
    d_params = distribute(params, params_shardings(params, mesh))
    del params
    with activation_policy(policy_from_mesh(mesh)), \
            attention_cores() as cores:
        got = prefill_step(d_params, d_batch, cfg=cfg)
    return {"logits": deviation([got], [want]),
            "replicated": replicated(got), "cores": dict(cores)}


def prefill_noise(cfg: ModelConfig, device, batch: int = 4, seq: int = 64,
                  seed: int = 0) -> Dict:
    """The unsharded prefill's own float noise, on ``prefill_check``'s
    scale: one unsharded prefill (data step 0) against the same with the
    batch rows reversed (``rows_reversed``: each row's arithmetic is its
    own, exact in real arithmetic) and on a card through cuBLASLt
    (``cublaslt``). Returns ``noise_floor``'s keys."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    feed = make_batch(DataConfig(seed=5, global_batch=batch, seq_len=seq),
                      cfg, 0, device=dev)

    def run(flip: bool):
        if flip:
            return [prefill_step(params, {k: v.flip(0) for k, v in
                                          feed.items()}, cfg=cfg).flip(0)]
        return [prefill_step(params, feed, cfg=cfg)]

    ref = run(False)
    probes = {"rows_reversed": deviation(run(True), ref)}
    if dev.type == "cuda":
        blas = torch.backends.cuda.preferred_blas_library()
        torch.backends.cuda.preferred_blas_library("cublaslt")
        try:
            probes["cublaslt"] = deviation(run(False), ref)
        finally:
            torch.backends.cuda.preferred_blas_library(blas)
    worst = max(probes.values(), key=lambda d: d["max_rel"])
    return {"max_rel": worst["max_rel"], "worst_leaf": worst["worst_leaf"],
            "probes": {k: v["max_rel"] for k, v in probes.items()}}


def compiled_prefill_check(mesh, cfg: ModelConfig, device, batch: int = 4,
                           seq: int = 64, seed: int = 0) -> Dict:
    """``compile_prefill_step`` on ``mesh`` (the params under the FSDP
    rules, static token buffers placed as ``batch_shardings`` places
    them; made under ``policy_from_mesh(mesh)``) for ``WARM_PASSES + 3``
    calls on the batches of data steps 0, 1, ... (on a card the first
    ``WARM_PASSES`` are the eager passes, the next captures and replays,
    then two more replays), each against the eager sharded
    ``prefill_step`` on the same params and batch and against the
    unsharded prefill. Returns whether every call's logits are bit-equal
    to the eager sharded ones (``bit_equal``) and came back replicated,
    their deviation from the unsharded ones (``deviation``), the
    attention cores the eager sharded prefills ran, whether a graph was
    captured, and whether the owned params kept their placements and the
    addresses of their local shards."""
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    calls = WARM_PASSES + 3
    feed = prefill_batches(mesh, cfg, batch, seq, calls)
    plain = [prefill_step(params, p, cfg=cfg) for _, p in feed]
    d_params = distribute(params, params_shardings(params, mesh))   # copies
    del params
    policy = policy_from_mesh(mesh)
    with activation_policy(policy):
        step = compile_prefill_step(d_params, feed[0][0], cfg=cfg)

    def layout():
        return [(t.placements, t.to_local().data_ptr())
                for t in tree_leaves(step.params)]

    before = layout()
    got, rep = [], True
    for b, _ in feed:
        out = step(b)
        rep = rep and replicated(out)
        got.append(whole(out).clone())
    kept = layout() == before
    captured = step.graph is not None
    eager = []
    with activation_policy(policy), attention_cores() as cores:
        for b, _ in feed:
            out = prefill_step(step.params, b, cfg=cfg)
            rep = rep and replicated(out)
            eager.append(whole(out))
    return {"calls": calls, "bit_equal": deviation(got, eager)["bit_equal"],
            "replicated": rep, "deviation": deviation(got, plain),
            "cores": dict(cores), "captured": captured, "layout_kept": kept}


def restore_check(mesh, cfg: ModelConfig, device, directory,
                  seed: int = 0) -> Dict:
    """A checkpoint of the sharded (params, optimizer state) of ``cfg``
    written to ``directory`` (every rank at the same path; rank 0 writes)
    and restored as the train driver restores it: to the host, mapped
    from the files (``restore(..., device="cpu")``), then each leaf's
    shard copied into a zeroed tree of the same placements
    (``sharding.load_shard``, what ``CompiledTrainStep.load_state`` runs).
    Holds every rank's local shard to its slice of the saved array bit
    for bit, and records every new storage an op made meanwhile:
    ``whole_made`` counts those the size of a sharded leaf whole (0: each
    rank read its shards alone)."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import load_shard, shard_slices
    dev = torch.device(device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    opt_state = init_opt_state(params, check_opt_config(cfg))
    state = distribute((params, opt_state),
                       (params_shardings(params, mesh),
                        params_shardings(opt_state, mesh)))
    mgr = CheckpointManager(Path(directory), async_write=False)
    mgr.save(1, state, extra={"step": 1})
    dist.barrier()
    leaves = tree_leaves(state)
    dst = [DTensor.from_local(torch.zeros_like(t.to_local()), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride()) for t in leaves]
    made = []

    class NewStorages(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {a.untyped_storage()._cdata for a in args
                   if isinstance(a, torch.Tensor)}
            for t in out if isinstance(out, (list, tuple)) else [out]:
                if isinstance(t, torch.Tensor) and \
                        t.untyped_storage()._cdata not in ins:
                    made.append(t.numel())
            return out

    meta = tree_unflatten(state, [torch.empty(t.shape, dtype=t.dtype,
                                              device="meta")
                                  for t in leaves])
    with NewStorages():
        host, extra = mgr.restore(meta, device="cpu")
        for d, h in zip(dst, tree_leaves(host)):
            load_shard(d, h)
    final = Path(directory) / "step_000000001" / "arrays"
    equal = True
    for i, t in enumerate(dst):
        want = np.load(final / f"{i:05d}.npy")[shard_slices(
            t.shape, t.placements, t.device_mesh)]
        got = t.to_local().detach().cpu()
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
        equal &= bool(np.array_equal(np.asarray(got), want))
    sizes = {t.numel() for t in dst if t.to_local().numel() != t.numel()}
    return {"leaves": len(dst),
            "sharded_leaves": sum(t.to_local().numel() != t.numel()
                                  for t in dst),
            "bit_equal": equal, "extra": extra,
            "whole_made": sum(n in sizes for n in made),
            "made": len(made)}
