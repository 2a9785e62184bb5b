"""The port's LM stack (``repro_torch.models``) against the JAX package's
on the CPU: every reduced architecture, the reference's weights carried
over by ``bridge.lm_params_from_jax``, the same numpy tokens on both
sides.

Tolerances: in f32 every output within rtol 1e-4 / atol 1e-4 of the
reference's. In bf16 within rtol 5e-2 and an absolute 5e-2 of the
output's largest magnitude: the two packages round bf16 intermediates
at different points (JAX runs SiLU and scaling in bf16, torch in f32
before one rounding), so a near-zero element can move by a few bf16
ulps of its neighbours. Top-k routing is discontinuous: where two experts'
router probabilities lie closer than bf16's resolution, one ulp upstream
picks the other expert and that token's output (and its row's capacity
drops) changes wholly. The MoE FFN on one bf16 input matches the
reference's (``test_moe_aux_losses_and_capacity``); the whole-model bf16
comparison of an MoE architecture takes the first batch (seeds 1-10)
whose routing margins, in the port, all exceed ``ROUTING_MARGIN``, and
says so when none does. The port's own decode-vs-forward invariant holds
at the reference's 2e-3 (``tests/test_lm_models.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models.attention import chunked_attention as jax_chunked_attention
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import model as M
from repro_torch.models.attention import chunked_attention
from repro_torch.models.moe import moe_ffn, moe_ffn_dense
from repro_torch.models.ssm import ssd_chunked


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and
    torch's thread pool, oversubscribed, wakes slower than the small CPU
    ops it would split (on an eight-core host, a reduced GoogleNet's max
    pool took ~16 ms on eight threads, ~0.03 ms on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEY = jax.random.PRNGKey(0)
DTYPES = ("float32", "bfloat16")
# Least gap between the k-th and (k+1)-th router probability of a bf16
# MoE batch compared across packages: a few bf16 ulps of a probability
# near 1/8 (2**-8 relative).
ROUTING_MARGIN = 2e-3


def tol(dtype: str, want: np.ndarray) -> dict:
    if dtype == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=5e-2, atol=5e-2 * float(np.abs(want).max()))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def pair(name: str, dtype: str, **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                               dtype=dtype, **overrides)
    tcfg = dataclasses.replace(get_config(name, reduced=True), dtype=dtype,
                               **overrides)
    jp = JM.init_model(jcfg, KEY)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def batches(cfg, seed: int, b: int = 2, s: int = 16):
    """The same batch for both packages: (reference, port)."""
    rng = np.random.default_rng(seed)
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    tokens = rng.integers(0, cfg.vocab, (b, s - n_front)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.as_tensor(tokens, dtype=torch.long)}
    if n_front:
        fe = rng.standard_normal((b, n_front, cfg.frontend_dim)).astype(
            np.float32)
        jb["frontend_embeds"] = jnp.asarray(fe)
        tb["frontend_embeds"] = torch.as_tensor(fe)
    return jb, tb


def routing_margin(monkeypatch, run) -> float:
    """The least top-k routing margin of any token at any MoE layer while
    ``run()`` runs the port (inf without MoE)."""
    import repro_torch.models.moe as tmoe
    margins = [float("inf")]
    router = tmoe._router

    def spy(p, xt, mo):
        out = router(p, xt, mo)
        top = torch.sort(out[2], dim=-1, descending=True).values
        margins.append(float((top[..., mo.top_k - 1]
                              - top[..., mo.top_k]).min()))
        return out

    monkeypatch.setattr(tmoe, "_router", spy)
    try:
        run()
    finally:
        monkeypatch.undo()
    return min(margins)


def test_configs_are_the_references():
    """Every FULL and REDUCED table equal to the reference's, field by
    field (the port's copy only drops the unused JAX import)."""
    from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
    assert ARCH_NAMES == JAX_ARCH_NAMES
    for name in ARCH_NAMES:
        for reduced in (False, True):
            want = dataclasses.asdict(jax_get_config(name, reduced))
            got = dataclasses.asdict(get_config(name, reduced))
            assert {k: getattr(v, "value", v) for k, v in got.items()} == \
                {k: getattr(v, "value", v) for k, v in want.items()}
            assert get_config(name, reduced).param_count() == \
                jax_get_config(name, reduced).param_count()


def test_init_model_has_the_references_tree():
    """The port's own init gives the reference's names, shapes and
    dtypes; a seeded generator gives the same weights twice."""
    for name in ARCH_NAMES:
        jcfg = jax_get_config(name, reduced=True)
        cfg = get_config(name, reduced=True)
        want = jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(lambda k: JM.init_model(jcfg, k), KEY))[0]
        got = M.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
        again = M.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
        for path, leaf in want:
            keys = [k.key for k in path]
            t, t2 = got, again
            for k in keys:
                t, t2 = t[k], t2[k]
            assert tuple(t.shape) == leaf.shape, (name, keys)
            assert str(t.dtype).split(".")[-1] == leaf.dtype.name, keys
            assert torch.equal(t, t2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_loss_and_decode_match_reference(name, dtype, monkeypatch):
    """``forward`` (hidden and MoE aux), ``logits_from_hidden``,
    ``loss_fn`` and one ``decode_step`` from an empty cache (logits and
    the written cache) against the reference's on its own weights."""
    jcfg, tcfg, jp, tp = pair(name, dtype)
    for seed in range(1, 11):
        jb, tb = batches(jcfg, seed=seed)
        tok = np.random.default_rng(seed + 100).integers(
            0, jcfg.vocab, (2, 1)).astype(np.int32)

        def port_run():
            M.forward(tp, tb["tokens"], tcfg, tb.get("frontend_embeds"))
            M.decode_step(tp, torch.as_tensor(tok, dtype=torch.long),
                          M.init_cache(tcfg, 2, 32, "cpu"), 0, tcfg)

        if dtype == "float32" or tcfg.moe is None or \
                routing_margin(monkeypatch, port_run) >= ROUTING_MARGIN:
            break
    else:
        pytest.fail(f"no batch of seeds 1-10 routes every token of "
                    f"{name} with a margin of {ROUTING_MARGIN} in bf16")
    jh, jaux = JM.forward(jp, jb["tokens"], jcfg, jb.get("frontend_embeds"))
    th, taux = M.forward(tp, tb["tokens"], tcfg, tb.get("frontend_embeds"))
    assert th.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(f32(th), f32(jh), **tol(dtype, f32(jh)))
    np.testing.assert_allclose(float(taux), float(jaux),
                               **tol(dtype, np.asarray(f32(jaux))))
    jl = f32(JM.logits_from_hidden(jp, jcfg, jh))
    tl = M.logits_from_hidden(tp, tcfg, th)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(f32(tl), jl, **tol(dtype, jl))
    jloss, jm = JM.loss_fn(jp, jb, jcfg)
    tloss, tm = M.loss_fn(tp, tb, tcfg)
    for got, want in ((tloss, jloss), (tm["ce"], jm["ce"])):
        np.testing.assert_allclose(float(got), float(want),
                                   **tol(dtype, np.asarray(f32(want))))

    jcache = JM.init_cache(jcfg, batch=2, max_len=32)
    tcache = M.init_cache(tcfg, batch=2, max_len=32, device="cpu")
    jd, jcache = JM.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(0),
                                jcfg)
    td, tcache = M.decode_step(tp, torch.as_tensor(tok, dtype=torch.long),
                               tcache, 0, tcfg)
    np.testing.assert_allclose(f32(td), f32(jd), **tol(dtype, f32(jd)))
    want_leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, leaf in want_leaves:
        t = tcache
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_allclose(f32(t), f32(leaf), **tol(dtype, f32(leaf)))


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES
                                  if get_config(n).frontend == "none"])
def test_decode_matches_forward(name):
    """Token-by-token ``decode_step`` reproduces the teacher-forced
    ``forward`` logits in f32 (the reference's serving invariant, MLA's
    absorbed decode and Mamba's recurrent decode included); MoE archs run
    at capacity 8 so no token drops. The port's own weights."""
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 12
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, s)))
    hidden, _ = M.forward(params, tokens, cfg)
    ref = M.logits_from_hidden(params, cfg, hidden)
    cache = M.init_cache(cfg, batch=b, max_len=32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = M.decode_step(params, tokens[:, t:t + 1], cache, t, cfg)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-3, atol=2e-3)
    last = M.prefill(params, tokens, cfg)
    np.testing.assert_allclose(last.numpy(), ref[:, -1].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sliding_window_cache_wraps_like_the_reference():
    """A window smaller than the decoded length: the cache keeps
    ``min(max_len, window)`` slots as a ring, and every step's logits and
    the ring's contents equal the reference's."""
    jcfg, tcfg, jp, tp = pair("h2o-danube-1.8b", "float32",
                              sliding_window=4)
    jcache = JM.init_cache(jcfg, batch=2, max_len=32)
    tcache = M.init_cache(tcfg, batch=2, max_len=32, device="cpu")
    assert tuple(tcache["attn"]["k"].shape) == jcache["attn"]["k"].shape
    assert tcache["attn"]["k"].shape[2] == 4
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 9))
    for t in range(9):
        tok = tokens[:, t:t + 1].astype(np.int32)
        jd, jcache = JM.decode_step(jp, jnp.asarray(tok), jcache,
                                    jnp.int32(t), jcfg)
        td, tcache = M.decode_step(tp, torch.as_tensor(tok).long(), tcache,
                                   t, tcfg)
        np.testing.assert_allclose(td.numpy(), f32(jd), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(tcache["attn"]["k"].numpy(),
                               f32(jcache["attn"]["k"]), rtol=1e-4,
                               atol=1e-4)


def test_sliding_window_masks_distant_tokens():
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    assert cfg.sliding_window == 64
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 8, 2, 16)),
                               dtype=torch.float32) for _ in range(3))
    full = chunked_attention(q, k, v, window=0, chunk=4)
    win = chunked_attention(q, k, v, window=2, chunk=4)
    # with window 2, position 7 ignores keys 0..5 → must differ from full
    assert not np.allclose(full[0, 7].numpy(), win[0, 7].numpy(), atol=1e-4)
    # positions 0 and 1 see the same context in both
    np.testing.assert_allclose(full[0, :2].numpy(), win[0, :2].numpy(),
                               rtol=1e-4, atol=1e-5)
    for window in (0, 2):
        want = jax_chunked_attention(*(jnp.asarray(t.numpy())
                                       for t in (q, k, v)),
                                     window=window, chunk=4)
        got = chunked_attention(q, k, v, window=window, chunk=4)
        np.testing.assert_allclose(got.numpy(), f32(want), rtol=1e-4,
                                   atol=1e-5)


def test_chunked_attention_matches_full_softmax():
    b, s, h, d = 2, 33, 4, 16
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.standard_normal((b, s, h, d)),
                        dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((b, s, 2, d)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((b, s, 2, d)),
                        dtype=torch.float32)
    out = chunked_attention(q, k, v, chunk=8)
    kr, vr = k.repeat_interleave(2, 2), v.repeat_interleave(2, 2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(d)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
    sc = torch.where(mask[None, None], sc, -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vr)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)
    want = jax_chunked_attention(jnp.asarray(q.numpy()),
                                 jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()), chunk=8)
    np.testing.assert_allclose(out.numpy(), f32(want), rtol=1e-4, atol=1e-5)


def test_ssd_chunked_matches_naive_recurrence():
    """SSD (the duality) against the literal h_t = exp(dtA)h + dt·B x
    recurrence, and against the reference's ``ssd_chunked``."""
    rng = np.random.default_rng(3)
    b, l, h, p, n = 2, 24, 3, 4, 8
    xbar = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dta = (-rng.random((b, l, h)) * 0.5).astype(np.float32)
    b_in = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    c_in = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    got = ssd_chunked(*(torch.as_tensor(a) for a in
                        (xbar, dta, b_in, c_in)), chunk=8).numpy()
    state = np.zeros((b, h, p, n), np.float32)
    want = np.zeros((b, l, h, p), np.float32)
    for t in range(l):
        da = np.exp(dta[:, t])                               # (b, h)
        state = state * da[:, :, None, None] + np.einsum(
            "bhp,bn->bhpn", xbar[:, t], b_in[:, t])
        want[:, t] = np.einsum("bhpn,bn->bhp", state, c_in[:, t])
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    ref = jax_ssd_chunked(*(jnp.asarray(a) for a in
                            (xbar, dta, b_in, c_in)), chunk=8)
    np.testing.assert_allclose(got, f32(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_aux_losses_and_capacity(name, dtype):
    """The sort-based dispatch against the reference's on its weights
    (routing, capacity drops and aux losses), the dense GShard oracle
    against the sorted one where no token drops, and the load-balance
    loss ≥ 1 (Cauchy-Schwarz)."""
    cfg = dataclasses.replace(get_config(name, reduced=True), dtype=dtype)
    jp = jax_init_moe(KEY, jax_get_config(name, reduced=True),
                      jnp.dtype(dtype))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(8).standard_normal((2, 16, cfg.d_model))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.tensor(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    y, aux = moe_ffn(tp, tx, cfg)
    jy, jaux = jax_moe_ffn(jp, jx, cfg)
    assert y.shape == tx.shape and y.dtype == tx.dtype
    assert np.isfinite(f32(y)).all()
    np.testing.assert_allclose(f32(y), f32(jy), **tol(dtype, f32(jy)))
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   **tol(dtype, np.asarray(f32(jaux[key]))))
    assert float(aux["load_balance"]) >= 1.0 - 1e-3
    roomy = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    dense, dense_aux = moe_ffn_dense(tp, tx, roomy)
    np.testing.assert_allclose(f32(dense), f32(moe_ffn(tp, tx, roomy)[0]),
                               **tol(dtype, f32(dense)))
    assert float(dense_aux["load_balance"]) == float(aux["load_balance"])
