"""The CNN path in bf16: the port's bf16 kernels' plain versions, its
bf16 programs and its engine options against the JAX reference.

The reference runs bf16 when its params are bf16 (``init_params(...,
dtype=jnp.bfloat16)``): every Pallas kernel sums in f32 and casts once at
its flush. The port's ``gemm_bf16`` and ``conv_im2col_bf16`` do the same
on the card; here, on the CPU, their plain versions run (f32 product,
epilogue in f32, one round-to-nearest-even cast). Inputs are made with
numpy from a seed and handed to both packages; reference params come over
through ``bridge.params_from_jax``. Kernel outputs are held within one
bf16 ulp (rtol 2^-7, atol 1e-4 of the output's max: the two f32 sums may
round to neighbouring bf16 values), whole forwards within the reference's
bf16 tolerance, 5e-2 of the largest logit (``tests/test_kernels.py:41``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.executor import init_params as jax_init_params
from repro.cnn.models import googlenet as jax_googlenet
from repro.cnn.models import vgg16 as jax_vgg16
from repro.core.cost_model import Dataflow as JaxDataflow
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import map_network as jax_map_network
from repro.kernels.conv_im2col.ops import conv_im2col as jax_conv_im2col
from repro.kernels.gemm.ops import batched_gemm as jax_batched_gemm
from repro.kernels.gemm.ops import gemm as jax_gemm
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn import overlay
from repro_torch.cnn.executor import (compile_plan, executable_cache_key,
                                      forward, init_params)
from repro_torch.cnn.models import googlenet, vgg16
from repro_torch.core.algorithms import IM2COL, KN2ROW, WINO_2_3
from repro_torch.core.cost_model import Dataflow
from repro_torch.core.dse import identify_parameters
from repro_torch.core.layouts import LayoutSpec
from repro_torch.core.mapper import map_network
from repro_torch.kernels import build
from repro_torch.kernels.common import apply_epilogue
from repro_torch.kernels.conv_im2col import conv_im2col as conv_mod
from repro_torch.kernels.conv_im2col.ops import conv_im2col
from repro_torch.kernels.conv_im2col.ref import conv_ref
from repro_torch.kernels.gemm.ops import batched_gemm, gemm
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine


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


BF = torch.bfloat16
BF16_ULP = 2.0 ** -7
FORWARD_REL = 5e-2          # the reference's bf16 tolerance
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _to_torch(a: np.ndarray, dtype=BF) -> torch.Tensor:
    """An f32 numpy array as a torch tensor of ``dtype`` (round to nearest
    even, as ``jnp.asarray(a, jnp.bfloat16)`` rounds)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_ulp(got, want):
    """``got`` within one bf16 ulp of ``want``: rtol 2^-7, atol 1e-4 of
    max|want|."""
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=BF16_ULP,
                               atol=1e-4 * float(np.abs(want).max()))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ kernels
@pytest.mark.parametrize("mkn", [(62, 124, 64), (128, 128, 128),
                                 (200, 300, 100), (8, 512, 8),
                                 (1, 256, 131), (257, 129, 63),
                                 (96, 160, 72)])
@pytest.mark.parametrize("df", list(Dataflow), ids=lambda d: d.name)
def test_gemm_bf16_matches_reference(mkn, df):
    """The reference's ``test_gemm_all_dataflows_match_oracle`` and
    ``test_gemm_dtypes`` shapes in bf16: the port's bf16 GEMM against the
    reference's interpret-mode kernel, a bf16 C within one ulp."""
    m, k, n = mkn
    rng = _rng(m * 7 + k + n)
    a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    bias = rng.normal(0, 0.5, (n,))
    for epilogue in ("none", "bias_relu"):
        got = gemm(_to_torch(a), _to_torch(b), dataflow=df,
                   epilogue=epilogue, bias=_to_torch(bias))
        want = jax_gemm(jnp.asarray(a, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16),
                        dataflow=JaxDataflow[df.name], interpret=True,
                        epilogue=epilogue,
                        bias=jnp.asarray(bias, jnp.bfloat16))
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        _within_one_ulp(got, want)


def test_gemm_out_dtype_both_ways():
    """``out_dtype`` is a store of the flush: bf16 operands stored as f32
    and f32 operands stored as bf16 (dense and batched), each against the
    reference's ``out_dtype``; the defaults are the reference's, and any
    other value raises."""
    rng = _rng(3)
    a, b = rng.standard_normal((70, 96)), rng.standard_normal((96, 40))
    got = gemm(_to_torch(a), _to_torch(b), out_dtype=torch.float32)
    want = jax_gemm(jnp.asarray(a, jnp.bfloat16),
                    jnp.asarray(b, jnp.bfloat16), out_dtype=jnp.float32,
                    interpret=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    got = gemm(_to_torch(a, torch.float32), _to_torch(b, torch.float32),
               out_dtype=BF, epilogue="relu")
    want = jax_gemm(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                    out_dtype=jnp.bfloat16, epilogue="relu", interpret=True)
    assert got.dtype == BF
    _within_one_ulp(got, want)
    ga, gb = rng.standard_normal((3, 30, 20)), rng.standard_normal((3, 20, 9))
    got = batched_gemm(_to_torch(ga, torch.float32),
                       _to_torch(gb, torch.float32), out_dtype=BF)
    want = jax_batched_gemm(jnp.asarray(ga, jnp.float32),
                            jnp.asarray(gb, jnp.float32),
                            out_dtype=jnp.bfloat16, interpret=True)
    assert got.dtype == BF
    _within_one_ulp(got, want)
    f32 = _to_torch(a, torch.float32)
    assert gemm(f32, f32.T.contiguous()).dtype == torch.float32
    assert gemm(_to_torch(a), _to_torch(a).T.contiguous()).dtype == BF
    i8 = torch.ones((4, 4), dtype=torch.int8)
    assert gemm(i8, i8, scale=torch.ones(4)).dtype == torch.float32
    for bad in ((f32, torch.float16), (i8, BF)):
        with pytest.raises(ValueError, match="out_dtype"):
            gemm(bad[0], bad[0], out_dtype=bad[1],
                 scale=torch.ones(4) if bad[0].dtype == torch.int8 else None)
    # The bf16 batched GEMM stores bf16 only (the reference's out_dtype =
    # a.dtype); f16 operands have no kernel.
    assert batched_gemm(_to_torch(ga), _to_torch(gb)).dtype == BF
    with pytest.raises(ValueError, match="out_dtype"):
        batched_gemm(_to_torch(ga), _to_torch(gb), out_dtype=torch.float32)
    with pytest.raises(TypeError):
        batched_gemm(_to_torch(ga, torch.float16),
                     _to_torch(gb, torch.float16))


# The reference's conv CASES (tests/test_kernels.py:55-58).
CASES = [(14, 14, 8, 16, 3, 3, 1, "SAME"), (28, 28, 4, 8, 5, 5, 1, "SAME"),
         (15, 15, 3, 8, 3, 3, 2, "SAME"), (14, 14, 8, 8, 1, 1, 1, "SAME"),
         (16, 16, 6, 10, 7, 7, 2, "SAME"), (14, 14, 8, 16, 3, 3, 1, "VALID"),
         (10, 10, 6, 10, 1, 7, 1, "SAME")]


@pytest.mark.parametrize("case", CASES)
def test_conv_im2col_bf16_matches_reference(case):
    """The port's bf16 im2col conv (bias and ReLU fused) against the
    reference's interpret-mode kernel on bf16 operands, one ulp."""
    h, w_, ci, co, k1, k2, s, pad = case
    rng = _rng(h * 100 + ci * 10 + k1)
    x, w = rng.standard_normal((h, w_, ci)), rng.standard_normal(
        (k1, k2, ci, co)) / np.sqrt(k1 * k2 * ci)
    bias = rng.normal(0, 0.2, (co,))
    got = conv_im2col(_to_torch(x), _to_torch(w), stride=s, padding=pad,
                      epilogue="bias_relu", bias=_to_torch(bias))
    want = jax_conv_im2col(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16), stride=s,
                           padding=pad, interpret=True, epilogue="bias_relu",
                           bias=jnp.asarray(bias, jnp.bfloat16))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape
    _within_one_ulp(got, want)


def test_bf16_gather_rule_matches_the_kernels_dispatch():
    """conv_im2col_bf16's entry point gathers 16 bytes under
    csrc/conv_im2col.cu::conv_bf16_vector_path; the wrapper's
    BF16_GATHER_RULE states the same divisors, and under it every conv of
    full-width GoogleNet but the stem (Cin 3) takes that path."""
    text = (build.CSRC / "conv_im2col.cu").read_text()
    body = re.search(r"inline bool conv_bf16_vector_path\(.*?\n}\n", text,
                     re.S)[0]
    terms = re.findall(r"(?:reinterpret_cast<uintptr_t>\()?(\w+)\)? % (\d+) "
                       r"== 0", body)
    assert {name: int(d) for name, d in terms} == conv_mod.BF16_GATHER_RULE
    assert "(int)conv_bf16_vector_path(x, w, c_in, c_out)" in text
    g = googlenet(res=224, scale=1.0)
    element = [n.name for n in g.conv_nodes()
               if not conv_mod.conv_bf16_vector_path(n.conv.c_in,
                                                     n.conv.c_out, 256, 256)]
    assert element == [g.conv_nodes()[0].name] and len(g.conv_nodes()) == 57
    assert not conv_mod.conv_bf16_vector_path(64, 64, 258, 256)


def test_toeplitz_layout_round_trip_keeps_bf16():
    """The Toeplitz store format is a gather: materialize and restore keep
    bf16 and the round trip is exact."""
    x = _to_torch(_rng(4).standard_normal((2, 9, 9, 5)))
    for stride in (1, 2):
        spec = LayoutSpec("toeplitz", 9, 9, 5, 3, 3, stride, "SAME")
        t = materialize(x, spec)
        assert t.dtype == BF
        back = restore(t, spec)
        assert back.dtype == BF and torch.equal(back, x)


def test_overlay_bf16_runs_im2col_only():
    """A bf16 layer runs im2col, kn2row and Winograd on the kernel path
    (bf16 out); an int8 layer takes bf16 x and emits f32, as the
    reference's does; bf16 x with f32 w raises ``TypeError``. The plain
    backends take bf16."""
    rng = _rng(5)
    x = _to_torch(rng.standard_normal((2, 8, 8, 4)))
    w = _to_torch(rng.standard_normal((3, 3, 4, 6)) / 6)
    y = overlay.apply_conv(x, w, IM2COL, epilogue="relu")
    assert y.dtype == BF
    y = overlay.apply_conv(x, w, WINO_2_3, epilogue="relu")
    assert y.dtype == BF and tuple(y.shape) == (2, 8, 8, 6)
    y = overlay.apply_conv(x, w, KN2ROW, epilogue="relu")
    assert y.dtype == BF and tuple(y.shape) == (2, 8, 8, 6)
    for algo in (KN2ROW, WINO_2_3):
        assert overlay.apply_conv(x, w, algo,
                                  backend="reference").dtype == BF
    for algo in (IM2COL, KN2ROW):
        y = overlay.apply_conv(x, w, algo, precision="int8", in_scale=0.1)
        assert y.dtype == torch.float32 and tuple(y.shape) == (2, 8, 8, 6)
    with pytest.raises(TypeError):
        overlay.apply_conv(x, w.float(), IM2COL)


def test_nhwc_conv_replays_an_elided_plan():
    """``overlay.nhwc_conv`` holds the reference's contract: a plain NHWC
    conv wrapped with it, patched in for ``apply_conv``, replays a plan
    whose elided edges hand it Toeplitz matrices and ask for them back,
    and gives the compiled program's logits."""
    g = googlenet(res=32, scale=0.25)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    params = init_params(g, seed=2, device="cpu")
    x = _rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = compile_plan(g, plan, epilogue="bias_relu", device="cpu")(
        params, x)
    calls = []

    @overlay.nhwc_conv
    def oracle(xi, w, algo, dataflow=Dataflow.NS, p1=128, p2=128, *,
               stride=1, padding="SAME", epilogue="none", bias=None, **kw):
        calls.append(xi.ndim)
        return apply_epilogue(conv_ref(xi, w, stride=stride,
                                       padding=padding), epilogue, bias)

    run = compile_plan(g, plan, epilogue="bias_relu", device="cpu")
    elided = [nid for nid, low in run.lowering.items()
              if low.in_layout is not None]
    assert elided, "the plan elides no edge"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(overlay, "apply_conv", oracle)
        got = run(params, x)
    assert len(calls) == len(g.conv_nodes()) and set(calls) == {4}
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


@pytest.fixture(scope="module")
def ref_bf16_vgg():
    """The reference's bias-free bf16 params of VGG16 at 8², width 0.05
    (``init_params(..., dtype=jnp.bfloat16, conv_bias=False)``): its only
    ``init_params`` call here, as it compiles one random draw per shape
    (~10 s on the CPU)."""
    jg = jax_vgg16(res=8, scale=0.05)
    jp = jax_init_params(jg, jax.random.PRNGKey(1), dtype=jnp.bfloat16,
                         conv_bias=False)
    return jg, jp


def test_params_from_jax_takes_bf16(ref_bf16_vgg):
    """The reference's bf16 params become bf16 tensors of the same values;
    the port's ``init_params(dtype=bf16, conv_bias=False)`` gives the same
    layout (no conv bias, the FC keeps one)."""
    jg, jp = ref_bf16_vgg
    ours = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    mine = init_params(vgg16(res=8, scale=0.05), seed=1, device="cpu",
                       dtype=BF, conv_bias=False)
    assert sorted(jp) == sorted(mine)
    for nid, layer in jp.items():
        assert set(ours[nid]) == set(layer) == set(mine[nid])
        assert set(layer) == ({"w"} if "in_features" not in
                              jg.nodes[nid].attrs else {"w", "b"})
        for name, arr in layer.items():
            assert ours[nid][name].dtype == mine[nid][name].dtype == BF
            assert tuple(ours[nid][name].shape) == arr.shape
            np.testing.assert_array_equal(_f32(ours[nid][name]), _f32(arr))


# ------------------------------------------------------------ programs
def _np_params(graph, seed, bias_scale=0.0):
    """He-normal numpy params of ``graph`` rounded to bf16
    (``ml_dtypes``, as the reference's bf16 arrays), made here: the
    reference's ``init_params`` compiles one random draw per shape, ~40 s
    at GoogleNet's. Conv biases are 0, or normal at ``bias_scale``."""
    rng = _rng(seed)
    params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.conv is not None:
            m = node.conv
            shape, fan_in, fan_out = ((m.k1, m.k2, m.c_in, m.c_out),
                                      m.k1 * m.k2 * m.c_in, m.c_out)
        elif "in_features" in node.attrs:
            fan_in = int(node.attrs["in_features"])
            fan_out = int(node.attrs["out_features"])
            shape = (fan_in, fan_out)
        else:
            continue
        params[nid] = {
            "w": np.asarray(jnp.asarray(rng.standard_normal(shape)
                                        / np.sqrt(fan_in), jnp.bfloat16)),
            "b": np.asarray(jnp.asarray(rng.normal(0, bias_scale, fan_out),
                                        jnp.bfloat16))}
    return params


@pytest.fixture(scope="module")
def bf16_googlenet():
    """GoogleNet at 56², width 0.25, planned by both packages (all
    im2col), with the same bf16 params on both sides (the port's through
    ``params_from_jax``)."""
    jg = jax_googlenet(res=56, scale=0.25)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    np_params = _np_params(jg, seed=0)
    g = googlenet(res=56, scale=0.25)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    params = params_from_jax(np_params, "cpu")
    return jg, jplan, np_params, g, plan, params


def test_googlenet_bf16_served_matches_reference(bf16_googlenet):
    """The bf16 path end to end: the port's engine (``dtype=bf16``) serves
    distinct requests through its compiled bf16 programs, against the
    reference's ``compile_plan`` (``use_pallas=False``) on bf16 params
    and inputs; results come back as f32 rows widening the bf16 logits.
    Measured at 0 here (both round each layer's f32 sum once, and the
    biases are 0); the limit is the reference's bf16 tolerance."""
    jg, jplan, np_params, g, plan, params = bf16_googlenet
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    images = _rng(7).standard_normal((5, 56, 56, 3)).astype(np.float32)
    ref = _f32(jax_compile_plan(jg, jplan)(
        jp, jnp.asarray(images, jnp.bfloat16)))
    engine = CNNServingEngine(g, params, plan, batch_size=4, dtype=BF,
                              warmup=True, device="cpu")
    for i, img in enumerate(images):
        engine.submit(CNNRequest(rid=i, image=img))
    done = engine.run_until_done()
    got = np.stack([done[i] for i in range(len(images))])
    assert got.dtype == np.float32
    assert _rel(got, ref) <= FORWARD_REL
    # The widened rows are the bf16 logits: they round to themselves.
    np.testing.assert_array_equal(_f32(_to_torch(got)), got)
    run = compile_plan(g, plan, epilogue="bias_relu", dtype=BF,
                       device="cpu")
    logits = run(params, _to_torch(images))
    assert logits.dtype == BF
    assert _rel(logits, ref) <= FORWARD_REL
    # f32 images promote, as the reference's do: an f32 walk, f32 logits.
    assert run(params, torch.from_numpy(images)).dtype == torch.float32
    with pytest.raises(TypeError):
        run(init_params(g, seed=0, device="cpu"), images)
    with pytest.raises(TypeError):
        compile_plan(g, plan, device="cpu")(init_params(g, seed=0,
                                                        device="cpu"),
                                            _to_torch(images))
    with pytest.raises(TypeError):
        CNNServingEngine(g, params, plan, device="cpu")
    assert executable_cache_key(g, plan, device="cpu") != \
        executable_cache_key(g, plan, device="cpu", dtype=BF)


def test_bf16_forward_tracks_the_f32_forward(bf16_googlenet):
    """The port's bf16 forward against its f32 forward of the same
    weights widened: within the reference's bf16 tolerance, as the
    reference's own bf16 run lies against its f32 run (measured 6.2e-3 of
    the largest logit here)."""
    _, _, _, g, plan, params = bf16_googlenet
    x = _rng(8).standard_normal((2, 56, 56, 3)).astype(np.float32)
    widened = {nid: {k: t.float() for k, t in layer.items()}
               for nid, layer in params.items()}
    got = forward(g, params, _to_torch(x), plan, epilogue="bias_relu",
                  device="cpu")
    want = forward(g, widened, x, plan, epilogue="bias_relu", device="cpu")
    assert got.dtype == BF and want.dtype == torch.float32
    assert 0 < _rel(got, want) <= FORWARD_REL


# ------------------------------------------------------------ engine options
@pytest.fixture(scope="module")
def tiny_vgg():
    """VGG16 at 8², width 0.05, with random conv biases (so the epilogue
    matters), as f32 numpy params both packages take."""
    jg = jax_vgg16(res=8, scale=0.05)
    np_params = jax.tree_util.tree_map(
        lambda a: a.astype(np.float32), _np_params(jg, seed=2, bias_scale=0.1))
    images = _rng(9).standard_normal((5, 8, 8, 3)).astype(np.float32)
    return jg, vgg16(res=8, scale=0.05), np_params, images


def _serve(engine, request_cls, images):
    for i, img in enumerate(images):
        engine.submit(request_cls(rid=i, image=img))
    done = engine.run_until_done()
    return np.stack([np.asarray(done[i], np.float32)
                     for i in range(len(images))])


@pytest.mark.parametrize("options", [
    dict(epilogue="relu"), dict(epilogue="bias_relu"),
    dict(trace_window=3), dict(use_pallas=False)],
    ids=["epilogue=relu", "epilogue=bias_relu", "trace_window=3",
         "use_pallas=False"])
def test_engine_options_match_reference_engine(tiny_vgg, options):
    """The engine's ``epilogue``, ``trace_window`` and ``use_pallas``
    against the reference's engine with the same option on the same
    requests: the same results (``epilogue="relu"`` leaves the conv
    biases out, as the reference's lowering does) and the same log
    window."""
    jg, g, np_params, images = tiny_vgg
    ours = CNNServingEngine(g, params_from_jax(np_params, "cpu"), None,
                            batch_size=4, device="cpu", **options)
    ref = JaxEngine(jg, np_params, None, batch_size=4, **options)
    got, want = _serve(ours, CNNRequest, images), _serve(ref, JaxRequest,
                                                         images)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert len(ours.request_log) == len(ref.request_log) == \
        min(options.get("trace_window", 2048), len(images))
    if options.get("epilogue") == "relu":
        biased = _serve(CNNServingEngine(
            g, params_from_jax(np_params, "cpu"), None, batch_size=4,
            device="cpu"), CNNRequest, images)
        assert np.abs(biased - got).max() > 1e-3


def test_conv_bias_false_matches_reference_engine(tiny_vgg, ref_bf16_vgg):
    """The reference's bias-free params (``init_params(conv_bias=False)``)
    and their bias-free lowering (the ``bias_relu`` epilogue drops to
    ReLU), served by the port's engine as by the reference's on the same
    requests: in bf16, and in f32 on the same weights widened."""
    _, g, _, images = tiny_vgg
    jg, jp = ref_bf16_vgg
    for dtype, jdtype in ((BF, jnp.bfloat16), (torch.float32, jnp.float32)):
        jpd = jax.tree_util.tree_map(lambda a: a.astype(jdtype), jp)
        ours = CNNServingEngine(
            g, params_from_jax(jax.tree_util.tree_map(np.asarray, jpd),
                               "cpu"), None, batch_size=4, dtype=dtype,
            device="cpu")
        ref = JaxEngine(jg, jpd, None, batch_size=4, dtype=jdtype)
        got = _serve(ours, CNNRequest, images)
        want = _serve(ref, JaxRequest, images)
        if dtype == BF:
            assert _rel(got, want) <= FORWARD_REL
        else:
            np.testing.assert_allclose(got, want, **F32_TOL)
