"""The port's int8 path against the JAX reference on the CPU.

Inputs are made with numpy from a seed and fed to both sides; parameters
come from the reference's ``init_params`` through ``params_from_jax``. The
reference's Pallas kernels run in interpret mode and the port runs each
int8 kernel's plain version (CPU tensors). Both sides get the same int8
operands and scales, so int32 partials and requantized int8 outputs must
be equal exactly; f32 outputs are held at 1e-5 (GEMM) and 1e-4 (convs),
the reference's int8 tolerances (``tests/test_quantized.py``), whole plans
at rtol 2e-2 / atol 2e-3. Run as a script (``main``), the file reads the
gated Inception-v4's deviation from its f32 plan in both packages at the
width and depth asked for."""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import inception_v4 as jax_inception_v4
from repro.cnn.models import vgg16 as jax_vgg16
from repro.cnn.overlay import apply_conv as jax_apply_conv
from repro.core.algorithms import IM2COL as JAX_IM2COL
from repro.core.algorithms import KN2ROW as JAX_KN2ROW
from repro.core.dse import identify_parameters as jax_identify
from repro.core.graph import ConvMeta as JaxConvMeta
from repro.core.graph import Graph as JaxGraph
from repro.core.graph import LayerKind as JaxLayerKind
from repro.core.layouts import LayoutSpec as JaxLayoutSpec
from repro.core.mapper import map_network as jax_map_network
from repro.core.quant import plan_mixed_precision as jax_gate
from repro.kernels.conv_im2col.ops import conv_im2col as jax_conv_im2col
from repro.kernels.gemm.ops import gemm as jax_gemm
from repro.kernels.kn2row import kn2row as jax_kn2
from repro.kernels.kn2row.ops import conv_kn2row as jax_conv_kn2row
from repro.kernels.layouts import materialize as jax_materialize
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import (ExecutableCache, compile_plan,
                                      executable_cache_key, forward)
from repro_torch.cnn.models import inception_v4, vgg16
from repro_torch.cnn.overlay import apply_conv
from repro_torch.core.algorithms import IM2COL, KN2ROW
from repro_torch.core.dse import identify_parameters
from repro_torch.core.graph import ConvMeta, Graph, LayerKind
from repro_torch.core.layouts import LayoutSpec
from repro_torch.core.mapper import lower_plan, map_network
from repro_torch.core.quant import (calibrate_act_scales, layer_errors,
                                    plan_mixed_precision)
from repro_torch.kernels.common import INT8_MAX_K
from repro_torch.kernels.conv_im2col.conv_im2col import conv_im2col_call
from repro_torch.kernels.conv_im2col.ops import conv_im2col
from repro_torch.kernels.conv_im2col.ref import conv_geometry
from repro_torch.kernels.gemm.gemm import gemm_call
from repro_torch.kernels.kn2row import kn2row as kn2
from repro_torch.kernels.kn2row.ops import conv_kn2row
from repro_torch.kernels.layouts import materialize
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


GEMM_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)
EPILOGUES = ["none", "relu", "bias", "bias_relu"]
OUT_SCALE = 0.05


def rnd(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def rnd_i8(seed, *shape):
    return np.random.default_rng(seed).integers(
        -127, 128, shape).astype(np.int8)


def dequant_scale(seed, n, depth):
    """Per-channel scales that bring a depth-``depth`` int8 sum to ~1."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, n) / (127.0 ** 2 * np.sqrt(depth) / 3)
            ).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_same(got: torch.Tensor, ref, tol) -> None:
    """int8 outputs equal exactly; f32 ones within ``tol``."""
    ref = np.asarray(ref)
    assert got.dtype == (torch.int8 if ref.dtype == np.int8
                         else torch.float32)
    assert tuple(got.shape) == ref.shape
    if ref.dtype == np.int8:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, **tol)


# ------------------------------------------------------- kernels' plain
# (M, K, N): ragged M, N and K under every epilogue; then the edges of
# the kernel's mma.sync loop (a 1x1x1 problem, ragged fragments, a K one
# k32 step past a 64-deep chunk) under bias_relu, f32 and requantized.
GEMM_I8_CASES = (
    [pytest.param((40, 70, 24), ep, os, id=f"{ep}-{os}")
     for ep in EPILOGUES for os in (None, OUT_SCALE)]
    + [pytest.param(mkn, "bias_relu", os,
                    id=f"{'x'.join(map(str, mkn))}-bias_relu-{os}")
       for mkn in ((1, 1, 1), (17, 33, 9), (64, 96, 8))
       for os in (None, OUT_SCALE)])


@pytest.mark.parametrize("mkn,epilogue,out_scale", GEMM_I8_CASES)
def test_gemm_i8_plain_matches_reference(mkn, epilogue, out_scale):
    """Ragged M, N and K: the reference pads to its blocks, the port
    never pads."""
    m, k, n = mkn
    a, b = rnd_i8(1, m, k), rnd_i8(2, k, n)
    scale, bias = dequant_scale(3, n, k), rnd(4, n)
    use_bias = epilogue.startswith("bias")
    ref = jax_gemm(jnp.asarray(a), jnp.asarray(b), interpret=True,
                   epilogue=epilogue, scale=jnp.asarray(scale),
                   bias=jnp.asarray(bias) if use_bias else None,
                   out_scale=out_scale)
    got = gemm_call(t(a), t(b), epilogue=epilogue, scale=t(scale),
                    bias=t(bias) if use_bias else None, out_scale=out_scale)
    assert_same(got, ref, GEMM_TOL)


def test_int8_wrappers_validate_their_operands():
    a, b = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(
        8, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="need a dequant scale"):
        gemm_call(a, b)
    with pytest.raises(ValueError, match="need torch.int8 operands"):
        gemm_call(a.float(), b.float(), scale=torch.ones(3))
    with pytest.raises(ValueError, match="need torch.int8 operands"):
        gemm_call(a.float(), b.float(), out_scale=0.1)
    deep = INT8_MAX_K + 1
    with pytest.raises(ValueError, match="cannot overflow"):
        gemm_call(torch.zeros(1, deep, dtype=torch.int8),
                  torch.zeros(deep, 1, dtype=torch.int8),
                  scale=torch.ones(1))
    with pytest.raises(ValueError, match="int32 operands need"):
        kn2.pad_accumulate_call(torch.zeros(1, 1, 2, 2, 3, dtype=torch.int32),
                                k1=1, k2=1, o1=2, o2=2)
    with pytest.raises(ValueError, match="need torch.int32"):
        kn2.pad_accumulate_call(torch.zeros(1, 1, 2, 2, 3), k1=1, k2=1,
                                o1=2, o2=2, out_scale=0.1)


@pytest.mark.parametrize("gmkn", [(9, 16, 8, 16), (3, 24, 16, 8),
                                  (1, 32, 24, 16), (1, 1, 1, 1),
                                  (1, 17, 33, 9), (1, 64, 96, 8),
                                  (9, 17, 33, 9)])
def test_unit_conv_gemms_i8_partials_are_exact(gmkn):
    """Ragged shapes: the reference's kernel takes operands padded to its
    blocks (as its ops pad them), the port's unpadded ones."""
    g, m, k, n = gmkn
    x2d, w = rnd_i8(5, m, k), rnd_i8(6, g, k, n)
    dm, dk, dn = (-d % 8 for d in (m, k, n))
    ref = jax_kn2.unit_conv_gemms(
        jnp.asarray(np.pad(x2d, ((0, dm), (0, dk)))),
        jnp.asarray(np.pad(w, ((0, 0), (0, dk), (0, dn)))), bm=8, bn=8,
        bk=8, interpret=True)[:, :m, :n]
    got = kn2.unit_conv_gemms_call(t(x2d), t(w), bm=64, bn=64)
    assert got.dtype == torch.int32 and np.asarray(ref).dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# (H, W, K1, K2, stride, padding, C, batch): SAME and VALID at stride 1
# and 2, and the one-dim pad of 1x3; then the edges of the card kernel's
# paths: C 30 (one channel a thread), batch 1, the generic offsets 1x7,
# 7x1 and 5x5 (5x5 at stride 2), and SAME at stride 2 on an odd map (pads
# on both sides).
PA_CASES = [(9, 9, 3, 3, 1, "SAME", 6, 2), (9, 9, 3, 3, 1, "VALID", 6, 2),
            (10, 9, 3, 3, 2, "SAME", 6, 2), (11, 11, 3, 3, 2, "VALID", 6, 2),
            (8, 8, 1, 3, 1, "SAME", 6, 2), (9, 9, 3, 3, 1, "SAME", 30, 2),
            (7, 7, 3, 3, 1, "SAME", 8, 1), (10, 10, 1, 7, 1, "SAME", 8, 2),
            (10, 10, 7, 1, 1, "SAME", 8, 2), (9, 9, 5, 5, 1, "SAME", 4, 2),
            (11, 11, 5, 5, 2, "SAME", 4, 2), (9, 9, 3, 3, 2, "SAME", 8, 2)]
PA_IDS = [f"{c[0]}x{c[1]}_{c[2]}x{c[3]}s{c[4]}{c[5]}"
          + ("" if c[6:] == (6, 2) else f"_c{c[6]}b{c[7]}") for c in PA_CASES]


def flush_cases(cases, ids):
    """Every epilogue, with and without requantization, on the first
    geometry; ``bias_relu`` with and without on the others (the flush is
    per element: geometry changes what is summed, not how it is flushed)."""
    return [pytest.param(c, ep, os, id=f"{i}-{ep}-{os}")
            for n, (c, i) in enumerate(zip(cases, ids))
            for ep in (EPILOGUES if n == 0 else ["bias_relu"])
            for os in (None, OUT_SCALE)]


@pytest.mark.parametrize("case,epilogue,out_scale",
                         flush_cases(PA_CASES, PA_IDS))
def test_pad_accumulate_i32_plain_matches_reference(case, epilogue,
                                                    out_scale):
    """int32 partials, unpadded on the port's side and zero-padded for
    the reference's; the images side by side along C in one reference
    call (the flush is per channel)."""
    h, w, k1, k2, stride, padding, c, batch = case
    o1, o2, pt, _, pl, _ = conv_geometry(h, w, k1, k2, stride, padding)
    p = np.random.default_rng(7).integers(
        -30000, 30000, (k1 * k2, batch, h, w, c)).astype(np.int32)
    scale, bias = dequant_scale(8, c, 9 * 16), rnd(9, c)
    use_bias = epilogue.startswith("bias")
    got = kn2.pad_accumulate_call(
        t(p), k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, pad_top=pt,
        pad_left=pl, epilogue=epilogue, bias=t(bias) if use_bias else None,
        scale=t(scale), out_scale=out_scale)
    side = np.concatenate(list(p.transpose(1, 0, 2, 3, 4)), axis=-1)
    ref = jax_kn2.pad_accumulate(
        jnp.asarray(np.pad(side, ((0, 0), (pt, k1), (pl, k2), (0, 0)))),
        k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, interpret=True,
        epilogue=epilogue, scale=jnp.asarray(np.tile(scale, batch)[None]),
        bias=jnp.asarray(np.tile(bias, batch)[None]) if use_bias else None,
        out_scale=out_scale)
    assert_same(torch.cat(list(got), dim=-1), ref, CONV_TOL)


# (H, W, Cin, Cout, K1, K2, stride, padding)
CONV_CASES = [(9, 9, 5, 7, 3, 3, 1, "SAME"), (9, 9, 5, 7, 3, 3, 1, "VALID"),
              (10, 10, 5, 7, 3, 3, 2, "SAME"),
              (11, 11, 5, 7, 3, 3, 2, "VALID"), (8, 8, 6, 4, 1, 3, 1, "SAME")]
CONV_IDS = [f"{c[4]}x{c[5]}s{c[6]}{c[7]}" for c in CONV_CASES]


def _conv_inputs(case, seed, batch=2):
    h, w_, ci, co, k1, k2, _, _ = case
    x, w = rnd_i8(seed, batch, h, w_, ci), rnd_i8(seed + 1, k1, k2, ci, co)
    return x, w, dequant_scale(seed + 2, co, k1 * k2 * ci), rnd(seed + 3, co)


@pytest.mark.parametrize("case,epilogue,out_scale",
                         flush_cases(CONV_CASES, CONV_IDS))
def test_conv_kn2row_i8_plain_matches_reference(case, epilogue, out_scale):
    """Both kn2row phases on int8 operands, batched."""
    s, pad = case[6], case[7]
    x, w, scale, bias = _conv_inputs(case, 10)
    bias = bias if epilogue.startswith("bias") else None
    ref = jax_conv_kn2row(
        jnp.asarray(x), jnp.asarray(w), stride=s, padding=pad,
        interpret=True, epilogue=epilogue, scale=jnp.asarray(scale),
        bias=None if bias is None else jnp.asarray(bias),
        out_scale=out_scale)
    got = conv_kn2row(t(x), t(w), stride=s, padding=pad, epilogue=epilogue,
                      bias=None if bias is None else t(bias),
                      scale=t(scale), out_scale=out_scale)
    assert_same(got, ref, CONV_TOL)


# (id, case, batch, Toeplitz input): the implicit-GEMM conv on an int8
# NHWC map and the GEMM on the layer's int8 Toeplitz matrix (the elided
# edge); then, on NHWC maps, the geometries at the edges of the int8
# kernel's two A paths: Cin 16 (K 144, one k32 step past two 64-deep
# chunks), stem/c1's Cin 3 (K 27, the byte path), Cin 32 at 3x3, 1x7 and
# 7x1 SAME, SAME at stride 2 on an odd map, and batch 1 with a 1x1 output.
CONV_I8_CASES = [
    ("nhwc", CONV_CASES[3], 2, False), ("toeplitz", CONV_CASES[2], 2, True),
    ("cin16", (9, 9, 16, 8, 3, 3, 1, "SAME"), 2, False),
    ("cin3-k27", (11, 11, 3, 32, 3, 3, 2, "VALID"), 2, False),
    ("cin32-3x3", (7, 7, 32, 12, 3, 3, 1, "SAME"), 2, False),
    ("1x7", (8, 8, 16, 8, 1, 7, 1, "SAME"), 2, False),
    ("7x1", (8, 8, 16, 8, 7, 1, 1, "SAME"), 2, False),
    ("s2-odd", (9, 9, 16, 8, 3, 3, 2, "SAME"), 2, False),
    ("batch1", (3, 3, 16, 1, 3, 3, 1, "VALID"), 1, False)]


@pytest.mark.parametrize("geometry,epilogue,out_scale", flush_cases(
    [c[1:] for c in CONV_I8_CASES], [c[0] for c in CONV_I8_CASES]))
def test_conv_im2col_i8_plain_matches_reference(geometry, epilogue,
                                                out_scale):
    """The int8 conv's plain path (CPU tensors) against the reference's
    interpret-mode kernel: on NHWC maps through ``conv_im2col`` and
    ``conv_im2col_call``, on a Toeplitz matrix through ``conv_im2col``."""
    case, batch, toeplitz = geometry
    h, w_, ci, _, k1, k2, s, pad = case
    x, w, scale, bias = _conv_inputs(case, 20, batch)
    bias = bias if epilogue.startswith("bias") else None
    kw = dict(stride=s, padding=pad, epilogue=epilogue, out_scale=out_scale)
    spec = dict(kind="toeplitz", h=h, w=w_, c=ci, k1=k1, k2=k2, stride=s,
                padding=pad)
    jx, tx = jnp.asarray(x), t(x)
    if toeplitz:
        jx = jax_materialize(jx, JaxLayoutSpec(**spec))
        tx = materialize(tx, LayoutSpec(**spec))
        assert tx.dtype == torch.int8
    ref = jax_conv_im2col(jx, jnp.asarray(w), interpret=True,
                          scale=jnp.asarray(scale),
                          bias=None if bias is None else jnp.asarray(bias),
                          in_layout=JaxLayoutSpec(**spec) if toeplitz
                          else None, **kw)
    got = conv_im2col(tx, t(w), scale=t(scale),
                      bias=None if bias is None else t(bias),
                      in_layout=LayoutSpec(**spec) if toeplitz else None,
                      **kw)
    assert_same(got, ref, CONV_TOL)
    if not toeplitz:
        assert_same(conv_im2col_call(tx, t(w), scale=t(scale),
                                     bias=None if bias is None else t(bias),
                                     **kw), ref, CONV_TOL)


# ---------------------------------------------------------------- overlay
@pytest.mark.parametrize("layout", ["nhwc", "toeplitz"])
@pytest.mark.parametrize("algo", ["im2col", "kn2row"])
def test_apply_conv_int8_kernel_path_matches_emulation(algo, layout):
    """The true int8 path (the int8 kernels' plain versions on CPU
    tensors) against the fake-quant emulation and against the reference's
    interpret-mode int8 kernels, f32 out; and requantized to int8."""
    ours, theirs = {"im2col": (IM2COL, JAX_IM2COL),
                    "kn2row": (KN2ROW, JAX_KN2ROW)}[algo]
    x, w = rnd(30, 2, 9, 9, 6), rnd(31, 3, 3, 6, 8, scale=0.2)
    bias = rnd(32, 8, scale=0.1)
    in_scale = float(np.abs(x).max()) / 127
    spec = (None if layout == "nhwc" else
            dict(kind="toeplitz", h=9, w=9, c=6, k1=3, k2=3, stride=1,
                 padding="SAME"))
    tx, jx = t(x), jnp.asarray(x)
    if spec is not None:
        tx = materialize(tx, LayoutSpec(**spec))
        jx = jax_materialize(jx, JaxLayoutSpec(**spec))
    kw = dict(stride=1, padding="SAME", epilogue="bias_relu",
              precision="int8", in_scale=in_scale)
    tkw = dict(kw, bias=t(bias),
               in_layout=None if spec is None else LayoutSpec(**spec))
    jkw = dict(kw, bias=jnp.asarray(bias),
               in_layout=None if spec is None else JaxLayoutSpec(**spec))
    got = apply_conv(tx, t(w), ours, **tkw)
    emul = apply_conv(tx, t(w), ours, backend="lax", **tkw)
    ref = jax_apply_conv(jx, jnp.asarray(w), theirs, backend="pallas",
                         interpret=True, **jkw)
    np.testing.assert_allclose(got.numpy(), emul.numpy(), **CONV_TOL)
    assert_same(got, ref, CONV_TOL)
    q = apply_conv(tx, t(w), ours, out_scale=OUT_SCALE, **tkw)
    jq = jax_apply_conv(jx, jnp.asarray(w), theirs, backend="pallas",
                        interpret=True, out_scale=OUT_SCALE, **jkw)
    assert_same(q, jq, CONV_TOL)
    if spec is None:
        # A fused edge: the input arrives int8 at this layer's scale.
        xq = rnd_i8(33, 2, 9, 9, 6)
        assert_same(apply_conv(t(xq), t(w), ours, in_quantized=True, **tkw),
                    jax_apply_conv(jnp.asarray(xq), jnp.asarray(w), theirs,
                                   backend="pallas", interpret=True,
                                   in_quantized=True, **jkw), CONV_TOL)


# ------------------------------------------------------------- the gate
IV4 = dict(res=75, scale=0.2, n_a=1, n_b=1, n_c=1)


def _models(name):
    if name == "vgg16":
        return vgg16(res=8, scale=0.05), jax_vgg16(res=8, scale=0.05), 8
    return inception_v4(**IV4), jax_inception_v4(**IV4), 75


def _np_params(graph, seed=0):
    """``{nid: {"w", "b"}}`` as the reference's ``init_params`` lays it
    out (He-style weights), drawn with numpy, biases non-zero."""
    rng = np.random.default_rng(seed)
    params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.conv is not None:
            m = node.conv
            shape = (m.k1, m.k2, m.c_in, m.c_out)
            fan_in, fan_out = m.k1 * m.k2 * m.c_in, m.c_out
        elif "in_features" in node.attrs:
            fan_in = int(node.attrs["in_features"])
            fan_out = int(node.attrs["out_features"])
            shape = (fan_in, fan_out)
        else:
            continue
        params[nid] = {
            "w": (rng.standard_normal(shape) / np.sqrt(fan_in)
                  ).astype(np.float32),
            "b": rng.normal(0, 0.05, (fan_out,)).astype(np.float32)}
    return params


# Gate tolerances with every isolated error at least 3.8e-4 from them and
# at least one layer demoted on each graph (1 of VGG16's 13 convs, 3 of
# Inception-v4's 48).
GATE_TOL = {"vgg16": 0.012, "inception_v4": 0.0153}


@functools.lru_cache(maxsize=None)
def _gate(name):
    """The gate on both sides, on the same two calibration images, each
    with the slice's ``identify_parameters`` binding."""
    g, jg, res = _models(name)
    np_params = _np_params(jg)
    x = np.random.default_rng(1).standard_normal(
        (2, res, res, 3)).astype(np.float32)
    params = params_from_jax(np_params, "cpu")
    report = plan_mixed_precision(g, params, x, tol=GATE_TOL[name],
                                  hw=identify_parameters(g, max_dim=512))
    jreport = jax_gate(jg, np_params, jnp.asarray(x), tol=GATE_TOL[name],
                       hw=jax_identify(jg, max_dim=512))
    return name, g, jg, params, np_params, x, report, jreport


@pytest.fixture(scope="module", params=sorted(GATE_TOL))
def gated(request):
    return _gate(request.param)


@pytest.fixture(scope="module")
def gated_vgg():
    return _gate("vgg16")


@pytest.fixture(scope="module")
def gated_iv4():
    return _gate("inception_v4")


def test_calibration_and_errors_match_reference(gated):
    """Scales and isolated errors against those the reference's gate
    computed (``calibrate_act_scales``, then ``layer_errors`` at its
    scales)."""
    _, g, _, params, _, x, _, jreport = gated
    scales = calibrate_act_scales(g, params, x)
    assert sorted(scales) == sorted(jreport.act_scales) == sorted(
        n.id for n in g.conv_nodes())
    for nid, s in jreport.act_scales.items():
        assert scales[nid] == pytest.approx(s, rel=1e-5)
    errs = layer_errors(g, params, x, jreport.act_scales)
    assert sorted(errs) == sorted(jreport.errors)
    for nid, e in jreport.errors.items():
        assert errs[nid] == pytest.approx(e, abs=1e-4)


def test_gate_matches_reference(gated):
    name, g, _, _, _, _, report, jreport = gated
    assert report.demoted == jreport.demoted
    assert report.rounds == jreport.rounds
    assert report.plan.precisions == jreport.plan.precisions
    assert {n: a.key for n, a in report.plan.assignment.items()} == {
        n: a.key for n, a in jreport.plan.assignment.items()}
    assert report.precision_mix == jreport.precision_mix
    for nid, e in jreport.errors.items():
        assert report.errors[nid] == pytest.approx(e, abs=1e-4)
    for nid, prec in report.plan.precisions.items():
        if prec == "int8":
            assert report.errors[nid] <= report.tol
    mix = collections.Counter((report.plan.assignment[n].key, p)
                              for n, p in report.plan.precisions.items())
    assert report.demoted and mix[("im2col", "int8")] > 0
    if name == "inception_v4":
        assert mix[("kn2row", "int8")] > 0


class _FlagSpy(torch.overrides.TorchFunctionMode):
    """Records the TF32 flags at every torch call made under it."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.seen.add((torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


def test_gate_measures_without_tf32_whatever_the_global_flags(
        gated_vgg, monkeypatch):
    """The isolated errors sit within a few 1e-3 of the gate's tol, so its
    f32 walks must not run in TF32 on the card: with both global flags on,
    every torch call of calibration and error measurement sees them off,
    the results are those of the flags off, and the flags come back."""
    _, g, _, params, _, x, report, _ = gated_vgg
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with _FlagSpy() as spy:
        scales = calibrate_act_scales(g, params, x)
        errs = layer_errors(g, params, x, scales)
    assert spy.seen == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    assert scales == report.act_scales and errs == report.errors


@pytest.fixture(scope="module")
def gated_iv4_reference(gated_iv4):
    """The reference's interpret-mode int8 kernels on the gated plan,
    elided, bucket 2. Elision changes only where each int8 layer's input
    is quantized (its own Toeplitz matrix, or the producer's requantizing
    flush at the same scale), not the function, so both of the port's
    programs are held to this one output."""
    _, _, jg, _, np_params, x, _, jreport = gated_iv4
    return np.asarray(jax_compile_plan(
        jg, jreport.plan, use_pallas=True, interpret=True,
        epilogue="bias_relu", tuning_batch=2,
        act_scales=jreport.act_scales)(np_params, x))


@pytest.mark.parametrize("elide", [True, False])
def test_gated_inception_v4_compile_plan_matches_reference(
        gated_iv4, gated_iv4_reference, elide):
    """The gated plan compiled with the reference's activation scales on
    both sides, bucket 2, against the reference's interpret-mode int8
    kernels; without elision the plan's fused int8 edges carry int8."""
    _, g, _, params, _, x, report, jreport = gated_iv4
    run = compile_plan(g, report.plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=2, act_scales=jreport.act_scales,
                       device="cpu")
    ref = gated_iv4_reference
    got = run(params, x)
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)
    fused = run.lowering.quantized_edges
    assert bool(fused) is (not elide)
    kinds = {(l.algo.family.value, l.in_quantized)
             for l in run.lowering.convs.values() if l.precision == "int8"}
    assert {("im2col", False), ("kn2row", False)} <= kinds
    if not elide:
        assert ("im2col", True) in kinds


def int8_deviation(g, jg, params, np_params, x, report, jreport):
    """The gated plan's logits against its own f32 plan's on each side —
    the port's true int8 path (the kernels' plain versions) and the
    reference's jitted fake-quant emulation, each plan at its own gate's
    scales — as ``(max|int8 - f32| / max|f32|, least per-image cosine
    similarity)``: ``{"port": ..., "reference": ...}``."""
    def reading(got, f32):
        got, f32 = (torch.from_numpy(np.array(v)).reshape(-1, 1000)
                    for v in (got, f32))
        return (float((got - f32).abs().max() / f32.abs().max()),
                float(torch.nn.functional.cosine_similarity(
                    got, f32, dim=-1).min()))

    kw = dict(epilogue="bias_relu")
    port = reading(
        compile_plan(g, report.plan, act_scales=report.act_scales,
                     device="cpu", **kw)(params, x),
        compile_plan(g, map_network(g, hw=identify_parameters(
            g, max_dim=512)), device="cpu", **kw)(params, x))
    ref = reading(
        jax_compile_plan(jg, jreport.plan, act_scales=jreport.act_scales,
                         **kw)(np_params, x),
        jax_compile_plan(jg, jax_map_network(jg, hw=jax_identify(
            jg, max_dim=512)), **kw)(np_params, x))
    return {"port": port, "reference": ref}


def test_int8_deviation_from_f32_matches_reference(gated):
    """How far the gated plan's logits sit from the f32 plan's is a
    property of the int8 semantics, not of an implementation: the port's
    reading equals the reference's."""
    _, g, jg, params, np_params, x, report, jreport = gated
    dev = int8_deviation(g, jg, params, np_params, x, report, jreport)
    (rel, cos), (jrel, jcos) = dev["port"], dev["reference"]
    assert 0 < rel and rel == pytest.approx(jrel, rel=1e-2, abs=1e-4)
    assert cos == pytest.approx(jcos, abs=1e-4)


# ------------------------------------------------------------ lowering
def _chain(pkg_graph, meta, kind, h=8, c=8):
    """INPUT -> 3x3 CONV -> 1x1 CONV -> OUTPUT (one fusable conv edge)."""
    g = pkg_graph()
    i = g.add_node(kind.INPUT, out_shape=(h, h, 3))
    c1 = g.add_node(kind.CONV, conv=meta(3, c, h, h, 3, 3))
    c2 = g.add_node(kind.CONV, conv=meta(c, c, h, h, 1, 1))
    o = g.add_node(kind.OUTPUT, out_shape=(h, h, c))
    g.chain([i, c1, c2, o])
    return g, c1, c2


def test_fused_precision_edge_matches_reference():
    """int8 → int8 single-successor NHWC edge: the producer requantizes at
    the consumer's scale and the consumer reads int8 — the lowering, and
    the compiled program against the reference's and the f32 forward."""
    g, c1, c2 = _chain(Graph, ConvMeta, LayerKind)
    jg, _, _ = _chain(JaxGraph, JaxConvMeta, JaxLayerKind)
    plan, jplan = map_network(g), jax_map_network(jg)
    plan.assignment[c1] = plan.assignment[c2] = IM2COL
    jplan.assignment[c1] = jplan.assignment[c2] = JAX_IM2COL
    plan.precisions = jplan.precisions = {c1: "int8", c2: "int8"}
    scales = {c1: 0.02, c2: 0.03}
    prog = lower_plan(g, plan, act_scales=scales, elide=False)
    assert prog.convs[c1].out_scale == pytest.approx(0.03)
    assert prog.convs[c2].in_quantized
    assert prog.transitions[(c1, c2)].precision == "int8"
    assert (c1, c2) in prog.quantized_edges
    np_params = _np_params(jg)
    params = params_from_jax(np_params, "cpu")
    x = rnd(40, 8, 8, 3)
    run = compile_plan(g, plan, act_scales=scales, elide=False,
                       epilogue="bias_relu", device="cpu")
    got = run(params, x)
    ref = jax_compile_plan(jg, jplan, use_pallas=True, interpret=True,
                           act_scales=scales, elide=False,
                           epilogue="bias_relu")(np_params, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)
    f32 = forward(g, params, x, epilogue="bias_relu", device="cpu")
    assert float((got - f32).abs().max() / f32.abs().max()) < 0.1
    # An elided (Toeplitz) edge never fuses: each layer quantizes its own
    # input; demoting the consumer breaks the fusion too.
    elided = lower_plan(g, plan, act_scales=scales)
    assert elided.convs[c1].out_scale is None and not elided.quantized_edges
    plan.precisions = {c1: "int8", c2: "bf16"}
    prog2 = lower_plan(g, plan, act_scales=scales, elide=False)
    assert prog2.convs[c1].out_scale is None and not prog2.quantized_edges


def test_executable_cache_distinguishes_precision_and_scales(gated_vgg):
    _, g, _, _, _, _, report, _ = gated_vgg
    cache = ExecutableCache()
    bf16 = map_network(g)
    kw = dict(cache=cache, device="cpu")
    run_q = compile_plan(g, report.plan, act_scales=report.act_scales, **kw)
    run_b = compile_plan(g, bf16, **kw)
    assert compile_plan(g, report.plan, act_scales=report.act_scales,
                        **kw) is run_q
    assert compile_plan(g, bf16, **kw) is run_b
    other = {n: 2 * s for n, s in report.act_scales.items()}
    assert compile_plan(g, report.plan, act_scales=other, **kw) is not run_q
    assert cache.stats() == {"entries": 3, "hits": 2, "misses": 3}
    assert executable_cache_key(g, report.plan,
                                act_scales=report.act_scales) != \
        executable_cache_key(g, bf16)


# ---------------------------------------------------------------- engine
def test_engine_serves_int8_plan_and_reports_precision(gated_vgg):
    """Both engines serve the gated plan with its scales; precision stats
    and every result agree."""
    _, g, jg, params, np_params, _, report, jreport = gated_vgg
    images = np.random.default_rng(5).standard_normal(
        (3, 8, 8, 3)).astype(np.float32)
    ours = CNNServingEngine(g, params, report.plan, batch_size=2,
                            act_scales=jreport.act_scales, device="cpu")
    ref = JaxEngine(jg, np_params, jreport.plan, batch_size=2,
                    act_scales=jreport.act_scales)
    for engine, req in ((ours, CNNRequest), (ref, JaxRequest)):
        for rid, img in enumerate(images):
            engine.submit(req(rid=rid, image=img))
        engine.run_until_done()
    stats = ours.stats()["precision"]
    assert stats == ref.stats()["precision"]
    assert stats["mix"] == report.precision_mix and stats["calibrated"]
    assert stats["int8_layers"] == sorted(
        n for n, p in report.plan.precisions.items() if p == "int8")
    for rid in range(3):
        np.testing.assert_allclose(ours.done[rid], np.asarray(ref.done[rid]),
                                   **PLAN_TOL)
    plain = CNNServingEngine(g, params, map_network(g), batch_size=2,
                             device="cpu").stats()["precision"]
    assert plain["mix"]["int8"] == 0 and not plain["calibrated"]


def main(argv=None) -> None:
    """The reading behind the int8-vs-f32 bound of ``chip_smoke.py``'s
    phase 17: the gate at tol 0.02 on Inception-v4 at the given widths and
    depths, both packages on the same numpy weights and images, each side's
    gated plan against its own f32 plan (``int8_deviation``)::

        PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_quant.py \\
            --scale 0.25 --blocks 1/1/1 2/3/1 4/7/3
    """
    import argparse
    import time

    ap = argparse.ArgumentParser(
        description="How far the gated Inception-v4's logits sit from the "
                    "f32 plan's, in the JAX reference and in the port.")
    ap.add_argument("--scale", type=float, nargs="+", default=[0.25])
    ap.add_argument("--blocks", nargs="+", default=["4/7/3"])
    args = ap.parse_args(argv)
    res, batch, tol = 299, 8, 0.02     # chip_smoke.py's phases 16-17
    for scale in args.scale:
        for blocks in args.blocks:
            n_a, n_b, n_c = (int(v) for v in blocks.split("/"))
            cfg = dict(res=res, scale=scale, n_a=n_a, n_b=n_b, n_c=n_c)
            t0 = time.perf_counter()
            g, jg = inception_v4(**cfg), jax_inception_v4(**cfg)
            np_params = _np_params(jg, seed=2)
            rng = np.random.default_rng(3)
            calib, x = (rng.standard_normal((n, res, res, 3))
                        .astype(np.float32) for n in (2, batch))
            params = params_from_jax(np_params, "cpu")
            report = plan_mixed_precision(
                g, params, calib, tol=tol,
                hw=identify_parameters(g, max_dim=512))
            jreport = jax_gate(jg, np_params, jnp.asarray(calib),
                               tol=tol, hw=jax_identify(jg, max_dim=512))
            dev = int8_deviation(g, jg, params, np_params, x, report,
                                 jreport)
            errs = sorted(jreport.errors.values())
            print(f"inception_v4 res {res} scale {scale} blocks "
                  f"{blocks}: {len(errs)} convs, mix {jreport.precision_mix}"
                  f" (port {report.precision_mix}), demoted "
                  f"{len(jreport.demoted)} (port {len(report.demoted)}), "
                  f"isolated errors {errs[0]:.4f}-{errs[-1]:.4f}; "
                  f"batch {batch} max|int8-f32|/max|f32| / least cosine:"
                  f" reference {dev['reference'][0]:.4f} / "
                  f"{dev['reference'][1]:.4f}, port {dev['port'][0]:.4f} / "
                  f"{dev['port'][1]:.4f} ({time.perf_counter() - t0:.0f} s)",
                  flush=True)


if __name__ == "__main__":
    main()
