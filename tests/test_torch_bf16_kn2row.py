"""The kn2row path in bf16 and the dtype rule of a gated bf16 model: the
port's bf16 kn2row kernels (their plain versions here, on the CPU),
``conv_kn2row`` in bf16, the mixed-dtype layers of a gated plan, reduced
Inception-v4 with bf16 params, its gated plan, the gate itself on bf16
params and the engine, against the JAX reference's Pallas kernels in
interpret mode.

The reference's kn2row kernels are dtype-generic: phase 1 sums in f32
and stores p in x's dtype, phase 2 sums p in f32 and stores p's dtype
after the epilogue (``src/repro/kernels/kn2row/kn2row.py``). Its dtype
rule in a gated bf16 plan is its type promotion: an int8 layer quantizes
bf16 x and emits f32 (or int8 under ``out_scale``); a bf16-weight layer
that receives f32 computes in f32 on the exactly widened weights and
emits f32; so the gated plan's logits are f32. Inputs are made with numpy
from a seed; each stage is fed the reference's own bf16 inputs. Stages are
held within one bf16 ulp (rtol 2^-7, atol 1e-4 of the output's max),
whole convs within the reference's bf16 tolerance, 5e-2 of the largest
value (``tests/test_kernels.py:41``), bf16 forwards within 2e-2 of the
reference's largest logit and gated (f32) ones at the reference's
whole-plan tolerance. Both sides take the same bf16 images, so that both
walk in bf16; f32 images promote on both sides, and
``tests/test_torch_bf16_promotion.py`` holds that walk.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as jax_layers
from repro.cnn.executor import ExecutableCache as JaxExecutableCache
from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import inception_v4 as jax_inception_v4
from repro.cnn.models import vgg16 as jax_vgg16
from repro.cnn.overlay import apply_conv as jax_apply_conv
from repro.core import algorithms as jax_algos
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import map_network as jax_map_network
from repro.core.quant import calibrate_act_scales as jax_calibrate
from repro.core.quant import plan_mixed_precision as jax_gate
from repro.kernels.kn2row import kn2row as jax_kn2
from repro.kernels.kn2row.ops import conv_kn2row as jax_conv_kn2row
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn import layers
from repro_torch.cnn import overlay
from repro_torch.cnn.executor import compile_plan
from repro_torch.cnn.models import inception_v4, vgg16
from repro_torch.core import algorithms as algos
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import map_network
from repro_torch.core.quant import calibrate_act_scales, plan_mixed_precision
from repro_torch.kernels.conv_im2col.ref import conv_geometry
from repro_torch.kernels.kn2row import kn2row as kn2
from repro_torch.kernels.kn2row.ops import conv_kn2row
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
CONV_REL = 5e-2             # the reference's bf16 tolerance
FORWARD_REL = 2e-2          # bf16 logits, of the reference's largest
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)      # the reference's whole-plan tol
CONV_TOL = dict(rtol=1e-4, atol=1e-4)      # its f32 and int8 conv tol
WINO_TOL = dict(rtol=2e-3, atol=2e-3)      # U summed in another order
EPILOGUES = ["none", "relu", "bias", "bias_relu"]
IV4 = dict(res=75, scale=0.2, n_a=1, n_b=1, n_c=1)
# Layers of reduced Inception-v4 pinned to bf16 in the gated plan, each
# downstream of int8 layers, so they receive f32: stem/c3 (F(4,3), after
# the int8 stem/c2), incA0/b3b and redB/b2b (im2col), redA/b2 and
# incC0/b3b (kn2row).
FORCE_BF16 = ("stem/c3", "incA0/b3b", "redB/b2b", "redA/b2", "incC0/b3b")
# The gate's tolerance on bf16 VGG16: at least 1e-3 from every isolated
# error (checked below), so both packages demote the same layers.
VGG_GATE_TOL = 0.0121


def _rng(seed):
    return np.random.default_rng(seed)


def _bf(a) -> torch.Tensor:
    """An f32 numpy array as a bf16 tensor (round to nearest even, as
    ``jnp.asarray(a, jnp.bfloat16)`` rounds)."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF)


def _jbf(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_ulp(got, want):
    assert got.dtype == BF and jnp.asarray(want).dtype == jnp.bfloat16
    want = _f32(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), want, rtol=BF16_ULP,
                               atol=1e-4 * float(np.abs(want).max()))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ kernels
@pytest.mark.parametrize("gmkn", [(9, 16, 8, 16), (3, 24, 16, 8),
                                  (1, 1, 1, 1), (3, 17, 33, 9),
                                  (2, 64, 64, 40)])
def test_unit_conv_gemms_bf16_matches_reference(gmkn):
    """Phase 1 in bf16: one x2d shared by every offset's weight, f32 sums
    rounded once into a bf16 p, against the reference's interpret-mode
    kernel on the same bf16 operands (padded to its blocks of 8, as its
    ops pad them)."""
    g, m, k, n = gmkn
    rng = _rng(sum(gmkn))
    x2d = _bf(rng.standard_normal((m, k)))
    w = _bf(rng.standard_normal((g, k, n)) / np.sqrt(k))
    dm, dk, dn = -m % 8, -k % 8, -n % 8
    ref = jax_kn2.unit_conv_gemms(
        _jbf(np.pad(_f32(x2d), ((0, dm), (0, dk)))),
        _jbf(np.pad(_f32(w), ((0, 0), (0, dk), (0, dn)))), bm=8, bn=8,
        bk=8, interpret=True)[:, :m, :n]
    got = kn2.unit_conv_gemms_call(x2d, w, bm=64, bn=64)
    _within_one_ulp(got, ref)
    assert torch.equal(got, kn2.unit_conv_gemms_plain(x2d, w))


# (H, W, K1, K2, stride, padding, C, batch): SAME and VALID at stride 1
# and 2, the unrolled offsets 1x3, 3x1 and 1x1, C 30 (the one-channel
# path), batch 1 and the generic 5x5 and 7x1.
PA_CASES = [(9, 9, 3, 3, 1, "SAME", 8, 2), (9, 9, 3, 3, 1, "VALID", 8, 2),
            (10, 9, 3, 3, 2, "SAME", 8, 2), (11, 11, 3, 3, 2, "VALID", 8, 2),
            (8, 8, 1, 3, 1, "SAME", 8, 2), (8, 8, 3, 1, 1, "SAME", 8, 2),
            (7, 7, 1, 1, 1, "SAME", 8, 2), (9, 9, 3, 3, 1, "SAME", 30, 1),
            (9, 9, 5, 5, 1, "SAME", 4, 2), (10, 10, 7, 1, 1, "SAME", 4, 2)]


def pa_id(case):
    h, w, k1, k2, stride, padding, c, batch = case
    return f"{h}x{w}_{k1}x{k2}s{stride}{padding}_c{c}b{batch}"


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("case", PA_CASES, ids=[pa_id(c) for c in PA_CASES])
def test_pad_accumulate_bf16_matches_reference(case, epilogue):
    """Phase 2 in bf16: the port takes p unpadded, (G, B, H, W, C), sums
    it in f32, applies the bf16 bias widened and ReLU in f32 and rounds
    once; the reference takes one image's p zero-padded by the caller
    (the images side by side along C, the epilogue being per channel).
    Fed the same bf16 p and bias, the two sum in the same order."""
    h, w, k1, k2, stride, padding, c, batch = case
    o1, o2, pt, _, pl, _ = conv_geometry(h, w, k1, k2, stride, padding)
    rng = _rng(h * 100 + k1 * 10 + k2 + c)
    p = _bf(rng.standard_normal((k1 * k2, batch, h, w, c)))
    bias = _bf(rng.standard_normal(c))
    use_bias = epilogue.startswith("bias")
    got = kn2.pad_accumulate_call(
        p, k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, pad_top=pt,
        pad_left=pl, epilogue=epilogue, bias=bias if use_bias else None)
    assert tuple(got.shape) == (batch, o1, o2, c)
    side = np.concatenate(list(_f32(p).transpose(1, 0, 2, 3, 4)), axis=-1)
    ref = jax_kn2.pad_accumulate(
        _jbf(np.pad(side, ((0, 0), (pt, k1), (pl, k2), (0, 0)))),
        k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, interpret=True,
        epilogue=epilogue,
        bias=_jbf(np.tile(_f32(bias), batch)[None]) if use_bias else None)
    _within_one_ulp(torch.cat(list(got), dim=-1), ref)


# --------------------------------------------------------- whole conv
# The reference's seven conv cases (tests/test_kernels.py:55-58).
CASES = [(14, 14, 8, 16, 3, 3, 1, "SAME"), (28, 28, 4, 8, 5, 5, 1, "SAME"),
         (15, 15, 3, 8, 3, 3, 2, "SAME"), (14, 14, 8, 8, 1, 1, 1, "SAME"),
         (16, 16, 6, 10, 7, 7, 2, "SAME"), (14, 14, 8, 16, 3, 3, 1, "VALID"),
         (10, 10, 6, 10, 1, 7, 1, "SAME")]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[4]}x{c[5]}s{c[6]}{c[7]}_{c[0]}x{c[1]}"
                              for c in CASES])
def test_conv_kn2row_bf16_matches_reference(case):
    """``conv_kn2row`` in bf16 (two images, the batch folded into M) with
    the fused bias and ReLU, against the reference's interpret-mode
    ``conv_kn2row`` on the same bf16 operands."""
    h, w_, ci, co, k1, k2, s, pad = case
    rng = _rng(h + ci + k1 * k2)
    x = rng.standard_normal((2, h, w_, ci))
    w = rng.standard_normal((k1, k2, ci, co)) / np.sqrt(k1 * k2 * ci)
    bias = rng.normal(0, 0.5, co)
    ref = jax_conv_kn2row(_jbf(x), _jbf(w), stride=s, padding=pad,
                          interpret=True, epilogue="bias_relu",
                          bias=_jbf(bias))
    got = conv_kn2row(_bf(x), _bf(w), stride=s, padding=pad,
                      epilogue="bias_relu", bias=_bf(bias))
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    assert tuple(got.shape) == tuple(ref.shape)
    assert _rel(got, ref) <= CONV_REL


# ------------------------------------------------------ the dtype rule
MIXED = [("im2col", algos.IM2COL, jax_algos.IM2COL, CONV_TOL),
         ("kn2row", algos.KN2ROW, jax_algos.KN2ROW, CONV_TOL),
         ("F2x3", algos.WINO_2_3, jax_algos.WINO_2_3, WINO_TOL),
         ("F4x3", algos.WINO_4_3, jax_algos.WINO_4_3, WINO_TOL)]


@pytest.mark.parametrize("backend", [None, "reference"],
                         ids=["kernels", "plain"])
@pytest.mark.parametrize("name,ours,theirs,tol", MIXED,
                         ids=[m[0] for m in MIXED])
def test_f32_input_with_bf16_weights_matches_reference(name, ours, theirs,
                                                       tol, backend):
    """A bf16-weight layer that receives f32 (downstream of an int8 layer
    in a gated plan) widens its weights and bias exactly and runs in f32,
    on the kernels' path and the plain one, against the reference's
    interpret-mode kernels on the same operands: f32 out on both sides."""
    rng = _rng(len(name))
    x = rng.standard_normal((2, 10, 10, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 8)) / np.sqrt(54)
    bias = rng.normal(0, 0.5, 8)
    ref = jax_apply_conv(jnp.asarray(x), _jbf(w), theirs, backend="pallas",
                         interpret=True, epilogue="bias_relu",
                         bias=_jbf(bias))
    got = overlay.apply_conv(torch.from_numpy(x), _bf(w), ours,
                             backend=backend, epilogue="bias_relu",
                             bias=_bf(bias))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("out_scale", [None, 0.05], ids=["f32", "int8"])
@pytest.mark.parametrize("name,ours,theirs",
                         [m[:3] for m in MIXED[:2]],
                         ids=[m[0] for m in MIXED[:2]])
def test_int8_layer_with_bf16_input_matches_reference(name, ours, theirs,
                                                      out_scale):
    """An int8 layer of a bf16 model: bf16 x quantized as it is, bf16
    weights quantized per channel, the bf16 bias in the int8 flush, out
    f32 (or int8 under ``out_scale``), equal to the reference's
    interpret-mode int8 kernels."""
    rng = _rng(7 + len(name))
    x = rng.standard_normal((2, 9, 9, 8))
    w = rng.standard_normal((3, 3, 8, 16)) / np.sqrt(72)
    bias = rng.normal(0, 0.5, 16)
    kw = dict(stride=2, padding="SAME", epilogue="bias_relu",
              precision="int8", in_scale=0.03, out_scale=out_scale)
    ref = jax_apply_conv(_jbf(x), _jbf(w), theirs, backend="pallas",
                         interpret=True, bias=_jbf(bias), **kw)
    got = overlay.apply_conv(_bf(x), _bf(w), ours, bias=_bf(bias), **kw)
    want = np.asarray(ref)
    assert got.dtype == (torch.int8 if out_scale else torch.float32)
    assert want.dtype == (np.int8 if out_scale else np.float32)
    if out_scale:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


def test_bf16_model_layer_refuses_bf16_input_with_f32_weights():
    """No plan gives a layer bf16 x with f32 w: that pair raises, on
    either path."""
    x, w = torch.ones((1, 5, 5, 2), dtype=BF), torch.ones((3, 3, 2, 4))
    for backend in (None, "reference"):
        with pytest.raises(TypeError, match="bf16 w"):
            overlay.apply_conv(x, w, algos.KN2ROW, backend=backend)


@pytest.mark.parametrize("node", ["fc", "global_avg_pool", "max_pool",
                                  "avg_pool"])
def test_non_conv_nodes_take_the_reference_dtypes(node):
    """The non-conv nodes of a gated bf16 plan, on f32 activations (and,
    for the FC, bf16 weights and bias): the reference's dtypes and values
    (its ``@`` promotes f32 x with bf16 w to f32)."""
    rng = _rng(11)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    if node == "fc":
        w, b = rng.standard_normal((288, 10)) / 17, rng.normal(0, 0.1, 10)
        flat = x.reshape(2, -1)
        got = layers.fc(torch.from_numpy(flat), _bf(w), _bf(b))
        ref = jax_layers.fc(jnp.asarray(flat), _jbf(w), _jbf(b))
    elif node == "global_avg_pool":
        got = layers.global_avg_pool(torch.from_numpy(x))
        ref = jax_layers.global_avg_pool(jnp.asarray(x))
    else:
        fn = getattr(layers, node)
        got = fn(torch.from_numpy(x), 3, 2, "SAME")
        ref = getattr(jax_layers, node)(jnp.asarray(x), 3, 2, "SAME")
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    mixed = torch.cat([torch.from_numpy(x), _bf(x)], dim=-1)
    assert mixed.dtype == torch.float32 and jnp.concatenate(
        [jnp.asarray(x), _jbf(x)], axis=-1).dtype == jnp.float32


# ------------------------------------------------------------ programs
def _np_params(graph, seed):
    """He-normal numpy params of ``graph`` rounded to bf16, biases normal
    at 0.05 (so the fused epilogue matters)."""
    rng = _rng(seed)
    params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.conv is not None:
            c = node.conv
            shape, fan_in, fan_out = ((c.k1, c.k2, c.c_in, c.c_out),
                                      c.k1 * c.k2 * c.c_in, c.c_out)
        elif "in_features" in node.attrs:
            fan_in = int(node.attrs["in_features"])
            fan_out = int(node.attrs["out_features"])
            shape = (fan_in, fan_out)
        else:
            continue
        params[nid] = {
            "w": np.asarray(_jbf(rng.standard_normal(shape)
                                 / np.sqrt(fan_in))),
            "b": np.asarray(_jbf(rng.normal(0, 0.05, fan_out)))}
    return params


def _jparams(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


@pytest.fixture(scope="module")
def bf16_iv4():
    """Reduced Inception-v4 (one block of each kind; 38 im2col, 8 kn2row
    and 2 F(4,3) layers) planned by both packages, the same bf16 params on
    both sides, and the reference's bf16 logits of two images through its
    interpret-mode Pallas kernels (elided), compiled through an
    ``ExecutableCache`` that its engine below shares."""
    jg = jax_inception_v4(**IV4)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    g = inception_v4(**IV4)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    np_params = _np_params(jg, seed=0)
    x = _rng(1).standard_normal((2, 75, 75, 3)).astype(np.float32)
    cache = JaxExecutableCache()
    ref = jax_compile_plan(jg, jplan, epilogue="bias_relu", tuning_batch=2,
                           use_pallas=True, cache=cache)(
        _jparams(np_params), _jbf(x))
    return g, plan, jg, jplan, np_params, x, ref, cache


@pytest.mark.parametrize("elide", [True, False])
def test_inception_v4_bf16_compile_plan_matches_reference(bf16_iv4, elide):
    """Reduced Inception-v4 in bf16 through ``compile_plan(dtype=bf16)``,
    elided (redA/b3a's kn2row stores the next layer's Toeplitz matrix) and
    not, against the reference's bf16 ``compile_plan`` on its
    interpret-mode kernels (elided; elision only moves data)."""
    g, plan, _, _, np_params, x, ref, _ = bf16_iv4
    mix = collections.Counter(a.key for a in plan.assignment.values())
    assert mix == {"im2col": 38, "kn2row": 8, "winograd(F4x3)": 2}
    run = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=2, dtype=BF, device="cpu")
    got = run(params_from_jax(np_params, "cpu"), _bf(x))
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    assert tuple(got.shape) == tuple(ref.shape) == (2, 1000)
    assert _rel(got, ref) <= FORWARD_REL


@pytest.fixture(scope="module")
def gated_iv4(bf16_iv4):
    """The gated plan of the bf16 reduced Inception-v4 on both sides:
    activation scales from each package's ``calibrate_act_scales`` on the
    same two bf16 images (the reference's eager walk takes ~35 s of this
    fixture), the plan from ``map_network(quantize=True,
    force_bf16=FORCE_BF16)``; and the reference's logits of that plan on
    its interpret-mode kernels (its own scales, elided, bucket 2)."""
    g, _, jg, _, np_params, x, _, cache = bf16_iv4
    names = {g.nodes[n].name: n for n in g.nodes}
    force = sorted(names[n] for n in FORCE_BF16)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512),
                       quantize=True, force_bf16=force)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512),
                            quantize=True, force_bf16=force)
    params = params_from_jax(np_params, "cpu")
    scales = calibrate_act_scales(g, params, _bf(x))
    jscales = jax_calibrate(jg, _jparams(np_params), _jbf(x))
    ref = jax_compile_plan(jg, jplan, epilogue="bias_relu", tuning_batch=2,
                           use_pallas=True, act_scales=jscales,
                           cache=cache)(_jparams(np_params), _jbf(x))
    return plan, jplan, scales, jscales, ref


@pytest.mark.parametrize("elide", [True, False])
def test_gated_bf16_inception_v4_matches_reference(bf16_iv4, gated_iv4,
                                                   elide, monkeypatch):
    """The gated plan of bf16 params: int8 im2col and kn2row layers (the
    first, stem/c1, on the bf16 input image) and bf16 layers (im2col,
    kn2row and F(4,3)) downstream of int8 ones, which receive f32.
    Compiled for bf16, elided and not, it returns f32 logits within the
    reference's whole-plan tolerance of the reference's. Both programs
    take the reference's scales: the two packages' plain bf16 walks round
    some activations to neighbouring bf16 values, so an abs-max, and its
    scale, may lie one bf16 ulp apart (0.56% here at most)."""
    g, _, _, _, np_params, x, _, _ = bf16_iv4
    plan, jplan, scales, jscales, ref = gated_iv4
    assert plan.precisions == jplan.precisions
    assert {n: a.key for n, a in plan.assignment.items()} == {
        n: a.key for n, a in jplan.assignment.items()}
    assert sorted(scales) == sorted(jscales)
    for nid, s in jscales.items():
        assert scales[nid] == pytest.approx(s, rel=BF16_ULP)
    seen = collections.Counter()
    apply_conv = overlay.apply_conv

    def spy(x_, w, algo, *args, **kw):
        seen[(algo.family.value, kw.get("precision"), str(x_.dtype))] += 1
        return apply_conv(x_, w, algo, *args, **kw)

    monkeypatch.setattr(overlay, "apply_conv", spy)
    run = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=2, act_scales=jscales, dtype=BF,
                       device="cpu")
    got = run(params_from_jax(np_params, "cpu"), _bf(x))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)
    f32_in = {fam for fam, prec, dt in seen
              if prec == "bf16" and dt == "torch.float32"}
    assert f32_in == {"im2col", "kn2row", "winograd"}
    assert ("im2col", "int8", "torch.bfloat16") in seen
    int8 = {fam for fam, prec, _ in seen if prec == "int8"}
    assert int8 == {"im2col", "kn2row"}


def test_gate_on_bf16_vgg16_matches_reference():
    """``plan_mixed_precision`` on bf16 params (reduced VGG16, the same
    two bf16 calibration images): the same scales, isolated errors,
    demotions, rounds and precisions as the reference's gate, at a
    tolerance at least 1e-3 from every isolated error."""
    g, jg = vgg16(res=8, scale=0.05), jax_vgg16(res=8, scale=0.05)
    np_params = _np_params(jg, seed=0)
    x = _rng(1).standard_normal((2, 8, 8, 3)).astype(np.float32)
    report = plan_mixed_precision(
        g, params_from_jax(np_params, "cpu"), _bf(x), tol=VGG_GATE_TOL,
        hw=identify_parameters(g, max_dim=512))
    jreport = jax_gate(jg, _jparams(np_params), _jbf(x), tol=VGG_GATE_TOL,
                       hw=jax_identify(jg, max_dim=512))
    assert min(abs(e - VGG_GATE_TOL) for e in jreport.errors.values()) \
        >= 1e-3
    for nid, s in jreport.act_scales.items():
        assert report.act_scales[nid] == pytest.approx(s, rel=1e-6)
    for nid, e in jreport.errors.items():
        assert report.errors[nid] == pytest.approx(e, abs=1e-6)
    assert report.demoted == jreport.demoted and report.demoted
    assert report.rounds == jreport.rounds
    assert report.plan.precisions == jreport.plan.precisions
    assert report.precision_mix == jreport.precision_mix


@pytest.mark.parametrize("gated", [False, True], ids=["bf16", "gated"])
def test_inception_v4_bf16_engine_matches_reference_engine(
        bf16_iv4, gated_iv4, gated):
    """Both engines in bf16 serve the same four requests on reduced
    Inception-v4 (buckets of 2; the reference's on its interpret-mode
    kernels, the programs the fixtures compiled): the bf16 plan and its
    gated twin (with the reference's scales on both sides), the same
    dispatches and outcomes, every result within the plan's tolerance."""
    g, plan, jg, jplan, np_params, _, _, cache = bf16_iv4
    scales = None
    if gated:
        plan, jplan, _, scales, _ = gated_iv4
    images = _rng(2).standard_normal((4, 75, 75, 3)).astype(np.float32)
    hits = cache.hits
    ours = CNNServingEngine(g, params_from_jax(np_params, "cpu"), plan,
                            batch_size=2, buckets=(2,), act_scales=scales,
                            dtype=BF, device="cpu")
    ref = JaxEngine(jg, _jparams(np_params), jplan, batch_size=2,
                    buckets=(2,), use_pallas=True, dtype=jnp.bfloat16,
                    act_scales=scales, cache=cache)
    for engine, req in ((ours, CNNRequest), (ref, JaxRequest)):
        for rid, img in enumerate(images):
            engine.submit(req(rid=rid, image=img))
        engine.run_until_done()
    assert cache.hits == hits + 1
    assert ours.dispatches == ref.dispatches
    assert sorted(ours.done) == sorted(ref.done) == list(range(4))
    assert ours.stats()["precision"] == ref.stats()["precision"]
    got = np.stack([ours.done[i] for i in range(4)])
    want = np.stack([np.asarray(ref.done[i], np.float32) for i in range(4)])
    assert got.dtype == np.float32
    if gated:
        np.testing.assert_allclose(got, want, **PLAN_TOL)
    else:
        assert _rel(got, want) <= FORWARD_REL
