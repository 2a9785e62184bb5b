"""The Winograd path in bf16: the port's bf16 Winograd transforms and
batched GEMM (their plain versions here, on the CPU), ``conv_winograd`` on
its three routes and reduced VGG16 with bf16 params, against the JAX
reference's bf16 Pallas kernels in interpret mode.

The reference's kernels are dtype-generic: each loads bf16, works in f32
and rounds once when it stores, and its Winograd pipeline rounds V, U (the
kernel transform, computed in f32) and M to the activation dtype and the
output once after the epilogue (``src/repro/kernels/winograd/ops.py``).
The port rounds at the same points. Inputs are made with numpy from a
seed; each stage is fed the reference's own bf16 inputs, so a stage is
held alone. Stages are held within one bf16 ulp (rtol 2^-7, atol 1e-4 of
the output's max: two f32 sums in another order may round to neighbouring
bf16 values), whole convs and forwards within the reference's bf16
tolerance, 5e-2 of the largest value (``tests/test_kernels.py:41``).
Measured here: every stage bit-equal but U of F(4,3) (5 of 1152 values one
ulp apart: XLA's jitted kernel transform orders its f32 sums otherwise),
the convs bit-equal but F(4,3)'s (1.7e-2: those U values, through Aᵀ M
A), reduced VGG16 3.8e-3 of the largest logit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import ExecutableCache as JaxExecutableCache
from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import vgg16 as jax_vgg16
from repro.core.dse import identify_parameters as jax_identify
from repro.core.layouts import LayoutSpec as JaxLayoutSpec
from repro.core.mapper import map_network as jax_map_network
from repro.kernels.gemm.ops import batched_gemm as jax_batched_gemm
from repro.kernels.layouts import materialize as jax_materialize
from repro.kernels.winograd import winograd as jax_wino
from repro.kernels.winograd.ops import conv_winograd as jax_conv_winograd
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import compile_plan
from repro_torch.cnn.models import vgg16
from repro_torch.core.algorithms import AlgoFamily
from repro_torch.core.dse import identify_parameters
from repro_torch.core.layouts import LayoutSpec
from repro_torch.core.mapper import map_network
from repro_torch.kernels.gemm.ops import batched_gemm
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.kernels.winograd import winograd as wino
from repro_torch.kernels.winograd.ops import conv_winograd
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
# The port's bf16 forward against its f32 forward of the same weights:
# the bf16 semantics' own deviation, measured 4.5e-3 of the largest logit
# on reduced VGG16 here (the reference's bf16 run lies as far from its
# f32 run, 4.5e-3); the bound is the reference's bf16 tolerance.
BF16_VS_F32_REL = 5e-2


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
    assert got.dtype == BF
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=BF16_ULP,
                               atol=1e-4 * float(np.abs(want).max()))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# The reference's Winograd cases (tests/test_kernels.py:91-96): (H, W, Cin,
# Cout, K, m, padding).
CASES = [(14, 14, 8, 16, 3, 2, "SAME"), (12, 12, 4, 8, 3, 4, "SAME"),
         (14, 14, 8, 16, 3, 2, "VALID"), (13, 11, 5, 7, 3, 2, "SAME"),
         (14, 14, 4, 8, 5, 2, "SAME"), (12, 12, 3, 6, 7, 2, "SAME")]
IDS = [f"{c[4]}x{c[4]}F{c[5]}{c[6]}_{c[0]}x{c[1]}" for c in CASES]


def _geometry(h, w, m, padding, r=3):
    o1, o2 = (h, w) if padding == "SAME" else (h - r + 1, w - r + 1)
    pad = (r - 1) // 2 if padding == "SAME" else 0
    return o1, o2, pad, -(-o1 // m), -(-o2 // m)


def _inputs(case):
    """One image, weights and a bias of ``case`` (f32 numpy, from a seed)."""
    h, w_, ci, co, k, m, _ = case
    rng = _rng(k * 1000 + h * 10 + ci + m)
    return (rng.standard_normal((h, w_, ci)),
            rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci),
            rng.normal(0, 0.5, co))


def _spec(case, cls):
    h, w_, ci, _, _, m, pad = case
    return cls(kind="winograd", h=h, w=w_, c=ci, k1=3, k2=3, stride=1,
               padding=pad, m=m, r=3)


@functools.lru_cache(maxsize=None)
def _reference(index: int):
    """The reference's bf16 pipeline on ``CASES[index]`` (K 3), every
    stage's output, in one jitted call of its interpret-mode kernels (one
    compile a case, shared by the tests below): V from the host-padded map
    and V from the stored tiles, U, M, and the conv's output with bias and
    ReLU by the NHWC route and by the tile route."""
    case = CASES[index]
    h, w_, _, _, _, m, pad = case
    o1, o2, p, ty, tx = _geometry(h, w_, m, pad)
    spec = _spec(case, JaxLayoutSpec)

    def out(mm, bias):
        return jax_wino.output_transform(
            mm, m=m, r=3, tiles_y=ty, tiles_x=tx, interpret=True,
            epilogue="bias_relu", bias=bias[None])[:o1, :o2]

    @jax.jit
    def run(x, w, bias):
        xp = jnp.pad(x, ((p, max(0, ty * m + 2 - h - p)),
                         (p, max(0, tx * m + 2 - w_ - p)), (0, 0)))
        v = jax_wino.input_transform(xp, m=m, r=3, tiles_y=ty, tiles_x=tx,
                                     interpret=True)
        tiles = jax_materialize(x, spec)
        vt = jax_wino.input_transform_tiles(tiles, m=m, r=3, tiles_y=ty,
                                            tiles_x=tx, interpret=True)
        u = jax_wino.transform_kernel_weights(w, m, 3).astype(jnp.bfloat16)
        mm = jax_batched_gemm(v, u, interpret=True, out_dtype=jnp.bfloat16)
        mmt = jax_batched_gemm(vt, u, interpret=True,
                               out_dtype=jnp.bfloat16)
        return dict(v=v, tiles=tiles, vt=vt, u=u, mm=mm, y=out(mm, bias),
                    y_tiles=out(mmt, bias))

    x, w, bias = _inputs(case)
    return {k: _f32(a) for k, a in run(_jbf(x), _jbf(w), _jbf(bias)).items()}


# ------------------------------------------------------------ kernels
@pytest.mark.parametrize("index", range(4), ids=IDS[:4])
def test_bf16_stages_match_reference_kernels(index):
    """Each bf16 kernel's plain version against the reference's bf16
    kernel, fed the reference's own inputs: the input transform (the port
    reads the unpadded map with the halo as offsets, the reference the
    host-padded map), the tiles transform (on the stored tile layout,
    whose bf16 round trip is exact), U, the batched GEMM and the output
    transform with bias and ReLU."""
    case = CASES[index]
    h, w_, _, co, _, m, pad = case
    o1, o2, p, ty, tx = _geometry(h, w_, m, pad)
    x, w, bias = _inputs(case)
    ref = _reference(index)
    v = wino.input_transform_call(_bf(x)[None], m=m, tiles_y=ty, tiles_x=tx,
                                  pad_top=p, pad_left=p)
    assert tuple(v.shape) == ref["v"].shape
    _within_one_ulp(v, ref["v"])
    tiles = materialize(_bf(x), _spec(case, LayoutSpec))
    assert tiles.dtype == BF
    np.testing.assert_array_equal(_f32(tiles), ref["tiles"])
    assert torch.equal(restore(tiles, _spec(case, LayoutSpec)), _bf(x))
    _within_one_ulp(wino.input_transform_tiles_call(tiles, m=m), ref["vt"])
    _within_one_ulp(wino.transform_kernel_weights(_bf(w), m, 3).to(BF),
                    ref["u"])
    _within_one_ulp(batched_gemm(_bf(ref["v"]), _bf(ref["u"])), ref["mm"])
    got = wino.output_transform_call(
        _bf(ref["mm"]), m=m, tiles_y=ty, tiles_x=tx, o1=o1, o2=o2,
        epilogue="bias_relu", bias=_bf(bias))
    assert tuple(got.shape) == (1, o1, o2, co)
    _within_one_ulp(got[0], ref["y"])


# --------------------------------------------------------- whole conv
@pytest.mark.parametrize("index", range(len(CASES)), ids=IDS)
def test_conv_winograd_bf16_matches_reference(index):
    """``conv_winograd`` in bf16 on the NHWC route (K 3) and the
    multi-round route (K 5, 7: each round's output rounded to bf16 and
    summed in bf16, the epilogue after the sum), against the reference's
    pipeline on the same bf16 operands, within its bf16 tolerance."""
    case = CASES[index]
    k, m, pad = case[4:]
    x, w, bias = _inputs(case)
    if k == 3:
        want = _reference(index)["y"]
    else:
        want = jax_conv_winograd(_jbf(x), _jbf(w), m=m, padding=pad,
                                 interpret=True, epilogue="bias_relu",
                                 bias=_jbf(bias))
    got = conv_winograd(_bf(x), _bf(w), m=m, padding=pad,
                        epilogue="bias_relu", bias=_bf(bias))
    assert got.dtype == BF and tuple(got.shape) == want.shape
    assert _rel(got, want) <= FORWARD_REL


@pytest.mark.parametrize("index", [0, 1], ids=["F2", "F4"])
def test_conv_winograd_bf16_tile_route_matches_reference(index):
    """The matched tile layout: a bf16 layer reads its stored tiles (the
    tiles transform) and stores the next layer's (an F(4,3) tile layout),
    against the reference's pipeline from the same tiles."""
    case = CASES[index]
    x, w, bias = _inputs(case)
    spec_in = _spec(case, LayoutSpec)
    spec_out = LayoutSpec(kind="winograd", h=case[0], w=case[1], c=case[3],
                          k1=3, k2=3, stride=1, padding="SAME", m=4, r=3)
    got = conv_winograd(materialize(_bf(x), spec_in), _bf(w), m=case[5],
                        epilogue="bias_relu", bias=_bf(bias),
                        in_layout=spec_in, out_layout=spec_out)
    assert got.dtype == BF and tuple(got.shape) == (
        spec_out.tiles_y * spec_out.tiles_x, 6, 6, case[3])
    assert _rel(restore(got, spec_out), _reference(index)["y_tiles"]) <= \
        FORWARD_REL


# ------------------------------------------------------------ programs
def _np_params(graph, seed):
    """He-normal numpy params of ``graph`` rounded to bf16, conv biases
    normal at 0.05 (so the fused epilogue matters)."""
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


@pytest.fixture(scope="module")
def bf16_vgg():
    """VGG16 at 32², width 0.125 (as ``tests/test_torch_winograd.py``),
    planned by both packages (im2col and Winograd), the same bf16 params
    on both sides, and the reference's bf16 logits of two images through
    its Pallas kernels in interpret mode (``use_pallas=True``: the
    pipeline whose rounding points the port's kernels keep; elided, the
    lowering's default), compiled through an ``ExecutableCache`` that the
    reference's engine below shares, so it compiles once."""
    res, scale = 32, 0.125
    jg = jax_vgg16(res=res, scale=scale)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    g = vgg16(res=res, scale=scale)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    np_params = _np_params(jg, seed=0)
    x = _rng(1).standard_normal((2, res, res, 3)).astype(np.float32)
    cache = JaxExecutableCache()
    ref = jax_compile_plan(jg, jplan, epilogue="bias_relu", tuning_batch=2,
                           use_pallas=True, cache=cache)(
        jax.tree_util.tree_map(jnp.asarray, np_params), _jbf(x))
    return g, plan, jg, jplan, np_params, x, ref, cache


@pytest.mark.parametrize("elide", [True, False])
def test_vgg16_bf16_compile_plan_matches_reference(bf16_vgg, elide):
    """Reduced VGG16 in bf16 through ``compile_plan(dtype=bf16)``, elided
    (the Winograd layers read stored tiles) and not, against the
    reference's bf16 ``compile_plan`` on its interpret-mode kernels
    (elided; elision only moves data, so the reference's unelided logits
    are the same bits), and against the port's own f32 forward of the
    same weights widened."""
    g, plan, _, _, np_params, x, ref, _ = bf16_vgg
    assert {a.family for a in plan.assignment.values()} == {
        AlgoFamily.IM2COL, AlgoFamily.WINOGRAD}
    params = params_from_jax(np_params, "cpu")
    run = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=2, dtype=BF, device="cpu")
    got = run(params, _bf(x))
    assert got.dtype == BF and tuple(got.shape) == (2, 1000)
    reads_tiles = [n for n, low in run.lowering.items()
                   if low.in_layout is not None
                   and low.in_layout.kind == "winograd"]
    assert bool(reads_tiles) == elide
    assert _rel(got, ref) <= FORWARD_REL
    widened = {nid: {k: t.float() for k, t in layer.items()}
               for nid, layer in params.items()}
    f32 = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=2, device="cpu")(widened, x)
    assert 0 < _rel(got, f32) <= BF16_VS_F32_REL


def test_vgg16_bf16_engine_matches_reference_engine(bf16_vgg):
    """Both engines in bf16 serve the same four requests on reduced VGG16
    (buckets of 2; the reference's on its interpret-mode kernels, the
    program the fixture compiled): the same dispatches, every result
    within the bf16 tolerance."""
    g, plan, jg, jplan, np_params, _, _, cache = bf16_vgg
    images = _rng(2).standard_normal((4, 32, 32, 3)).astype(np.float32)
    ours = CNNServingEngine(g, params_from_jax(np_params, "cpu"), plan,
                            batch_size=2, buckets=(2,), dtype=BF,
                            device="cpu")
    ref = JaxEngine(jg, jax.tree_util.tree_map(jnp.asarray, np_params),
                    jplan, batch_size=2, buckets=(2,), use_pallas=True,
                    dtype=jnp.bfloat16, cache=cache)
    assert cache.hits == 1
    for engine, req in ((ours, CNNRequest), (ref, JaxRequest)):
        for rid, img in enumerate(images):
            engine.submit(req(rid=rid, image=img))
        engine.run_until_done()
    assert ours.dispatches == ref.dispatches
    got = np.stack([ours.done[i] for i in range(4)])
    want = np.stack([np.asarray(ref.done[i], np.float32) for i in range(4)])
    assert got.dtype == np.float32
    assert _rel(got, want) <= FORWARD_REL
