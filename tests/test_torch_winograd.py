"""The port's Winograd path against the JAX reference on the CPU.

Inputs are made with numpy from a seed and fed to both sides; the
reference's Pallas kernels run in interpret mode and the port runs each
kernel's plain version (CPU tensors). Tolerances are the reference's:
1e-4 for f32 kernels, 2e-3 for a whole Winograd conv, rtol 2e-2 / atol
2e-3 for whole plans; layout conversions are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import vgg16 as jax_vgg16
from repro.cnn.overlay import apply_conv as jax_apply_conv
from repro.core.algorithms import WINO_2_3 as JAX_WINO_2_3
from repro.core.algorithms import WINO_4_3 as JAX_WINO_4_3
from repro.core.cost_model import Dataflow as JaxDataflow
from repro.core.dse import identify_parameters as jax_identify
from repro.core.layouts import LayoutSpec as JaxLayoutSpec
from repro.core.mapper import map_network as jax_map_network
from repro.kernels.conv_im2col.ref import conv_ref as jax_conv_ref
from repro.kernels.gemm.ops import batched_gemm as jax_batched_gemm
from repro.kernels.layouts import materialize as jax_materialize
from repro.kernels.layouts import restore as jax_restore
from repro.kernels.winograd import ref as jax_ref
from repro.kernels.winograd import winograd as jax_wino
from repro.kernels.winograd.ops import conv_winograd as jax_conv_winograd
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import compile_plan
from repro_torch.cnn.models import vgg16
from repro_torch.cnn.overlay import apply_conv
from repro_torch.core.algorithms import WINO_2_3, WINO_4_3, AlgoFamily
from repro_torch.core.cost_model import Dataflow
from repro_torch.core.dse import identify_parameters
from repro_torch.core.layouts import LayoutSpec
from repro_torch.core.mapper import map_network
from repro_torch.kernels.conv_im2col.ref import conv_ref
from repro_torch.kernels.gemm.gemm import (batched_gemm_call,
                                          batched_gemm_plain)
from repro_torch.kernels.gemm.ops import batched_gemm
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.kernels.winograd import winograd as wino
from repro_torch.kernels.winograd.ops import conv_winograd
from repro_torch.kernels.winograd.ref import (winograd_from_tiles_ref,
                                              winograd_ref)
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


TOL = dict(rtol=1e-4, atol=1e-4)
WINO_TOL = dict(rtol=2e-3, atol=2e-3)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)


def rnd(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def _geometry(h, w, m, padding="SAME", r=3):
    """(o1, o2, pad, tiles_y, tiles_x) as the reference's single-round
    core computes them."""
    o1, o2 = (h, w) if padding == "SAME" else (h - r + 1, w - r + 1)
    pad = (r - 1) // 2 if padding == "SAME" else 0
    ty, tx = -(-o1 // m), -(-o2 // m)
    return o1, o2, pad, ty, tx


def _np_pad(x, pad, ty, tx, m, r=3):
    h, w = x.shape[-3], x.shape[-2]
    need_r, need_c = ty * m + r - 1, tx * m + r - 1
    widths = [(0, 0)] * (x.ndim - 3) + [
        (pad, max(0, need_r - h - pad)), (pad, max(0, need_c - w - pad)),
        (0, 0)]
    return np.pad(x, widths)


# ------------------------------------------------------- kernels' plain
@pytest.mark.parametrize("m", [2, 4])
def test_matrices_and_kernel_transform_match_reference(m):
    for ours, ref in zip(wino.matrices(m, 3), jax_wino.matrices(m, 3)):
        np.testing.assert_array_equal(ours, ref)
    w = rnd(1, 3, 3, 5, 7)
    np.testing.assert_allclose(
        wino.transform_kernel_weights(t(w), m, 3).numpy(),
        np.asarray(jax_wino.transform_kernel_weights(jnp.asarray(w), m, 3)),
        **TOL)
    with pytest.raises(ValueError, match="not supported"):
        wino.matrices(3, 3)


INPUT_CASES = [(2, 14, 14, 8, "SAME"), (4, 14, 14, 8, "SAME"),
               (4, 13, 11, 5, "SAME"), (2, 12, 12, 4, "VALID"),
               (4, 9, 10, 3, "VALID")]


@pytest.mark.parametrize("case", INPUT_CASES,
                         ids=[f"F{c[0]}_{c[1]}x{c[2]}{c[4]}"
                              for c in INPUT_CASES])
def test_input_transform_plain_matches_reference(case):
    """The port reads the unpadded map with the halo and the bottom/right
    fill as offsets; the reference transforms the host-padded map."""
    m, h, w, c, padding = case
    _, _, pad, ty, tx = _geometry(h, w, m, padding)
    x = rnd(2, 2, h, w, c)
    got = wino.input_transform_call(t(x), m=m, tiles_y=ty, tiles_x=tx,
                                    pad_top=pad, pad_left=pad)
    assert tuple(got.shape) == ((m + 2) ** 2, 2 * ty * tx, c)
    for b in range(2):
        ref = jax_wino.input_transform(
            jnp.asarray(_np_pad(x[b], pad, ty, tx, m)), m=m, r=3,
            tiles_y=ty, tiles_x=tx, interpret=True)
        np.testing.assert_allclose(
            got[:, b * ty * tx:(b + 1) * ty * tx].numpy(), np.asarray(ref),
            **TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_input_transform_tiles_plain_matches_reference(m):
    ty, tx, c = 3, 4, 6
    tiles = rnd(3, ty * tx, m + 2, m + 2, c)
    ref = jax_wino.input_transform_tiles(jnp.asarray(tiles), m=m, r=3,
                                         tiles_y=ty, tiles_x=tx,
                                         interpret=True)
    got = wino.input_transform_tiles_call(t(tiles), m=m)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), wino.input_transform_tiles_plain(t(tiles), m=m).numpy())


@pytest.mark.parametrize("epilogue", ["none", "relu", "bias_relu"])
@pytest.mark.parametrize("m,ty,tx,o1,o2", [(2, 3, 4, 6, 8), (4, 4, 3, 14, 9),
                                           (4, 2, 2, 5, 8)])
def test_output_transform_plain_matches_reference(m, ty, tx, o1, o2,
                                                  epilogue):
    """Batched M (two images' tiles); the reference writes the whole tile
    grid and crops on the host, the port writes (B, o1, o2, C)."""
    c = 5
    mm = rnd(4, (m + 2) ** 2, 2 * ty * tx, c)
    bias = rnd(5, c)
    use_bias = epilogue.startswith("bias")
    got = wino.output_transform_call(
        t(mm), m=m, tiles_y=ty, tiles_x=tx, o1=o1, o2=o2, epilogue=epilogue,
        bias=t(bias) if use_bias else None)
    assert tuple(got.shape) == (2, o1, o2, c)
    for b in range(2):
        ref = jax_wino.output_transform(
            jnp.asarray(mm[:, b * ty * tx:(b + 1) * ty * tx]), m=m, r=3,
            tiles_y=ty, tiles_x=tx, interpret=True, epilogue=epilogue,
            bias=jnp.asarray(bias[None]) if use_bias else None)
        np.testing.assert_allclose(got[b].numpy(),
                                   np.asarray(ref)[:o1, :o2], **TOL)


@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
@pytest.mark.parametrize("df", ["NS", "WS", "IS"])
@pytest.mark.parametrize("gmkn", [(16, 37, 20, 45), (36, 130, 64, 129)])
def test_batched_gemm_matches_reference(gmkn, df, epilogue):
    """Ragged (G, M, K, N): the reference pads to its blocks and crops;
    the port masks edges in the kernel and pads nothing."""
    g, m, k, n = gmkn
    a, b = rnd(6, g, m, k), rnd(7, g, k, n, scale=k ** -0.5)
    bias = rnd(8, n)
    use_bias = epilogue.startswith("bias")
    ref = jax_batched_gemm(jnp.asarray(a), jnp.asarray(b), JaxDataflow[df],
                           interpret=True, epilogue=epilogue,
                           bias=jnp.asarray(bias) if use_bias else None)
    got = batched_gemm(t(a), t(b), Dataflow[df], epilogue=epilogue,
                       bias=t(bias) if use_bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        got.numpy(),
        batched_gemm_plain(t(a), t(b), epilogue,
                           t(bias) if use_bias else None).numpy())


def test_winograd_wrappers_validate_and_reject_other_devices():
    meta = torch.empty(1, 4, 4, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wino.input_transform_call(meta, m=2, tiles_y=2, tiles_x=2)
    with pytest.raises(ValueError, match="unsupported device"):
        wino.input_transform_tiles_call(meta, m=2)
    with pytest.raises(ValueError, match="unsupported device"):
        wino.output_transform_call(torch.empty(16, 4, 1, device="meta"),
                                   m=2, tiles_y=2, tiles_x=2, o1=4, o2=4)
    with pytest.raises(ValueError, match="unsupported device"):
        batched_gemm_call(torch.empty(2, 3, 4, device="meta"),
                          torch.empty(2, 4, 5, device="meta"))
    with pytest.raises(ValueError, match="needs a bias"):
        wino.output_transform_call(torch.zeros(16, 4, 1), m=2, tiles_y=2,
                                   tiles_x=2, o1=4, o2=4, epilogue="bias")
    with pytest.raises(ValueError, match="not supported"):
        wino.input_transform_call(torch.zeros(1, 4, 4, 1), m=3, tiles_y=2,
                                  tiles_x=2)


@pytest.mark.parametrize("tiling,match", [
    (dict(tiles_y=2, tiles_x=2, pad_top=-1, pad_left=0), "negative pad"),
    (dict(tiles_y=0, tiles_x=2), "empty tile grid")])
def test_input_transform_rejects_bad_tiling(tiling, match):
    """The tile grid and halo are checked before either path runs."""
    with pytest.raises(ValueError, match=match):
        wino.input_transform_call(torch.zeros(1, 4, 4, 1), m=2, **tiling)


# --------------------------------------------------------- whole conv
WINO_CASES = [(14, 14, 8, 16, 3, 2, "SAME"), (12, 12, 4, 8, 3, 4, "SAME"),
              (14, 14, 8, 16, 3, 2, "VALID"), (13, 11, 5, 7, 3, 2, "SAME"),
              (14, 14, 4, 8, 5, 2, "SAME"), (12, 12, 3, 6, 7, 2, "SAME")]


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", WINO_CASES,
                         ids=[f"{c[4]}x{c[4]}F{c[5]}{c[6]}_{c[0]}x{c[1]}"
                              for c in WINO_CASES])
def test_conv_winograd_matches_reference(case, batch):
    """The reference's six cases (F(2,3)/F(4,3), SAME/VALID, odd 13×11,
    5×5 and 7×7 multi-round), batched and not, against the reference's
    ``conv_winograd`` and the direct conv at the Winograd tolerance."""
    h, w_, ci, co, k, m, pad = case
    lead = () if batch is None else (batch,)
    x, w = rnd(9, *lead, h, w_, ci), rnd(10, k, k, ci, co)
    bias = rnd(11, co, scale=0.5)
    ref = jax_conv_winograd(jnp.asarray(x), jnp.asarray(w), m=m, padding=pad,
                            interpret=True, epilogue="bias_relu",
                            bias=jnp.asarray(bias))
    got = conv_winograd(t(x), t(w), m=m, padding=pad, epilogue="bias_relu",
                        bias=t(bias))
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **WINO_TOL)
    direct = np.maximum(np.asarray(jax_conv_ref(
        jnp.asarray(x), jnp.asarray(w), stride=1, padding=pad)) + bias, 0)
    np.testing.assert_allclose(got.numpy(), direct, **WINO_TOL)
    plain = conv_winograd(t(x), t(w), m=m, padding=pad, epilogue="bias_relu",
                          bias=t(bias), plain=True)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    if k == 3:
        np.testing.assert_allclose(
            winograd_ref(t(x), t(w), m=m, padding=pad).numpy(),
            np.asarray(jax_ref.winograd_ref(jnp.asarray(x), jnp.asarray(w),
                                            m=m, padding=pad)), **TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_winograd_from_tiles_ref_matches_reference(m):
    spec = LayoutSpec(kind="winograd", h=10, w=9, c=4, k1=3, k2=3, m=m, r=3)
    x, w = rnd(12, 2, 10, 9, 4), rnd(13, 3, 3, 4, 6)
    tiles = materialize(t(x), spec)
    got = winograd_from_tiles_ref(tiles, t(w), m, spec.tiles_y,
                                  spec.tiles_x, spec.o1, spec.o2)
    for b in range(2):
        ref = jax_ref.winograd_from_tiles_ref(
            jnp.asarray(tiles[b].numpy()), jnp.asarray(w), m, spec.tiles_y,
            spec.tiles_x, spec.o1, spec.o2)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               conv_ref(t(x), t(w)).numpy(), **WINO_TOL)


# --------------------------------------------------------------- layouts
TILE_CASES = [(12, 12, 4, 2, "SAME"), (13, 11, 5, 4, "SAME"),
              (14, 14, 3, 4, "SAME"), (9, 9, 2, 2, "VALID"),
              (10, 7, 3, 4, "VALID")]


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", TILE_CASES)
def test_winograd_tile_layout_round_trip_is_exact(case, batch):
    h, w, c, m, pad = case
    kw = dict(kind="winograd", h=h, w=w, c=c, k1=3, k2=3, stride=1,
              padding=pad, m=m, r=3)
    spec, jspec = LayoutSpec(**kw), JaxLayoutSpec(**kw)
    lead = () if batch is None else (batch,)
    x = rnd(14, *lead, h, w, c)
    tiles = materialize(t(x), spec)
    assert tuple(tiles.shape) == (*lead, spec.tiles_y * spec.tiles_x,
                                  m + 2, m + 2, c)
    ref = jax_materialize(jnp.asarray(x), jspec)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(ref))
    back = restore(tiles, spec)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_restore(jnp.asarray(tiles.numpy()),
                                             jspec)))


# ---------------------------------------------------------------- overlay
@pytest.mark.parametrize("backend", [None, "reference", "lax"])
@pytest.mark.parametrize("algo,jalgo", [(WINO_2_3, JAX_WINO_2_3),
                                        (WINO_4_3, JAX_WINO_4_3)],
                         ids=["F2", "F4"])
def test_apply_conv_winograd_layouts_match_reference(algo, jalgo, backend):
    """Matched tile ``in_layout`` and a tile ``out_layout`` for the next
    layer, batched, on every backend, against the reference overlay."""
    kw = dict(kind="winograd", k1=3, k2=3, m=algo.m, r=3)
    spec_in = dict(h=12, w=10, c=6, **kw)
    spec_out = dict(h=12, w=10, c=8, **{**kw, "m": 4})
    x, w = rnd(15, 2, 12, 10, 6), rnd(16, 3, 3, 6, 8, scale=0.3)
    bias = rnd(17, 8, scale=0.5)
    jx = jax_materialize(jnp.asarray(x), JaxLayoutSpec(**spec_in))
    ref = jax_apply_conv(jx, jnp.asarray(w), jalgo, backend=backend,
                         epilogue="bias_relu", bias=jnp.asarray(bias),
                         in_layout=JaxLayoutSpec(**spec_in),
                         out_layout=JaxLayoutSpec(**spec_out))
    got = apply_conv(materialize(t(x), LayoutSpec(**spec_in)), t(w), algo,
                     backend=backend, epilogue="bias_relu", bias=t(bias),
                     in_layout=LayoutSpec(**spec_in),
                     out_layout=LayoutSpec(**spec_out))
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **WINO_TOL)


@pytest.mark.parametrize("backend", [None, "reference"])
def test_apply_conv_winograd_multi_round_matches_reference(backend):
    """K > r: the reference's "reference" backend runs the multi-round
    pipeline in interpret mode; the port runs its plain stages."""
    x, w = rnd(18, 2, 11, 11, 4), rnd(19, 5, 5, 4, 6, scale=0.2)
    bias = rnd(20, 6)
    ref = jax_apply_conv(jnp.asarray(x), jnp.asarray(w), JAX_WINO_2_3,
                         backend=backend, interpret=True, epilogue="bias",
                         bias=jnp.asarray(bias))
    got = apply_conv(t(x), t(w), WINO_2_3, backend=backend, epilogue="bias",
                     bias=t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **WINO_TOL)


def test_apply_conv_winograd_rejects_strided_and_int8():
    x = torch.zeros(8, 8, 3)
    with pytest.raises(ValueError, match="stride-1 square"):
        apply_conv(x, torch.zeros(3, 3, 3, 4), WINO_4_3, stride=2)
    with pytest.raises(ValueError, match="bf16-only"):
        apply_conv(x, torch.zeros(3, 3, 3, 4), WINO_4_3, precision="int8",
                   in_scale=0.1, backend="lax")


# ------------------------------------------------------------ whole plans
def _np_params(graph, seed):
    """``{nid: {"w", "b"}}`` as the reference's ``init_params`` lays it
    out, drawn with numpy (biases non-zero)."""
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


VGG_CONFIGS = [(32, 0.125), (56, 0.25)]


@pytest.fixture(scope="module", params=VGG_CONFIGS,
                ids=[f"r{r}_s{s}" for r, s in VGG_CONFIGS])
def vgg(request):
    res, scale = request.param
    g = vgg16(res=res, scale=scale)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    jg = jax_vgg16(res=res, scale=scale)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    return res, g, plan, jg, jplan, _np_params(jg, seed=0)


_REFERENCE_LOGITS = {}


def _reference_logits(vgg, bucket):
    """(input, the reference's logits) of its elided program on ``bucket``
    images, compiled once for both of the port's lowerings: elision moves
    data only, and the reference's unelided logits lie within 9e-8 of
    these (measured at both configs and buckets), far inside the plan
    tolerance. Keyed by the config's resolution (one per config)."""
    res, _, _, jg, jplan, np_params = vgg
    if (res, bucket) not in _REFERENCE_LOGITS:
        x = np.random.default_rng(1).standard_normal(
            (bucket, res, res, 3)).astype(np.float32)
        ref = jax_compile_plan(jg, jplan, epilogue="bias_relu", elide=True,
                               tuning_batch=bucket)(np_params, x)
        _REFERENCE_LOGITS[(res, bucket)] = (x, np.asarray(ref))
    return _REFERENCE_LOGITS[(res, bucket)]


@pytest.mark.parametrize("elide", [True, False])
@pytest.mark.parametrize("bucket", [1, 4])
def test_vgg16_compile_plan_matches_reference(vgg, bucket, elide):
    res, g, plan, jg, jplan, np_params = vgg
    assert {a.family for a in plan.assignment.values()} == {
        AlgoFamily.IM2COL, AlgoFamily.WINOGRAD}
    x, ref = _reference_logits(vgg, bucket)
    run = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=bucket, device="cpu")
    got = run(params_from_jax(np_params, "cpu"), x)
    assert got.shape == (bucket, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)
    reads_tiles = [n for n, l in run.lowering.items()
                   if l.in_layout is not None
                   and l.in_layout.kind == "winograd"]
    assert bool(reads_tiles) == elide


def test_vgg16_engine_matches_reference_engine():
    """Both engines serve the same requests on reduced VGG16 (dispatch as
    soon as a request arrives: no waiting decision depends on measured
    service times) and every result agrees."""
    g = vgg16(res=56, scale=0.25)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    jg = jax_vgg16(res=56, scale=0.25)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    np_params = _np_params(jg, seed=3)
    images = np.random.default_rng(4).standard_normal(
        (5, 56, 56, 3)).astype(np.float32)
    ours = CNNServingEngine(g, params_from_jax(np_params, "cpu"), plan,
                            batch_size=4, slo_s=None, device="cpu")
    ref = JaxEngine(jg, np_params, jplan, batch_size=4, slo_s=None)
    for engine, req in ((ours, CNNRequest), (ref, JaxRequest)):
        for rid, img in enumerate(images):
            engine.submit(req(rid=rid, image=img))
        engine.run_until_done()
    assert ours.dispatches == ref.dispatches
    assert sorted(ours.done) == sorted(ref.done) == list(range(5))
    for rid in range(5):
        np.testing.assert_allclose(ours.done[rid], np.asarray(ref.done[rid]),
                                   **PLAN_TOL)
