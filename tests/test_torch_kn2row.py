"""The port's kn2row path against the JAX reference on the CPU.

Inputs are made with numpy from a seed and fed to both sides; the
reference's Pallas kernels run in interpret mode and the port runs each
kernel's plain version (CPU tensors). Tolerances are the reference's:
1e-4 for f32 kernels and convs, rtol 2e-2 / atol 2e-3 for whole plans."""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import inception_v4 as jax_inception_v4
from repro.cnn.overlay import apply_conv as jax_apply_conv
from repro.core.algorithms import KN2ROW as JAX_KN2ROW
from repro.core.dse import identify_parameters as jax_identify
from repro.core.layouts import LayoutSpec as JaxLayoutSpec
from repro.core.mapper import map_network as jax_map_network
from repro.kernels.kn2row import kn2row as jax_kn2
from repro.kernels.kn2row.ops import conv_kn2row as jax_conv_kn2row
from repro.kernels.kn2row.ref import kn2row_ref as jax_kn2row_ref
from repro.kernels.layouts import materialize as jax_materialize
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import compile_plan
from repro_torch.cnn.models import inception_v4
from repro_torch.cnn.overlay import apply_conv
from repro_torch.core.algorithms import KN2ROW, AlgoFamily
from repro_torch.core.cost_model import Dataflow
from repro_torch.core.dse import identify_parameters
from repro_torch.core.layouts import LayoutSpec
from repro_torch.core.mapper import lower_plan, map_network
from repro_torch.kernels.conv_im2col.ref import conv_geometry, conv_ref
from repro_torch.kernels.kn2row import kn2row as kn2
from repro_torch.kernels.kn2row.ops import conv_kn2row
from repro_torch.kernels.kn2row.ref import kn2row_ref
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


TOL = dict(rtol=1e-4, atol=1e-4)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)
EPILOGUES = ["none", "relu", "bias", "bias_relu"]


def rnd(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- kernels' plain
@pytest.mark.parametrize("gmkn", [(9, 16, 8, 16), (3, 24, 16, 8),
                                  (1, 32, 24, 16), (1, 1, 1, 1),
                                  (3, 17, 33, 9), (2, 64, 1536, 256)])
def test_unit_conv_gemms_plain_matches_reference(gmkn):
    """One x2d shared by every offset's weight. The reference's kernel
    takes operands padded to its blocks (as its ops pad them: blocks of 8,
    or of (64, 128, 512) at incC's 1x1 depth), the port's unpadded ones."""
    g, m, k, n = gmkn
    x2d, w = rnd(1, m, k), rnd(2, g, k, n, scale=k ** -0.5)
    bm, bn, bk = (8, 8, 8) if k < 512 else (64, 128, 512)
    dm, dk, dn = -m % bm, -k % bk, -n % bn
    ref = jax_kn2.unit_conv_gemms(
        jnp.asarray(np.pad(x2d, ((0, dm), (0, dk)))),
        jnp.asarray(np.pad(w, ((0, 0), (0, dk), (0, dn)))), bm=bm, bn=bn,
        bk=bk, interpret=True)[:, :m, :n]
    got = kn2.unit_conv_gemms_call(t(x2d), t(w), bm=64, bn=64)
    assert tuple(got.shape) == (g, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), kn2.unit_conv_gemms_plain(t(x2d), t(w)).numpy())


# (H, W, K1, K2, stride, padding, C, batch): SAME and VALID at stride 1
# and 2, the one-dim pads of 1x3 and 3x1, and G = 1; then the edges of the
# card kernel's paths: C 30 (one channel a thread), batch 1, the generic
# offsets 1x7, 7x1 and 5x5 (5x5 at stride 2), and SAME at stride 2 on an
# odd map (pads on both sides).
PA_CASES = [(9, 9, 3, 3, 1, "SAME", 6, 2), (9, 9, 3, 3, 1, "VALID", 6, 2),
            (10, 9, 3, 3, 2, "SAME", 6, 2), (11, 11, 3, 3, 2, "VALID", 6, 2),
            (8, 8, 1, 3, 1, "SAME", 6, 2), (8, 8, 3, 1, 1, "SAME", 6, 2),
            (7, 7, 1, 1, 1, "SAME", 6, 2), (9, 9, 3, 3, 1, "SAME", 30, 2),
            (7, 7, 3, 3, 1, "SAME", 8, 1), (10, 10, 1, 7, 1, "SAME", 8, 2),
            (10, 10, 7, 1, 1, "SAME", 8, 2), (9, 9, 5, 5, 1, "SAME", 4, 2),
            (11, 11, 5, 5, 2, "SAME", 4, 2), (9, 9, 3, 3, 2, "SAME", 8, 2)]


def pa_id(case):
    h, w, k1, k2, stride, padding, c, batch = case
    return (f"{h}x{w}_{k1}x{k2}s{stride}{padding}"
            + ("" if (c, batch) == (6, 2) else f"_c{c}b{batch}"))


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("case", PA_CASES, ids=[pa_id(c) for c in PA_CASES])
def test_pad_accumulate_plain_matches_reference(case, epilogue):
    """The port takes p unpadded, (G, B, H, W, C), and treats rows and
    columns outside each image as 0; the reference takes one image's p
    zero-padded by the caller, as its ``conv_kn2row`` pads it. The epilogue
    is per channel, so one reference call takes the images side by side
    along C."""
    h, w, k1, k2, stride, padding, c, batch = case
    o1, o2, pt, _, pl, _ = conv_geometry(h, w, k1, k2, stride, padding)
    p, bias = rnd(3, k1 * k2, batch, h, w, c), rnd(4, c)
    use_bias = epilogue.startswith("bias")
    got = kn2.pad_accumulate_call(
        t(p), k1=k1, k2=k2, o1=o1, o2=o2, stride=stride,
        pad_top=pt, pad_left=pl, epilogue=epilogue,
        bias=t(bias) if use_bias else None)
    assert tuple(got.shape) == (batch, o1, o2, c)
    side = np.concatenate(list(p.transpose(1, 0, 2, 3, 4)), axis=-1)
    ref = jax_kn2.pad_accumulate(
        jnp.asarray(np.pad(side, ((0, 0), (pt, k1), (pl, k2), (0, 0)))),
        k1=k1, k2=k2, o1=o1, o2=o2, stride=stride, interpret=True,
        epilogue=epilogue,
        bias=jnp.asarray(np.tile(bias, batch)[None]) if use_bias else None)
    np.testing.assert_allclose(
        np.concatenate(list(got.numpy()), axis=-1), np.asarray(ref), **TOL)


# (graph, quantize, expected launches, whether every launch has C % 4 ==
# 0): the full-width model the card runs, width 0.25 at full depth (the
# int8 deviation table's reduced width), and this file's reduced IV4,
# whose widths of 19, 38, 51 and 77 channels take the one-channel path.
PATH_CASES = [(dict(res=299, scale=1.0), False, 16, True),
              (dict(res=299, scale=1.0), True, 16, True),
              (dict(res=299, scale=0.25), False, 16, True),
              (dict(res=299, scale=0.25), True, 16, True),
              (dict(res=75, scale=0.2, n_a=1, n_b=1, n_c=1), False, 8,
               False)]


@pytest.mark.parametrize(
    "graph_kw,quantize,launches,vector", PATH_CASES,
    ids=["full-f32", "full-int8", "w0.25-f32", "w0.25-int8", "reduced-f32"])
def test_main_path_pad_accumulate_launches_take_the_unrolled_path(
        graph_kw, quantize, launches, vector):
    """Every kn2row layer of Inception-v4's elided lowering (f32, or the
    int8 plan with nothing demoted, as the gate keeps it at full width)
    runs pad_accumulate on offsets the kernels unroll, and on the vector
    path where C % 4 == 0: the wrapper's choice for p and out as fresh
    allocations give them (the allocator aligns them; the kernels' p is
    unit_conv_gemms' fresh output)."""
    g = inception_v4(**graph_kw)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512),
                       quantize=quantize)
    low = lower_plan(g, plan, epilogue="bias_relu", elide=True,
                     act_scales={n.id: 1.0 for n in g.conv_nodes()})
    paths = collections.Counter()
    for nid, lw in low.items():
        if lw.algo.family is not AlgoFamily.KN2ROW:
            continue
        conv, i8 = g.nodes[nid].conv, lw.precision == "int8"
        p = torch.empty((conv.k1 * conv.k2, 1, 1, 1, conv.c_out),
                        dtype=torch.int32 if i8 else torch.float32)
        out = torch.empty((1, 1, 1, conv.c_out),
                          dtype=torch.int8 if i8 else torch.float32)
        assert (conv.k1, conv.k2) in kn2.UNROLLED_OFFSETS, g.nodes[nid].name
        assert kn2.accumulate_vector_path(p, out) == (conv.c_out % 4 == 0)
        paths[(lw.precision, bool(kn2.accumulate_vector_path(p, out)))] += 1
    assert sum(paths.values()) == launches
    assert all(v == vector for _, v in paths)
    if quantize:
        assert paths[("int8", vector)] >= launches - 1


def test_pad_accumulate_validates_geometry():
    """Checked before either path runs."""
    geo = dict(k1=3, k2=3, o1=4, o2=4, pad_top=1, pad_left=1)
    with pytest.raises(ValueError, match="wants p"):
        kn2.pad_accumulate_call(torch.zeros(3, 1, 4, 4, 2), **geo)
    with pytest.raises(ValueError, match="negative pad"):
        kn2.pad_accumulate_call(torch.zeros(9, 1, 4, 4, 2),
                                **{**geo, "pad_top": -1})
    with pytest.raises(ValueError, match="needs a bias"):
        kn2.pad_accumulate_call(torch.zeros(9, 1, 4, 4, 2), epilogue="bias",
                                **geo)


# --------------------------------------------------------- whole conv
# The reference's seven conv cases (tests/test_kernels.py).
CASES = [(14, 14, 8, 16, 3, 3, 1, "SAME"), (28, 28, 4, 8, 5, 5, 1, "SAME"),
         (15, 15, 3, 8, 3, 3, 2, "SAME"), (14, 14, 8, 8, 1, 1, 1, "SAME"),
         (16, 16, 6, 10, 7, 7, 2, "SAME"), (14, 14, 8, 16, 3, 3, 1, "VALID"),
         (10, 10, 6, 10, 1, 7, 1, "SAME")]


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[4]}x{c[5]}s{c[6]}{c[7]}_{c[0]}x{c[1]}"
                              for c in CASES])
def test_conv_kn2row_matches_reference(case, batch):
    """``kn2row_ref`` and ``conv_kn2row`` (the kernels' plain versions,
    the batch folded into M) against the reference's oracle and its
    interpret-mode ``conv_kn2row``, with the fused bias/ReLU."""
    h, w_, ci, co, k1, k2, s, pad = case
    lead = () if batch is None else (batch,)
    x, w = rnd(5, *lead, h, w_, ci), rnd(6, k1, k2, ci, co)
    bias = rnd(7, co)
    ref = jax_conv_kn2row(jnp.asarray(x), jnp.asarray(w), stride=s,
                          padding=pad, interpret=True, epilogue="bias_relu",
                          bias=jnp.asarray(bias))
    got = conv_kn2row(t(x), t(w), stride=s, padding=pad,
                      epilogue="bias_relu", bias=t(bias))
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    oracle = kn2row_ref(t(x), t(w), stride=s, padding=pad)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(jax_kn2row_ref(
            jnp.asarray(x), jnp.asarray(w), stride=s, padding=pad)), **TOL)
    np.testing.assert_allclose(oracle.numpy(),
                               conv_ref(t(x), t(w), s, pad).numpy(), **TOL)


# ---------------------------------------------------------------- overlay
LAYOUT_CASES = {
    # A 3x3 consumer's Toeplitz matrix in, a Winograd-tile store out.
    "toeplitz_in": (dict(kind="toeplitz", h=9, w=9, c=5, k1=3, k2=3,
                         stride=1, padding="SAME"),
                    dict(kind="winograd", h=9, w=9, c=7, k1=3, k2=3, m=4,
                         r=3)),
    # Winograd tiles in, the next 3x3 layer's Toeplitz matrix out (as
    # redA/b3a stores for its consumer).
    "winograd_in": (dict(kind="winograd", h=9, w=9, c=5, k1=3, k2=3, m=2,
                         r=3),
                    dict(kind="toeplitz", h=9, w=9, c=7, k1=3, k2=3,
                         stride=1, padding="SAME")),
}


@pytest.mark.parametrize("backend", [None, "reference", "lax"])
@pytest.mark.parametrize("layouts", sorted(LAYOUT_CASES))
@pytest.mark.parametrize("kernel", [(1, 1), (3, 1)])
def test_apply_conv_kn2row_layouts_match_reference(kernel, layouts,
                                                   backend):
    """kn2row restores a non-NHWC input and emits its consumer's store
    format, batched, on every backend, against the reference overlay."""
    spec_in, spec_out = LAYOUT_CASES[layouts]
    k1, k2 = kernel
    x, w = rnd(8, 2, 9, 9, 5), rnd(9, k1, k2, 5, 7, scale=0.3)
    bias = rnd(10, 7, scale=0.5)
    jx = jax_materialize(jnp.asarray(x), JaxLayoutSpec(**spec_in))
    ref = jax_apply_conv(jx, jnp.asarray(w), JAX_KN2ROW, backend=backend,
                         interpret=True, epilogue="bias_relu",
                         bias=jnp.asarray(bias),
                         in_layout=JaxLayoutSpec(**spec_in),
                         out_layout=JaxLayoutSpec(**spec_out))
    got = apply_conv(materialize(t(x), LayoutSpec(**spec_in)), t(w), KN2ROW,
                     Dataflow.IS, backend=backend, epilogue="bias_relu",
                     bias=t(bias), in_layout=LayoutSpec(**spec_in),
                     out_layout=LayoutSpec(**spec_out))
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("backend", ["reference", "lax"])
def test_apply_conv_kn2row_int8_emulation_matches_reference(backend):
    """int8 kn2row layers run the fake-quant emulation on the plain
    backends, as the reference's do."""
    x, w = rnd(11, 2, 9, 9, 4), rnd(12, 3, 1, 4, 6, scale=0.2)
    bias = rnd(13, 6, scale=0.1)
    kw = dict(stride=1, padding="SAME", backend=backend,
              epilogue="bias_relu", precision="int8", in_scale=0.03)
    ref = jax_apply_conv(jnp.asarray(x), jnp.asarray(w), JAX_KN2ROW,
                         bias=jnp.asarray(bias), **kw)
    got = apply_conv(t(x), t(w), KN2ROW, bias=t(bias), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


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


# Reduced Inception-v4: one block of each kind. Its exact plan keeps every
# full-width kn2row shape: 3x3 s2 VALID, 1x1 → Toeplitz, 1x3 and 3x1.
IV4 = dict(res=75, scale=0.2, n_a=1, n_b=1, n_c=1)


@pytest.fixture(scope="module")
def iv4():
    g = inception_v4(**IV4)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    jg = jax_inception_v4(**IV4)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    return g, plan, jg, jplan, _np_params(jg, seed=0)


def test_reduced_inception_v4_plan_covers_every_kn2row_shape(iv4):
    g, plan, _, _, _ = iv4
    assert plan.solver.exact
    mix = collections.Counter(a.key for a in plan.assignment.values())
    assert mix == {"im2col": 38, "kn2row": 8, "winograd(F4x3)": 2}
    shapes = {(g.nodes[n].conv.k1, g.nodes[n].conv.k2, g.nodes[n].conv.stride,
               g.nodes[n].conv.pad) for n, a in plan.assignment.items()
              if a.family is AlgoFamily.KN2ROW}
    assert shapes == {(3, 3, 2, "valid"), (1, 1, 1, "same"),
                      (1, 3, 1, "same"), (3, 1, 1, "same")}


@pytest.mark.parametrize("elide", [True, False])
@pytest.mark.parametrize("bucket", [1, 4])
def test_inception_v4_compile_plan_matches_reference(iv4, bucket, elide):
    g, plan, jg, jplan, np_params = iv4
    x = np.random.default_rng(1).standard_normal(
        (bucket, 75, 75, 3)).astype(np.float32)
    ref = jax_compile_plan(jg, jplan, epilogue="bias_relu", elide=elide,
                           tuning_batch=bucket)(np_params, x)
    run = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=bucket, device="cpu")
    got = run(params_from_jax(np_params, "cpu"), x)
    assert got.shape == (bucket, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)
    stores = {g.nodes[n].name: l.out_layout.kind for n, l in
              run.lowering.items() if l.algo.family is AlgoFamily.KN2ROW
              and l.out_layout is not None}
    assert stores == ({"redA/b3a": "toeplitz"} if elide else {})


def test_inception_v4_engine_matches_reference_engine(iv4):
    """Both engines serve the same requests on reduced Inception-v4
    (dispatch as soon as a request arrives: no waiting decision depends on
    measured service times) and every result agrees."""
    g, plan, jg, jplan, _ = iv4
    np_params = _np_params(jg, seed=3)
    images = np.random.default_rng(4).standard_normal(
        (5, 75, 75, 3)).astype(np.float32)
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
