"""The port's kernel wrappers, oracles, layouts and layers against the JAX
reference on the CPU. Inputs are made with numpy from a seed and fed to
both sides; the reference's Pallas kernels run in interpret mode and the
port runs each kernel's plain version (CPU tensors). f32 at 1e-4, the
reference's own kernel tolerance; layout conversions are exact."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as jax_layers
from repro.core.cost_model import Dataflow as JaxDataflow
from repro.core.layouts import LayoutSpec as JaxLayoutSpec
from repro.kernels.conv_im2col.ops import conv_im2col as jax_conv_im2col
from repro.kernels.conv_im2col.ref import conv_ref as jax_conv_ref
from repro.kernels.conv_im2col.ref import toeplitz_ref as jax_toeplitz_ref
from repro.kernels.gemm.ops import gemm as jax_gemm
from repro.kernels.layouts import materialize as jax_materialize
from repro_torch.cnn import layers
from repro_torch.cnn.models import googlenet, inception_v4, vgg16
from repro_torch.core.algorithms import AlgoFamily
from repro_torch.core.cost_model import Dataflow
from repro_torch.core.dse import identify_parameters
from repro_torch.core.layouts import LayoutSpec
from repro_torch.kernels.common import EPILOGUES
from repro_torch.kernels.conv_im2col.conv_im2col import (conv_im2col_call,
                                                         conv_plain)
from repro_torch.kernels.conv_im2col.ops import conv_im2col
from repro_torch.kernels.conv_im2col.ref import (conv_ref,
                                                 conv_via_toeplitz_ref,
                                                 toeplitz_ref)
from repro_torch.core.mapper import lower_plan, map_network
from repro_torch.kernels.gemm.gemm import (K_CHUNK, MIN_SLICE_CHUNKS,
                                          gemm_call, gemm_plain, grid_splits,
                                          k_slices, kernel_tile, split_k)
from repro_torch.kernels.gemm.ops import dataflow_blocks, gemm, toeplitz_gemm
from repro_torch.kernels.layouts import materialize, restore


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


def rnd(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def _spec_pair(**kw):
    return LayoutSpec(**kw), JaxLayoutSpec(**kw)


# ------------------------------------------------------------------ GEMM
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("df", ["NS", "WS", "IS"])
@pytest.mark.parametrize("mkn", [(37, 150, 45), (130, 64, 129), (1, 1, 1),
                                 (17, 33, 9), (64, 1536, 256)])
def test_gemm_matches_reference(df, epilogue, mkn):
    m, k, n = mkn
    a, b = rnd(1, m, k), rnd(2, k, n, scale=k ** -0.5)
    bias = rnd(3, n, scale=0.5)
    use_bias = epilogue.startswith("bias")
    ref = jax_gemm(jnp.asarray(a), jnp.asarray(b), JaxDataflow[df],
                   interpret=True, epilogue=epilogue,
                   bias=jnp.asarray(bias) if use_bias else None)
    got = gemm(t(a), t(b), Dataflow[df], epilogue=epilogue,
               bias=t(bias) if use_bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if epilogue == "none":
        np.testing.assert_allclose(got.numpy(),
                                   gemm_plain(t(a), t(b)).numpy(), **TOL)


def test_dataflow_blocks_and_kernel_tiles():
    assert dataflow_blocks(Dataflow.NS, 128, 256) == (128, 256, 128)
    assert dataflow_blocks(Dataflow.WS, 128, 256) == (128, 256, 128)
    assert dataflow_blocks(Dataflow.IS, 384, 256) == (256, 128, 384)
    # The main path's NS (128, 128) binding keeps the 128 tile; narrow or
    # short problems clamp to the 64 tile; wide bindings map to 128.
    assert kernel_tile(128, 128, 25088, 192) == (128, 128)
    assert kernel_tile(128, 128, 392, 32) == (128, 64)
    assert kernel_tile(128, 128, 49, 832) == (64, 128)
    assert kernel_tile(512, 256, 4096, 4096) == (128, 128)


# (blocks, K, SMs): grids that fill the card, the main path's small grids
# (5b/1x1 and incC's 1x1 at bucket 1, incC0/b4d's unit-conv GEMMs at 8),
# K within one chunk, K = 70 and ragged K, and another SM count.
SPLIT_CASES = [(132, 576, 132), (392, 576, 132), (154, 1728, 132),
               (3, 832, 132), (2, 1536, 132), (24, 512, 132), (38, 1568, 132),
               (1, 1, 132), (5, 16, 132), (3, 17, 132), (9, 70, 132),
               (27, 264, 132), (1, 2880, 132), (7, 1000, 114), (1, 64, 2)]


@pytest.mark.parametrize("blocks,k,sms", SPLIT_CASES,
                         ids=[f"b{b}-k{k}-sm{s}" for b, k, s in SPLIT_CASES])
def test_split_k_slices_cover_k(blocks, k, sms):
    """The K slices the f32 kernels run: one slice when the grid fills the
    card or K fits one chunk; otherwise one wave (blocks · S <= SMs) of
    non-empty slices that start on chunk boundaries, are at least
    MIN_SLICE_CHUNKS deep but for the last, and cover [0, K) exactly."""
    s = split_k(blocks, k, sms)
    if blocks >= sms or k <= K_CHUNK:
        assert s == 1
    assert 1 <= s and (s == 1 or blocks * s <= sms)
    slices = k_slices(k, s)
    assert len(slices) == s
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (b0, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1                      # disjoint and contiguous
        assert e0 - b0 >= min(k, MIN_SLICE_CHUNKS * K_CHUNK)
    for begin, end in slices:
        assert begin < end and begin % K_CHUNK == 0
    assert sum(e - b for b, e in slices) == k


def test_k_chunk_is_the_kernels_chunk_depth():
    """split_k and k_slices cut K in the kernels' chunks: K_CHUNK is
    csrc/tile_gemm.cuh's kBK, and slice_depth rounds to it."""
    csrc = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
    assert f"constexpr int kBK = {K_CHUNK};" in \
        (csrc / "tile_gemm.cuh").read_text()
    assert "return (chunks + splits - 1) / splits * kBK;" in \
        (csrc / "tile_gemm_async.cuh").read_text()


def test_split_k_has_no_empty_slice_at_any_depth():
    for sms in (132, 114, 7):
        for blocks in (1, 2, 3, 5, 24, 38, 131):
            for k in range(1, 1200):
                slices = k_slices(k, split_k(blocks, k, sms))
                assert all(b < e for b, e in slices), (blocks, k, sms)
                assert slices[-1][1] == k


H100_SMS = 132
MODELS = {"googlenet": googlenet, "vgg16": vgg16,
          "inception_v4": inception_v4}


def _lowering(model: str, elide: bool):
    """The full-width model's exact plan, lowered as the card runs it."""
    g = MODELS[model]()
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    return g, lower_plan(g, plan, epilogue="bias_relu", elide=elide)


def _conv_kernel_grids(model: str, elide: bool, batch: int):
    """{layer: (M, N, K, tile)} of every conv the implicit-GEMM conv
    kernel runs (an im2col layer reading NHWC) at ``batch``."""
    g, low = _lowering(model, elide)
    grids = {}
    for nid, lw in low.items():
        if lw.algo.family is not AlgoFamily.IM2COL or lw.in_layout:
            continue
        c = g.nodes[nid].conv
        m, n = batch * c.o1 * c.o2, c.c_out
        bm, bn, _ = dataflow_blocks(lw.dataflow, lw.p1, lw.p2)
        grids[g.nodes[nid].name] = (m, n, c.k1 * c.k2 * c.c_in,
                                    kernel_tile(bm, bn, m, n))
    return grids


@pytest.mark.parametrize("model,launches,small", [("googlenet", 57, 12),
                                                  ("inception_v4", 117, 20)])
def test_conv_splits_k_on_the_unelided_small_maps(model, launches, small):
    """Without layout elision every im2col layer runs the conv kernel: 57
    in GoogleNet, 117 in Inception-v4. At bucket 1 each of those on a 7x7
    or 8x8 map (M 49 or 64; 12 and 20 layers) has a grid of a few blocks
    and a K of 800-2880, so the conv splits K as gemm_f32 does, in one
    wave of slices."""
    grids = _conv_kernel_grids(model, elide=False, batch=1)
    assert len(grids) == launches
    on_small = {name: v for name, v in grids.items() if v[0] <= 64}
    assert len(on_small) == small
    for name, (m, n, k, tile) in on_small.items():
        blocks = -(-m // tile[0]) * -(-n // tile[1])
        s = grid_splits(m, n, k, tile, H100_SMS)
        assert blocks <= 4 and 1 < s and blocks * s <= H100_SMS, name


@pytest.mark.parametrize("model,stem,blocks", [
    ("googlenet", (112 * 112, 64, 147), 98),
    ("vgg16", (224 * 224, 64, 27), 392),
    ("inception_v4", (149 * 149, 32, 27), 174)])
def test_conv_does_not_split_the_elided_stems(model, stem, blocks):
    """With elision the conv kernel runs once per forward, on the image:
    GoogleNet's 7x7 stem, VGG16's conv0_0, Inception-v4's stem/c1. Their
    grids fill the card at bucket 1 already (98 blocks for the GoogleNet
    stem's 147-deep K: 9 chunks, too few for two slices), so no bucket
    splits them."""
    for batch in (1, 2, 4, 8):
        (m, n, k, tile), = _conv_kernel_grids(model, True, batch).values()
        assert (m, n, k) == (batch * stem[0], stem[1], stem[2])
        if batch == 1:
            assert -(-m // tile[0]) * -(-n // tile[1]) == blocks
        assert grid_splits(m, n, k, tile, H100_SMS) == 1


@pytest.mark.parametrize("model", ["vgg16", "inception_v4"])
def test_batched_gemm_main_path_grids_are_never_split(model):
    """Every Winograd layer's batched GEMM (G = 36 for F(4,3), M =
    B · tiles, K = Cin, N = Cout) at buckets 1-8: split_k leaves each at
    one slice, the grounds for a batched kernel without split K. The
    smallest grids (Inception-v4's incA layers at bucket 1: 36 blocks)
    have 4-6 chunks of K, below two slices of MIN_SLICE_CHUNKS."""
    g, low = _lowering(model, elide=True)
    smallest = None
    for batch in (1, 2, 4, 8):
        for nid, lw in low.items():
            if lw.algo.family is not AlgoFamily.WINOGRAD:
                continue
            c, t = g.nodes[nid].conv, lw.algo.m + lw.algo.r - 1
            m = batch * -(-c.o1 // lw.algo.m) * -(-c.o2 // lw.algo.m)
            bm, bn, _ = dataflow_blocks(lw.dataflow, lw.p1, lw.p2)
            tile = kernel_tile(bm, bn, m, c.c_out)
            blocks = t * t * -(-m // tile[0]) * -(-c.c_out // tile[1])
            assert grid_splits(m, c.c_out, c.c_in, tile, H100_SMS,
                               groups=t * t) == 1, (g.nodes[nid].name, batch)
            if smallest is None or blocks < smallest[0]:
                smallest = (blocks, c.c_in, g.nodes[nid].name, batch)
    if model == "vgg16":
        assert smallest[:2] == (144, 256)           # conv2_x at bucket 1
    else:
        assert smallest[0] == 36 and smallest[3] == 1
        assert -(-smallest[1] // K_CHUNK) < 2 * MIN_SLICE_CHUNKS


def test_gemm_call_validates_epilogue():
    a, b = torch.zeros(4, 3), torch.zeros(3, 2)
    with pytest.raises(ValueError, match="needs a bias"):
        gemm_call(a, b, epilogue="bias")
    with pytest.raises(ValueError, match="unknown epilogue"):
        gemm_call(a, b, epilogue="gelu")


# --------------------------------------------------------------- im2col
CONV_CASES = [  # (h, w, cin, cout, k1, k2, stride, padding)
    (14, 14, 8, 16, 1, 1, 1, "SAME"), (14, 14, 8, 16, 3, 3, 1, "SAME"),
    (28, 28, 4, 8, 5, 5, 1, "SAME"), (16, 16, 3, 8, 7, 7, 2, "SAME"),
    (15, 15, 3, 8, 3, 3, 2, "SAME"), (14, 14, 8, 16, 3, 3, 1, "VALID"),
    (17, 17, 6, 10, 3, 3, 2, "VALID")]


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"{c[4]}x{c[5]}s{c[6]}{c[7]}" for c in CONV_CASES])
def test_conv_im2col_matches_reference(case, batch):
    h, w_, cin, cout, k1, k2, s, pad = case
    lead = () if batch is None else (batch,)
    x = rnd(4, *lead, h, w_, cin)
    w = rnd(5, k1, k2, cin, cout, scale=(k1 * k2 * cin) ** -0.5)
    bias = rnd(6, cout, scale=0.5)
    ref = jax_conv_im2col(jnp.asarray(x), jnp.asarray(w), stride=s,
                          padding=pad, interpret=True, epilogue="bias_relu",
                          bias=jnp.asarray(bias))
    got = conv_im2col(t(x), t(w), stride=s, padding=pad,
                      epilogue="bias_relu", bias=t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        conv_ref(t(x), t(w), stride=s, padding=pad).numpy(),
        np.asarray(jax_conv_ref(jnp.asarray(x), jnp.asarray(w), stride=s,
                                padding=pad)), **TOL)


@pytest.mark.parametrize("batch", [None, 3])
def test_conv_im2col_toeplitz_layouts_match_reference(batch):
    """A Toeplitz ``in_layout`` (the matched load: a plain GEMM) and a
    Toeplitz ``out_layout`` (the consumer's store format)."""
    lead = () if batch is None else (batch,)
    spec_in, jspec_in = _spec_pair(kind="toeplitz", h=12, w=12, c=6, k1=3,
                                   k2=3, stride=1, padding="SAME")
    spec_out, jspec_out = _spec_pair(kind="toeplitz", h=12, w=12, c=10, k1=5,
                                     k2=5, stride=1, padding="SAME")
    x = rnd(7, *lead, 12, 12, 6)
    w = rnd(8, 3, 3, 6, 10, scale=54 ** -0.5)
    bias = rnd(9, 10, scale=0.5)
    x_t = jax_materialize(jnp.asarray(x), jspec_in)
    ref = jax_conv_im2col(x_t, jnp.asarray(w), interpret=True,
                          epilogue="bias_relu", bias=jnp.asarray(bias),
                          in_layout=jspec_in, out_layout=jspec_out)
    ours_in = materialize(t(x), spec_in)
    np.testing.assert_array_equal(ours_in.numpy(), np.asarray(x_t))
    got = conv_im2col(ours_in, t(w), epilogue="bias_relu", bias=t(bias),
                      in_layout=spec_in, out_layout=spec_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    direct = toeplitz_gemm(ours_in, t(w).reshape(-1, 10), spec_in)
    np.testing.assert_allclose(
        direct.numpy(),
        conv_via_toeplitz_ref(t(x), t(w)).numpy(), **TOL)


def test_conv_plain_matches_conv_call_and_ref():
    x, w = t(rnd(10, 2, 9, 11, 5)), t(rnd(11, 3, 3, 5, 7, scale=0.2))
    bias = t(rnd(12, 7))
    a = conv_plain(x, w, stride=2, padding="SAME", epilogue="bias",
                   bias=bias)
    b = conv_im2col_call(x, w, stride=2, padding="SAME", epilogue="bias",
                         bias=bias)
    c = conv_ref(x, w, stride=2, padding="SAME") + bias
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(a.numpy(), c.numpy(), **TOL)


# --------------------------------------------------------------- layouts
LAYOUT_CASES = [(12, 12, 4, 3, 3, 1, "SAME"), (13, 11, 5, 5, 5, 1, "SAME"),
                (16, 16, 3, 7, 7, 2, "SAME"), (10, 10, 4, 3, 3, 2, "SAME"),
                (9, 9, 2, 3, 3, 1, "VALID"), (8, 10, 3, 1, 1, 1, "SAME")]


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_toeplitz_round_trip_is_exact(case, batch):
    h, w, c, k1, k2, s, pad = case
    spec, jspec = _spec_pair(kind="toeplitz", h=h, w=w, c=c, k1=k1, k2=k2,
                             stride=s, padding=pad)
    lead = () if batch is None else (batch,)
    x = rnd(13, *lead, h, w, c)
    m = materialize(t(x), spec)
    assert tuple(m.shape) == (*lead, spec.o1 * spec.o2, k1 * k2 * c)
    ref = jax_materialize(jnp.asarray(x), jspec)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref))
    if batch is None:
        np.testing.assert_array_equal(
            toeplitz_ref(t(x), k1, k2, s, pad).numpy(),
            np.asarray(jax_toeplitz_ref(jnp.asarray(x), k1, k2, s, pad)))
    np.testing.assert_array_equal(restore(m, spec).numpy(), x)


def test_materialize_rejects_wrong_shape():
    spec = LayoutSpec(kind="toeplitz", h=8, w=8, c=3, k1=3, k2=3)
    with pytest.raises(ValueError, match="cannot materialize"):
        materialize(torch.zeros(8, 8, 4), spec)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("pad", ["SAME", "VALID"])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (2, 2)])
def test_pooling_matches_reference(k, stride, pad):
    x = rnd(14, 2, 11, 13, 4)
    np.testing.assert_allclose(
        layers.max_pool(t(x), k, stride, pad).numpy(),
        np.asarray(jax_layers.max_pool(jnp.asarray(x), k, stride, pad)),
        **TOL)
    np.testing.assert_allclose(
        layers.avg_pool(t(x[0]), k, stride, pad).numpy(),
        np.asarray(jax_layers.avg_pool(jnp.asarray(x[0]), k, stride, pad)),
        **TOL)


def test_global_pool_and_fc_match_reference():
    x, w, b = rnd(15, 3, 5, 5, 8), rnd(16, 8, 4), rnd(17, 4)
    gap = layers.global_avg_pool(t(x))
    np.testing.assert_allclose(
        gap.numpy(), np.asarray(jax_layers.global_avg_pool(jnp.asarray(x))),
        **TOL)
    np.testing.assert_allclose(
        layers.fc(gap, t(w), t(b)).numpy(),
        np.asarray(jax_layers.fc(jax_layers.global_avg_pool(jnp.asarray(x)),
                                 jnp.asarray(w), jnp.asarray(b))), **TOL)


# The four wrappers that once took an operand of any dtype and the
# Winograd path's four, each called on operands of ``dtype`` (shapes the
# kernels take, on the CPU).
def _wrapper_calls(dtype):
    from repro_torch.kernels.gemm.gemm import batched_gemm_call
    from repro_torch.kernels.kn2row.kn2row import (pad_accumulate_call,
                                                   unit_conv_gemms_call)
    from repro_torch.kernels.winograd import winograd as wino
    a = torch.ones((4, 8), dtype=dtype)
    return {
        "batched_gemm": lambda: batched_gemm_call(
            torch.ones((2, 4, 8), dtype=dtype),
            torch.ones((2, 8, 3), dtype=dtype)),
        "input_transform": lambda: wino.input_transform_call(
            torch.ones((1, 4, 4, 2), dtype=dtype), m=2, tiles_y=2,
            tiles_x=2, pad_top=1, pad_left=1),
        "input_transform_tiles": lambda: wino.input_transform_tiles_call(
            torch.ones((3, 4, 4, 2), dtype=dtype), m=2),
        "output_transform": lambda: wino.output_transform_call(
            torch.ones((16, 4, 2), dtype=dtype), m=2, tiles_y=2, tiles_x=2,
            o1=4, o2=4),
        "gemm": lambda: gemm_call(a, torch.ones((8, 3), dtype=dtype)),
        "conv_im2col": lambda: conv_im2col_call(
            torch.ones((1, 5, 5, 2), dtype=dtype),
            torch.ones((3, 3, 2, 4), dtype=dtype)),
        "unit_conv_gemms": lambda: unit_conv_gemms_call(
            a, torch.ones((2, 8, 3), dtype=dtype)),
        "pad_accumulate": lambda: pad_accumulate_call(
            torch.ones((9, 1, 4, 4, 3), dtype=dtype), k1=3, k2=3, o1=4,
            o2=4, pad_top=1, pad_left=1),
    }


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.bfloat16],
                         ids=["f16", "f64", "bf16"])
@pytest.mark.parametrize("kernel", ["gemm", "conv_im2col",
                                    "unit_conv_gemms", "pad_accumulate",
                                    "batched_gemm", "input_transform",
                                    "input_transform_tiles",
                                    "output_transform"])
def test_wrappers_raise_on_dtypes_without_a_kernel(kernel, dtype):
    """Each wrapper checks its operands' dtype against ``KERNEL_DTYPES``
    before it picks the kernel or its plain version, so on the card no
    f16 or f64 operand reaches an f32 kernel's buffers; here the same
    check raises on CPU tensors. Every wrapper takes bf16 and returns
    bf16."""
    from repro_torch.kernels.common import KERNEL_DTYPES
    call = _wrapper_calls(dtype)[kernel]
    if dtype in KERNEL_DTYPES[kernel]:
        assert dtype == torch.bfloat16
        assert call().dtype == torch.bfloat16
        return
    with pytest.raises(TypeError, match="no kernel"):
        call()
