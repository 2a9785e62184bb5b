"""The host side of the bf16 GEMMs' two loops on the CPU: how the wrapper
cuts K for the wgmma loop (``split_k`` and ``grid_splits`` at its 64-deep
chunks; the mma.sync loop does not split), which loop a shape takes
(``wgmma_path``, the TMA condition), and the function a split product
computes, against the JAX reference's interpret-mode GEMM.

The kernels run only on the card; here the main path's shapes come from
full-width GoogleNet and Inception-v4 planned and lowered as the card runs
them, and the split product is emulated in plain torch as the kernels
compute it: each K slice's f32 partial, summed in slice order, then the
bias widened, ReLU and one rounding to bf16. That emulation is held
within one bf16 ulp (rtol 2^-7, atol 1e-4 of the output's max) of
``gemm_plain`` and of the reference's kernel on the same bf16 operands.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm.ops import gemm as jax_gemm
from repro_torch.cnn.executor import lower_plan
from repro_torch.cnn.models import googlenet, inception_v4, vgg16
from repro_torch.core.algorithms import AlgoFamily
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import map_network
from repro_torch.kernels.gemm.gemm import (BF16_WGMMA_CHUNK, K_CHUNK,
                                          MIN_SLICE_DEPTH,
                                          gemm_call, gemm_plain, grid_splits,
                                          k_slices, kernel_tile, split_k,
                                          wgmma_path)
from repro_torch.kernels.gemm.ops import dataflow_blocks


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and
    torch's thread pool, oversubscribed, wakes slower than the small CPU
    ops it would split."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF = torch.bfloat16
BF16_ULP = 2.0 ** -7
H100_SMS = 132
MODELS = {"googlenet": googlenet, "vgg16": vgg16,
          "inception_v4": inception_v4}
# Toeplitz GEMMs a forward of each model runs under elision.
TOEPLITZ_LAUNCHES = {"googlenet": 56, "vgg16": 7, "inception_v4": 116}


@pytest.fixture(scope="module")
def lowerings():
    """{model: (graph, elided lowering)} of the full-width models, planned
    as the card runs them."""
    out = {}
    for name, build in MODELS.items():
        g = build()
        plan = map_network(g, hw=identify_parameters(g, max_dim=512))
        out[name] = (g, lower_plan(g, plan, epilogue="bias_relu", elide=True))
    return out


def _toeplitz_gemms(g, low, batch):
    """Counter of (layer, M, K, N, tile) over the conv layers whose input
    edge carries their Toeplitz matrix: gemm_bf16's launches in a forward
    of a bf16 model at ``batch``."""
    shapes = Counter()
    for nid, lw in low.items():
        if (lw.algo.family is AlgoFamily.IM2COL and lw.in_layout is not None
                and lw.in_layout.kind == "toeplitz"):
            c = g.nodes[nid].conv
            m, k, n = batch * c.o1 * c.o2, c.k1 * c.k2 * c.c_in, c.c_out
            bm, bn, _ = dataflow_blocks(lw.dataflow, lw.p1, lw.p2)
            shapes[(g.nodes[nid].name, m, k, n,
                    kernel_tile(bm, bn, m, n))] += 1
    return shapes


def _check_slices(k, s, chunk):
    slices = k_slices(k, s, chunk)
    assert len(slices) == s and slices[0][0] == 0 and slices[-1][1] == k
    for (b0, e0), (b1, _) in zip(slices, slices[1:]):
        assert e0 == b1 and e0 - b0 >= min(k, MIN_SLICE_DEPTH)
    for begin, end in slices:
        assert begin < end and begin % chunk == 0


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", ["googlenet", "inception_v4"])
def test_main_path_toeplitz_gemms_split_on_the_wgmma_loop(lowerings, model,
                                                          batch):
    """Every Toeplitz GEMM of full-width GoogleNet (56 a forward) and
    Inception-v4 (116) at buckets 1 and 8 takes the wgmma loop (K and N
    multiples of 8) and is cut into one wave of non-empty slices of whole
    64-deep chunks covering K; a grid that fills the card runs one slice,
    and GoogleNet's 5b/1x1 at bucket 1 (3 blocks of 64 x 128, K 832)
    splits 13 ways, as gemm_f32 does at its 16-deep chunks."""
    g, low = lowerings[model]
    shapes = _toeplitz_gemms(g, low, batch)
    assert sum(shapes.values()) == TOEPLITZ_LAUNCHES[model]
    split = 0
    for (name, m, k, n, tile), _ in shapes.items():
        assert k % 8 == 0 and n % 8 == 0, name
        blocks = -(-m // tile[0]) * -(-n // tile[1])
        s = grid_splits(m, n, k, tile, H100_SMS, chunk=BF16_WGMMA_CHUNK)
        assert s == split_k(blocks, k, H100_SMS, BF16_WGMMA_CHUNK)
        assert blocks * s <= H100_SMS or s == 1
        if blocks >= H100_SMS:
            assert s == 1
        _check_slices(k, s, BF16_WGMMA_CHUNK)
        split += s > 1
        if model == "googlenet" and batch == 1 and name.endswith("5b/1x1"):
            assert (m, k, n, tile) == (49, 832, 384, (64, 128))
            assert s == 13 == grid_splits(m, n, k, tile, H100_SMS)
    assert split if batch == 1 else True


@pytest.mark.parametrize("model", ["vgg16", "inception_v4"])
def test_main_path_winograd_gemms_take_the_wgmma_loop(lowerings, model):
    """Every Winograd layer's batched GEMM (K = Cin, N = Cout) of VGG16 and
    Inception-v4 meets the TMA condition, so the batched kernel's main-path
    launches all run the wgmma loop."""
    g, low = lowerings[model]
    wino = [g.nodes[nid].conv for nid, lw in low.items()
            if lw.algo.family is AlgoFamily.WINOGRAD]
    assert len(wino) == {"vgg16": 5, "inception_v4": 16}[model]
    assert all(c.c_in % 8 == 0 and c.c_out % 8 == 0 for c in wino)


@pytest.mark.parametrize("chunk", [K_CHUNK, BF16_WGMMA_CHUNK])
def test_split_k_keeps_64_elements_a_slice_at_every_chunk_depth(chunk):
    """At each splitting loop's chunk depth (f32's 16, the wgmma loop's 64)
    the slices are non-empty, whole chunks, at least 64 elements deep but
    the last, and cover K, for any depth and grid; f32's 16-deep chunks
    cut as before (4 chunks a slice)."""
    for blocks in (1, 2, 3, 5, 24, 38, 131):
        for k in list(range(1, 300)) + [576, 832, 1000, 2880, 4096]:
            s = split_k(blocks, k, H100_SMS, chunk)
            assert 1 <= s and blocks * s <= H100_SMS
            _check_slices(k, s, chunk)
    assert split_k(3, 832, H100_SMS, K_CHUNK) == split_k(3, 832, H100_SMS)


def _offset(t):
    """``t`` in a contiguous view one element into a larger buffer: not
    16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case,m,k,n,want", [
    ("aligned", 49, 832, 384, True), ("K 8, N 8", 1, 8, 8, True),
    ("K 830", 49, 830, 384, False), ("N 30", 70, 40, 30, False),
    ("K 1", 1, 1, 1, False), ("A offset", 64, 64, 64, False),
    ("B offset", 64, 64, 64, False), ("K 16, N 24", 3, 16, 24, True),
    ("N 12", 5, 64, 12, False)])
def test_wgmma_path_is_the_tma_condition(case, m, k, n, want):
    """The wgmma loop takes K and N multiples of 8 (16-byte rows) and A and
    B on 16-byte boundaries; any other operand takes the mma.sync loop.
    The choice reads only the shape and the pointers."""
    a, b = torch.zeros((m, k), dtype=BF), torch.zeros((k, n), dtype=BF)
    if case == "A offset":
        a = _offset(a)
    if case == "B offset":
        b = _offset(b)
    assert wgmma_path(a, b, n, k) is want


def _sliced(a, b, bias, splits, chunk):
    """The split kernels' function in plain torch: each slice's f32
    partial, summed in slice order, bias widened, ReLU, one rounding."""
    acc = None
    for begin, end in k_slices(a.shape[1], splits, chunk):
        part = a[:, begin:end].float() @ b[begin:end].float()
        acc = part if acc is None else acc + part
    return torch.clamp_min(acc + bias.float(), 0).to(BF)


def _within_one_ulp(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("m,k,n,tile", [
    (49, 832, 384, (64, 128)),      # 5b/1x1 b1: 13 slices
    (64, 1728, 64, (64, 64)),       # a deep K, one block
    (70, 200, 104, (128, 128)),     # a ragged last chunk
    (64, 1536, 256, (64, 128))])    # an Inception-C 1x1 at b1: 24 slices
def test_split_sum_rounded_once_matches_plain_and_reference(m, k, n, tile):
    """The split product's function, its slices as the wrapper cuts them
    on an H100, within one bf16 ulp of ``gemm_plain`` (the CPU path of
    ``gemm_call``) and of the reference's interpret-mode kernel on the
    same bf16 operands."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
    a, b, bias = a.to(BF), b.to(BF), bias.to(BF)
    splits = grid_splits(m, n, k, tile, H100_SMS, chunk=BF16_WGMMA_CHUNK)
    assert splits > 1
    got = _sliced(a, b, bias, splits, BF16_WGMMA_CHUNK)
    plain = gemm_plain(a, b, "bias_relu", bias)
    assert torch.equal(plain, gemm_call(a, b, bm=tile[0], bn=tile[1],
                                        epilogue="bias_relu", bias=bias))
    _within_one_ulp(got, plain.float().numpy())
    ref = jax_gemm(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                   jnp.asarray(b.float().numpy(), jnp.bfloat16),
                   interpret=True, epilogue="bias_relu",
                   bias=jnp.asarray(bias.float().numpy(), jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    _within_one_ulp(got, jnp.asarray(ref, jnp.float32))
