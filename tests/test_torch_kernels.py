"""The port's kernel wrappers, oracles, layouts and layers against the JAX
reference on the CPU. Inputs are made with numpy from a seed and fed to
both sides; the reference's Pallas kernels run in interpret mode and the
port runs each kernel's plain version (CPU tensors). f32 at 1e-4, the
reference's own kernel tolerance; layout conversions are exact."""
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
from repro_torch.core.cost_model import Dataflow
from repro_torch.core.layouts import LayoutSpec
from repro_torch.kernels.common import EPILOGUES
from repro_torch.kernels.conv_im2col.conv_im2col import (conv_im2col_call,
                                                         conv_plain)
from repro_torch.kernels.conv_im2col.ops import conv_im2col
from repro_torch.kernels.conv_im2col.ref import (conv_ref,
                                                 conv_via_toeplitz_ref,
                                                 toeplitz_ref)
from repro_torch.kernels.gemm.gemm import gemm_call, gemm_plain, kernel_tile
from repro_torch.kernels.gemm.ops import dataflow_blocks, gemm, toeplitz_gemm
from repro_torch.kernels.layouts import materialize, restore

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
@pytest.mark.parametrize("mkn", [(37, 150, 45), (130, 64, 129)])
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
