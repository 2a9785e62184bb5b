"""Guards of the port: it imports nothing of JAX or the reference, its
entry points never fall back to the CPU or to another implementation, and
what is not ported yet raises instead of running something else."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.overlay import apply_conv as jax_apply_conv
from repro.core.algorithms import IM2COL as JAX_IM2COL
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import compile_plan, forward, init_params
from repro_torch.cnn.models import googlenet
from repro_torch.cnn.overlay import apply_conv
from repro_torch.core.algorithms import IM2COL, KN2ROW, WINO_2_3
from repro_torch.core.layouts import LayoutSpec
from repro_torch.kernels import build
from repro_torch.kernels.conv_im2col.conv_im2col import conv_im2col_call
from repro_torch.kernels.gemm.gemm import gemm_call
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.serving.cnn_engine import CNNServingEngine

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = {str(f.relative_to(REPO)): root for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert bad == {}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small():
    g = googlenet(res=32, scale=0.125)
    return g, init_params(g, seed=0, device="cpu")


def test_entry_points_with_default_device_raise_without_cuda(no_cuda,
                                                             small):
    g, params = small
    x = np.zeros((32, 32, 3), np.float32)
    calls = [lambda: init_params(g),
             lambda: compile_plan(g),
             lambda: forward(g, params, x),
             lambda: CNNServingEngine(g, params, None),
             lambda: params_from_jax({0: {"w": np.zeros(3, np.float32)}})]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_backend_on_cpu_tensors_raises(small):
    g, params = small
    x, w = torch.zeros(8, 8, 3), torch.zeros(3, 3, 3, 4)
    for kw in (dict(backend="pallas"), dict(use_pallas=True)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            apply_conv(x, w, IM2COL, **kw)
    run = compile_plan(g, use_pallas=True, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        run(params, np.zeros((32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="unknown backend"):
        apply_conv(x, w, IM2COL, backend="cuda")


def test_kernel_wrappers_reject_other_devices():
    meta = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gemm_call(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        conv_im2col_call(torch.empty(1, 4, 4, 1, device="meta"),
                         torch.empty(1, 1, 1, 1, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_extension
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    monkeypatch.delenv("CUDA_HOME")
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_library_path_tracks_sources():
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    for path in paths:
        assert path.parent == build.BUILD_DIR
        assert build.BUILD_DIR.relative_to(REPO) == Path("build/kernels")


def test_unported_algorithms_and_int8_kernels_raise():
    x, w = torch.zeros(8, 8, 3), torch.zeros(3, 3, 3, 4)
    for algo in (KN2ROW, WINO_2_3):
        for kw in ({}, dict(backend="reference"), dict(use_pallas=False)):
            with pytest.raises(NotImplementedError):
                apply_conv(x, w, algo, **kw)
    for kw in ({}, dict(backend="pallas")):
        with pytest.raises(NotImplementedError, match="int8"):
            apply_conv(x, w, IM2COL, precision="int8", in_scale=0.1, **kw)
    spec = LayoutSpec(kind="winograd", h=8, w=8, c=3, k1=3, k2=3, m=2, r=3)
    with pytest.raises(NotImplementedError):
        materialize(x, spec)
    with pytest.raises(NotImplementedError):
        restore(torch.zeros(16, 4, 4, 3), spec)


def test_later_slice_options_raise(small):
    g, params = small
    for kw in (dict(mesh=object()), dict(donate=True),
               dict(fault_hook=lambda: None)):
        with pytest.raises(NotImplementedError):
            compile_plan(g, device="cpu", **kw)
    for kw in (dict(pipeline_depth=2), dict(max_queue=4),
               dict(shed_deadline=True), dict(fault_plan=object()),
               dict(degrade=object()), dict(mesh=object()),
               dict(tuning=object()), dict(act_scales={1: 0.1})):
        with pytest.raises(NotImplementedError):
            CNNServingEngine(g, params, None, device="cpu", **kw)
    engine = CNNServingEngine(g, params, None, batch_size=1, device="cpu")
    with pytest.raises(NotImplementedError, match="swap_plan"):
        engine.swap_plan(None, {})


@pytest.mark.parametrize("backend", ["reference", "lax"])
def test_int8_emulation_matches_reference(backend):
    """The fake-quant int8 emulation of the plain backends, against the
    reference's (both quantize the same f32 operands identically)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 4, 6)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(6) * 0.1).astype(np.float32)
    kw = dict(stride=1, padding="SAME", backend=backend,
              epilogue="bias_relu", precision="int8", in_scale=0.03)
    got = apply_conv(torch.from_numpy(x), torch.from_numpy(w), IM2COL,
                     bias=torch.from_numpy(b), **kw)
    ref = jax_apply_conv(jnp.asarray(x), jnp.asarray(w), JAX_IM2COL,
                         bias=jnp.asarray(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    q = apply_conv(torch.from_numpy(x), torch.from_numpy(w), IM2COL,
                   bias=torch.from_numpy(b), out_scale=0.05, **kw)
    jq = jax_apply_conv(jnp.asarray(x), jnp.asarray(w), JAX_IM2COL,
                        bias=jnp.asarray(b), out_scale=0.05, **kw)
    assert q.dtype == torch.int8
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() \
        <= 1
