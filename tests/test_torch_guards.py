"""Guards of the port: it imports nothing of JAX or the reference, its
entry points never fall back to the CPU or to another implementation, and
what is not ported yet raises instead of running something else."""
import ast
import ctypes
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.overlay import apply_conv as jax_apply_conv
from repro.core.algorithms import IM2COL as JAX_IM2COL
from repro_torch.bridge import (lm_params_from_jax, opt_state_from_jax,
                                params_from_jax)
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, make_batch
from repro_torch.cnn.executor import compile_plan, forward, init_params
from repro_torch.cnn.models import googlenet, inception_v4
from repro_torch.cnn.overlay import apply_conv
from repro_torch.core.algorithms import IM2COL, KN2ROW, WINO_2_3
from repro_torch.kernels.conv_im2col.ref import conv_ref
from repro_torch.core.layouts import LayoutSpec
from repro_torch.kernels import build
from repro_torch.kernels.conv_im2col import conv_im2col as conv_mod
from repro_torch.kernels.conv_im2col.conv_im2col import conv_im2col_call
from repro_torch.kernels.gemm import gemm as gemm_mod
from repro_torch.kernels.gemm.gemm import gemm_call
from repro_torch.kernels.kn2row import kn2row as kn2row_mod
from repro_torch.kernels.kn2row.kn2row import (pad_accumulate_call,
                                               unit_conv_gemms_call)
from repro_torch.kernels.winograd import winograd as winograd_mod
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.distributed.fault import FaultPlan
from repro_torch.serving.cnn_engine import (CNNRequest, CNNServingEngine,
                                            DegradeConfig)
from repro_torch.serving.multi_engine import MultiModelEngine
from repro_torch.launch.mesh import (make_data_mesh, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.launch import serve, train
from repro_torch.configs import get_config
from repro_torch.models.model import init_model
from repro_torch.serving.engine import ServingEngine

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
    examples = sorted((REPO / "examples").glob("*_torch.py"))
    files += [REPO / "chip_smoke.py", REPO / "tools" / "bench_serving.py",
              REPO / "tools" / "bench_autotune.py",
              REPO / "tools" / "check_mesh.py",
              REPO / "tools" / "check_train_graph.py",
              *(REPO / "tools" / f"time_{t}.py"
                for t in ("graphs", "f32_loops", "pad_accumulate",
                          "i8_conv")), *examples]
    assert len(files) > 15
    assert {f.name for f in examples} >= {"quickstart_torch.py",
                                          "serve_cnn_torch.py",
                                          "train_lm_torch.py",
                                          "serve_lm_torch.py",
                                          "algorithm_mapping_tour_torch.py"}
    names = {str(f.relative_to(REPO / "src" / "repro_torch")) for f in files
             if "repro_torch" in f.parts}
    assert {"kernels/winograd/winograd.py", "kernels/winograd/ops.py",
            "kernels/winograd/ref.py", "kernels/layouts.py",
            "kernels/gemm/gemm.py", "kernels/kn2row/kn2row.py",
            "kernels/kn2row/ops.py", "kernels/kn2row/ref.py",
            "core/quant.py", "core/autotune.py",
            "serving/multi_engine.py", "serving/supervisor.py",
            "launch/mesh.py", "distributed/sharding.py", "configs/base.py",
            "configs/googlenet.py", "core/lm_mapping.py", "models/model.py",
            "models/attention.py", "models/ssm.py", "models/moe.py",
            "models/layers.py", "models/scan_util.py", "serving/engine.py",
            "launch/serve.py", "optim/adamw.py", "data/pipeline.py",
            "checkpoint/manager.py", "distributed/fault.py",
            "launch/steps.py", "launch/train.py", "bridge.py",
            "distributed/api.py", "launch/dryrun.py", "launch/roofline.py",
            "launch/mesh_check.py", "hw.py"} <= names
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
                                                             small,
                                                             tmp_path):
    g, params = small
    x = np.zeros((32, 32, 3), np.float32)
    calls = [lambda: init_params(g),
             lambda: compile_plan(g),
             lambda: forward(g, params, x),
             lambda: CNNServingEngine(g, params, None),
             lambda: MultiModelEngine().register_model("m", g, params, None),
             lambda: params_from_jax({0: {"w": np.zeros(3, np.float32)}}),
             lambda: make_data_mesh(),
             lambda: make_smoke_mesh(),
             lambda: make_production_mesh(),
             lambda: init_model(get_config("qwen2.5-14b", reduced=True)),
             lambda: ServingEngine(get_config("qwen2.5-14b", reduced=True),
                                   {}, batch_size=1),
             lambda: lm_params_from_jax({"w": np.zeros(3, np.float32)}),
             lambda: serve.main(["--arch", "qwen2.5-14b", "--reduced"]),
             lambda: train.main(["--arch", "mamba2-370m", "--reduced",
                                 "--ckpt-dir", str(tmp_path)]),
             lambda: make_batch(DataConfig(global_batch=2, seq_len=8),
                                get_config("mamba2-370m", reduced=True), 0),
             lambda: PrefetchIterator(DataConfig(global_batch=2, seq_len=8),
                                      get_config("mamba2-370m",
                                                 reduced=True)),
             lambda: CheckpointManager(tmp_path).restore(
                 {"a": torch.empty(3, device="meta")}),
             lambda: opt_state_from_jax(({}, {}, np.int32(0)))]
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
    with pytest.raises(ValueError, match="unsupported device"):
        unit_conv_gemms_call(meta, torch.empty(9, 4, 2, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pad_accumulate_call(torch.empty(9, 1, 4, 4, 2, device="meta"),
                            k1=3, k2=3, o1=4, o2=4)


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
    assert build.SOURCES == ("gemm", "conv_im2col", "winograd", "kn2row")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    for path in paths:
        assert path.parent == build.BUILD_DIR
        assert build.BUILD_DIR.relative_to(REPO) == Path("build/kernels")


def test_library_path_tracks_the_int8_mma_header(monkeypatch, tmp_path):
    """An edit of tile_mma_i8.cuh, the mainloop of gemm_i8,
    unit_conv_gemms_i8 and conv_im2col_i8, gives their three libraries a
    new path, so they rebuild; conv_im2col.cu includes the header."""
    assert '#include "tile_mma_i8.cuh"' in (
        build.CSRC / "conv_im2col.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name)
              for name in ("gemm", "kn2row", "conv_im2col")}
    header = csrc / "tile_mma_i8.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert build.library_path(name) != path


def test_library_path_tracks_the_async_f32_header(monkeypatch, tmp_path):
    """An edit of tile_gemm_async.cuh, the mainloop and split-K reduce of
    gemm_f32, batched_gemm_f32, unit_conv_gemms_f32 and conv_im2col_f32,
    gives their three libraries a new path, so they rebuild; conv_im2col.cu
    includes the header."""
    assert '#include "tile_gemm_async.cuh"' in (
        build.CSRC / "conv_im2col.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name)
              for name in ("gemm", "kn2row", "conv_im2col")}
    header = csrc / "tile_gemm_async.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert build.library_path(name) != path


# Every C entry point the wrappers bind, by module.
CUDA_KERNELS = [k for mod in (gemm_mod, conv_mod, kn2row_mod, winograd_mod)
                for k in vars(mod).values() if isinstance(k, build.CudaKernel)]
C_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
           ctypes.c_float: "float"}


def _c_params(source: str, symbol: str):
    """The kinds of the parameters of ``extern "C" int symbol(...)`` in
    csrc/<source>.cu: "pointer" for any ``T*``, else the scalar type."""
    text = (build.CSRC / f"{source}.cu").read_text()
    sig = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert sig, f"no extern \"C\" {symbol} in {source}.cu"
    kinds = []
    for param in sig[1].split(","):
        param = " ".join(param.split())
        kinds.append("pointer" if "*" in param else param.split()[-2])
    return kinds


def test_every_kernel_library_entry_is_bound():
    """The wrappers bind twenty-two C entry points (the bf16 GEMMs one per
    loop), and every ``extern "C"`` function of csrc/*.cu is one of
    them."""
    bound = {(k.source, k.symbol) for k in CUDA_KERNELS}
    assert len(CUDA_KERNELS) == len(bound) == 22
    defined = {(path.stem, name) for path in build.CSRC.glob("*.cu")
               for name in re.findall(r'extern "C" int (\w+)\(',
                                      path.read_text())}
    assert defined == bound


@pytest.mark.parametrize("kernel", CUDA_KERNELS,
                         ids=[k.symbol for k in CUDA_KERNELS])
def test_kernel_argtypes_match_the_c_entry_point(kernel):
    """ctypes passes each argument as its argtype says, so a wrapper whose
    argtypes drift from the C parameter list corrupts arguments silently:
    the counts and the pointer / int / float kinds must match."""
    assert [C_KINDS[t] for t in kernel.argtypes] == \
        _c_params(kernel.source, kernel.symbol)


def test_unrolled_offsets_match_the_kernels_dispatch():
    """The wrapper's UNROLLED_OFFSETS (what the CPU tests hold the main
    paths to) are the (K1, K2) that csrc/kn2row.cu instantiates with its
    offsets unrolled; every other K1 x K2 takes the generic <0, 0, V>."""
    text = (build.CSRC / "kn2row.cu").read_text()
    body = re.search(r"void dispatch_offsets\(.*?\n}\n", text, re.S)[0]
    pairs = re.findall(r"g\.k1 == (\d+) && g\.k2 == (\d+)\)\s*"
                       r"launch\.template run<(\d+), (\d+), V>", body)
    assert all((a, b) == (c, d) for a, b, c, d in pairs)
    assert [(int(a), int(b)) for a, b, _, _ in pairs] == \
        list(kn2row_mod.UNROLLED_OFFSETS)
    assert "launch.template run<0, 0, V>" in body


def test_int8_gather_rule_matches_the_kernels_dispatch():
    """conv_im2col_i8's entry point takes the 16-byte gather path under
    csrc/conv_im2col.cu::conv_i8_vector_path; the wrapper's I8_GATHER_RULE
    states the same divisors, and under it every conv of full-width
    Inception-v4 but stem/c1 (Cin 3) gathers 16 bytes at a time from
    aligned operands, and none from a map one byte off alignment."""
    text = (build.CSRC / "conv_im2col.cu").read_text()
    body = re.search(r"inline bool conv_i8_vector_path\(.*?\n}\n", text,
                     re.S)[0]
    terms = re.findall(r"(?:reinterpret_cast<uintptr_t>\()?(\w+)\)? % (\d+) "
                       r"== 0", body)
    assert {name: int(d) for name, d in terms} == conv_mod.I8_GATHER_RULE
    assert "(int)conv_i8_vector_path(x, w, c_in, c_out)" in text
    graph = inception_v4(res=299, scale=1.0)
    byte_path = [n.name for n in graph.conv_nodes()
                 if not conv_mod.conv_i8_vector_path(n.conv.c_in,
                                                     n.conv.c_out, 256, 256)]
    assert byte_path == ["stem/c1"]
    assert len(graph.conv_nodes()) == 149
    assert not conv_mod.conv_i8_vector_path(192, 224, 257, 256)
    assert not conv_mod.conv_i8_vector_path(192, 224, 256, 258)
    assert not conv_mod.conv_i8_vector_path(192, 30, 256, 256)


def test_unported_algorithms_and_int8_kernels_raise():
    """Every algorithm and every int8 kernel is ported: kn2row runs on the
    plain backends (CPU tensors) and computes the direct conv; an int8
    im2col or kn2row layer on CPU tensors runs the int8 kernels' plain
    versions (true int8, equal to the fake-quant emulation at 1e-4) unless
    the kernels themselves are asked for, which raises ``ValueError`` as
    for f32. Winograd still rejects int8 with the reference's
    ``ValueError``."""
    x, w = torch.zeros(8, 8, 3), torch.zeros(3, 3, 3, 4)
    xr = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8, 3)).astype(np.float32))
    wr = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 1, 3, 4)).astype(np.float32))
    for kw in ({}, dict(backend="reference"), dict(use_pallas=False),
               dict(backend="lax")):
        got = apply_conv(xr, wr, KN2ROW, **kw)
        np.testing.assert_allclose(got.numpy(), conv_ref(xr, wr).numpy(),
                                   rtol=1e-4, atol=1e-4)
    q = dict(precision="int8", in_scale=0.03)
    for algo in (IM2COL, KN2ROW):
        with pytest.raises(ValueError, match="CUDA tensors"):
            apply_conv(x, w, algo, backend="pallas", **q)
        np.testing.assert_allclose(
            apply_conv(xr, wr, algo, **q).numpy(),
            apply_conv(xr, wr, algo, backend="lax", **q).numpy(),
            rtol=1e-4, atol=1e-4)
    for kw in ({}, dict(backend="reference"), dict(backend="lax")):
        with pytest.raises(ValueError, match="bf16-only"):
            apply_conv(x, w, WINO_2_3, precision="int8", in_scale=0.1, **kw)
    spec = LayoutSpec(kind="winograd", h=8, w=8, c=3, k1=3, k2=3, m=2, r=3)
    tiles = materialize(x, spec)
    assert tuple(tiles.shape) == (16, 4, 4, 3)
    assert torch.equal(restore(tiles, spec), x)


def test_later_slice_options_raise(small):
    """Every option of the reference's ``compile_plan`` and engine that a
    slice has ported is taken: the fused-epilogue options ``default_algo=``
    and ``avg_pool_via=`` (``tests/test_torch_fused_epilogue.py``, module
    item A), the mesh (``tests/test_torch_mesh.py``),
    which refuses anything but a ``launch.mesh.DataMesh`` with a
    ``TypeError``; the serving slice's options (donation, the fault hook,
    pipelining, admission, shedding, faults, degrade), ``act_scales=``
    (the int8 slice) and ``tuning=`` (``tests/test_torch_autotune.py``),
    and plan hot-swap (``tests/test_torch_plan_hotswap.py``)."""
    g, params = small
    with pytest.raises(TypeError, match="DataMesh"):
        compile_plan(g, device="cpu", mesh=object())
    calls = []
    run = compile_plan(g, device="cpu", donate=True, default_algo=KN2ROW,
                       avg_pool_via="overlay",
                       fault_hook=lambda: calls.append(1))
    assert run(params, np.zeros((1, 32, 32, 3), np.float32)).shape[0] == 1
    assert calls == [1]
    with pytest.raises(TypeError, match="DataMesh"):
        CNNServingEngine(g, params, None, device="cpu", mesh=object())
    engine = CNNServingEngine(
        g, params, None, buckets=(2,), pipeline_depth=2, max_queue=4,
        shed_deadline=True, slo_s=10.0, fault_plan=FaultPlan({}),
        degrade=DegradeConfig(), device="cpu")
    engine.submit(CNNRequest(rid=0, image=np.zeros((32, 32, 3))))
    assert set(engine.run_until_done()) == {0}
    scales = {n.id: 0.1 for n in g.conv_nodes()}
    engine = CNNServingEngine(g, params, None, batch_size=1, device="cpu",
                              act_scales=scales)
    assert engine.stats()["precision"]["calibrated"]


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
