"""The port's compiled programs as captured CUDA graphs, checked on the CPU.

Nothing here can capture: the CPU has no CUDA graphs. So the tests hold
what the CPU can see:

- the capture key (input shape and the params' pointers);
- the CPU path, which never captures and equals ``forward`` bit for bit,
  and agrees with the reference's jitted program on the same numpy inputs
  at its whole-plan tolerance (rtol 2e-2, atol 2e-3);
- the capture helper, which raises off the card;
- the CUDA path's stages (eager walk, capture, replay), with the capture
  faked by a graph whose replay walks the lowering on the CPU into the
  static output, so its copy-in, replay and clone-out run here;
- the engine handing its staging slice to the program, and its warm-up
  estimate coming from the last (replayed) dispatch;
- the modules of the forward's call path, which hold no host-synchronizing
  call (a capture would fail on one).
"""
import collections
import dataclasses
import inspect
import io
import sys
import threading
import tokenize
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import googlenet as jax_googlenet
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import map_network as jax_map_network
from repro_torch.bridge import params_from_jax
from repro_torch.cnn import executor
from repro_torch.cnn.executor import (CompiledProgram, _eval_graph,
                                      capture_forward, capture_key,
                                      compile_plan, forward, init_params)
from repro_torch.cnn.models import googlenet, inception_v4, vgg16
from repro_torch.core.algorithms import AlgoFamily
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import lower_plan, map_network
from repro_torch.serving import cnn_engine
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


REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)


def _planned(graph):
    return graph, map_network(graph, hw=identify_parameters(graph,
                                                            max_dim=512))


@pytest.fixture(scope="module")
def small():
    g, plan = _planned(googlenet(res=32, scale=0.125))
    return g, plan, init_params(g, seed=0, device="cpu")


def _images(n, res, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, res, res, 3)).astype(np.float32)


# ------------------------------------------------------------ capture key
def _key_pair(case, params):
    x = torch.zeros(2, 32, 32, 3)
    if case == "other tensors":
        other = {n: {k: t.clone() for k, t in d.items()}
                 for n, d in params.items()}
        return capture_key(params, x), capture_key(other, x)
    if case == "same tensors, new dict":
        same = {n: dict(d) for n, d in params.items()}
        return capture_key(params, x), capture_key(same, x)
    if case == "other input shape":
        return (capture_key(params, x),
                capture_key(params, torch.zeros(1, 32, 32, 3)))
    assert case == "numpy input"
    return (capture_key(params, x),
            capture_key(params, np.zeros((2, 32, 32, 3), np.float32)))


@pytest.mark.parametrize("case, same_key", [
    ("other tensors", False), ("same tensors, new dict", True),
    ("other input shape", False), ("numpy input", True)])
def test_capture_key(small, case, same_key):
    """A graph binds pointers: other params tensors need another capture,
    a new dict of the same tensors does not; each input shape has its
    own."""
    _, _, params = small
    a, b = _key_pair(case, params)
    assert (a == b) is same_key


# ------------------------------------------------------- the CPU path
def _int8(graph, plan):
    """``plan`` with every im2col and kn2row conv in int8, and one
    activation scale for all (the numbers are not the point here)."""
    prec = {n.id: "int8" for n in graph.conv_nodes()
            if plan.assignment[n.id].family is not AlgoFamily.WINOGRAD}
    return (dataclasses.replace(plan, precisions=prec),
            {nid: 0.05 for nid in prec})


CPU_CASES = {
    "googlenet b2 elided": (lambda: googlenet(res=32, scale=0.125), 2,
                            True, False),
    "googlenet one image": (lambda: googlenet(res=32, scale=0.125), None,
                            True, False),
    "googlenet b2 not elided": (lambda: googlenet(res=32, scale=0.125), 2,
                                False, False),
    "vgg16 b2": (lambda: vgg16(res=32, scale=0.125), 2, True, False),
    "inception_v4 b2": (lambda: inception_v4(res=75, scale=0.2, n_a=1,
                                             n_b=1, n_c=1), 2, True, False),
    "googlenet int8 b2": (lambda: googlenet(res=32, scale=0.125), 2, True,
                          True),
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_cpu_program_never_captures_and_equals_forward(case):
    """Three calls of a CPU program: nothing captured, and every output
    equal to the eager ``forward`` bit for bit."""
    build, batch, elide, int8 = CPU_CASES[case]
    g, plan = _planned(build())
    scales = None
    if int8:
        plan, scales = _int8(g, plan)
    params = init_params(g, seed=3, device="cpu")
    res = int(g.nodes[g.source()].attrs["out_shape"][0])
    x = _images(batch or 1, res, seed=4)
    if batch is None:
        x = x[0]
    run = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       act_scales=scales, device="cpu")
    want = forward(g, params, x, plan, epilogue="bias_relu", elide=elide,
                   act_scales=scales, device="cpu")
    for _ in range(3):
        assert torch.equal(run(params, x), want)
    assert run.captures == {}
    assert isinstance(run, CompiledProgram) and run.lowering is not None


def _np_params(graph, seed):
    """``{nid: {"w", "b"}}`` as the reference lays it out, from numpy."""
    rng = np.random.default_rng(seed)
    params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.conv is not None:
            m = node.conv
            shape, fan_in, fan_out = ((m.k1, m.k2, m.c_in, m.c_out),
                                      m.k1 * m.k2 * m.c_in, m.c_out)
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


@pytest.mark.parametrize("bucket", [1, 4])
def test_cpu_program_calls_match_the_reference_program(bucket):
    """The slice as a whole: three calls of the port's program against the
    reference's jitted program on the same numpy weights and images."""
    g, plan = _planned(googlenet(res=56, scale=0.25))
    jg = jax_googlenet(res=56, scale=0.25)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    np_params = _np_params(jg, seed=6)
    x = _images(bucket, 56, seed=7)
    want = np.asarray(jax_compile_plan(jg, jplan, epilogue="bias_relu",
                                       tuning_batch=bucket)(np_params, x))
    run = compile_plan(g, plan, epilogue="bias_relu", tuning_batch=bucket,
                       device="cpu")
    params = params_from_jax(np_params, "cpu")
    for _ in range(3):
        np.testing.assert_allclose(run(params, x).numpy(), want, **PLAN_TOL)


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 32, 32, 3)])
def test_capture_helper_raises_on_cpu(small, shape):
    """The CPU never captures: the helper refuses a CPU tensor instead of
    running anything."""
    g, plan, params = small
    lowering = lower_plan(g, plan, epilogue="bias_relu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        capture_forward(g, lowering, params, torch.zeros(shape), None)


# ---------------------------------------- the CUDA path's stages, faked
class _CpuGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``: a replay walks
    the lowering on the CPU from the static input into the static output
    (in place, as a replay writes its pool)."""

    def __init__(self, g, lowering, params, use_pallas, avg_pool_via="jnp"):
        self.args = (g, lowering, params, use_pallas, avg_pool_via)
        self.replays = 0
        self.entry = None

    def replay(self):
        g, lowering, params, use_pallas, avg_pool_via = self.args
        self.replays += 1
        self.entry.static_out.copy_(_eval_graph(
            g, lowering, params, self.entry.static_in, use_pallas,
            avg_pool_via))


@pytest.fixture
def fake_cuda(monkeypatch):
    """A CUDA program whose capture is ``_CpuGraph``; returns the list of
    captures made."""
    made = []

    def fake_capture(g, lowering, params, x, use_pallas, avg_pool_via):
        graph = _CpuGraph(g, lowering, params, use_pallas, avg_pool_via)
        entry = executor._Capture(graph, x.clone(), torch.empty(0))
        graph.entry = entry
        entry.static_out = _eval_graph(g, lowering, params, entry.static_in,
                                       use_pallas, avg_pool_via).mul_(0)
        made.append(entry)
        return entry

    monkeypatch.setattr(executor, "capture_forward", fake_capture)
    monkeypatch.setattr(executor, "_as_input",
                        lambda x, dev: torch.as_tensor(x,
                                                       dtype=torch.float32))
    return made


def _cuda_program(g, plan):
    return CompiledProgram(g, lower_plan(g, plan, epilogue="bias_relu"),
                           None, torch.device("cuda"))


def test_cuda_program_walks_then_captures_then_replays(small, fake_cuda):
    """First call per key: the eager walk, no capture; second: one capture
    and one replay; later: the new input copied in, a replay, and a clone
    of the static output (a returned tensor survives the next replay)."""
    g, plan, params = small
    run = _cuda_program(g, plan)
    xs = [_images(2, 32, seed=s) for s in range(4)]
    want = [forward(g, params, x, plan, epilogue="bias_relu", device="cpu")
            for x in xs]
    assert torch.equal(run(params, xs[0]), want[0])
    assert fake_cuda == [] and list(run.captures.values()) == [None]
    assert torch.equal(run(params, xs[1]), want[1])
    (entry,) = fake_cuda
    assert entry.graph.replays == 1 and run.captures[
        capture_key(params, xs[1])] is entry
    third = run(params, xs[2])
    assert torch.equal(third, want[2]) and entry.graph.replays == 2
    assert third.data_ptr() != entry.static_out.data_ptr()
    assert torch.equal(run(params, torch.as_tensor(xs[3])), want[3])
    assert torch.equal(third, want[2])                 # not overwritten
    other = {n: {k: t.clone() for k, t in d.items()}
             for n, d in params.items()}
    assert torch.equal(run(params=other, x=xs[0]), want[0])
    assert len(fake_cuda) == 1 and len(run.captures) == 2


def test_cuda_program_is_safe_across_threads(small, fake_cuda):
    """Many threads share one program (as engines share one through
    ``ExecutableCache``): one capture in all, and every thread gets the
    output of its own input — a copy-in of one thread never lands in
    another's replay."""
    g, plan, params = small
    run = _cuda_program(g, plan)
    xs = [_images(1, 32, seed=10 + s) for s in range(4)]
    want = [forward(g, params, x, plan, epilogue="bias_relu", device="cpu")
            for x in xs]
    errors = []

    def worker(i):
        try:
            for j in range(6):
                k = (i + j) % len(xs)
                if not torch.equal(run(params, xs[k]), want[k]):
                    errors.append((i, j))
        except Exception as exc:                       # reported below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(fake_cuda) == 1 and len(run.captures) == 1


# ---------------------------------------------------------------- engine
class _SpyProgram:
    """Records the tensor each dispatch hands it; returns zero logits."""

    def __init__(self):
        self.received = []

    def __call__(self, params, x):
        self.received.append(x)
        return torch.zeros(x.shape[0], 10)


@pytest.mark.parametrize("n_requests, bucket", [(1, 1), (3, 4), (4, 4)])
def test_engine_hands_its_staging_slice_to_the_program(small, n_requests,
                                                       bucket):
    """A tick passes the staging buffer's leading rows themselves — no
    ``.to()`` copy — and the program copies them into its static input."""
    g, plan, params = small
    eng = CNNServingEngine(g, params, plan, batch_size=4, device="cpu")
    spy = _SpyProgram()
    eng._runs = {b: spy for b in eng.buckets}
    imgs = _images(n_requests, 32, seed=2)
    for rid in range(n_requests):
        eng.submit(CNNRequest(rid=rid, image=imgs[rid]))
    assert eng.step(flush=True) == n_requests
    (x,) = spy.received
    assert tuple(x.shape) == (bucket, 32, 32, 3)
    assert x.data_ptr() == eng._staging.data_ptr()
    assert x.untyped_storage().data_ptr() == \
        eng._staging.untyped_storage().data_ptr()
    assert np.array_equal(x[:n_requests].numpy(), imgs)
    assert not x[n_requests:].any()


def test_warmup_estimate_is_the_last_warm_dispatch(small, monkeypatch):
    """Warm-up dispatches each bucket three times (eager, capture, replay)
    through the staging buffer, and the estimate is the third's wall
    time: the k-th dispatch of bucket b takes 10k + b seconds here."""
    g, plan, params = small
    eng = CNNServingEngine(g, params, plan, batch_size=4, device="cpu")
    now = [0.0]
    monkeypatch.setattr(cnn_engine, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0]))
    calls = collections.Counter()

    def spy(bucket):
        def run(p, x):
            assert x.data_ptr() == eng._staging.data_ptr()
            calls[bucket] += 1
            now[0] += 10.0 * calls[bucket] + bucket
            return torch.zeros(bucket, 10)
        return run

    eng._runs = {b: spy(b) for b in eng.buckets}
    eng._warmup()
    assert calls == {1: 3, 2: 3, 4: 3}
    assert eng._svc == {1: 31.0, 2: 32.0, 4: 34.0}


# -------------------------------------------------- host syncs on the path
SYNC_CALLS = (".item(", ".cpu(", ".tolist(", ".numpy(",
              "torch.cuda.synchronize")
PATH_FILES = sorted(
    str(p.relative_to(PORT)) for p in [*(PORT / "kernels").rglob("*.py"),
                                       PORT / "cnn" / "overlay.py",
                                       PORT / "cnn" / "layers.py"]
    if p.name != "build.py")
EXECUTOR_PATH = ("_Staged", "_eval_graph", "capture_forward",
                 "CompiledProgram")


def _code(source: str) -> str:
    """``source``'s names and operators run together: comments, strings
    and docstrings dropped."""
    keep = (tokenize.NAME, tokenize.OP)
    return "".join(t.string for t in tokenize.generate_tokens(
        io.StringIO(source).readline) if t.type in keep)


@pytest.mark.parametrize("where", PATH_FILES + [
    f"cnn/executor.py::{name}" for name in EXECUTOR_PATH])
def test_forward_path_has_no_host_sync(where):
    """A capture fails on a call that waits for the device or copies to
    the host: no module of the forward's call path holds one."""
    if "::" in where:
        source = inspect.getsource(getattr(executor, where.split("::")[1]))
    else:
        source = (PORT / where).read_text()
    code = _code(source)
    assert [c for c in SYNC_CALLS if c in code] == []
