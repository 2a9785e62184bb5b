"""The port's LM serving engine (``repro_torch.serving.engine``) and the
LM strategy mapping (``repro_torch.core.lm_mapping``) against the JAX
package's on the CPU.

The engines decode greedily, so their token streams must be equal:
both run f32 on the reference's weights (``bridge.lm_params_from_jax``),
where the two packages' logits agree within 1e-4 of each other
(``tests/test_torch_lm_models.py``). The mappings are numpy over the two
packages' PBQP copies and must be equal exactly."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import lm_mapping as jax_lm
from repro.models.model import init_model as jax_init_model
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import lm_mapping
from repro_torch.launch import serve
from repro_torch.serving.engine import Request, ServingEngine


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


# (arch, config overrides, batch, max_len, requests, prompt length, new
# tokens): the reference's continuous-batching set-up (4 requests on 2
# slots), a window smaller than a request's length (the ring wraps),
# Mamba's recurrent state, MLA + MoE, and the Zamba hybrid.
CASES = [
    ("qwen2.5-14b", {}, 2, 64, 4, 5, 3),
    ("h2o-danube-1.8b", {"sliding_window": 6}, 2, 64, 3, 5, 4),
    ("mamba2-370m", {}, 2, 64, 3, 5, 3),
    ("deepseek-v2-236b", {}, 2, 64, 3, 5, 3),
    ("zamba2-2.7b", {}, 3, 32, 4, 4, 3),
]


def _requests(cls, vocab, n, prompt_len, new, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, prompt_len).astype(
        np.int32), max_new_tokens=new) for rid in range(n)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_engine_token_streams_equal_the_references(case):
    name, overrides, batch, max_len, n, prompt_len, new = case
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                               dtype="float32", **overrides)
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="float32", **overrides)
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    want_eng = JaxServingEngine(jcfg, jparams, batch_size=batch,
                                max_len=max_len)
    eng = ServingEngine(cfg, params, batch_size=batch, max_len=max_len,
                        device="cpu")
    for jr, r in zip(_requests(JaxRequest, cfg.vocab, n, prompt_len, new),
                     _requests(Request, cfg.vocab, n, prompt_len, new)):
        want_eng.submit(jr)
        eng.submit(r)
    want = want_eng.run_until_done()
    out = eng.run_until_done()
    assert sorted(out) == list(range(n))
    assert all(len(v) == new for v in out.values())
    assert all(0 <= t < cfg.vocab for v in out.values() for t in v)
    assert out == want
    assert [(s.rid, s.pos, s.remaining) for s in eng.slots] == \
        [(s.rid, s.pos, s.remaining) for s in want_eng.slots]


def test_serve_main_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", "qwen2.5-14b", "--reduced", "--requests",
                       "3", "--batch", "2", "--prompt-len", "4",
                       "--max-new", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == \
        [f"request {i}" for i in range(3)]
    assert "6 tokens" in lines[3] and "tok/s" in lines[3] \
        and "device cpu" in lines[3]


def test_lm_strategy_mapping_equals_the_references():
    """``map_layer_strategies`` and ``strategies_from_probes`` against
    ``repro.core.lm_mapping``'s, on the reference test's probe terms and on
    random ones with three layouts."""
    probes = {"seq": {"compute_s": 5.12, "memory_s": 17.0,
                      "collective_s": 18.04},
              "heads": {"compute_s": 5.16, "memory_s": 36.3,
                        "collective_s": 14.1}}
    rng = np.random.default_rng(9)
    random_probes = {f"s{i}": {k: float(v) for k, v in zip(
        ("compute_s", "memory_s", "collective_s"), rng.random(3) * 10)}
        for i in range(4)}
    layouts = {"s0": "a", "s1": "b", "s2": "a", "s3": "c"}
    for probe, lay, n_layers in ((probes, None, 40),
                                 (random_probes, layouts, 7)):
        got = lm_mapping.strategies_from_probes(probe, n_layers, lay)
        want = jax_lm.strategies_from_probes(probe, n_layers, lay)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]
        for resid in (0.0, 64e6, 1e12):
            a, res = lm_mapping.map_layer_strategies(n_layers, got, resid)
            ja, jres = jax_lm.map_layer_strategies(n_layers, want, resid)
            assert a == ja
            assert res.exact == jres.exact and res.cost == jres.cost
            assert lm_mapping.transition_cost_s("a", "b", resid) == \
                jax_lm.transition_cost_s("a", "b", resid)


@pytest.mark.parametrize("name, overrides", [
    ("h2o-danube-1.8b", {"sliding_window": 6}), ("mamba2-370m", {}),
    ("deepseek-v2-236b", {}), ("zamba2-2.7b", {})])
def test_static_buffer_step_equals_decode_step(name, overrides):
    """The step the engine's CUDA graph records (``_decode``: the static
    token and position buffers and the engine's cache), run eagerly on the
    CPU through ``decode_logits``, equals ``decode_step`` on a cloned cache
    bit for bit at every position (past a sliding window's ring); and
    every decode of a served trace goes through it, with the reference
    engine's token streams."""
    from repro_torch.models.model import decode_step
    from repro_torch.models.scan_util import tree_leaves, tree_map
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                               dtype="float32", **overrides)
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="float32", **overrides)
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    eng = ServingEngine(cfg, params, batch_size=3, max_len=16, device="cpu")
    cache = tree_map(torch.clone, eng.cache)
    rng = np.random.default_rng(4)
    for pos in range(16):
        slot, token = pos % 3, int(rng.integers(0, cfg.vocab))
        got = eng.decode_logits(slot, token, pos).clone()
        tokens = torch.zeros((3, 1), dtype=torch.long)
        tokens[slot, 0] = token
        want, cache = decode_step(params, tokens, cache, pos, cfg)
        assert torch.equal(got, want), pos
        assert torch.equal(eng._tokens, tokens)
        assert eng._pos.tolist() == [pos]
    for a, b in zip(tree_leaves(eng.cache), tree_leaves(cache)):
        assert torch.equal(a, b)
    assert eng._graph is None                 # the CPU never captures

    eng = ServingEngine(cfg, params, batch_size=2, max_len=32, device="cpu")
    want_eng = JaxServingEngine(jcfg, jparams, batch_size=2, max_len=32)
    calls = []
    decode = eng._decode
    eng._decode = lambda: calls.append(1) or decode()
    for jr, r in zip(_requests(JaxRequest, cfg.vocab, 3, 5, 3, seed=1),
                     _requests(Request, cfg.vocab, 3, 5, 3, seed=1)):
        want_eng.submit(jr)
        eng.submit(r)
    assert eng.run_until_done() == want_eng.run_until_done()
    assert len(calls) == 3 * (5 + 3)


def test_a_failed_capture_raises(monkeypatch):
    """On a card the first step is the warm pass, then the capture; a
    capture that fails raises out of ``decode_logits`` and leaves no
    graph, and the next step tries the capture again instead of going on
    eagerly. The card's stream and graph calls are stood in for on the
    CPU, the capture failing as it enters."""
    import contextlib
    import types
    cfg = dataclasses.replace(get_config("qwen2.5-14b", reduced=True),
                              dtype="float32")
    from repro_torch.models.model import init_model
    params = init_model(cfg, device="cpu")
    eng = ServingEngine(cfg, params, batch_size=2, max_len=16, device="cpu")
    eng.device = torch.device("cuda")
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())

    @contextlib.contextmanager
    def failing_capture(graph, stream=None, capture_error_mode=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
        yield

    monkeypatch.setattr(torch.cuda, "graph", failing_capture)
    decodes = []
    decode = eng._decode
    eng._decode = lambda: decodes.append(1) or decode()
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match="stream is capturing"):
            eng.decode_logits(0, 3, 0)
        assert eng._graph is None and eng._logits is None
        assert len(decodes) == attempt           # the warm pass only
