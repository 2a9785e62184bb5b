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
