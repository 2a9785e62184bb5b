"""The port's ``core.autotune`` against the reference's, on the CPU.

Three kinds of test:

* twins of the reference's autotuning tests (``tests/test_autotune.py``,
  the bucket-keyed record tests of ``tests/test_dynamic_batching.py``,
  ``test_tune_elision_returns_overrides`` and the junk-backend check of
  ``tests/test_layout_elision.py``, the mixed-backend compiled plan of
  ``tests/test_fused_epilogue.py`` and the precision keys of
  ``tests/test_quantized.py``), run on the port with ``device="cpu"``;
* parity with the reference: the same candidate lists, records that cross
  between the packages in both directions, and — with one deterministic
  fake timer patched into both packages — equal ``tune_layer``,
  ``autotune_buckets`` and ``tune_elision`` results; ``refresh_from_service``
  in the reference's scenarios; tuned compiled plans and tuned engines on
  the same record at the whole-plan tolerance (rtol 2e-2, atol 2e-3);
* the executor's cache key and the no-fallback rule (a kernel candidate on
  the CPU raises; a CUDA default without a card raises).
"""
import dataclasses
import json
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import executor as jax_executor
from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import _start as jax_start
from repro.cnn.models import googlenet as jax_googlenet
from repro.cnn.models import inception_v4 as jax_inception_v4
from repro.cnn.models import vgg16 as jax_vgg16
from repro.core import autotune as jax_autotune
from repro.core.dse import identify_parameters as jax_identify
from repro.core.graph import LayerKind as JaxLayerKind
from repro.core.mapper import map_network as jax_map_network
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn import executor, overlay
from repro_torch.cnn.executor import (ExecutableCache, compile_plan,
                                      executable_cache_key, forward,
                                      init_params)
from repro_torch.cnn.models import _start, googlenet, inception_v4, vgg16
from repro_torch.core import autotune
from repro_torch.core.algorithms import IM2COL, KN2ROW, WINO_2_3, WINO_4_3
from repro_torch.core.autotune import (Binding, LayerTuning, TuningRecord,
                                       algo_from_key, autotune_buckets,
                                       autotune_graph, benchmark_binding,
                                       candidate_bindings, conv_key,
                                       elision_overrides_from_meta,
                                       parse_record_key, record_key,
                                       refresh_from_service,
                                       signature_coverage, tune_elision,
                                       tune_layer)
from repro_torch.core.cost_model import Dataflow
from repro_torch.core.dse import identify_parameters
from repro_torch.core.graph import ConvMeta, LayerKind
from repro_torch.core.mapper import lower_plan, map_network
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


PLAN_TOL = dict(rtol=2e-2, atol=2e-3)
CPU = dict(device="cpu")
CONV = ConvMeta(c_in=4, c_out=6, h1=8, h2=8, k1=3, k2=3, stride=1)
# The four kernel tiles (``kernels/gemm/gemm.py::kernel_tile``).
FOUR_PAIRS = ((64, 64), (64, 128), (128, 64), (128, 128))


@pytest.fixture(scope="module")
def tiny():
    g = vgg16(res=8, scale=0.05)
    return g, init_params(g, seed=0, device="cpu")


def _np_params(graph, seed):
    """``{nid: {"w", "b"}}`` in the layout of the reference's
    ``init_params``, drawn with numpy (biases non-zero)."""
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


@pytest.fixture(scope="module")
def served():
    """Reduced GoogleNet planned by both packages, and numpy params."""
    g = googlenet(res=56, scale=0.25)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    jg = jax_googlenet(res=56, scale=0.25)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    return g, plan, jg, jplan, _np_params(jg, seed=7)


def _tuning(label_s: float, batch: int = 1,
            precision: str = "bf16") -> LayerTuning:
    b = Binding("im2col", "NS", 128, 128, "reference")
    return LayerTuning(binding=b, measured_s=label_s,
                       candidates=[(b.label(), label_s)],
                       batch=batch, precision=precision)


def _low_fields(low):
    """A ConvLowering of either package as comparable plain values."""
    if low is None:
        return None
    return (low.algo.key, low.dataflow.name, low.p1, low.p2, low.backend)


def _pick(seed: str, n: int) -> int:
    return zlib.crc32(seed.encode()) % n


# --------------------------------------------------- twins: test_autotune
def test_conv_key_identifies_shape():
    assert conv_key(CONV) == "c4x6_h8x8_k3x3_s1_same"
    assert conv_key(CONV) != conv_key(
        ConvMeta(c_in=4, c_out=6, h1=8, h2=8, k1=3, k2=3, stride=2))


@pytest.mark.parametrize("algo", [IM2COL, KN2ROW, WINO_2_3, WINO_4_3])
def test_algo_key_roundtrip(algo):
    assert algo_from_key(algo.key) == algo


def test_algo_from_key_rejects_garbage():
    with pytest.raises(ValueError, match="unparseable"):
        algo_from_key("fft")


def test_candidate_bindings_shape_of_search_space():
    """lax is algorithm-independent (1 candidate); reference ignores the
    block binding (1 candidate/algo); the kernels sweep dataflows ×
    (p1, p2)."""
    cands = candidate_bindings(CONV, p1p2=[(128, 128), (256, 128)])
    lax = [c for c in cands if c.backend == "lax"]
    assert len(lax) == 1
    ref = [c for c in cands if c.backend == "reference"]
    pal = [c for c in cands if c.backend == "pallas"]
    assert len(ref) == len({c.algo_key for c in ref})
    per_algo = {}
    for c in pal:
        per_algo.setdefault(c.algo_key, []).append(c)
    for group in per_algo.values():
        assert len(group) == 3 * 2
    ref_only = candidate_bindings(CONV, backends=("reference",))
    assert all(c.backend == "reference" for c in ref_only)
    assert len(ref_only) == len(ref)


def test_tune_layer_picks_measured_min():
    tuned = tune_layer(CONV, backends=("reference",), reps=1, **CPU)
    assert tuned.candidates
    best_label, best_s = min(tuned.candidates, key=lambda c: c[1])
    assert tuned.binding.label() == best_label
    assert tuned.measured_s == best_s
    assert tuned.binding.backend == "reference"


def test_record_roundtrip_and_lowering(tmp_path, tiny):
    g, _ = tiny
    rec = autotune_graph(g, backends=("reference",), reps=1,
                         record=TuningRecord(), **CPU)
    assert len(rec.entries) > 0
    assert rec.meta["backend"] == "cpu"
    path = tmp_path / "tuning.json"
    rec.save(path)
    rec2 = TuningRecord.load(path)
    assert rec2.entries.keys() == rec.entries.keys()
    for key in rec.entries:
        assert rec2.entries[key].binding == rec.entries[key].binding
    lowering = lower_plan(g, None, default_algo=KN2ROW, tuning=rec2)
    for node in g.conv_nodes():
        tuned = rec2.entries[record_key(node.conv)]
        low = lowering[node.id]
        assert low.algo == tuned.binding.algo
        assert low.backend == tuned.binding.backend
        assert (low.p1, low.p2) == (tuned.binding.p1, tuned.binding.p2)
        assert low.dataflow is Dataflow[tuned.binding.dataflow]
        assert low.epilogue == "relu"


def test_autotune_incremental_skip_known(tiny):
    g, _ = tiny
    rec = autotune_graph(g, backends=("reference",), reps=1, **CPU)
    stamped = {k: t.measured_s for k, t in rec.entries.items()}
    rec = autotune_graph(g, backends=("reference",), reps=1, record=rec,
                         skip_known=True, **CPU)
    assert {k: t.measured_s for k, t in rec.entries.items()} == stamped


def test_tuned_compiled_plan_equivalent(tiny):
    """A tuned record changes bindings, never the function."""
    g, params = tiny
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator()
                    .manual_seed(1))
    rec = autotune_graph(g, backends=("lax", "reference"), reps=1, **CPU)
    got = compile_plan(g, tuning=rec, **CPU)(params, x)
    ref = compile_plan(g, **CPU)(params, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **PLAN_TOL)


def test_version_mismatch_rejected():
    with pytest.raises(ValueError, match="version"):
        TuningRecord.from_json({"version": 99, "entries": {}})


class TestMergePrecisionMigration:
    def test_precision_keys_never_collide(self):
        k_bf16 = record_key(CONV, 4)
        k_int8 = record_key(CONV, 4, precision="int8")
        assert k_bf16 != k_int8 and k_int8.endswith("#int8")
        mine = TuningRecord({k_bf16: _tuning(1.0, 4)})
        theirs = TuningRecord({k_bf16: _tuning(9.0, 4),
                               k_int8: _tuning(0.5, 4, "int8")})
        assert mine.merge(theirs) == 1
        assert mine.entries[k_bf16].measured_s == 1.0
        assert mine.entries[k_int8].measured_s == 0.5
        assert mine.entries[k_int8].precision == "int8"

    def test_lookup_bucket_fallback_is_precision_strict(self):
        rec = TuningRecord({record_key(CONV, 2): _tuning(1.0, 2),
                            record_key(CONV, 2, "int8"):
                                _tuning(0.5, 2, "int8")})
        assert rec.lookup(CONV, batch=8).measured_s == 1.0
        assert rec.lookup(CONV, batch=8, precision="int8").measured_s == 0.5
        only_bf16 = TuningRecord({record_key(CONV, 2): _tuning(1.0, 2)})
        assert only_bf16.lookup(CONV, batch=8, precision="int8") is None

    def test_v1_migration_then_merge_keeps_incumbents(self):
        v1_blob = {
            "version": 1, "meta": {"batch": 4},
            "entries": {conv_key(CONV): {
                "binding": {"algo_key": "kn2row", "dataflow": "WS",
                            "p1": 128, "p2": 128, "backend": "reference"},
                "measured_s": 7.0,
                "candidates": [["kn2row|WS|128x128|reference", 7.0]]}}}
        migrated = TuningRecord.from_json(v1_blob)
        key4 = record_key(CONV, 4)
        assert set(migrated.entries) == {key4}
        assert migrated.entries[key4].batch == 4
        assert migrated.entries[key4].precision == "bf16"
        assert migrated.to_json()["version"] == 2
        assert TuningRecord.from_json(
            migrated.to_json()).entries.keys() == {key4}
        mine = TuningRecord({key4: _tuning(1.0, 4),
                             record_key(CONV, 4, "int8"):
                                 _tuning(0.4, 4, "int8")})
        assert mine.merge(migrated) == 0
        assert mine.entries[key4].measured_s == 1.0
        assert migrated.merge(mine) == 1
        assert migrated.entries[key4].measured_s == 7.0
        assert migrated.entries[record_key(CONV, 4, "int8")].precision \
            == "int8"

    def test_v1_without_batch_meta_lands_in_bucket_1(self):
        v1_blob = {"version": 1, "meta": {}, "entries": {
            conv_key(CONV): {
                "binding": {"algo_key": "im2col", "dataflow": "NS",
                            "p1": 128, "p2": 128, "backend": "reference"},
                "measured_s": 3.0, "candidates": []}}}
        rec = TuningRecord.from_json(v1_blob)
        assert set(rec.entries) == {record_key(CONV, 1)}


class TestRefreshFromService:
    def _graph_record(self):
        g = vgg16(res=8, scale=0.05)
        rec = TuningRecord()
        for node in g.conv_nodes():
            for bucket in (1, 4):
                rec.entries[record_key(node.conv, bucket)] = \
                    _tuning(0.001, bucket)
        return g, rec

    def test_divergent_ema_rescales_exact_bucket_only(self):
        g, rec = self._graph_record()
        expected = len(list(g.conv_nodes())) * 0.001
        applied = refresh_from_service(rec, g, {4: 2.0 * expected})
        assert applied == {4: pytest.approx(2.0)}
        for node in g.conv_nodes():
            assert rec.entries[record_key(node.conv, 4)].measured_s \
                == pytest.approx(0.002)
            _, cand_s = rec.entries[record_key(node.conv, 4)].candidates[0]
            assert cand_s == pytest.approx(0.002)
            assert rec.entries[record_key(node.conv, 1)].measured_s \
                == pytest.approx(0.001)
        assert rec.meta["live_refresh"] == {"4": pytest.approx(2.0)}

    def test_sub_hysteresis_divergence_holds_steady(self):
        g, rec = self._graph_record()
        expected = len(list(g.conv_nodes())) * 0.001
        assert refresh_from_service(rec, g, {4: 1.03 * expected}) == {}
        assert "live_refresh" not in rec.meta
        assert rec.entries[record_key(
            next(iter(g.conv_nodes())).conv, 4)].measured_s \
            == pytest.approx(0.001)

    def test_refresh_scales_accumulate(self):
        g, rec = self._graph_record()
        expected = len(list(g.conv_nodes())) * 0.001
        refresh_from_service(rec, g, {4: 2.0 * expected})
        refresh_from_service(rec, g, {4: 3.0 * expected})
        assert rec.meta["live_refresh"]["4"] == pytest.approx(3.0)

    def test_bindings_never_rerank(self):
        g, rec = self._graph_record()
        before = {k: t.binding for k, t in rec.entries.items()}
        expected = len(list(g.conv_nodes())) * 0.001
        refresh_from_service(rec, g, {4: 2.0 * expected})
        assert {k: t.binding for k, t in rec.entries.items()} == before


# ------------------------------- twins: bucket-keyed records and the engine
def _bucket_tuning(backend, batch):
    return LayerTuning(binding=Binding("im2col", "NS", 128, 128, backend),
                       measured_s=1.0, candidates=[], batch=batch)


def test_record_key_and_parse_roundtrip():
    assert record_key(CONV) == conv_key(CONV) + "@b1"
    assert record_key(CONV, 8) == conv_key(CONV) + "@b8"
    assert parse_record_key(record_key(CONV, 4)) == (conv_key(CONV), 4, "bf16")
    assert parse_record_key(record_key(CONV, 4, "int8")) \
        == (conv_key(CONV), 4, "int8")
    with pytest.raises(ValueError, match="unparseable"):
        parse_record_key("garbage")


def test_bucket_keyed_record_roundtrip_json(tmp_path):
    rec = TuningRecord({record_key(CONV, 1): _bucket_tuning("reference", 1),
                        record_key(CONV, 8): _bucket_tuning("lax", 8)})
    path = tmp_path / "tuning.json"
    rec.save(path)
    rec2 = TuningRecord.load(path)
    assert rec2.entries.keys() == rec.entries.keys()
    assert json.loads(path.read_text())["version"] == 2
    assert rec2.buckets_for(CONV) == [1, 8]
    assert rec2.lookup(CONV, 1).binding.backend == "reference"
    assert rec2.lookup(CONV, 8).binding.backend == "lax"
    assert rec2.lookup(CONV, 8).batch == 8
    assert rec2.lookup(CONV, 4).binding.backend == "reference"
    assert rec2.lookup(CONV, 16).binding.backend == "lax"
    other = ConvMeta(c_in=3, c_out=5, h1=8, h2=8, k1=3, k2=3)
    assert rec2.lookup(other, 4) is None


def test_v1_record_migrates_on_load():
    ent = {"binding": {"algo_key": "im2col", "dataflow": "NS", "p1": 128,
                       "p2": 128, "backend": "lax"},
           "measured_s": 1.0, "candidates": []}
    rec = TuningRecord.from_json({"version": 1, "meta": {"batch": 8},
                                  "entries": {conv_key(CONV): ent}})
    assert list(rec.entries) == [record_key(CONV, 8)]
    assert rec.lookup(CONV, 8).batch == 8
    blob = {"version": 1, "meta": {"batch": None},
            "entries": {conv_key(CONV): ent}}
    assert list(TuningRecord.from_json(blob).entries) == [record_key(CONV, 1)]


def test_autotune_buckets_and_bucket_matched_lowering(tiny):
    g, _ = tiny
    rec = autotune_buckets(g, buckets=(1, 2), backends=("reference",),
                           reps=1, **CPU)
    sigs = {conv_key(n.conv) for n in g.conv_nodes()}
    assert len(rec.entries) == 2 * len(sigs)
    assert rec.meta["buckets"] == [1, 2]
    for node in g.conv_nodes():
        assert rec.buckets_for(node.conv) == [1, 2]
    low1 = lower_plan(g, None, tuning=rec, batch=1)
    low2 = lower_plan(g, None, tuning=rec, batch=2)
    for node in g.conv_nodes():
        assert low1[node.id].algo == \
            rec.entries[record_key(node.conv, 1)].binding.algo
        assert low2[node.id].algo == \
            rec.entries[record_key(node.conv, 2)].binding.algo


def test_engine_binds_each_bucket_to_its_tuned_winner(tiny, monkeypatch):
    """Each bucket's program takes the (signature, bucket) winner: a record
    sending bucket 1 to "reference" and bucket 2 to "lax" gives
    backend-distinct programs per bucket, with equal outputs."""
    g, params = tiny
    entries = {}
    for node in g.conv_nodes():
        entries[record_key(node.conv, 1)] = _bucket_tuning("reference", 1)
        entries[record_key(node.conv, 2)] = _bucket_tuning("lax", 2)
    rec = TuningRecord(entries)
    seen = []
    real = overlay.apply_conv

    def spy(x, w, *a, **kw):
        seen.append(kw.get("backend"))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(overlay, "apply_conv", spy)
    eng = CNNServingEngine(g, params, None, buckets=(1, 2), tuning=rec,
                           **CPU)
    rng = np.random.default_rng(11)
    reqs = [CNNRequest(rid=i, image=rng.standard_normal((8, 8, 3))
                       .astype(np.float32)) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    assert eng.step() == 2
    assert eng.step() == 1
    monkeypatch.undo()
    n_conv = len(g.conv_nodes())
    assert seen[:n_conv] == ["lax"] * n_conv
    assert seen[n_conv:] == ["reference"] * n_conv
    for r in reqs:
        want = forward(g, params, r.image, **CPU)
        np.testing.assert_allclose(eng.done[r.rid], want.numpy(), **PLAN_TOL)


# ------------------------------- twins: elision, mixed backends, precision
def _two_conv_graph(start):
    """input → convA (3×3) → convB (3×3) → output in either package."""
    g, cur = start(12, 4)
    cur = cur.conv(6, 3, 3, name="convA").conv(5, 3, 3, name="convB")
    kind = LayerKind if start is _start else JaxLayerKind
    out = g.add_node(kind.OUTPUT, name="output", out_shape=(12, 12, 5))
    g.add_edge(cur.node, out)
    return g


def test_tune_elision_returns_overrides():
    g = _two_conv_graph(_start)
    rec = TuningRecord()
    overrides = tune_elision(g, None, reps=1, record=rec, **CPU)
    lowered = lower_plan(g, None)
    assert set(overrides) <= set(lowered.elided_edges)
    assert all(v is False for v in overrides.values())
    assert elision_overrides_from_meta(rec) == overrides
    lowered2 = lower_plan(g, None, elide_overrides=overrides)
    assert set(lowered2.elided_edges) == \
        set(lowered.elided_edges) - set(overrides)


def test_lower_plan_rejects_a_junk_tuning_backend(served):
    g = served[0]
    node = g.conv_nodes()[0]
    rec = TuningRecord({record_key(node.conv): LayerTuning(
        binding=Binding("im2col", "NS", 128, 128, "cuda"),
        measured_s=0.0, candidates=[])})
    with pytest.raises(ValueError, match="backend"):
        lower_plan(g, None, tuning=rec)


def test_mixed_backend_compiled_plan(served):
    """One lowering cycling pallas/reference/lax per conv layer. On the
    CPU its kernel layers raise (no fallback); the reference/lax mix
    equals the all-reference oracle."""
    g, _, _, _, np_params = served
    params = params_from_jax(np_params, "cpu")

    def record(backends):
        return TuningRecord({
            record_key(node.conv): LayerTuning(
                binding=Binding("im2col", "NS", 128, 128,
                                backends[i % len(backends)]),
                measured_s=0.0, candidates=[])
            for i, node in enumerate(g.conv_nodes())})

    three = ("pallas", "reference", "lax")
    lowering = lower_plan(g, None, tuning=record(three))
    assert {low.backend for low in lowering.values()} == set(three)
    xb = np.random.default_rng(2).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        compile_plan(g, tuning=record(three), **CPU)(params, xb)
    mixed = compile_plan(g, tuning=record(("reference", "lax")),
                         **CPU)(params, xb)
    oracle = compile_plan(g, **CPU)(params, xb)
    np.testing.assert_allclose(mixed.numpy(), oracle.numpy(), **PLAN_TOL)


def test_tuning_record_precision_keys():
    conv = ConvMeta(8, 8, 8, 8, 3, 3)
    kb = record_key(conv, 2)
    kq = record_key(conv, 2, "int8")
    assert kq == kb + "#int8" and kb != kq
    assert parse_record_key(kb)[2] == "bf16"
    assert parse_record_key(kq) == parse_record_key(kb)[:2] + ("int8",)
    b = Binding("im2col", "NS", 128, 128, "reference")
    rec = TuningRecord({kq: LayerTuning(binding=b, measured_s=1e-3,
                                        candidates=[], batch=2,
                                        precision="int8")})
    assert rec.lookup(conv, 2, "int8") is not None
    assert rec.lookup(conv, 2) is None
    assert rec.buckets_for(conv, "int8") == [2]
    assert rec.buckets_for(conv) == []
    rec2 = TuningRecord.from_json(rec.to_json())
    assert rec2.entries[kq].precision == "int8"
    assert rec2.lookup(conv, 2, "int8").binding == b


# ------------------------------------------------ parity with the reference
@pytest.mark.parametrize("model", ["googlenet", "vgg16", "inception_v4"])
def test_candidate_bindings_match_reference(model):
    """Every signature of the full-width model gets the reference's
    candidate list, in its order, duplicates included."""
    ours, ref = {
        "googlenet": (googlenet(res=224, scale=1.0),
                      jax_googlenet(res=224, scale=1.0)),
        "vgg16": (vgg16(res=224, scale=1.0), jax_vgg16(res=224, scale=1.0)),
        "inception_v4": (inception_v4(res=299, scale=1.0),
                         jax_inception_v4(res=299, scale=1.0)),
    }[model]
    sigs = {conv_key(n.conv): n.conv for n in ours.conv_nodes()}
    jsigs = {jax_autotune.conv_key(n.conv): n.conv for n in ref.conv_nodes()}
    assert sigs.keys() == jsigs.keys()
    for pairs in (((128, 128),), FOUR_PAIRS):
        for backends in (autotune.BACKENDS, ("pallas",)):
            for key, conv in sigs.items():
                got = [c.label() for c in candidate_bindings(
                    conv, p1p2=pairs, backends=backends)]
                want = [c.label() for c in jax_autotune.candidate_bindings(
                    jsigs[key], p1p2=pairs, backends=backends)]
                assert got == want, key


def _varied_record(mod, graph):
    """A record of ``mod`` over every signature of ``graph``: bf16 entries
    at buckets 1 and 8 and int8 entries at bucket 2, each binding picked
    from the signature's candidates by a hash of its key."""
    rec = mod.TuningRecord(meta={"backend": "gpu", "buckets": [1, 2, 8]})
    for node in graph.conv_nodes():
        for bucket, prec in ((1, "bf16"), (8, "bf16"), (2, "int8")):
            key = mod.record_key(node.conv, bucket, prec)
            cands = [c for c in mod.candidate_bindings(node.conv,
                                                       p1p2=FOUR_PAIRS)
                     if not (prec == "int8" and "winograd" in c.algo_key)]
            b = cands[_pick(key, len(cands))]
            s = 1e-3 * (1 + _pick(key + "s", 1000) / 1000)
            rec.entries[key] = mod.LayerTuning(
                binding=b, measured_s=s, candidates=[(b.label(), s)],
                batch=bucket, precision=prec)
    return rec


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_record_crosses_packages(tmp_path, served, direction):
    """A record saved by either package loads in the other with the same
    JSON and the same ``lowering_for`` at buckets 1, 2, 4 and 8, int8
    keys included (buckets 2 and 4 ride the bucket fallback for bf16)."""
    g, _, jg, _, _ = served
    if direction == "torch_to_jax":
        src, dst, src_graph = autotune, jax_autotune, g
    else:
        src, dst, src_graph = jax_autotune, autotune, jg
    rec = _varied_record(src, src_graph)
    path = tmp_path / "tuning.json"
    rec.save(path)
    loaded = dst.TuningRecord.load(path)
    assert loaded.to_json() == rec.to_json()
    for node, jnode in zip(g.conv_nodes(), jg.conv_nodes()):
        assert node.id == jnode.id
        for bucket in (1, 2, 4, 8):
            for prec in ("bf16", "int8"):
                a = rec.lowering_for(node.conv, bucket, prec)
                b = loaded.lowering_for(jnode.conv, bucket, prec)
                assert a is not None
                assert _low_fields(a) == _low_fields(b)
    assert signature_coverage(g, TuningRecord.load(path), (1, 4, 8)) == \
        jax_autotune.signature_coverage(jg, jax_autotune.TuningRecord.load(
            path), (1, 4, 8))


def test_v1_blob_migrates_alike():
    blob = {"version": 1, "meta": {"batch": 4}, "entries": {
        conv_key(CONV): {
            "binding": {"algo_key": "winograd(F4x3)", "dataflow": "IS",
                        "p1": 64, "p2": 128, "backend": "pallas"},
            "measured_s": 2.5, "candidates": [["x", 2.5], ["y", 3.0]]}}}
    ours = TuningRecord.from_json(json.loads(json.dumps(blob)))
    ref = jax_autotune.TuningRecord.from_json(json.loads(json.dumps(blob)))
    assert ours.to_json() == ref.to_json()
    for bucket in (1, 2, 4, 8):
        assert _low_fields(ours.lowering_for(CONV, bucket)) == \
            _low_fields(ref.lowering_for(CONV, bucket))


def _fake_benchmark(conv, binding, **kw):
    """A deterministic fake time in [1, 2) ms, a function of the
    signature, the binding, the batch and the precision only."""
    key = (f"{autotune.conv_key(conv)}|{binding.label()}|{kw.get('batch')}"
           f"|{kw.get('precision', 'bf16')}")
    return 1e-3 * (1 + _pick(key, 4096) / 4096)


@pytest.fixture
def fake_benchmark(monkeypatch):
    monkeypatch.setattr(autotune, "benchmark_binding", _fake_benchmark)
    monkeypatch.setattr(jax_autotune, "benchmark_binding", _fake_benchmark)


def _as_dict(tuning):
    return dataclasses.asdict(tuning)


@pytest.mark.parametrize("precision,with_baseline",
                         [("bf16", True), ("int8", True), ("bf16", False)])
def test_tune_layer_matches_reference_under_a_fake_timer(
        fake_benchmark, precision, with_baseline):
    from repro.core.graph import ConvMeta as JaxConvMeta
    shape = dict(c_in=16, c_out=32, h1=14, h2=14, k1=3, k2=3, stride=1)
    kw = dict(p1p2=FOUR_PAIRS, batch=8, precision=precision, reps=1)
    base = ("im2col", "NS", 128, 128, "reference")
    got = tune_layer(ConvMeta(**shape), baseline=Binding(*base)
                     if with_baseline else None, **kw, **CPU)
    want = jax_autotune.tune_layer(
        JaxConvMeta(**shape), baseline=jax_autotune.Binding(*base)
        if with_baseline else None, **kw)
    assert _as_dict(got) == _as_dict(want)
    if precision == "int8":
        assert not any("winograd" in lbl for lbl, _ in got.candidates)


def _without_backend(blob):
    blob = json.loads(json.dumps(blob))
    blob["meta"].pop("backend")
    return blob


def test_autotune_buckets_matches_reference_under_a_fake_timer(
        fake_benchmark, served):
    """The served configuration's tuning (kernels only, the plan's own
    binding as the hysteresis baseline, the four tiles) gives the
    reference's record, entry for entry."""
    g, plan, jg, jplan, _ = served
    kw = dict(buckets=(1, 2, 8), backends=("pallas",),
              baseline_backend="pallas", p1p2=FOUR_PAIRS, reps=1)
    got = autotune_buckets(g, plan, **kw, **CPU)
    want = jax_autotune.autotune_buckets(jg, jplan, **kw)
    assert _without_backend(got.to_json()) == _without_backend(want.to_json())
    # Both outcomes of the hysteresis occur: some signatures keep the
    # plan's binding, others move to a measured challenger.
    kept = [t.binding == Binding(plan.assignment[n.id].key,
                                 plan.dataflows[n.id].name, plan.p1,
                                 plan.p2, "pallas")
            for n in g.conv_nodes()
            for t in [got.entries[record_key(n.conv, 8)]]]
    assert any(kept) and not all(kept)


class _FakeClock:
    """A host clock that moves only when a fake program runs."""

    def __init__(self) -> None:
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t


def _fake_compile(clock, make_out):
    """A ``compile_plan`` stand-in whose program advances ``clock`` by a
    deterministic cost of its elision overrides."""
    def compile_fake(graph, plan=None, **kw):
        overrides = kw.get("elide_overrides")
        if not overrides:
            cost = 1.0
        else:
            (edge, flag), = overrides.items()
            cost = 0.9 + 0.2 * _pick(f"{edge}{flag}", 1000) / 1000

        def run(params, x):
            clock.t += cost
            return make_out()
        return run
    return compile_fake


@pytest.mark.parametrize("graph_kind", ["two_conv", "googlenet"])
def test_tune_elision_matches_reference_under_a_fake_timer(
        monkeypatch, served, graph_kind):
    if graph_kind == "two_conv":
        g, jg, plan, jplan, batch = (_two_conv_graph(_start),
                                     _two_conv_graph(jax_start), None, None,
                                     None)
    else:
        g, plan, jg, jplan, _ = served
        batch = 2
    clock, jclock = _FakeClock(), _FakeClock()
    monkeypatch.setattr(executor, "compile_plan",
                        _fake_compile(clock, lambda: torch.zeros(1)))
    monkeypatch.setattr(jax_executor, "compile_plan",
                        _fake_compile(jclock, lambda: jnp.zeros(1)))
    monkeypatch.setattr(autotune, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    monkeypatch.setattr(jax_autotune, "time", types.SimpleNamespace(
        perf_counter=jclock.perf_counter))
    rec, jrec = TuningRecord(), jax_autotune.TuningRecord()
    got = tune_elision(g, plan, batch=batch, reps=2, record=rec, **CPU)
    want = jax_autotune.tune_elision(jg, jplan, batch=batch, reps=2,
                                     record=jrec)
    assert got == want
    assert rec.meta == jrec.meta
    if graph_kind == "googlenet":
        # Both outcomes of the hysteresis occur on GoogleNet's 56 edges.
        assert 0 < len(got) < len(lower_plan(g, plan).elided_edges)


SCENARIOS = {
    "divergent": [{4: 2.0}],
    "sub_hysteresis": [{4: 1.03}],
    "accumulate": [{4: 2.0}, {4: 3.0}],
    "fallback_none_and_zero": [{2: 2.0, 1: None, 8: 0.0}],
    "int8_precisions": [{1: 1.5, 4: 0.5}],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_refresh_from_service_matches_reference(scenario):
    """The reference's scenarios, on both packages' records and graphs:
    equal applied scales, entries and meta after every call."""
    g, jg = vgg16(res=8, scale=0.05), jax_vgg16(res=8, scale=0.05)
    int8 = {n.id: "int8" for i, n in enumerate(g.conv_nodes()) if i % 2}
    rec = TuningRecord()
    for node in g.conv_nodes():
        for bucket in (1, 4):
            rec.entries[record_key(node.conv, bucket)] = \
                _tuning(0.001 * (1 + node.id % 3), bucket)
            rec.entries[record_key(node.conv, bucket, "int8")] = \
                _tuning(0.0005, bucket, "int8")
    jrec = jax_autotune.TuningRecord.from_json(rec.to_json())
    precisions = int8 if scenario == "int8_precisions" else None
    expected = sum(rec.lookup(n.conv, 4, (precisions or {}).get(
        n.id, "bf16")).measured_s for n in g.conv_nodes())
    for emas in SCENARIOS[scenario]:
        scaled = {b: None if r is None else r * expected
                  for b, r in emas.items()}
        got = refresh_from_service(rec, g, scaled, precisions=precisions)
        want = jax_autotune.refresh_from_service(jrec, jg, scaled,
                                                 precisions=precisions)
        assert got == want
        assert rec.to_json() == jrec.to_json()
    if scenario == "sub_hysteresis":
        assert got == {}


def _mixed_record(graph, buckets=(1, 2)):
    """A record of the port mixing the plain oracles and cuDNN, a
    different algorithm per signature and bucket (int8 entries too,
    which a bf16 plan never reads)."""
    rec = TuningRecord()
    for node in graph.conv_nodes():
        for bucket in buckets:
            key = record_key(node.conv, bucket)
            cands = candidate_bindings(node.conv,
                                       backends=("lax", "reference"))
            b = cands[_pick(key, len(cands))]
            rec.entries[key] = LayerTuning(binding=b, measured_s=1e-3,
                                           candidates=[], batch=bucket)
    return rec


def test_tuned_compiled_plan_matches_reference(served):
    g, plan, jg, jplan, np_params = served
    rec = _mixed_record(g)
    jrec = jax_autotune.TuningRecord.from_json(rec.to_json())
    low = lower_plan(g, plan, tuning=rec, batch=2)
    assert {l.backend for l in low.values()} == {"lax", "reference"}
    assert len({l.algo.key for l in low.values()}) >= 3
    x = np.random.default_rng(3).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    want = jax_compile_plan(jg, jplan, epilogue="bias_relu", tuning=jrec,
                            tuning_batch=2)(np_params, x)
    run = compile_plan(g, plan, epilogue="bias_relu", tuning=rec,
                       tuning_batch=2, **CPU)
    got = run(params_from_jax(np_params, "cpu"), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAN_TOL)
    assert [(n, _low_fields(run.lowering[n])) for n in sorted(low)] == \
        [(n, _low_fields(low[n])) for n in sorted(low)]


def test_tuned_engine_matches_reference(served):
    """Both engines on one record: the same dispatches and results at the
    whole-plan tolerance, each bucket on its own winners."""
    g, plan, jg, jplan, np_params = served
    rec = _mixed_record(g)
    jrec = jax_autotune.TuningRecord.from_json(rec.to_json())
    ours = CNNServingEngine(g, params_from_jax(np_params, "cpu"), plan,
                            batch_size=2, tuning=rec, **CPU)
    ref = JaxEngine(jg, np_params, jplan, batch_size=2, tuning=jrec)
    assert ours.tuning is rec
    images = np.random.default_rng(4).standard_normal(
        (3, 56, 56, 3)).astype(np.float32)
    for engine, request in ((ours, CNNRequest), (ref, JaxRequest)):
        for rid, img in enumerate(images):
            engine.submit(request(rid=rid, image=img))
        engine.run_until_done()
    assert ours.dispatches == ref.dispatches == {1: 1, 2: 1}
    for rid in range(len(images)):
        np.testing.assert_allclose(ours.done[rid], np.asarray(ref.done[rid]),
                                   **PLAN_TOL)
    for bucket, run in ours._runs.items():
        for node in g.conv_nodes():
            want = rec.lowering_for(node.conv, bucket)
            assert _low_fields(run.lowering[node.id]) == _low_fields(want)


# --------------------------------------------------------- port-only checks
def test_tuning_and_overrides_enter_the_cache_key(served):
    """A tuned and an untuned program never share a key; a record and its
    reload from JSON do; elision overrides key a program of their own."""
    g, plan, _, _, _ = served
    rec = _mixed_record(g)
    reloaded = TuningRecord.from_json(json.loads(json.dumps(rec.to_json())))
    base = dict(tuning_batch=2, **CPU)
    plain = executable_cache_key(g, plan, **base)
    tuned = executable_cache_key(g, plan, tuning=rec, **base)
    edge = lower_plan(g, plan).elided_edges[0]
    assert tuned != plain
    assert executable_cache_key(g, plan, tuning=reloaded, **base) == tuned
    assert executable_cache_key(g, plan, elide_overrides={edge: False},
                                **base) not in (plain, tuned)
    cache = ExecutableCache()
    a = compile_plan(g, plan, tuning=rec, cache=cache, **base)
    b = compile_plan(g, plan, tuning=reloaded, cache=cache, **base)
    c = compile_plan(g, plan, cache=cache, **base)
    assert a is b and a is not c
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 2}


def test_engine_takes_a_tuning_record():
    """``CNNServingEngine(tuning=...)`` is accepted: each bucket's program
    is lowered under the record's winners at that bucket, and a bucket
    the record lacks takes the largest tuned bucket below it."""
    g = googlenet(res=32, scale=0.125)
    params = init_params(g, seed=0, **CPU)
    rec = _mixed_record(g, buckets=(1, 2))
    engine = CNNServingEngine(g, params, None, buckets=(1, 2, 4),
                              tuning=rec, **CPU)
    assert engine.tuning is rec
    for bucket, lookup in ((1, 1), (2, 2), (4, 2)):
        low = engine._runs[bucket].lowering
        for node in g.conv_nodes():
            assert _low_fields(low[node.id]) == _low_fields(
                rec.lowering_for(node.conv, lookup))
    img = np.random.default_rng(5).standard_normal(
        (32, 32, 3)).astype(np.float32)
    engine.submit(CNNRequest(rid=0, image=img))
    engine.run_until_done()
    want = forward(g, params, img, epilogue="bias_relu", tuning=rec, **CPU)
    np.testing.assert_allclose(engine.done[0], want.numpy(), **PLAN_TOL)


def test_forward_takes_tuning_and_elision_overrides(served):
    g, plan, _, _, np_params = served
    params = params_from_jax(np_params, "cpu")
    rec = _mixed_record(g)
    edge = lower_plan(g, plan).elided_edges[0]
    kw = dict(tuning=rec, tuning_batch=2, elide_overrides={edge: False},
              **CPU)
    x = np.random.default_rng(6).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    run = compile_plan(g, plan, **kw)
    assert edge not in run.lowering.elided_edges
    assert torch.equal(forward(g, params, x, plan, **kw), run(params, x))


def test_benchmark_binding_on_the_cpu():
    """Plain candidates time on the host clock; a kernel candidate on the
    CPU raises — the tuner never times something else in its place."""
    for backend in ("reference", "lax"):
        for prec in ("bf16", "int8"):
            s = benchmark_binding(CONV, Binding("im2col", "NS", 128, 128,
                                                backend),
                                  reps=2, batch=2, precision=prec, **CPU)
            assert np.isfinite(s) and s > 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        benchmark_binding(CONV, Binding("im2col", "NS", 64, 64, "pallas"),
                          reps=1, **CPU)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tune_layer(CONV, backends=("pallas",), reps=1, **CPU)


def test_measurements_run_without_tf32(monkeypatch):
    """The tuner times every backend at f32 whatever the caller's TF32
    flags are (a cuDNN candidate must not win on TF32), and gives the
    caller's flags back."""
    conv, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    seen = []
    real_apply, real_program_s = overlay.apply_conv, autotune._program_s

    def spy_apply(*args, **kw):
        seen.append((conv.allow_tf32, mm.allow_tf32))
        return real_apply(*args, **kw)

    def spy_program_s(*args, **kw):
        seen.append((conv.allow_tf32, mm.allow_tf32))
        return real_program_s(*args, **kw)

    monkeypatch.setattr(overlay, "apply_conv", spy_apply)
    monkeypatch.setattr(autotune, "_program_s", spy_program_s)
    monkeypatch.setattr(conv, "allow_tf32", True)
    monkeypatch.setattr(mm, "allow_tf32", True)
    benchmark_binding(CONV, Binding("im2col", "NS", 128, 128, "lax"),
                      reps=1, **CPU)
    tune_elision(_two_conv_graph(_start), None, reps=1, **CPU)
    assert seen and set(seen) == {(False, False)}
    assert (conv.allow_tf32, mm.allow_tf32) == (True, True)


def test_cuda_default_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _two_conv_graph(_start)
    binding = Binding("im2col", "NS", 128, 128, "reference")
    for call in (lambda: benchmark_binding(CONV, binding),
                 lambda: tune_layer(CONV, backends=("reference",)),
                 lambda: autotune_graph(g, backends=("reference",)),
                 lambda: tune_elision(g)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
