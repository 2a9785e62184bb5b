"""The port's planner copy against the reference planner: identical plans
and lowerings (exact equality) for reduced and full-width GoogleNet."""
import dataclasses

import pytest

from repro.cnn.executor import graph_hash as jax_graph_hash
from repro.cnn.models import googlenet as jax_googlenet
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import lower_plan as jax_lower_plan
from repro.core.mapper import map_network as jax_map_network
from repro_torch.cnn.executor import graph_hash
from repro_torch.cnn.models import googlenet
from repro_torch.core.algorithms import AlgoFamily
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import lower_plan, map_network

CONFIGS = [(56, 0.25), (224, 1.0)]


def _spec(s):
    return None if s is None else dataclasses.astuple(s)


def _plan_view(plan):
    return {
        "p": (plan.p1, plan.p2),
        "assignment": {n: a.key for n, a in plan.assignment.items()},
        "dataflows": {n: d.name for n, d in plan.dataflows.items()},
        "store_formats": {n: f.value for n, f in plan.store_formats.items()},
        "total_cost_s": plan.total_cost_s,
        "exact": plan.solver.exact,
        "solver_assignment": dict(plan.solver.assignment),
    }


def _lowering_view(prog):
    convs = {n: (l.algo.key, l.dataflow.name, l.p1, l.p2, l.epilogue,
                 l.backend, _spec(l.in_layout), _spec(l.out_layout),
                 l.precision, l.in_scale, l.out_scale, l.in_quantized)
             for n, l in prog.items()}
    transitions = {e: (_spec(t.layout), t.elide, t.reason, t.precision)
                   for e, t in prog.transitions.items()}
    stores = {n: _spec(s) for n, s in prog.store_specs.items()}
    return convs, transitions, stores


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"r{r}_s{s}" for r, s in CONFIGS])
def both_plans(request):
    res, scale = request.param
    g = googlenet(res=res, scale=scale)
    jg = jax_googlenet(res=res, scale=scale)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    return g, plan, jg, jplan


def test_graph_hash_matches_reference(both_plans):
    g, _, jg, _ = both_plans
    assert graph_hash(g) == jax_graph_hash(jg)


def test_plan_matches_reference(both_plans):
    _, plan, _, jplan = both_plans
    assert _plan_view(plan) == _plan_view(jplan)


@pytest.mark.parametrize("elide", [True, False])
@pytest.mark.parametrize("epilogue", ["bias_relu", "relu"])
def test_lowering_matches_reference(both_plans, elide, epilogue):
    g, plan, jg, jplan = both_plans
    ours = lower_plan(g, plan, epilogue=epilogue, elide=elide)
    ref = jax_lower_plan(jg, jplan, epilogue=epilogue, elide=elide)
    assert _lowering_view(ours) == _lowering_view(ref)
    assert ours.elided_edges == ref.elided_edges


def test_full_width_main_path_layouts():
    """Full-width GoogleNet is all im2col under one exact plan; with
    elision 56 convs read a Toeplitz matrix (the GEMM kernel) and only the
    7x7 stem reads NHWC (the implicit-GEMM conv kernel)."""
    g = googlenet(res=224, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    assert plan.solver.exact
    assert {a.family for a in plan.assignment.values()} == {AlgoFamily.IM2COL}
    prog = lower_plan(g, plan, epilogue="bias_relu", elide=True)
    reads_t = [n for n, l in prog.items() if l.in_layout is not None]
    stores_t = [n for n, l in prog.items() if l.out_layout is not None]
    nhwc_in = [n for n, l in prog.items() if l.in_layout is None]
    assert len(reads_t) == 56 and len(nhwc_in) == 1
    assert len([n for n in reads_t if n not in stores_t]) == 37
    assert len([n for n in reads_t if n in stores_t]) == 19
    stem = g.nodes[nhwc_in[0]].conv
    assert (stem.h1, stem.k1, stem.stride, stem.c_in, stem.c_out) == \
        (224, 7, 2, 3, 64)
