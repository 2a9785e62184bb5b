"""The port's compiled plans against the reference's on reduced GoogleNet.

The same numpy weights, drawn from a seed in the layout of the reference's
``init_params`` pytree (non-zero biases, so the fused bias epilogue does
work), go to both sides — to the port through ``params_from_jax``.
Whole-plan tolerance is the reference's own: rtol 2e-2, atol 2e-3."""
import jax
import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.executor import init_params as jax_init_params
from repro.cnn.models import googlenet as jax_googlenet
from repro.core.dse import identify_parameters as jax_identify
from repro.core.graph import ConvMeta, Graph, LayerKind
from repro.core.mapper import map_network as jax_map_network
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import (ExecutableCache, _eval_graph,
                                      compile_plan, executable_cache_key,
                                      forward, init_params)
from repro_torch.cnn.models import googlenet
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import lower_plan, map_network

PLAN_TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(scope="module")
def setup():
    g = googlenet(res=56, scale=0.25)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    jg = jax_googlenet(res=56, scale=0.25)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    return g, plan, jg, jplan, _np_params(jg, seed=0)


def _np_params(graph, seed):
    """``{nid: {"w", "b"}}`` as the reference's ``init_params`` lays it
    out, drawn with numpy (biases non-zero)."""
    rng = np.random.default_rng(seed)
    params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.conv is not None:
            m = node.conv
            shape = (m.k1, m.k2, m.c_in, m.c_out)
            fan_in, fan_out = m.k1 * m.k2 * m.c_in, m.c_out
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


def _images(n, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 56, 56, 3)).astype(np.float32)


@pytest.mark.parametrize("elide", [True, False])
@pytest.mark.parametrize("bucket", [1, 4])
def test_compile_plan_matches_reference(setup, bucket, elide):
    g, plan, jg, jplan, np_params = setup
    x = _images(bucket)
    ref = jax_compile_plan(jg, jplan, epilogue="bias_relu", elide=elide,
                           tuning_batch=bucket)(np_params, x)
    run = compile_plan(g, plan, epilogue="bias_relu", elide=elide,
                       tuning_batch=bucket, device="cpu")
    got = run(params_from_jax(np_params, "cpu"), x)
    assert got.shape == (bucket, 1000) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)
    assert len(run.lowering.elided_edges) == (56 if elide else 0)


def test_forward_single_image_matches_reference(setup):
    g, plan, jg, jplan, np_params = setup
    x = _images(1, seed=2)[0]
    ref = jax_compile_plan(jg, jplan, epilogue="bias_relu")(np_params, x)
    got = forward(g, params_from_jax(np_params, "cpu"), x, plan=plan,
                  epilogue="bias_relu", device="cpu")
    assert tuple(got.shape) == tuple(ref.shape) == (1000,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)


def test_backends_compute_the_same_function(setup):
    """auto (the kernel's plain version on CPU), reference and lax give
    the same logits; so does a plan-free (all-im2col default) program."""
    g, plan, _, _, np_params = setup
    params = params_from_jax(np_params, "cpu")
    x = _images(2, seed=3)
    base = compile_plan(g, plan, epilogue="bias_relu", device="cpu")(
        params, x)
    for kw in (dict(use_pallas=False), dict(plan=None)):
        kw = {"plan": plan, **kw}
        out = compile_plan(g, epilogue="bias_relu", device="cpu", **kw)(
            params, x)
        np.testing.assert_allclose(out.numpy(), base.numpy(), **PLAN_TOL)
    lax_prog = lower_plan(g, plan, epilogue="bias_relu", backend="lax")
    assert all(l.in_layout is None for l in lax_prog.values())
    with torch.inference_mode():
        out = _eval_graph(g, lax_prog, params, torch.from_numpy(x), None)
    np.testing.assert_allclose(out.numpy(), base.numpy(), **PLAN_TOL)


def test_params_from_jax_carries_reference_init_params():
    """The bridge takes the reference's own ``init_params`` pytree (as
    numpy) and gives the same values, layouts and dtypes on the device."""
    g = Graph()
    src = g.add_node(LayerKind.INPUT, out_shape=(8, 8, 3))
    conv = g.add_node(LayerKind.CONV, conv=ConvMeta(3, 4, 8, 8, 3, 3))
    gap = g.add_node(LayerKind.GLOBAL_POOL, out_shape=(1, 1, 4))
    fc = g.add_node(LayerKind.FC, out_shape=(1, 1, 5), in_features=4,
                    out_features=5)
    out = g.add_node(LayerKind.OUTPUT, out_shape=(1, 1, 5))
    g.chain([src, conv, gap, fc, out])
    ref = jax.tree_util.tree_map(
        np.asarray, jax_init_params(g, jax.random.PRNGKey(3)))
    ours = params_from_jax(ref, "cpu")
    assert set(ours) == {conv, fc}
    for nid, layer in ref.items():
        for name, value in layer.items():
            assert ours[nid][name].dtype == torch.float32
            np.testing.assert_array_equal(ours[nid][name].numpy(), value)
    assert tuple(ours[conv]["w"].shape) == (3, 3, 3, 4)


def test_executable_cache_shares_programs(setup):
    g, plan, _, _, _ = setup
    cache = ExecutableCache()
    a = compile_plan(g, plan, tuning_batch=2, cache=cache, device="cpu")
    b = compile_plan(googlenet(res=56, scale=0.25), plan, tuning_batch=2,
                     cache=cache, device="cpu")
    c = compile_plan(g, plan, tuning_batch=4, cache=cache, device="cpu")
    assert a is b and a is not c
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 2}


def test_executable_cache_key_names_every_option(setup):
    """Structurally equal graphs share a key; each option the program
    closes over (plan, kernels or plain, epilogue, bucket, elision,
    device) gives a key of its own."""
    g, plan, _, _, _ = setup
    base = dict(use_pallas=None, epilogue="bias_relu", tuning_batch=2,
                elide=True, device="cpu")
    key = executable_cache_key(g, plan, **base)
    assert key == executable_cache_key(googlenet(res=56, scale=0.25), plan,
                                       **base)
    assert executable_cache_key(g, plan, **{**base, "tuning_batch": None}) \
        == executable_cache_key(g, plan, **{**base, "tuning_batch": 1})
    variants = [executable_cache_key(g, None, **base),
                executable_cache_key(googlenet(res=32, scale=0.25), plan,
                                     **base)]
    for name, value in (("use_pallas", False), ("epilogue", "relu"),
                        ("tuning_batch", 4), ("elide", False),
                        ("device", "meta")):
        variants.append(executable_cache_key(g, plan,
                                             **{**base, name: value}))
    assert len({key, *variants}) == len(variants) + 1


def test_init_params_is_seeded_and_shaped(setup):
    g = setup[0]
    p0, p1 = init_params(g, seed=3, device="cpu"), init_params(
        g, seed=3, device="cpu")
    for nid, layer in p0.items():
        for name, value in layer.items():
            assert torch.equal(value, p1[nid][name])
    conv = g.conv_nodes()[0]
    m = conv.conv
    assert tuple(p0[conv.id]["w"].shape) == (m.k1, m.k2, m.c_in, m.c_out)
    assert not torch.equal(p0[conv.id]["w"],
                           init_params(g, seed=4, device="cpu")[conv.id]["w"])
