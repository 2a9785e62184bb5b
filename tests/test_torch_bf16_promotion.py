"""An f32 image over bf16 params, as the reference types it: the port's
``forward``, ``calibrate_act_scales``, compiled programs and engine
against the JAX reference's on the CPU.

The reference's ``forward`` takes its input as it comes: an f32 image over
bf16 params promotes, each layer runs f32 on the exactly widened weights
and the logits are f32, so ``calibrate_act_scales`` on f32 samples walks
in f32 too (``src/repro/cnn/executor.py::forward``,
``src/repro/core/quant.py::calibrate_act_scales``). Its engine casts each
image to its dtype first (``src/repro/serving/cnn_engine.py``), so a bf16
engine given f32 images walks in bf16. Weights are made with numpy from a
seed and rounded to bf16; images are seeded f32. Forwards are held at the
reference's whole-plan tolerance (rtol 2e-2, atol 2e-3), the scales within
1e-5 relative (both walk in f32; the sums' order alone differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.executor import forward as jax_forward
from repro.cnn.models import inception_v4 as jax_inception_v4
from repro.cnn.models import vgg16 as jax_vgg16
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import map_network as jax_map_network
from repro.core.quant import calibrate_act_scales as jax_calibrate
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import capture_key, compile_plan, forward
from repro_torch.cnn.models import inception_v4, vgg16
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import map_network
from repro_torch.core.quant import calibrate_act_scales
from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine


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
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)      # the reference's whole-plan tol
SCALE_REL = 1e-5
IV4 = dict(res=75, scale=0.2, n_a=1, n_b=1, n_c=1)
VGG = dict(res=8, scale=0.05)


def _rng(seed):
    return np.random.default_rng(seed)


def _jbf(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _np_params(graph, seed):
    """He-normal numpy params of ``graph`` rounded to bf16 (numpy keeps
    them as bf16 arrays), biases normal at 0.05."""
    rng = _rng(seed)
    params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.conv is not None:
            c = node.conv
            shape, fan_in, fan_out = ((c.k1, c.k2, c.c_in, c.c_out),
                                      c.k1 * c.k2 * c.c_in, c.c_out)
        elif "in_features" in node.attrs:
            fan_in = int(node.attrs["in_features"])
            fan_out = int(node.attrs["out_features"])
            shape = (fan_in, fan_out)
        else:
            continue
        params[nid] = {
            "w": np.asarray(_jbf(rng.standard_normal(shape)
                                 / np.sqrt(fan_in))),
            "b": np.asarray(_jbf(rng.normal(0, 0.05, fan_out)))}
    return params


def _jparams(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _model(name):
    """(port graph, plan, reference graph, plan, bf16 numpy params, two f32
    images) of reduced VGG16 or reduced Inception-v4."""
    if name == "vgg16":
        jg, g, res = jax_vgg16(**VGG), vgg16(**VGG), VGG["res"]
    else:
        jg, g = jax_inception_v4(**IV4), inception_v4(**IV4)
        res = IV4["res"]
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    x = _rng(1).standard_normal((2, res, res, 3)).astype(np.float32)
    return g, plan, jg, jplan, _np_params(jg, seed=0), x


@pytest.fixture(scope="module")
def tiny_vgg():
    return _model("vgg16")


@pytest.mark.parametrize("name", ["vgg16", "inception_v4"])
def test_f32_image_over_bf16_params_matches_reference_forward(name,
                                                              tiny_vgg):
    """The port's eager ``forward`` of f32 images over bf16 params walks
    in f32 and returns f32 logits, within the reference's whole-plan
    tolerance of the reference's ``forward`` of the same images (reduced
    VGG16 with its Winograd layers; reduced Inception-v4 with its kn2row
    and Winograd layers, whose eager reference walk takes ~25 s here, so
    the reference runs the same walk jitted: ``compile_plan`` with its
    plain ops, 4.5e-8 from the eager one)."""
    g, plan, jg, jplan, np_params, x = (tiny_vgg if name == "vgg16"
                                        else _model(name))
    got = forward(g, params_from_jax(np_params, "cpu"), x, plan,
                  epilogue="bias_relu", device="cpu")
    if name == "vgg16":
        ref = jax_forward(jg, _jparams(np_params), jnp.asarray(x), jplan,
                          epilogue="bias_relu")
    else:
        ref = jax_compile_plan(jg, jplan, epilogue="bias_relu")(
            _jparams(np_params), jnp.asarray(x))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PLAN_TOL)


def test_calibrate_act_scales_on_f32_samples_matches_reference(tiny_vgg):
    """``calibrate_act_scales`` on bf16 params and f32 samples walks in
    f32 on both sides: every scale within 1e-5 relative of the
    reference's (a bf16 walk lay 0.27% from it here)."""
    g, _, jg, _, np_params, x = tiny_vgg
    scales = calibrate_act_scales(g, params_from_jax(np_params, "cpu"), x)
    jscales = jax_calibrate(jg, _jparams(np_params), jnp.asarray(x))
    assert sorted(scales) == sorted(jscales)
    for nid, s in jscales.items():
        assert scales[nid] == pytest.approx(s, rel=SCALE_REL)


def test_compiled_program_takes_either_input_dtype(tiny_vgg):
    """A bf16 program on f32 input equals the eager ``forward`` of that
    input bit for bit (f32 logits), on bf16 input it walks in bf16, and
    the two inputs have two capture keys: one captured walk per input
    dtype."""
    g, plan, _, _, np_params, x = tiny_vgg
    params = params_from_jax(np_params, "cpu")
    run = compile_plan(g, plan, epilogue="bias_relu", dtype=BF,
                       device="cpu")
    got = run(params, x)
    want = forward(g, params, x, plan, epilogue="bias_relu", device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    x16 = torch.from_numpy(x).to(BF)
    assert run(params, x16).dtype == BF
    assert capture_key(params, x) != capture_key(params, x16)
    assert capture_key(params, x) == capture_key(params, torch.from_numpy(x))


def test_bf16_engine_casts_f32_images_as_the_reference(tiny_vgg):
    """A bf16 engine given f32 images casts each to bf16, as the
    reference's does: its results are the bf16 program's on the cast
    images, bit for bit, and lie within the reference's whole-plan
    tolerance of the reference engine's."""
    g, plan, jg, jplan, np_params, _ = tiny_vgg
    params = params_from_jax(np_params, "cpu")
    images = _rng(2).standard_normal((3, 8, 8, 3)).astype(np.float32)
    ours = CNNServingEngine(g, params, plan, batch_size=4, buckets=(4,),
                            dtype=BF, device="cpu")
    ref = JaxEngine(jg, _jparams(np_params), jplan, batch_size=4,
                    buckets=(4,), dtype=jnp.bfloat16)
    for engine, req in ((ours, CNNRequest), (ref, JaxRequest)):
        for rid, img in enumerate(images):
            engine.submit(req(rid=rid, image=img))
        engine.run_until_done()
    got = np.stack([ours.done[i] for i in range(3)])
    run = compile_plan(g, plan, epilogue="bias_relu", tuning_batch=4,
                       dtype=BF, device="cpu")
    x16 = torch.zeros((4, 8, 8, 3), dtype=BF)
    x16[:3] = torch.from_numpy(images).to(BF)
    cast = run(params, x16)[:3]
    assert cast.dtype == BF
    np.testing.assert_array_equal(got, cast.float().numpy())
    want = np.stack([np.asarray(ref.done[i], np.float32) for i in range(3)])
    np.testing.assert_allclose(got, want, **PLAN_TOL)
    f32_walk = run(params, np.concatenate([images, images[:1]]))[:3]
    assert f32_walk.dtype == torch.float32
    assert not np.array_equal(got, f32_walk.numpy())
