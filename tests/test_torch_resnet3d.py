"""The port's 3-D ResNets against the JAX package's, on the CPU in float32.

Both sides hold the same weights, the JAX module's carried over with
``resnet3d_state_dict_from_jax_params`` (random batch-norm statistics and
affine parameters in place of their init's constants). One block per stage,
basic and bottleneck, a grouped and widened bottleneck and a stem without
stride, on (2, 1, 16, 16, 16) inputs: the forward in eval mode (running
statistics), and in training mode, in float64 on both sides, the forward,
the new running statistics and the gradients of a cross entropy. The ten factories have the JAX
package's parameter and statistics counts (the JAX side by ``eval_shape``,
the port's on the meta device), and one records its arguments, seeds its
weights and rebuilds from its spec.

Tolerances: logits within 1e-4 of their largest magnitude; running
statistics within 1e-5; gradients within 1e-3 of each tensor's L2 norm plus
1e-6 of the largest gradient's (a bias that a batch norm follows has a true
gradient of zero and holds rounding noise on both sides).
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_em_tpu.models import resnet3d as jresnet
from torch_em_tpu_torch.models import resnet3d as presnet
from torch_em_tpu_torch.models.resnet3d import ResNet3dModule
from torch_em_tpu_torch.utils.convert import resnet3d_state_dict_from_jax_params

RTOL = 1e-4
VARIANTS = {
    "basic": dict(block="basic"),
    "bottleneck": dict(block="bottleneck"),
    "resnext": dict(block="bottleneck", groups=4, width_per_group=8),
    "no-stem-stride": dict(block="basic", stride_conv1=False),
}
FACTORIES = ["resnet3d_18", "resnet3d_34", "resnet3d_50", "resnet3d_101", "resnet3d_152", "resnext3d_50_32x4d",
             "resnext3d_101_32x8d", "resnext3d_101_64x4d", "wide_resnet3d_50_2", "wide_resnet3d_101_2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Six test workers' thread pools oversubscribe the CPU; one thread per worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(got, expected, rtol=RTOL):
    expected = np.asarray(expected)
    assert got.shape == expected.shape
    np.testing.assert_allclose(np.asarray(got), expected, rtol=0, atol=rtol * np.abs(expected).max())


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _input(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def pair(variant):
    """The JAX module, its randomised variables (flattened params and batch_stats) and the
    port's module with the same weights, for a ``VARIANTS`` entry with one block per stage."""
    kwargs = dict(VARIANTS[variant], layers=(1, 1, 1, 1), in_channels=1, out_channels=3)
    module = jresnet.ResNet3dModule(**kwargs)
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 16, 16)))
    rng = np.random.default_rng(1)
    params = {k: (v + rng.normal(size=v.shape).astype(np.float32) * 0.1 if "bn" in k else v)
              for k, v in _flat(variables["params"]).items()}
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var") else rng.normal(size=v.shape) * 0.1)
             .astype(np.float32) for k, v in _flat(variables["batch_stats"]).items()}
    port = ResNet3dModule(**kwargs)
    port.load_state_dict(resnet3d_state_dict_from_jax_params(params, stats), strict=True)
    return module, params, stats, port


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resnet3d_matches_jax(variant):
    module, params, stats, port = pair(variant)
    x = _input((2, 1, 16, 16, 16), 2)
    expected = jax.jit(module.apply)({"params": _tree(params), "batch_stats": _tree(stats)}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), expected)


@pytest.mark.parametrize("variant", ["basic", "resnext"])
def test_resnet3d_training_step_matches_jax(variant):
    """Batch statistics in the forward, the running statistics' update and the gradients of a
    cross entropy, in float64 on both sides (``jax.enable_x64``): in float32 the JAX package's
    own gradients lie up to 6e-3 of their norm from float64 ones here (the last stages' batch
    norms see two to eight values per channel), beyond the tolerance, while the port's lie
    within 1e-3."""
    module, params, stats, port = pair(variant)
    x = _input((2, 1, 16, 16, 16), 3).astype(np.float64)
    y = np.array([0, 2])
    with jax.enable_x64(True):
        as64 = functools.partial(jax.tree_util.tree_map, lambda v: jnp.asarray(v, jnp.float64))
        module64, stats64 = module.clone(dtype=jnp.float64), as64(_tree(stats))

        def loss_fn(p):
            logits, new = module64.apply({"params": p, "batch_stats": stats64}, jnp.asarray(x), train=True,
                                         mutable=["batch_stats"])
            return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), y]), (logits, new)

        (loss, (logits, new)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(as64(_tree(params)))
        logits, new_stats, grads = np.asarray(logits), _flat(new["batch_stats"]), _flat(grads)
    model = copy.deepcopy(port).double().train()
    model.dtype = torch.float64
    got = model(torch.from_numpy(x))
    got_loss = torch.nn.functional.cross_entropy(got, torch.from_numpy(y))
    got_loss.backward()
    _assert_close(got.detach().numpy(), logits)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    expected_stats = resnet3d_state_dict_from_jax_params(params, new_stats)
    for name, value in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            _assert_close(value.numpy(), expected_stats[name].numpy(), 1e-5)
    expected_grads = resnet3d_state_dict_from_jax_params(grads)
    largest = max(np.linalg.norm(g.numpy()) for g in expected_grads.values())
    for name, p in model.named_parameters():
        expected = expected_grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - expected)
        assert err <= 1e-3 * np.linalg.norm(expected) + 1e-6 * largest, (name, err, np.linalg.norm(expected))


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_matches_jax_sizes(name):
    """Each factory's model has the JAX package's parameter and running-statistics counts."""
    jax_model_module = None

    def capture(module, **kwargs):
        nonlocal jax_model_module
        jax_model_module = module
        raise StopIteration

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jresnet, "Model", capture)
        with pytest.raises(StopIteration):
            getattr(jresnet, name)(1, 4)
    shapes = jax.eval_shape(jax_model_module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 32)))
    count = lambda tree: sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))  # noqa: E731
    with torch.device("meta"):
        model = ResNet3dModule(jax_model_module.block, jax_model_module.layers, 1, 4, groups=jax_model_module.groups,
                               width_per_group=jax_model_module.width_per_group)
    assert sum(p.numel() for p in model.parameters()) == count(shapes["params"])
    assert sum(b.numel() for n, b in model.named_buffers() if n.endswith(("mean", "var"))) == \
        count(shapes["batch_stats"])
    factory = getattr(presnet, name)
    assert factory.__doc__


def test_factory_records_seeds_and_rebuilds():
    from torch_em_tpu_torch.trainer.serialization import deserialize_value, serialize_value

    model = presnet.resnext3d_50_32x4d(1, 4, device="cpu", seed=3)
    assert model.factory == "torch_em_tpu_torch.models.resnet3d.resnext3d_50_32x4d"
    assert model.init_kwargs == {"in_channels": 1, "out_channels": 4, "seed": 3, "device": "cpu"}
    assert model.layer1[0].conv2.groups == 32 and model.layer1[0].conv2.out_channels == 128
    rebuilt = deserialize_value(serialize_value(model))
    assert all(torch.equal(v, rebuilt.state_dict()[k]) for k, v in model.state_dict().items())
    with torch.no_grad():
        assert model(torch.zeros(1, 1, 32, 32, 32)).shape == (1, 4)
    with pytest.raises(TypeError, match="unexpected"):
        presnet.resnet3d_18(1, 4, device="cpu", depth=3)
