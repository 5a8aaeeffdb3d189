"""The last public names of the JAX package in the port: ``ConvBlock2d``, ``ConvBlock3d``,
``Upsampler2d``, ``Upsampler3d`` (with the ``Upsampler``'s ``mode``: linear, nearest, cubic and
Lanczos, the last two with their gradients) and
``ops.native.is_available``; and an ``ast`` comparison of every module pair's ``__all__``.

The blocks and upsamplers run in float32 on the same seeded numpy input in both packages, with
the JAX module's weights carried into the port by ``utils/convert.py``'s ``_conv_weight``;
tolerance atol 1e-4, as the U-Net parity (``tests/test_torch_unet.py``).
"""

import ast
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_em_tpu.models import unet as jax_unet
from torch_em_tpu_torch.models import unet
from torch_em_tpu_torch.ops import native
from torch_em_tpu_torch.utils.convert import _conv_weight

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
# module (relative to either package): the names of its __all__ that the port leaves out by design
# (ROADMAP.md, "Not ported, by design"): the flax wrappers and the mesh module's re-exports of JAX
BY_DESIGN = {"models/base.py": {"Model"}, "models/probabilistic_unet.py": {"ProbabilisticUNetModel"},
             "parallel/mesh.py": {"Mesh", "NamedSharding", "P"}}
# modules of the JAX package with no port module, by design: the Pallas kernels (ported to ops/csrc/)
# and the torch mirror of the flax models (the port's models are that twin)
NO_PORT_MODULE = {"ops/pallas/__init__.py", "ops/pallas/norm.py", "utils/torch_mirror.py"}


def _all_of(path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def test_every_module_pair_exports_the_same_names_but_the_by_design_list():
    jax_root, port_root = REPO / "torch_em_tpu", REPO / "torch_em_tpu_torch"
    gaps, unpaired = {}, set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if not (port_root / rel).exists():
            unpaired.add(rel)
            continue
        names = _all_of(path)
        if names:
            missing = names - (_all_of(port_root / rel) or set())
            if missing:
                gaps[rel] = missing
    assert gaps == BY_DESIGN
    assert unpaired == NO_PORT_MODULE


def _carry(variables, spatial_rank):
    """The port's state dict of a JAX ConvBlock's or Upsampler's flax variables."""
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    state = {}
    for key, value in flat.items():
        module, leaf = key.rsplit("/", 1)
        name = {"conv0": "block.1", "conv1": "block.4", "conv": "conv"}[module]
        if leaf == "kernel":
            state[f"{name}.weight"] = torch.from_numpy(_conv_weight(value, spatial_rank).copy())
        else:
            state[f"{name}.bias"] = torch.from_numpy(value.copy())
    return state


def _run_both(jax_module, port_module, shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x_last = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(seed), x_last)
    port_module.load_state_dict(_carry(variables, len(shape) - 2), strict=True)
    expected = np.moveaxis(np.asarray(jax.jit(jax_module.apply)(variables, x_last)), -1, 1)
    with torch.inference_mode():
        got = port_module(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape
    return got, expected


@pytest.mark.parametrize("dim", [2, 3])
def test_conv_block_partials_match_jax(dim):
    jax_block = {2: jax_unet.ConvBlock2d, 3: jax_unet.ConvBlock3d}[dim](out_channels=8)
    port_block = {2: unet.ConvBlock2d, 3: unet.ConvBlock3d}[dim](3, 8)
    shape = (2, 3, 24, 20) if dim == 2 else (2, 3, 6, 12, 10)
    got, expected = _run_both(jax_block, port_block, shape, seed=dim)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


UPSAMPLERS = {  # name: (dim, scale factor, mode, input shape)
    "2d_linear": (2, 2, "linear", (2, 6, 8, 10)),
    "2d_nearest": (2, 2, "nearest", (2, 6, 8, 10)),
    "3d_linear": (3, 2, "linear", (1, 6, 4, 6, 8)),
    "3d_nearest": (3, 2, "nearest", (1, 6, 4, 6, 8)),
    "3d_nearest_anisotropic": (3, (1, 2, 2), "nearest", (1, 6, 4, 6, 8)),
    "3d_trilinear_alias": (3, (1, 2, 2), "trilinear", (1, 6, 4, 6, 8)),
}


@pytest.mark.parametrize("name", sorted(UPSAMPLERS))
def test_upsampler_partials_match_jax(name):
    dim, factor, mode, shape = UPSAMPLERS[name]
    jax_up = {2: jax_unet.Upsampler2d, 3: jax_unet.Upsampler3d}[dim](out_channels=4, scale_factor=factor, mode=mode)
    port_up = {2: unet.Upsampler2d, 3: unet.Upsampler3d}[dim](shape[1], 4, factor, mode=mode)
    got, expected = _run_both(jax_up, port_up, shape, seed=7)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_partials_are_the_dim_forms():
    """Each partial builds the module of its ``dim`` form: the same parameters, the same output bitwise."""
    torch.manual_seed(0)
    x2, x3 = torch.randn(1, 3, 8, 8), torch.randn(1, 3, 4, 8, 8)
    for partial_cls, full, x in ((unet.ConvBlock2d, lambda: unet.ConvBlock(3, 4, dim=2), x2),
                                 (unet.ConvBlock3d, lambda: unet.ConvBlock(3, 4, dim=3), x3),
                                 (unet.Upsampler2d, lambda: unet.Upsampler(3, 4, 2, dim=2), x2),
                                 (unet.Upsampler3d, lambda: unet.Upsampler(3, 4, 2, dim=3), x3)):
        reference = full()
        for m in reference.modules():
            if isinstance(m, unet._Conv):
                m.reset_parameters(torch.Generator().manual_seed(1))
        module = partial_cls(3, 4) if partial_cls in (unet.ConvBlock2d, unet.ConvBlock3d) else partial_cls(3, 4, 2)
        module.load_state_dict(reference.state_dict(), strict=True)
        with torch.inference_mode():
            assert torch.equal(module(x), reference(x))


RESIZE_METHODS = {  # name: (dim, scale factor, mode, input shape)
    "2d_cubic_x2": (2, 2, "cubic", (2, 5, 6, 7)),
    "2d_bicubic_x3": (2, 3, "bicubic", (1, 5, 6, 7)),
    "2d_lanczos3_x3": (2, 3, "lanczos3", (1, 5, 6, 7)),
    "2d_lanczos5_x2": (2, 2, "lanczos5", (2, 5, 6, 7)),
    "3d_tricubic_133": (3, (1, 3, 3), "tricubic", (1, 4, 3, 5, 6)),
    "3d_cubic_x2": (3, 2, "cubic", (1, 4, 3, 5, 6)),
    "3d_lanczos3_133": (3, (1, 3, 3), "lanczos3", (1, 4, 3, 5, 6)),
    "3d_lanczos5_122": (3, (1, 2, 2), "lanczos5", (1, 4, 3, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(RESIZE_METHODS))
def test_upsampler_resize_methods_match_jax(name):
    """The cubic and Lanczos modes against the JAX ``Upsampler`` (``jax.image.resize``): the
    output to 1e-5 in float32, and the gradients of a seeded cotangent's inner product with
    respect to the input and the conv's weight and bias to 1e-4."""
    dim, factor, mode, shape = RESIZE_METHODS[name]
    jax_up = {2: jax_unet.Upsampler2d, 3: jax_unet.Upsampler3d}[dim](out_channels=3, scale_factor=factor, mode=mode)
    port_up = {2: unet.Upsampler2d, 3: unet.Upsampler3d}[dim](shape[1], 3, factor, mode=mode)
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    x_last = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = jax.jit(jax_up.init)(jax.random.PRNGKey(3), x_last)
    port_up.load_state_dict(_carry(variables, dim), strict=True)
    out_shape = shape[:2] + tuple(s * f for s, f in zip(shape[2:], unet._to_tuple(factor, dim)))
    cot = rng.normal(size=(shape[0], 3) + out_shape[2:]).astype(np.float32)

    def loss(params, x_last):
        out = jax_up.apply({"params": params}, x_last)
        return jnp.sum(out * jnp.asarray(np.moveaxis(cot, 1, -1)))

    expected = np.moveaxis(np.asarray(jax.jit(jax_up.apply)(variables, x_last)), -1, 1)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], x_last)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_up(xt)
    assert tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.detach().numpy(), expected, rtol=0, atol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(np.asarray(grads[1]), -1, 1), rtol=0, atol=1e-4)
    weight = _conv_weight(np.asarray(grads[0]["conv"]["kernel"]), dim)
    np.testing.assert_allclose(port_up.conv.weight.grad.numpy(), weight, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port_up.conv.bias.grad.numpy(), np.asarray(grads[0]["conv"]["bias"]), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["cubic", "lanczos3", "lanczos5", "bicubic"])
def test_unported_resize_methods_raise(mode):
    """Once unported, the resize methods now build (their values are held against the JAX
    package above); a name that is no ``jax.image.resize`` method still raises."""
    assert unet.Upsampler2d(2, 2, 2, mode=mode).mode == mode
    with pytest.raises(ValueError, match="Invalid upsampling mode"):
        unet.Upsampler3d(2, 2, 2, mode=mode + "x")


def test_names_are_exported():
    assert {"ConvBlock2d", "ConvBlock3d", "Upsampler2d", "Upsampler3d"} <= set(unet.__all__)
    assert "is_available" in native.__all__


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ builds the native library")
def test_native_is_available_with_gxx():
    assert native.is_available() is True


def test_native_is_available_is_false_when_the_build_fails(monkeypatch):
    def fail():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "load_library", fail)
    assert native.is_available() is False
