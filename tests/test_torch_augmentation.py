"""The port's geometric augmentations against the JAX package's.

Each primitive's ``apply`` runs on parameters drawn by the JAX
``sample_params`` and carried across as numpy; ``gaussian_blur``, the cubic
resize and the elastic noise field run on the same numpy inputs on both
sides. Labels resample with order 0 and may differ only where a sampling
coordinate lies within 1e-4 of a rounding tie. The pipeline's host path,
``apply_batched`` and the sampling statistics are checked on the port alone.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_em_tpu.transforms.augmentation as J
import torch_em_tpu_torch.transforms.augmentation as P

FLOAT_ATOL = 1e-5
SMOOTH_ATOL = 1e-6
TIE = 1e-4
PLANAR = ("RandomRotation", "RandomAffine", "RandomElasticDeformation")


def _cases():
    for name in sorted(J.AUGMENTATIONS):
        if "Flip" in name:
            shapes = [(2, 24, 24), (2, 8, 24, 24)]
        else:
            shapes = [(2, 24, 24)] if name in PLANAR else [(2, 8, 24, 24)]
        for shape in shapes:
            for order in (0, 1):
                yield pytest.param(name, shape, order, id=f"{name}-{len(shape) - 1}d-order{order}")


def _port_params(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _near_tie(aug, spatial, params):
    """(*spatial) mask of voxels with a sampling coordinate within TIE of a rounding tie."""
    coords = aug.coords(spatial, {k: v[None] for k, v in params.items()})
    near = torch.zeros(coords[0].shape[1:], dtype=torch.bool)
    for c in coords:
        near |= ((c[0] - torch.floor(c[0])) - 0.5).abs() < TIE
    return near.numpy()  # an elastic field's (H, W) broadcasts over the planes


@pytest.mark.parametrize("name,shape,order", list(_cases()))
def test_primitive_matches_jax_apply(name, shape, order):
    kwargs = J.AUGMENTATIONS[name]
    jax_aug, port_aug = getattr(J, name)(**kwargs), getattr(P, name)(**kwargs)
    rng = np.random.default_rng(len(shape) * 10 + order)
    for seed in range(4):
        params = {k: np.asarray(v) for k, v in jax_aug.sample_params(jax.random.PRNGKey(seed), shape[1:]).items()}
        params["apply"] = np.asarray(seed != 3)  # the last draw is kept as it is
        if order == 1:
            x = rng.random(shape).astype(np.float32)
        else:
            x = rng.integers(0, 50, shape).astype(np.float32)
        expected = np.asarray(jax_aug.apply(jnp.asarray(x), params, order))
        got = port_aug.apply(torch.from_numpy(x), _port_params(params), order).numpy()
        assert got.shape == expected.shape and got.dtype == expected.dtype
        if order == 1:
            np.testing.assert_allclose(got, expected, rtol=0, atol=FLOAT_ATOL)
            continue
        differ = got != expected
        if differ.any():
            assert port_aug.interpolating, f"{name} differs without resampling"
            near = np.broadcast_to(_near_tie(port_aug, shape[1:], _port_params(params)), shape)
            assert not (differ & ~near).any(), f"{int(differ.sum())} labels differ away from a tie"


@pytest.mark.parametrize("sigma", [1.5, 3.0, 30.0])
def test_gaussian_blur_matches_jax(sigma):
    """Radius ceil(3 sigma) is 5, 9 and 90: the last two reflect wider than the axes of 7 and 5."""
    field = np.random.default_rng(0).normal(size=(2, 5, 7)).astype(np.float32)
    expected = np.asarray(J.gaussian_blur(jnp.asarray(field), sigma))
    got = P.gaussian_blur(torch.from_numpy(field), sigma).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=SMOOTH_ATOL)


@pytest.mark.parametrize("src,dst", [((2, 3, 4), (2, 24, 24)), ((2, 5, 7), (2, 64, 48)),
                                     ((2, 9, 6), (2, 4, 6))])
def test_cubic_resize_matches_jax(src, dst):
    x = np.random.default_rng(1).uniform(-1, 1, size=src).astype(np.float32)
    expected = np.asarray(jax.image.resize(jnp.asarray(x), dst, method="cubic"))
    got = P.cubic_resize(torch.from_numpy(x), dst).numpy()
    assert got.shape == tuple(dst)
    np.testing.assert_allclose(got, expected, rtol=0, atol=SMOOTH_ATOL)


@pytest.mark.parametrize("spacing,shape2d", [(4, (24, 24)), (1, (16, 20)), ((3, 5), (30, 40))])
def test_noise_field_matches_jax_from_the_same_control_noise(spacing, shape2d):
    kwargs = dict(control_point_spacing=spacing, sigma=(4.0, 6.0))
    jax_aug, port_aug = J.RandomElasticDeformation(**kwargs), P.RandomElasticDeformation(**kwargs)
    control = np.random.default_rng(2).uniform(-1, 1, (2,) + port_aug.control_shape(shape2d)).astype(np.float32)
    expected = np.asarray(J.gaussian_blur(jax.image.resize(jnp.asarray(control), (2,) + shape2d, "cubic"),
                                          float(np.mean(jax_aug.sigma))))
    got = port_aug.smooth_noise(torch.from_numpy(control), shape2d).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-5)
    # and the JAX draw's own field has the control grid the port draws
    jax_noise = np.asarray(jax_aug._noise_field(jax.random.PRNGKey(0), shape2d))
    port_noise = port_aug.sample_params(torch.Generator().manual_seed(0), (1,) + shape2d)["noise"]
    assert port_noise.shape == jax_noise.shape and port_noise.dtype == torch.float32


def test_registry_defaults_and_factory():
    assert P.AUGMENTATIONS == J.AUGMENTATIONS
    assert P.DEFAULT_2D_AUGMENTATIONS == J.DEFAULT_2D_AUGMENTATIONS
    assert P.DEFAULT_3D_AUGMENTATIONS == J.DEFAULT_3D_AUGMENTATIONS
    assert P.DEFAULT_ANISOTROPIC_AUGMENTATIONS == J.DEFAULT_ANISOTROPIC_AUGMENTATIONS
    for name in J.AUGMENTATIONS:
        jax_aug, port_aug = J.create_augmentation(name), P.create_augmentation(name)
        assert type(port_aug).__name__ == type(jax_aug).__name__
        assert vars(port_aug) == vars(jax_aug), name
        assert port_aug.interpolating == jax_aug.interpolating
    with pytest.raises(ValueError, match="not defined"):
        P.create_augmentation("RandomShear")
    for ndim in (2, 3, "anisotropic"):
        jax_pipe, port_pipe = J.get_augmentations(ndim), P.get_augmentations(ndim)
        assert port_pipe.init_kwargs == jax_pipe.init_kwargs
        assert [type(a).__name__ for a in port_pipe.augmentations] == \
            [type(a).__name__ for a in jax_pipe.augmentations]
        assert port_pipe.factory == "torch_em_tpu_torch.transforms.augmentation.get_augmentations"
        assert port_pipe.dtype == torch.float32 and port_pipe.halo is None
    named = ["RandomHorizontalFlip", "RandomRotation"]
    assert P.get_augmentations(2, named).init_kwargs == J.get_augmentations(2, named).init_kwargs
    with pytest.raises(ValueError):
        P.get_augmentations(4)
    assert P.KorniaAugmentationPipeline is P.AugmentationPipeline


@pytest.mark.parametrize("names", [["RandomHorizontalFlip"], ["RandomRotation"], ["RandomRotation3D"],
                                   ["RandomAffine", "RandomRotation3D"], ["RandomElasticDeformation"]])
def test_compute_halo_matches_jax(names):
    augs_j = [J.create_augmentation(n) for n in names]
    augs_p = [P.create_augmentation(n) for n in names]
    assert P.AugmentationPipeline(*augs_p).halo == J.AugmentationPipeline(*augs_j).halo


def _draw(aug, generator, spatial, batch):
    return P._stack([aug.sample_params(generator, spatial) for _ in range(batch)])


@pytest.mark.parametrize("name", sorted(J.AUGMENTATIONS))
def test_apply_batch_matches_per_element_apply(name):
    aug = P.create_augmentation(name)
    shape = (3, 2, 16, 20) if name in PLANAR else (3, 1, 6, 16, 20)
    gen = torch.Generator().manual_seed(4)
    params = _draw(aug, gen, shape[2:], shape[0])
    params["apply"] = torch.tensor([True, False, True])
    raw = torch.rand(shape, generator=gen)
    labels = torch.randint(0, 30, shape, generator=gen)
    for x, order in ((raw, 1), (labels, 0)):
        batched = aug.apply_batch(x, params, order)
        assert batched.dtype == x.dtype and batched.shape == x.shape
        for b in range(shape[0]):
            single = aug.apply(x[b], {k: v[b] for k, v in params.items()}, order)
            assert torch.equal(batched[b], single)
        assert torch.equal(batched[1], x[1])  # not applied


def test_apply_batched_draws_per_element_and_keeps_label_values():
    pipeline = P.get_augmentations(3, ["RandomHorizontalFlip3D", "RandomRotation3D",
                                       "RandomElasticDeformation3D"])
    gen = torch.Generator().manual_seed(5)
    raw = torch.rand((4, 1, 6, 16, 16), generator=gen).expand(4, 1, 6, 16, 16).contiguous()
    raw[:] = raw[0]
    labels = torch.randint(0, 9, (1, 1, 6, 16, 16), generator=gen).expand(4, 1, 6, 16, 16).contiguous()
    out_raw, out_labels = pipeline.apply_batched(gen, raw, labels)
    assert out_raw.shape == raw.shape and out_labels.dtype == torch.int64
    assert len({out_raw[b].sum().item() for b in range(4)}) > 1  # the elements differ
    assert set(out_labels.unique().tolist()) <= set(labels.unique().tolist())


def test_sample_statistics():
    gen = torch.Generator().manual_seed(6)
    n = 2000
    flips = torch.stack([P.RandomHorizontalFlip().sample_params(gen, (8, 8))["apply"] for _ in range(n)])
    assert abs(flips.float().mean().item() - 0.5) < 0.05
    rot = P.RandomRotation(degrees=30)
    angles = torch.stack([rot.sample_params(gen, (8, 8))["angle"] for _ in range(n)])
    assert angles.abs().max() <= np.deg2rad(30) + 1e-6 and angles.std() > np.deg2rad(10)
    affine = P.RandomAffine(degrees=10, scale=(0.9, 1.1))
    scales = torch.stack([affine.sample_params(gen, (8, 8))["scale"] for _ in range(n)])
    assert scales.min() >= 0.9 and scales.max() <= 1.1 and scales.max() - scales.min() > 0.15
    affine3d = P.create_augmentation("RandomAffine3D")  # registry scale (0.0, 1.1): clamped to 1e-2
    draws = [affine3d.sample_params(gen, (4, 8, 8)) for _ in range(n)]
    scales = torch.stack([d["scale"] for d in draws])
    assert scales.min() >= 1e-2 and scales.max() <= 1.1
    for key in ("yaw", "pitch", "roll"):
        assert torch.stack([d[key] for d in draws]).abs().max() <= np.deg2rad(90) + 1e-6


def test_host_path_is_reproducible_and_casts():
    raw = np.random.default_rng(7).random((4, 16, 16)).astype(np.float64)
    labels = np.random.default_rng(8).integers(0, 7, (4, 16, 16)).astype(np.uint32)

    def pipeline(seed):
        return P.AugmentationPipeline(*[P.create_augmentation(n) for n in
                                        ("RandomHorizontalFlip", "RandomRotation")], seed=seed)

    first, second = pipeline(3)(raw, labels), pipeline(3)(raw, labels)
    assert all(np.array_equal(a, b) for a, b in zip(first, second))
    assert all(a.dtype == np.float32 and a.shape == raw.shape for a in first)
    assert set(np.unique(first[1])) <= set(np.unique(labels).astype(np.float32))
    outputs = [tuple(o.tobytes() for o in pipeline(s)(raw, labels)) for s in range(6)]
    assert len(set(outputs)) > 1


def test_host_path_is_safe_from_threads():
    """Threads that share a pipeline draw the same seeds as one thread would, each once."""
    raw = np.random.default_rng(9).random((2, 12, 12)).astype(np.float32)

    def make():
        names = ("RandomHorizontalFlip", "RandomVerticalFlip", "RandomRotation")
        return P.AugmentationPipeline(*[P.create_augmentation(n) for n in names], seed=10)

    calls, n_threads = 64, 16  # more threads than cores
    serial = make()
    expected = sorted(serial(raw)[0].tobytes() for _ in range(calls))
    shared = make()
    results, lock = [], threading.Lock()

    def work():
        for _ in range(calls // n_threads):
            out = shared(raw)[0].tobytes()
            with lock:
                results.append(out)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(results) == expected


def test_elastic_3d_takes_a_sample_without_channel_axis():
    """A dataset hands a 3D patch over as (D, H, W): every plane takes the same 2D field,
    as a (1, D, H, W) sample does (the JAX package raises here)."""
    aug = P.create_augmentation("RandomElasticDeformation3D")
    params = aug.sample_params(torch.Generator().manual_seed(11), (24, 24))
    params["apply"] = torch.tensor(True)
    x = torch.rand((6, 24, 24), generator=torch.Generator().manual_seed(12))
    planes = aug.apply(x, params, 1)
    assert torch.equal(planes, aug.apply(x[None], params, 1)[0])
    with pytest.raises(TypeError):
        J.create_augmentation("RandomElasticDeformation3D").apply(
            jnp.asarray(x.numpy()), {k: jnp.asarray(v.numpy()) for k, v in params.items()}, 1)
