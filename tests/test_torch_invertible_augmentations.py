"""The port's invertible augmentations against the JAX package's.

``jax.random`` and ``torch`` cannot share draws, so the port's ``apply`` and
``inverse`` take the parameters that the JAX augmenter draws from its key
(``jax_params`` replays its splits), the same sigma and the same noise. The
geometric warps are permutations and agree bitwise; the blur and the noise
within 1e-6 (float32 sums of three taps).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_em_tpu.transforms import invertible_augmentations as jax_aug
from torch_em_tpu_torch.trainer.serialization import deserialize_value, serialize_value
from torch_em_tpu_torch.transforms import invertible_augmentations as aug

TOL = 1e-6
GEOMETRIC = list(itertools.product((-1, 0, 1, 2), (False, True), (False, True)))


def _batch(shape=(2, 3, 16, 16), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jax_params(jax_augmenter, key, x):
    """The port's parameters for the draws that ``jax_augmenter.forward(key, x)`` makes."""
    k_int = jax.random.split(key, 7)[0]
    _, drawn = jax_augmenter.forward(key, jnp.asarray(x))
    params = {"hflip": bool(drawn["hflip"]), "vflip": bool(drawn["vflip"]), "k": int(drawn["k"])}
    if jax_augmenter.kind == "strong":
        _, k_noise, k_bs, k_bp, k_np = jax.random.split(k_int, 5)
        lo, hi = jax_augmenter.blur_sigma
        sigma = float(jax.random.uniform(k_bs, (), minval=lo, maxval=hi))
        params["sigma"] = sigma if bool(jax.random.uniform(k_bp) < jax_augmenter.p) else None
        noise = np.asarray(jax.random.normal(k_noise, x.shape) * jax_augmenter.noise_std)
        params["noise"] = torch.from_numpy(noise.copy()) if bool(jax.random.uniform(k_np) < jax_augmenter.p) else None
    return params


def _jax_geometric(x, hflip, vflip, k):
    x = jnp.flip(x, axis=-1) if hflip else x
    x = jnp.flip(x, axis=-2) if vflip else x
    return jax_aug._rot90_lasttwo(x, jnp.int32(k))


@pytest.mark.parametrize("k,hflip,vflip", GEOMETRIC)
def test_geometric_forward_and_inverse_match_jax(k, hflip, vflip):
    x = _batch()
    params = {"hflip": hflip, "vflip": vflip, "k": k}
    jax_params_ = {"hflip": jnp.bool_(hflip), "vflip": jnp.bool_(vflip), "k": jnp.int32(k)}
    augmenter, jax_augmenter = aug.InvertibleAugmenter("weak"), jax_aug.InvertibleAugmenter("weak")
    warped = augmenter.apply(torch.from_numpy(x), params)
    np.testing.assert_array_equal(warped.numpy(), np.asarray(_jax_geometric(jnp.asarray(x), hflip, vflip, k)))
    pred = _batch(seed=1)
    np.testing.assert_array_equal(augmenter.inverse(torch.from_numpy(pred), params).numpy(),
                                  np.asarray(jax_augmenter.inverse(jnp.asarray(pred), jax_params_)))
    # the inverse undoes the warp, also on a 3-D batch (per slice)
    assert torch.equal(augmenter.inverse(warped, params), torch.from_numpy(x))
    x3 = torch.from_numpy(_batch((1, 2, 3, 8, 8), seed=2))
    assert torch.equal(augmenter.inverse(augmenter.apply(x3, params), params), x3)


@pytest.mark.parametrize("kind", ["weak", "strong"])
@pytest.mark.parametrize("seed", range(6))
def test_forward_with_jax_draws_matches_jax(kind, seed):
    x = _batch(seed=seed)
    key = jax.random.PRNGKey(seed)
    jax_augmenter = jax_aug.InvertibleAugmenter(kind)
    expected, _ = jax_augmenter.forward(key, jnp.asarray(x))
    params = jax_params(jax_augmenter, key, x)
    got = aug.InvertibleAugmenter(kind).apply(torch.from_numpy(x), params)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=TOL)


def test_strong_draws_cover_blur_and_noise():
    """Over the seeds of the test above, the strong augmenter blurs, adds noise and rotates."""
    jax_augmenter = jax_aug.InvertibleAugmenter("strong")
    drawn = [jax_params(jax_augmenter, jax.random.PRNGKey(s), _batch(seed=s)) for s in range(6)]
    assert any(p["sigma"] is not None for p in drawn) and any(p["noise"] is not None for p in drawn)
    assert any(p["k"] != 0 for p in drawn)


@pytest.mark.parametrize("sigma", [1e-4, 0.1, 0.37, 1.0])
def test_blur_matches_jax(sigma):
    x = _batch((2, 1, 12, 12), seed=3)
    np.testing.assert_allclose(aug.gaussian_blur3(torch.from_numpy(x), sigma).numpy(),
                               np.asarray(jax_aug._gaussian_blur3(jnp.asarray(x), jnp.float32(sigma))),
                               rtol=0, atol=TOL)


def test_draw_is_one_set_per_batch():
    augmenter = aug.InvertibleAugmenter("strong", p=1.0)
    x = torch.from_numpy(_batch())
    generator = torch.Generator().manual_seed(0)
    draws = [augmenter.draw(x, generator) for _ in range(200)]
    assert {d["k"] for d in draws} == {-1, 0, 1, 2}
    assert all(d["hflip"] and d["vflip"] and 0.1 <= d["sigma"] <= 1.0 for d in draws)
    assert all(d["noise"].shape == x.shape for d in draws)
    std = float(torch.stack([d["noise"] for d in draws]).std())
    assert abs(std - 0.1) < 0.005
    again = aug.InvertibleAugmenter("strong", p=1.0).draw(x, torch.Generator().manual_seed(0))
    assert again["k"] == draws[0]["k"] and torch.equal(again["noise"], draws[0]["noise"])
    weak = aug.InvertibleAugmenter("weak").draw(x, torch.Generator().manual_seed(0))
    assert set(weak) == {"hflip", "vflip", "k"}


def test_noise_comes_from_the_noise_generator():
    augmenter = aug.InvertibleAugmenter("strong", p=1.0)
    x = torch.from_numpy(_batch())
    first = augmenter.draw(x, torch.Generator().manual_seed(0), torch.Generator().manual_seed(5))
    second = augmenter.draw(x, torch.Generator().manual_seed(1), torch.Generator().manual_seed(5))
    assert torch.equal(first["noise"], second["noise"])


def test_stateful_api():
    augmenter = aug.InvertibleAugmenter("weak", p=1.0, seed=3)
    with pytest.raises(RuntimeError, match="transform before"):
        augmenter.reverse_transform(_batch())
    x = _batch()
    warped = augmenter.transform(x)
    assert augmenter.params is not None and torch.is_tensor(warped)
    np.testing.assert_array_equal(augmenter.reverse_transform(warped).numpy(), x)
    augmenter.reset()
    assert augmenter.params is None


def test_non_square_patch_raises():
    augmenter = aug.InvertibleAugmenter("weak")
    with pytest.raises(ValueError, match="square"):
        augmenter.forward(torch.zeros(1, 1, 16, 24))
    with pytest.raises(ValueError, match="square"):
        augmenter.inverse(torch.zeros(1, 1, 16, 24), {"hflip": False, "vflip": False, "k": 0})


def test_bundles_and_their_specs():
    x = torch.from_numpy(_batch())
    for bundle, parts in ((aug.MeanTeacherAugmenters(2), {"teacher": "weak", "student": "weak"}),
                          (aug.FixMatchAugmenters(2), {"teacher": "weak", "student": "strong"}),
                          (aug.UniMatchv2Augmenters(2), {"weak": "weak", "strong1": "strong", "strong2": "strong"})):
        assert {name: getattr(bundle, name).kind for name in parts} == parts
        rebuilt = deserialize_value(serialize_value(bundle))
        assert type(rebuilt) is type(bundle) and rebuilt.ndim == 2
        bundle.reset_all()
    bundle = aug.FixMatchAugmenters(2, student=aug.InvertibleAugmenter("strong", p=0.5, seed=7))
    rebuilt = deserialize_value(serialize_value(bundle))
    assert rebuilt.student.p == 0.5 and rebuilt.student.init_kwargs == bundle.student.init_kwargs
    warped, params = bundle.forward(x, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(bundle.inverse(warped, params).numpy(),
                               (x if params["sigma"] is None else aug.gaussian_blur3(x, params["sigma"])).add(
                                   0 if params["noise"] is None else params["noise"]).numpy(), rtol=0, atol=TOL)
    assert aug.DEFAULT_WEAK_AUGMENTATIONS == jax_aug.DEFAULT_WEAK_AUGMENTATIONS
    assert aug.DEFAULT_STRONG_AUGMENTATIONS == jax_aug.DEFAULT_STRONG_AUGMENTATIONS
