"""The port's raw, generic, defect and nnU-Net transforms against the JAX package's.

Both sides are numpy and scipy and draw from the global ``np.random``, so
under the same ``np.random.seed`` before each call their outputs are equal.
"""

import json

import numpy as np
import pytest

import torch_em_tpu.transforms.defect as jax_defect
import torch_em_tpu.transforms.generic as jax_generic
import torch_em_tpu.transforms.nnunet_raw as jax_nnunet
import torch_em_tpu.transforms.raw as jax_raw
import torch_em_tpu_torch.transforms.defect as defect
import torch_em_tpu_torch.transforms.generic as generic
import torch_em_tpu_torch.transforms.nnunet_raw as nnunet
import torch_em_tpu_torch.transforms.raw as raw


def _image(shape=(2, 20, 24), seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _same(port_fn, jax_fn, *inputs, seeds=(0, 1, 2)):
    for seed in seeds:
        np.random.seed(seed)
        got = port_fn(*[np.copy(x) for x in inputs])
        np.random.seed(seed)
        expected = jax_fn(*[np.copy(x) for x in inputs])
        got, expected = (got, expected) if isinstance(got, tuple) else ((got,), (expected,))
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            assert np.asarray(g).dtype == np.asarray(e).dtype
            np.testing.assert_array_equal(g, e)


RAW_CASES = {
    "standardize": lambda m: m.standardize,
    "standardize_axis": lambda m: lambda x: m.standardize(x, axis=(1, 2)),
    "normalize": lambda m: m.normalize,
    "normalize_percentile": lambda m: lambda x: m.normalize_percentile(x, 2, 98),
    "RandomContrast": lambda m: m.RandomContrast(),
    "AdditiveGaussianNoise": lambda m: m.AdditiveGaussianNoise(),
    "AdditivePoissonNoise": lambda m: m.AdditivePoissonNoise(),
    "PoissonNoise": lambda m: m.PoissonNoise(),
    "GaussianBlur": lambda m: m.GaussianBlur(sigma=(0.5, 2.0)),
    "Compose": lambda m: m.Compose([m.normalize, m.RandomContrast(clip_kwargs=False)]),
    "RandomApply": lambda m: m.RandomApply([m.AdditiveGaussianNoise()], p=0.5),
    "get_raw_transform": lambda m: m.get_raw_transform(augmentation1=m.GaussianBlur()),
    "mean_teacher": lambda m: m.get_default_mean_teacher_augmentations(p=0.9),
}


@pytest.mark.parametrize("name", sorted(RAW_CASES))
def test_raw_transform_matches_jax(name):
    _same(RAW_CASES[name](raw), RAW_CASES[name](jax_raw), _image())


def test_raw_init_kwargs_match_jax():
    for name in ("RandomContrast", "AdditiveGaussianNoise", "AdditivePoissonNoise", "PoissonNoise",
                 "GaussianBlur"):
        assert getattr(raw, name)().init_kwargs == getattr(jax_raw, name)().init_kwargs
    transform = raw.get_raw_transform()
    assert transform.normalizer is raw.standardize and transform.init_kwargs["augmentation1"] is None


GENERIC_CASES = {
    "Tile": (lambda m: m.Tile(reps=(1, 2, 1)), 1),
    "Rescale": (lambda m: m.Rescale(scale=0.5), 2),
    "Rescale_label_channels": (lambda m: m.Rescale(scale=(2, 1.5), with_channels=[True, False], is_label=True), 2),
    "ResizeInputs": (lambda m: m.ResizeInputs(target_shape=(2, 13, 17)), 1),
    "ResizeInputs_label": (lambda m: m.ResizeInputs(target_shape=(3, 30, 12), is_label=True), 1),
    "ResizeLongestSideInputs": (lambda m: m.ResizeLongestSideInputs(target_shape=(32, 32)), 1),
    "PadIfNecessary": (lambda m: m.PadIfNecessary((24, 30)), 2),
    "Compose": (lambda m: m.Compose(m.PadIfNecessary((24, 30)), m.Rescale(scale=0.5)), 2),
}


@pytest.mark.parametrize("name", sorted(GENERIC_CASES))
def test_generic_transform_matches_jax(name):
    make, n_inputs = GENERIC_CASES[name]
    inputs = [_image(seed=3), (_image(seed=4)[0] * 5).round()][:n_inputs]
    if name == "Rescale_label_channels":
        inputs[1] = inputs[1][None].repeat(2, axis=0)[0]
    port_t, jax_t = make(generic), make(jax_generic)
    _same(port_t, jax_t, *inputs, seeds=(0,))
    assert port_t.init_kwargs.keys() == jax_t.init_kwargs.keys()


def test_resize_longest_side_restores_the_original_shape():
    image = _image((1, 20, 28), seed=5)[0]
    port_t = generic.ResizeLongestSideInputs(target_shape=(32, 32))
    jax_t = jax_generic.ResizeLongestSideInputs(target_shape=(32, 32))
    resized = port_t(image)
    jax_t(image)
    np.testing.assert_array_equal(port_t.convert_transformed_inputs_to_original_shape(resized),
                                  jax_t.convert_transformed_inputs_to_original_shape(resized))


@pytest.mark.parametrize("mode", ["undirected", "compress", "all"])
def test_defect_augmentation_matches_jax(mode):
    kwargs = dict(p_drop_slice=0.15, p_low_contrast=0.2, p_deform_slice=0.5, deformation_mode=mode,
                  deformation_strength=4.0)
    volume = _image((12, 40, 48), seed=6)
    _same(defect.EMDefectAugmentation(**kwargs), jax_defect.EMDefectAugmentation(**kwargs), volume)


def test_defect_paste_artifact_matches_jax():
    """Pasted artifacts: the same artifact source (numpy arrays) on both sides."""
    rng = np.random.default_rng(7)
    artifacts = [(rng.random((1, 32, 32)).astype(np.float32), rng.random((1, 32, 32)).astype(np.float32))
                 for _ in range(3)]
    kwargs = dict(p_drop_slice=0.0, p_low_contrast=0.0, p_deform_slice=0.0, p_paste_artifact=0.6,
                  artifact_source=artifacts)
    _same(defect.EMDefectAugmentation(**kwargs), jax_defect.EMDefectAugmentation(**kwargs),
          _image((6, 32, 32), seed=8))


def test_artifact_source_is_a_segmentation_dataset_with_2d_augmentations(tmp_path):
    path = str(tmp_path / "artifacts.npy")  # one array serves as artifacts and alpha mask
    np.save(path, np.random.default_rng(9).random((4, 64, 64)).astype(np.float32))
    source = defect.get_artifact_source(path, (1, 32, 32), 0.1, raw_key=None, mask_key=None)
    assert source.transform.init_kwargs == {"ndim": 2, "transforms": ["RandomHorizontalFlip", "RandomVerticalFlip"]}
    assert type(source.sampler).__name__ == "MinForegroundSampler"
    np.random.seed(0)
    artifact, alpha = source[0]
    assert artifact.shape == alpha.shape and artifact.squeeze().shape == (32, 32) and alpha.dtype == np.float32


def _plans(tmp_path, schemes):
    plans = {
        "foreground_intensity_properties_per_channel": {
            str(i): {"mean": 0.3 + i, "std": 0.2, "percentile_00_5": 0.05, "percentile_99_5": 0.9 + i}
            for i in range(len(schemes))},
        "configurations": {"3d_fullres": {"normalization_schemes": schemes}},
    }
    path = tmp_path / "nnUNetPlans.json"
    path.write_text(json.dumps(plans))
    return str(path)


def test_nnunet_raw_transform_matches_jax(tmp_path):
    path = _plans(tmp_path, ["CTNormalization", "CTNormalization"])
    volume = _image((2, 4, 16, 16), seed=10) * 2
    port_t, jax_t = nnunet.nnUNetRawTransform(path), jax_nnunet.nnUNetRawTransform(path)
    _same(port_t, jax_t, volume, seeds=(0,))
    assert port_t.init_kwargs == jax_t.init_kwargs
    with pytest.raises(NotImplementedError):
        nnunet.nnUNetRawTransform(_plans(tmp_path, ["ZScoreNormalization"]))(volume[:1])
