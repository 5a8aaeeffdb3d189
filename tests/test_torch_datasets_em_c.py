"""The port's dataset zoo, electron microscopy (humanneurons to zebrafinch), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): the same paths, ``len`` and samples
under the same ``np.random.seed``, loader batches of the same shapes, and equal converted files
where the reader converts its sources (MitoEM v2's NIfTI pairs into N5, MouseCC's NIfTI files,
ProbTEM's TIFF and PNG pairs, the WAE-NET archive, NISB's cube writer). The streamed datasets
(cloud-volume sources) are read from the cache files their download writes.
"""

import json

import numpy as np
import pytest

from torch_em_tpu.utils.io import write_data as jax_write_data
from torch_em_tpu.utils.medical_io import save_nifti
from torch_zoo_layouts import (IMAGE, PATCH_2D, PATCH_3D, Case, check_case, labels, modules, raw, same_container,
                               save_image, write_h5, zip_folder)

BOUNDARIES = dict(patch_shape=PATCH_3D, boundaries=True)


def _bbox_cache(module, name_of_box, seed, dtype="uint64"):
    """A builder of the cache file a streamed download writes for its default bounding box."""
    def build(root):
        jax_mod = modules(module)[0]
        rng = np.random.default_rng(seed)
        write_h5(root / name_of_box(jax_mod), raw=raw(rng), labels=labels(rng, low=1, dtype=dtype))
    return build


def build_microns(root):
    """Zenodo's pinky volume with neuron and mitochondria labels, and one whose labels do not
    match its image (the reader skips it)."""
    rng = np.random.default_rng(68)
    write_h5(root / "pinky" / "em0.h5", volumes__image=raw(rng), volumes__segmentation=labels(rng, low=1),
             volumes__mitochondria=labels(rng, 3))
    write_h5(root / "pinky" / "em1.h5", volumes__image=raw(rng), volumes__segmentation=labels(rng, low=1,
                                                                                             shape=(4, 32, 32)))


def build_microns_nuclei(root):
    rng = np.random.default_rng(5)
    for i in range(2):
        write_h5(root / "train" / f"crop{i}.h5", raw=raw(rng), labels__nuclei=labels(rng, 4, dtype="uint32"))


def build_mitoemv2(root):
    """One MitoEM v2 dataset: its split file and NIfTI image and label pairs in (x, y, z)."""
    rng = np.random.default_rng(58)
    ds_dir = root / "Dataset001_ME2-Beta"
    (ds_dir / "imagesTr").mkdir(parents=True)
    (ds_dir / "labelsTr").mkdir()
    (ds_dir / "split.json").write_text(json.dumps([{"train": ["me2-beta_train01", "me2-beta_train02"],
                                                    "val": ["me2-beta_val01"]}]))
    for sample in ("me2-beta_train01", "me2-beta_train02", "me2-beta_val01"):
        save_nifti(str(ds_dir / "imagesTr" / f"{sample}_0000.nii.gz"), raw(rng, (64, 64, 8)))
        save_nifti(str(ds_dir / "labelsTr" / f"{sample}.nii.gz"), labels(rng, 3, (64, 64, 8), "uint16"))


def build_mousecc(root):
    rng = np.random.default_rng(61)
    save_nifti(str(root / "datac.nii"), raw(rng, (64, 64, 8)))
    save_nifti(str(root / "maskc.nii"), (rng.random((64, 64, 8)) > 0.5).astype("uint8"))
    save_nifti(str(root / "myelin_mask.nii"), (rng.random((64, 64, 8)) > 0.5).astype("uint8"))
    save_nifti(str(root / "fibers.nii"), labels(rng, 5, (64, 64, 8), "uint32"))


def build_nisb(root):
    """Cached NISB cubes: ``<setting>/<split>/seed<i>/data.zarr`` with ``img`` and ``seg``."""
    rng = np.random.default_rng(65)
    for i in range(5):
        store = str(root / "base" / "train" / f"seed{i}" / "data.zarr")
        jax_write_data(store, "img", raw(rng, (16, 64, 64)))
        jax_write_data(store, "seg", labels(rng, low=1, shape=(16, 64, 64), dtype="uint16"))


class _V2Source:
    """An in-memory stand-in for a remote zarr v2 array in (x, y, z[, c]) order."""

    def __init__(self, array):
        self._array = array
        self.shape, self.ndim = array.shape, array.ndim

    def __getitem__(self, index):
        return self._array[index]


def check_nisb_writer(jax_mod, port_mod, jax_root, port_root):
    """``_nisb_write_cube`` streams a cube into a local zarr store in (z, y, x): equal stores."""
    rng = np.random.default_rng(66)
    source = {"img": _V2Source(raw(rng, (48, 40, 32, 1))), "seg": _V2Source(labels(rng, 7, (48, 40, 32), "uint16"))}
    for root, mod in ((jax_root, jax_mod), (port_root, port_mod)):
        out = root / "written" / "data.zarr"
        out.parent.mkdir()
        mod._nisb_write_cube(source, str(out))
    same_container(jax_root / "written" / "data.zarr", port_root / "written" / "data.zarr")


def build_probtem(root):
    rng = np.random.default_rng(62)
    base = root / "Deeppi-EM" / "mitoseg_deploy" / "datasets" / "Skeletal_muscle"
    for split in ("train", "test"):
        for i in range(2):
            save_image(base / split / "input" / f"x_{i}.tif", raw(rng, IMAGE + (3,)) if i else raw(rng, IMAGE))
            save_image(base / split / "target" / f"y_{i}.png", raw(rng, IMAGE))


def build_synapseweb(root):
    rng = np.random.default_rng(63)
    for region in ("spine", "oblique"):
        write_h5(root / f"synapseweb_hippocampus_{region}.h5", raw=raw(rng, (10, 64, 64)),
                 labels=labels(rng, low=1, shape=(10, 64, 64)))


WAENET_VALUES = {3: [0, 85, 170, 255]}


def build_waenet(root):
    """The WAE-NET archive: seven sub-datasets of images and masks whose class values are not
    consecutive (the reader renumbers them)."""
    rng = np.random.default_rng(66)
    for ds_id in range(1, 8):
        values = WAENET_VALUES.get(ds_id, [0, 128, 255])
        base = root / "src" / "Datasets" / f"Dataset {ds_id}"
        for i in range(2):
            save_image(base / "Images" / f"im{i}.png", raw(rng, IMAGE))
            save_image(base / "Ground truth mask" / f"im{i}.png",
                       np.choose(rng.integers(0, len(values), IMAGE), values).astype("uint8"))
    zip_folder(root / "src", root / "Datasets.zip", root / "src")


def _default_box(attr, prefix=""):
    return lambda mod: f"{prefix}{mod._bbox_to_str(getattr(mod, attr))}.h5"


CASES = [
    Case("humanneurons", _bbox_cache("humanneurons", _default_box("DEFAULT_BOUNDING_BOX", "humanneurons_"), 56),
         paths=[("get_humanneurons_paths", {})],
         datasets=[("get_humanneurons_dataset", BOUNDARIES)],
         loaders=[("get_humanneurons_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    Case("hydra_vulgaris", _bbox_cache("hydra_vulgaris", lambda m: f"hydra_{m._bbox_to_str(m.HYDRA_BOUNDING_BOXES[0])}.h5",
                                       57),
         paths=[("get_hydra_paths", {})],
         datasets=[("get_hydra_dataset", dict(patch_shape=PATCH_3D, offsets=[[-1, 0, 0], [0, -2, 0]]))],
         loaders=[("get_hydra_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    Case("malecns", _bbox_cache("malecns", _default_box("DEFAULT_BOUNDING_BOX"), 59),
         paths=[("get_malecns_paths", {})],
         datasets=[("get_malecns_dataset", dict(patch_shape=PATCH_3D))],
         loaders=[("get_malecns_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    Case("manc", _bbox_cache("manc", _default_box("DEFAULT_BOUNDING_BOX"), 60),
         paths=[("get_manc_paths", {})],
         datasets=[("get_manc_dataset", BOUNDARIES)],
         loaders=[("get_manc_loader", dict(patch_shape=PATCH_3D, batch_size=1, boundaries=True))]),
    Case("microns", build_microns, name="microns_zenodo",
         paths=[("get_microns_paths", dict(volumes=["pinky"], download=False)),
                ("get_microns_paths", dict(volumes=["pinky"], download=False, label_key="volumes/mitochondria"))],
         datasets=[("get_microns_dataset", dict(patch_shape=PATCH_3D, volumes=["pinky"], boundaries=True)),
                   ("get_microns_dataset", dict(patch_shape=PATCH_3D, label_choice="mitochondria"))],
         loaders=[("get_microns_loader", dict(batch_size=1, patch_shape=PATCH_3D, volumes=["pinky"],
                                              offsets=[[-1, 0, 0]]))]),
    Case("microns", _bbox_cache("microns",
                                lambda m: f"minnie65_{m._minnie65_bbox_to_str(m.MINNIE65_BOUNDING_BOXES['val'][0])}.h5",
                                69, dtype="uint32"), name="microns_minnie65",
         paths=[("get_microns_minnie65_paths", dict(bounding_boxes=[(733048, 765816, 525324, 558092, 787320,
                                                                     807800)]))],
         datasets=[("get_microns_minnie65_dataset", dict(patch_shape=PATCH_3D, split="val", bounding_boxes=[
             (733048, 765816, 525324, 558092, 787320, 807800)], boundaries=True))],
         loaders=[("get_microns_minnie65_loader", dict(batch_size=1, patch_shape=PATCH_3D, bounding_boxes=[
             (733048, 765816, 525324, 558092, 787320, 807800)]))]),
    Case("microns_nuclei", build_microns_nuclei, paths=[("get_microns_nuclei_paths", dict(split="train",
                                                                                          download=False))],
         datasets=[("get_microns_nuclei_dataset", dict(split="train", patch_shape=PATCH_3D))],
         loaders=[("get_microns_nuclei_loader", dict(split="train", patch_shape=PATCH_3D, batch_size=2))]),
    Case("mitoemv2", build_mitoemv2,
         paths=[("get_mitoemv2_paths", dict(datasets="beta", split="train")),
                ("get_mitoemv2_paths", dict(datasets=["beta"], split="val"))],
         datasets=[("get_mitoemv2_dataset", dict(patch_shape=PATCH_3D, datasets="beta"))],
         loaders=[("get_mitoemv2_loader", dict(patch_shape=PATCH_3D, batch_size=1, datasets="beta", split="val"))],
         converted=["n5_data/beta/me2-beta_train01.n5", "n5_data/beta/me2-beta_val01.n5"]),
    Case("mousecc", build_mousecc, paths=[("get_mousecc_paths", {})],
         datasets=[("get_mousecc_dataset", dict(patch_shape=PATCH_3D)),
                   ("get_mousecc_dataset", dict(patch_shape=PATCH_3D, label_choice="fibers"))],
         loaders=[("get_mousecc_loader", dict(patch_shape=PATCH_3D, batch_size=1, label_choice="fibers"))],
         converted=["mousecc.h5"]),
    Case("nisb", build_nisb, paths=[("get_nisb_paths", dict(setting="base", split="train"))],
         datasets=[("get_nisb_dataset", dict(patch_shape=(8, 32, 32), boundaries=True)),
                   ("get_nisb_dataset", dict(patch_shape=(8, 32, 32), offsets=[[-1, 0, 0], [0, 0, -4]]))],
         loaders=[("get_nisb_loader", dict(patch_shape=(8, 32, 32), batch_size=2))],
         check=check_nisb_writer),
    Case("probtem", build_probtem, paths=[("get_probtem_paths", dict(split="test"))],
         datasets=[("get_probtem_dataset", dict(patch_shape=PATCH_2D, split="train"))],
         loaders=[("get_probtem_loader", dict(patch_shape=PATCH_2D, batch_size=2))],
         converted=["processed/train/x_0.h5", "processed/train/x_1.h5", "processed/test/x_1.h5"]),
    Case("synapseweb_hippocampus", build_synapseweb,
         paths=[("get_synapseweb_hippocampus_paths", dict(regions=("spine", "oblique")))],
         datasets=[("get_synapseweb_hippocampus_dataset", dict(
             patch_shape=PATCH_3D, regions=("spine", "oblique"),
             rois={"spine": np.s_[1:9, 8:60, 8:60], "oblique": np.s_[0:10, 0:64, 16:64]}))],
         loaders=[("get_synapseweb_hippocampus_loader", dict(patch_shape=PATCH_3D, batch_size=1, regions=("spine",),
                                                             rois={"spine": np.s_[1:9, 8:60, 8:60]}))]),
    Case("waenet", build_waenet, paths=[("get_waenet_paths", dict(dataset_id=5))],
         datasets=[("get_waenet_dataset", dict(patch_shape=PATCH_2D, dataset_id=3, label_type="mitochondria")),
                   ("get_waenet_dataset", dict(patch_shape=PATCH_2D))],
         loaders=[("get_waenet_loader", dict(patch_shape=PATCH_2D, batch_size=2, dataset_id=2,
                                             label_type="chromosomes"))],
         converted=[f"dataset_{i}/im{j}.h5" for i in range(1, 8) for j in range(2)]),
    Case("wildenberg", _bbox_cache("wildenberg", _default_box("DEFAULT_BOUNDING_BOX", "p14_psd_"), 64),
         paths=[("get_wildenberg_paths", dict(experiment="p14", labels="psd"))],
         datasets=[("get_wildenberg_dataset", dict(patch_shape=PATCH_3D))],
         loaders=[("get_wildenberg_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    Case("zebrafinch", _bbox_cache("zebrafinch", _default_box("DEFAULT_BOUNDING_BOX", "j0126_"), 67),
         paths=[("get_zebrafinch_paths", {})],
         datasets=[("get_zebrafinch_dataset", BOUNDARIES)],
         loaders=[("get_zebrafinch_loader", dict(patch_shape=PATCH_3D, batch_size=1, dataset="j0126"))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)
