"""The port's dataset zoo, light microscopy (Parhyale regeneration to YeaZ), against the JAX
package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): paths, ``len``, samples under one
``np.random.seed``, loader batch shapes, and every file under both folders equal afterwards, the
reader's conversions included (Parhyale's, SegPC's, SLiMIA's, XPRESS's, YeastCellSeg's and
YeastMS's HDF5 files, Scaffold-A549's, SynthMT's and U2OS's TIFFs, TissueNet's and the wing
disc's zarr, YeaZ's split file). Conversions that only a download reaches run through the
reader's own function on both sides (``prepare``). YeaZ splits its images with sklearn's
``train_test_split`` in the JAX package and with the port's numpy copy (``datasets/util.py``):
both draw from numpy's global ``RandomState``, and the last tests hold the copy against sklearn.
"""

import io

import numpy as np
import pytest
from PIL import Image

from torch_em_tpu.utils.io import write_data as jax_write_data
from torch_em_tpu.utils.medical_io import save_nrrd
from torch_zoo_layouts import (IMAGE, PATCH_2D, PATCH_3D, VOLUME, LMCase, check_case, labels, raw, save_image,
                               save_stack, save_tif, write_h5)


def build_parhyale_regen(root):
    """The 50-timepoint hyperstack as one multi-page TIFF of 50 x 8 planes and the labels of six
    timepoints."""
    rng = np.random.default_rng(128)
    save_stack(root / "data" / "Parhyale_H2B-EGFP_images_tp01-50.tif", raw(rng, (50 * 8, 32, 32)))
    for tp in (1, 11, 21, 31, 41, 50):
        save_tif(root / "data" / f"Parhyale_instance-segmentation-labels_tp{tp:02d}.tif",
                 labels(rng, 4, (8, 32, 32), "uint16"))


def build_phmamm(root):
    rng = np.random.default_rng(129)
    for i in range(2):
        save_tif(root / "data" / "Inputs" / f"t{i}.tiff", raw(rng))
        save_tif(root / "data" / "ASTEC_Ground_truth" / f"t{i}.tiff", labels(rng, 5, dtype="uint16"))


def build_pnas_arabidopsis(root):
    rng = np.random.default_rng(130)
    for i in range(2):
        write_h5(root / "data" / f"plant{i}_trim-acylYFP.h5", raw=raw(rng), labels=labels(rng, 5, dtype="uint16"))


def build_scaffold_a549(root):
    """``.npy`` volumes that the reader converts to TIFF; only the test volume has labels."""
    rng = np.random.default_rng(131)
    for subdir in ("train", "test"):
        (root / "scaffold_a549" / subdir).mkdir(parents=True)
    np.save(root / "scaffold_a549" / "test" / "sf_a549_21.npy", (rng.random(VOLUME) * 255).astype("float32"))
    np.save(root / "scaffold_a549" / "test" / "sf_a549_21_Label.npy", labels(rng, 5, dtype="uint16"))
    for i in (1, 2):
        np.save(root / "scaffold_a549" / "train" / f"sf_a549_0{i}.npy", (rng.random(VOLUME) * 255).astype("float32"))


def build_segpc(root):
    """RGB BMPs and one mask per cell (cytoplasm 20, nucleus 40)."""
    rng = np.random.default_rng(132)
    for split in ("train", "validation"):
        data_dir = root / "TCIA_SegPC_dataset" / split
        for i in range(2):
            save_image(data_dir / "x" / f"{i}.bmp", raw(rng, IMAGE + (3,)))
            for k in (1, 2):
                off = int(rng.integers(2, 40))
                mask = np.zeros(IMAGE, dtype="uint8")
                mask[off:off + 16, off:off + 18] = 20
                mask[off + 4:off + 10, off + 4:off + 12] = 40
                save_image(data_dir / "y" / f"{i}_{k}.bmp", mask)


def build_slimia(root):
    rng = np.random.default_rng(133)
    for micro in ("OperaPhenix", "Cytation5"):
        for cell_line in ("HepG2", "A549"):
            for i in range(2):
                save_image(root / micro / "Images" / cell_line / f"im{i}.ome.tiff", raw(rng, IMAGE))
                save_image(root / micro / "Manual segmentations" / cell_line / f"im{i}.ome.tiff",
                           ((rng.random(IMAGE) > 0.5) * 255).astype("uint8"))


def build_spheroids_hepg2(root):
    rng = np.random.default_rng(134)
    (root / "spheroids").mkdir()
    (root / "GT").mkdir()
    for i in range(2):  # uncompressed: a gzip header holds the time of writing
        save_nrrd(str(root / "spheroids" / f"sph{i}.nrrd"), (rng.random(VOLUME) * 255).astype("float32"),
                  compressed=False)
        save_nrrd(str(root / "GT" / f"sph{i}.nrrd"), labels(rng, 5, dtype="uint16"), compressed=False)
        save_nrrd(str(root / "spheroids" / f"sph{i}_expanded.nrrd"), (rng.random(VOLUME) * 255).astype("float32"),
                  compressed=False)


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def build_synthmt(root):
    """The hub's eight parquet shards: a PNG image and one PNG mask per microtubule each row."""
    import pandas as pd

    rng = np.random.default_rng(135)
    (root / "parquets").mkdir()
    for i in range(8):
        masks = []
        for _ in range(2):
            m = np.zeros(IMAGE, dtype="uint8")
            y, x = rng.integers(0, 50, 2)
            m[y:y + 12, x:x + 12] = 255
            masks.append({"bytes": _png_bytes(m)})
        pd.DataFrame([{"id": f"s{i}", "image": {"bytes": _png_bytes(raw(rng, IMAGE + (3,)))}, "mask": masks}]
                     ).to_parquet(root / "parquets" / f"train-{i:05d}-of-00008.parquet")


def build_tissuenet(root):
    rng = np.random.default_rng(94)
    for split in ("train", "val"):
        np.savez(root / f"tissuenet_v1.1_{split}.npz", X=rng.random((3, 64, 64, 2)).astype("float32"),
                 y=labels(rng, 5, (3, 64, 64, 2), "int32"))


def build_toiam(root):
    rng = np.random.default_rng(136)
    for seq in ("01", "02"):
        for t in range(2):
            save_image(root / "data" / seq / f"t{t:03d}.tif", raw(rng, IMAGE))
            save_image(root / "data" / f"{seq}_GT" / "SEG" / f"man_seg{t:03d}.tif", labels(rng, 4, IMAGE, "uint16"))


def build_u20s(root):
    """RGBA masks with the nuclei in the red channel."""
    rng = np.random.default_rng(137)
    for i in range(2):
        save_image(root / "images" / f"im{i}.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
        mask = np.zeros(IMAGE + (4,), dtype="uint8")
        for _ in range(3):
            y, x = rng.integers(0, 48, 2)
            mask[y:y + 14, x:x + 14, 0] = 255
        mask[..., 3] = 255
        save_image(root / "masks" / f"im{i}.png", mask)


def process_u20s(module, root):
    module._process_masks(str(root))


def build_usiigaci(root):
    rng = np.random.default_rng(138)
    for split in ("train", "val"):
        for s in ("set1", "set2"):
            d = root / "Usiigaci" / "Mask R-CNN" / split / s
            save_image(d / "raw.tif", raw(rng, IMAGE))
            save_image(d / "instances_ids.png", labels(rng, 4, IMAGE, "uint8"))


def build_vicar(root):
    rng = np.random.default_rng(139)
    for ct in ("A2058", "G361"):
        for i in range(2):
            save_image(root / "labelled" / ct / f"{i}_img.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
            save_image(root / "labelled" / ct / f"{i}_mask.png", labels(rng, 4, IMAGE, "uint8"))


def build_vibrio_cholerae(root):
    rng = np.random.default_rng(140)
    data_dir = root / "training-data-from-experimentally-acquired-images"
    for i in range(2):
        save_image(data_dir / "raw-data" / f"im{i}_raw.tif", raw(rng, IMAGE))
        save_image(data_dir / "semi-manual-annotation" / f"im{i}_labels.tif", labels(rng, 4, IMAGE, "uint16"))


def build_wing_disc(root):
    """The OME-zarr volumes (raw as (1, 1, z, y, x), labels as (z, 1, 1, y, x))."""
    from torch_em_tpu.data.datasets.light_microscopy.wing_disc import VOLUMES

    rng = np.random.default_rng(141)
    for name in VOLUMES:
        jax_write_data(str(root / "zarr" / f"{name}.zarr"), "0/0",
                       (rng.random((1, 1, 8, 32, 32)) * 255).astype("uint16"))
        jax_write_data(str(root / "zarr" / f"{name}_segmented.zarr"), "0/0",
                       labels(rng, 4, (8, 1, 1, 32, 32), "uint16"))


def preprocess_wing_disc(module, root):
    module._preprocess_volumes(str(root), str(root / "data"))


def build_xpress(root):
    """The two downloads, raw and voxel labels, with the labels' offset in nm."""
    import h5py

    rng = np.random.default_rng(142)
    with h5py.File(root / "xpress-training-raw.h5", "w") as f:
        f.create_dataset("volumes/raw", data=raw(rng, (48, 48, 48))).attrs["resolution"] = [10, 10, 10]
    with h5py.File(root / "xpress-training-voxel-labels.h5", "w") as f:
        f.create_dataset("volumes/labels", data=labels(rng, 5, (16, 16, 16), "uint32")).attrs["offset"] = [200, 100,
                                                                                                            150]


def build_yeastcellseg(root):
    from torch_em_tpu.data.datasets.light_microscopy.yeastcellseg import _FILENAMES

    rng = np.random.default_rng(143)
    for name in _FILENAMES:
        save_image(root / "raw" / f"{name}.tif", raw(rng, IMAGE))
        gt = np.zeros(IMAGE, dtype="uint8")
        for _ in range(2):
            y, x = rng.integers(0, 46, 2)
            gt[y:y + 16, x:x + 16] = 255
        save_image(root / "gt" / f"{name}_gt.tif", gt)


def create_yeastcellseg(module, root):
    module._create_h5_data(str(root), str(root / "raw"), str(root / "gt"))


def build_yeastms(root):
    """``.pt`` tensors: the image, the instances (N, H, W) and their classes (1 = trap)."""
    import torch

    rng = np.random.default_rng(144)
    for split in ("train", "val"):
        for sub in ("inputs", "instances", "classes"):
            (root / split / sub).mkdir(parents=True)
        for i in range(2):
            torch.save(torch.from_numpy(rng.random(IMAGE).astype("float32")), root / split / "inputs" / f"s{i}.pt")
            inst = np.zeros((3,) + IMAGE, dtype="uint8")
            for k in range(3):
                y, x = rng.integers(0, 50, 2)
                inst[k, y:y + 10, x:x + 10] = 1
            torch.save(torch.from_numpy(inst), root / split / "instances" / f"s{i}.pt")
            torch.save(torch.from_numpy(np.array([0, 0, 1])), root / split / "classes" / f"s{i}.pt")


def build_yeastsam(root):
    rng = np.random.default_rng(145)
    for i in range(3):
        save_image(root / "DIC" / f"im{i}.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
        save_image(root / "DIC_mask" / f"im{i}.tif", labels(rng, 4, IMAGE, "uint16"))


def build_yeaz(root):
    """Ten image pairs; the reader splits them on first use, drawing from the global
    ``RandomState``, and keeps the split in a JSON file."""
    rng = np.random.default_rng(146)
    for i in range(10):
        save_image(root / "gold-standard-PhC-plus-2" / f"im{i}_im.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
        save_image(root / "gold-standard-PhC-plus-2" / f"im{i}_mask.tif", labels(rng, 4, IMAGE, "uint16"))


BOUNDARIES_3D = dict(patch_shape=PATCH_3D, boundaries=True)

CASES = [
    LMCase("parhyale_regen", build_parhyale_regen,
           paths=[("get_parhyale_regen_paths", {})],
           datasets=[("get_parhyale_regen_dataset", dict(patch_shape=(4, 16, 16)))],
           loaders=[("get_parhyale_regen_loader", dict(patch_shape=(4, 16, 16), batch_size=1))]),
    LMCase("phmamm", build_phmamm,
           paths=[("get_phmamm_paths", {})],
           datasets=[("get_phmamm_dataset", BOUNDARIES_3D),
                     ("get_phmamm_dataset", dict(patch_shape=PATCH_3D, offsets=[[-1, 0, 0], [0, -2, 0]]))],
           loaders=[("get_phmamm_loader", dict(patch_shape=PATCH_3D, batch_size=1, binary=True))]),
    LMCase("pnas_arabidopsis", build_pnas_arabidopsis,
           paths=[("get_pnas_arabidopsis_paths", {})],
           datasets=[("get_pnas_arabidopsis_dataset", dict(patch_shape=PATCH_3D))],
           loaders=[("get_pnas_arabidopsis_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("scaffold_a549", build_scaffold_a549,
           paths=[("get_scaffold_a549_paths", dict(split="test")), ("get_scaffold_a549_paths", dict(split="train"))],
           datasets=[("get_scaffold_a549_dataset", dict(patch_shape=PATCH_3D))],
           loaders=[("get_scaffold_a549_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("segpc", build_segpc,
           paths=[("get_segpc_paths", dict(split="train")), ("get_segpc_paths", dict(split="validation"))],
           datasets=[("get_segpc_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_segpc_dataset", dict(patch_shape=PATCH_2D, split="validation", label_choice="nuclei"))],
           loaders=[("get_segpc_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train",
                                              label_choice="cells"))]),
    LMCase("slimia", build_slimia,
           paths=[("get_slimia_paths", dict(microscope="OperaPhenix")),
                  ("get_slimia_paths", dict(microscope=["Cytation5", "OperaPhenix"]))],
           datasets=[("get_slimia_dataset", dict(patch_shape=PATCH_2D, microscope="OperaPhenix")),
                     ("get_slimia_dataset", dict(patch_shape=PATCH_2D, microscope=["Cytation5"]))],
           loaders=[("get_slimia_loader", dict(patch_shape=PATCH_2D, batch_size=2, microscope="OperaPhenix"))]),
    LMCase("spheroids_hepg2", build_spheroids_hepg2,
           paths=[("get_spheroids_hepg2_paths", {})],
           datasets=[("get_spheroids_hepg2_dataset", dict(patch_shape=PATCH_3D))],
           loaders=[("get_spheroids_hepg2_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("synthmt", build_synthmt,
           paths=[("get_synthmt_paths", {})],
           datasets=[("get_synthmt_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_synthmt_loader", dict(patch_shape=IMAGE, batch_size=2))]),
    LMCase("tissuenet", build_tissuenet,
           paths=[("get_tissuenet_paths", dict(split="train")), ("get_tissuenet_paths", dict(split="val"))],
           datasets=[("get_tissuenet_dataset", dict(split="train", patch_shape=PATCH_2D)),
                     ("get_tissuenet_dataset", dict(split="val", patch_shape=PATCH_2D, raw_channel="rgb",
                                                    label_channel="nucleus"))],
           loaders=[("get_tissuenet_loader", dict(split="train", patch_shape=PATCH_2D, batch_size=2,
                                                  raw_channel="rgb", label_channel="cell"))]),
    LMCase("toiam", build_toiam,
           paths=[("get_toiam_paths", {})],
           datasets=[("get_toiam_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_toiam_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("u20s", build_u20s, prepare=process_u20s,
           paths=[("get_u20s_paths", {})],
           datasets=[("get_u20s_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_u20s_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("usiigaci", build_usiigaci,
           paths=[("get_usiigaci_paths", dict(split="train")), ("get_usiigaci_paths", dict(split="val"))],
           datasets=[("get_usiigaci_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_usiigaci_dataset", dict(patch_shape=PATCH_2D, split="val"))],
           loaders=[("get_usiigaci_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("vibrio_cholerae", build_vibrio_cholerae,
           paths=[("get_vibrio_cholerae_paths", {})],
           datasets=[("get_vibrio_cholerae_dataset", dict(patch_shape=PATCH_2D, boundaries=True)),
                     ("get_vibrio_cholerae_dataset", dict(patch_shape=PATCH_2D, binary=True))],
           loaders=[("get_vibrio_cholerae_loader", dict(patch_shape=IMAGE, batch_size=2, binary=True))]),
    LMCase("vicar", build_vicar,
           paths=[("get_vicar_paths", {}), ("get_vicar_paths", dict(cell_types="A2058"))],
           datasets=[("get_vicar_dataset", dict(patch_shape=PATCH_2D)),
                     ("get_vicar_dataset", dict(patch_shape=PATCH_2D, cell_types=["G361"]))],
           loaders=[("get_vicar_loader", dict(patch_shape=PATCH_2D, batch_size=2, cell_types=["A2058"]))]),
    LMCase("wing_disc", build_wing_disc, prepare=preprocess_wing_disc,
           paths=[("get_wing_disc_paths", {})],
           datasets=[("get_wing_disc_dataset", dict(patch_shape=(4, 16, 16), boundaries=True)),
                     ("get_wing_disc_dataset", dict(patch_shape=(4, 16, 16), binary=True))],
           loaders=[("get_wing_disc_loader", dict(patch_shape=(4, 16, 16), batch_size=1, binary=True))]),
    LMCase("xpress", build_xpress,
           paths=[("get_xpress_paths", {})],
           datasets=[("get_xpress_dataset", dict(patch_shape=(8, 16, 16)))],
           loaders=[("get_xpress_loader", dict(patch_shape=(8, 16, 16), batch_size=1))]),
    LMCase("yeastcellseg", build_yeastcellseg, prepare=create_yeastcellseg,
           paths=[("get_yeastcellseg_paths", {})],
           datasets=[("get_yeastcellseg_dataset", dict(patch_shape=PATCH_2D)),
                     ("get_yeastcellseg_dataset", dict(patch_shape=PATCH_2D, label_choice="semantic"))],
           loaders=[("get_yeastcellseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, label_choice="semantic"))]),
    LMCase("yeastms", build_yeastms,
           paths=[("get_yeastms_paths", dict(split="train")), ("get_yeastms_paths", dict(split="val"))],
           datasets=[("get_yeastms_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_yeastms_dataset", dict(patch_shape=PATCH_2D, split="val"))],
           loaders=[("get_yeastms_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("yeastsam", build_yeastsam,
           paths=[("get_yeastsam_paths", {})],
           datasets=[("get_yeastsam_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_yeastsam_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("yeaz", build_yeaz,
           paths=[("get_yeaz_paths", dict(choice="phc", split="train")),
                  ("get_yeaz_paths", dict(choice="phc", split="val")),
                  ("get_yeaz_paths", dict(choice="phc", split="test"))],
           datasets=[("get_yeaz_dataset", dict(patch_shape=PATCH_2D, choice="phc", split="train", ndim=2)),
                     ("get_yeaz_dataset", dict(patch_shape=PATCH_2D, choice="phc", split="test", ndim=2))],
           loaders=[("get_yeaz_loader", dict(patch_shape=PATCH_2D, batch_size=2, choice="phc", split="train",
                                             ndim=2))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


@pytest.mark.parametrize("n", [2, 7, 10, 21, 100])
@pytest.mark.parametrize("test_size", [0.15, 0.2, 0.5])
@pytest.mark.parametrize("random_state", [None, 3])
def test_split_matches_sklearn(n, test_size, random_state):
    """``util._train_test_split`` is sklearn's ``train_test_split`` on one list and on two: with a seed,
    and with ``random_state=None``, where both draw from numpy's global ``RandomState``, so under one
    ``np.random.seed`` they give the same split and leave the global state alike."""
    from sklearn.model_selection import train_test_split

    from torch_em_tpu_torch.data.datasets import util

    names = [f"im{i}_im.tif" for i in range(n)]
    masks = [f"im{i}_mask.tif" for i in range(n)]
    for arrays in ((names,), (names, masks)):
        np.random.seed(17)
        expected = train_test_split(*arrays, test_size=test_size, random_state=random_state)
        after_expected = np.random.random()
        np.random.seed(17)
        got = util._train_test_split(*arrays, test_size=test_size, random_state=random_state)
        assert list(got) == list(expected) and all(type(part) is list for part in got)
        assert np.random.random() == after_expected


def test_split_rejects_empty_sides():
    from torch_em_tpu_torch.data.datasets import util

    with pytest.raises(ValueError):
        util._train_test_split([1, 2], test_size=0.99)
    with pytest.raises(ValueError):
        util._train_test_split([1, 2, 3], [1, 2], test_size=0.5)
