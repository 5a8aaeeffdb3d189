"""The port's dataset zoo, light microscopy (the recipes' readers and the first ones of the JAX
package's list), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): the same paths, ``len`` and samples
under the same ``np.random.seed``, loader batches of the same shapes, and every file under both
folders equal afterwards, so that what a reader converts (DSB's merged instances, LIVECell's
label TIFFs from COCO polygons and RLE, the HDF5 files of BCCD and HPA) is compared too. This
file also holds the module lists against each other: the port's light-microscopy modules are the
JAX package's, with its public names and signatures, and each has a case in one of the
``test_torch_datasets_lm_*`` files.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest

import torch_em_tpu.data.datasets.light_microscopy as jax_lm
import torch_em_tpu_torch.data.datasets.light_microscopy as port_lm
from torch_zoo_layouts import (IMAGE, LIGHT_MICROSCOPY, PATCH_2D, PATCH_3D, LMCase, check_case,
                               check_domain_matches_jax, check_every_module_has_a_case, labels, modules, raw,
                               same_samples, save_image, save_tif, write_h5)


def _image_pairs(folder_raw, folder_labels, rng, n, raw_name, label_name, rgb=False, high=4, dtype="uint8"):
    for i in range(n):
        save_image(folder_raw / (raw_name % i), raw(rng, IMAGE + ((3,) if rgb else ())))
        save_image(folder_labels / (label_name % i), labels(rng, high, IMAGE, dtype))


def build_dsb(root):
    """dsb2018's reduced layout: train and test images and masks as TIFF."""
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        _image_pairs(root / split / "images", root / split / "masks", rng, 3, "im%i.tif", "im%i.tif", dtype="uint16")


def build_dsb_full(root):
    """The 'full' source before ``_merge_instances``: RGBA images (fluorescence as equal channels,
    histopathology as colour) and one mask PNG per object."""
    rng = np.random.default_rng(1)
    for i, kind in enumerate(["fluo", "histo", "fluo"]):
        id_ = f"sample{i:03d}"
        if kind == "fluo":
            g = raw(rng, IMAGE)
            rgba = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
        else:
            rgba = raw(rng, IMAGE + (4,))
            rgba[..., -1] = 255
        save_image(root / "full" / id_ / "images" / f"{id_}.png", rgba)
        for m in range(3):
            mask = np.zeros(IMAGE, dtype="uint8")
            y, x = rng.integers(0, 48, 2)
            mask[y:y + 12, x:x + 10] = 255
            save_image(root / "full" / id_ / "masks" / f"m{m}.png", mask)


def merge_dsb(module, root):
    module._merge_instances(str(root))


def build_livecell(root):
    """LIVECell's layout: images under ``<cell type>/`` and a COCO file with polygons, an
    uncompressed RLE, a crowd region and cells that overlap (the larger painted last) or fall
    under 50 pixels (dropped)."""
    rng = np.random.default_rng(9)
    for split, ids in (("train", (0, 1, 2)), ("val", (3,))):
        images, annotations = [], []
        for i in ids:
            cell_type = ("A172", "BV2", "A172", "SkBr3")[i]
            fname = f"{cell_type}_Phase_A7_1_00d0{i}h00m_{i}.tif"
            save_image(root / "images" / "livecell_train_val_images" / cell_type / fname, raw(rng, IMAGE))
            images.append({"id": i, "file_name": fname, "height": 64, "width": 64})
            for j in range(4):
                x0, y0 = [int(v) for v in rng.integers(2, 40, 2)]
                w, h = [int(v) for v in rng.integers(4, 22, 2)]
                poly = [x0, y0, x0 + w, y0 + 1, x0 + w - 2, y0 + h, x0, y0 + h - 3]
                annotations.append({"id": 10 * i + j, "image_id": i, "segmentation": [poly], "area": w * h,
                                     "iscrowd": 0})
            mask = np.zeros((64, 64), bool)
            mask[20:40, 5:25] = True
            flat = mask.T.ravel()  # column-major runs, starting with background
            change = np.flatnonzero(np.diff(flat.astype(int))) + 1
            counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
            annotations.append({"id": 10 * i + 8, "image_id": i, "segmentation": {"size": [64, 64], "counts": counts},
                                "area": 400, "iscrowd": 1})
        (root / f"{split}.json").write_text(json.dumps({"images": images, "annotations": annotations}))


def build_covid_if(root):
    rng = np.random.default_rng(12)
    for i in range(4):
        write_h5(root / f"gt_image_{i:03d}.h5", raw__serum_IgG__s0=rng.random(IMAGE).astype("float32"),
                 raw__nuclei__s0=rng.random(IMAGE).astype("float32"),
                 labels__cells__s0=labels(rng, 4, IMAGE, "uint32"), labels__nuclei__s0=labels(rng, 3, IMAGE, "uint32"))


def build_plantseg(root):
    rng = np.random.default_rng(10)
    for name, split in (("ovules", "train"), ("root", "val")):
        for i in range(2):
            write_h5(root / f"{name}_{split}" / f"vol{i}.h5", raw=rng.random((8, 64, 64)).astype("float32"),
                     label=labels(rng, 5, low=1, dtype="uint32"))


def build_ctc(root):
    rng = np.random.default_rng(29)
    base = root / "train" / "DIC-C2DH-HeLa"
    for vol in ("01", "02"):
        for i in range(2):
            save_image(base / vol / f"t{i:03d}.tif", raw(rng, IMAGE))
            save_image(base / f"{vol}_GT" / "SEG" / f"man_seg{i:03d}.tif", labels(rng, 4, IMAGE, "int32"), mode="I")


def build_deepbacs(root):
    rng = np.random.default_rng(10)
    for split in ("training", "test"):
        folder = root / "mixed" / split
        _image_pairs(folder / "source", folder / "target", rng, 3, "im%i.tif", "im%i.tif")


def build_gonuclear(root):
    rng = np.random.default_rng(13)
    for sample in ("1135", "1136"):
        write_h5(root / "gonuclear_datasets" / f"{sample}.h5", raw__cells=raw(rng), raw__nuclei=raw(rng),
                 labels__cells=labels(rng, 4, dtype="uint32"), labels__nuclei=labels(rng, 4, dtype="uint32"))


def build_mouse_embryo(root):
    rng = np.random.default_rng(13)
    for name, split in (("Membrane", "train"), ("Membrane", "val"), ("Nuclei", "train"), ("Nuclei", "test")):
        for i in range(2):
            write_h5(root / name / split / f"vol{i}.h5", raw=rng.random((8, 64, 64)).astype("float32"),
                     label=labels(rng, 5, low=1, dtype="uint32"))


def build_orgasegment(root):
    rng = np.random.default_rng(14)
    for split in ("train", "val"):
        _image_pairs(root / split, root / split, rng, 3, "org%i_img.jpg", "org%i_masks_organoid.png", rgb=True)


def build_omnipose(root):
    """The bact_* layout (``train_sorted/<subfolder>/``) and the worm layout (flat)."""
    rng = np.random.default_rng(15)
    sub = root / "data" / "bact_phase" / "train_sorted" / "A22"
    _image_pairs(sub, sub, rng, 2, "img%i.tif", "img%i_masks.tif")
    worm = root / "data" / "worm" / "train"
    _image_pairs(worm, worm, rng, 2, "w%i.png", "w%i_masks.png")


def build_arvidsson(root):
    """RGB-coded instances: each colour one nucleus."""
    rng = np.random.default_rng(92)
    data_dir = root / "training_nuclei"
    for i in range(2):
        save_image(data_dir / "images" / f"im{i}.png", raw(rng, IMAGE))
        ann = np.zeros(IMAGE + (3,), dtype="uint8")
        for colour in ((255, 0, 0), (0, 255, 0), (0, 0, 255), (12, 200, 7)):
            y, x = rng.integers(0, 50, 2)
            ann[y:y + 12, x:x + 12] = colour
        save_image(data_dir / "annotations" / f"im{i}.png", ann)


def build_vgg_hela(root):
    rng = np.random.default_rng(36)
    for split in ("train", "test"):
        for i in (1, 2):
            save_image(root / split / "images" / f"im{i:02}.tif", raw(rng, IMAGE))
            points = np.zeros(IMAGE, "uint8")
            points[rng.integers(0, 64, 5), rng.integers(0, 64, 5)] = 1
            save_image(root / split / "labels" / f"im{i:02}.tif", points)


def build_ifnuclei(root):
    rng = np.random.default_rng(110)
    for i in range(2):
        save_image(root / "rawimages" / f"im{i}.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
        save_image(root / "groundtruth" / f"im{i}.tif", labels(rng, 5, IMAGE, "uint16"))


def build_embedseg(root):
    rng = np.random.default_rng(105)
    base = root / "Mouse-Skull-Nuclei-CBG"
    for split in ("train", "test"):
        for i in range(2):
            save_tif(base / split / "images" / f"v{i}.tif", raw(rng))
            save_tif(base / split / "masks" / f"v{i}.tif", labels(rng, 5, dtype="uint16"))


def build_neurips(root):
    """The challenge's labelled training images (grayscale and RGB mixed) and unlabelled ones."""
    rng = np.random.default_rng(12)
    train = root / "Training-labeled"
    for i in range(3):
        save_image(train / "images" / f"cell_{i:05d}.png", raw(rng, IMAGE + (() if i == 0 else (3,))))
        save_image(train / "labels" / f"cell_{i:05d}_label.png", labels(rng, 4, IMAGE, "uint8"))
    for i in range(2):
        save_image(root / "release-part1" / f"unl_{i:05d}.png", raw(rng, IMAGE + (3,)))


def build_cellseg_3d(root):
    rng = np.random.default_rng(97)
    base = root / "DATASET_WITH_GT"
    for i in range(3):
        save_tif(base / f"vol{i}.tif", (rng.random((8, 64, 64)) * 65535).astype("uint16"))
        save_tif(base / "labels" / f"vol{i}.tif", labels(rng, 5, dtype="uint16"))


def build_cellpose(root):
    rng = np.random.default_rng(20)
    for split in ("train", "test"):
        folder = root / "cyto" / split
        for i in range(3):
            save_image(folder / f"{i:03d}_img.png", raw(rng, IMAGE + (3,)))
            save_image(folder / f"{i:03d}_masks.png", labels(rng, 4, IMAGE, "int32"), mode="I")


def build_bccd(root):
    """Binary masks that the reader turns into connected components in HDF5 files."""
    rng = np.random.default_rng(35)
    base = root / "data" / "BCCD Dataset with mask"
    for split in ("train", "test"):
        for i in range(2):
            save_image(base / split / "original" / f"img_{i}.png", raw(rng, IMAGE + (3,)))
            save_image(base / split / "mask" / f"img_{i}.png", ((rng.random(IMAGE) > 0.6) * 255).astype("uint8"))


def build_hpa(root):
    """Four channel PNGs per image and a polygon annotation (none for the test split)."""
    rng = np.random.default_rng(34)
    for split in ("train", "valid", "test"):
        for k in range(2):
            img_dir = root / "hpa_dataset_v2" / split / f"img{k}"
            for chan in ("microtubules", "protein", "nuclei", "er"):
                save_image(img_dir / f"{chan}.png", raw(rng, IMAGE))
            if split != "test":
                x0, y0 = [float(v) for v in rng.integers(2, 30, 2)]
                features = [{"geometry": {"type": "Polygon", "coordinates": [[
                    [x0, y0], [x0 + 20, y0], [x0 + 25, y0 + 30], [x0, y0 + 20]]]}}]
                (img_dir / "annotation.json").write_text(json.dumps({"features": features}))


def _identity_raw(raw):
    return raw


def check_unsupervised(jax_mod, port_mod, jax_root, port_root):
    """The unsupervised datasets (the unlabelled images, with and without RGB): the same samples."""
    for kwargs in (dict(patch_shape=PATCH_2D, transform=_identity_raw),
                   dict(patch_shape=PATCH_2D, make_rgb=False, n_samples=3, transform=_identity_raw)):
        np.random.seed(5)
        expected = jax_mod.get_neurips_cellseg_unsupervised_dataset(str(jax_root), **kwargs)
        np.random.seed(5)
        got = port_mod.get_neurips_cellseg_unsupervised_dataset(str(port_root), **kwargs)
        same_samples(expected, got)


BOUNDARIES_2D = dict(patch_shape=PATCH_2D, boundaries=True)
BOUNDARIES_3D = dict(patch_shape=PATCH_3D, boundaries=True)

CASES = [
    LMCase("dsb", build_dsb,
           paths=[("get_dsb_paths", dict(split="train")), ("get_dsb_paths", {})],
           datasets=[("get_dsb_dataset", dict(split="train", **BOUNDARIES_2D)),
                     ("get_dsb_dataset", dict(patch_shape=(1, 32, 32), split="test", offsets=[[-1, 0], [0, -1]])),
                     ("get_dsb_dataset", dict(patch_shape=PATCH_2D, binary=True))],
           loaders=[("get_dsb_loader", dict(patch_shape=(1, 32, 32), batch_size=2, split="train", boundaries=True)),
                    ("get_dsb_loader", dict(patch_shape=(1, 32, 32), batch_size=2, split="test",
                                            label_dtype="int32", label_transform=None))]),
    LMCase("dsb", build_dsb_full, name="dsb_full", prepare=merge_dsb,
           paths=[("get_dsb_paths", dict(source="full")), ("get_dsb_paths", dict(source="full", domain="fluo"))],
           datasets=[("get_dsb_dataset", dict(source="full", domain="fluo", **BOUNDARIES_2D))]),
    LMCase("livecell", build_livecell,
           paths=[("get_livecell_paths", dict(split="train")),
                  ("get_livecell_paths", dict(split="train", cell_types=["A172"])),
                  ("get_livecell_paths", dict(split="val"))],
           datasets=[("get_livecell_dataset", dict(split="train", **BOUNDARIES_2D)),
                     ("get_livecell_dataset", dict(split="val", patch_shape=PATCH_2D, binary=True)),
                     ("get_livecell_dataset", dict(split="train", patch_shape=PATCH_2D, cell_types=("BV2",)))],
           loaders=[("get_livecell_loader", dict(split="train", patch_shape=PATCH_2D, batch_size=2, boundaries=True))]),
    LMCase("covid_if", build_covid_if,
           paths=[("get_covid_if_paths", {}), ("get_covid_if_paths", dict(sample_range=(1, 3)))],
           datasets=[("get_covid_if_dataset", dict(target="cells", **BOUNDARIES_2D)),
                     ("get_covid_if_dataset", dict(patch_shape=PATCH_2D, target="nuclei", sample_range=(0, 2),
                                                   binary=True))],
           loaders=[("get_covid_if_loader", dict(patch_shape=PATCH_2D, batch_size=2, target="nuclei",
                                                 boundaries=True))]),
    LMCase("plantseg", build_plantseg,
           paths=[("get_plantseg_paths", dict(name="ovules", split="train"))],
           datasets=[("get_plantseg_dataset", dict(name="ovules", split="train", **BOUNDARIES_3D)),
                     ("get_plantseg_dataset", dict(name="root", split="val", patch_shape=PATCH_3D,
                                                   offsets=[[-1, 0, 0], [0, -1, 0]]))],
           loaders=[("get_plantseg_loader", dict(name="ovules", split="train", batch_size=1, **BOUNDARIES_3D))]),
    LMCase("ctc", build_ctc,
           paths=[("get_ctc_segmentation_paths", dict(dataset_name="DIC-C2DH-HeLa")),
                  ("get_ctc_segmentation_paths", dict(dataset_name="DIC-C2DH-HeLa", vol_id="02"))],
           datasets=[("get_ctc_segmentation_dataset", dict(dataset_name="DIC-C2DH-HeLa", patch_shape=(1, 32, 32))),
                     ("get_ctc_segmentation_dataset", dict(dataset_name="DIC-C2DH-HeLa", patch_shape=(1, 32, 32),
                                                           vol_id="01"))],
           loaders=[("get_ctc_segmentation_loader", dict(dataset_name="DIC-C2DH-HeLa", patch_shape=(1, 32, 32),
                                                         batch_size=2))]),
    LMCase("deepbacs", build_deepbacs,
           paths=[("get_deepbacs_paths", dict(bac_type="mixed", split="train")),
                  ("get_deepbacs_paths", dict(bac_type="mixed", split="test"))],
           datasets=[("get_deepbacs_dataset", dict(split="train", patch_shape=PATCH_2D)),
                     ("get_deepbacs_dataset", dict(split="test", patch_shape=PATCH_2D))],
           loaders=[("get_deepbacs_loader", dict(split="train", patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("gonuclear", build_gonuclear,
           paths=[("get_gonuclear_paths", {}), ("get_gonuclear_paths", dict(sample_ids=["1135"]))],
           datasets=[("get_gonuclear_dataset", dict(segmentation_task="nuclei", **BOUNDARIES_3D)),
                     ("get_gonuclear_dataset", dict(patch_shape=PATCH_3D, segmentation_task="cells", binary=True,
                                                    sample_ids=[1136]))],
           loaders=[("get_gonuclear_loader", dict(batch_size=1, segmentation_task="cells", **BOUNDARIES_3D))]),
    LMCase("mouse_embryo", build_mouse_embryo,
           paths=[("get_mouse_embryo_paths", dict(name="membrane", split="train")),
                  ("get_mouse_embryo_paths", dict(name="nuclei", split="val"))],
           datasets=[("get_mouse_embryo_dataset", dict(name="membrane", split="val", **BOUNDARIES_3D)),
                     ("get_mouse_embryo_dataset", dict(name="nuclei", split="train", patch_shape=PATCH_3D,
                                                       offsets=[[-1, 0, 0], [0, 0, -2]]))],
           loaders=[("get_mouse_embryo_loader", dict(name="membrane", split="train", batch_size=1,
                                                     **BOUNDARIES_3D))]),
    LMCase("orgasegment", build_orgasegment,
           paths=[("get_orgasegment_paths", dict(split="train"))],
           datasets=[("get_orgasegment_dataset", dict(split="train", **BOUNDARIES_2D)),
                     ("get_orgasegment_dataset", dict(split="val", patch_shape=PATCH_2D, binary=True))],
           loaders=[("get_orgasegment_loader", dict(split="train", batch_size=2, **BOUNDARIES_2D))]),
    LMCase("omnipose", build_omnipose,
           paths=[("get_omnipose_paths", dict(split="train", data_choice=["bact_phase", "worm"]))],
           datasets=[("get_omnipose_dataset", dict(split="train", data_choice="bact_phase", **BOUNDARIES_2D)),
                     ("get_omnipose_dataset", dict(split="train", data_choice="worm", patch_shape=PATCH_2D,
                                                   binary=True))],
           loaders=[("get_omnipose_loader", dict(split="train", data_choice="bact_phase", batch_size=2,
                                                 patch_shape=PATCH_2D, binary=True))]),
    LMCase("arvidsson", build_arvidsson,
           paths=[("get_arvidsson_paths", dict(split="train"))],
           datasets=[("get_arvidsson_dataset", dict(split="train", **BOUNDARIES_2D)),
                     ("get_arvidsson_dataset", dict(split="train", patch_shape=PATCH_2D, offsets=[[-1, 0], [0, -1]]))],
           loaders=[("get_arvidsson_loader", dict(split="train", batch_size=2, patch_shape=IMAGE, binary=True))]),
    LMCase("vgg_hela", build_vgg_hela,
           paths=[("get_vgg_hela_paths", dict(split="train")), ("get_vgg_hela_paths", dict(split="test"))],
           datasets=[("get_vgg_hela_dataset", dict(split="train", patch_shape=PATCH_2D)),
                     ("get_vgg_hela_dataset", dict(split="test", patch_shape=PATCH_2D))],
           loaders=[("get_vgg_hela_loader", dict(split="train", patch_shape=PATCH_2D, batch_size=1))]),
    LMCase("ifnuclei", build_ifnuclei,
           paths=[("get_ifnuclei_paths", {})],
           datasets=[("get_ifnuclei_dataset", BOUNDARIES_2D),
                     ("get_ifnuclei_dataset", dict(patch_shape=PATCH_2D, binary=True))],
           loaders=[("get_ifnuclei_loader", dict(patch_shape=PATCH_2D, batch_size=2, binary=True))]),
    LMCase("embedseg_data", build_embedseg,
           paths=[("get_embedseg_paths", dict(name="Mouse-Skull-Nuclei-CBG", split="train"))],
           datasets=[("get_embedseg_dataset", dict(patch_shape=PATCH_3D, name="Mouse-Skull-Nuclei-CBG")),
                     ("get_embedseg_dataset", dict(patch_shape=PATCH_3D, name="Mouse-Skull-Nuclei-CBG", split="test"))],
           loaders=[("get_embedseg_loader", dict(patch_shape=PATCH_3D, batch_size=1, name="Mouse-Skull-Nuclei-CBG"))]),
    LMCase("neurips_cell_seg", build_neurips,
           paths=[("get_neurips_cellseg_paths", dict(split="train"))],
           datasets=[("get_neurips_cellseg_supervised_dataset", dict(split="train", patch_shape=PATCH_2D)),
                     ("get_neurips_cellseg_supervised_dataset", dict(split="train", patch_shape=PATCH_2D,
                                                                     make_rgb=False, n_samples=4))],
           loaders=[("get_neurips_cellseg_supervised_loader", dict(split="train", patch_shape=PATCH_2D,
                                                                   batch_size=2))],
           check=check_unsupervised),
    LMCase("cellseg_3d", build_cellseg_3d,
           paths=[("get_cellseg_3d_paths", {})],
           datasets=[("get_cellseg_3d_dataset", dict(patch_shape=PATCH_3D)),
                     ("get_cellseg_3d_dataset", dict(patch_shape=PATCH_3D, sample_ids=(0, 2)))],
           loaders=[("get_cellseg_3d_loader", dict(patch_shape=PATCH_3D, batch_size=1, sample_ids=(1,)))]),
    LMCase("cellpose", build_cellpose,
           paths=[("get_cellpose_paths", dict(split="train")), ("get_cellpose_paths", dict(split="test"))],
           datasets=[("get_cellpose_dataset", dict(split="train", patch_shape=PATCH_2D)),
                     ("get_cellpose_dataset", dict(split="test", patch_shape=PATCH_2D))],
           loaders=[("get_cellpose_loader", dict(split="train", patch_shape=PATCH_2D, batch_size=1))]),
    LMCase("bccd", build_bccd,
           paths=[("get_bccd_paths", dict(split="train")), ("get_bccd_paths", dict(split="test"))],
           datasets=[("get_bccd_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_bccd_dataset", dict(patch_shape=PATCH_2D, split="test", label_choice="semantic"))],
           loaders=[("get_bccd_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    LMCase("hpa", build_hpa,
           paths=[("get_hpa_segmentation_paths", dict(split="train", n_workers_preproc=1)),
                  ("get_hpa_segmentation_paths", dict(split="test", n_workers_preproc=1))],
           datasets=[("get_hpa_segmentation_dataset", dict(split="train", n_workers_preproc=1, **BOUNDARIES_2D)),
                     ("get_hpa_segmentation_dataset", dict(split="val", patch_shape=PATCH_2D, binary=True,
                                                           channels=("protein", "nuclei"), n_workers_preproc=1))],
           loaders=[("get_hpa_segmentation_loader", dict(split="train", patch_shape=PATCH_2D, batch_size=1,
                                                         binary=True, n_workers_preproc=2))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_lm_modules_and_public_names_match_jax():
    check_domain_matches_jax(jax_lm, port_lm, LIGHT_MICROSCOPY, 81)


def test_every_lm_module_has_a_parity_case():
    """Each port light-microscopy module has a case in one of the ``test_torch_datasets_lm_*`` files."""
    check_every_module_has_a_case(port_lm, Path(__file__).parent.glob("test_torch_datasets_lm_*.py"), "LMCase")


def test_zoo_exports_the_recipes_readers():
    """``from torch_em_tpu_torch.data.datasets import get_dsb_loader, get_livecell_loader`` works, and
    the zoo exports every light-microscopy getter of the JAX package's domain."""
    from torch_em_tpu_torch.data.datasets import get_dsb_loader, get_livecell_loader

    port_zoo = importlib.import_module("torch_em_tpu_torch.data.datasets")
    assert get_dsb_loader is modules("dsb", LIGHT_MICROSCOPY)[1].get_dsb_loader
    assert get_livecell_loader is modules("livecell", LIGHT_MICROSCOPY)[1].get_livecell_loader
    for getter in (n for n in dir(jax_lm) if n.startswith("get_")):
        assert getattr(port_zoo, getter) is getattr(port_lm, getter)


def test_livecell_decoder_matches_jax():
    """The COCO decoder (``_annotation_to_mask``) on polygons and an uncompressed RLE, as in the JAX package; a
    compressed RLE, on which the JAX package raises naming pycocotools, the port decodes with ``utils/coco.py``
    to the mask of the same runs uncompressed."""
    jax_mod, port_mod = modules("livecell", LIGHT_MICROSCOPY)
    rng = np.random.default_rng(3)
    for _ in range(4):
        xy = rng.uniform(0, 40, 12).round(2).tolist()
        ann = {"segmentation": [xy, [1, 1, 9, 2, 5, 8]]}
        np.testing.assert_array_equal(port_mod._annotation_to_mask(ann, (48, 40)),
                                      jax_mod._annotation_to_mask(ann, (48, 40)))
    ann = {"segmentation": {"size": [6, 5], "counts": [3, 4, 10, 2, 11]}}
    np.testing.assert_array_equal(port_mod._annotation_to_mask(ann, (6, 5)), jax_mod._annotation_to_mask(ann, (6, 5)))
    with pytest.raises(ValueError, match="pycocotools"):
        jax_mod._annotation_to_mask({"segmentation": {"size": [6, 5], "counts": "abc"}}, (6, 5))
    # the runs 3, 4, 10, 2, 11 compressed: 3, 4, 10 (':' = 48 + 10), then 2 - 4 = -2 ('N' = 48 + 30), 11 - 10 = 1
    compressed = {"segmentation": {"size": [6, 5], "counts": "34:N1"}}
    np.testing.assert_array_equal(port_mod._annotation_to_mask(compressed, (6, 5)),
                                  jax_mod._annotation_to_mask(ann, (6, 5)))
