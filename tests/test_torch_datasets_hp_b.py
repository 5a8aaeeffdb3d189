"""The port's dataset zoo, histopathology (the readers that convert to HDF5, CPU-only on the card,
and PUMA's and HEST's, whose conversions need geopandas, rasterio, shapely, scanpy or
huggingface_hub), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): paths, ``len``, samples under one
``np.random.seed``, loader batch shapes, and every file under both folders equal afterwards, the
HDF5 files the readers write included. Conversions that only a download reaches run through the
reader's own function on both sides (``prepare``: GlaS, Lizard, SegPath). PUMA's cases start from
the converted layout, HEST's from a converted slide and one that the reader converts without its
optional inputs; the last tests hold that both packages raise the same exception where one of those
packages is missing, and compare the pure helpers directly.

CoNIC splits its sources with sklearn's ``StratifiedShuffleSplit`` in the JAX package and with the
port's numpy copy of its first split (``datasets/util.py:_stratified_shuffle_split``), which a test
holds against sklearn. BCSS and TNBC split with ``train_test_split`` in the JAX package and with the
port's numpy copy. PCNS's crosswalk reader skips rows whose patch id is not a number, where the JAX
package's raises: a test reads one with a prose footer.
"""

import gzip
import importlib.util
import json
import struct
import sys
import tarfile
from pathlib import Path

import h5py
import numpy as np
import pytest

from torch_zoo_layouts import (HISTOPATHOLOGY, IMAGE, PATCH_2D, HPCase, check_case, labels, modules, raw, save_image,
                               save_mat, write_h5, zip_folder)
from torch_zoo_layouts import no_network  # noqa: F401 (the fixture of pytestmark)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_conversion_layouts as layouts  # noqa: E402

pytestmark = pytest.mark.usefixtures("no_network")


def _rgb(rng, shape=IMAGE):
    return raw(rng, shape + (3,))


def build_bcss(root):
    """The git repository's layout (flat ``images`` and ``masks``); one slide of the held-out list."""
    from torch_em_tpu.data.datasets.histopathology.bcss import TEST_LIST

    rng = np.random.default_rng(301)
    names = [f"TCGA-XX-{i:04d}-DX1_xmin{i}_ymin{i}_MPP-0.2500" for i in range(6)] + TEST_LIST[:2]
    for name in names:
        save_image(root / "images" / f"{name}.png", _rgb(rng))
        save_image(root / "masks" / f"{name}.png", labels(rng, 5, IMAGE, "uint8"))


def build_conic(root):
    """The downloaded folder: ``patch_info.csv`` and the image and label stacks, two cohorts of five
    sources with two patches each."""
    rng = np.random.default_rng(302)
    data = root / "data"
    data.mkdir()
    names = [f"{c}_{s}-{i}" for c in ("consep", "crag") for s in range(5) for i in range(2)]
    (data / "patch_info.csv").write_text("patch_info\n" + "\n".join(names) + "\n")
    np.save(data / "images.npy", raw(rng, (len(names),) + IMAGE + (3,)))
    np.save(data / "labels.npy", np.stack([labels(rng, 5, (len(names),) + IMAGE, "int32"),
                                           labels(rng, 7, (len(names),) + IMAGE, "int32")], axis=-1))


def build_consep(root):
    """The tiled release: 224x224 tiles named by their box, a two-tile train image and a one-tile
    test image, instance maps as ``.mat``."""
    rng = np.random.default_rng(303)
    base = root / "data" / "consep"
    for name in ("train_1_0_224_0_224", "train_1_0_224_224_448", "test_2_0_224_0_224"):
        save_image(base / "tiles" / f"{name}.png", _rgb(rng, (224, 224)))
        inst = np.zeros((224, 224), "int32")
        for k in range(1, 6):
            y, x = rng.integers(0, 200, 2)
            inst[y:y + 24, x:x + 24] = k
        inst[100:120, 210:224] = 9  # touches the seam between the train tiles
        save_mat(base / "labels" / f"{name}.mat", instance_map=inst)


def build_cytodark0(root):
    """The zip: both magnifications' images, instance and semantic labels and folds."""
    rng = np.random.default_rng(304)
    src = root / "cytoDArk0"
    for mag, res in (("20x", "1024x1024"), ("40x", "2048x2048")):
        base = src / mag / res
        rows = ["img_id,fold"]
        for i, fold in enumerate((0, 0, 1, 2)):
            name = f"{mag}_im{i}"
            save_image(base / "image" / f"{name}.png", _rgb(rng))
            save_image(base / "label" / f"{name}.tiff", labels(rng, 5, IMAGE, "int32"), mode="I")
            save_image(base / "graymask4" / f"{name}.png", labels(rng, 4, IMAGE, "uint8"))
            rows.append(f"{name},{fold}")
        (base / "folds.csv").write_text("\n".join(rows) + "\n")
    zip_folder(src, root / "cytoDArk0.zip", root)


def build_glas(root):
    rng = np.random.default_rng(305)
    base = root / "Warwick_QU_Dataset"
    for name in ("train_1", "train_2", "train_10", "testA_1", "testB_1"):
        save_image(base / f"{name}.bmp", _rgb(rng))
        save_image(base / f"{name}_anno.bmp", labels(rng, 5, IMAGE, "uint8"))


def convert_glas(module, root):
    for split in ("train", "test"):
        module._extract_images(split, str(root))


def build_glysac(root):
    rng = np.random.default_rng(306)
    for folder in ("Train", "Test"):
        for i in (1, 2, 11):
            save_image(root / "glysac_dataset" / folder / "Images" / f"im{i}.png", _rgb(rng))
            save_mat(root / "glysac_dataset" / folder / "Labels" / f"im{i}.mat",
                     inst_map=labels(rng, 5, IMAGE, "float64"), type_map=labels(rng, 3, IMAGE, "float64"))


def build_lizard(root):
    rng = np.random.default_rng(307)
    rows = ["Filename,Source,Split"]
    for k, (folder, names) in enumerate((("lizard_images1/Lizard_Images1", ("consep_1", "consep_2", "crag_1")),
                                         ("lizard_images2/Lizard_Images2", ("dpath_1", "pannuke_1")))):
        for j, name in enumerate(names):
            save_image(root / folder / f"{name}.png", _rgb(rng))
            save_mat(root / "lizard_labels" / "Lizard_Labels" / "Labels" / f"{name}.mat",
                     inst_map=labels(rng, 5, IMAGE, "int32"), **{"class": np.array([[1], [2], [3], [4]])})
            rows.append(f"{name},{name.split('_')[0]},{(k + j) % 3 + 1}")
    (root / "lizard_labels" / "Lizard_Labels" / "info.csv").write_text("\n".join(rows) + "\n")


def convert_lizard(module, root):
    label_folder = str(root / "lizard_labels" / "Lizard_Labels" / "Labels")
    for split in ("train", "val"):
        for folder in ("lizard_images1/Lizard_Images1", "lizard_images2/Lizard_Images2"):
            module._extract_images(split, str(root / folder), label_folder, str(root))


def build_orion_crc(root):
    """The tile release's tables and tiles: two slides with cell tables for the semantic labels (their
    cells at tile-local and at slide coordinates), and a tile whose image is missing (skipped)."""
    rng = np.random.default_rng(308)
    rows = ["slide_name,image_path,target_path,nuclei_path"]
    for slide, origins in (("slideA.ome.tiff", ((100, 200), (164, 200))), ("slideB.ome.tiff", ((0, 0),))):
        for ox, oy in origins:
            stem = f"{slide.split('.')[0]}_{ox}_{oy}_0_64_64"
            save_image(root / "tiles" / f"{stem}_he.png", _rgb(rng))
            save_image(root / "tiles" / f"{stem}_mif.png", raw(rng, IMAGE))
            save_image(root / "tiles" / f"{stem}_nuclei.png", labels(rng, 6, IMAGE, "uint16"))
            rows.append(f"{slide},tiles/{stem}_he.png,tiles/{stem}_mif.png,tiles/{stem}_nuclei.png")
    rows.append("slideB.ome.tiff,tiles/missing_he.png,tiles/missing_mif.png,tiles/missing_nuclei.png")
    for split in ("train", "val", "test"):
        (root / f"{split}_dataframe.csv").write_text("\n".join(rows) + "\n")
    (root / "cells_slideA.csv").write_text("cell_type,x,y\ntumor,105,205\nlymphocyte,125,225\nstroma,180,230\n"
                                           "tumor,20,30\n")
    (root / "cells_slideB.csv").write_text("cell_type,x,y\nstroma,10,12\n")
    (root / "slide_dataframe.csv").write_text("slide_name,orion_slide_id,nuclei_csv_path\n"
                                              "slideA.ome.tiff,slideA,cells_slideA.csv\n"
                                              "slideB.ome.tiff,slideB,cells_slideB.csv\n")


def build_pannuke(root):
    """Two folds' zips of the image and mask stacks (five nucleus-type channels and background)."""
    rng = np.random.default_rng(309)
    for fold, inner in (("fold_1", "Fold 1"), ("fold_2", "Fold 2")):
        src = root / "src" / inner
        (src / "images" / fold.replace("_", "")).mkdir(parents=True)
        (src / "masks" / fold.replace("_", "")).mkdir(parents=True)
        n = 3
        np.save(src / "images" / fold.replace("_", "") / "images.npy", raw(rng, (n,) + IMAGE + (3,)).astype("float64"))
        masks = np.zeros((n,) + IMAGE + (6,), "float64")
        for c in range(5):
            masks[..., c] = labels(rng, 3, (n,) + IMAGE, "float64") * (rng.random((n,) + IMAGE) > 0.7)
        masks[..., 5] = masks[..., :5].sum(-1) == 0
        np.save(src / "masks" / fold.replace("_", "") / "masks.npy", masks)
        zip_folder(src, root / f"{fold}.zip", root / "src")
    (root / "src").rmdir()


CROSSWALK = "Pan-Cancer-Nuclei-Seg crosswalk\n\nPatch-ID,CancerType,TCGA-ID\n" + "".join(
    f"{pid},{ct},TCGA-{pid:02d}\n" for pid, ct in ((1, "BLCA"), (2, "BRCA"), (3, "BLCA"), (4, "BRCA"), (5, "blca"),
                                                   (6, "LUAD"))) + "7,,TCGA-07\n"


def build_pcns(root):
    """The manual tarball (per-type folders of crops and corrected masks, some annotators' masks
    missing, one crop without a corrected mask) and the crosswalk readme."""
    rng = np.random.default_rng(310)
    src = root / "src" / "manual_segmentation_data"
    for pid, ct in ((1, "blca"), (2, "brca"), (3, "blca"), (4, "brca"), (5, "blca"), (6, "luad"), (7, "luad")):
        save_image(src / ct / f"{pid}_crop.png", raw(rng, IMAGE + (4,)))
        if pid == 7:
            continue
        mask = labels(rng, 5, IMAGE, "int32")
        save_image(src / ct / f"{pid}_labeled_mask_corrected.png", mask, mode="I")
        for k in range(3 if pid % 2 else 1):
            save_image(src / ct / f"{pid}_labeled_mask_common{k}.png", (mask > k).astype("int32"), mode="I")
    with tarfile.open(root / "manual_segmentation_data.tar.gz", "w:gz") as tf:
        tf.add(src, arcname="manual_segmentation_data")
    for p in sorted(src.parent.rglob("*"), reverse=True):
        p.unlink() if p.is_file() else p.rmdir()
    src.parent.rmdir()
    (root / "pcns_crosswalk.txt").write_text(CROSSWALK)


def build_segpath(root):
    """Two cell types' tarballs of H&E and mask PNGs; the epithelium's file list gives the splits,
    the smooth muscle has none."""
    rng = np.random.default_rng(311)
    for folder, csv in (("panCK_Epithelium", "panCK_fileinfo.csv"), ("aSMA_SmoothMuscle", None)):
        src = root / "src" / folder
        names = [f"case{c}_{i}" for c in "ABC" for i in range(2)]
        for name in names:
            save_image(src / f"{name}_HE.png", _rgb(rng))
            save_image(src / f"{name}_mask.png", (rng.random(IMAGE) > 0.5).astype("uint8"))
        with tarfile.open(root / f"{folder}.tar.gz", "w:gz") as tf:
            tf.add(src, arcname=folder)
        for p in sorted(src.rglob("*"), reverse=True):
            p.unlink()
        src.rmdir()
        if csv:
            splits = ("train", "train", "val", "test", "train", "val")
            (root / csv).write_text("filename,train_val_test\n" + "".join(
                f"{folder}/{n}_HE.png,{s}\n" for n, s in zip(names, splits)) + "extra_mask.png,train\n")
    (root / "src").rmdir()


def convert_segpath(module, root):
    for folder in ("panCK_Epithelium", "aSMA_SmoothMuscle"):
        module._extract_data(Path(root) / f"{folder}.tar.gz", Path(root) / folder)


def build_tnbc(root):
    """The zip: RGBA slides and binary masks per patient folder, and a ``__MACOSX`` folder."""
    rng = np.random.default_rng(312)
    src = root / "src"
    for slide in (1, 2, 3):
        for i in (1, 2):
            save_image(src / "TNBC_NucleiSegmentation" / f"Slide_{slide:02d}" / f"{slide:02d}_{i}.png",
                       raw(rng, IMAGE + (4,)))
            save_image(src / "TNBC_NucleiSegmentation" / f"GT_{slide:02d}" / f"{slide:02d}_{i}.png",
                       ((rng.random(IMAGE) > 0.7) * 255).astype("uint8"))
    (src / "__MACOSX").mkdir()
    (src / "__MACOSX" / "._x").write_bytes(b"\0")
    zip_folder(src, root / "TNBC_NucleiSegmentation.zip", src)


def build_puma(root):
    """The converted layout (the geojson conversion needs geopandas and rasterio)."""
    rng = np.random.default_rng(313)
    for split, names in (("train", ("training_set_metastatic_roi_001", "training_set_primary_roi_002")),
                         ("val", ("training_set_metastatic_roi_003",))):
        for name in names:
            datasets = {f"labels__{kind}__{ann}": labels(rng, 6, IMAGE, "int32" if kind == "instances" else "uint8")
                        for kind in ("instances", "semantic") for ann in ("nuclei", "tissue")}
            write_h5(root / split / "preprocessed" / f"{name}.h5", raw=raw(rng, (3,) + IMAGE), **datasets)


def _panglao(path):
    rows = ["species\tofficial gene symbol\tcell type\tubiquitousness index",
            "Hs\tKRT8\tHepatocytes\t0.1", "Mm Hs\tCD3E\tT cells\t0.0", "Mm\tCol1a1\tFibroblasts\t0.2"]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(gzip.compress(("\n".join(rows) + "\n").encode(), mtime=0))


def build_hest(root):
    """One converted slide, one slide's 224x224 patches that the reader converts (no CellViT,
    Xenium or ST inputs, so its labels are empty), the metadata table and the marker table's
    cache (so that nothing is downloaded)."""
    rng = np.random.default_rng(314)
    write_h5(root / "preprocessed" / "NCBI55.h5", raw=raw(rng, (3, 3, 224, 224)),
             **{key.replace("/", "__"): labels(rng, 5, (3, 224, 224), "int32")
                for key in ("labels/instances/h&e", "labels/instances/xenium", "labels/semantic/st")})
    write_h5(root / "patches" / "TENX24.h5", img=raw(rng, (2, 224, 224, 3)),
             coords=np.array([[0, 0], [224, 0]], dtype="int64"))
    (root / "HEST_v1_3_0.csv").write_text("id,organ,pixel_size_um_estimated\nTENX24,Breast,0.5\nNCBI55,Lung,\n")
    _panglao(root / "_db_cache" / "PanglaoDB_markers_27_Mar_2020.tsv.gz")


CASES = [
    HPCase("bcss", build_bcss,
           paths=[("get_bcsss_paths", {}), ("get_bcsss_paths", dict(split="train")),
                  ("get_bcsss_paths", dict(split="val", val_fraction=0.3)), ("get_bcsss_paths", dict(split="test"))],
           datasets=[("get_bcss_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_bcss_dataset", dict(patch_shape=PATCH_2D, split="test"))],
           loaders=[("get_bcss_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="val"))]),
    HPCase("conic", build_conic,
           paths=[("get_conic_paths", dict(split="train")), ("get_conic_paths", dict(split="test"))],
           datasets=[("get_conic_dataset", dict(patch_shape=(1, 32, 32), split="train")),
                     ("get_conic_dataset", dict(patch_shape=(1, 32, 32), split="test", label_choice="semantic"))],
           loaders=[("get_conic_loader", dict(patch_shape=(1, 32, 32), batch_size=2, split="train"))],
           converted=["data/train.h5", "data/test.h5"]),
    HPCase("consep", build_consep,
           paths=[("get_consep_paths", dict(split="train")), ("get_consep_paths", dict(split="test"))],
           datasets=[("get_consep_dataset", dict(patch_shape=(64, 64), split="train"))],
           loaders=[("get_consep_loader", dict(patch_shape=(64, 64), batch_size=1, split="test"))],
           converted=["data/consep/preprocessed/train/1.h5", "data/consep/preprocessed/test/2.h5"]),
    HPCase("cytodark0", build_cytodark0,
           paths=[("get_cytodark0_paths", dict(split="train")),
                  ("get_cytodark0_paths", dict(split="test", magnification="40x"))],
           datasets=[("get_cytodark0_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_cytodark0_dataset", dict(patch_shape=PATCH_2D, split="val", magnification="20x",
                                                    label_choice="semantic"))],
           loaders=[("get_cytodark0_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    HPCase("glas", build_glas, prepare=convert_glas,
           paths=[("get_glas_paths", dict(split="train")), ("get_glas_paths", dict(split="test"))],
           datasets=[("get_glas_dataset", dict(patch_shape=PATCH_2D, split="train"))],
           loaders=[("get_glas_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="test"))]),
    HPCase("glysac", build_glysac,
           paths=[("get_glysac_paths", dict(split="train")), ("get_glysac_paths", dict(split="test"))],
           datasets=[("get_glysac_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_glysac_dataset", dict(patch_shape=PATCH_2D, split="test", label_choice="semantic"))],
           loaders=[("get_glysac_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    HPCase("lizard", build_lizard, prepare=convert_lizard,
           paths=[("get_lizard_paths", dict(split="train")), ("get_lizard_paths", dict(split="val"))],
           datasets=[("get_lizard_dataset", dict(patch_shape=PATCH_2D, split="train"))],
           loaders=[("get_lizard_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="val"))]),
    HPCase("orion_crc", build_orion_crc,
           paths=[("get_orion_crc_paths", dict(split="train", preprocessing_workers=1)),
                  ("get_orion_crc_paths", dict(split="val", preprocessing_workers=1))],
           datasets=[("get_orion_crc_dataset", dict(patch_shape=PATCH_2D, split="train", preprocessing_workers=1)),
                     ("get_orion_crc_dataset", dict(patch_shape=PATCH_2D, split="val", modality="mif",
                                                    label_type="semantic", preprocessing_workers=1))],
           loaders=[("get_orion_crc_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train",
                                                  preprocessing_workers=1))]),
    HPCase("pannuke", build_pannuke,
           paths=[("get_pannuke_paths", dict(folds=("fold_1", "fold_2")))],
           datasets=[("get_pannuke_dataset", dict(patch_shape=(1, 32, 32), folds=("fold_1", "fold_2"))),
                     ("get_pannuke_dataset", dict(patch_shape=(1, 32, 32), folds=("fold_2",),
                                                  custom_label_choice="semantic"))],
           loaders=[("get_pannuke_loader", dict(patch_shape=(1, 32, 32), batch_size=2, folds=("fold_1",)))]),
    HPCase("pcns", build_pcns,
           paths=[("get_pcns_paths", dict(split="train")), ("get_pcns_paths", dict(split="test")),
                  ("get_pcns_paths", dict(split="train", cancer_type=["BLCA", "luad"]))],
           datasets=[("get_pcns_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_pcns_dataset", dict(patch_shape=PATCH_2D, split="train", cancer_type="brca"))],
           loaders=[("get_pcns_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    HPCase("segpath", build_segpath, prepare=convert_segpath,
           paths=[("get_segpath_paths", dict(cell_types="epithelium", split="train")),
                  ("get_segpath_paths", dict(cell_types=["epithelium", "smooth_muscle"]))],
           datasets=[("get_segpath_dataset", dict(patch_shape=PATCH_2D, cell_types="epithelium", split="val")),
                     ("get_segpath_dataset", dict(patch_shape=PATCH_2D, cell_types="smooth_muscle"))],
           loaders=[("get_segpath_loader", dict(patch_shape=PATCH_2D, batch_size=2, cell_types="epithelium",
                                                split="train"))]),
    HPCase("tnbc", build_tnbc,
           paths=[("get_tnbc_paths", dict(split="train")), ("get_tnbc_paths", dict(split="val")),
                  ("get_tnbc_paths", dict(split="test"))],
           datasets=[("get_tnbc_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_tnbc_dataset", dict(patch_shape=PATCH_2D, split="test", label_choice="semantic"))],
           loaders=[("get_tnbc_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    HPCase("puma", build_puma,
           paths=[("get_puma_paths", dict(split="train")), ("get_puma_paths", dict(split="val", annotations="tissue"))],
           datasets=[("get_puma_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_puma_dataset", dict(patch_shape=PATCH_2D, split="val", annotations="tissue",
                                               label_choice="semantic")),
                     ("get_puma_dataset", dict(patch_shape=PATCH_2D, split="train", resize_inputs=True))],
           loaders=[("get_puma_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    HPCase("hest", build_hest,
           paths=[("get_hest_paths", {}), ("get_hest_paths", dict(organs=["Breast"]))],
           datasets=[("get_hest_dataset", dict(patch_shape=PATCH_2D)),
                     ("get_hest_dataset", dict(patch_shape=PATCH_2D, label_choice="semantic", n_samples=4, seed=3))],
           loaders=[("get_hest_loader", dict(patch_shape=PATCH_2D, batch_size=2, label_choice="xenium_instances"))],
           converted=["preprocessed/TENX24.h5"]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


@pytest.mark.parametrize("sizes", [(0.8, 0.2), (0.7, 0.3), (0.5, 0.25)])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_stratified_split_matches_sklearn(sizes, seed):
    """The numpy copy of ``StratifiedShuffleSplit``'s first split gives sklearn's indices, in order,
    on classes of unequal sizes (so that the allocation breaks ties with the generator)."""
    from sklearn.model_selection import StratifiedShuffleSplit

    from torch_em_tpu_torch.data.datasets.util import _stratified_shuffle_split

    rng = np.random.default_rng(seed)
    y = rng.permutation(np.repeat(np.arange(4), rng.integers(2, 9, 4)))
    train_size, test_size = sizes
    for random_state in (5, seed):
        splitter = StratifiedShuffleSplit(n_splits=10, train_size=train_size, test_size=test_size,
                                          random_state=random_state)
        expected = next(splitter.split(np.zeros(len(y)), y))
        got = _stratified_shuffle_split(y, train_size=train_size, test_size=test_size, random_state=random_state)
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g, e)


def test_stratified_split_refuses_a_class_of_one():
    from sklearn.model_selection import StratifiedShuffleSplit

    from torch_em_tpu_torch.data.datasets.util import _stratified_shuffle_split

    y = np.array([0, 0, 0, 1, 1, 2])
    with pytest.raises(ValueError):
        next(StratifiedShuffleSplit(train_size=0.5, test_size=0.5, random_state=0).split(y, y))
    with pytest.raises(ValueError, match="one member"):
        _stratified_shuffle_split(y, train_size=0.5, test_size=0.5, random_state=0)


def test_pcns_crosswalk_with_a_prose_footer(tmp_path):
    """A crosswalk readme whose table is followed by prose with commas: the JAX package's reader
    raises on the first such line, the port's skips it and reads the table (as it does a gzipped
    readme without the suffix)."""
    jax_mod, port_mod = modules("pcns", HISTOPATHOLOGY)
    text = CROSSWALK + "\nNotes: the ids, as listed above, follow the TCIA release, version 1.\n"
    (tmp_path / "pcns_crosswalk.txt").write_text(text)
    with pytest.raises(ValueError):
        jax_mod._load_crosswalk(str(tmp_path))
    expected = {1: "blca", 2: "brca", 3: "blca", 4: "brca", 5: "blca", 6: "luad"}
    assert port_mod._load_crosswalk(str(tmp_path)) == expected
    (tmp_path / "pcns_crosswalk.txt").write_bytes(gzip.compress(text.encode()))
    assert port_mod._load_crosswalk(str(tmp_path)) == expected
    (tmp_path / "pcns_crosswalk.txt").write_text(CROSSWALK)
    assert port_mod._load_crosswalk(str(tmp_path)) == jax_mod._load_crosswalk(str(tmp_path)) == expected


def _same_error(call, *args, **kwargs):
    """``call`` raises in both packages with the same exception type and message; returns it."""
    errors = []
    for mod in call:
        with pytest.raises(Exception) as info:
            mod(*args, **kwargs)
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1]) and str(errors[0]) == str(errors[1]), errors
    return errors[0]


def test_missing_packages_raise_as_in_jax(tmp_path, monkeypatch):
    """Where a conversion needs a package that neither machine has, the JAX package raises: for scanpy and
    tiffslide the port raises the same exception; for geopandas, rasterio and shapely (PUMA's and HEST's nuclei)
    the port converts with its own ``utils/geometry.py`` (``tests/test_torch_zoo_conversions.py`` holds what it
    converts against a brute force)."""
    import pandas as pd

    from torch_em_tpu_torch.utils import geometry

    jax_puma, port_puma = modules("puma", HISTOPATHOLOGY)
    jax_hest, port_hest = modules("hest", HISTOPATHOLOGY)
    jax_monusac, port_monusac = modules("monusac", HISTOPATHOLOGY)
    for name in ("geopandas", "rasterio", "shapely", "scanpy", "tiffslide"):
        assert importlib.util.find_spec(name) is None, f"{name} is installed: this test needs it missing"
    for side in ("jax", "port"):
        layouts.puma_layout(str(tmp_path / side / "puma"), 2, 30)
        build_puma(tmp_path / side / "converted")
    with pytest.raises(RuntimeError, match="geopandas"):
        jax_puma.get_puma_paths(str(tmp_path / "jax" / "puma"), "train")
    assert len(port_puma.get_puma_paths(str(tmp_path / "port" / "puma"), "train")) == 2
    with pytest.raises(RuntimeError, match="geopandas"):
        jax_puma._preprocess_inputs(str(tmp_path / "jax" / "converted"), "nuclei", "train")
    port_puma._preprocess_inputs(str(tmp_path / "port" / "converted"), "nuclei", "train")  # no annotations there
    parts = [[[[0, 0], [4, 0], [4, 4], [0, 0]]], [[[9, 9], [12, 9], [9, 12], [9, 9]]]]
    (tmp_path / "cells.geojson").write_text(json.dumps([{"type": "Feature", "geometry": {
        "type": "MultiPolygon", "coordinates": parts}}]))
    pd.DataFrame({"geometry": [bytes([1]) + struct.pack("<III", 3, 1, 4)
                               + np.array([[1, 1], [5, 1], [1, 5], [1, 1]], "<f8").tobytes()]}).to_parquet(
        tmp_path / "cells.parquet")
    for name, path in (("_gdf_from_cellvit_geojson", "cells.geojson"), ("_gdf_from_xenium_parquet", "cells.parquet")):
        with pytest.raises(ImportError, match="geopandas and shapely"):
            getattr(jax_hest, name)(str(tmp_path / path))
    cells = port_hest._gdf_from_cellvit_geojson(str(tmp_path / "cells.geojson"))
    assert len(cells) == 2 and all(isinstance(g, geometry.Polygon) for g in cells.geometry)
    xenium = port_hest._gdf_from_xenium_parquet(str(tmp_path / "cells.parquet"))
    assert len(xenium) == 1 and xenium["cell_id"] == ["0"]
    assert isinstance(_same_error((jax_hest._compute_cell_type_map, port_hest._compute_cell_type_map),
                                  "st.h5ad", None), ImportError)
    with pytest.raises(ImportError, match="rasterio and shapely"):
        jax_hest._rasterize_patch_instances(0, 0, 224, None)
    instances = port_hest._rasterize_patch_instances(0, 0, 224, cells)
    assert instances.dtype == np.int32 and sorted(np.unique(instances)) == [0, 1, 2]
    with pytest.raises(ImportError, match="rasterio"):
        jax_hest._burn([], [], 224)
    assert not port_hest._burn([], [], 224).any()
    # MoNuSAC's test scans that ship only as svs go through tiffslide
    for root, mod in ((tmp_path / "jax", jax_monusac), (tmp_path / "port", port_monusac)):
        src = root / "src" / "MoNuSAC Testing Data and Annotations" / "TCGA-49-6743-01Z-00-DX2"
        src.mkdir(parents=True)
        (src / "TCGA-49-6743-01Z-00-DX2_1.svs").write_bytes(b"II*\0")
        (src / "TCGA-49-6743-01Z-00-DX2_1.xml").write_text("<Annotations/>")
        zip_folder(root / "src" / "MoNuSAC Testing Data and Annotations", root / "monusac_test.zip", root / "src")
    errors = []
    for root, mod in ((tmp_path / "jax", jax_monusac), (tmp_path / "port", port_monusac)):
        with pytest.raises(RuntimeError, match="tiffslide") as info:
            mod._process_monusac(str(root), "test")
        errors.append(str(info.value))
    assert errors[0] == errors[1]


class _FakeGeoms:
    """A stand-in for a GeoSeries that records the translations and scalings it is given."""

    def __init__(self, ops=()):
        self.ops = list(ops)

    def translate(self, xoff, yoff):
        return _FakeGeoms(self.ops + [("translate", xoff, yoff)])

    def scale(self, xfact, yfact, origin):
        return _FakeGeoms(self.ops + [("scale", xfact, yfact, origin)])


class _FakeFrame:
    """A stand-in for a GeoDataFrame: ``.cx[x0:x1, y0:y1]`` keeps the rows whose point lies in the window."""

    def __init__(self, points):
        self.points = np.asarray(points, dtype=float)
        self.geometry = _FakeGeoms()

    def __len__(self):
        return len(self.points)

    @property
    def cx(self):
        frame = self

        class _Indexer:
            def __getitem__(self, key):
                xs, ys = key
                keep = ((frame.points[:, 0] >= xs.start) & (frame.points[:, 0] <= xs.stop)
                        & (frame.points[:, 1] >= ys.start) & (frame.points[:, 1] <= ys.stop))
                return _FakeFrame(frame.points[keep])
        return _Indexer()


def test_hest_and_puma_helpers_match_jax():
    """The pure helpers: HEST's cell-type keyword mapping; its patch windows, on the JAX side over a stand-in for
    the GeoDataFrame that keeps the points in the closed window and records the translation and scaling, on the
    port's side over its ``GeoFrame`` of one degenerate polygon a point (its ``.cx`` keeps a point in the closed
    window too): the same rows, moved and scaled by the same numbers; PUMA's sample split."""
    from torch_em_tpu_torch.utils import geometry

    jax_hest, port_hest = modules("hest", HISTOPATHOLOGY)
    names = ["Alveolar macrophages", "Hepatocytes", "Fibroblasts", "Unicorn cells", "Beta cells", "T cells",
             "Smooth muscle cells", "Pericytes", "Plasma cells", "Ductal cells", "Neurons", ""]
    assert [port_hest._cell_type_to_category(n) for n in names] == [jax_hest._cell_type_to_category(n) for n in names]
    points = np.random.default_rng(0).uniform(0, 1000, (200, 2))
    points[:3] = [(100, 200), (324, 424), (500, 224)]  # on the windows' borders
    frame = _FakeFrame(points)
    cells = geometry.GeoFrame([geometry.Polygon(np.repeat(p[None], 4, axis=0)) for p in points])
    for args in ((100, 200, 224, 1.0), (500, 0, 224, 2.0), (990, 990, 224, 0.5), (5000, 5000, 224, 1.0)):
        got, expected = port_hest._window_geometries(cells, *args), jax_hest._window_geometries(frame, *args)
        assert (got is None) == (expected is None)
        if got is None:
            continue
        span = round(args[2] * args[3])
        inside = points[(points[:, 0] >= args[0]) & (points[:, 0] <= args[0] + span)
                        & (points[:, 1] >= args[1]) & (points[:, 1] <= args[1] + span)]
        moved = inside.copy()
        for op in expected.ops:
            moved = moved + op[1:3] if op[0] == "translate" else moved * op[1:3]
        assert len(got) == len(inside)
        np.testing.assert_array_equal(np.array([g.exterior[0] for g in got.geometry]), moved)
    jax_puma, port_puma = modules("puma", HISTOPATHOLOGY)
    ids = [f"training_set_metastatic_roi_{i:03d}" for i in range(23)]
    assert port_puma._split_sample_ids(ids, np.random.RandomState(3)) == \
        jax_puma._split_sample_ids(ids, np.random.RandomState(3))


def test_converted_hest_slide_without_optional_inputs(tmp_path):
    """A HEST slide without CellViT, Xenium or ST inputs converts to its patches with empty labels."""
    build_hest(tmp_path)
    port_hest = modules("hest", HISTOPATHOLOGY)[1]
    port_hest.get_hest_paths(str(tmp_path))
    with h5py.File(tmp_path / "preprocessed" / "TENX24.h5", "r") as f:
        assert f["raw"].shape == (2, 3, 224, 224)
        assert all(not f[key][()].any() for key in port_hest.LABEL_KEYS.values())
    assert json.loads(json.dumps(port_hest.LABEL_KEYS)) == modules("hest", HISTOPATHOLOGY)[0].LABEL_KEYS
