"""The port's dataset zoo, electron microscopy (the recipes' readers), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): the same paths, ``len`` and samples
under the same ``np.random.seed``, loader batches of the same shapes, and equal converted files
where the reader converts its sources (Lucchi's and Kasthuri's PNG stacks, MitoEM's slices,
VNC's stacks, NucMM's split files, CEM-MitoLab's ``non_empty_images.json``). This file also
holds the module lists against each other: the port's EM modules are the JAX package's, with
its public names and signatures, and each has a case in one of the ``test_torch_datasets_em_*``
files.
"""

import importlib
import os
from pathlib import Path

import numpy as np
import pytest

import torch_em_tpu.data.datasets.electron_microscopy as jax_em
import torch_em_tpu_torch.data.datasets.electron_microscopy as port_em
from torch_em_tpu.utils.io import write_data as jax_write_data
from torch_zoo_layouts import (IMAGE, PATCH_2D, PATCH_3D, Case, check_case, check_domain_matches_jax,
                               check_every_module_has_a_case, domain_modules, labels, modules, public_names, raw,
                               save_image, save_stack, write_h5, zip_folder)


def build_cremi(root):
    rng = np.random.default_rng(2)
    for sample in "AB":
        write_h5(root / f"sample_{sample}.h5", volumes__raw=raw(rng),
                 volumes__labels__neuron_ids=labels(rng, low=1))


def build_snemi(root):
    rng = np.random.default_rng(3)
    write_h5(root / "snemi_train.h5", volumes__raw=raw(rng), volumes__labels__neuron_ids=labels(rng, low=1))


def build_isbi(root):
    rng = np.random.default_rng(8)
    write_h5(root / "isbi.h5", raw=raw(rng), labels__gt_segmentation=labels(rng, low=1, dtype="uint32"),
             labels__membranes=(rng.random((8, 64, 64)) > 0.7).astype("uint8"))


def _png_stack(folder, volume, pattern):
    for z, plane in enumerate(volume):
        save_image(folder / (pattern % z), plane)


def build_lucchi(root):
    """The Lucchi++ archive: PNG planes of raw (``mask%04i.png``) and labels (``%i.png``); the
    test labels grayscale 0/255, the training labels RGBA."""
    rng = np.random.default_rng(4)
    src = root / "src" / "Lucchi++"
    for split in ("Train", "Test"):
        _png_stack(src / f"{split}_In", raw(rng), "mask%04i.png")
        fg = rng.random((8, 64, 64)) > 0.7
        if split == "Train":
            rgba = np.zeros((8, 64, 64, 4), dtype="uint8")
            rgba[fg] = 255
            rgba[..., 3] = 255
            _png_stack(src / f"{split}_Out", rgba, "%i.png")
        else:
            _png_stack(src / f"{split}_Out", (fg * 255).astype("uint8"), "%i.png")
    zip_folder(root / "src", root / "lucchi.zip", root / "src")


def build_kasthuri(root):
    """The Kasthuri++ archive: raw PNG planes and RGB labels (white mitochondria, 2-2-2 empty)."""
    rng = np.random.default_rng(6)
    src = root / "src" / "Kasthuri++"
    for split in ("Train", "Test"):
        _png_stack(src / f"{split}_In", raw(rng), "im%03i.png")
        classes = rng.integers(0, 3, (8, 64, 64))
        rgb = np.zeros((8, 64, 64, 3), dtype="uint8")
        rgb[classes == 1] = 255
        rgb[classes == 2] = 2
        _png_stack(src / f"{split}_Out", rgb, "im%03i.png")
    zip_folder(root / "src", root / "kasthuri.zip", root / "src")


def build_mitoem(root):
    rng = np.random.default_rng(11)
    for sample in ("rat", "human"):
        write_h5(root / f"{sample}_train.h5", raw=raw(rng), labels=labels(rng, 4, dtype="uint32"))


def build_mitoem_sources(root):
    """MitoEM's slice archives: fewer slices than the labels' train range, so the converted
    volume holds the raw alone."""
    rng = np.random.default_rng(12)
    _png_stack(root / "src" / "im", raw(rng), "im%04i.png")
    zip_folder(root / "src", root / "rat_raw.zip", root / "src")
    _png_stack(root / "src" / "mito-train-val-v2", labels(rng, 4, dtype="uint16"), "seg%04i.png")
    zip_folder(root / "src", root / "rat_labels.zip", root / "src")


def build_vnc(root):
    """The VNC archive: raw TIFF planes and binary mitochondria and synapse PNGs (the reader
    labels their connected components)."""
    rng = np.random.default_rng(7)
    src = root / "src" / "groundtruth-drosophila-vnc-master"
    for stack in ("stack1", "stack2"):
        _png_stack(src / stack / "raw", raw(rng), "%02i.tif")
    for target in ("mitochondria", "synapses"):
        _png_stack(src / "stack1" / target, ((rng.random((8, 64, 64)) > 0.8) * 255).astype("uint8"), "%02i.png")
    zip_folder(root / "src", root / "vnc.zip", root / "src")


def build_platynereis(root):
    """Membrane (cells) volumes as N5 with the ``s1`` scale, cilia as HDF5; the readers need the
    full file count on disk."""
    rng = np.random.default_rng(9)
    for i in range(1, 10):
        path = str(root / "membrane" / f"train_data_membrane_{i:02d}.n5")
        jax_write_data(path, "volumes/raw/s1", raw(rng))
        jax_write_data(path, "volumes/labels/segmentation/s1", labels(rng, low=1), chunks=(4, 32, 32))
    for i in range(1, 4):
        write_h5(root / "cilia" / f"train_data_cilia_{i:02d}.h5", volumes__raw=raw(rng),
                 volumes__labels__segmentation=labels(rng, 3))


def build_uro_cell(root):
    rng = np.random.default_rng(11)
    for name, with_lyso in (("fib1", True), ("fib2", True), ("fib3", False)):
        extra = {"labels__lyso": labels(rng, 3, dtype="uint32")} if with_lyso else {}
        write_h5(root / f"{name}.h5", raw=raw(rng), **extra)


def build_nuc_mm(root):
    """NucMM's download folder: image and label files per split, each with a ``main`` dataset."""
    rng = np.random.default_rng(21)
    src = root / "Mouse (NucMM-M)"
    for split in ("train", "val"):
        for i in range(2):
            write_h5(src / "Image" / split / f"img_{i}.h5", main=raw(rng))
            write_h5(src / "Label" / split / f"img_{i}.h5", main=labels(rng, 4))


def build_axonem(root):
    rng = np.random.default_rng(44)
    for sample in ("human", "mouse"):
        write_h5(root / sample / "im_0.h5", main=raw(rng))
        write_h5(root / sample / "seg_0.h5", main=labels(rng, low=1))


def build_sponge_em(root):
    rng = np.random.default_rng(22)
    for i in (1, 2, 3):
        write_h5(root / f"train_data_0{i}.h5", volumes__raw=raw(rng), volumes__labels__instances=labels(rng, 4),
                 volumes__labels__semantic=labels(rng, 3))


def build_mitolab(root):
    """CEM-MitoLab's 2-D patches in two datasets; one patch has no mitochondria."""
    rng = np.random.default_rng(49)
    for ds in ("dataset_a", "dataset_b"):
        for i in range(4):
            base = root / "11037" / "cem_mitolab" / ds
            save_image(base / "images" / f"p{i}.tiff", raw(rng, IMAGE))
            empty = (ds, i) == ("dataset_a", 0)
            save_image(base / "masks" / f"p{i}.tiff",
                       np.zeros(IMAGE, "uint8") if empty else labels(rng, 3, IMAGE, "uint8"))


def build_benchmark(root):
    """MitoLab benchmark 1 (a volume as two multi-page TIFFs) and 7 (2-D images and masks)."""
    rng = np.random.default_rng(50)
    ds_dir = root / "10982" / "data" / "mito_benchmarks" / "c_elegans"
    save_stack(ds_dir / "c_elegans_em.tif", raw(rng))
    save_stack(ds_dir / "c_elegans_mito.tif", labels(rng, 3, dtype="uint8"))
    tem = root / "10982" / "data" / "tem_benchmark"
    for i in range(3):
        save_image(tem / "images" / f"t{i}.tiff", raw(rng, IMAGE))
        save_image(tem / "masks" / f"t{i}.tiff", labels(rng, 3, IMAGE, "uint8"))


BOUNDARIES = dict(patch_shape=PATCH_3D, boundaries=True)
AFFINITIES = dict(patch_shape=PATCH_3D, offsets=[[-1, 0, 0], [0, -1, 0], [0, 0, -3]])
CREMI = dict(samples=("A", "B"), defect_augmentation_kwargs=None)

CASES = [
    Case("cremi", build_cremi, paths=[("get_cremi_paths", dict(samples=("A", "B")))],
         datasets=[("get_cremi_dataset", dict(BOUNDARIES, **CREMI)),
                   ("get_cremi_dataset", dict(AFFINITIES, rois={"A": np.s_[0:6, :, :]}, **CREMI))],
         loaders=[("get_cremi_loader", dict(patch_shape=PATCH_3D, batch_size=1, samples=("A", "B"),
                                            boundaries=True))]),
    Case("snemi", build_snemi, paths=[("get_snemi_paths", dict(sample="train"))],
         datasets=[("get_snemi_dataset", AFFINITIES), ("get_snemi_dataset", BOUNDARIES)],
         loaders=[("get_snemi_loader", dict(patch_shape=PATCH_3D, batch_size=2, offsets=[[-1, 0, 0]]))]),
    Case("isbi2012", build_isbi, paths=[("get_isbi_paths", {})],
         datasets=[("get_isbi_dataset", BOUNDARIES),
                   ("get_isbi_dataset", dict(patch_shape=PATCH_3D, use_original_labels=True))],
         loaders=[("get_isbi_loader", dict(patch_shape=PATCH_3D, batch_size=1, boundaries=True))]),
    Case("lucchi", build_lucchi, paths=[("get_lucchi_paths", dict(split="train"))],
         datasets=[("get_lucchi_dataset", dict(split="train", patch_shape=PATCH_3D)),
                   ("get_lucchi_dataset", dict(split="test", patch_shape=PATCH_3D))],
         loaders=[("get_lucchi_loader", dict(split="test", patch_shape=PATCH_3D, batch_size=1))],
         converted=["lucchi_train.h5", "lucchi_test.h5"]),
    Case("kasthuri", build_kasthuri, paths=[("get_kasthuri_paths", dict(split="test"))],
         datasets=[("get_kasthuri_dataset", dict(split="train", patch_shape=PATCH_3D)),
                   ("get_kasthuri_dataset", dict(split="test", patch_shape=PATCH_3D, label_dtype="int64"))],
         loaders=[("get_kasthuri_loader", dict(split="train", patch_shape=PATCH_3D, batch_size=1))],
         converted=["kasthuri_train.h5", "kasthuri_test.h5"]),
    Case("mitoem", build_mitoem,
         paths=[("get_mitoem_paths", dict(splits="train", samples=("rat", "human")))],
         datasets=[("get_mitoem_dataset", dict(splits="train", samples=("rat", "human"), **BOUNDARIES)),
                   ("get_mitoem_dataset", dict(splits=["train"], samples="rat", patch_shape=PATCH_3D, binary=True))],
         loaders=[("get_mitoem_loader", dict(splits="train", samples=("rat",), patch_shape=PATCH_3D, batch_size=1,
                                             offsets=[[-1, 0, 0], [0, -2, 0]]))]),
    Case("mitoem", build_mitoem_sources, name="mitoem_sources",
         paths=[("get_mitoem_paths", dict(splits="train", samples="rat"))], datasets=[],
         converted=["rat_train.h5"]),
    Case("vnc", build_vnc, paths=[("get_vnc_mito_paths", {})],
         datasets=[("get_vnc_mito_dataset", BOUNDARIES), ("get_vnc_mito_dataset", dict(patch_shape=PATCH_3D,
                                                                                        binary=True))],
         loaders=[("get_vnc_mito_loader", dict(patch_shape=PATCH_3D, batch_size=1, offsets=[[-1, 0, 0]]))],
         converted=["vnc_train.h5", "vnc_test.h5"]),
    Case("platynereis", build_platynereis,
         paths=[("get_platynereis_paths", dict(sample_ids=None, name="cells")),
                ("get_platynereis_paths", dict(sample_ids=[2, 3], name="cilia"))],
         datasets=[("get_platynereis_dataset", dict(name="cells", sample_ids=[1, 2], **BOUNDARIES)),
                   ("get_platynereis_cell_dataset", dict(patch_shape=PATCH_3D, sample_ids=[3])),
                   ("get_platynereis_cilia_dataset", dict(patch_shape=PATCH_3D, sample_ids=[1, 3]))],
         loaders=[("get_platynereis_cell_loader", dict(patch_shape=PATCH_3D, batch_size=1, sample_ids=[4],
                                                       boundaries=True)),
                  ("get_platynereis_cilia_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    Case("uro_cell", build_uro_cell, paths=[("get_uro_cell_paths", dict(target="lyso"))],
         datasets=[("get_uro_cell_dataset", dict(target="lyso", **BOUNDARIES)),
                   ("get_uro_cell_dataset", dict(target="lyso", patch_shape=PATCH_3D, binary=True))],
         loaders=[("get_uro_cell_loader", dict(target="lyso", patch_shape=PATCH_3D, batch_size=1))]),
    Case("nuc_mm", build_nuc_mm, paths=[("get_nuc_mm_paths", dict(sample="mouse", split="val"))],
         datasets=[("get_nuc_mm_dataset", dict(sample="mouse", split="train", patch_shape=PATCH_3D))],
         loaders=[("get_nuc_mm_loader", dict(sample="mouse", split="val", patch_shape=PATCH_3D, batch_size=2))],
         converted=["mouse/train/img_0.h5", "mouse/train/img_1.h5", "mouse/val/img_0.h5"]),
    Case("axonem", build_axonem, paths=[("get_axonem_paths", dict(samples=("human", "mouse")))],
         datasets=[("get_axonem_dataset", dict(patch_shape=PATCH_3D)),
                   ("get_axonem_dataset", dict(patch_shape=PATCH_3D, samples="mouse"))],
         loaders=[("get_axonem_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    Case("sponge_em", build_sponge_em, paths=[("get_sponge_em_paths", dict(sample_ids=None))],
         datasets=[("get_sponge_em_dataset", dict(mode="instances", patch_shape=PATCH_3D, sample_ids=(1, 2))),
                   ("get_sponge_em_dataset", dict(mode="semantic", patch_shape=PATCH_3D))],
         loaders=[("get_sponge_em_loader", dict(mode="instances", patch_shape=PATCH_3D, batch_size=1))]),
    Case("cem", build_mitolab, name="cem_mitolab",
         paths=[("get_mitolab_paths", dict(split="train", val_fraction=0.2)),
                ("get_mitolab_paths", dict(split="val", val_fraction=0.2)),
                ("get_mitolab_paths", dict(split=None))],
         datasets=[("get_mitolab_dataset", dict(split="train", patch_shape=PATCH_2D, val_fraction=0.2)),
                   ("get_mitolab_dataset", dict(split="val", patch_shape=PATCH_2D, val_fraction=0.3))],
         loaders=[("get_mitolab_loader", dict(split="train", batch_size=2, patch_shape=PATCH_2D,
                                              val_fraction=0.2))],
         converted=["11037/cem_mitolab/non_empty_images.json"]),
    Case("cem", build_benchmark, name="cem_benchmark",
         paths=[("get_benchmark_paths", dict(dataset_id=1)), ("get_benchmark_paths", dict(dataset_id=7))],
         datasets=[("get_benchmark_dataset", dict(dataset_id=1, patch_shape=PATCH_3D)),
                   ("get_benchmark_dataset", dict(dataset_id=7, patch_shape=PATCH_2D))],
         loaders=[("get_benchmark_loader", dict(dataset_id=1, patch_shape=PATCH_3D, batch_size=1))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_em_modules_and_public_names_match_jax():
    check_domain_matches_jax(jax_em, port_em, "electron_microscopy", 41)


def test_every_em_module_has_a_parity_case():
    """Each port EM module has a case in one of the ``test_torch_datasets_em_*`` files."""
    check_every_module_has_a_case(port_em, Path(__file__).parent.glob("test_torch_datasets_em_*.py"), "Case")


def test_mitolab_reads_all_images_after_the_cache(tmp_path):
    """Once ``non_empty_images.json`` sits beside the datasets, ``discard_empty_images=False``
    still lists every patch in the port; the JAX package takes the JSON file for a dataset
    folder and fails its assertion."""
    jax_cem, port_cem = modules("cem")
    build_mitolab(tmp_path)
    port_cem.get_mitolab_paths(str(tmp_path), split=None)  # writes the cache
    raws, labels_ = port_cem.get_mitolab_paths(str(tmp_path), split=None, discard_empty_images=False)
    assert len(raws) == len(labels_) == 8
    with pytest.raises(AssertionError):
        jax_cem.get_mitolab_paths(str(tmp_path), split=None, discard_empty_images=False)


def test_zoo_exports_match():
    """The port's ``data.datasets`` exports the EM getters and ``util`` the JAX package's names."""
    port_zoo = importlib.import_module("torch_em_tpu_torch.data.datasets")
    jax_util = importlib.import_module("torch_em_tpu.data.datasets.util")
    for name in domain_modules(jax_em):
        for getter in (n for n in dir(modules(name)[0]) if n.startswith("get_") and n in dir(jax_em)):
            assert getattr(port_zoo, getter) is getattr(modules(name)[1], getter)
    assert public_names(port_zoo.util) == public_names(jax_util)
    assert os.path.basename(port_zoo.util.__file__) == "util.py"
