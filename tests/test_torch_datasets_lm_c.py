"""The port's dataset zoo, light microscopy (EVICAN to OrgLine), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): paths, ``len``, samples under one
``np.random.seed``, loader batch shapes, and every file under both folders equal afterwards, the
reader's conversions included (EVICAN's and GliomaC6's label TIFFs from COCO, LSM mouse embryo's
masks, MEDUSSA's, MUCIC's and OrgLine's HDF5 files, MorphoSeg's rasterised ROIs, Neurosphere's
filled shells, OrgaExtractor's components). Conversions that only a download reaches run through
the reader's own function on both sides (``prepare``). IDR0095 needs nd2, LICONN cloud-volume,
E11bio s3fs and zarr, and OrgLine's stomach and breast pycocotools, none of which this machine
has: their cases read what those packages would have cached, and the last test holds the error
each reader raises without its package against the JAX package's.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from torch_zoo_layouts import (IMAGE, LIGHT_MICROSCOPY, PATCH_2D, PATCH_3D, VOLUME, LMCase, check_case, labels,
                               modules, raw, save_image, save_stack, save_tif, write_h5)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_conversion_layouts as layouts  # noqa: E402


def _coco(images, annotations, categories=None):
    return json.dumps({"images": images, "annotations": annotations, "categories": categories or []})


def _square(x, y, w, h):
    return [x, y, x + w, y, x + w, y + h, x, y + h]


def build_evican(root):
    """COCO annotations of cells and nuclei (categories 1 and 2)."""
    rng = np.random.default_rng(107)
    for split in ("train", "val"):
        images, annotations = [], []
        for i in range(2):
            fname = f"{split}{i}.jpg"
            save_image(root / "images" / split / fname, raw(rng, IMAGE))
            images.append({"id": i, "file_name": fname, "height": 64, "width": 64})
            for j, (category, size) in enumerate(((1, 20), (2, 8), (1, 14))):
                x, y = [int(v) for v in rng.integers(0, 64 - size, 2)]
                annotations.append({"id": 10 * i + j, "image_id": i, "category_id": category, "iscrowd": 0,
                                    "area": size * size, "segmentation": [_square(x, y, size, size)]})
        categories = [{"id": 1, "name": "Cell"}, {"id": 2, "name": "Nucleus"}]
        (root / "annotations").mkdir(exist_ok=True)
        (root / "annotations" / f"instances_{split}_evican2.json").write_text(_coco(images, annotations, categories))


def build_glioma_c6(root):
    rng = np.random.default_rng(108)
    for split in ("train", "valid", "test", "gen"):
        base = root / "GliomaC6" / "dataset" / ("gen" if split == "gen" else f"spec/{split}")
        for i in range(2):
            save_image(base / "images" / f"im{i}.tif", raw(rng, IMAGE))
            save_image(base / "masks" / f"anno_{split}" / f"im{i}_mask.tif", labels(rng, 4, IMAGE, "int32"), mode="I")
    cells = [{"image_id": 0, "category_id": 1, "segmentation": [_square(4, 4, 16, 16)]},
             {"image_id": 0, "category_id": 2, "segmentation": [_square(8, 8, 4, 4)]},
             {"image_id": 0, "category_id": 1, "segmentation": [_square(22, 20, 8, 9)]}]
    categories = [{"id": 1, "name": "cell"}, {"id": 2, "name": "nucleus", "supercategory": "cell_part"}]
    (root / "ann.json").write_text(_coco([{"id": 0, "file_name": "x.tif", "height": 32, "width": 32}], cells,
                                         categories))


def coco_masks_glioma(module, root):
    module._coco_to_instance_masks(str(root), str(root / "ann.json"), str(root / "coco_masks"))


def build_idr0095(root):
    """Phase TIFFs already extracted beside the masks, so no ND2 file needs reading."""
    rng = np.random.default_rng(109)
    for cond in ("cond1", "cond2"):
        cond_dir = root / "idr0095" / "Experiment_A_Figure3" / "glucose" / cond
        for i in range(2):
            save_image(cond_dir / f"f{i}-Phase.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
            save_image(cond_dir / f"f{i}-Mask.tif", labels(rng, 4, IMAGE, "uint16"))


def build_liconn(root):
    """The cache the cloud-volume stream writes."""
    rng = np.random.default_rng(111)
    write_h5(root / "liconn.h5", raw=raw(rng), seg_proofread=labels(rng, 6))


def build_lpc_nucseg(root):
    rng = np.random.default_rng(112)
    repo = root / "Coelho2009_ISBI_NuclearSegmentation-master" / "data"
    for source in ("gnf", "ic100"):
        for i in range(2):
            save_image(repo / "images" / "dna-images" / source / f"im{i}.png", raw(rng, IMAGE))
            save_image(repo / "preprocessed-data" / source / f"im{i}.png", labels(rng, 4, IMAGE, "uint8"))


def build_lsm_mouse_embryo(root):
    """RGBA masks that the reader turns into single-channel TIFFs."""
    rng = np.random.default_rng(113)
    for split_dir in ("Training", "Test"):
        base = root / "LSM_Segmentation_Dataset" / "DAPI-Tissue" / split_dir
        for i in range(2):
            save_image(base / "Original" / f"im{i}.png", raw(rng, IMAGE))
            mask = np.zeros(IMAGE + (4,), dtype="uint8")
            y, x = rng.integers(0, 40, 2)
            mask[y:y + 20, x:x + 20] = (255, 255, 255, 255)
            save_image(base / "Mask" / f"im{i}.png", mask)


def build_medussa(root):
    """The split's file lists and 5-slice image stacks with 2-D masks."""
    from torch_em_tpu.data.datasets.light_microscopy.medussa import SPLIT_FILE_LISTS

    rng = np.random.default_rng(114)
    for split in ("train", "test"):
        img_rels = [f"Files/images/{split}{i}.tif" for i in range(2)]
        mask_rels = [f"Files/masks/{split}{i}_mask.tif" for i in range(2)]
        (root / "file_lists").mkdir(exist_ok=True)
        (root / "file_lists" / SPLIT_FILE_LISTS[split]["images"]).write_text(json.dumps([{"path": p}
                                                                                         for p in img_rels]))
        (root / "file_lists" / SPLIT_FILE_LISTS[split]["masks"]).write_text(json.dumps([{"path": p}
                                                                                        for p in mask_rels]))
        for img, mask in zip(img_rels, mask_rels):
            save_stack(root / img, raw(rng, (5, 64, 64)))
            save_image(root / mask, labels(rng, 4, IMAGE, "uint8"))


def build_microbeseg(root):
    rng = np.random.default_rng(115)
    for split in ("train", "val"):
        split_dir = root / "microbeSEG_dataset" / "30min-man_15min-pre" / split
        for i in range(2):
            save_image(split_dir / f"img_{i:03d}.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
            save_image(split_dir / f"mask_{i:03d}.tif", labels(rng, 4, IMAGE, "uint16"))


def build_mndino(root):
    rng = np.random.default_rng(116)
    for split_dir in ("train", "validation"):
        base = root / "annotated_mn_datasets" / split_dir
        for i in range(2):
            save_image(base / "images" / f"im{i}.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
            save_image(base / "nuclei_masks" / f"im{i}.tif", labels(rng, 4, IMAGE, "uint16"))
            save_image(base / "mn_masks" / f"im{i}.png", (rng.random(IMAGE) > 0.8).astype("uint8"))


def build_morphonet(root):
    rng = np.random.default_rng(117)
    for org_dir in ("Patiria miniata", "Phallusia mammillata"):  # two of the five organisms
        for t in range(2):
            save_tif(root / org_dir / "published" / "RAW" / f"t{t:03d}.tif", raw(rng))
            save_tif(root / org_dir / "published" / "SEG" / f"t{t:03d}.tif", labels(rng, 5, dtype="uint16"))
    (root / "Patiria miniata" / "published" / "RAW" / "._t000.tif").write_bytes(b"junk")


def build_morphoseg(root):
    """Polygon ROIs per image, rasterised into masks by the reader."""
    rng = np.random.default_rng(118)
    for split in ("train",):
        data_dir = root / split
        for i in range(3):
            save_image(data_dir / "training_dataset" / f"im{i}.tif", raw(rng, IMAGE))
            rois = []
            for _ in range(3):
                x, y = [int(v) for v in rng.integers(0, 44, 2)]
                rois.append({"points": [[x, y], [x + 18, y + 2], [x + 20, y + 18], [x + 1, y + 20]]})
            (data_dir / "roi_jsons_combined").mkdir(exist_ok=True)
            (data_dir / "roi_jsons_combined" / f"im{i}_ROI.json").write_text(json.dumps(rois))


def rois_to_masks(module, root):
    module._rois_to_masks(str(root / "train"))


def build_mucic(root):
    """An HL60 variant as HDF5 volumes and the vasculogenesis PNGs whose semantic masks the
    reader splits into instances with a watershed."""
    rng = np.random.default_rng(119)
    variant_dir = root / "hl60" / "low_c00"
    for i in range(2):
        write_h5(variant_dir / f"image-final_{i:03d}.h5", Image=raw(rng))
        write_h5(variant_dir / f"image-labels_{i:03d}.h5", Image=labels(rng, 5, dtype="uint16"))
    vasc_dir = root / "vasculogenesis" / "default"
    for i in range(2):
        save_image(vasc_dir / "images" / f"image_{i:04d}.png", raw(rng, IMAGE))
        mask = np.zeros(IMAGE, dtype="uint8")
        mask[5:20, 5:20] = 255
        mask[21:40, 8:30] = 255
        mask[35:55, 35:55] = 255
        save_image(vasc_dir / "labels" / f"mask_{i:04d}.png", mask)


def check_mucic_watershed(jax_mod, port_mod, jax_root, port_root):
    sem = np.zeros((32, 32), dtype="uint8")
    sem[4:15, 4:28] = 1
    sem[16:28, 4:28] = 1
    sem[20:22, 10:12] = 0
    np.testing.assert_array_equal(port_mod._semantic_to_instances_watershed(sem),
                                  jax_mod._semantic_to_instances_watershed(sem))


def build_neurosphere(root):
    """Hollow nucleus shells as an int32 stack; the reader fills them."""
    rng = np.random.default_rng(120)
    data_dir = root / "neurosphere" / "sample"
    save_tif(data_dir / "OriginalStack.tif", raw(rng))
    shells = np.zeros(VOLUME, dtype="int32")
    for k, (y, x) in enumerate(((10, 10), (36, 30)), 1):
        shells[2:6, y:y + 20, x:x + 20] = k
        shells[3:5, y + 2:y + 18, x + 2:x + 18] = 0
    frames = [Image.fromarray(sl, mode="I") for sl in shells]
    frames[0].save(data_dir / "Nucleisegmented2.tif", save_all=True, append_images=frames[1:])


def build_nis3d(root):
    rng = np.random.default_rng(121)
    for species in ("DrosophilaMelanogaster_1", "MusMusculus_1"):
        d = root / "NIS3D" / "NIS3D" / species
        save_tif(d / "data.tif", raw(rng))
        save_tif(d / "GroundTruth.tif", labels(rng, 5, dtype="uint16"))
    for split in ("train", "test"):
        split_dir = root / "NIS3D" / "suggestive splitting" / "cross-image" / split / "vol1"
        save_tif(split_dir / "data.tif", raw(rng))
        save_tif(split_dir / "GroundTruth.tif", labels(rng, 5, dtype="uint16"))


def build_nisnet3d(root):
    rng = np.random.default_rng(122)
    for vol in ("Rat_liver_1", "Scale-cleared_rat_kidney_1"):
        for sub in ("V1", "synthetic"):
            d = root / "ground_truth_and_synthetic" / vol / sub
            save_tif(d / f"{sub}.tif", raw(rng))
            save_tif(d / f"{sub}_gt.tif", labels(rng, 5, dtype="uint16"))


def build_nuc_morph(root):
    rng = np.random.default_rng(123)
    (root / "training_data_manifest.csv").write_text("index,mode\n1,train\n2,train\n3,valid\n4,test\n")
    for idx in (1, 2, 3, 4):
        save_tif(root / "high_res_100x" / f"IMG_{idx:04d}.tif", raw(rng))
        save_tif(root / "watershed_segmentation_100x" / f"IMG_{idx:04d}.tif", labels(rng, 5, dtype="uint16"))


def build_oocyteseg(root):
    rng = np.random.default_rng(124)
    for subdir in ("exp1", "exp2", "exp1_test", "exp2_test"):
        base = root / "SegmentationCortex" / "mouse" / subdir
        for i in range(2):
            save_image(base / "input" / f"im{i}.png", raw(rng, IMAGE + (3,)))
            mask = np.zeros(IMAGE + (3,), dtype="uint8")
            y, x = rng.integers(0, 30, 2)
            mask[y:y + 30, x:x + 30] = 255
            save_image(base / "mask" / f"im{i}.png", mask)


def build_orgaextractor(root):
    rng = np.random.default_rng(125)
    for split in ("train", "val"):
        for i in range(2):
            save_image(root / split / f"im{i}.jpg", raw(rng, IMAGE + (3,)))
            mask = np.zeros(IMAGE, dtype="uint8")
            mask[5:20, 5:20] = 255
            y, x = rng.integers(25, 44, 2)
            mask[y:y + 18, x:x + 18] = 255
            save_image(root / split / f"im{i}.tif", mask)


def preprocess_orgaextractor(module, root):
    for split in ("train", "val"):
        module._preprocess_data(str(root / split))


def build_organoid(root):
    rng = np.random.default_rng(126)
    for split in ("train", "val"):
        for i in range(2):
            write_h5(root / "data" / "original" / split / f"im{i}.h5", raw=raw(rng, (3, 64, 64)),
                     labels=labels(rng, 4, IMAGE, "uint16"))
    write_h5(root / "data" / "gemcitabine" / "well1.h5", raw__bf=(rng.random(VOLUME) * 255).astype("uint16"),
             raw__pi=(rng.random(VOLUME) * 255).astype("uint16"), labels=labels(rng, 4, dtype="uint16"))


def build_organoidnet(root):
    rng = np.random.default_rng(127)
    for split in ("Training", "Validation"):
        for i in range(2):
            save_image(root / split / "Images" / f"im{i}.tif", (rng.random(IMAGE) * 65535).astype("uint16"))
            save_image(root / split / "Masks" / f"im{i}.tif", labels(rng, 4, IMAGE, "uint16"))


def build_orgline(root):
    """The first archive's InstanceSeg folders (images with masks as PNG or ``.npy``), which the
    reader converts to HDF5 for every organ of the archive and then removes."""
    rng = np.random.default_rng(93)
    for organ in ("PDAC", "colon", "Intestine", "brain"):
        for split in ("train", "val"):
            d = root / "data1" / "InstanceSeg" / organ / split
            for i in range(2):
                save_image(d / "images" / f"im{i}.png", raw(rng, IMAGE + ((3,) if organ == "colon" else ())))
                if organ == "brain":
                    (d / "masks").mkdir(parents=True, exist_ok=True)
                    np.save(d / "masks" / f"im{i}.npy", labels(rng, 5, IMAGE, "uint16"))
                else:
                    save_image(d / "masks" / f"im{i}.png", labels(rng, 5, IMAGE, "uint16"))


def prepare_orgline(module, root):
    module._prepare_data(str(root / "data1"), "PDAC")


BOUNDARIES_2D = dict(patch_shape=PATCH_2D, boundaries=True)

CASES = [
    LMCase("evican", build_evican,
           paths=[("get_evican_paths", dict(split="train", segmentation_type="cell")),
                  ("get_evican_paths", dict(split="val", segmentation_type="nucleus"))],
           datasets=[("get_evican_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_evican_dataset", dict(patch_shape=PATCH_2D, split="val", segmentation_type="nucleus"))],
           loaders=[("get_evican_loader", dict(patch_shape=IMAGE, batch_size=2, split="train"))]),
    LMCase("glioma_c6", build_glioma_c6, prepare=coco_masks_glioma,
           paths=[("get_glioma_c6_paths", dict(subset="spec", split="train")),
                  ("get_glioma_c6_paths", dict(subset="spec")), ("get_glioma_c6_paths", dict(subset="gen"))],
           datasets=[("get_glioma_c6_dataset", dict(patch_shape=PATCH_2D, subset="spec", split="val")),
                     ("get_glioma_c6_dataset", dict(patch_shape=PATCH_2D, subset="gen"))],
           loaders=[("get_glioma_c6_loader", dict(patch_shape=PATCH_2D, batch_size=2, subset="spec", split="val"))]),
    LMCase("idr0095", build_idr0095,
           paths=[("get_idr0095_paths", dict(experiment="A"))],
           datasets=[("get_idr0095_dataset", dict(patch_shape=PATCH_2D, experiment="A"))],
           loaders=[("get_idr0095_loader", dict(batch_size=2, patch_shape=PATCH_2D, experiment="A"))]),
    LMCase("liconn", build_liconn,
           paths=[("get_liconn_paths", dict(segmentation="proofread"))],
           datasets=[("get_liconn_dataset", dict(patch_shape=PATCH_3D))],
           loaders=[("get_liconn_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("lpc_nucseg", build_lpc_nucseg,
           paths=[("get_lpc_nucseg_paths", dict(source="gnf")), ("get_lpc_nucseg_paths", dict(source="ic100"))],
           datasets=[("get_lpc_nucseg_dataset", dict(patch_shape=PATCH_2D, source="gnf")),
                     ("get_lpc_nucseg_dataset", dict(patch_shape=PATCH_2D, source="ic100"))],
           loaders=[("get_lpc_nucseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, source="ic100"))]),
    LMCase("lsm_mouse_embryo", build_lsm_mouse_embryo,
           paths=[("get_lsm_mouse_embryo_paths", dict(split="train", task="tissue")),
                  ("get_lsm_mouse_embryo_paths", dict(split="test", task="tissue"))],
           datasets=[("get_lsm_mouse_embryo_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_lsm_mouse_embryo_dataset", dict(patch_shape=PATCH_2D, split="test"))],
           loaders=[("get_lsm_mouse_embryo_loader", dict(patch_shape=IMAGE, batch_size=2, split="train"))]),
    LMCase("medussa", build_medussa,
           paths=[("get_medussa_paths", dict(split="train")), ("get_medussa_paths", dict(split="test"))],
           datasets=[("get_medussa_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_medussa_dataset", dict(patch_shape=PATCH_2D, split="test"))],
           loaders=[("get_medussa_loader", dict(batch_size=2, patch_shape=PATCH_2D, split="train"))]),
    LMCase("microbeseg", build_microbeseg,
           paths=[("get_microbeseg_paths", dict(split="train")), ("get_microbeseg_paths", dict(split="val"))],
           datasets=[("get_microbeseg_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_microbeseg_dataset", dict(patch_shape=PATCH_2D, split="val"))],
           loaders=[("get_microbeseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("mndino", build_mndino,
           paths=[("get_mndino_paths", dict(split="train")), ("get_mndino_paths", dict(split="val"))],
           datasets=[("get_mndino_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_mndino_dataset", dict(patch_shape=PATCH_2D, split="val", label_choice="nuclei"))],
           loaders=[("get_mndino_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train",
                                               label_choice="nuclei"))]),
    LMCase("morphonet", build_morphonet,
           paths=[("get_morphonet_paths", dict(organism="patiria_miniata")),
                  ("get_morphonet_paths", dict(organism=["phallusia_mammillata", "patiria_miniata"]))],
           datasets=[("get_morphonet_dataset", dict(patch_shape=PATCH_3D, organism="patiria_miniata")),
                     ("get_morphonet_dataset", dict(patch_shape=PATCH_3D, organism=["phallusia_mammillata"]))],
           loaders=[("get_morphonet_loader", dict(batch_size=1, patch_shape=PATCH_3D, organism="patiria_miniata"))]),
    LMCase("morphoseg", build_morphoseg, prepare=rois_to_masks,
           paths=[("get_morphoseg_paths", dict(split="train"))],
           datasets=[("get_morphoseg_dataset", dict(patch_shape=PATCH_2D, split="train"))],
           loaders=[("get_morphoseg_loader", dict(patch_shape=IMAGE, batch_size=2, split="train"))]),
    LMCase("mucic", build_mucic, check=check_mucic_watershed,
           paths=[("get_mucic_paths", dict(cell_line="hl60", variant="low_c00")),
                  ("get_mucic_paths", dict(cell_line="vasculogenesis"))],
           datasets=[("get_mucic_dataset", dict(patch_shape=PATCH_3D, cell_line="hl60", variant="low_c00")),
                     ("get_mucic_dataset", dict(patch_shape=PATCH_2D, cell_line="vasculogenesis"))],
           loaders=[("get_mucic_loader", dict(batch_size=1, patch_shape=PATCH_3D, cell_line="hl60",
                                              variant="low_c00"))]),
    LMCase("neurosphere", build_neurosphere,
           paths=[("get_neurosphere_paths", {})],
           datasets=[("get_neurosphere_dataset", dict(patch_shape=PATCH_3D))],
           loaders=[("get_neurosphere_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("nis3d", build_nis3d,
           paths=[("get_nis3d_paths", {}), ("get_nis3d_paths", dict(split="train", split_type="cross-image"))],
           datasets=[("get_nis3d_dataset", dict(patch_shape=PATCH_3D)),
                     ("get_nis3d_dataset", dict(patch_shape=PATCH_3D, split="test", split_type="cross-image"))],
           loaders=[("get_nis3d_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("nisnet3d", build_nisnet3d,
           paths=[("get_nisnet3d_paths", dict(volumes=["Rat_liver_1"])),
                  ("get_nisnet3d_paths", dict(volumes=["Rat_liver_1", "Scale-cleared_rat_kidney_1"]))],
           datasets=[("get_nisnet3d_dataset", dict(patch_shape=PATCH_3D, volumes=["Scale-cleared_rat_kidney_1"]))],
           loaders=[("get_nisnet3d_loader", dict(patch_shape=PATCH_3D, batch_size=1, volumes=["Rat_liver_1"]))]),
    LMCase("nuc_morph", build_nuc_morph,
           paths=[("get_nuc_morph_paths", dict(split="train")), ("get_nuc_morph_paths", dict(split="val"))],
           datasets=[("get_nuc_morph_dataset", dict(patch_shape=PATCH_3D, split="train")),
                     ("get_nuc_morph_dataset", dict(patch_shape=PATCH_3D, split="test"))],
           loaders=[("get_nuc_morph_loader", dict(patch_shape=PATCH_3D, batch_size=1, split="train"))]),
    LMCase("oocyteseg", build_oocyteseg,
           paths=[("get_oocyteseg_paths", dict(split="train", species="mouse")),
                  ("get_oocyteseg_paths", dict(split="test", species="mouse"))],
           datasets=[("get_oocyteseg_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_oocyteseg_dataset", dict(patch_shape=PATCH_2D, split="test"))],
           loaders=[("get_oocyteseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("orgaextractor", build_orgaextractor, prepare=preprocess_orgaextractor,
           paths=[("get_orgaextractor_paths", dict(split="train"))],
           datasets=[("get_orgaextractor_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_orgaextractor_dataset", dict(patch_shape=PATCH_2D, split="val"))],
           loaders=[("get_orgaextractor_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("organoid", build_organoid,
           paths=[("get_organoid_paths", dict(split="train", source="original")),
                  ("get_organoid_paths", dict(source="gemcitabine"))],
           datasets=[("get_organoid_dataset", dict(patch_shape=PATCH_2D, split="val", source="original")),
                     ("get_organoid_dataset", dict(patch_shape=PATCH_3D, source="gemcitabine",
                                                   source_channels=["bf", "pi"]))],
           loaders=[("get_organoid_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train",
                                                 source="original"))]),
    LMCase("organoidnet", build_organoidnet,
           paths=[("get_organoidnet_paths", dict(split="Training"))],
           datasets=[("get_organoidnet_dataset", dict(split="Training", patch_shape=PATCH_2D)),
                     ("get_organoidnet_dataset", dict(split="Validation", patch_shape=PATCH_2D))],
           loaders=[("get_organoidnet_loader", dict(split="Training", patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("orgline", build_orgline, prepare=prepare_orgline,
           paths=[("get_orgline_paths", dict(split="train", organs=["PDAC", "colon", "Intestine", "brain"])),
                  ("get_orgline_paths", dict(split="val", organs="brain"))],
           datasets=[("get_orgline_dataset", dict(patch_shape=PATCH_2D, split="train", organs="colon")),
                     ("get_orgline_dataset", dict(patch_shape=PATCH_2D, split="val", organs=["PDAC", "brain"]))],
           loaders=[("get_orgline_loader", dict(batch_size=2, patch_shape=PATCH_2D, split="train", organs="PDAC"))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def _idr0095_without_phase(module, root):
    cond = root / "idr0095" / "Experiment_A_Figure3" / "glucose" / "cond1"
    save_image(cond / "f0-Mask.tif", np.ones(IMAGE, "uint16"))
    (cond.parent / "cond1.nd2").write_bytes(b"nd2")
    module.get_idr0095_paths(str(root), experiment="A")


def _liconn_stream(module, root):
    module.get_liconn_paths(str(root), segmentation="proofread", download=True)


def _e11bio_stream(module, root):
    module.get_e11bio_paths(str(root), split="instance", crop_ids=[0], download=True)


def _orgline_coco(module, root):
    """OrgLine's stomach and breast COCO layout (``torch_conversion_layouts.orgline_layout``: compressed-RLE and
    polygon organoids), converted by the reader's own ``_prepare_data``."""
    layouts.orgline_layout(str(root / "data2"), (4, 2), (192, 256))
    module._prepare_data(str(root / "data2"), "stomach")


# packages that the port no longer needs: the JAX package raises, the port converts with its own code
PORTED = ("'pycocotools'",)


@pytest.mark.parametrize("name, call, error, package", [
    ("idr0095", _idr0095_without_phase, ImportError, "'nd2'"),
    ("liconn", _liconn_stream, ImportError, "'cloud-volume'"),
    ("e11bio", _e11bio_stream, ImportError, "'s3fs'"),
    ("orgline", _orgline_coco, ModuleNotFoundError, "'pycocotools'"),
])
def test_missing_package_error_matches_jax(name, call, error, package, tmp_path, monkeypatch):
    """Where a reader needs a package only on its download or conversion path (nd2, cloud-volume,
    s3fs), the port raises the JAX package's error naming it, and imports it only there. Where the
    JAX package needs pycocotools (OrgLine's COCO masks) it still raises, and the port converts with
    its own ``utils/coco.py``."""
    for blocked in ("nd2", "cloudvolume", "s3fs", "zarr", "pycocotools"):
        monkeypatch.setitem(__import__("sys").modules, blocked, None)
    messages = []
    for k, module in enumerate(modules(name, LIGHT_MICROSCOPY)):
        root = tmp_path / str(k)
        root.mkdir()
        if k == 1 and package in PORTED:
            call(module, root)
            assert sorted(p.name for p in root.rglob("*.h5")), "the port converted nothing"
            continue
        with pytest.raises(error) as info:
            call(module, root)
        assert type(info.value) is error and package in str(info.value)
        messages.append(str(info.value))
    assert len(set(messages)) == 1


class _ZarrArray:
    """What ``zarr.open(...)[key]`` gives the E11bio conversion: an array with ``attrs``."""

    def __init__(self, data, **attrs):
        self.data, self.attrs = data, attrs

    def __getitem__(self, index):
        return self.data[index]


def _stub_e11bio_packages(monkeypatch, rng):
    """``s3fs`` and ``zarr`` as the E11bio conversion calls them, serving one seeded crop whose labels
    are offset by a plane from the raw and hold ids with gaps."""
    import sys
    import types

    crop = {"raw": _ZarrArray(raw(rng, (3, 10, 16, 16)), offset=[0, 0, 0], resolution=[2, 1, 1]),
            "labels": _ZarrArray(rng.choice([0, 3, 7, 20], size=(8, 16, 16)).astype("uint64"),
                                 offset=[2, 0, 0])}
    s3fs = types.ModuleType("s3fs")
    s3fs.S3FileSystem = lambda anon: None
    s3fs.S3Map = lambda url, s3: url
    zarr = types.ModuleType("zarr")
    zarr.open = lambda store, mode: crop
    monkeypatch.setitem(sys.modules, "s3fs", s3fs)
    monkeypatch.setitem(sys.modules, "zarr", zarr)


def _relabel_to_two(monkeypatch):
    """The JAX package's ``relabel_consecutive`` cut to the two values its readers unpack."""
    import torch_em_tpu.ops.host as jax_host

    relabel = jax_host.relabel_consecutive
    monkeypatch.setattr(jax_host, "relabel_consecutive", lambda seg, *args, **kwargs: relabel(seg, *args, **kwargs)[:2])


def test_e11bio_conversion_unpacks_relabel_consecutive(tmp_path, monkeypatch):
    """E11bio's conversion of a streamed crop takes two values from ``relabel_consecutive``, which returns
    three: the JAX package's conversion raises there (ValueError: too many values to unpack), the port's
    takes the first. With the JAX package's ``relabel_consecutive`` cut to two values, both write the same
    file: raw per channel cropped to the labels' offset, labels relabelled 1..n."""
    import h5py

    _stub_e11bio_packages(monkeypatch, np.random.default_rng(211))
    jax_module, port_module = modules("e11bio", LIGHT_MICROSCOPY)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_module.get_e11bio_data(str(tmp_path / "unpatched"), crop_ids=[0], download=True)
    port_path, = port_module.get_e11bio_data(str(tmp_path / "port"), crop_ids=[0], download=True)
    _relabel_to_two(monkeypatch)
    jax_path, = jax_module.get_e11bio_data(str(tmp_path / "jax"), crop_ids=[0], download=True)
    with h5py.File(port_path, "r") as got, h5py.File(jax_path, "r") as expected:
        assert dict(got.attrs) == dict(expected.attrs) and sorted(got["raw"]) == sorted(expected["raw"])
        for key in [f"raw/{ch}" for ch in expected["raw"]] + ["labels"]:
            assert got[key].dtype == expected[key].dtype
            np.testing.assert_array_equal(got[key][:], expected[key][:])
        assert got["raw/ch_00"].shape == (8, 16, 16)
        assert sorted(np.unique(got["labels"][:])) == [0, 1, 2, 3]


class _Coco:
    """The three calls of pycocotools' ``COCO`` that OrgLine's conversion makes, over rectangles."""

    def __init__(self, boxes):
        self.boxes = boxes

    def getAnnIds(self, imgIds):
        return list(range(len(self.boxes)))

    def loadAnns(self, ids):
        return [{"id": i, "area": self.boxes[i][2] * self.boxes[i][3], "box": self.boxes[i]} for i in ids]

    def annToMask(self, annotation):
        x, y, w, h = annotation["box"]
        mask = np.zeros((48, 64), "uint8")
        mask[y:y + h, x:x + w] = 1
        return mask


def test_orgline_coco_conversion_unpacks_relabel_consecutive(monkeypatch):
    """OrgLine's COCO conversion (stomach, breast) takes two values from ``relabel_consecutive``, which
    returns three: the JAX package's raises there (ValueError: too many values to unpack), the port's
    takes the first. With the JAX package's function cut to two values, both give the same instances:
    larger organoids pasted first, pieces under 25 pixels dropped, ids 1..n."""
    coco = _Coco([(2, 2, 30, 20), (20, 10, 30, 30), (40, 5, 4, 4), (0, 40, 3, 3), (56, 40, 6, 6)])
    image = {"id": 0, "height": 48, "width": 64}
    jax_module, port_module = modules("orgline", LIGHT_MICROSCOPY)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_module._annotations_to_instances(coco, image)
    got = port_module._annotations_to_instances(coco, image)
    _relabel_to_two(monkeypatch)
    expected = jax_module._annotations_to_instances(coco, image)
    assert got.dtype == expected.dtype == np.uint16
    np.testing.assert_array_equal(got, expected)
    assert sorted(np.unique(got)) == [0, 1, 2, 3]
