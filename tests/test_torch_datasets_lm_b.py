"""The port's dataset zoo, light microscopy (aiSEGcell to EnSeg), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): paths, ``len``, samples under one
``np.random.seed``, loader batch shapes, and every file under both folders equal afterwards, the
reader's conversions included (aiSEGcell's, BALF's, BBBC030's, BlastoSPIM's, BMGD's, BriFiSeg's
and CShaper's HDF5 files, Brain Organoids', CISD's, CVZ-Fluo's, DIC-HepG2's and EnSeg's TIFFs,
DynamicNuclearNet's zarr). Conversions that only a download reaches run through the reader's own
function on both sides (``prepare``). E11bio streams from S3 with s3fs and zarr, which this
machine lacks: its case reads the cached crops, as the JAX package's tests do.
"""

import base64
import gzip
import io
import json

import numpy as np
import pytest
from PIL import Image

from torch_em_tpu.utils.medical_io import save_nifti
from torch_zoo_layouts import (IMAGE, PATCH_2D, PATCH_3D, VOLUME, LMCase, check_case, labels, raw, save_image,
                               save_tif, write_h5)


def build_aisegcell(root):
    """The extracted aiSEGcell_nucleus folder: brightfield, nucleus and mask PNGs per split."""
    rng = np.random.default_rng(91)
    base = root / "aiSEGcell_nucleus"
    for dname, split in (("exp1", "train"), ("exp1", "val"), ("exp2", "train")):
        for i in range(2):
            for sub in ("brightfield", "nucleus"):
                save_image(base / dname / f"set_{split}" / sub / f"im{i}.png", raw(rng, IMAGE))
            mask = np.zeros(IMAGE, dtype="uint8")
            for _ in range(3):
                y, x = rng.integers(0, 50, 2)
                mask[y:y + 10, x:x + 12] = 255
            save_image(base / dname / f"set_{split}" / "masks" / f"im{i}.png", mask)
    (root / "data").mkdir()


def prepare_aisegcell(module, root):
    module._preprocess_data(str(root / "data"), str(root / "aiSEGcell_nucleus"))


def build_bac_mother(root):
    rng = np.random.default_rng(87)
    for split in ("train", "test"):
        for seq in ("01", "02"):
            for t in range(2):
                save_tif(root / "CTC" / split / seq / f"t{t:03d}.tif", raw(rng, IMAGE))
                save_tif(root / "CTC" / split / f"{seq}_GT" / "SEG" / f"man_seg{t:03d}.tif",
                         labels(rng, 4, IMAGE, "uint16"))


def build_balf(root):
    """YOLO polygon files (class, then normalised x y pairs) beside the RGB images."""
    rng = np.random.default_rng(93)
    for split in ("train", "val"):
        for i in range(2):
            save_image(root / "images" / split / f"im{i}.jpg", raw(rng, IMAGE + (3,)))
            lines = []
            for _ in range(3):
                x0, y0 = rng.uniform(0.05, 0.55, 2).round(3)
                lines.append(f"{int(rng.integers(0, 8))} {x0} {y0} {x0 + 0.3} {y0} {x0 + 0.3} {y0 + 0.35} {x0} "
                             f"{y0 + 0.3}")
            (root / "labels" / split).mkdir(parents=True, exist_ok=True)
            (root / "labels" / split / f"im{i}.txt").write_text("\n".join(lines) + "\n")


def build_bbbc030(root):
    """Images and hand-drawn closed contours, one per cell."""
    rng = np.random.default_rng(94)
    for i in range(3):
        save_image(root / "images" / f"im{i}.png", raw(rng, IMAGE))
        contour = np.zeros(IMAGE, dtype="uint8")
        for _ in range(2):
            y, x = rng.integers(2, 40, 2)
            h, w = rng.integers(8, 20, 2)
            contour[y, x:x + w] = contour[y + h, x:x + w] = 255
            contour[y:y + h + 1, x] = contour[y:y + h + 1, x + w] = 255
        save_image(root / "ground_truth" / f"im{i}.png", contour)


def prepare_bbbc030(module, root):
    module._preprocess(str(root))


def build_bbbc034(root):
    rng = np.random.default_rng(85)
    for c in range(4):
        save_tif(root / "BBBC034" / f"stack_C={c}.tif", (rng.random(VOLUME) * 65535).astype("uint16"))
    save_tif(root / "BBBC034" / "ground_truth_segmented.tif", labels(rng, 5, dtype="uint16"))


def build_bitdepth_nucseg(root):
    rng = np.random.default_rng(86)
    for mag in ("20x", "40x"):
        for i in range(2):
            save_tif(root / "data" / mag / "images_16bit" / f"im{i}.tif",
                     (rng.random(IMAGE) * 65535).astype("uint16"))
            save_tif(root / "data" / mag / "label masks" / f"im{i}.tif", labels(rng, 4, IMAGE, "uint16"))


def build_blastospim(root):
    """The gzipped ``.npy`` pairs of the download (written without a time stamp)."""
    rng = np.random.default_rng(89)
    for i in range(2):
        for tag, arr in (("image", (rng.random(VOLUME) * 255).astype("float32")),
                         ("masks", labels(rng, 5, dtype="uint16"))):
            buf = io.BytesIO()
            np.save(buf, arr)
            (root / "data").mkdir(exist_ok=True)
            (root / "data" / f"F{i}_{tag}_0.npy.gz").write_bytes(gzip.compress(buf.getvalue(), mtime=0))


def prepare_blastospim(module, root):
    module._preprocess_inputs(str(root / "data"))


def build_bmgd(root):
    rng = np.random.default_rng(91)
    for folder in ("250 Pa", "950 Pa"):
        for i in range(3):
            save_image(root / folder / "image" / f"im{i}.tif", raw(rng, IMAGE))
            save_image(root / folder / "mask" / f"im{i}.tif", ((rng.random(IMAGE) > 0.6) * 255).astype("uint8"))


def build_brain_organoids(root):
    rng = np.random.default_rng(92)
    for i in range(3):
        save_image(root / "data" / "imgs" / f"organoid_{i}.png", raw(rng, IMAGE + (3,)))
        (root / "data" / "labels").mkdir(parents=True, exist_ok=True)
        np.save(root / "data" / "labels" / f"organoid_{i}.npy", labels(rng, 4, IMAGE, "int64"))


def build_brifiseg(root):
    """The nnU-Net task layout of the 1channel tarball, as NIfTI."""
    rng = np.random.default_rng(90)
    task = root / "1channel" / "Task501_A549"
    for sub, lab_sub, n in (("imagesTr", "labelsTr", 2), ("imagesTs", "labelsTs", 1)):
        (task / sub).mkdir(parents=True)
        (task / lab_sub).mkdir(parents=True)
        for i in range(n):
            name = f"{sub[-2:].lower()}_case{i}"
            save_nifti(str(task / sub / f"{name}_0000.nii.gz"), (rng.random(IMAGE) * 255).astype("float32"))
            save_nifti(str(task / lab_sub / f"{name}.nii.gz"), labels(rng, 3, IMAGE, "uint8"))


def prepare_brifiseg(module, root):
    module._preprocess(str(root), str(root / "data"))


def build_cartocell(root):
    rng = np.random.default_rng(88)
    for name, split in (("MDCK-Normoxia", "train"), ("hMSC", "test"), ("MDCK-Normoxia", "test")):
        for i in range(2):
            save_tif(root / "data" / f"low-resolution_{name}_{split}_raw_images" / f"cyst_{i}.tif", raw(rng))
            save_tif(root / "data" / f"low-resolution_{name}_{split}_label_images" / f"cyst_{i}.tif",
                     labels(rng, 5, dtype="uint16"))


def build_celegans_atlas(root):
    rng = np.random.default_rng(95)
    for split in ("train", "val"):
        for i in range(2):
            save_tif(root / "c_elegans_nuclei" / split / "images" / f"v{i}.tif", raw(rng))
            save_tif(root / "c_elegans_nuclei" / split / "masks" / f"v{i}.tif", labels(rng, 5, dtype="uint16"))


def build_cellbindb(root):
    rng = np.random.default_rng(96)
    for choice in ("DAPI", "ssDNA"):
        for sample in ("s1", "s2"):
            save_tif(root / "Other" / choice / sample / f"{sample}-img.tif", raw(rng, IMAGE))
            save_tif(root / "Other" / choice / sample / f"{sample}-instancemask.tif", labels(rng, 4, IMAGE, "uint16"))


def build_cisd(root):
    """RGB JPEGs and their instances as row-major RLE in CISD.json."""
    rng = np.random.default_rng(98)
    data_dir = root / "CISD"
    assets = []
    for i in range(3):
        name = f"im{i}.jpg"
        save_image(data_dir / "center_slice" / name, raw(rng, (32, 32, 3)))
        anns = []
        for _ in range(2):
            start, length = int(rng.integers(0, 800)), int(rng.integers(20, 120))
            anns.append({"data": [{"mask": {"size": [32, 32], "counts": [start, length, 32 * 32 - start - length]}}]})
        assets.append({"file_name": name, "annotations": anns})
    (data_dir / "CISD.json").write_text(json.dumps({"assets": assets}))


def build_cshaper(root):
    from torch_em_tpu.data.datasets.light_microscopy.cshaper import _ZIP_ROOT

    rng = np.random.default_rng(99)
    for split_subdir in ("TrainingData", "EvaluationData"):
        sample = root / _ZIP_ROOT / split_subdir / "Sample01"
        (sample / "RawMemb").mkdir(parents=True)
        (sample / "SegCell").mkdir()
        for t in range(2):
            save_nifti(str(sample / "RawMemb" / f"Sample01_{t:03d}_rawMemb.nii.gz"),
                       (rng.random((8, 32, 32)) * 255).astype("float32"))
            save_nifti(str(sample / "SegCell" / f"Sample01_{t:03d}_segCell.nii.gz"),
                       labels(rng, 5, (8, 32, 32), "int16"))


def build_cvz_fluo(root):
    rng = np.random.default_rng(100)
    (root / "Annotation Panel Table.xlsx").write_bytes(b"stub")
    for platform, sample in (("CODEX", "reg1"), ("Vectra", "reg2"), ("CODEX", "reg3")):
        for stain in ("Cell", "Dapi"):
            d = root / platform / sample
            save_image(d / f"{sample}-Crop_{stain}_Png.png", raw(rng, IMAGE + (3,)))
            mask = np.zeros(IMAGE, dtype="uint8")
            for _ in range(3):
                y, x = rng.integers(0, 50, 2)
                mask[y:y + 10, x:x + 10] = 1
            save_image(d / f"{sample}-Crop_{stain}_Mask_Png.png", mask)


def build_deepseas(root):
    rng = np.random.default_rng(101)
    for split in ("train", "test"):
        for i in range(3):
            save_image(root / "segmentation_dataset" / split / "images" / f"im{i}.png", raw(rng, IMAGE))
            save_image(root / "segmentation_dataset" / split / "masks" / f"im{i}.png", labels(rng, 4, IMAGE, "uint8"))


def build_dic_hepg2(root):
    """COCO polygons per split, decoded by LIVECell's decoder."""
    rng = np.random.default_rng(102)
    for split in ("train", "test"):
        base = root / "2021-11-15_HepG2_Calcein_AM" / "coco_format" / split
        images, annotations = [], []
        for i in range(2):
            fname = f"im{i}.png"
            save_image(base / "images" / fname, raw(rng, IMAGE))
            images.append({"id": i, "file_name": fname, "height": 64, "width": 64})
            for j in range(3):
                x, y = [int(v) for v in rng.integers(0, 44, 2)]
                annotations.append({"id": 10 * i + j, "image_id": i, "iscrowd": 0, "area": 300,
                                    "segmentation": [[x, y, x + 18, y, x + 20, y + 16, x, y + 18]]})
        (base / "annotations.json").write_text(json.dumps({"images": images, "annotations": annotations}))


def build_dynamicnuclearnet(root):
    """The release's npz per split; the reader writes one zarr per image and removes it."""
    rng = np.random.default_rng(103)
    npz_dir = root / "DynamicNuclearNet-segmentation-v1_0"
    npz_dir.mkdir()
    for split in ("train", "val"):
        np.savez(npz_dir / f"{split}.npz", X=rng.random((3, 64, 64, 1)).astype("float32"),
                 y=labels(rng, 5, (3, 64, 64, 1), "int32"))


def build_e11bio(root):
    """The crops the S3 stream caches: three raw channels and the labels."""
    rng = np.random.default_rng(104)
    for crop_id in range(2):
        write_h5(root / "instance" / f"crop_{crop_id}.h5", labels=labels(rng, 5, dtype="uint32"),
                 **{f"raw__ch_{ch:02d}": raw(rng) for ch in range(3)})


def build_enseg(root):
    """LabelMe-style JSON files with the image embedded as a base64 PNG."""
    rng = np.random.default_rng(106)
    for tag, sub in (("2C", "control"), ("22TW", "tumor"), ("4C", "control")):
        buf = io.BytesIO()
        Image.fromarray(raw(rng, IMAGE + (3,))).save(buf, format="PNG")
        shapes = []
        for _ in range(2):
            x, y = [int(v) for v in rng.integers(0, 40, 2)]
            shapes.append({"points": [[x, y], [x + 20, y], [x + 18, y + 20], [x, y + 22]]})
        (root / "data" / sub).mkdir(parents=True, exist_ok=True)
        (root / "data" / sub / f"sample_{tag}.json").write_text(json.dumps({
            "animalTag": tag, "imageData": base64.b64encode(buf.getvalue()).decode(), "imageHeight": 64,
            "imageWidth": 64, "shapes": shapes}))


BOUNDARIES_2D = dict(patch_shape=PATCH_2D, boundaries=True)

CASES = [
    LMCase("aisegcell", build_aisegcell, prepare=prepare_aisegcell,
           paths=[("get_aisegcell_paths", dict(split="train")), ("get_aisegcell_paths", dict(split="val"))],
           datasets=[("get_aisegcell_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_aisegcell_dataset", dict(patch_shape=PATCH_2D, split="val", raw_channel="fluorescence"))],
           loaders=[("get_aisegcell_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("bac_mother", build_bac_mother,
           paths=[("get_bac_mother_paths", dict(split="train")), ("get_bac_mother_paths", dict(split="test"))],
           datasets=[("get_bac_mother_dataset", dict(split="train", **BOUNDARIES_2D)),
                     ("get_bac_mother_dataset", dict(split="test", patch_shape=PATCH_2D, binary=True))],
           loaders=[("get_bac_mother_loader", dict(patch_shape=IMAGE, batch_size=2, split="train", binary=True))]),
    LMCase("balf", build_balf,
           paths=[("get_balf_paths", dict(split="train")), ("get_balf_paths", dict(split="val"))],
           datasets=[("get_balf_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_balf_dataset", dict(patch_shape=PATCH_2D, split="val", label_choice="semantic"))],
           loaders=[("get_balf_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train",
                                             label_choice="semantic"))]),
    LMCase("bbbc030", build_bbbc030, prepare=prepare_bbbc030,
           paths=[("get_bbbc030_paths", {})],
           datasets=[("get_bbbc030_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_bbbc030_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("bbbc034", build_bbbc034,
           paths=[("get_bbbc034_paths", dict(channel=2)), ("get_bbbc034_paths", dict(channel=0))],
           datasets=[("get_bbbc034_dataset", dict(patch_shape=PATCH_3D)),
                     ("get_bbbc034_dataset", dict(patch_shape=PATCH_3D, channel=3))],
           loaders=[("get_bbbc034_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("bitdepth_nucseg", build_bitdepth_nucseg,
           paths=[("get_bitdepth_nucseg_paths", {}), ("get_bitdepth_nucseg_paths", dict(magnification="20x"))],
           datasets=[("get_bitdepth_nucseg_dataset", dict(patch_shape=PATCH_2D)),
                     ("get_bitdepth_nucseg_dataset", dict(patch_shape=PATCH_2D, magnification="40x"))],
           loaders=[("get_bitdepth_nucseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, magnification="20x"))]),
    LMCase("blastospim", build_blastospim, prepare=prepare_blastospim,
           paths=[("get_blastospim_paths", {})],
           datasets=[("get_blastospim_dataset", dict(patch_shape=PATCH_3D))],
           loaders=[("get_blastospim_loader", dict(patch_shape=PATCH_3D, batch_size=1))]),
    LMCase("bmgd", build_bmgd,
           paths=[("get_bmgd_paths", dict(stiffness="250pa")), ("get_bmgd_paths", dict(stiffness=["950pa", "250pa"]))],
           datasets=[("get_bmgd_dataset", dict(patch_shape=PATCH_2D, stiffness="250pa")),
                     ("get_bmgd_dataset", dict(patch_shape=PATCH_2D, stiffness=["250pa", "950pa"]))],
           loaders=[("get_bmgd_loader", dict(batch_size=2, patch_shape=PATCH_2D, stiffness="950pa"))]),
    LMCase("brain_organoids", build_brain_organoids,
           paths=[("get_brain_organoids_paths", {})],
           datasets=[("get_brain_organoids_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_brain_organoids_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("brifiseg", build_brifiseg, prepare=prepare_brifiseg,
           paths=[("get_brifiseg_paths", dict(split="train")), ("get_brifiseg_paths", dict(split="test"))],
           datasets=[("get_brifiseg_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_brifiseg_dataset", dict(patch_shape=PATCH_2D, split="test"))],
           loaders=[("get_brifiseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("cartocell", build_cartocell,
           paths=[("get_cartocell_paths", {}), ("get_cartocell_paths", dict(split="train")),
                  ("get_cartocell_paths", dict(name="hMSC", split="test"))],
           datasets=[("get_cartocell_dataset", dict(patch_shape=PATCH_3D, split="train")),
                     ("get_cartocell_dataset", dict(patch_shape=PATCH_3D, name="MDCK-Normoxia", split="test"))],
           loaders=[("get_cartocell_loader", dict(patch_shape=PATCH_3D, batch_size=1, split="test"))]),
    LMCase("celegans_atlas", build_celegans_atlas,
           paths=[("get_celegans_atlas_paths", dict(split="train"))],
           datasets=[("get_celegans_atlas_dataset", dict(patch_shape=PATCH_3D, split="train")),
                     ("get_celegans_atlas_dataset", dict(patch_shape=PATCH_3D, split="val"))],
           loaders=[("get_celegans_atlas_loader", dict(patch_shape=PATCH_3D, batch_size=1, split="train"))]),
    LMCase("cellbindb", build_cellbindb,
           paths=[("get_cellbindb_paths", {}), ("get_cellbindb_paths", dict(data_choice="DAPI"))],
           datasets=[("get_cellbindb_dataset", dict(patch_shape=PATCH_2D)),
                     ("get_cellbindb_dataset", dict(patch_shape=PATCH_2D, data_choice=["ssDNA"]))],
           loaders=[("get_cellbindb_loader", dict(patch_shape=PATCH_2D, batch_size=2, data_choice=["DAPI", "ssDNA"]))]),
    LMCase("cisd", build_cisd,
           paths=[("get_cisd_paths", dict(mode="center_slice"))],
           datasets=[("get_cisd_dataset", dict(patch_shape=(32, 32)))],
           loaders=[("get_cisd_loader", dict(patch_shape=(32, 32), batch_size=2))]),
    LMCase("cshaper", build_cshaper,
           paths=[("get_cshaper_paths", dict(split="train")), ("get_cshaper_paths", dict(split="val"))],
           datasets=[("get_cshaper_dataset", dict(patch_shape=(4, 16, 16), split="train")),
                     ("get_cshaper_dataset", dict(patch_shape=(4, 16, 16), split="val"))],
           loaders=[("get_cshaper_loader", dict(patch_shape=(4, 16, 16), batch_size=1, split="train"))]),
    LMCase("cvz_fluo", build_cvz_fluo,
           paths=[("get_cvz_fluo_paths", dict(stain_choice="cell")),
                  ("get_cvz_fluo_paths", dict(stain_choice="dapi", data_choice="CODEX"))],
           datasets=[("get_cvz_fluo_dataset", dict(patch_shape=PATCH_2D, stain_choice="cell")),
                     ("get_cvz_fluo_dataset", dict(patch_shape=PATCH_2D, stain_choice="dapi", data_choice="Vectra"))],
           loaders=[("get_cvz_fluo_loader", dict(patch_shape=IMAGE, batch_size=2, stain_choice="cell"))]),
    LMCase("deepseas", build_deepseas,
           paths=[("get_deepseas_paths", dict(split="train")), ("get_deepseas_paths", dict(split="test"))],
           datasets=[("get_deepseas_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_deepseas_dataset", dict(patch_shape=PATCH_2D, split="test"))],
           loaders=[("get_deepseas_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    LMCase("dic_hepg2", build_dic_hepg2,
           paths=[("get_dic_hepg2_paths", dict(split="train")), ("get_dic_hepg2_paths", dict(split="test"))],
           datasets=[("get_dic_hepg2_dataset", dict(split="train", **BOUNDARIES_2D)),
                     ("get_dic_hepg2_dataset", dict(patch_shape=PATCH_2D, split="test", binary=True))],
           loaders=[("get_dic_hepg2_loader", dict(patch_shape=IMAGE, batch_size=2, split="train", binary=True))]),
    LMCase("dynamicnuclearnet", build_dynamicnuclearnet,
           paths=[("get_dynamicnuclearnet_paths", dict(split="train")),
                  ("get_dynamicnuclearnet_paths", dict(split="val"))],
           datasets=[("get_dynamicnuclearnet_dataset", dict(split="train", patch_shape=PATCH_2D)),
                     ("get_dynamicnuclearnet_dataset", dict(split="val", patch_shape=PATCH_2D))],
           loaders=[("get_dynamicnuclearnet_loader", dict(split="train", patch_shape=PATCH_2D, batch_size=2))]),
    LMCase("e11bio", build_e11bio,
           paths=[("get_e11bio_paths", dict(split="instance", crop_ids=[0, 1]))],
           datasets=[("get_e11bio_dataset", dict(patch_shape=PATCH_3D, crop_ids=[0, 1], channel=1, boundaries=True)),
                     ("get_e11bio_dataset", dict(patch_shape=PATCH_3D, crop_ids=[1],
                                                 offsets=[[-1, 0, 0], [0, -1, 0]]))],
           loaders=[("get_e11bio_loader", dict(patch_shape=PATCH_3D, batch_size=1, crop_ids=[0, 1], channel=2,
                                               boundaries=True))]),
    LMCase("enseg", build_enseg,
           paths=[("get_enseg_paths", {}), ("get_enseg_paths", dict(animal_tags=["2C"]))],
           datasets=[("get_enseg_dataset", dict(patch_shape=PATCH_2D)),
                     ("get_enseg_dataset", dict(patch_shape=PATCH_2D, animal_tags=["22TW", "4C"]))],
           loaders=[("get_enseg_loader", dict(patch_shape=IMAGE, batch_size=2))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)
