"""The port's dataset zoo, medical (the 2-D readers of PNG, JPEG, BMP, GIF, PGM, TIFF and MetaImage
images, which run on the card), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): paths, ``len``, samples under one
``np.random.seed``, loader batch shapes, and every file under both folders equal afterwards, so
that what a reader converts is compared too: the colour-coded annotations that AMD-SD, CholecSeg8k,
Fundus-AVSeg, HIL-ToothSeg, m2caiSeg and OIMHS map to label ids, DRIVE's and Kvasir's binarized
masks, PALM's inverted masks, PAPILA's contours drawn as masks. Several readers default to
``resize_inputs``, whose transform the cases exercise. OIMHS splits its eyes with sklearn's
``train_test_split`` in the JAX package and with the port's numpy copy, both drawing from numpy's
global ``RandomState``.
"""

import numpy as np
import pytest

from torch_em_tpu.utils.medical_io import save_mha
from torch_zoo_layouts import (IMAGE, PATCH_2D, MedCase, check_case, labels, raw, save_image, zip_folder)
from torch_zoo_layouts import no_network  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("no_network")


def gray(rng, shape=IMAGE):
    return raw(rng, shape)


def rgb(rng, shape=IMAGE):
    return raw(rng, shape + (3,))


def binary(rng, shape=IMAGE, value=255, p=0.6):
    return ((rng.random(shape) > p) * value).astype("uint8")


def colours(rng, palette, shape=IMAGE):
    return np.array(list(palette), dtype="uint8")[rng.integers(0, len(palette), shape)]


def mha(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    save_mha(str(path), array)


def build_abus(root):
    rng = np.random.default_rng(501)
    for cname in ("Benign", "Malignant"):
        for sub in (f"Original_{cname}", f"Fuzzy_{cname}"):
            for i in (1, 2, 10):
                save_image(root / "MT_Small_Dataset" / cname / sub / f"case{i}.png", gray(rng))
        for i in (1, 2, 10):
            save_image(root / "MT_Small_Dataset" / cname / f"Ground_Truth_{cname}" / f"case{i}.png", binary(rng))


def build_amd_sd(root):
    """The zip: per patient, PNGs of the scan beside its colour-coded annotation."""
    from torch_em_tpu.data.datasets.medical.amd_sd import MAPPING_IDS

    rng = np.random.default_rng(502)
    src = root / "src" / "AMD-SD" / "images"
    for pid in (1, 2, 10):
        for i in range(2):
            ann = colours(rng, list(MAPPING_IDS) + [(0, 0, 0), (250, 3, 0)])
            save_image(src / f"patient{pid}" / f"b{i}.png", np.concatenate([rgb(rng), ann], axis=1))
    zip_folder(root / "src" / "AMD-SD", root / "AMD-SD.zip", root / "src")
    (root / "src").rmdir()


def build_busi(root):
    rng = np.random.default_rng(503)
    for category in ("benign", "malignant"):
        for i in (1, 2, 10):
            save_image(root / "Dataset_BUSI_with_GT" / category / f"{category} ({i}).png", gray(rng))
            save_image(root / "Dataset_BUSI_with_GT" / category / f"{category} ({i})_mask.png", binary(rng))


def build_cbis_ddsm(root):
    rng = np.random.default_rng(504)
    for task in ("Calc", "Mass"):
        for folder, kind in (("Train", "MALIGNANT"), ("Train", "BENIGN"), ("Test", "BENIGN")):
            for i in range(2):
                base = root / "DATA" / task / folder / kind
                save_image(base / f"P_{i:05d}_LEFT_CC_FULL_1.png", gray(rng))
                save_image(base / f"P_{i:05d}_LEFT_CC_MASK_1.png", binary(rng, (64, 48) if i else IMAGE))


def build_cholecseg8k(root):
    """Five videos of frames and colour-coded watershed masks (one with an alpha channel)."""
    from torch_em_tpu.data.datasets.medical.cholecseg8k import LABEL_MAPS

    rng = np.random.default_rng(505)
    for vid in range(1, 6):
        base = root / "data" / f"video{vid:02d}" / f"video{vid:02d}_00080"
        for i in range(2):
            save_image(base / f"frame_{80 + i}_endo.png", rgb(rng))
            mask = colours(rng, LABEL_MAPS)
            if vid == 3 and i == 1:
                mask = np.concatenate([mask, np.full(IMAGE + (1,), 255, "uint8")], axis=-1)
            save_image(base / f"frame_{80 + i}_endo_watershed_mask.png", mask)


def build_covid_qu_ex(root):
    rng = np.random.default_rng(506)
    for task in ("Lung Segmentation Data", "Infection Segmentation Data"):
        for split in ("Train", "Val"):
            for ptype in ("COVID-19", "Normal"):
                base = root / "data" / task / task / split / ptype
                for i in range(2):
                    save_image(base / "images" / f"{ptype}_{i}.png", gray(rng))
                    save_image(base / "lung masks" / f"{ptype}_{i}.png", binary(rng))
                    if task.startswith("Infection"):
                        save_image(base / "infection masks" / f"{ptype}_{i}.png", binary(rng))


def build_dca1(root):
    rng = np.random.default_rng(507)
    for i in range(1, 4):
        save_image(root / "Database_134_Angiograms" / f"{i}.pgm", gray(rng))
        save_image(root / "Database_134_Angiograms" / f"{i}_gt.pgm", binary(rng))


def build_drive(root):
    """RGB TIFFs and the first observer's GIF masks, converted to binary TIFFs."""
    rng = np.random.default_rng(508)
    for i in range(21, 24):
        save_image(root / "training" / "images" / f"{i}_training.tif", rgb(rng))
        save_image(root / "training" / "1st_manual" / f"{i}_manual1.gif", binary(rng))


def build_dsad(root):
    rng = np.random.default_rng(509)
    for organ in ("liver", "pancreas", "multilabel"):
        for seq in ("01", "02"):
            for i in range(2):
                save_image(root / "data" / organ / seq / f"image{i:02d}.png", rgb(rng))
                save_image(root / "data" / organ / seq / f"mask{i:02d}.png", binary(rng))


def build_fundus_avseg(root):
    """The zip: images, colour-coded artery and vein annotations and the split lists."""
    rng = np.random.default_rng(510)
    src = root / "src" / "Fundus-AVSeg"
    names = [f"{i:03d}.png" for i in range(1, 19)]
    for name in names:
        save_image(src / "images" / name, rgb(rng, (32, 32)))
        save_image(src / "annotation" / name,
                   colours(rng, [(255, 0, 0), (0, 0, 255), (0, 255, 0), (255, 255, 255), (0, 0, 0)], (32, 32)))
    (src / "training.txt").write_text("\n".join(["filename"] + names[:16]) + "\n")
    (src / "testing.txt").write_text("\n".join(["filename"] + names[16:]) + "\n")
    zip_folder(src, root / "Fundus_AVSeg.zip", root / "src")
    (root / "src").rmdir()


def build_hil_toothseg(root):
    """Colour-coded teeth, converted to instance ids."""
    rng = np.random.default_rng(511)
    for i in range(4):
        save_image(root / "Teeth Segmentation PNG" / "d2" / "img" / f"{i}.png", gray(rng))
        mask = np.zeros(IMAGE + (3,), "uint8")
        for colour in ((255, 0, 0), (0, 255, 0), (17, 90, 200)):
            y, x = rng.integers(0, 48, 2)
            mask[y:y + 12, x:x + 10] = colour
        save_image(root / "Teeth Segmentation PNG" / "d2" / "masks_machine" / f"{i}.png", mask)


def build_idrid(root):
    rng = np.random.default_rng(512)
    seg = root / "data" / "A.%20Segmentation" / "A. Segmentation"
    for split in ("a. Training Set", "b. Testing Set"):
        for i in (1, 2):
            save_image(seg / "1. Original Images" / split / f"IDRiD_{i:02d}.jpg", rgb(rng))
            for task, suffix in (("5. Optic Disc", "OD"), ("3. Hard Exudates", "EX")):
                save_image(seg / "2. All Segmentation Groundtruths" / split / task / f"IDRiD_{i:02d}_{suffix}.tif",
                           binary(rng))


def build_isic(root):
    rng = np.random.default_rng(513)
    for split in ("Training", "Validation"):
        for i in range(3):
            save_image(root / f"ISIC2018_Task1-2_{split}_Input" / f"ISIC_{i:07d}.jpg", rgb(rng, (48, 64)))
            save_image(root / f"ISIC2018_Task1_{split}_GroundTruth" / f"ISIC_{i:07d}_segmentation.png",
                       binary(rng, (48, 64)))


def build_jnuifm(root):
    rng = np.random.default_rng(514)
    base = root / "Pubic Symphysis-Fetal Head Segmentation and Angle of Progression"
    for i in range(2):
        mha(base / "image_mha" / f"{i:05d}.mha", rgb(rng))
        mha(base / "label_mha" / f"{i:05d}.mha", labels(rng, 3, IMAGE, "uint8"))


def build_jsrt(root):
    """Both annotation sets: PNG images of the first, BMP images of the second."""
    rng = np.random.default_rng(515)
    for split in ("train", "test"):
        for i in range(2):
            save_image(root / "Segmentation01" / split / "org" / f"case{i}.png", gray(rng))
            save_image(root / "Segmentation01" / split / "label" / f"case{i}.png", labels(rng, 3, IMAGE, "uint8"))
            save_image(root / "segmentation02" / f"org_{split}" / f"case{i}.bmp", gray(rng))
            save_image(root / "segmentation02" / f"label_{split}" / f"case{i}.png", labels(rng, 3, IMAGE, "uint8"))


def build_kvasir(root):
    """JPEG polyps and RGB JPEG masks, binarized on first use."""
    rng = np.random.default_rng(516)
    for i in range(3):
        save_image(root / "Kvasir-SEG" / "images" / f"case_{i}.jpg", rgb(rng))
        mask = binary(rng)
        save_image(root / "Kvasir-SEG" / "masks" / f"case_{i}.jpg", np.stack([mask] * 3, -1))


def build_m2caiseg(root):
    from torch_em_tpu.data.datasets.medical.m2caiseg import LABEL_MAPS

    rng = np.random.default_rng(517)
    for split, frames in (("train", (0, 1)), ("trainval", (0, 1, 2)), ("test", (5,))):
        for i in frames:
            save_image(root / "m2caiSeg dataset" / split / "images" / f"frame{i}.jpg", rgb(rng, (32, 32)))
            save_image(root / "m2caiSeg dataset" / split / "groundtruth" / f"frame{i}.png",
                       colours(rng, LABEL_MAPS, (32, 32)))


def build_montgomery(root):
    """Chest X-rays and left and right lung masks, merged on first use."""
    rng = np.random.default_rng(518)
    base = root / "MontgomerySet"
    for i in range(3):
        name = f"MCUCXR_{i:04d}_{i % 2}.png"
        save_image(base / "CXR_png" / name, gray(rng, (64, 48)))
        save_image(base / "ManualMask" / "leftMask" / name, binary(rng, (64, 48)))
        save_image(base / "ManualMask" / "rightMask" / name, binary(rng, (64, 48)))


def build_oimhs(root):
    """Per eye, scans of 512 columns of image beside 512 of colour-coded labels."""
    from torch_em_tpu.data.datasets.medical.oimhs import LABEL_MAPS

    rng = np.random.default_rng(519)
    for eye in range(6):
        for scan in range(2):
            scan_img = np.concatenate([rgb(rng, (32, 512)), colours(rng, list(LABEL_MAPS) + [(0, 0, 0)], (32, 512))],
                                      axis=1)
            save_image(root / "data" / "Images" / f"eye_{eye:02d}" / f"scan_{scan}.png", scan_img)


def build_palm(root):
    """JPEG fundus images and BMP masks that mark the structure with 0."""
    rng = np.random.default_rng(520)
    for split, n in (("Training", 3), ("Validation", 2)):
        for i in range(n):
            save_image(root / "PALM" / split / "Images" / f"P{i:04d}.jpg", rgb(rng))
            for sub in ("Disc Masks", "Lesion Masks/Atrophy"):
                mask = np.full(IMAGE, 255, "uint8")
                y, x = rng.integers(0, 40, 2)
                mask[y:y + 20, x:x + 16] = 0
                save_image(root / "PALM" / split / sub / f"P{i:04d}.bmp", mask)


def build_papila(root):
    """Fundus images and the experts' disc and cup contours, drawn as masks on first use."""
    rng = np.random.default_rng(521)
    base = root / "PapilaDB-PAPILA-17f8fa7746adb20275b5b6a0d99dc9dfe3007e9f"
    (base / "ExpertsSegmentations" / "Contours").mkdir(parents=True)
    for i in range(3):
        pid = f"RET{i:03d}OS"
        save_image(base / "FundusImages" / f"{pid}.jpg", rgb(rng))
        for task in ("disc", "cup"):
            for exp in ("exp1", "exp2"):
                t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
                contour = np.stack([32 + 14 * np.cos(t) + rng.uniform(-1, 1, 12),
                                    30 + 10 * np.sin(t) + rng.uniform(-1, 1, 12)], axis=1)
                np.savetxt(base / "ExpertsSegmentations" / "Contours" / f"{pid}_{task}_{exp}.txt", contour)


def build_piccolo(root):
    rng = np.random.default_rng(522)
    for split in ("train", "validation", "test"):
        for i in range(2):
            base = root / "piccolo dataset-release0.1" / split
            save_image(base / "polyps" / f"{split}_{i:03d}.png", rgb(rng))
            save_image(base / "masks" / f"{split}_{i:03d}.png", binary(rng))


def build_psfhs(root):
    rng = np.random.default_rng(523)
    for i in range(3):
        mha(root / "PSFHS" / "image_mha" / f"{i:05d}.mha", rgb(rng))
        mha(root / "PSFHS" / "label_mha" / f"{i:05d}.mha", labels(rng, 3, IMAGE, "uint8"))


def build_ravir(root):
    rng = np.random.default_rng(524)
    for i in range(3):
        save_image(root / "RAVIR_Dataset" / "train" / "training_images" / f"IR_Case_{i:03d}.png", gray(rng))
        save_image(root / "RAVIR_Dataset" / "train" / "training_masks" / f"IR_Case_{i:03d}.png",
                   (labels(rng, 3, IMAGE, "uint8") * 127).astype("uint8"))


def build_siim_acr(root):
    """Chest X-rays and masks; an empty mask and a full one, which the reader drops."""
    rng = np.random.default_rng(525)
    base = root / "siim-acr-pneumothorax"
    for split, n in (("train", 4), ("test", 3)):
        for i in range(n):
            name = f"{i}_{split}_{i}_.png"
            save_image(base / "png_images" / name, gray(rng))
            mask = binary(rng) if i else np.zeros(IMAGE, "uint8")
            if i == 2:
                mask[:] = 255
            save_image(base / "png_masks" / name, mask)


def build_uwaterloo_skin(root):
    rng = np.random.default_rng(526)
    for kind in ("melanoma", "not_melanoma"):
        for case in ("case1", "case2"):
            base = root / "set1_Data" / "skin_data" / kind / case
            save_image(base / f"{kind}_{case}_orig.jpg", rgb(rng))
            save_image(base / f"{kind}_{case}_contour.png", binary(rng))


RESIZE = dict(patch_shape=PATCH_2D, resize_inputs=True)

CASES = [
    MedCase("abus", build_abus,
            paths=[("get_abus_paths", {}), ("get_abus_paths", dict(category="malign", image_choice="fuzzy"))],
            datasets=[("get_abus_dataset", dict(patch_shape=PATCH_2D)),
                      ("get_abus_dataset", dict(category="malign", **RESIZE))],
            loaders=[("get_abus_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    MedCase("amd_sd", build_amd_sd,
            paths=[("get_amd_sd_paths", dict(split="train"))],
            datasets=[("get_amd_sd_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_amd_sd_dataset", dict(split="train", **RESIZE))],
            loaders=[("get_amd_sd_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    MedCase("busi", build_busi,
            paths=[("get_busi_paths", {}), ("get_busi_paths", dict(category="malignant"))],
            datasets=[("get_busi_dataset", dict(patch_shape=PATCH_2D)),
                      ("get_busi_dataset", dict(category="benign", **RESIZE))],
            loaders=[("get_busi_loader", dict(patch_shape=PATCH_2D, batch_size=2, category="benign"))]),
    MedCase("cbis_ddsm", build_cbis_ddsm,
            paths=[("get_cbis_ddsm_paths", dict(split="Val")), ("get_cbis_ddsm_paths", dict(split="Test", task="Mass")),
                   ("get_cbis_ddsm_paths", dict(split="Val", tumour_type="MALIGNANT", ignore_mismatching_pairs=True))],
            datasets=[("get_cbis_ddsm_dataset", dict(patch_shape=(48, 48), split="Val", task="Calc",
                                                     tumour_type="BENIGN")),
                      ("get_cbis_ddsm_dataset", dict(split="Val", **RESIZE))],
            loaders=[("get_cbis_ddsm_loader", dict(split="Test", batch_size=2, **RESIZE))]),
    MedCase("cholecseg8k", build_cholecseg8k,
            paths=[("get_cholecseg8k_paths", dict(split="train")), ("get_cholecseg8k_paths", dict(split="val")),
                   ("get_cholecseg8k_paths", dict(split="test"))],
            datasets=[("get_cholecseg8k_dataset", dict(patch_shape=PATCH_2D, split="val")),
                      ("get_cholecseg8k_dataset", dict(split="train", **RESIZE))],
            loaders=[("get_cholecseg8k_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="test"))]),
    MedCase("covid_qu_ex", build_covid_qu_ex,
            paths=[("get_covid_qu_ex_paths", dict(split="train", task="lung")),
                   ("get_covid_qu_ex_paths", dict(split="val", task="infection", patient_type="covid19",
                                                  segmentation_mask="infection"))],
            datasets=[("get_covid_qu_ex_dataset", dict(patch_shape=PATCH_2D, split="train", task="lung")),
                      ("get_covid_qu_ex_dataset", dict(split="val", task="infection", segmentation_mask="infection",
                                                       **RESIZE))],
            loaders=[("get_covid_qu_ex_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train", task="lung",
                                                     patient_type="normal"))]),
    MedCase("dca1", build_dca1,
            paths=[("get_dca1_paths", dict(split="train"))],
            datasets=[("get_dca1_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_dca1_dataset", dict(split="train", **RESIZE))],
            loaders=[("get_dca1_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    MedCase("drive", build_drive,
            paths=[("get_drive_paths", dict(split="train"))],
            datasets=[("get_drive_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_drive_dataset", dict(split="train", **RESIZE))],
            loaders=[("get_drive_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    MedCase("dsad", build_dsad,
            paths=[("get_dsad_paths", {}), ("get_dsad_paths", dict(organ="liver"))],
            datasets=[("get_dsad_dataset", dict(patch_shape=PATCH_2D)),
                      ("get_dsad_dataset", dict(organ="pancreas", **RESIZE))],
            loaders=[("get_dsad_loader", dict(patch_shape=PATCH_2D, batch_size=2, organ="liver"))]),
    MedCase("fundus_avseg", build_fundus_avseg,
            paths=[("get_fundus_avseg_paths", dict(split="train")), ("get_fundus_avseg_paths", dict(split="val")),
                   ("get_fundus_avseg_paths", dict(split="test"))],
            datasets=[("get_fundus_avseg_dataset", dict(patch_shape=(24, 24), split="val")),
                      ("get_fundus_avseg_dataset", dict(split="test", **RESIZE))],
            loaders=[("get_fundus_avseg_loader", dict(patch_shape=(24, 24), batch_size=2, split="val"))]),
    MedCase("hil_toothseg", build_hil_toothseg,
            paths=[("get_hil_toothseg_paths", dict(split="train")), ("get_hil_toothseg_paths", dict(split="test"))],
            datasets=[("get_hil_toothseg_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_hil_toothseg_dataset", dict(split="train", **RESIZE))],
            loaders=[("get_hil_toothseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    MedCase("idrid", build_idrid,
            paths=[("get_idrid_paths", dict(split="train", task="optic_disc")),
                   ("get_idrid_paths", dict(split="test", task="hard_exudates"))],
            datasets=[("get_idrid_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_idrid_dataset", dict(split="test", task="hard_exudates", **RESIZE))],
            loaders=[("get_idrid_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train"))]),
    MedCase("isic", build_isic,
            paths=[("get_isic_paths", dict(split="train")), ("get_isic_paths", dict(split="val"))],
            datasets=[("get_isic_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_isic_dataset", dict(patch_shape=PATCH_2D, split="val", resize_inputs=False))],
            loaders=[("get_isic_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    MedCase("jnuifm", build_jnuifm,
            paths=[("get_jnuifm_paths", {})],
            datasets=[("get_jnuifm_dataset", dict(patch_shape=PATCH_2D)), ("get_jnuifm_dataset", RESIZE)],
            loaders=[("get_jnuifm_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    MedCase("jsrt", build_jsrt,
            paths=[("get_jsrt_paths", dict(split="train")),
                   ("get_jsrt_paths", dict(split="test", choice="Segmentation02"))],
            datasets=[("get_jsrt_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_jsrt_dataset", dict(split="test", choice="Segmentation01", **RESIZE))],
            loaders=[("get_jsrt_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train",
                                              choice="Segmentation01"))]),
    MedCase("kvasir", build_kvasir,
            paths=[("get_kvasir_paths", {})],
            datasets=[("get_kvasir_dataset", dict(patch_shape=PATCH_2D)), ("get_kvasir_dataset", RESIZE)],
            loaders=[("get_kvasir_loader", dict(patch_shape=PATCH_2D, batch_size=1))]),
    MedCase("m2caiseg", build_m2caiseg,
            paths=[("get_m2caiseg_paths", dict(split="train")), ("get_m2caiseg_paths", dict(split="val")),
                   ("get_m2caiseg_paths", dict(split="test"))],
            datasets=[("get_m2caiseg_dataset", dict(patch_shape=(24, 24), split="train")),
                      ("get_m2caiseg_dataset", dict(split="val", **RESIZE))],
            loaders=[("get_m2caiseg_loader", dict(patch_shape=(24, 24), batch_size=2, split="train"))]),
    MedCase("montgomery", build_montgomery,
            paths=[("get_montgomery_paths", {})],
            datasets=[("get_montgomery_dataset", dict(patch_shape=PATCH_2D)),
                      ("get_montgomery_dataset", dict(patch_shape=PATCH_2D, resize_inputs=False))],
            loaders=[("get_montgomery_loader", dict(patch_shape=PATCH_2D, batch_size=1))]),
    MedCase("oimhs", build_oimhs,
            paths=[("get_oimhs_paths", dict(split="train")), ("get_oimhs_paths", dict(split="test"))],
            datasets=[("get_oimhs_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_oimhs_dataset", dict(split="val", **RESIZE))],
            loaders=[("get_oimhs_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    MedCase("palm", build_palm,
            paths=[("get_palm_paths", dict(split="Training")),
                   ("get_palm_paths", dict(split="Validation", label_choice="atrophy_lesion"))],
            datasets=[("get_palm_dataset", dict(patch_shape=PATCH_2D, split="Training")),
                      ("get_palm_dataset", dict(split="Validation", **RESIZE))],
            loaders=[("get_palm_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="Training"))]),
    MedCase("piccolo", build_piccolo,
            paths=[("get_piccolo_paths", dict(split="train")), ("get_piccolo_paths", dict(split="validation"))],
            datasets=[("get_piccolo_dataset", dict(patch_shape=PATCH_2D, split="test")),
                      ("get_piccolo_dataset", dict(split="train", **RESIZE))],
            loaders=[("get_piccolo_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    MedCase("psfhs", build_psfhs,
            paths=[("get_psfhs_paths", dict(split="train"))],
            datasets=[("get_psfhs_dataset", dict(patch_shape=PATCH_2D, split="train")),
                      ("get_psfhs_dataset", dict(split="train", **RESIZE))],
            loaders=[("get_psfhs_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    MedCase("ravir", build_ravir,
            paths=[("get_ravir_paths", {})],
            datasets=[("get_ravir_dataset", dict(patch_shape=PATCH_2D)), ("get_ravir_dataset", RESIZE)],
            loaders=[("get_ravir_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    MedCase("siim_acr", build_siim_acr,
            paths=[("get_siim_acr_paths", dict(split="val")), ("get_siim_acr_paths", dict(split="test"))],
            datasets=[("get_siim_acr_dataset", dict(patch_shape=PATCH_2D, split="val")),
                      ("get_siim_acr_dataset", dict(split="test", **RESIZE))],
            loaders=[("get_siim_acr_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="val"))]),
    MedCase("uwaterloo_skin", build_uwaterloo_skin,
            paths=[("get_uwaterloo_skin_paths", {})],
            datasets=[("get_uwaterloo_skin_dataset", dict(patch_shape=PATCH_2D)),
                      ("get_uwaterloo_skin_dataset", RESIZE)],
            loaders=[("get_uwaterloo_skin_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
]

PAPILA = MedCase("papila", build_papila,
                 paths=[("get_papila_paths", dict(split="train")),
                        ("get_papila_paths", dict(split="train", task="cup", expert_choice="exp2"))],
                 datasets=[("get_papila_dataset", dict(patch_shape=PATCH_2D, split="train")),
                           ("get_papila_dataset", dict(split="train", task="cup", **RESIZE))],
                 loaders=[("get_papila_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_papila_matches_jax(tmp_path, monkeypatch):
    """PAPILA draws the contours on a canvas of the published image shape, (1934, 2576): here both
    packages draw on the test images' shape."""
    import torch_em_tpu.data.datasets.medical.papila as jax_papila
    import torch_em_tpu_torch.data.datasets.medical.papila as port_papila

    for module in (jax_papila, port_papila):
        monkeypatch.setattr(module, "_INPUT_SHAPE", IMAGE + (3,))
    check_case(PAPILA, tmp_path)
