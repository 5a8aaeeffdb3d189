"""The port's dataset zoo, medical (the 3-D readers of NIfTI, MetaImage and NRRD volumes, which run
on the card through the port's pure-numpy ``utils/medical_io.py``), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): paths, ``len``, samples under one
``np.random.seed``, loader batch shapes, and every file under both folders equal afterwards (a
``.nii.gz`` file by its decompressed bytes), so that what a reader converts is compared too:
HaN-Seg's merged organ masks and SegA's volumes from NRRD, LEG 3D US's relabelled masks, ToothFairy
v1's volumes from ``.npy``, CURVAS's HDF5 files (CPU-only on the card). ``load_nifti`` returns
nibabel's (X, Y, Z) order, so 3-D patch shapes are given in the order the volumes were saved in.

LEG 3D US's reader finds each label file by making every "x" of the volume's path "masksX"; the
JAX package's does so in the whole path, the port's in the file's name only. Its case calls both in
folders named without an "x", and a test holds the port's reader in a folder named with one.
"""

import numpy as np
import pytest

from torch_em_tpu.utils.medical_io import save_mha, save_nifti, save_nrrd
from torch_zoo_layouts import (MEDICAL, PATCH_3D, VOLUME, MedCase, check_case, labels, modules, save_tif, zip_folder)
from torch_zoo_layouts import no_network  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("no_network")

SMALL = (8, 48, 48)


def vol(rng, shape=VOLUME):
    return rng.random(shape).astype("float32")


def lab(rng, high, shape=VOLUME):
    return labels(rng, high, shape, "uint8")


def nii(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    save_nifti(str(path), array)


def mha(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    save_mha(str(path), array)


def nrrd(path, array):
    """NRRD without compression: the gzip header would hold the time it was written."""
    path.parent.mkdir(parents=True, exist_ok=True)
    save_nrrd(str(path), array, compressed=False)


def build_amos(root):
    """CT (ids under 500) and MRI volumes of the train and val folders."""
    rng = np.random.default_rng(401)
    for split, ids in (("Tr", (1, 2, 507)), ("Va", (3, 508))):
        for pid in ids:
            nii(root / "amos22" / f"images{split}" / f"amos_{pid:04d}.nii.gz", (vol(rng) * 2000 - 1000).astype("int16"))
            nii(root / "amos22" / f"labels{split}" / f"amos_{pid:04d}.nii.gz", lab(rng, 16))


def build_btcv(root):
    """The abdomen extracted and the cervix as its zip."""
    rng = np.random.default_rng(402)
    for region in ("Abdomen", "Cervix"):
        base = root / ("src" if region == "Cervix" else region) / "RawData" / "Training"
        for i in (1, 2):
            nii(base / "img" / f"img{i:04d}.nii.gz", vol(rng))
            nii(base / "label" / f"label{i:04d}.nii.gz", lab(rng, 5))
    zip_folder(root / "src" / "RawData", root / "Cervix.zip", root / "src")
    (root / "src").rmdir()


def build_acdc(root):
    rng = np.random.default_rng(403)
    for split, pids in (("training", (1, 2, 10)), ("testing", (101,))):
        for pid in pids:
            base = root / "ACDC" / "database" / split / f"patient{pid:03d}"
            nii(base / f"patient{pid:03d}_4d.nii.gz", vol(rng, (4, 16, 16)))
            for frame in (1, 12):
                nii(base / f"patient{pid:03d}_frame{frame:02d}.nii.gz", vol(rng))
                nii(base / f"patient{pid:03d}_frame{frame:02d}_gt.nii.gz", lab(rng, 4))


def build_msd(root):
    """Three extracted tasks, the brain tumours with four channels first."""
    rng = np.random.default_rng(404)
    for task, folder, channels in (("spleen", "Task09_Spleen", ()), ("heart", "Task02_Heart", ()),
                                   ("braintumour", "Task01_BrainTumour", (4,))):
        base = root / "data" / task / folder
        for i in range(2):
            nii(base / "imagesTr" / f"{task}_{i:02d}.nii.gz", vol(rng, channels + VOLUME))
            nii(base / "labelsTr" / f"{task}_{i:02d}.nii.gz", lab(rng, 3))


def build_han_seg(root):
    """Per case the CT, an MR volume (skipped) and per-organ masks, merged into one label volume."""
    rng = np.random.default_rng(405)
    for case in ("case_01", "case_02", "case_10"):
        base = root / "HaN-Seg" / "set_1" / case
        nrrd(base / f"{case}_IMG_CT.nrrd", (vol(rng) * 1000).astype("int16"))
        nrrd(base / f"{case}_IMG_MR_T1.nrrd", vol(rng))
        for organ in ("OAR_A_Carotid_L", "OAR_Bone_Mandible", "OAR_Glnd_Thyroid"):
            nrrd(base / f"{case}_{organ}.nrrd", (rng.random(VOLUME) > 0.8).astype("uint8"))


def build_leg_3d_us(root):
    """Volumes and masks with the muscles' ids 100, 150 and 200 among others, and the validation
    split as its zip."""
    rng = np.random.default_rng(406)
    for split, cases in (("train", ("S1", "S2")), ("val", ("S3",))):
        base = root / ("src" if split == "val" else "") / split
        for case in cases:
            for i in (1, 2):
                mha(base / case / f"x{i:03d}.mha", vol(rng))
                mha(base / case / f"masksX{i:03d}.mha", rng.choice([0, 50, 100, 150, 200], VOLUME).astype("uint8"))
    zip_folder(root / "src" / "val", root / "leg_val_data.zip", root / "src")
    (root / "src").rmdir()


def build_sega(root):
    """KiTS' cases: the volume and a 3D Slicer segmentation with a layer axis."""
    rng = np.random.default_rng(407)
    for case in ("K1", "K2", "K11"):
        nrrd(root / "KiTS" / case / f"{case}.nrrd", vol(rng))
        nrrd(root / "KiTS" / case / f"{case}.seg.nrrd", lab(rng, 2, (1,) + VOLUME))


def build_segthy(root):
    """MRI (thyroid, and thyroid with vessels) and ultrasound, in (X, Y, Z) order."""
    rng = np.random.default_rng(408)
    mri = root / "MRI_volunteer_dataset"
    for i in range(3):
        nii(mri / "MRI" / f"{i:03d}_MRI.nii.gz", vol(rng, (64, 64, 8)))
        nii(mri / "MRI_thyroid_label" / f"{i:03d}_MRI_thyroid_label.nii.gz", lab(rng, 2, (64, 64, 8)))
        nii(mri / "MRI_thyroid+jugular+carotid_label" / f"{i:03d}_MRI_thyroid+jugular+carotid_label.nii.gz",
            lab(rng, 4, (64, 64, 8)))
    us = root / "US_volunteer_dataset" / "ground_truth_data"
    for i in range(2):
        nii(us / "US" / f"{i:03d}_US.nii", vol(rng, (64, 64, 8)))
        nii(us / "US_thyroid_label" / f"{i:03d}.nii", lab(rng, 2, (64, 64, 8)))


def build_autopet(root):
    rng = np.random.default_rng(409)
    for pid in range(2):
        base = root / "AutoPET-II" / "FDG-PET-CT-Lesions" / f"PETCT_{pid}" / "study0"
        nii(base / "CTres.nii.gz", vol(rng))
        nii(base / "SUV.nii.gz", vol(rng))
        nii(base / "SEG.nii.gz", lab(rng, 2))


def build_camus(root):
    rng = np.random.default_rng(410)
    for pid in (1, 2):
        base = root / "database_nifti" / f"patient{pid:04d}"
        for ch in ("2CH", "4CH"):
            nii(base / f"patient{pid:04d}_{ch}_half_sequence.nii.gz", vol(rng))
            nii(base / f"patient{pid:04d}_{ch}_half_sequence_gt.nii.gz", lab(rng, 4))


def build_covid19_seg(root):
    rng = np.random.default_rng(411)
    for i in (1, 2, 10):
        nii(root / "images" / "COVID-19-CT-Seg_20cases" / f"coronacases_{i:03d}.nii.gz", vol(rng))
        nii(root / "gt" / "Lung_Mask" / f"coronacases_{i:03d}.nii.gz", lab(rng, 3))
        nii(root / "gt" / "Infection_Mask" / f"coronacases_{i:03d}.nii.gz", lab(rng, 2))


def build_ct_cadaiver(root):
    rng = np.random.default_rng(412)
    for i in range(2):
        nii(root / "CadAIver study" / "Images" / f"case{i}.nii.gz", vol(rng))
        nii(root / "CadAIver study" / "Segmentations" / f"case{i}_seg.nii.gz", lab(rng, 5))


def build_curvas(root):
    """Per patient the volume and three raters' annotations (as floats), in (X, Y, Z) order."""
    rng = np.random.default_rng(413)
    for pid in ("UKCHLL001", "UKCHLL002"):
        base = root / "training_set" / pid
        nii(base / "image.nii.gz", vol(rng, (64, 64, 8)))
        for i in (1, 2, 3):
            nii(base / f"annotation_{i}.nii.gz", lab(rng, 4, (64, 64, 8)).astype("float32"))


def build_feta24(root):
    """The manually downloaded zip."""
    rng = np.random.default_rng(414)
    for sid in (1, 2):
        base = root / "feta_2.3" / f"sub-{sid:03d}" / "anat"
        nii(base / f"sub-{sid:03d}_rec-mial_T2w.nii.gz", vol(rng))
        nii(base / f"sub-{sid:03d}_rec-mial_dseg.nii.gz", lab(rng, 8))
    zip_folder(root / "feta_2.3", root / "feta_2.3.zip", root)


def build_isles(root):
    rng = np.random.default_rng(415)
    for case in ("sub-strokecase0001", "sub-strokecase0002"):
        base = root / "ISLES-2022" / case / "ses-0001" / "dwi"
        for mod in ("dwi", "adc"):
            nii(base / f"{case}_ses-0001_{mod}.nii.gz", vol(rng))
        nii(root / "ISLES-2022" / "derivatives" / case / "ses-0001" / f"{case}_ses-0001_msk.nii.gz", lab(rng, 2))


def build_mbh_seg(root):
    rng = np.random.default_rng(416)
    for i in range(2):
        nii(root / "label_192" / "images" / f"ID_{i}.nii.gz", vol(rng))
        nii(root / "label_192" / "ground truths" / f"ID_{i}.nii.gz", lab(rng, 6))


def build_mice_tumseg(root):
    rng = np.random.default_rng(417)
    for dataset, mice in (("Dataset A", (0, 1)), ("Dataset B", (2,))):
        for i in mice:
            base = root / "TumSeg database" / dataset / f"mouse{i}"
            nii(base / f"CT_{i}.nii.gz", vol(rng))
            for rater in ("Annotator_A", "Annotator_B", "Annotator_C", "STAPLE"):
                nii(base / f"{rater}_{i}.nii.gz", lab(rng, 2))


def build_micro_usp(root):
    rng = np.random.default_rng(418)
    base = root / "Micro_Ultrasound_Prostate_Segmentation_Dataset"
    for split, n in (("train", 7), ("test", 2)):
        for i in range(n):
            nii(base / split / "micro_ultrasound_scans" / f"microUS_{split}_{i:02d}.nii.gz", vol(rng, SMALL))
            nii(base / split / "expert_annotations" / f"microUS_{split}_gt_{i:02d}.nii.gz", lab(rng, 2, SMALL))


def build_motum(root):
    """Subjects with FLAIR and T1ce volumes and labels; sub-0030 has labels but no volumes."""
    rng = np.random.default_rng(419)
    for i in (1, 2, 3, 30, 31, 32, 33):
        name = f"sub-{i:04d}"
        for modality in ("flair", "t1ce"):
            if i not in (30, 31, 32):
                nii(root / name / "anat" / f"{name}_{modality}.nii.gz", vol(rng, SMALL))
            nii(root / "derivatives" / name / f"{modality}_seg_{name}.nii.gz", lab(rng, 2, SMALL))


def build_oasis(root):
    rng = np.random.default_rng(420)
    for i in range(3):
        base = root / "data" / f"OASIS_OAS1_{i:04d}_MR1"
        for stem in ("orig", "norm"):
            nii(base / f"{stem}.nii.gz", vol(rng, SMALL))
        for ann in ("4", "35"):
            nii(base / f"seg{ann}.nii.gz", lab(rng, 5, SMALL))


def build_spider(root):
    rng = np.random.default_rng(421)
    for i in (1, 2, 10):
        for seq in ("t1", "t2"):
            mha(root / "data" / "images" / f"{i}_{seq}.mha", vol(rng))
            mha(root / "data" / "masks" / f"{i}_{seq}.mha", lab(rng, 5))


def build_toothfairy(root):
    """Version 2's MetaImage folders, and version 1's patient folders of ``.npy`` volumes (one with
    sparse annotations only, which the reader skips)."""
    rng = np.random.default_rng(422)
    v2 = root / "Dataset112_ToothFairy2"
    for i in range(3):
        mha(v2 / "imagesTr" / f"ToothFairy2F_{i:03d}_0000.mha", vol(rng))
        mha(v2 / "labelsTr" / f"ToothFairy2F_{i:03d}.mha", lab(rng, 4))
    v1 = root / "ToothFairy_Dataset" / "Dataset"
    for pid in ("P1", "P2", "P10", "P3"):
        (v1 / pid).mkdir(parents=True)
        np.save(v1 / pid / "data.npy", vol(rng))
        if pid != "P3":
            np.save(v1 / pid / "gt_alpha.npy", lab(rng, 2))


def build_verse(root):
    rng = np.random.default_rng(423)
    for split, subs in (("train", ("sub-verse004", "sub-verse005")), ("test", ("sub-verse012",))):
        for sub in subs:
            nii(root / "data" / split / "rawdata" / sub / f"{sub}_ct.nii.gz", vol(rng))
            nii(root / "data" / split / "derivatives" / sub / f"{sub}_seg-vert_msk.nii.gz", lab(rng, 5))


def build_acouslic_ai(root):
    rng = np.random.default_rng(424)
    for i in range(2):
        mha(root / "data" / "images" / "stacked_fetal_ultrasound" / f"case{i}.mha", vol(rng))
        mha(root / "data" / "masks" / "stacked_fetal_abdomen" / f"case{i}.mha", lab(rng, 3))


def build_pengwin(root):
    """CT volumes as MetaImage, X-ray images as TIFF."""
    rng = np.random.default_rng(425)
    for i in range(2):
        mha(root / "data" / "CT" / "images" / f"{i:03d}.mha", vol(rng))
        mha(root / "data" / "CT" / "labels" / f"{i:03d}.mha", lab(rng, 5))
        save_tif(root / "data" / "X-Ray" / "train" / "input" / "images" / f"{i:03d}.tif",
                 (rng.random((64, 64)) * 65535).astype("uint16"))
        save_tif(root / "data" / "X-Ray" / "train" / "output" / "images" / f"{i:03d}.tif", lab(rng, 5, (64, 64)))


P3 = dict(patch_shape=PATCH_3D)

CASES = [
    MedCase("amos", build_amos,
            paths=[("get_amos_paths", dict(split="train")), ("get_amos_paths", dict(split="train", modality="CT")),
                   ("get_amos_paths", dict(split="val", modality="mri"))],
            datasets=[("get_amos_dataset", dict(split="train", modality="CT", **P3)),
                      ("get_amos_dataset", dict(split="val", **P3))],
            loaders=[("get_amos_loader", dict(split="train", modality="CT", batch_size=1, **P3))]),
    MedCase("btcv", build_btcv,
            paths=[("get_btcv_paths", dict(anatomy="Cervix")), ("get_btcv_paths", {}),
                   ("get_btcv_paths", dict(anatomy="Abdomen"))],
            datasets=[("get_btcv_dataset", P3), ("get_btcv_dataset", dict(anatomy=["Cervix"], **P3))],
            loaders=[("get_btcv_loader", dict(batch_size=1, anatomy="Abdomen", **P3))]),
    MedCase("acdc", build_acdc,
            paths=[("get_acdc_paths", dict(split="train")), ("get_acdc_paths", dict(split="test"))],
            datasets=[("get_acdc_dataset", dict(split="train", **P3)), ("get_acdc_dataset", dict(split="test", **P3))],
            loaders=[("get_acdc_loader", dict(split="train", batch_size=2, **P3))]),
    MedCase("msd", build_msd,
            datasets=[("get_msd_dataset", dict(task_names="spleen", **P3)),
                      ("get_msd_dataset", dict(task_names=["spleen", "heart"], **P3)),
                      ("get_msd_dataset", dict(task_names="braintumour", **P3))],
            loaders=[("get_msd_loader", dict(task_names="heart", batch_size=1, **P3)),
                     ("get_msd_loader", dict(task_names="braintumour", batch_size=2, **P3))]),
    MedCase("han_seg", build_han_seg,
            paths=[("get_han_seg_paths", {})],
            datasets=[("get_han_seg_dataset", P3)],
            loaders=[("get_han_seg_loader", dict(batch_size=1, **P3))]),
    MedCase("leg_3d_us", build_leg_3d_us, relative=True,
            paths=[("get_leg_3d_us_paths", dict(split="train")), ("get_leg_3d_us_paths", dict(split="val"))],
            datasets=[("get_leg_3d_us_dataset", dict(split="train", **P3))],
            loaders=[("get_leg_3d_us_loader", dict(split="val", batch_size=1, **P3))]),
    MedCase("sega", build_sega,
            paths=[("get_sega_paths", dict(data_choice="kits"))],
            datasets=[("get_sega_dataset", dict(data_choice="kits", **P3))],
            loaders=[("get_sega_loader", dict(data_choice="kits", batch_size=1, **P3))]),
    MedCase("segthy", build_segthy,
            paths=[("get_segthy_paths", dict(split="train", source="MRI")),
                   ("get_segthy_paths", dict(split="train", source="MRI", region="thyroid_and_vessels")),
                   ("get_segthy_paths", dict(split="train", source="US"))],
            datasets=[("get_segthy_dataset", dict(patch_shape=(32, 32, 4), split="train", source="MRI")),
                      ("get_segthy_dataset", dict(patch_shape=(32, 32, 4), split="train", source="US"))],
            loaders=[("get_segthy_loader", dict(patch_shape=(32, 32, 4), split="train", source="MRI",
                                                batch_size=1))]),
    MedCase("autopet", build_autopet,
            paths=[("get_autopet_paths", {}), ("get_autopet_paths", dict(modality="PET"))],
            datasets=[("get_autopet_dataset", dict(modality="CT", **P3)), ("get_autopet_dataset", P3)],
            loaders=[("get_autopet_loader", dict(batch_size=1, **P3))]),
    MedCase("camus", build_camus,
            paths=[("get_camus_paths", {}), ("get_camus_paths", dict(chamber=2))],
            datasets=[("get_camus_dataset", P3), ("get_camus_dataset", dict(chamber=4, **P3))],
            loaders=[("get_camus_loader", dict(batch_size=1, chamber=4, **P3))]),
    MedCase("covid19_seg", build_covid19_seg,
            paths=[("get_covid19_seg_paths", dict(task="lung")), ("get_covid19_seg_paths", dict(task="infection"))],
            datasets=[("get_covid19_seg_dataset", P3), ("get_covid19_seg_dataset", dict(task="infection", **P3))],
            loaders=[("get_covid19_seg_loader", dict(batch_size=1, **P3))]),
    MedCase("ct_cadaiver", build_ct_cadaiver,
            paths=[("get_ct_cadaiver_paths", {})],
            datasets=[("get_ct_cadaiver_dataset", P3)],
            loaders=[("get_ct_cadaiver_loader", dict(batch_size=1, **P3))]),
    MedCase("curvas", build_curvas,
            paths=[("get_curvas_paths", {})],
            datasets=[("get_curvas_dataset", P3), ("get_curvas_dataset", dict(rater="3", **P3))],
            loaders=[("get_curvas_loader", dict(batch_size=1, rater="2", **P3))],
            converted=["training_set/UKCHLL001/data.h5", "training_set/UKCHLL002/data.h5"]),
    MedCase("feta24", build_feta24,
            paths=[("get_feta24_paths", {})],
            datasets=[("get_feta24_dataset", P3)],
            loaders=[("get_feta24_loader", dict(batch_size=1, **P3))]),
    MedCase("isles", build_isles,
            paths=[("get_isles_paths", {}), ("get_isles_paths", dict(modality="adc"))],
            datasets=[("get_isles_dataset", P3), ("get_isles_dataset", dict(modality="adc", **P3))],
            loaders=[("get_isles_loader", dict(batch_size=1, **P3))]),
    MedCase("mbh_seg", build_mbh_seg,
            paths=[("get_mbh_seg_paths", {})],
            datasets=[("get_mbh_seg_dataset", P3)],
            loaders=[("get_mbh_seg_loader", dict(batch_size=1, **P3))]),
    MedCase("mice_tumseg", build_mice_tumseg,
            paths=[("get_mice_tumseg_paths", {}), ("get_mice_tumseg_paths", dict(rater="STAPLE"))],
            datasets=[("get_mice_tumseg_dataset", P3), ("get_mice_tumseg_dataset", dict(rater="C", **P3))],
            loaders=[("get_mice_tumseg_loader", dict(batch_size=1, rater="B", **P3))]),
    MedCase("micro_usp", build_micro_usp,
            paths=[("get_micro_usp_paths", dict(split="train")), ("get_micro_usp_paths", dict(split="val")),
                   ("get_micro_usp_paths", dict(split="test"))],
            datasets=[("get_micro_usp_dataset", dict(split="train", **P3)),
                      ("get_micro_usp_dataset", dict(split="test", **P3))],
            loaders=[("get_micro_usp_loader", dict(split="val", batch_size=1, **P3))]),
    MedCase("motum", build_motum,
            paths=[("get_motum_paths", dict(split="train")), ("get_motum_paths", dict(split="train", modality="t1ce"))],
            datasets=[("get_motum_dataset", dict(split="train", **P3))],
            loaders=[("get_motum_loader", dict(split="train", batch_size=1, **P3))]),
    MedCase("oasis", build_oasis,
            paths=[("get_oasis_paths", dict(split="train")),
                   ("get_oasis_paths", dict(split="train", source="norm", label_annotations="35")),
                   ("get_oasis_paths", dict(split="val"))],
            datasets=[("get_oasis_dataset", dict(split="train", **P3))],
            loaders=[("get_oasis_loader", dict(split="train", batch_size=1, **P3))]),
    MedCase("spider", build_spider,
            paths=[("get_spider_paths", {})],
            datasets=[("get_spider_dataset", P3)],
            loaders=[("get_spider_loader", dict(batch_size=2, **P3))]),
    MedCase("toothfairy", build_toothfairy,
            paths=[("get_toothfairy_paths", dict(split="train")),
                   ("get_toothfairy_paths", dict(split="train", version="v1")),
                   ("get_toothfairy_paths", dict(split="val", version="v1"))],
            datasets=[("get_toothfairy_dataset", dict(split="train", **P3)),
                      ("get_toothfairy_dataset", dict(split="train", version="v1", **P3))],
            loaders=[("get_toothfairy_loader", dict(split="train", batch_size=1, **P3))]),
    MedCase("verse", build_verse,
            paths=[("get_verse_paths", dict(split="train")), ("get_verse_paths", dict(split="test"))],
            datasets=[("get_verse_dataset", dict(split="train", **P3))],
            loaders=[("get_verse_loader", dict(split="test", batch_size=1, **P3))]),
    MedCase("acouslic_ai", build_acouslic_ai,
            paths=[("get_acouslic_ai_paths", {})],
            datasets=[("get_acouslic_ai_dataset", P3)],
            loaders=[("get_acouslic_ai_loader", dict(batch_size=1, **P3))]),
    MedCase("pengwin", build_pengwin,
            paths=[("get_pengwin_paths", dict(modality="CT")), ("get_pengwin_paths", dict(modality="X-Ray"))],
            datasets=[("get_pengwin_dataset", dict(modality="CT", **P3)),
                      ("get_pengwin_dataset", dict(patch_shape=(32, 32), modality="X-Ray"))],
            loaders=[("get_pengwin_loader", dict(modality="CT", batch_size=1, **P3)),
                     ("get_pengwin_loader", dict(patch_shape=(32, 32), modality="X-Ray", batch_size=2))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_leg_3d_us_in_a_folder_named_with_x(tmp_path):
    """The port finds LEG 3D US's labels whatever the folders are called; the JAX package looks for
    them in a folder that does not exist once the path holds an "x" before the file's name."""
    root = tmp_path / "xdata"
    build_leg_3d_us(root)
    jax_mod, port_mod = modules("leg_3d_us", MEDICAL)
    raw_paths, label_paths = port_mod.get_leg_3d_us_paths(str(root), "train")
    assert [p.split("/")[-1] for p in label_paths] == ["masksX001_preprocessed.mha", "masksX002_preprocessed.mha"] * 2
    assert all(p.startswith(str(root)) for p in label_paths)
    assert set(np.unique(np.concatenate([np.ravel(port_mod.load_mha(p)) for p in label_paths]))) <= {0, 1, 2, 3}
    with pytest.raises(FileNotFoundError):
        jax_mod.get_leg_3d_us_paths(str(root), "train")
