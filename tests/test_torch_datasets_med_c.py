"""The port's dataset zoo, medical (the readers whose conversions need pydicom or a download through
``git`` and the KiTS23 command line, SA-Med2D's sharded conversion, and LGG-MRI's HDF5 volumes),
against the JAX package's, and the medical module lists.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``). Where a conversion reads DICOM (CHAOS,
Duke Liver, 3D-IRCADb, OSIC, PLETHORA) the case starts from the converted layout, or, for CHAOS,
from PNG slices, which its reader takes without pydicom; a test holds that the JAX package raises for
the missing pydicom where the port converts the DICOM files with its own reader. KiTS23's, LGG-MRI's
and SA-Med2D's conversions run through the reader's own function on both sides (``prepare``): KiTS23
splits its cases with sklearn's ``train_test_split`` (seeded) in the JAX package and with the port's
numpy copy; SA-Med2D resizes through ``transforms/generic.py:ResizeLongestSideInputs`` and relabels
with ``ops/host.relabel_consecutive``.
"""

import json
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

import torch_em_tpu.data.datasets.medical as jax_med
import torch_em_tpu_torch.data.datasets.medical as port_med
from torch_em_tpu.utils.medical_io import save_nifti
from torch_zoo_layouts import (IMAGE, MEDICAL, PATCH_3D, VOLUME, MedCase, check_case, check_domain_matches_jax,
                               check_every_module_has_a_case, labels, modules, raw, save_image, save_tif, write_h5)
from torch_zoo_layouts import no_network  # noqa: F401 (the fixture of pytestmark)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_conversion_layouts as layouts  # noqa: E402

pytestmark = pytest.mark.usefixtures("no_network")


def nii(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    save_nifti(str(path), array)


def vol(rng, shape=VOLUME):
    return rng.random(shape).astype("float32")


def build_chaos(root):
    """CT and MR slices as PNG per patient (the DICOM reader is pydicom's)."""
    rng = np.random.default_rng(601)
    base = root / "data" / "Train_Sets"
    for uid in ("1", "2"):
        pairs = [(base / "CT" / uid / "DICOM_anon", base / "CT" / uid / "Ground"),
                 (base / "MR" / uid / "T1DUAL" / "DICOM_anon" / "InPhase", base / "MR" / uid / "T1DUAL" / "Ground"),
                 (base / "MR" / uid / "T2SPIR" / "DICOM_anon", base / "MR" / uid / "T2SPIR" / "Ground")]
        for image_dir, gt_dir in pairs:
            for i in range(8):
                save_image(image_dir / f"i{i:04d},0000b.png", raw(rng, IMAGE))
                save_image(gt_dir / f"liver_GT_{i:03d}.png", (labels(rng, 4, IMAGE, "uint8") * 63).astype("uint8"))


def build_duke_liver(root):
    """The converted cache (the conversion reads DICOM)."""
    rng = np.random.default_rng(602)
    (root / "data" / "Segmentation").mkdir(parents=True)
    for i in range(2):
        nii(root / "data" / "preprocessed" / "images" / f"000{i}_01.nii.gz", vol(rng))
        nii(root / "data" / "preprocessed" / "masks" / f"000{i}_01.nii.gz", labels(rng, 2, VOLUME, "uint8"))


def build_ircadb(root):
    """The converted HDF5 volumes (the conversion reads DICOM)."""
    rng = np.random.default_rng(603)
    for pid in ("3Dircadb1.1", "3Dircadb1.2", "3Dircadb1.10"):
        write_h5(root / "data" / f"{pid}.h5", raw=vol(rng), labels__liver=labels(rng, 2, VOLUME, "uint8"),
                 labels__bone=labels(rng, 2, VOLUME, "uint8"))


def build_osic_pulmofib(root):
    """The completed conversion's cache and its confirmation (the conversion reads DICOM)."""
    rng = np.random.default_rng(604)
    prep = root / "data" / "preprocessed"
    for i in range(4):
        uid = f"ID{i:08d}"
        (root / "data" / "train" / uid).mkdir(parents=True)
        if i != 2:  # a scan without labels is left out
            nii(prep / "images" / f"{uid}.nii.gz", vol(rng, (64, 64, 8)))
            nii(prep / "ground_truth" / f"{uid}.nii.gz", labels(rng, 4, (64, 64, 8), "uint8"))
    (prep / "confirmer.json").write_text(json.dumps("preprocessed"))


def build_plethora(root):
    """A converted CT volume, its ground truth (re-oriented on first use), the series table, and a
    series whose subject has no ground truth."""
    rng = np.random.default_rng(605)
    image_dir = root / "data" / "images"
    series = {"1.3.6.1.4.1.0001": "LUNG1-001", "1.3.6.1.4.1.0002": "LUNG1-002", "1.3.6.1.4.1.0003": "LUNG1-003"}
    for uid, subject in series.items():
        (image_dir / uid).mkdir(parents=True)
        if subject != "LUNG1-003":
            nii(image_dir / "preprocessed" / f"{subject}.nii.gz", vol(rng, (64, 64, 8)))
            nii(root / "data" / "gt" / "Thoracic_Cavities" / subject / f"{subject}_thor_cav_primary_reviewer.nii.gz",
                labels(rng, 3, (64, 64, 8), "uint8"))
    (root / "plethora_images.csv").write_text("Series UID,Subject ID\n" + "".join(
        f"{uid},{subject}\n" for uid, subject in series.items()))


def build_kits(root):
    """KiTS23's downloaded cases: volume, segmentation and per-rater instance annotations."""
    rng = np.random.default_rng(606)
    for case in range(6):
        base = root / "kits23" / "dataset" / f"case_{case:05d}"
        nii(base / "imaging.nii.gz", vol(rng))
        nii(base / "segmentation.nii.gz", labels(rng, 4, VOLUME, "uint8"))
        for name, rater in (("kidney_instance-1_annotation-1", 1), ("kidney_instance-1_annotation-2", 2),
                            ("kidney_instance-2_annotation-1", 1), ("tumor_instance-1_annotation-3", 3)):
            nii(base / "instances" / f"{name}.nii.gz", labels(rng, 2, VOLUME, "uint8"))


def convert_kits(module, root):
    module._preprocess_inputs(str(root))


def build_panorama(root):
    rng = np.random.default_rng(607)
    for choice, n in (("manual", 3), ("automatic", 2)):
        for i in range(n):
            name = f"1000{i}_0000{1 if choice == 'manual' else 2}"
            nii(root / "labels" / f"{choice}_labels" / f"{name}.nii.gz", labels(rng, 2, VOLUME, "uint8"))
            nii(root / "volumes" / f"{name}_0000.nii.gz", vol(rng))
    # the label that ships empty upstream, and a label without its volume: both dropped
    nii(root / "labels" / "manual_labels" / "100051_00001.nii.gz", labels(rng, 2, VOLUME, "uint8"))
    nii(root / "volumes" / "100051_00001_0000.nii.gz", vol(rng))
    nii(root / "labels" / "manual_labels" / "100099_00001.nii.gz", labels(rng, 2, VOLUME, "uint8"))


def build_sa_med2d(root):
    """The merged archive ``data.zip``: the index of masks per image, grey and RGB images of two
    sub-datasets with their masks (ACDC's whole-cavity mask, which the reader skips, among them), and
    an image without foreground (dropped)."""
    rng = np.random.default_rng(608)
    src = root / "src" / "SAMed2Dv1"
    index = {}
    for name, shape in (("ACDC_0001_000.png", (40, 64)), ("ACDC_0002_000.png", (40, 64)),
                        ("kvasir_seg_0001.png", (48, 40, 3)), ("kvasir_seg_0002.png", (48, 40, 3))):
        save_image(src / "images" / name, raw(rng, shape))
        masks = []
        for k in (1, 3) if name.startswith("ACDC_0001") else (1,):
            mask_name = f"masks/{name[:-4]}--000{k}_000.png"
            mask = np.zeros(shape[:2], "uint8")
            if name != "kvasir_seg_0002.png":
                y, x = rng.integers(0, 20, 2)
                mask[y:y + 12, x:x + 10] = 255
            save_image(src / mask_name, mask)
            masks.append(mask_name)
        index[f"images/{name}"] = masks
    (src / "SAMed2D_v1.json").write_text(json.dumps(index))
    with zipfile.ZipFile(root / "data.zip", "w") as zf:
        for p in sorted(src.rglob("*")):
            if p.is_file():
                zf.write(p, p.relative_to(root / "src"))
    for p in sorted((root / "src").rglob("*"), reverse=True):
        p.unlink() if p.is_file() else p.rmdir()
    (root / "src").rmdir()


def build_lgg_mri(root):
    """The kaggle layout: per patient, RGB TIFF slices (pre-contrast, FLAIR, post-contrast) and masks."""
    rng = np.random.default_rng(609)
    for patient in ("TCGA_CS_4941_19960909", "TCGA_CS_4942_19970222"):
        for i in range(1, 5):
            save_tif(root / "kaggle_3m" / patient / f"{patient}_{i}.tif", raw(rng, IMAGE + (3,)))
            save_tif(root / "kaggle_3m" / patient / f"{patient}_{i}_mask.tif",
                     ((rng.random(IMAGE) > 0.7) * 255).astype("uint8"))


def convert_lgg_mri(module, root):
    module._merge_slices_to_volumes(str(root))


P3 = dict(patch_shape=PATCH_3D)

CASES = [
    MedCase("chaos", build_chaos,
            paths=[("get_chaos_paths", dict(modality="CT")), ("get_chaos_paths", dict(modality="MRI")),
                   ("get_chaos_paths", {})],
            datasets=[("get_chaos_dataset", dict(patch_shape=(32, 32, 4), modality="CT")),
                      ("get_chaos_dataset", dict(patch_shape=(32, 32, 4)))],
            loaders=[("get_chaos_loader", dict(patch_shape=(32, 32, 4), batch_size=1, modality="CT"))]),
    MedCase("duke_liver", build_duke_liver,
            paths=[("get_duke_liver_paths", {})],
            datasets=[("get_duke_liver_dataset", P3)],
            loaders=[("get_duke_liver_loader", dict(batch_size=1, **P3))]),
    MedCase("ircadb", build_ircadb,
            paths=[("get_ircadb_paths", {})],
            datasets=[("get_ircadb_dataset", P3), ("get_ircadb_dataset", dict(organ="bone", **P3))],
            loaders=[("get_ircadb_loader", dict(batch_size=1, **P3))]),
    MedCase("osic_pulmofib", build_osic_pulmofib,
            paths=[("get_osic_pulmofib_paths", dict(split="train")), ("get_osic_pulmofib_paths", dict(split="val"))],
            datasets=[("get_osic_pulmofib_dataset", dict(patch_shape=(32, 32, 4), split="train"))],
            loaders=[("get_osic_pulmofib_loader", dict(patch_shape=(32, 32, 4), split="train", batch_size=1))]),
    MedCase("plethora", build_plethora,
            paths=[("get_plethora_paths", dict(task="thoracic"))],
            datasets=[("get_plethora_dataset", dict(patch_shape=(32, 32, 4), task="thoracic"))],
            loaders=[("get_plethora_loader", dict(patch_shape=(32, 32, 4), task="thoracic", batch_size=1))]),
    MedCase("kits", build_kits, prepare=convert_kits,
            paths=[("get_kits_paths", dict(split="train")), ("get_kits_paths", dict(split="val")),
                   ("get_kits_paths", dict(split="test"))],
            datasets=[("get_kits_dataset", dict(split="train", **P3)),
                      ("get_kits_dataset", dict(split="test", rater=1, annotation_choice="kidney", **P3))],
            loaders=[("get_kits_loader", dict(split="train", batch_size=1, **P3))],
            converted=["splits_kits.json"]),
    MedCase("panorama", build_panorama,
            paths=[("get_panorama_paths", {}), ("get_panorama_paths", dict(annotation_choice="manual"))],
            datasets=[("get_panorama_dataset", P3), ("get_panorama_dataset", dict(annotation_choice="automatic",
                                                                                  **P3))],
            loaders=[("get_panorama_loader", dict(batch_size=1, **P3))]),
    MedCase("lgg_mri", build_lgg_mri, prepare=convert_lgg_mri,
            paths=[("get_lgg_mri_paths", dict(split="train")), ("get_lgg_mri_paths", dict(split="val"))],
            datasets=[("get_lgg_mri_dataset", dict(patch_shape=(2, 32, 32), split="train")),
                      ("get_lgg_mri_dataset", dict(patch_shape=(2, 32, 32), split="train", channels="flair"))],
            loaders=[("get_lgg_mri_loader", dict(patch_shape=(2, 32, 32), split="train", batch_size=1))]),
]


SA_MED2D = MedCase("sa_med2d", build_sa_med2d,
                   paths=[("get_sa_med2d_paths", {})],
                   datasets=[("get_sa_med2d_dataset", dict(patch_shape=(1, 64, 64)))],
                   loaders=[("get_sa_med2d_loader", dict(patch_shape=(1, 64, 64), batch_size=2))],
                   converted=["data/ACDC_00.h5", "data/kvasir_seg_00.h5"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_sa_med2d_matches_jax(tmp_path, monkeypatch):
    """SA-Med2D's conversion takes two values from ``relabel_consecutive``, which returns three: the JAX
    package's conversion raises there, the port's takes the first. With the JAX package's
    ``relabel_consecutive`` cut to two values, both convert the same archive to the same shards."""
    import torch_em_tpu.ops.host as jax_host

    build_sa_med2d(tmp_path / "unpatched")
    with pytest.raises(ValueError, match="too many values to unpack"):
        modules("sa_med2d", MEDICAL)[0].get_sa_med2d_paths(str(tmp_path / "unpatched"))
    relabel = jax_host.relabel_consecutive
    monkeypatch.setattr(jax_host, "relabel_consecutive", lambda seg: relabel(seg)[:2])
    (tmp_path / "case").mkdir()
    check_case(SA_MED2D, tmp_path / "case")


def _raises_alike(calls, tmp_path):
    """Each (JAX, port) call raises the same exception type with the same message, after the
    folder's name is taken out of it."""
    errors = []
    for side, call in zip(("jax", "port"), calls):
        with pytest.raises(Exception) as info:
            call(tmp_path / side)
        errors.append((type(info.value), str(info.value).replace(str(tmp_path / side), "<root>")))
    assert errors[0] == errors[1], errors
    return errors[0][0]


def _dicom_series(root):
    """One DICOM file a series for each reader that converts DICOM (written with ``torch_conversion_layouts.dcmwrite``):
    CHAOS' CT case 3 beside its PNG ground truth, a Duke Liver scan, a 3D-IRCADb patient, an OSIC scan with a
    heart annotation of its shape, and PLETHORA's series of LUNG1-002."""
    from torch_em_tpu_torch.utils.medical_io import save_nrrd

    rng = np.random.default_rng(609)
    files = {"data/Train_Sets/CT/3/DICOM_anon/i0000,0000b.dcm": "int16",
             "data/Segmentation/0001/01/images/000.dicom": "uint16",
             "data/Segmentation/0001/01/masks/000.dicom": "uint8",
             "Dataset/3Dircadb1.1/PATIENT_DICOM/image_0": "int16",
             "Dataset/3Dircadb1.1/MASKS_DICOM/liver/image_0": "uint8",
             "data/train/ID00000000/1.dcm": "int16",
             "pl/data/images/1.3.6.1.4.1.0002/1-1.dcm": "int16"}
    for rel, dtype in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        layouts.dcmwrite(str(root / rel), rng.integers(0, 200, IMAGE).astype(dtype))
    save_image(root / "data" / "Train_Sets" / "CT" / "3" / "Ground" / "liver_GT_000.png",
               (labels(rng, 2, IMAGE, "uint8") * 255).astype("uint8"))
    (root / "data" / "segmentations" / "heart").mkdir(parents=True)
    save_nrrd(str(root / "data" / "segmentations" / "heart" / "ID00000000_heart.nrrd"),
              labels(rng, 2, IMAGE + (1,), "uint8"))


def test_missing_pydicom_raises_as_in_jax(tmp_path):
    """Where a conversion reads DICOM, the JAX package still raises without pydicom; the port reads the files with
    its own ``utils/dicom.py`` and converts them (``tests/test_torch_zoo_conversions.py`` holds the converted files
    against the JAX package's over a stand-in pydicom)."""
    import importlib.util

    assert importlib.util.find_spec("pydicom") is None, "pydicom is installed: this test needs it missing"
    mods = {name: modules(name, MEDICAL) for name in ("chaos", "duke_liver", "ircadb", "osic_pulmofib", "plethora")}
    for side in ("jax", "port"):
        root = tmp_path / side
        build_chaos(root)
        build_plethora(root / "pl")
        (root / "pl" / "data" / "images" / "preprocessed" / "LUNG1-002.nii.gz").unlink()
        _dicom_series(root)
    cases = [
        (lambda m: lambda r: m.get_chaos_paths(str(r), modality="CT"), "chaos", ModuleNotFoundError,
         "data/Train_Sets/preprocessed/CT/image/3_CT.nii.gz"),
        (lambda m: lambda r: m.get_duke_liver_paths(str(r)), "duke_liver", ImportError,
         "data/preprocessed/images/0001_01.nii.gz"),
        (lambda m: lambda r: m._preprocess_inputs(str(r)), "ircadb", ImportError, "data/3Dircadb1.1.h5"),
        (lambda m: lambda r: m.get_osic_pulmofib_paths(str(r), "train"), "osic_pulmofib", ImportError,
         "data/preprocessed/images/ID00000000.nii.gz"),
        (lambda m: lambda r: m.get_plethora_paths(str(r / "pl"), "thoracic"), "plethora", ImportError,
         "pl/data/images/preprocessed/LUNG1-002.nii.gz")]
    for make, name, error, converted in cases:
        jax_mod, port_mod = mods[name]
        with pytest.raises(error, match="pydicom") as info:
            make(jax_mod)(tmp_path / "jax")
        assert type(info.value) is error, name
        make(port_mod)(tmp_path / "port")
        assert (tmp_path / "port" / converted).exists() and not (tmp_path / "jax" / converted).exists(), name


def test_downloads_refused_as_in_jax(tmp_path):
    """KiTS23 and PANORAMA download through ``git`` and their own command lines only when asked: without
    ``download`` both packages refuse the same way, and start no process."""
    for name, call in (("kits", lambda m: lambda r: m.get_kits_paths(str(r), "train")),
                       ("panorama", lambda m: lambda r: m.get_panorama_paths(str(r)))):
        assert _raises_alike([call(m) for m in modules(name, MEDICAL)], tmp_path) is RuntimeError


def test_medical_modules_and_public_names_match_jax():
    check_domain_matches_jax(jax_med, port_med, MEDICAL, 60)


def test_every_medical_module_has_a_parity_case():
    """Each port medical module has a case in one of the ``test_torch_datasets_med_*`` files."""
    check_every_module_has_a_case(port_med, Path(__file__).parent.glob("test_torch_datasets_med_*.py"), "MedCase")


def test_zoo_exports_amos():
    """``from torch_em_tpu_torch.data.datasets import get_amos_loader`` works."""
    from torch_em_tpu_torch.data.datasets import get_amos_loader

    assert get_amos_loader is modules("amos", MEDICAL)[1].get_amos_loader
