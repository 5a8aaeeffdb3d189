"""The zoo's conversions that the JAX package runs through pydicom, nibabel and pycocotools, held against the
port's, which reads the same files with its own ``utils/dicom.py``, ``utils/medical_io.py`` and ``utils/coco.py``.

Each case writes one small layout from a seed twice, once for each package. The JAX package's reader gets a
stand-in module in ``sys.modules`` (``pydicom``, ``nibabel`` or ``pycocotools.coco``) that returns the arrays the
test wrote for each file; the port reads the real files. The converted HDF5 and NIfTI outputs must then be equal,
bitwise (``torch_zoo_layouts.same_tree``): IRCADb, CHAOS, Duke Liver, OSIC, PLETHORA (DICOM), UroCell (NIfTI)
and OrgLine (COCO: compressed RLE ellipses and polygon rectangles; the JAX package's ``relabel_consecutive`` cut
to the two values its reader unpacks). PUMA's and HEST's conversions, which the JAX package cannot run without
geopandas, rasterio and shapely, are held against the brute-force references of
``scripts/torch_conversion_layouts.py`` (which ``chip_smoke.py`` phase 25 uses too) at a cut size, and
``write_data``'s images against ``load_image`` and imageio (here only the tests' oracle).
"""

import json
import os
import sys
import types
import zipfile
from pathlib import Path

import numpy as np
import pytest

from torch_em_tpu.utils import medical_io as jax_medical_io
from torch_em_tpu_torch.utils import dicom, hdf5, io
from torch_em_tpu_torch.utils import medical_io
from torch_zoo_layouts import LIGHT_MICROSCOPY, MEDICAL, modules, same_tree
from torch_zoo_layouts import no_network  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("no_network")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_conversion_layouts as layouts  # noqa: E402


class Written:
    """The arrays written for each file, by its path relative to the layout's root."""

    def __init__(self):
        self.arrays = {}

    def dicom(self, root, rel, array, syntax):
        path = Path(root) / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        layouts.dcmwrite(str(path), array, syntax, Modality="CT", InstanceNumber=len(self.arrays) + 1)
        self.arrays[str(rel)] = array

    def lookup(self, root, path):
        return self.arrays[os.path.relpath(path, root)]


def stand_in_pydicom(monkeypatch, written, root):
    module = types.ModuleType("pydicom")
    module.dcmread = lambda path, *args, **kwargs: types.SimpleNamespace(pixel_array=written.lookup(root, path))
    monkeypatch.setitem(sys.modules, "pydicom", module)


SYNTAXES = (dicom.EXPLICIT_VR_LITTLE_ENDIAN, dicom.IMPLICIT_VR_LITTLE_ENDIAN, dicom.RLE_LOSSLESS,
            dicom.DEFLATED_EXPLICIT_VR_LITTLE_ENDIAN, dicom.EXPLICIT_VR_BIG_ENDIAN)


def ct_series(rng, n, shape=(32, 32)):
    return [(rng.normal(0, 300, shape) + rng.integers(-1000, 500)).astype(np.int16) for _ in range(n)]


def masks(rng, n, shape=(32, 32), high=2, dtype=np.uint8):
    return [(rng.integers(0, high, shape) * (255 if high == 2 else 1)).astype(dtype) for _ in range(n)]


def build_ircadb(root, written):
    rng = np.random.default_rng(701)
    for p, pid in enumerate(("3Dircadb1.1", "3Dircadb1.2", "3Dircadb1.10")):
        for k, (image, mask, bone) in enumerate(zip(ct_series(rng, 6), masks(rng, 6), masks(rng, 6))):
            syntax = SYNTAXES[(p + k) % len(SYNTAXES)]
            written.dicom(root, f"Dataset/{pid}/PATIENT_DICOM/image_{k}", image, syntax)
            written.dicom(root, f"Dataset/{pid}/MASKS_DICOM/liver/image_{k}", mask, syntax)
            written.dicom(root, f"Dataset/{pid}/MASKS_DICOM/bone/image_{k}", bone, syntax)


def build_chaos(root, written):
    from PIL import Image

    rng = np.random.default_rng(702)
    for uid in ("1", "2"):
        for k, (image, mask) in enumerate(zip(ct_series(rng, 5), masks(rng, 5))):
            written.dicom(root, f"data/Train_Sets/CT/{uid}/DICOM_anon/i{k:04d},0000b.dcm", image, SYNTAXES[k % 5])
            gt = root / f"data/Train_Sets/CT/{uid}/Ground/liver_GT_{k:03d}.png"
            gt.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(mask).save(gt)


def build_duke_liver(root, written):
    rng = np.random.default_rng(703)
    for patient, sub in (("0001", "01"), ("0001", "02"), ("0003", "01")):
        for k, (image, mask) in enumerate(zip(ct_series(rng, 4, (24, 28)), masks(rng, 4, (24, 28)))):
            base = f"data/Segmentation/{patient}/{sub}"
            written.dicom(root, f"{base}/images/{k:03d}.dicom", image.astype(np.uint16), SYNTAXES[k % 5])
            written.dicom(root, f"{base}/masks/{k:03d}.dicom", mask, SYNTAXES[(k + 1) % 5])


def build_osic_pulmofib(root, written):
    """Three scans: two with heart and lung annotations, one whose annotation has another shape (left without
    labels, so not converted)."""
    rng = np.random.default_rng(704)
    for i in range(3):
        uid = f"ID{i:08d}"
        for k, image in enumerate(ct_series(rng, 6)):
            written.dicom(root, f"data/train/{uid}/{k + 1}.dcm", image, SYNTAXES[(i + k) % 5])
        shape = (32, 32, 6) if i != 1 else (32, 32, 5)
        for organ in ("heart", "lung", "noisy"):
            path = root / "data" / "segmentations" / organ / f"{uid}_{organ}.nrrd"
            path.parent.mkdir(parents=True, exist_ok=True)
            medical_io.save_nrrd(str(path), (rng.random(shape) > 0.7).astype(np.uint8))


def build_plethora(root, written):
    rng = np.random.default_rng(705)
    series = {"1.3.6.1.4.1.0001": "LUNG1-001", "1.3.6.1.4.1.0002": "LUNG1-002"}
    for s, (uid, subject) in enumerate(series.items()):
        for k, image in enumerate(ct_series(rng, 5, (24, 24))):
            written.dicom(root, f"data/images/{uid}/1-{k + 1:02d}.dcm", image, SYNTAXES[(s + k) % 5])
        gt = root / "data" / "gt" / "Thoracic_Cavities" / subject / f"{subject}_thor_cav_primary_reviewer.nii.gz"
        gt.parent.mkdir(parents=True, exist_ok=True)
        medical_io.save_nifti(str(gt), (rng.random((24, 24, 5)) > 0.5).astype(np.uint8))
    (root / "plethora_images.csv").write_text("Series UID,Subject ID\n" + "".join(
        f"{uid},{subject}\n" for uid, subject in series.items()))


DICOM_CASES = {
    "ircadb": (build_ircadb, lambda m, r: m._preprocess_inputs(str(r))),
    "chaos": (build_chaos, lambda m, r: m.get_chaos_paths(str(r), modality="CT")),
    "duke_liver": (build_duke_liver, lambda m, r: m.get_duke_liver_paths(str(r))),
    "osic_pulmofib": (build_osic_pulmofib, lambda m, r: m.get_osic_pulmofib_paths(str(r), "train")),
    "plethora": (build_plethora, lambda m, r: m.get_plethora_paths(str(r), "thoracic")),
}


@pytest.mark.parametrize("name", sorted(DICOM_CASES))
def test_dicom_conversion_matches_jax(name, tmp_path, monkeypatch):
    """The port converts the DICOM files as the JAX package converts pydicom's arrays of them, bitwise."""
    build, convert = DICOM_CASES[name]
    written = {}
    for side in ("jax", "port"):
        written[side] = Written()
        (tmp_path / side).mkdir()
        build(tmp_path / side, written[side])
    jax_module, port_module = modules(name, MEDICAL)
    got = convert(port_module, tmp_path / "port")
    stand_in_pydicom(monkeypatch, written["jax"], tmp_path / "jax")
    expected = convert(jax_module, tmp_path / "jax")
    if got is not None:
        rel = [[os.path.relpath(p, tmp_path / "port") for p in paths] for paths in got] if isinstance(got, tuple) \
            else [os.path.relpath(p, tmp_path / "port") for p in got]
        assert rel == ([[os.path.relpath(p, tmp_path / "jax") for p in paths] for paths in expected]
                       if isinstance(expected, tuple) else [os.path.relpath(p, tmp_path / "jax") for p in expected])
    converted = [p for p in (tmp_path / "port").rglob("*") if p.suffix in (".h5", ".gz")]
    assert converted, "nothing was converted"
    same_tree(tmp_path / "jax", tmp_path / "port")


def build_uro_cell(root):
    """UroCell's archive: two volumes, one with mito and fv instance labels, one with golgi; their arrays as
    ``get_fdata`` gives them, by path in the unpacked archive."""
    rng = np.random.default_rng(706)
    arrays = {}
    with zipfile.ZipFile(root / "uro_cell.zip", "w") as zf:
        for name, labels in (("fib1-0-0-0.nii.gz", ("mito", "fv")), ("fib1-1-0-3.nii.gz", ("golgi",))):
            items = [("data", rng.integers(0, 256, (20, 24, 16)).astype(np.uint8))]
            items += [(f"{label}/instance", rng.integers(0, 6, (20, 24, 16)).astype(np.uint16)) for label in labels]
            for sub, array in items:
                jax_medical_io.save_nifti(str(root / name), array)
                zf.write(root / name, f"UroCell-master/{sub}/{name}")
                arrays[f"UroCell-master/{sub}/{name}"] = array.astype(np.float64)
            (root / name).unlink()
    return arrays


def test_uro_cell_conversion_matches_jax(tmp_path, monkeypatch):
    """The port reads UroCell's NIfTI volumes with ``load_nifti`` as nibabel's ``get_fdata`` gives them: float64,
    (X, Y, Z); the h5 files equal the JAX package's over a stand-in nibabel."""
    arrays = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        arrays[side] = build_uro_cell(tmp_path / side)
    jax_module, port_module = modules("uro_cell")
    got = port_module.get_uro_cell_paths(str(tmp_path / "port"), "mito")
    nibabel = types.ModuleType("nibabel")
    nibabel.load = lambda path: types.SimpleNamespace(
        get_fdata=lambda: arrays["jax"][os.path.relpath(path, tmp_path / "jax")])
    monkeypatch.setitem(sys.modules, "nibabel", nibabel)
    expected = jax_module.get_uro_cell_paths(str(tmp_path / "jax"), "mito")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in expected] == ["fib1-0-0-0.h5"]
    with hdf5.File(got[0], "r") as f:
        assert f["raw"].dtype == np.float64 and f["labels/mito"].dtype == np.uint32
        np.testing.assert_array_equal(f["raw"][:], arrays["port"]["UroCell-master/data/fib1-0-0-0.nii.gz"])
    same_tree(tmp_path / "jax", tmp_path / "port")


class StandInCoco:
    """pycocotools' ``COCO`` as OrgLine's conversion calls it, over the annotation file, with ``annToMask`` giving
    the mask the test wrote for each annotation."""

    masks = {}

    def __init__(self, path):
        with open(path) as f:
            self.dataset = json.load(f)
        self.organ = os.path.basename(os.path.dirname(path))
        self.imgs = {img["id"]: img for img in self.dataset["images"]}

    def getImgIds(self):
        return list(self.imgs)

    def loadImgs(self, ids):
        return [self.imgs[ids]]

    def getAnnIds(self, imgIds):
        return [a["id"] for a in self.dataset["annotations"] if a["image_id"] == imgIds]

    def loadAnns(self, ids):
        return [a for a in self.dataset["annotations"] if a["id"] in ids]

    def annToMask(self, annotation):
        return self.masks[(self.organ, annotation["id"])].astype(np.uint8)


def test_orgline_coco_conversion_matches_jax(tmp_path, monkeypatch):
    """OrgLine's stomach and breast conversion: the port decodes the compressed RLE and polygon annotations itself
    (``utils/coco.py``) into the masks written, and its h5 files equal the JAX package's over a stand-in
    pycocotools (with its ``relabel_consecutive`` cut to two values, since its reader raises there)."""
    import torch_em_tpu.ops.host as jax_host

    organs = {}
    for side in ("jax", "port"):
        organs[side] = layouts.orgline_layout(str(tmp_path / side / "data2"), (4, 2), (192, 256), seed=3)
    with open(tmp_path / "jax" / "data2" / "stomach" / "coco.json") as f:
        annotations = json.load(f)["annotations"]
    assert {type(a["segmentation"]).__name__ for a in annotations} == {"list", "dict"}
    StandInCoco.masks = {}
    for organ in ("stomach", "breast"):
        with open(tmp_path / "jax" / "data2" / organ / "coco.json") as f:
            data = json.load(f)
        for ann in data["annotations"]:
            image = next(i for i in data["images"] if i["id"] == ann["image_id"])
            expected = organs["jax"][organ][os.path.basename(image["file_name"])][1]
            # the mask of an annotation is the instance of its rank by area in the expected map
            areas = sorted(a["area"] for a in data["annotations"] if a["image_id"] == ann["image_id"])
            StandInCoco.masks[(organ, ann["id"])] = expected == areas.index(ann["area"]) + 1
    jax_module, port_module = modules("orgline", LIGHT_MICROSCOPY)
    port_module._prepare_data(str(tmp_path / "port" / "data2"), "stomach")
    pycocotools, coco_module = types.ModuleType("pycocotools"), types.ModuleType("pycocotools.coco")
    coco_module.COCO = StandInCoco
    monkeypatch.setitem(sys.modules, "pycocotools", pycocotools)
    monkeypatch.setitem(sys.modules, "pycocotools.coco", coco_module)
    relabel = jax_host.relabel_consecutive
    monkeypatch.setattr(jax_host, "relabel_consecutive", lambda seg, *a, **k: relabel(seg, *a, **k)[:2])
    jax_module._prepare_data(str(tmp_path / "jax" / "data2"), "stomach")
    converted = sorted((tmp_path / "port" / "data2").rglob("*.h5"))
    assert len(converted) == sum(len(images) for images in organs["port"].values())
    for path in converted:
        image, expected = organs["port"][path.parent.parent.name][path.name[:-3]]
        with hdf5.File(str(path), "r") as f:
            np.testing.assert_array_equal(f["image"][:], image)
            np.testing.assert_array_equal(f["masks"][:], expected)
    same_tree(tmp_path / "jax", tmp_path / "port")


def test_puma_conversion_matches_the_brute_force(tmp_path, monkeypatch):
    """PUMA's GeoJSON nuclei (holes and MultiPolygons), rasterized by the port's reader, equal the pixel-centre
    even-odd reference, instance and semantic, flipped as the reader flips them."""
    from torch_em_tpu_torch.data.datasets.histopathology import puma

    rois = layouts.puma_layout(str(tmp_path), 2, 60, seed=5)
    paths = puma.get_puma_paths(str(tmp_path), "train", "nuclei")
    assert sorted(os.path.basename(p) for p in paths) == sorted(f"{name}.h5" for name in rois)
    for path in paths:
        rgb, nuclei, classes = rois[os.path.basename(path)[:-3]]
        instances, semantic = layouts.puma_reference(nuclei, classes)
        with hdf5.File(path, "r") as f:
            np.testing.assert_array_equal(f["raw"][:], rgb.transpose(2, 0, 1))
            assert f["labels/instances/nuclei"].dtype == np.int32 and f["labels/semantic/nuclei"].dtype == np.uint8
            np.testing.assert_array_equal(f["labels/instances/nuclei"][:], instances)
            np.testing.assert_array_equal(f["labels/semantic/nuclei"][:], semantic)
    assert puma._classification('{"name": "nuclei_tumor"}') == {"name": "nuclei_tumor"}


def test_hest_conversion_matches_the_brute_force(tmp_path, monkeypatch):
    """HEST's CellViT GeoJSON and Xenium WKB parquet nuclei at 0.5 and 0.25 um/px: each patch's instance masks
    equal the reference's exact window selection, numbering and pixel-centre burn."""
    from torch_em_tpu_torch.data.datasets.histopathology import hest

    slides = layouts.hest_layout(str(tmp_path), 40, seed=6)
    hest.get_hest_data(str(tmp_path))
    for sid, (coords, scale, cellvit, xenium) in slides.items():
        with hdf5.File(str(tmp_path / "preprocessed" / f"{sid}.h5"), "r") as f:
            got = f[hest.LABEL_KEYS["instances"]][:], f[hest.LABEL_KEYS["xenium_instances"]][:]
            assert not f[hest.LABEL_KEYS["semantic"]][:].any()
        for i, coord in enumerate(coords):
            for nuclei, mask in ((cellvit, got[0][i]), (xenium, got[1][i])):
                np.testing.assert_array_equal(mask, layouts.hest_reference(nuclei, coord, 224, scale))
        assert got[0].max() > 0 and got[1].max() > 0


@pytest.mark.parametrize("name, array", [
    ("u8.png", np.arange(48, dtype=np.uint8).reshape(6, 8)),
    ("u16.png", np.arange(48, dtype=np.uint16).reshape(6, 8) * 1000),
    ("rgb.png", np.arange(144, dtype=np.uint8).reshape(6, 8, 3)),
    ("rgba.png", np.arange(192, dtype=np.uint8).reshape(6, 8, 4)),
    ("i32.tif", (np.arange(48, dtype=np.int32).reshape(6, 8) - 20) * 100000000),
    ("f32.tiff", np.linspace(-1, 1, 48, dtype=np.float32).reshape(6, 8)),
    ("rgb.tif", np.arange(144, dtype=np.uint8).reshape(6, 8, 3)),
    ("stack.tif", np.arange(3 * 48, dtype=np.uint16).reshape(3, 6, 8)),
    ("stack_f32.tif", np.linspace(0, 1, 5 * 48, dtype=np.float32).reshape(5, 6, 8)),
    ("stack_rgb.tif", np.arange(2 * 144, dtype=np.uint8).reshape(2, 6, 8, 3)),
    ("bool.png", np.arange(48).reshape(6, 8) % 3 == 0),
])
def test_write_data_images_read_back(name, array, tmp_path):
    """``write_data`` writes images through PIL: they read back equal through ``load_image`` and through imageio
    (a multi-page TIFF as imageio's one ndimage of its pages)."""
    import imageio.v3 as iio

    path = str(tmp_path / name)
    io.write_data(path, None, array)
    got = io.load_image(path)
    assert got.dtype == array.dtype
    np.testing.assert_array_equal(got, array)
    np.testing.assert_array_equal(iio.imread(path), array)


@pytest.mark.parametrize("name, array, what", [
    ("i32.png", np.zeros((4, 4), np.int32), "int32"),
    ("f32.png", np.zeros((4, 4), np.float32), "float32"),
    ("f64.tif", np.zeros((4, 4), np.float64), "float64"),
    ("i64.tif", np.zeros((4, 4), np.int64), "int64"),
    ("two.tif", np.zeros((2, 4, 4, 2), np.uint8), r"\(2, 4, 4, 2\)"),
    ("stack.png", np.zeros((3, 4, 4), np.uint16), "multi-page TIFF"),
    ("rgba.jpg", np.zeros((4, 4, 4), np.uint8), "RGBA|shape"),
    ("u16.bmp", np.zeros((4, 4), np.uint16), "uint16"),
])
def test_write_data_refuses_what_pil_does_not_store(name, array, what, tmp_path):
    with pytest.raises(ValueError, match=what):
        io.write_data(str(tmp_path / name), None, array)


def test_hest_semantic_patch_takes_the_nearest_spot():
    """``_rasterize_patch_semantic``: each nucleus in the window is burned with the label of the ST spot nearest
    to its area centroid, mapped back to native pixels (here at 2 native pixels a patch pixel)."""
    from torch_em_tpu_torch.data.datasets.histopathology import hest
    from torch_em_tpu_torch.utils import geometry

    def square(x, y, side):
        return geometry.Polygon(np.array([(x, y), (x + side, y), (x + side, y + side), (x, y + side), (x, y)], float))

    cells = geometry.GeoFrame([square(110, 110, 20), square(300, 120, 30), square(2000, 2000, 10)])
    spots = np.array([[120.0, 121.0, 4.0], [316.0, 134.0, 2.0], [900.0, 900.0, 5.0]])
    got = hest._rasterize_patch_semantic(100, 100, 224, cells, spots, native_scale=2.0)
    expected = np.zeros((224, 224), np.int32)
    expected[5:15, 5:15] = 4
    expected[10:25, 100:115] = 2
    np.testing.assert_array_equal(got, expected)
    assert not hest._rasterize_patch_semantic(5000, 5000, 224, cells, spots, native_scale=2.0).any()
