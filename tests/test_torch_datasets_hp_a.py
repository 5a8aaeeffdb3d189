"""The port's dataset zoo, histopathology (the readers of PNG, TIFF and ``.npy`` files, which run on
the card), against the JAX package's.

Each case lays out one module's files at a small size and holds the port's getters against the
JAX package's on them (``torch_zoo_layouts.check_case``): the same paths, ``len`` and samples
under the same ``np.random.seed``, loader batches of the same shapes, and every file under both
folders equal afterwards, so that what a reader converts is compared too: MoNuSeg's and MoNuSAC's
labels rasterized from Aperio XML polygons, CPM's from ``.mat`` files, LyNSeC's and SRSA-Net's from
``.npy`` arrays, NuClick's, Janowczyk's and PanopTILs' label TIFFs. CPM, CryoNuSeg, Janowczyk and
LyNSeC split their images with sklearn's ``train_test_split`` in the JAX package and with the
port's numpy copy: both draw from numpy's global ``RandomState``. This file also holds the module
lists against each other: the port's histopathology modules are the JAX package's, with its public
names and signatures, and each has a case in one of the ``test_torch_datasets_hp_*`` files.
"""

import io
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from PIL import Image

import torch_em_tpu.data.datasets.histopathology as jax_hp
import torch_em_tpu_torch.data.datasets.histopathology as port_hp
from torch_zoo_layouts import (HISTOPATHOLOGY, IMAGE, PATCH_2D, HPCase, check_case, check_domain_matches_jax,
                               check_every_module_has_a_case, labels, modules, raw, save_image, save_mat, zip_folder)
from torch_zoo_layouts import no_network  # noqa: F401 (the fixture of pytestmark)

pytestmark = pytest.mark.usefixtures("no_network")

BOUNDARIES = dict(patch_shape=PATCH_2D, boundaries=True)


def _rgb(rng, shape=IMAGE):
    return raw(rng, shape + (3,))


def _polygons_xml(rng, n, shape=IMAGE):
    """An Aperio-style annotation file: ``n`` regions of 3 to 9 float vertices around random centres
    (some past the border, some overlapping), and one degenerate region of two vertices."""
    regions = []
    for k in range(n):
        cy, cx = rng.uniform(-4, shape[0] + 4), rng.uniform(-4, shape[1] + 4)
        m = int(rng.integers(3, 10))
        t = np.sort(rng.uniform(0, 2 * np.pi, m))
        r = rng.uniform(2, 9, m)
        vertices = "".join(f'<Vertex X="{cx + a * np.cos(b):.3f}" Y="{cy + a * np.sin(b):.3f}" Z="0"/>'
                           for a, b in zip(r, t))
        regions.append(f'<Region Id="{k + 1}"><Vertices>{vertices}</Vertices></Region>')
    regions.append('<Region Id="0"><Vertices><Vertex X="1" Y="1"/><Vertex X="9" Y="9"/></Vertices></Region>')
    return ('<?xml version="1.0"?><Annotations><Annotation Id="1"><Regions>' + "".join(regions)
            + "</Regions></Annotation></Annotations>")


def build_monuseg(root):
    """The extracted downloads: images as RGB TIFFs with Aperio XML annotations, beside them in the
    test folder and in a sibling ``Annotations`` folder in the training one."""
    from torch_em_tpu.data.datasets.histopathology.monuseg import ORGAN_SPLITS

    rng = np.random.default_rng(201)
    train = root / "MoNuSeg 2018 Training Data"
    for name in (ORGAN_SPLITS["breast"][0], ORGAN_SPLITS["kidney"][1], ORGAN_SPLITS["liver"][2]):
        save_image(train / "Tissue Images" / f"{name}.tif", _rgb(rng))
        (train / "Annotations").mkdir(parents=True, exist_ok=True)
        (train / "Annotations" / f"{name}.xml").write_text(_polygons_xml(rng, 14))
    test = root / "MoNuSegTestData"
    for name in ("TCGA-2Z-A9J9-01A-01-TS1", "TCGA-44-2665-01B-06-BS6"):
        save_image(test / f"{name}.tif", _rgb(rng))
        (test / f"{name}.xml").write_text(_polygons_xml(rng, 10))


def build_monusac(root):
    """Each split's zip of per-patient folders of RGB TIFFs and XML annotations."""
    rng = np.random.default_rng(202)
    for split, folder, patients in (
            ("train", "MoNuSAC_images_and_annotations", ("TCGA-55-1594-01Z-00-DX1", "TCGA-5P-A9K0-01Z-00-DX1",
                                                         "TCGA-A2-A0CV-01Z-00-DX1")),
            ("test", "MoNuSAC Testing Data and Annotations", ("TCGA-49-6743-01Z-00-DX2",))):
        src = root / "src" / folder
        for patient in patients:
            for i in (1, 2):
                save_image(src / patient / f"{patient}_{i}.tif", _rgb(rng))
                (src / patient / f"{patient}_{i}.xml").write_text(_polygons_xml(rng, 8))
        zip_folder(src, root / f"monusac_{split}.zip", root / "src")
    (root / "src").rmdir()


def build_cpm(root):
    """cpm15 (one folder, split on first use) and cpm17 (train and test), labels as ``.mat``."""
    rng = np.random.default_rng(203)
    for i in range(5):
        save_image(root / "cpm15" / "Images" / f"image_{i:02d}.png", _rgb(rng))
        save_mat(root / "cpm15" / "Labels" / f"image_{i:02d}.mat", inst_map=labels(rng, 6, IMAGE, "int32"))
    for split in ("train", "test"):
        for i in (1, 2, 10):
            save_image(root / "cpm17" / split / "Images" / f"image_{i}.png", _rgb(rng))
            save_mat(root / "cpm17" / split / "Labels" / f"image_{i}.mat", inst_map=labels(rng, 6, IMAGE, "int32"))


def build_cryonuseg(root):
    rng = np.random.default_rng(204)
    for i in range(6):
        save_image(root / "tissue images" / f"Human_AdrenalGland_{i:02d}.tif", _rgb(rng))
        for folder in ("Annotator 1 (biologist)/", "Annotator 2 (bioinformatician)/" * 2):
            save_image(root / f"{folder}label masks modify" / f"Human_AdrenalGland_{i:02d}.tif",
                       labels(rng, 5, IMAGE, "int32"), mode="I")


def build_janowczyk(root):
    """The three annotation sets: nuclei (TIFF and binary mask PNG per patient image, converted to
    instances), epithelium (masks in a subfolder) and tubule (BMP pairs)."""
    rng = np.random.default_rng(205)
    nuclei = root / "data" / "nuclei"
    for i in range(6):
        save_image(nuclei / f"{8863 + i}_500_f00{i}_original.tif", _rgb(rng))
        save_image(nuclei / f"{8863 + i}_500_f00{i}_mask.png", ((rng.random(IMAGE) > 0.7) * 255).astype("uint8"))
    for i in range(2):
        save_image(root / "data" / "epithelium" / f"{10262 + i}_500_f00{i}.tif", _rgb(rng))
        save_image(root / "data" / "epithelium" / "masks" / f"{10262 + i}_500_f00{i}_mask.png",
                   ((rng.random(IMAGE) > 0.5) * 255).astype("uint8"))
        save_image(root / "data" / "tubule" / f"09-1339-01-{i}.bmp", _rgb(rng))
        save_image(root / "data" / "tubule" / f"09-1339-01-{i}_anno.bmp",
                   ((rng.random(IMAGE) > 0.5) * 255).astype("uint8"))


def build_lynsec(root):
    """The zip of ``.npy`` arrays (RGB and the instance labels as a fourth channel): 'lynsec 1' is
    IHC, the rest H&E, of which ``3_l2`` is one of the images the reader drops."""
    rng = np.random.default_rng(206)
    src = root / "src"
    for folder, names in (("lynsec 1", [f"{i}_l1" for i in range(5)]), ("lynsec 2", ["3_l2", "40_l2", "41_l2"]),
                          ("lynsec 3", ["7_l3", "8_l3"])):
        (src / folder).mkdir(parents=True)
        for name in names:
            array = np.concatenate([_rgb(rng), labels(rng, 6, IMAGE, "uint8")[..., None]], axis=-1)
            np.save(src / folder / f"{name}.npy", array.astype("float64"))
    zip_folder(src, root / "lynsec.zip", src)


def build_nuclick(root):
    rng = np.random.default_rng(207)
    base = root / "IHC_nuclick" / "IHC"
    for split in ("Train", "Validation"):
        for i in range(3):
            save_image(base / "images" / split / f"img_{i}.png", _rgb(rng))
            (base / "masks" / split).mkdir(parents=True, exist_ok=True)
            np.save(base / "masks" / split / f"img_{i}.npy", labels(rng, 5, IMAGE, "int64"))


def build_nuinsseg(root):
    rng = np.random.default_rng(208)
    for organ in ("human liver", "mouse spleen"):
        for i in range(2):
            save_image(root / "data" / organ / "tissue images" / f"{organ}_{i}.png", _rgb(rng))
            save_image(root / "data" / organ / "label masks modify" / f"{organ}_{i}.tif",
                       labels(rng, 5, IMAGE, "int32"), mode="I")


def _png(array, mode=None):
    buf = io.BytesIO()
    (Image.fromarray(array, mode=mode) if mode else Image.fromarray(array)).save(buf, format="PNG")
    return buf.getvalue()


def build_panoptils(root):
    """The refined parquet release: PNG bytes of the image and of its instance, type and semantic
    masks per row."""
    rng = np.random.default_rng(209)
    rows = []
    for _ in range(3):
        inst = labels(rng, 5, IMAGE, "int32")
        rows.append({"image": _png(_rgb(rng)), "inst": _png(inst, mode="I"),
                     "type": _png((inst % 3).astype("uint8")), "sem": _png(labels(rng, 4, IMAGE, "uint8"))})
    pd.DataFrame(rows).to_parquet(root / "panoptils_refined.parquet")


def build_srsanet(root):
    """The zip: PNG images and two binary channels (positive and negative nuclei) per ``.npy`` mask."""
    rng = np.random.default_rng(210)
    src = root / "src" / "IHC_TMA_dataset"
    (src / "masks").mkdir(parents=True)
    for fold in ("fold1", "fold2", "fold3"):
        for i in range(2):
            save_image(src / "images" / f"{fold}_{i}.png", _rgb(rng))
            np.save(src / "masks" / f"{fold}_{i}.npy", (rng.random((2,) + IMAGE) > 0.8).astype("uint8"))
    zip_folder(src, root / "IHC_TMA_dataset.zip", root / "src")
    (root / "src").rmdir()


def check_panoptils_semantic(jax_mod, port_mod, jax_root, port_root):
    """The type and semantic labels go through a segmentation dataset, which both packages refuse
    beside channel-last RGB images (the JAX package with an ``AssertionError``, the port with a
    ``ValueError``, as its ``SegmentationDataset`` does for any two shapes that differ)."""
    for mod, root, error in ((jax_mod, jax_root, AssertionError), (port_mod, port_root, ValueError)):
        for choice in ("type", "semantic"):
            with pytest.raises(error, match=r"\(64, 64, 3\),? (and labels )?\(64, 64\)"):
                mod.get_panoptils_dataset(str(root), (1, 32, 32), label_choice=choice)


CASES = [
    HPCase("monuseg", build_monuseg,
           paths=[("get_monuseg_paths", dict(split="train")),
                  ("get_monuseg_paths", dict(split="train", organ_type=["breast", "liver"])),
                  ("get_monuseg_paths", dict(split="test"))],
           datasets=[("get_monuseg_dataset", dict(split="train", **BOUNDARIES)),
                     ("get_monuseg_dataset", dict(patch_shape=PATCH_2D, split="test", binary=True)),
                     ("get_monuseg_dataset", dict(patch_shape=PATCH_2D, split="train", organ_type=["kidney"],
                                                  offsets=[[-1, 0], [0, -1]]))],
           loaders=[("get_monuseg_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train")),
                    ("get_monuseg_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="test", boundaries=True))]),
    HPCase("monusac", build_monusac,
           paths=[("get_monusac_paths", dict(split="train")),
                  ("get_monusac_paths", dict(split="train", organ_type=["lung", "breast"])),
                  ("get_monusac_paths", dict(split="test"))],
           datasets=[("get_monusac_dataset", dict(split="train", **BOUNDARIES)),
                     ("get_monusac_dataset", dict(patch_shape=PATCH_2D, split="test", binary=True))],
           loaders=[("get_monusac_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train", binary=True))]),
    HPCase("cpm", build_cpm,
           paths=[("get_cpm_paths", dict(data_choice="cpm15", split="train")),
                  ("get_cpm_paths", dict(data_choice="cpm15", split="val")),
                  ("get_cpm_paths", dict(data_choice="cpm17", split="test"))],
           datasets=[("get_cpm_dataset", dict(patch_shape=PATCH_2D, data_choice="cpm15", split="test")),
                     ("get_cpm_dataset", dict(patch_shape=PATCH_2D, data_choice="cpm17", split="train"))],
           loaders=[("get_cpm_loader", dict(patch_shape=PATCH_2D, batch_size=1, data_choice="cpm17", split="train"))]),
    HPCase("cryonuseg", build_cryonuseg,
           paths=[("get_cryonuseg_paths", dict(split="train")), ("get_cryonuseg_paths", dict(split="test")),
                  ("get_cryonuseg_paths", dict(split="val", rater_choice="b3"))],
           datasets=[("get_cryonuseg_dataset", dict(patch_shape=PATCH_2D, split="train")),
                     ("get_cryonuseg_dataset", dict(patch_shape=PATCH_2D, split="test", rater="b3"))],
           loaders=[("get_cryonuseg_loader", dict(patch_shape=PATCH_2D, batch_size=1, split="train"))]),
    HPCase("janowczyk", build_janowczyk,
           paths=[("get_janowczyk_paths", dict(split="train")), ("get_janowczyk_paths", {}),
                  ("get_janowczyk_paths", dict(annotation="epithelium")),
                  ("get_janowczyk_paths", dict(annotation="tubule"))],
           datasets=[("get_janowczyk_dataset", dict(patch_shape=PATCH_2D, split="test")),
                     ("get_janowczyk_dataset", dict(patch_shape=PATCH_2D, annotation="tubule"))],
           loaders=[("get_janowczyk_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train")),
                    ("get_janowczyk_loader", dict(patch_shape=PATCH_2D, batch_size=2, annotation="epithelium"))]),
    HPCase("lynsec", build_lynsec,
           paths=[("get_lynsec_paths", {}), ("get_lynsec_paths", dict(split="train", choice="ihc")),
                  ("get_lynsec_paths", dict(split="test"))],
           datasets=[("get_lynsec_dataset", dict(patch_shape=PATCH_2D, choice="h&e")),
                     ("get_lynsec_dataset", dict(patch_shape=PATCH_2D, split="val"))],
           loaders=[("get_lynsec_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train", choice="ihc"))]),
    HPCase("nuclick", build_nuclick,
           paths=[("get_nuclick_paths", {}), ("get_nuclick_paths", dict(split="Validation"))],
           datasets=[("get_nuclick_dataset", dict(patch_shape=PATCH_2D)),
                     ("get_nuclick_dataset", dict(patch_shape=PATCH_2D, split="Validation"))],
           loaders=[("get_nuclick_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    HPCase("nuinsseg", build_nuinsseg,
           paths=[("get_nuinsseg_paths", {})],
           datasets=[("get_nuinsseg_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_nuinsseg_loader", dict(patch_shape=PATCH_2D, batch_size=2))]),
    HPCase("panoptils", build_panoptils,
           paths=[("get_panoptils_paths", {}), ("get_panoptils_paths", dict(label_choice="type")),
                  ("get_panoptils_paths", dict(label_choice="semantic"))],
           datasets=[("get_panoptils_dataset", dict(patch_shape=PATCH_2D))],
           loaders=[("get_panoptils_loader", dict(patch_shape=PATCH_2D, batch_size=2))],
           check=check_panoptils_semantic),
    HPCase("srsanet", build_srsanet,
           paths=[("get_srsanet_paths", dict(split="train")), ("get_srsanet_paths", dict(split="test"))],
           datasets=[("get_srsanet_dataset", dict(split="val", **BOUNDARIES)),
                     ("get_srsanet_dataset", dict(patch_shape=PATCH_2D, split="train", binary=True))],
           loaders=[("get_srsanet_loader", dict(patch_shape=PATCH_2D, batch_size=2, split="train", boundaries=True))]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reader_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_monuseg_labels_hold_each_polygon_once(tmp_path):
    """MoNuSeg's converted labels hold one instance per drawable polygon of the XML."""
    build_monuseg(tmp_path)
    _, label_paths = modules("monuseg", HISTOPATHOLOGY)[1].get_monuseg_paths(str(tmp_path), "test")
    for path in label_paths:
        assert 0 < len(np.unique(np.asarray(Image.open(path)))) - 1 <= 10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xml_rasterization_matches_jax(seed, tmp_path):
    """``util.generate_labeled_array_from_xml`` (the port draws every polygon on one canvas and reads
    it back in the polygon's bounding box) gives the JAX package's labels on polygons of every size,
    overlapping each other and the border, with fractional vertices."""
    from torch_em_tpu.data.datasets import util as jax_util
    from torch_em_tpu_torch.data.datasets import util as port_util

    rng = np.random.default_rng(seed)
    shape = ((64, 80), (50, 50), (97, 61))[seed]
    path = tmp_path / "annotations.xml"
    path.write_text(_polygons_xml(rng, 120, shape))
    np.testing.assert_array_equal(port_util.generate_labeled_array_from_xml(shape, str(path)),
                                  jax_util.generate_labeled_array_from_xml(shape, str(path)))


def test_hp_modules_and_public_names_match_jax():
    check_domain_matches_jax(jax_hp, port_hp, HISTOPATHOLOGY, 24)


def test_every_hp_module_has_a_parity_case():
    """Each port histopathology module has a case in one of the ``test_torch_datasets_hp_*`` files."""
    check_every_module_has_a_case(port_hp, Path(__file__).parent.glob("test_torch_datasets_hp_*.py"), "HPCase")


def test_zoo_exports_monuseg():
    """``from torch_em_tpu_torch.data.datasets import get_monuseg_loader`` works."""
    from torch_em_tpu_torch.data.datasets import get_monuseg_loader

    assert get_monuseg_loader is modules("monuseg", HISTOPATHOLOGY)[1].get_monuseg_loader
