"""Shared machinery for the dataset zoo (torch-em data/datasets/util.py), the port's own copy of
``torch_em_tpu/data/datasets/util.py``.

Download with checksum verification (:106), gdrive/empiar/kaggle/tcia/synapse/
cryo-ET variants (:133-305, import-guarded), archive unpacking (:316-398),
kwargs plumbing between dataset and loader (:306,:399), instance label
transforms (:423), resize plumbing (:452) and annotation conversion helpers
(:495,:540).
"""

import hashlib
import inspect
import math
import os
import zipfile
from shutil import copyfileobj
from typing import Optional, Sequence, Tuple
from warnings import warn

import numpy as np

BIOIMAGEIO_IDS = {
    "covid_if": "ilastik/covid_if_training_data",
    "cremi": "ilastik/cremi_training_data",
    "dsb": "ilastik/stardist_dsb_training_data",
    "hpa": "",
    "isbi2012": "ilastik/isbi2012_neuron_segmentation_challenge",
    "kasthuri": "",
    "livecell": "ilastik/livecell_dataset",
    "lucchi": "",
    "mitoem": "ilastik/mitoem_segmentation_challenge",
    "monuseg": "deepimagej/monuseg_digital_pathology_miccai2018",
    "ovules": "",
    "plantseg_root": "ilastik/plantseg_root",
    "plantseg_ovules": "ilastik/plantseg_ovules",
    "platynereis": "ilastik/platynereis_em_training_data",
    "snemi": "",
    "uro_cell": "",
    "vnc": "ilastik/vnc",
}
"""@private"""


def get_bioimageio_dataset_id(dataset_name):
    """@private"""
    assert dataset_name in BIOIMAGEIO_IDS
    return BIOIMAGEIO_IDS[dataset_name]


def get_checksum(filename: str) -> str:
    """Get the SHA256 checksum of a file (reference datasets/util.py:76)."""
    with open(filename, "rb") as f:
        file_ = f.read()
        return hashlib.sha256(file_).hexdigest()


def _check_checksum(path, checksum):
    if checksum is not None:
        this_checksum = get_checksum(path)
        if this_checksum != checksum:
            raise RuntimeError(
                "The checksum of the download does not match the expected checksum."
                f"Expected: {checksum}, got: {this_checksum}"
            )
        print("Download successful and checksums agree.")
    else:
        warn("The file was downloaded, but no checksum was provided, so the file may be corrupted.")


def download_source(path: str, url: str, download: bool, checksum: Optional[str] = None,
                    verify: bool = True) -> None:
    """Download data via https (reference datasets/util.py:106)."""
    if os.path.exists(path):
        return
    if not download:
        raise RuntimeError(f"Cannot find the data at {path}, but download was set to False.")

    import requests

    with requests.get(url, stream=True, allow_redirects=True, verify=verify, timeout=120) as r:
        r.raise_for_status()
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            copyfileobj(r.raw, f)
        os.replace(tmp, path)
    _check_checksum(path, checksum)


def download_source_gdrive(path: str, url: str, download: bool, checksum: Optional[str] = None,
                           download_type: str = "zip", expected_samples: int = 10000,
                           quiet: bool = True) -> None:
    """Download data from google drive (reference datasets/util.py:133);
    requires the optional gdown dependency."""
    if os.path.exists(path):
        return
    if not download:
        raise RuntimeError(f"Cannot find the data at {path}, but download was set to False.")
    try:
        import gdown
    except ImportError as e:
        raise RuntimeError("gdown is required for google-drive downloads.") from e
    if download_type == "zip":
        gdown.download(url, path, quiet=quiet)
        _check_checksum(path, checksum)
    else:
        gdown.download_folder(url, output=path, quiet=quiet)


def download_source_empiar(path: str, access_id: str, download: bool) -> str:
    """Download data from EMPIAR (reference datasets/util.py:180); requires ascp."""
    download_path = os.path.join(path, access_id)
    if os.path.exists(download_path):
        return download_path
    if not download:
        raise RuntimeError(f"Cannot find the data at {path}, but download was set to False.")
    import subprocess

    if not os.path.exists(os.path.expanduser("~/.aspera")):
        raise RuntimeError("Need aspera-cli (ascp) to download EMPIAR data.")
    os.makedirs(path, exist_ok=True)
    subprocess.run([
        os.path.expanduser("~/.aspera/cli/bin/ascp"), "-QT", "-l", "200M", "-P", "33001",
        "-i", os.path.expanduser("~/.aspera/cli/etc/asperaweb_id_dsa.openssh"),
        f"emp_ext2@fasp.ebi.ac.uk:/{access_id}", path,
    ], check=True)
    return download_path


def download_source_kaggle(path: str, dataset_name: str, download: bool,
                           competition: bool = False):
    """Download data from kaggle (reference datasets/util.py:219); requires the kaggle api."""
    if not download:
        raise RuntimeError(f"Cannot find the data at {path}, but download was set to False.")
    try:
        from kaggle.api.kaggle_api_extended import KaggleApi
    except ImportError as e:
        raise RuntimeError("Please install the kaggle api and set up your credentials.") from e
    api = KaggleApi()
    api.authenticate()
    if competition:
        api.competition_download_files(dataset_name, path=path, quiet=False)
    else:
        api.dataset_download_files(dataset_name, path=path, quiet=False)


def download_source_tcia(path, url, dst, csv_filename, download):
    """Download data from TCIA (reference datasets/util.py:250); requires tcia_utils."""
    if not download:
        raise RuntimeError(f"Cannot find the data at {path}, but download was set to False.")
    try:
        from tcia_utils import nbia
    except ImportError as e:
        raise RuntimeError("tcia_utils is required for TCIA downloads.") from e
    manifest = nbia.getSeries(collection=url.split("=")[-1])
    nbia.downloadSeries(series_data=manifest, path=dst, csv_filename=csv_filename)


def download_source_synapse(path: str, entity: str, download: bool) -> None:
    """Download data from synapse (reference datasets/util.py:277); requires synapseclient."""
    if not download:
        raise RuntimeError(f"Cannot find the data at {path}, but download was set to False.")
    try:
        import synapseclient
        import synapseutils
    except ImportError as e:
        raise RuntimeError("synapseclient is required for synapse downloads.") from e
    token = os.environ.get("SYNAPSE_TOKEN")
    if token is None:
        raise RuntimeError("Please set the SYNAPSE_TOKEN environment variable.")
    syn = synapseclient.Synapse()
    syn.login(authToken=token)
    synapseutils.syncFromSynapse(syn, entity=entity, path=path)


def download_from_cryo_et_portal(path: str, dataset_id: int, download: bool) -> str:
    """Download data from the cryo-ET data portal (reference datasets/util.py:566)."""
    if not download:
        raise RuntimeError(f"Cannot find the data at {path}, but download was set to False.")
    try:
        from cryoet_data_portal import Client, Dataset
    except ImportError as e:
        raise RuntimeError("cryoet_data_portal is required for portal downloads.") from e
    client = Client()
    dataset = Dataset.get_by_id(client, dataset_id)
    dataset.download_everything(dest_path=path)
    return path


def update_kwargs(kwargs, key, value, msg=None):
    """@private"""
    if key in kwargs:
        msg = f"{key} will be over-ridden in loader kwargs." if msg is None else msg
        warn(msg)
    kwargs[key] = value
    return kwargs


def unzip_tarfile(tar_path: str, dst: str, remove: bool = True) -> None:
    """Unpack a tar archive (reference datasets/util.py:316)."""
    import tarfile

    if tar_path.endswith(".tar.gz") or tar_path.endswith(".tgz"):
        access_mode = "r:gz"
    elif tar_path.endswith(".tar"):
        access_mode = "r:"
    else:
        raise ValueError(f"The provided file isn't a supported archive to unpack: {tar_path}")
    with tarfile.open(tar_path, access_mode) as tar:
        tar.extractall(dst)
    if remove:
        os.remove(tar_path)


def unzip_rarfile(rar_path: str, dst: str, remove: bool = True, use_rarfile: bool = True) -> None:
    """Unpack a rar archive (reference datasets/util.py:341); requires rarfile/aspose."""
    if use_rarfile:
        import rarfile

        with rarfile.RarFile(rar_path) as f:
            f.extractall(path=dst)
    else:
        import aspose.zip as az

        with az.rar.RarArchive(rar_path) as archive:
            archive.extract_to_directory(dst)
    if remove:
        os.remove(rar_path)


def unzip(zip_path: str, dst: str, remove: bool = True) -> None:
    """Unpack a zip archive (reference datasets/util.py:385)."""
    with zipfile.ZipFile(zip_path, "r") as f:
        f.extractall(dst)
    if remove:
        os.remove(zip_path)


def split_kwargs(function, **kwargs):
    """Split kwargs into those accepted by `function` and the rest
    (reference datasets/util.py:399)."""
    function_parameters = list(inspect.signature(function).parameters)
    parameter_names = list(filter(lambda name: name in function_parameters, kwargs.keys()))
    function_kwargs = {name: kwargs.pop(name) for name in parameter_names}
    return function_kwargs, kwargs


def ensure_transforms(ndim, **kwargs):
    """@private"""
    from ...transforms import get_augmentations, get_raw_transform

    if "raw_transform" not in kwargs:
        kwargs["raw_transform"] = get_raw_transform()
    if "transform" not in kwargs:
        kwargs["transform"] = get_augmentations(ndim=ndim)
    return kwargs


def add_instance_label_transform(
    kwargs, add_binary_target: bool, label_dtype=None, binary: bool = False,
    boundaries: bool = False, offsets: Optional[Sequence[Sequence[int]]] = None,
    binary_is_exclusive: bool = True,
):
    """Add an instance segmentation label transform from binary/boundaries/offsets
    options (reference datasets/util.py:423)."""
    from ...transforms import AffinityTransform, BoundaryTransform, labels_to_binary

    if binary_is_exclusive:
        assert sum((offsets is not None, boundaries, binary)) <= 1
    else:
        assert sum((offsets is not None, boundaries)) <= 1
    if offsets is not None:
        label_transform2 = AffinityTransform(offsets=offsets, add_binary_target=add_binary_target,
                                             add_mask=True)
        msg = "Offsets are passed, but 'label_transform2' is in the kwargs. It will be over-ridden."
        kwargs = update_kwargs(kwargs, "label_transform2", label_transform2, msg=msg)
        label_dtype = "float32"
    elif boundaries:
        label_transform = BoundaryTransform(add_binary_target=add_binary_target)
        msg = "Boundaries is set to true, but 'label_transform' is in the kwargs. It will be over-ridden."
        kwargs = update_kwargs(kwargs, "label_transform", label_transform, msg=msg)
        label_dtype = "float32"
    elif binary:
        label_transform = labels_to_binary
        msg = "Binary is set to true, but 'label_transform' is in the kwargs. It will be over-ridden."
        kwargs = update_kwargs(kwargs, "label_transform", label_transform, msg=msg)
        label_dtype = "float32"
    return kwargs, label_dtype


def update_kwargs_for_resize_trafo(kwargs, patch_shape, resize_inputs, resize_kwargs=None,
                                   ensure_rgb=None):
    """Set up a resize transform in the dataset kwargs (reference datasets/util.py:452)."""
    from ...transforms import Compose, ResizeLongestSideInputs
    from ...transforms.raw import get_raw_transform

    if resize_inputs:
        assert isinstance(resize_kwargs, dict)
        target_shape = resize_kwargs.get("patch_shape")
        if len(resize_kwargs["patch_shape"]) == 3:
            target_shape = resize_kwargs["patch_shape"][1:]

        raw_trafo = ResizeLongestSideInputs(target_shape=target_shape,
                                            is_rgb=bool(ensure_rgb))
        label_trafo = ResizeLongestSideInputs(target_shape=target_shape, is_label=True)

        base_raw = kwargs.pop("raw_transform", get_raw_transform())
        base_label = kwargs.pop("label_transform", None)

        def raw_transform(raw):
            return base_raw(raw_trafo(raw))

        def label_transform(labels):
            labels = label_trafo(labels)
            return base_label(labels) if base_label is not None else labels

        kwargs["raw_transform"] = raw_transform
        kwargs["label_transform"] = label_transform
        # the resize transform produces fixed-size outputs, so patching is disabled
        patch_shape = None

    return kwargs, patch_shape


def generate_labeled_array_from_xml(shape: Tuple[int, ...], xml_file: str) -> np.ndarray:
    """Rasterize polygon annotations from an xml file (reference datasets/util.py:495)."""
    import xml.etree.ElementTree as ET

    from PIL import Image, ImageDraw

    tree = ET.parse(xml_file)
    root = tree.getroot()
    label = np.zeros(shape, dtype="uint32")
    # each polygon is drawn on one shared canvas and read back within its bounding box (with a margin
    # for PIL's rounding): its id is new, so what earlier polygons left there never matches it, and the
    # pixels are those of a fresh full-size canvas per polygon
    img = Image.new("I", (shape[1], shape[0]), 0)
    draw = ImageDraw.Draw(img)
    count = 1
    for region in root.iter("Region"):
        vertices = [
            (float(v.attrib["X"]), float(v.attrib["Y"])) for v in region.iter("Vertex")
        ]
        if len(vertices) < 3:
            continue
        xs, ys = [v[0] for v in vertices], [v[1] for v in vertices]
        x0, y0 = max(math.floor(min(xs)) - 2, 0), max(math.floor(min(ys)) - 2, 0)
        x1, y1 = min(math.ceil(max(xs)) + 3, shape[1]), min(math.ceil(max(ys)) + 3, shape[0])
        draw.polygon(vertices, outline=count, fill=count)
        if x0 < x1 and y0 < y1:
            mask = np.asarray(img.crop((x0, y0, x1, y1)))
            label[y0:y1, x0:x1][mask == count] = count
        count += 1
    return label


def convert_svs_to_array(path: str, location=(0, 0), level: int = 0, img_size=None) -> np.ndarray:
    """Convert an svs whole-slide image to a numpy array
    (reference datasets/util.py:540); requires tiffslide."""
    try:
        from tiffslide import TiffSlide
    except ImportError as e:
        raise RuntimeError("tiffslide is required for svs conversion.") from e
    slide = TiffSlide(path)
    if img_size is None:
        img_size = slide.level_dimensions[0]
    return slide.read_region(location=location, level=level, size=img_size, as_array=True)


def natsorted(items):
    """Natural sort (numeric-aware), replacing the natsort dependency."""
    import re

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def _train_test_split(*arrays, test_size: float, random_state: Optional[int] = None):
    """sklearn's ``train_test_split(*arrays, test_size=..., random_state=...)`` in numpy:
    ``ceil(test_size * n)`` items go to the test side, taken from the front of the permutation
    that ``RandomState(random_state)`` draws, the rest (in permutation order) to the train side.
    With ``random_state=None`` the permutation comes from numpy's global ``RandomState``, as
    sklearn's ``check_random_state(None)`` gives it, so ``np.random.seed`` fixes the split.
    Returns (train, test) of each array in turn, as lists."""
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError(f"the arrays have unequal lengths {[len(a) for a in arrays]}")
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} of {n} samples leaves an empty train or test side")
    perm = (np.random if random_state is None else np.random.RandomState(random_state)).permutation(n)
    train, test = perm[n_test:], perm[:n_test]
    return [[a[i] for i in part] for a in arrays for part in (train, test)]


def _approximate_mode(class_counts, n_draws, rng):
    """sklearn's ``utils.extmath._approximate_mode``: how many of ``n_draws`` each class gets, in
    proportion to ``class_counts``, floored, the rest handed out by the largest remainder with ties
    broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle_split(y, train_size: float, test_size: float, random_state: int):
    """The first split of sklearn's ``StratifiedShuffleSplit(train_size=..., test_size=...,
    random_state=...).split(X, y)`` in numpy, for float sizes: ``floor(train_size * n)`` train and
    ``ceil(test_size * n)`` test indices, each class allotted by ``_approximate_mode`` and drawn
    from its own permutation, both sides permuted last, all from ``RandomState(random_state)``.
    Returns (train indices, test indices)."""
    y = np.asarray(y)
    n = len(y)
    n_train, n_test = math.floor(train_size * n), math.ceil(test_size * n)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(f"the classes {classes[class_counts < 2].tolist()} have one member; a stratified split "
                         "needs at least two")
    if n_train + n_test > n or min(n_train, n_test) < len(classes):
        raise ValueError(f"{n_train} train and {n_test} test samples of {n} cannot hold each of "
                         f"{len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)
