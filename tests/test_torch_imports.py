"""The port imports nothing of JAX, flax or the JAX package.

The machine with the card has PyTorch, numpy and scipy (and, lately,
PyYAML, tqdm, pandas, PIL and requests) but none of jax, flax, optax, h5py,
tensorstore, imageio, sklearn, napari, tensorboardX, tensorboard, wandb,
matplotlib, onnx, pydicom, nibabel, pycocotools, geopandas, rasterio or shapely, and
neither machine has timm, segment_anything or mamba_ssm, whose models the
port builds itself. The port needs none of the optional ones: here most of
them are installed, so a
subprocess blocks them (``sys.modules[name] = None`` makes an import raise)
before it imports every module of the port, ``chip_smoke`` and the probe
scripts ``scripts/torch_parity3d.py``, ``scripts/torch_parity2d.py`` and
``scripts/torch_spoco2d.py`` (none of the port's files, ``chip_smoke`` or ``scripts/torch_*.py``
imports ``scripts/jax_quality_seeds.py`` or ``jax_quality_pairs.py``, which import the JAX package), and
writes HDF5 test data and reads it back and writes into it again (HDF5 needs no h5py: the port's own
``utils/hdf5.py`` reads and writes it), writes a zarr and an N5 volume and reads them back (they need no
tensorstore: the port's own ``utils/zarr_n5.py`` reads and writes them), clusters with ``HDBScan`` (native, no
sklearn), builds the tensorboard loggers (the trainer's, self-training's and classification's) and writes
scalars through them and draws a confusion matrix (no tensorboardX, tensorboard, sklearn or matplotlib),
reads a PNG file, writes a logger's image, shows a validation sample and builds the wandb logger and a
classification metric that only sklearn computes, which must raise an ImportError that names PIL, PIL,
napari, sklearn and wandb; the classification package's metrics in numpy, the accuracy and the F1 score, run. With yaml, sklearn, pandas, tqdm,
matplotlib and onnx blocked too, a committed ``.npz`` forest loads, a ``Shallow2DeepDataset``
gives its items, and a trainer's checkpoint exports to a bioimage.io package (its rdf as JSON
text) and imports back; ``prepare_shallow2deep`` (with tqdm, which the card has) and
``prepare_shallow2deep_advanced`` fit forests natively and write them as ``.npz`` and as sklearn's
pickle, which loads back with the same trees, a classification trainer validates with the macro F1
score in numpy; a classification score the port does not compute raises naming scikit-learn,
``prepare_shallow2deep`` without tqdm tqdm,
``evaluate_enhancers`` pandas, ``check_loader`` matplotlib and the ONNX conversion onnx. Those
packages, and the dataset zoo's download and conversion packages (requests, gdown, rarfile,
kaggle, nd2, cloud-volume, s3fs and zarr, and the histopathology and medical readers' scanpy,
huggingface_hub and tiffslide, blocked here too, with the zoo's every module imported, the 81
light-microscopy, 24 histopathology and 60 medical readers among them), may be imported inside a
function, never at module level; sklearn only inside ``forest.forest_to_sklearn`` and
``ClassificationMetric``'s fallback. With pydicom, nibabel, imageio, pycocotools, geopandas, rasterio and
shapely blocked (PIL and pandas let in) the port converts a small 3D-IRCADb (DICOM), UroCell (NIfTI),
OrgLine (COCO), PUMA (GeoJSON) and HEST (GeoJSON and WKB) layout and writes a PNG and a TIFF; none of
the seven is imported anywhere in the port. The native host library builds under
``torch_em_tpu_torch/_build/`` and writes nothing under ``HOME`` or
``TMPDIR``.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "torch_em_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "h5py", "tqdm", "PIL", "imageio", "sklearn", "napari", "pandas", "tensorboardX",
           "tensorboard", "wandb", "matplotlib", "torch_em_tpu", "timm", "segment_anything", "mamba_ssm", "yaml",
           "onnx", "tensorstore", "requests", "gdown", "rarfile", "kaggle", "nd2", "pycocotools", "cloudvolume", "s3fs",
           "zarr", "geopandas", "rasterio", "shapely", "scanpy", "huggingface_hub", "pydicom", "tiffslide", "nibabel")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import torch_em_tpu_torch
names = [m.name for m in pkgutil.walk_packages(torch_em_tpu_torch.__path__, "torch_em_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert set(["torch_em_tpu_torch.parallel.halo", "torch_em_tpu_torch.parallel.checkpoint",
            "torch_em_tpu_torch.multi_gpu_training", "torch_em_tpu_torch.shallow2deep.forest",
            "torch_em_tpu_torch.shallow2deep.prepare_shallow2deep", "torch_em_tpu_torch.utils.modelzoo",
            "torch_em_tpu_torch.utils.medical_io", "torch_em_tpu_torch.utils.debug",
            "torch_em_tpu_torch.data.datasets.util", "torch_em_tpu_torch.data.datasets.electron_microscopy.cem",
            "torch_em_tpu_torch.data.datasets.electron_microscopy.nisb"]) <= set(names)
lm = "torch_em_tpu_torch.data.datasets.light_microscopy."
assert len([n for n in names if n.startswith(lm)]) == 81
assert set(lm + m for m in ("dsb", "livecell", "yeaz", "orgline", "idr0095", "e11bio", "liconn", "parhyale_regen",
                            "yeastms", "synthmt", "nuc_morph")) <= set(names)
from torch_em_tpu_torch.data.datasets import get_dsb_loader, get_livecell_loader
hp, med = "torch_em_tpu_torch.data.datasets.histopathology.", "torch_em_tpu_torch.data.datasets.medical."
assert len([n for n in names if n.startswith(hp)]) == 24 and len([n for n in names if n.startswith(med)]) == 60
assert set([hp + "monuseg", hp + "hest", hp + "puma", hp + "conic", med + "amos", med + "sa_med2d", med + "kits",
            med + "chaos", med + "plethora"]) <= set(names)
from torch_em_tpu_torch.data.datasets import get_amos_loader, get_monuseg_loader
from torch_em_tpu_torch.multi_gpu_training import DataParallelTrainer, train_multi_device, train_multi_gpu
from torch_em_tpu_torch.parallel import (get_mesh, halo_sharded_predict, replicate, restore_sharded_checkpoint,
                                         save_sharded_checkpoint, shard_batch)
from torch_em_tpu_torch.data import DistributedIndexSampler
from torch_em_tpu_torch.models.unet import ConvBlock2d, ConvBlock3d, Upsampler2d, Upsampler3d
from torch_em_tpu_torch.ops.native import is_available
assert callable(is_available)
import chip_smoke
assert callable(chip_smoke.main)
import runpy
runpy.run_path("scripts/torch_parity3d.py", run_name="probe")
runpy.run_path("scripts/torch_parity2d.py", run_name="probe")
runpy.run_path("scripts/torch_spoco2d.py", run_name="probe")
import types
import numpy as np
from torch_em_tpu_torch.metric import HDBScan
from torch_em_tpu_torch.self_training import SelfTrainingTensorboardLogger
from torch_em_tpu_torch.trainer import TensorboardLogger, WandbLogger
from torch_em_tpu_torch.utils import io, test, validation
from torch_em_tpu_torch.classification import ClassificationLogger, ClassificationMetric
assert ClassificationMetric()(np.array([0, 1, 2, 2]), np.array([0, 1, 1, 2])) == 0.25
# the sklearn.metrics scores of two label vectors are the port's own, in numpy
assert abs(ClassificationMetric("f1_score", average="macro")(np.array([0, 1, 2, 2]), np.array([0, 1, 1, 2]))
           - (1 - (1 + 2 / 3 + 2 / 3) / 3)) < 1e-12
trainer = types.SimpleNamespace(name="run", log_image_interval=1, loss=None)
import os, tempfile
# HDF5 needs no h5py: the port's own module writes the test data and reads it back
h5_path = os.path.join(tempfile.mkdtemp(), "data.h5")
test.create_segmentation_test_data(h5_path, "raw", "labels", (4, 4), (2, 2))
written = io.load_data(h5_path, "raw")
assert written.shape == (4, 4) and written.dtype == np.float64 and written[:].min() >= 0 and written[:].max() < 1
assert io.load_data(h5_path, "labels")[:].max() < 4
del written  # a reading handle holds HDF5's shared lock, which refuses a writer
io.write_data(h5_path, "raw", np.arange(16, dtype="float32").reshape(4, 4), chunks=(2, 2))
assert (io.load_data(h5_path, "raw")[1:3, ::2] == np.array([[4, 6], [8, 10]], dtype="float32")).all()
# HDBSCAN needs no sklearn (the native ops.native.hdbscan), the tensorboard loggers no tensorboardX, tensorboard,
# sklearn or matplotlib (the port's own utils/tensorboard.py; the confusion matrix in numpy); an image needs PIL
log_root = tempfile.mkdtemp()
assert (HDBScan(5, 0.1, False)(np.repeat(np.eye(2, dtype="float32")[:, :, None], 8, axis=2)) > 0).all()
for logger_class in (TensorboardLogger, SelfTrainingTensorboardLogger, ClassificationLogger):
    logger = logger_class(trainer, log_root)
    logger.tb.add_scalar("train/loss", 0.5, 0)
    logger.tb.close()
classification = ClassificationLogger(trainer, log_root)
classification.log_validation(1, 0.5, 0.25, None, None, None)
classification.tb.close()
from torch_em_tpu_torch.classification.classification_logger import make_confusion_matrix
matrix = make_confusion_matrix(np.array([0, 1, 2]), np.array([0, 2, 2]))
assert matrix.dtype == np.uint8 and matrix.shape[0] == 3
from torch_em_tpu_torch.utils.tensorboard import read_events
assert [(step, tag) for _, step, tag, _ in read_events(os.path.join(log_root, "logs", "run"))] == \
    [(0, "train/loss")] * 3 + [(1, "validation/loss"), (1, "validation/metric")]
for call, package in ((lambda: validation._visualize(np.zeros((4, 4)), np.zeros((4, 4)), None), "napari"),
                      (lambda: TensorboardLogger(trainer, log_root).tb.add_image("x", np.zeros((3, 2, 2))), "PIL"),
                      (lambda: ClassificationMetric("roc_auc_score"), "sklearn"),
                      (lambda: WandbLogger(trainer, None), "wandb")):
    try:
        call()
    except ImportError as e:
        assert package in str(e), e
    else:
        raise AssertionError(package + " was not needed")
# zarr and N5 need no tensorstore: the port's own module (utils/zarr_n5.py and its native blosc build) writes
# them and reads them back
for name in ("data.zarr", "data.n5"):
    store = os.path.join(tempfile.mkdtemp(), name)
    volume = np.arange(2 * 5 * 7, dtype="uint16").reshape(2, 5, 7)
    io.write_data(store, "volumes/raw", volume, chunks=(1, 4, 4))
    assert io.get_dataset_shape(store, "volumes/raw") == (2, 5, 7)
    stored = io.load_data(store, "volumes/raw")
    assert isinstance(stored, io.LazyTensorStore) and (stored[1, 2:5] == volume[1, 2:5]).all()
    assert (stored[...] == volume).all()
for read in (io.load_data, io.load_image):
    try:
        read("image.png")
    except ImportError as e:
        assert "PIL" in str(e), e
    else:
        raise AssertionError("reading a PNG without PIL did not raise")
# Shallow2Deep and the bioimage.io round trip with sklearn, pandas, yaml, tqdm and matplotlib blocked
import tempfile
from torch_em_tpu_torch import DataLoader, UNet2d, default_segmentation_trainer
from torch_em_tpu_torch.shallow2deep import (Shallow2DeepDataset, evaluate_enhancers, load_forest,
                                             prepare_shallow2deep, prepare_shallow2deep_advanced)
from torch_em_tpu_torch.utils import debug, modelzoo
forest = load_forest("scripts/s2d_forests/rf_0000.npz")
raw = np.random.default_rng(0).random((2, 48, 48)).astype("float32")
ds = Shallow2DeepDataset(raw, None, (raw > 0.5).astype("float32"), None, patch_shape=(1, 32, 32), ndim=2,
                         rf_paths=["scripts/s2d_forests/rf_0000.npz"], filter_config=forest.feature_config)
x, y = ds[0]
assert x.shape == (1, 32, 32) and 0 <= x.min() and x.max() <= 1
with tempfile.TemporaryDirectory() as tmp:
    loader = DataLoader(ds, batch_size=1)
    # logger=None: the default logger's images need PIL, blocked here
    trainer = default_segmentation_trainer("s2d", UNet2d(1, 1, depth=2, initial_features=4, device="cpu"), loader,
                                           loader, device="cpu", mixed_precision=False, save_root=tmp, logger=None)
    trainer.fit(iterations=1)
    assert modelzoo.export_bioimageio_model(trainer.checkpoint_folder, tmp + "/pkg", input_data=x, device="cpu",
                                            config=modelzoo.get_shallow2deep_config("scripts/s2d_forests"))
    model, _ = modelzoo.import_bioimageio_model(tmp + "/pkg", device="cpu")
    assert open(tmp + "/pkg/rdf.yaml").read().startswith("{{")
    # the forests are fitted natively and written as .npz and as sklearn's pickle; prepare_shallow2deep shows
    # its progress with tqdm, which the card has
    np.save(tmp + "/raw.npy", raw)
    np.save(tmp + "/labels.npy", (raw > 0.5).astype("uint8"))
    sys.modules.pop("tqdm")
    prepare_shallow2deep(tmp + "/raw.npy", None, tmp + "/labels.npy", None, (1, 24, 24), (1, 32, 32), 2, 1,
                         tmp + "/rfs", 2, n_estimators=3, random_state=0)
    sys.modules["tqdm"] = None
    prepare_shallow2deep_advanced(tmp + "/raw.npy", None, tmp + "/labels.npy", None, (1, 24, 24), (1, 32, 32), 4, 1,
                                  tmp + "/advanced", 2, forests_per_stage=2, sample_fraction_per_stage=0.5,
                                  sampling_strategy="worst_tiles", n_estimators=3, random_state=0)
    from torch_em_tpu_torch.shallow2deep import node_differences
    for folder, n in (("rfs", 2), ("advanced", 4)):
        assert sorted(os.listdir(tmp + "/" + folder)) == sorted(["rf_%04d.npz" % i for i in range(n)] +
                                                                ["rf_%04d.pkl" % i for i in range(n)])
        npz, pkl = (load_forest(tmp + "/" + folder + "/rf_0000" + ext) for ext in (".npz", ".pkl"))
        assert npz.n_estimators == 3 and node_differences(pkl, npz) == [] and pkl.feature_ndim == 2
    # a classification trainer validated with the macro F1 score
    from torch_em_tpu_torch import resnet3d_18
    from torch_em_tpu_torch.classification import default_classification_loader, default_classification_trainer
    volumes = [np.random.default_rng(i).normal(i % 2, size=(1, 16, 16, 16)).astype("float32") for i in range(4)]
    cls = default_classification_trainer(
        "cls", resnet3d_18(1, 2, device="cpu"), default_classification_loader(volumes, np.arange(4) % 2, 2),
        default_classification_loader(volumes, np.arange(4) % 2, 2), metric=ClassificationMetric("f1_score",
        average="macro"), logger=None, device="cpu", mixed_precision=False, save_root=tmp)
    cls.fit(iterations=1)
    assert 0.0 <= cls.current_metric <= 1.0
    for call, package in ((lambda: prepare_shallow2deep(None, None, None, None, (1, 8, 8), (1, 8, 8), 1, 1, tmp, 2),
                           "tqdm"),
                          (lambda: evaluate_enhancers(raw, raw, {{}}, tmp, None), "pandas"),
                          (lambda: debug.check_loader(loader, 1), "matplotlib"),
                          (lambda: modelzoo.convert_to_onnx(tmp + "/pkg"), "onnx")):
        try:
            call()
        except ImportError as e:
            assert package in str(e), e
        else:
            raise AssertionError(package + " was not needed")
# the zoo's conversions with pydicom, nibabel, imageio, pycocotools, geopandas, rasterio and shapely blocked (PIL
# and pandas, which the card has, let in): 3D-IRCADb's DICOM series, UroCell's NIfTI volumes, OrgLine's COCO
# masks, PUMA's and HEST's nuclei, and a PNG and a multi-page TIFF written and read back
import glob, zipfile
for name in ("PIL", "pandas"):
    sys.modules.pop(name)
from torch_em_tpu_torch.data.datasets import get_hest_data, get_ircadb_paths, get_puma_paths, get_uro_cell_paths
from torch_em_tpu_torch.data.datasets.light_microscopy import orgline
from torch_em_tpu_torch.utils import dicom, medical_io
sys.path.insert(0, "scripts")
import torch_conversion_layouts as layouts
with tempfile.TemporaryDirectory() as tmp:
    layouts.ircadb_layout(tmp + "/ircadb", ["3Dircadb1.1"], [(dicom.RLE_LOSSLESS, dicom.IMPLICIT_VR_LITTLE_ENDIAN)],
                          0, (3, 16, 16))
    assert [os.path.basename(p) for p in get_ircadb_paths(tmp + "/ircadb")] == ["3Dircadb1.1.h5"]
    os.makedirs(tmp + "/uro")
    with zipfile.ZipFile(tmp + "/uro/uro_cell.zip", "w") as zf:
        for sub in ("data", "mito/instance"):
            medical_io.save_nifti(tmp + "/v.nii.gz", np.arange(24, dtype="uint8").reshape(2, 3, 4))
            zf.write(tmp + "/v.nii.gz", "UroCell-master/" + sub + "/v.nii.gz")
    assert len(get_uro_cell_paths(tmp + "/uro", "mito")) == 1
    layouts.orgline_layout(tmp + "/org/data2", (4, 2), (192, 256))
    orgline._prepare_data(tmp + "/org/data2", "stomach")
    assert glob.glob(tmp + "/org/data2/stomach/*/*.h5")
    layouts.puma_layout(tmp + "/puma", 1, 10)
    assert len(get_puma_paths(tmp + "/puma", "train")) == 1
    layouts.hest_layout(tmp + "/hest", 8)
    get_hest_data(tmp + "/hest")
    assert sorted(os.listdir(tmp + "/hest/preprocessed")) == ["NCBI91.h5", "TENX90.h5"]
    for name, image in (("a.png", np.arange(12, dtype="uint8").reshape(3, 4)),
                        ("b.tif", np.ones((2, 3, 4), "float32"))):
        io.write_data(tmp + "/" + name, None, image)
        assert (io.load_image(tmp + "/" + name) == image).all()
print(len(names))
"""


def _port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("torch_*.py"))


def test_port_imports_with_jax_stack_blocked():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 38


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert "torch_em_tpu." not in text
    # the JAX package's seed driver and controlled pairs (scripts/jax_quality_*.py) write records the port reads
    assert not re.search(r"^\s*(from|import)\s+jax_quality_|import_module\(.jax_quality_|jax_quality_\w+\.py.\)", text,
                         flags=re.MULTILINE)
    assert "import jax" not in text
    pattern = r"^\s*(from|import)\s+(jax|flax|optax|torch_em_tpu)\b(?!_torch)"
    assert not re.search(pattern, text, flags=re.MULTILINE)
    # h5py, tensorstore, tensorboardX and tensorboard nowhere: the port reads and writes HDF5 with its own
    # utils/hdf5.py, zarr and N5 with its own utils/zarr_n5.py, TensorBoard event files with its own
    # utils/tensorboard.py
    assert not re.search(r"^\s*(from|import)\s+(h5py|tensorstore|tensorboardX|tensorboard)\b"
                         r"|import_module\(.(h5py|tensorstore|tensorboardX|tensorboard).\)", text, flags=re.MULTILINE)
    # PIL, sklearn, napari, pandas, tensorboard, wandb, matplotlib, tqdm, yaml, onnx, tensorstore and the zoo's
    # download and conversion packages only inside the functions that need them
    assert not re.search(r"^(from|import)\s+(h5py|PIL|sklearn|napari|pandas|tensorboard|wandb|matplotlib|tqdm"
                         r"|yaml|onnx|tensorstore|requests|gdown|rarfile|kaggle|zarr|s3fs|cloudvolume|quilt3|nd2"
                         r"|scanpy|huggingface_hub|tiffslide)\b", text, flags=re.MULTILINE)
    # pydicom, nibabel, imageio, pycocotools, geopandas, rasterio and shapely nowhere: the port reads DICOM, NIfTI,
    # image files, COCO masks and GeoJSON/WKB polygons with its own utils/dicom.py, medical_io.py, io.py (PIL),
    # coco.py and geometry.py
    assert not re.search(r"^\s*(from|import)\s+(pydicom|nibabel|imageio|pycocotools|geopandas|rasterio|shapely)\b"
                         r"|import_module\(.(pydicom|nibabel|imageio|pycocotools|geopandas|rasterio|shapely)",
                         text, flags=re.MULTILINE)


# the only places where the port may import sklearn: building sklearn's forest object, and the classification
# metrics that scores.SCORES does not compute
SKLEARN_ALLOWED = {("torch_em_tpu_torch/shallow2deep/forest.py", "forest_to_sklearn"),
                   ("torch_em_tpu_torch/classification/classification.py", "ClassificationMetric.__init__")}


def _sklearn_imports(path):
    """(file, the qualified name of the enclosing function) of each sklearn import in a source file."""
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            name = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = f"{scope}.{child.name}" if scope else child.name
            modules = []
            if isinstance(child, ast.Import):
                modules = [alias.name for alias in child.names]
            elif isinstance(child, ast.ImportFrom):
                modules = [child.module or ""]
            elif isinstance(child, ast.Call) and getattr(child.func, "attr", getattr(child.func, "id", "")) in (
                    "import_module", "__import__") and child.args and isinstance(child.args[0], ast.Constant):
                modules = [str(child.args[0].value)]
            if any(m == "sklearn" or m.startswith("sklearn.") for m in modules):
                found.append((str(path.relative_to(REPO)), scope))
            visit(child, name)

    visit(ast.parse(path.read_text()), "")
    return found


def test_sklearn_imported_only_where_allowed():
    found = [hit for path in _port_sources() for hit in _sklearn_imports(path)]
    assert set(found) == SKLEARN_ALLOWED, found


_BUILD_NATIVE = """
import sys
from pathlib import Path
from torch_em_tpu_torch.ops import _build, native
source = Path(sys.argv[1])
source.write_text(native.SOURCE.read_text() + "// a copy with another hash, so that it builds\\n")
print(_build.compile_library("tem_native", native._find_gxx, native.GXX_FLAGS, [source]))
"""


def test_native_library_builds_under_the_package(tmp_path):
    """A build of the native host library writes its library under torch_em_tpu_torch/_build/
    and nothing under HOME or TMPDIR."""
    home, tmp = tmp_path / "home", tmp_path / "tmp"
    home.mkdir()
    tmp.mkdir()
    env = dict(os.environ, HOME=str(home), TMPDIR=str(tmp))
    proc = subprocess.run([sys.executable, "-c", _BUILD_NATIVE, str(tmp_path / "tem_native.cpp")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = Path(proc.stdout.split()[-1])
    try:
        assert lib.is_file() and lib.parent.parent == PACKAGE / "_build"
        assert sorted(p.name for p in lib.parent.iterdir()) == ["libtem_native.so"]
        assert not list(home.iterdir()) and not list(tmp.iterdir())
    finally:
        shutil.rmtree(lib.parent, ignore_errors=True)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    """Without a CUDA device, or without the rest of the repository, the smoke run
    exits nonzero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs in full here")
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _run_fanout(late_group=None):
    """chip_smoke.run_fanout(((8,), (21,))) in a subprocess; the child of ``late_group`` starts 600 s late."""
    code = ("import subprocess, chip_smoke\n"
            "popen = subprocess.Popen\n"
            "def late(args, **kwargs):\n"
            f"    if args[-1] == {late_group!r}:\n"
            "        args = ['sh', '-c', 'sleep 600; exec \"$0\" \"$@\"', *args]\n"
            "    return popen(args, **kwargs)\n"
            "subprocess.Popen = late\n"
            "try:\n"
            "    print('launches', chip_smoke.run_fanout(((8,), (21,))))\n"
            "except RuntimeError as e:\n"
            "    print(e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_chip_smoke_fanout_fails_without_card():
    """Without a CUDA device each child process of the smoke run's fan-out exits nonzero at
    once: the fan-out raises naming every group instead of returning launches. The first child
    to exit stops the other, which may still be starting: each group shows its exit code 2 or
    that it was stopped, and at least one its exit code."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fan-out's groups run in full here")
    out = _run_fanout()
    groups = re.findall(r"phases \((8|21),\) \((exit 2|stopped)\)", out)
    assert sorted(g for g, _ in groups) == ["21", "8"], out
    assert "exit 2" in [e for _, e in groups] and "launches" not in out, out


def test_chip_smoke_fanout_names_a_stopped_group():
    """A group still running when another fails is stopped and named so; the one that failed
    keeps its exit code."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fan-out's groups run in full here")
    out = _run_fanout(late_group="21")
    assert "phases (8,) (exit 2), phases (21,) (stopped)" in out and "launches" not in out, out
