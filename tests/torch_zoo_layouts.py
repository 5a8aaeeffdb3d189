"""Synthetic layouts of the dataset zoo's readers (electron and light microscopy, histopathology and
medical), and the check that holds the port's reader against the JAX package's on them.

Each case builds one small layout (8x64x64 volumes, 64x64 images) from a seed, twice: once
for each package, in folders of its own, since several readers convert their sources on first
use and cache the result beside them. The check then calls both packages' getters:

- ``get_*_paths`` return the same paths and keys (each relative to its own folder);
- the datasets have the same ``len`` and, under the same ``np.random.seed``, the same samples
  element for element, with the same shape and dtype, for several indices. The cases pass an
  identity ``transform``: the default augmentations draw from their own generators (and
  ``transform=None`` selects them). They keep the default ``raw_transform`` and the module's
  label transform (``boundaries``, ``offsets``, ``binary``, one-hot), so the targets are
  compared too;
- a batch of each loader, with the default augmentations, has the shapes of the JAX loader's;
- the files a reader converts from its sources (``converted``) exist and are equal, container
  for container, and so is every file under both folders afterwards: HDF5 by datasets and
  attributes, a zarr or N5 folder by its file set, its metadata's content and every dataset as
  the JAX package reads it (``same_store``: the chunks' compressed bytes are c-blosc's on one side
  and the port's blosc build's on the other), a gzip file (a ``.nii.gz`` volume) by its
  decompressed bytes, since its header holds the time it was written, another archive by name,
  any other file byte for byte (the builders write ``.mat`` files with ``save_mat``, which blanks
  the time in their header).

The ``no_network`` fixture refuses every connection to another host while a test runs: a reader
that would download something fails instead.

Each getter is called under the same ``np.random.seed`` on both sides: some readers split their
files with numpy's global ``RandomState`` on first use.
"""

import ast
import functools
import gzip
import importlib
import inspect
import json
import os
import pkgutil
import re
import socket
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import h5py
import numpy as np
import pytest
from PIL import Image

VOLUME, IMAGE = (8, 64, 64), (64, 64)
PATCH_3D, PATCH_2D = (4, 32, 32), (32, 32)
N_SAMPLES = 3


def identity(raw, labels):
    return raw, labels


@dataclass
class Case:
    """One layout of one module: ``build(root)`` writes it; ``paths``, ``datasets`` and ``loaders``
    are (getter name, keyword arguments) calls; ``converted`` the files the readers write."""
    module: str
    build: Callable
    datasets: List[Tuple[str, Dict]]
    paths: List[Tuple[str, Dict]] = field(default_factory=list)
    loaders: List[Tuple[str, Dict]] = field(default_factory=list)
    converted: List[str] = field(default_factory=list)
    check: Callable = None  # an extra check(jax module, port module, jax root, port root)
    prepare: Callable = None  # prepare(module, root) on each side before the getters run
    name: str = ""
    domain: str = "electron_microscopy"
    relative: bool = False  # call the getters with folders relative to the test's own, named "ref" and "port"

    @property
    def id(self):
        return self.name or self.module


LIGHT_MICROSCOPY = "light_microscopy"
LMCase = functools.partial(Case, domain=LIGHT_MICROSCOPY)
HISTOPATHOLOGY = "histopathology"
HPCase = functools.partial(Case, domain=HISTOPATHOLOGY)
MEDICAL = "medical"
MedCase = functools.partial(Case, domain=MEDICAL)


@pytest.fixture
def no_network(monkeypatch):
    """Connections to any host but this one raise ``OSError`` for the test's duration."""
    local = {"localhost", "127.0.0.1", "::1"}
    getaddrinfo, connect = socket.getaddrinfo, socket.socket.connect

    def guarded_getaddrinfo(host, *args, **kwargs):
        if host not in local:
            raise socket.gaierror(f"the zoo's tests reach no other host ({host})")
        return getaddrinfo(host, *args, **kwargs)

    def guarded_connect(sock, address):
        if sock.family in (socket.AF_INET, socket.AF_INET6) and address[0] not in local:
            raise OSError(f"the zoo's tests reach no other host ({address[0]})")
        return connect(sock, address)

    monkeypatch.setattr(socket, "getaddrinfo", guarded_getaddrinfo)
    monkeypatch.setattr(socket.socket, "connect", guarded_connect)


def modules(package, domain="electron_microscopy"):
    return importlib.import_module(f"torch_em_tpu.data.datasets.{domain}.{package}"), \
        importlib.import_module(f"torch_em_tpu_torch.data.datasets.{domain}.{package}")


# builders' pieces
def raw(rng, shape=VOLUME):
    return (rng.random(shape) * 255).astype("uint8")


def labels(rng, high=5, shape=VOLUME, dtype="uint64", low=0):
    return rng.integers(low, high, shape).astype(dtype)


def write_h5(path, **datasets):
    """``datasets`` by key, with ``__`` for ``/`` (``volumes__raw`` is ``volumes/raw``)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        for key, value in datasets.items():
            f.create_dataset(key.replace("__", "/"), data=value)


def save_image(path, array, mode=None):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(array, mode=mode).save(path) if mode else Image.fromarray(array).save(path)


def save_tif(path, array):
    """A TIFF written with PIL, a 3-D array as a multi-page stack (PIL writes no time stamp, so
    both packages' folders get the same bytes)."""
    if array.ndim == 3:
        save_stack(path, array)
    else:
        save_image(path, array)


def save_stack(path, volume):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    frames = [Image.fromarray(s) for s in volume]
    frames[0].save(path, save_all=True, append_images=frames[1:])


def save_mat(path, **variables):
    """A MATLAB file written by ``scipy.io.savemat`` with its header's time stamp blanked, so that
    both packages' folders get the same bytes."""
    from scipy.io import savemat

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    savemat(str(path), variables)
    with open(path, "r+b") as f:
        f.write(b"MATLAB 5.0 MAT-file".ljust(116))


def zip_folder(src, zip_path, arcroot):
    """Zip every file under ``src`` with names relative to ``arcroot``, then remove them."""
    with zipfile.ZipFile(zip_path, "w") as zf:
        for p in sorted(Path(src).rglob("*")):
            if p.is_file():
                zf.write(p, p.relative_to(arcroot))
    for p in sorted(Path(src).rglob("*"), reverse=True):
        p.unlink() if p.is_file() else p.rmdir()
    Path(src).rmdir()


# comparisons
def relative(value, root):
    """``value`` (paths, keys, nested lists and tuples) with ``root`` replaced by ``<root>``."""
    if isinstance(value, (list, tuple)):
        return type(value)(relative(v, root) for v in value)
    if isinstance(value, str):
        return value.replace(str(root), "<root>")
    return value


def same_samples(jax_ds, port_ds, seed=0, n=N_SAMPLES):
    assert len(port_ds) == len(jax_ds)
    for i in range(min(n, len(jax_ds))):
        np.random.seed(seed + i)
        expected = jax_ds[i]
        np.random.seed(seed + i)
        got = port_ds[i]
        expected, got = (expected, got) if isinstance(expected, tuple) else ((expected,), (got,))
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            g, e = np.asarray(g), np.asarray(e)
            assert g.shape == e.shape and g.dtype == e.dtype, (g.shape, e.shape, g.dtype, e.dtype)
            np.testing.assert_array_equal(g, e)


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], dict(obj.attrs))
        f.visititems(visit)
        out["/attrs"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
    return out


STORE_SUFFIXES = (".zarr", ".zr", ".n5")
STORE_METADATA = (".zarray", ".zattrs", ".zgroup", "attributes.json")


def _store_root(rel):
    """The zarr or N5 folder that holds the relative path ``rel``, or None."""
    for i, part in enumerate(rel.parts[:-1]):
        if Path(part).suffix in STORE_SUFFIXES:
            return Path(*rel.parts[:i + 1])
    return None


def same_store(a, b):
    """Two zarr or N5 folders equal as a user sees them: the same relative files; ``.zarray``,
    ``.zattrs``, ``.zgroup`` and ``attributes.json`` equal by content; every dataset, read through
    the JAX package's tensorstore ``load_data``, equal in shape, dtype and values. The chunks'
    compressed bytes, which the blosc implementation chooses, are not compared."""
    from torch_em_tpu.utils.io import load_data as jax_load_data

    a, b = Path(a), Path(b)
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files_a == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    datasets = []
    for rel in files_a:
        if rel.name in STORE_METADATA:
            meta_a, meta_b = json.loads((a / rel).read_text()), json.loads((b / rel).read_text())
            assert meta_a == meta_b, rel
            if rel.name == ".zarray" or (rel.name == "attributes.json" and "dimensions" in meta_a):
                datasets.append(rel.parent.as_posix())
    for key in datasets:
        key = None if key == "." else key
        da, db = jax_load_data(str(a), key), jax_load_data(str(b), key)
        assert da.shape == db.shape and da.dtype == db.dtype, key
        np.testing.assert_array_equal(da[...], db[...])


def same_container(a, b):
    """Two converted files or folders equal: HDF5 by datasets and attributes, JSON by content,
    a zarr or N5 folder by ``same_store``."""
    a, b = Path(a), Path(b)
    if a.is_dir():
        same_store(a, b)
    elif a.suffix == ".json":
        assert json.loads(a.read_text()) == json.loads(b.read_text())
    else:
        items_a, items_b = _h5_items(a), _h5_items(b)
        assert sorted(items_a) == sorted(items_b)
        for key, value in items_a.items():
            if key == "/attrs":
                assert value == items_b[key]
                continue
            (da, attrs_a), (db, attrs_b) = value, items_b[key]
            assert da.dtype == db.dtype and da.shape == db.shape, key
            np.testing.assert_array_equal(da, db)


ARCHIVES = (".zip", ".gz", ".tgz", ".tar", ".rar", ".pt")  # torch.save writes a zip with a random record


def same_tree(a, b):
    """Every file under ``a`` and ``b`` equal: the same relative paths; the files of a zarr or N5
    folder by ``same_store``; HDF5 files by datasets and attributes; a gzip file that is not a tar
    archive by its decompressed bytes; other archives (the builders' sources, whose headers hold
    write times) by name; any other file byte for byte."""
    a, b = Path(a), Path(b)
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files_a == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    stores = sorted({root for root in map(_store_root, files_a) if root is not None})
    for root in stores:
        same_store(a / root, b / root)
    for rel in files_a:
        if _store_root(rel) is not None:
            continue
        if rel.suffix in (".h5", ".hdf5", ".hdf"):
            same_container(a / rel, b / rel)
        elif rel.suffix == ".gz" and not rel.name.endswith(".tar.gz"):
            assert gzip.decompress((a / rel).read_bytes()) == gzip.decompress((b / rel).read_bytes()), rel
        elif rel.suffix not in ARCHIVES:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _call(module, name, root, kwargs, seed=1234):
    np.random.seed(seed)
    return getattr(module, name)(str(root), **kwargs)


def check_case(case, tmp_path):
    if not case.relative:
        return _check_case(case, tmp_path / "jax", tmp_path / "port")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return _check_case(case, Path("ref"), Path("port"))
    finally:
        os.chdir(cwd)


def _check_case(case, jax_root, port_root):
    for root in (jax_root, port_root):
        root.mkdir()
        case.build(root)
    jax_mod, port_mod = modules(case.module, case.domain)
    if case.prepare is not None:
        case.prepare(jax_mod, jax_root)
        case.prepare(port_mod, port_root)
    for name, kwargs in case.paths:
        expected = _call(jax_mod, name, jax_root, kwargs)
        got = _call(port_mod, name, port_root, kwargs)
        assert relative(got, port_root) == relative(expected, jax_root), name
    for k, (name, kwargs) in enumerate(case.datasets):
        kwargs = dict({"transform": identity}, **kwargs)
        expected = _call(jax_mod, name, jax_root, kwargs)
        got = _call(port_mod, name, port_root, kwargs)
        same_samples(expected, got, seed=10 * k)
        del expected, got  # closes their files before the next getter opens them
    for name, kwargs in case.loaders:
        np.random.seed(0)
        xe, ye = next(iter(getattr(jax_mod, name)(str(jax_root), **kwargs)))
        np.random.seed(0)
        xg, yg = next(iter(getattr(port_mod, name)(str(port_root), **kwargs)))
        assert tuple(xg.shape) == tuple(np.shape(xe)) and tuple(yg.shape) == tuple(np.shape(ye)), name
    for rel in case.converted:
        assert (jax_root / rel).exists(), rel
        same_container(jax_root / rel, port_root / rel)
    same_tree(jax_root, port_root)
    if case.check is not None:
        case.check(jax_mod, port_mod, jax_root, port_root)


# module lists
def public_names(module):
    """The public names a module defines at its top level (functions, classes, assignments)."""
    tree = ast.parse(Path(module.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _parameters(function):
    return str(inspect.signature(function).replace(return_annotation=inspect.Signature.empty))


def domain_modules(package):
    return sorted(m.name for m in pkgutil.iter_modules(package.__path__))


def check_domain_matches_jax(jax_package, port_package, domain, n_modules):
    """The port's modules of a domain are the JAX package's, with its public names and signatures, and
    the port's domain package exports the JAX package's getters."""
    assert domain_modules(port_package) == domain_modules(jax_package)
    assert len(domain_modules(jax_package)) == n_modules
    for name in domain_modules(jax_package):
        jax_mod, port_mod = modules(name, domain)
        assert public_names(port_mod) == public_names(jax_mod), name
        for attr in public_names(jax_mod):
            jax_obj, port_obj = getattr(jax_mod, attr), getattr(port_mod, attr)
            if inspect.isfunction(jax_obj):  # the loaders return the port's DataLoader
                assert _parameters(port_obj) == _parameters(jax_obj), (name, attr)
    assert sorted(n for n in dir(port_package) if n.startswith("get_")) == \
        sorted(n for n in dir(jax_package) if n.startswith("get_"))
    port_zoo = importlib.import_module("torch_em_tpu_torch.data.datasets")
    for getter in (n for n in dir(jax_package) if n.startswith("get_")):
        assert getattr(port_zoo, getter) is getattr(port_package, getter)


def check_every_module_has_a_case(port_package, test_files, case_name):
    """Each module of the port's domain package has a ``case_name("<module>"`` case in ``test_files``."""
    covered = set()
    for path in sorted(test_files):
        covered.update(re.findall(rf'{case_name}\("(\w+)"', Path(path).read_text()))
    missing = sorted(set(domain_modules(port_package)) - covered)
    assert not missing, f"modules without a parity case: {missing}"
