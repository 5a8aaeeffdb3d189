"""The port's own HDF5 (``torch_em_tpu_torch/utils/hdf5.py``) against h5py, the oracle.

Each case is an array made from a seed with numpy and the ``create_dataset`` arguments it is
written with. What h5py writes (with ``libver`` "earliest" and "latest"), the port reads
bitwise, attributes too; what the port writes, h5py reads bitwise and the port reads back.
Selections equal numpy's on the same array; appending to and deleting from a file that h5py
wrote, past one symbol-table node (8 entries) and one B-tree node (32 children), leaves every
key readable by both; the latest format's dense groups and attributes and its extensible-array
and v2 B-tree chunk indexes read bitwise; six threads reading random windows equal a serial read;
a pickled dataset reads the same; an unsupported filter, type or structure raises
``NotImplementedError`` naming it. h5py is imported on the oracle side only.
"""

import pickle
import re
import threading

import numpy as np
import pytest

from torch_em_tpu_torch.utils import hdf5, io


def _h5py():
    return pytest.importorskip("h5py")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _ints(dtype, shape, seed=0):
    """Integers over the type's whole range: random bytes seen as ``dtype``."""
    dtype = np.dtype(dtype)
    n = int(np.prod(shape)) * dtype.itemsize
    return _rng(seed).integers(0, 256, size=n, dtype=np.uint8).view(dtype).reshape(shape)


def _floats(dtype, shape, seed=0):
    return (_rng(seed).normal(size=shape) * 100).astype(dtype)


# name: (data, create_dataset arguments)
CASES = {
    **{f"dtype_{np.dtype(t).str.replace('<', 'le_').replace('>', 'be_').replace('|', '')}": (_ints(t, (7, 9)), {})
       for t in ("u1", "i1", "<u2", "<i2", "<u4", "<i4", "<u8", "<i8", ">u2", ">i2", ">u4", ">i4", ">u8", ">i8")},
    **{f"dtype_{np.dtype(t).str.replace('<', 'le_').replace('>', 'be_')}": (_floats(t, (7, 9)), {})
       for t in ("<f2", "<f4", "<f8", ">f2", ">f4", ">f8")},
    "dtype_bool": (_rng(1).random((7, 9)) > 0.5, {}),
    "dtype_bool_chunked": (_rng(1).random((7, 9)) > 0.5, {"chunks": (4, 4), "compression": "gzip"}),
    "shape_0d": (np.float64(3.25), {}),
    "shape_1d": (_floats("f4", (100,)), {}),
    "shape_4d": (_floats("f4", (3, 4, 5, 6)), {"chunks": (2, 3, 2, 4)}),
    "shape_5d": (_ints("u2", (2, 3, 4, 5, 6)), {"chunks": (1, 2, 3, 2, 4), "compression": "gzip"}),
    "shape_empty_axis": (np.zeros((0, 5), dtype="f4"), {}),
    "shape_empty_axis_chunked": (np.zeros((0, 5), dtype="f4"), {"chunks": (4, 5), "maxshape": (None, 5)}),
    "contiguous_3d": (_floats("f4", (9, 17, 13)), {}),
    "chunked_edges": (_floats("f4", (9, 17, 13)), {"chunks": (4, 8, 5)}),
    "chunked_true": (_ints("i4", (30, 70, 50)), {"chunks": True}),
    "chunked_many": (_ints("u2", (64, 72)), {"chunks": (4, 4)}),  # 288 chunks: a 2-level chunk B-tree
    "gzip_0": (_floats("f4", (9, 17, 13)), {"chunks": (4, 8, 5), "compression": "gzip", "compression_opts": 0}),
    "gzip_4": (_floats("f4", (9, 17, 13)), {"chunks": (4, 8, 5), "compression": "gzip"}),
    "gzip_9": (_ints("u4", (9, 17, 13)) % 7, {"chunks": (4, 8, 5), "compression": "gzip", "compression_opts": 9}),
    "lzf_compressible": (np.arange(20 * 30 * 40, dtype="u4").reshape(20, 30, 40) // 64,
                         {"chunks": (8, 16, 16), "compression": "lzf"}),
    "lzf_random": (_ints("u1", (20, 30, 40)), {"chunks": (8, 16, 16), "compression": "lzf"}),
    "shuffle_gzip": (_floats("f8", (9, 17, 13)), {"chunks": (4, 8, 5), "compression": "gzip", "shuffle": True}),
    "shuffle_lzf_fletcher32": (_ints("i2", (9, 17, 13)) % 100,
                               {"chunks": (4, 8, 5), "compression": "lzf", "shuffle": True, "fletcher32": True}),
    "fletcher32": (_floats("f4", (9, 17, 13)), {"chunks": (4, 8, 5), "fletcher32": True}),
    "fletcher32_odd": (_ints("u1", (9, 17, 13)), {"chunks": (3, 7, 5), "fletcher32": True}),
    "maxshape_resize": (_floats("f4", (6, 10, 10)), {"chunks": (4, 4, 4), "maxshape": (None, 10, 10),
                                                     "compression": "gzip", "resize": 11}),
    "maxshape_shrink": (_floats("f4", (6, 10, 10)), {"chunks": (4, 4, 4), "maxshape": (None, 10, 10),
                                                     "resize": 3}),
    "partial_write": (_floats("f4", (9, 10)), {"chunks": (4, 4), "partial": True}),
    "fillvalue": (_floats("f4", (9, 10)), {"chunks": (4, 4), "fillvalue": 7.5, "partial": True}),
}
# the port writes the default fill value (zeros) only; h5py writes the others
WRITE_CASES = sorted(set(CASES) - {"fillvalue"})
ATTRS = {"int": 3, "float": 2.5, "array": np.arange(6, dtype="i2").reshape(2, 3), "list": [1.5, 2.5],
         "str": "héllo wörld", "bytes": b"raw bytes", "bool": True, "shape": (64, 512, 512)}


def _create(f, name, case):
    """Write a case through an h5py-like ``f`` (h5py or the port): the dataset, resized or
    partly written where the case says so, and the attributes."""
    data, kwargs = CASES[case]
    kwargs = dict(kwargs)
    resize, partial = kwargs.pop("resize", None), kwargs.pop("partial", False)
    if partial:
        ds = f.create_dataset(name, shape=data.shape, dtype=data.dtype, **kwargs)
        ds[1:6, 2:7] = data[1:6, 2:7]
        expected = np.full(data.shape, kwargs.get("fillvalue", 0), dtype=data.dtype)
        expected[1:6, 2:7] = data[1:6, 2:7]
    else:
        ds = f.create_dataset(name, data=data, **kwargs)
        expected = data
    if resize is not None:
        ds.resize(resize, axis=0)
        grown = np.zeros((resize,) + data.shape[1:], dtype=data.dtype)
        n = min(resize, data.shape[0])
        grown[:n] = data[:n]
        if resize < data.shape[0]:
            ds.resize(data.shape[0], axis=0)  # shrink and grow back: the cut rows read as the fill value
            grown = np.zeros(data.shape, dtype=data.dtype)
            grown[:n] = data[:n]
        expected = grown
    for key, value in ATTRS.items():
        ds.attrs[key] = value
    return expected


def _same_bits(got, expected):
    got = np.asarray(got)
    assert got.shape == expected.shape and got.dtype == expected.dtype, (got.shape, got.dtype, expected.dtype)
    assert got.tobytes() == np.ascontiguousarray(expected).tobytes()


def _check_attrs(attrs, oracle=None):
    for key, value in ATTRS.items():
        got = attrs[key]
        if isinstance(value, str):
            assert got == value and isinstance(got, str)
        elif isinstance(value, bytes) and oracle is None:
            assert bytes(got) == value
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(value if oracle is None else oracle[key]))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_what_h5py_writes(tmp_path, case, libver):
    h5py = _h5py()
    path = tmp_path / "h5py.h5"
    with h5py.File(path, "w", libver=libver) as f:
        expected = _create(f, "group/data", case)
        oracle_attrs = dict(f["group/data"].attrs)
        assert np.asarray(f["group/data"][()]).tobytes() == np.ascontiguousarray(expected).tobytes()
    with hdf5.File(path) as f:
        ds = f["group/data"]
        _same_bits(ds[()], expected)
        if isinstance(CASES[case][1].get("chunks"), tuple):
            assert ds.chunks == CASES[case][1]["chunks"]
        _check_attrs(ds.attrs, oracle_attrs)


@pytest.mark.parametrize("case", WRITE_CASES)
def test_h5py_reads_what_the_port_writes(tmp_path, case):
    path = tmp_path / "port.h5"
    with hdf5.File(path, "w") as f:
        expected = _create(f, "group/data", case)
    with hdf5.File(path) as f:
        ds = f["group/data"]
        _same_bits(ds[()], expected)
        _check_attrs(ds.attrs)
        kwargs = CASES[case][1]
        if isinstance(kwargs.get("chunks"), tuple):
            assert ds.chunks == kwargs["chunks"]
        assert ds.compression == kwargs.get("compression")
    h5py = _h5py()
    with h5py.File(path) as f:
        ds = f["group/data"]
        _same_bits(ds[()], expected)
        if ds.chunks is not None and kwargs.get("chunks") is True:
            assert ds.chunks == hdf5.guess_chunk(expected.shape, None, expected.dtype.itemsize)
        assert ds.compression == kwargs.get("compression")
        assert ds.shuffle == bool(kwargs.get("shuffle")) and ds.fletcher32 == bool(kwargs.get("fletcher32"))
        for key, value in ATTRS.items():
            got = ds.attrs[key]
            if isinstance(value, (str, bytes)):
                assert got == value
            else:
                np.testing.assert_array_equal(np.asarray(got), np.asarray(value))


def test_string_attributes(tmp_path):
    """Variable- and fixed-length strings read as ``str`` (fixed ASCII, h5py's bytes, as bytes)."""
    h5py = _h5py()
    path = tmp_path / "strings.h5"
    with h5py.File(path, "w") as f:
        f.attrs["vlen"] = "wörd"
        f.attrs["vlen_array"] = ["a", "bc", "déf"]
        f.attrs.create("fixed_utf8", np.array("naïve".encode()), dtype=h5py.string_dtype("utf-8", 8))
        f.attrs["fixed_ascii"] = np.bytes_(b"abc")
    with hdf5.File(path) as f:
        assert f.attrs["vlen"] == "wörd"
        assert list(f.attrs["vlen_array"]) == ["a", "bc", "déf"]
        assert f.attrs["fixed_utf8"] == "naïve"
        assert f.attrs["fixed_ascii"] == b"abc"
        assert sorted(f.attrs) == ["fixed_ascii", "fixed_utf8", "vlen", "vlen_array"]


SELECTIONS = {
    "all": (Ellipsis,),
    "int": (3,),
    "negative_int": (-1, slice(None), -2),
    "slices": (slice(1, 8), slice(2, 15), slice(0, 11)),
    "steps": (slice(0, 9, 2), slice(1, 17, 3), slice(None, None, 4)),
    "step_beyond_chunk": (slice(None), slice(0, 17, 9), slice(1, 13, 6)),
    "ellipsis_last": (2, Ellipsis, 4),
    "ellipsis_first": (Ellipsis, slice(3, 4)),
    "empty": (slice(5, 5),),
    "open_ends": (slice(-3, None), slice(None, -5), slice(None)),
    "past_the_end": (slice(7, 100), slice(16, 40)),
    "scalar_element": (4, 16, 12),
}


@pytest.mark.parametrize("layout", ["contiguous", "chunked", "gzip"])
@pytest.mark.parametrize("name", sorted(SELECTIONS))
def test_selections_match_numpy(tmp_path, name, layout):
    data = _floats("f4", (9, 17, 13), seed=5)
    kwargs = {"contiguous": {}, "chunked": {"chunks": (4, 8, 5)},
              "gzip": {"chunks": (4, 8, 5), "compression": "gzip"}}[layout]
    path = tmp_path / "sel.h5"
    with hdf5.File(path, "w") as f:
        f.create_dataset("x", data=data, **kwargs)
    index = SELECTIONS[name]
    with hdf5.File(path) as f:
        got = f["x"][index]
        expected = data[index]
        assert np.shape(got) == expected.shape
        np.testing.assert_array_equal(got, expected)
    # the same selection written into a zeroed dataset leaves exactly those elements set
    with hdf5.File(path, "a") as f:
        f.create_dataset("y", shape=data.shape, dtype=data.dtype, **kwargs)
        f["y"][index] = expected
        target = np.zeros_like(data)
        target[index] = expected
        np.testing.assert_array_equal(f["y"][...], target)


@pytest.mark.parametrize("writer", ["h5py", "port"])
@pytest.mark.parametrize("n_keys", [12, 40, 300])
def test_append_and_delete(tmp_path, n_keys, writer):
    """Keys appended to and deleted from a file the other side wrote: past one symbol-table
    node (8 entries), one B-tree node (32 children) and, at 300, a 2-level group B-tree."""
    h5py = _h5py()
    path = tmp_path / "many.h5"
    first, second = (h5py.File, hdf5.File) if writer == "h5py" else (hdf5.File, h5py.File)
    values = {f"k{i:03d}": np.arange(i % 5 + 1, dtype="i4") * i for i in range(n_keys)}
    with first(path, "w") as f:
        f.create_dataset("base", data=np.ones(3))
        for key in list(values)[: n_keys // 2]:
            f.create_dataset(f"g/{key}", data=values[key])
    with second(path, "a") as f:
        for key in list(values)[n_keys // 2:]:
            f.create_dataset(f"g/{key}", data=values[key])
        for key in list(values)[::3]:
            del f[f"g/{key}"]
            del values[key]
        f.attrs["note"] = "appended"
    with hdf5.File(path, "a") as f:  # write_data's delete-and-write-again
        io_key = next(iter(values))
        del f[f"g/{io_key}"]
        values[io_key] = np.full(4, -1, dtype="i4")
        f.create_dataset(f"g/{io_key}", data=values[io_key])
    for opener in (hdf5.File, h5py.File):
        with opener(path, "r") as f:
            assert sorted(f["g"]) == sorted(values)
            for key, value in values.items():
                np.testing.assert_array_equal(f[f"g/{key}"][()], value)
            np.testing.assert_array_equal(f["base"][()], np.ones(3))
            assert f.attrs["note"] == "appended"


def test_write_data_appends_into_an_h5py_file(tmp_path):
    h5py = _h5py()
    path = tmp_path / "io.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=np.arange(10))
    labels = _ints("u4", (8, 16, 16), seed=3)
    io.write_data(path, "labels", labels, chunks=(4, 8, 8))
    io.write_data(path, "raw", np.arange(5))
    with h5py.File(path) as f:
        np.testing.assert_array_equal(f["labels"][:], labels)
        assert f["labels"].compression == "gzip" and f["labels"].chunks == (4, 8, 8)
        np.testing.assert_array_equal(f["raw"][:], np.arange(5))
    np.testing.assert_array_equal(io.load_data(path, "labels")[2:5, ::3, 7], labels[2:5, ::3, 7])


def test_threads_read_like_a_serial_read(tmp_path):
    data = _floats("f4", (24, 40, 40), seed=2)
    path = tmp_path / "threads.h5"
    with hdf5.File(path, "w") as f:
        f.create_dataset("gzip", data=data, chunks=(8, 16, 16), compression="gzip")
        f.create_dataset("raw", data=data, chunks=(8, 16, 16))
    windows = [tuple(slice(s, s + w) for s, w in zip(_rng(i).integers(0, (12, 20, 20)), (12, 20, 20)))
               for i in range(48)]
    for key in ("gzip", "raw"):
        ds = hdf5.File(path)[key]  # one handle, shared by the threads
        serial = [data[w] for w in windows]
        results = [None] * len(windows)

        def work(k):
            for i in range(k, len(windows), 6):
                results[i] = ds[windows[i]]

        threads = [threading.Thread(target=work, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for got, expected in zip(results, serial):
            np.testing.assert_array_equal(got, expected)


def test_pickled_handles_reopen(tmp_path):
    data = _floats("f4", (10, 20), seed=4)
    path = tmp_path / "pickle.h5"
    with hdf5.File(path, "w") as f:
        f.create_dataset("a/b", data=data, chunks=(5, 5), compression="gzip")
    ds = io.load_data(path, "a/b")
    clone = pickle.loads(pickle.dumps(ds))
    assert clone.name == "/a/b" and clone.shape == ds.shape
    np.testing.assert_array_equal(clone[3:7, ::2], data[3:7, ::2])
    group = pickle.loads(pickle.dumps(hdf5.File(path)["a"]))
    np.testing.assert_array_equal(group["b"][...], data)
    f = pickle.loads(pickle.dumps(hdf5.File(path)))
    assert list(f) == ["a"] and f.mode == "r"


def _patched_filter(tmp_path, filter_id):
    h5py = _h5py()
    path = tmp_path / "filter.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100.0), chunks=(10,), compression="gzip")
    raw = bytearray(path.read_bytes())
    at = raw.index(b"deflate\0") - 8
    assert raw[at:at + 2] == b"\x01\x00"
    raw[at:at + 2] = filter_id.to_bytes(2, "little")
    path.write_bytes(bytes(raw))
    return path


UNSUPPORTED = {  # name: (writer of the file, the dataset or attribute to read, the words of the error)
    "filter_blosc": (lambda p: _patched_filter(p, 32001), "x", "32001 (blosc)"),
    "filter_szip": (lambda p: _patched_filter(p, 4), "x", "4 (szip)"),
    "type_compound": (lambda p: _h5py_file(p, lambda f: f.create_dataset(
        "x", data=np.zeros(3, dtype=[("a", "i4"), ("b", "f4")]))), "x", "compound"),
    "type_opaque": (lambda p: _h5py_file(p, lambda f: f.create_dataset(
        "x", data=np.zeros(3, dtype="V8"))), "x", "opaque"),
    "type_reference": (lambda p: _h5py_file(p, lambda f: f.create_dataset(
        "x", data=[f.ref], dtype=_h5py().ref_dtype)), "x", "reference"),
    "external_storage": (lambda p: _h5py_file(p, lambda f: f.create_dataset(
        "x", shape=(4,), dtype="f4", external=[(str(p / "x.raw"), 0, 16)])), "x", "external files"),
    "virtual_layout": (lambda p: _h5py_file(p, _virtual), "v", "virtual dataset"),
}


def _virtual(f):
    h5py = _h5py()
    f.create_dataset("x", data=np.arange(4.0))
    layout = h5py.VirtualLayout(shape=(4,), dtype="f8")
    layout[:] = h5py.VirtualSource(f["x"])
    f.create_virtual_dataset("v", layout)


def _h5py_file(tmp_path, fill, libver="earliest"):
    path = tmp_path / "unsupported.h5"
    with _h5py().File(path, "w", libver=libver) as f:
        fill(f)
    return path


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_raises_naming_it(tmp_path, name):
    make, key, words = UNSUPPORTED[name]
    path = make(tmp_path)
    with pytest.raises(NotImplementedError, match=re.escape(words)):
        with hdf5.File(path) as f:
            if key.endswith(".attrs"):
                dict(f[key[:-6]].attrs)
            else:
                f[key][...]


LATEST_STRUCTURES = {  # name: the number of links, attributes or chunks past the compact or fixed forms
    "dense_group_12": 12, "dense_group_300": 300, "dense_attributes_12": 12, "dense_attributes_150": 150,
    "extensible_array_40": 40, "extensible_array_700": 700, "btree2_index_30": 30, "btree2_index_900": 900,
}


@pytest.mark.parametrize("name", sorted(LATEST_STRUCTURES))
def test_reads_the_latest_formats_larger_structures(tmp_path, name):
    """Dense groups and attributes (a fractal heap under a v2 B-tree name index), the
    extensible-array index (one unlimited axis) and the v2 B-tree index (two), at sizes that fill
    their first blocks and at sizes that take more blocks or levels."""
    h5py = _h5py()
    n = LATEST_STRUCTURES[name]
    path = tmp_path / "latest.h5"
    rng = _rng(n)
    with h5py.File(path, "w", libver="latest") as f:
        if name.startswith("dense_group"):
            expected = {f"d{i:04d}": rng.integers(0, 100, size=i % 7 + 1) for i in range(n)}
            for key, value in expected.items():
                f.create_dataset(f"g/{key}", data=value)
        elif name.startswith("dense_attributes"):
            ds = f.create_dataset("x", data=np.arange(3))
            expected = {f"a{i:04d}": (f"text {i}" if i % 3 == 0 else rng.normal(size=i % 4 + 1)) for i in range(n)}
            for key, value in expected.items():
                ds.attrs[key] = value
        elif name.startswith("extensible"):
            data = rng.integers(0, 2 ** 16, size=(n, 6, 5)).astype("u2")
            f.create_dataset("x", data=data, maxshape=(None, 6, 5), chunks=(1, 3, 5), compression="gzip")
            data2 = _floats("f4", (7, n * 2))
            f.create_dataset("y", data=data2, maxshape=(7, None), chunks=(4, 2))  # unlimited axis not the first
        else:
            data = rng.integers(0, 2 ** 16, size=(n // 10, 40)).astype("u2")
            f.create_dataset("x", data=data, maxshape=(None, None), chunks=(1, 4))
            data2 = _floats("f4", (n // 10, 40))
            f.create_dataset("y", data=data2, maxshape=(None, None), chunks=(2, 2), compression="gzip")
    with hdf5.File(path) as f:
        if name.startswith("dense_group"):
            assert sorted(f["g"]) == sorted(expected)
            for key, value in expected.items():
                np.testing.assert_array_equal(f["g"][key][()], value)
        elif name.startswith("dense_attributes"):
            attrs = f["x"].attrs
            assert sorted(attrs) == sorted(expected)
            for key, value in expected.items():
                np.testing.assert_array_equal(attrs[key], value)
        else:
            assert f["x"]._state().index_type == ("earray" if name.startswith("extensible") else "btree2")
            _same_bits(f["x"][()], data)
            _same_bits(f["y"][()], data2)
            np.testing.assert_array_equal(f["x"][n // 20:n // 10, 1::2], data[n // 20:n // 10, 1::2])


def test_writes_refuse_the_latest_format_and_unknown_filters(tmp_path):
    h5py = _h5py()
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4))
    with hdf5.File(path, "a") as f:
        np.testing.assert_array_equal(f["x"][:], np.arange(4))
        with pytest.raises(NotImplementedError, match="latest"):
            f.create_dataset("y", data=np.arange(3))
    with hdf5.File(tmp_path / "new.h5", "w") as f:
        with pytest.raises(NotImplementedError, match="blosc"):
            f.create_dataset("z", data=np.arange(3), compression="blosc")


def test_fletcher32_mismatch_raises(tmp_path):
    path = tmp_path / "sum.h5"
    with hdf5.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype="u1"), chunks=(64,), fletcher32=True)
    raw = bytearray(path.read_bytes())
    at = raw.index(bytes(range(64)))
    raw[at + 10] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(OSError, match="fletcher32"):
        hdf5.File(path)["x"][:]


def test_lzf_round_trips_and_fails_on_corrupt_streams():
    from torch_em_tpu_torch.ops.native import lzf

    for data in (b"a" * 1000, bytes(range(256)) * 40, _ints("u1", (5000,)).tobytes(), b"abcabcabd" * 300):
        packed = lzf.compress(data)
        if packed is not None:
            assert len(packed) < len(data) and lzf.decompress(packed, len(data)) == data
    assert lzf.compress(_ints("u1", (64,)).tobytes()) is None  # random bytes do not shrink
    with pytest.raises(ValueError):
        lzf.decompress(b"\xe0\xff\x01", 100)


def test_lookup3_matches_hdf5_metadata(tmp_path):
    """A superblock v3 that h5py wrote carries a lookup3 checksum the port reproduces."""
    h5py = _h5py()
    path = tmp_path / "sb.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    raw = path.read_bytes()
    assert raw[8] in (2, 3)
    assert hdf5.lookup3(raw[:44]) == int.from_bytes(raw[44:48], "little")
    assert hdf5.lookup3(b"") == 0xDEADBEEF
