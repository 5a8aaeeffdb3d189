"""The port's own zarr v2 and N5 reader and writer (``utils/zarr_n5.py``, ``ops/native/blosc.cpp``)
against tensorstore and the JAX package, on the CPU, at small sizes.

tensorstore (c-blosc and the other codecs of its build) writes every codec that the port reads,
over the dtypes u1, u2, u4, u8, i2, f4, f8 and zarr's ``|b1``, in shapes with ragged edge chunks,
and the port reads each equal; zstd and snappy raise ``NotImplementedError`` naming the codec. The
zarr layouts (``order`` F, "/" separators, ``>u2``, numeric and ``"NaN"`` fill values over missing
chunks) and hand-written N5 blocks (truncated edges, mode 1) read as tensorstore reads them. The
port's writes read back equal through the JAX ``load_data``, with the metadata of the JAX
``write_data`` (default chunks on a grid of shapes, created without data) and the same chunk
files. The native LZ4 and shuffles round-trip random bytes (hypothesis), and tensorstore decodes
those frames too. The committed fixtures of ``scripts/make_zarr_n5_fixtures.py`` read equal to
their seeded arrays in both packages. Every comparison is exact.
"""

import json
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_em_tpu.utils import io as jax_io
from torch_em_tpu_torch.ops import _build
from torch_em_tpu_torch.ops.native import blosc
from torch_em_tpu_torch.utils import io, zarr_n5

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import make_zarr_n5_fixtures as fixtures  # noqa: E402

DTYPES = ("uint8", "uint16", "uint32", "uint64", "int16", "float32", "float64")
SHAPE, CHUNKS = (7, 19, 45), (3, 8, 32)  # ragged on every axis
BLOSC_CODECS = ("lz4", "lz4hc", "blosclz", "zlib")


def _array(dtype, shape=SHAPE, seed=0):
    """Half a smooth random walk (which every codec shrinks), half noise (which some store as it is)."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == bool:
        return rng.random(shape) > 0.7
    walk = rng.integers(0, 3, shape).cumsum(axis=-1) % 120
    noise = rng.integers(0, 120, shape)
    data = np.where(np.arange(shape[0]).reshape((-1,) + (1,) * (len(shape) - 1)) < shape[0] // 2, walk, noise)
    return (data / 3).astype(dtype) if np.dtype(dtype).kind == "f" else data.astype(dtype)


def _ts_write(path, fmt, data, metadata, key="a"):
    """Write ``data`` with tensorstore under ``metadata`` (C-order shapes; N5's are reversed here)."""
    spec = {"driver": fmt, "kvstore": {"driver": "file", "path": str(path)}, "path": key}
    if fmt == "zarr":
        spec["metadata"] = dict({"shape": list(data.shape), "chunks": list(CHUNKS)}, **metadata)
        if "dtype" not in metadata:
            spec["metadata"]["dtype"] = "|b1" if data.dtype == bool else np.dtype(data.dtype).str
    else:
        spec["metadata"] = dict({"dimensions": list(data.shape)[::-1], "blockSize": list(CHUNKS)[::-1],
                                 "dataType": data.dtype.name}, **metadata)
    store = ts.open(spec, create=True, delete_existing=True).result()
    (store.T if fmt == "n5" else store)[...] = data
    return store


def _check_reads(path, key, data):
    ours, theirs = io.load_data(str(path), key), jax_io.load_data(str(path), key)
    assert ours.shape == theirs.shape == data.shape and ours.dtype == theirs.dtype == data.dtype.newbyteorder("=")
    for index in (np.s_[...], np.s_[1:6, 3:17, 5:44], np.s_[6], np.s_[2, ::3, 1::7]):
        np.testing.assert_array_equal(ours[index], data[index])
        np.testing.assert_array_equal(ours[index], np.asarray(theirs[index]))
    # numpy's negative indices and steps, which tensorstore reads otherwise
    for index in (np.s_[-1], np.s_[-3:, ::-5, -7::-2]):
        np.testing.assert_array_equal(ours[index], data[index])


def _files(root):
    root = Path(root)
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


# -- tensorstore writes, the port reads -----------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
@pytest.mark.parametrize("cname", BLOSC_CODECS)
@pytest.mark.parametrize("shuffle", [0, 1, 2])
def test_blosc_chunks_of_tensorstore(fmt, cname, shuffle, tmp_path):
    """Every blosc codec the port reads, under each shuffle, over every dtype (and zarr's bool)."""
    codec = {"cname": cname, "clevel": 5, "shuffle": shuffle}
    for k, dtype in enumerate(DTYPES + (("bool",) if fmt == "zarr" else ())):
        data = _array(dtype, seed=k)
        key = f"a{k}"
        if fmt == "zarr":
            _ts_write(tmp_path / "d.zarr", fmt, data, {"compressor": dict(codec, id="blosc")}, key)
        else:
            _ts_write(tmp_path / "d.n5", fmt, data, {"compression": dict(codec, type="blosc")}, key)
        _check_reads(tmp_path / f"d.{fmt}", key, data)


@pytest.mark.parametrize("fmt,codec", [("zarr", None), ("zarr", {"id": "zlib", "level": 1}),
                                       ("zarr", {"id": "gzip", "level": 6}), ("zarr", {"id": "bz2", "level": 9}),
                                       ("n5", {"type": "raw"}), ("n5", {"type": "gzip"}),
                                       ("n5", {"type": "gzip", "useZlib": True}), ("n5", {"type": "bzip2"}),
                                       ("n5", {"type": "xz"})])
def test_other_codecs_of_tensorstore(fmt, codec, tmp_path):
    for k, dtype in enumerate(DTYPES):
        data = _array(dtype, seed=10 + k)
        _ts_write(tmp_path / f"d.{fmt}", fmt, data, {"compressor" if fmt == "zarr" else "compression": codec}, f"a{k}")
        _check_reads(tmp_path / f"d.{fmt}", f"a{k}", data)


@pytest.mark.parametrize("codec", ["zstd", "snappy"])
@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_zstd_and_snappy_raise_naming_the_codec(fmt, codec, tmp_path):
    """Inside blosc (zarr and N5), as a zarr compressor and as N5 compression (zstd), and a bare frame."""
    data = _array("uint16")
    field = "compressor" if fmt == "zarr" else "compression"
    _ts_write(tmp_path / f"d.{fmt}", fmt, data, {field: {"id" if fmt == "zarr" else "type": "blosc", "cname": codec,
                                                         "clevel": 5, "shuffle": 1}})
    with pytest.raises(NotImplementedError, match=codec):
        io.load_data(str(tmp_path / f"d.{fmt}"), "a")
    chunk = tmp_path / f"d.{fmt}" / "a" / ("0.0.0" if fmt == "zarr" else "0/0/0")
    frame = chunk.read_bytes()[16 if fmt == "n5" else 0:]
    with pytest.raises(NotImplementedError, match=codec):
        blosc.decompress(frame)
    if codec == "zstd":
        _ts_write(tmp_path / f"z.{fmt}", fmt, data, {field: {"id" if fmt == "zarr" else "type": "zstd"}})
        with pytest.raises(NotImplementedError, match="zstd"):
            io.load_data(str(tmp_path / f"z.{fmt}"), "a")


def test_zarr_layouts(tmp_path):
    """``order`` F, "/" separators, big-endian dtypes, a numeric and a "NaN" fill value over missing chunks."""
    path = tmp_path / "d.zarr"
    blosc_lz4 = {"id": "blosc", "cname": "lz4", "shuffle": 1}
    cases = {"f_order": (_array("uint32", seed=1), {"order": "F", "compressor": blosc_lz4}),
             "nested": (_array("int16", seed=2), {"dimension_separator": "/", "compressor": {"id": "zlib"}}),
             "big_endian": (_array(">u2", seed=3), {"dtype": ">u2", "compressor": blosc_lz4}),
             "big_endian_f8": (_array(">f8", seed=4), {"dtype": ">f8", "compressor": None})}
    for key, (data, meta) in cases.items():
        _ts_write(path, "zarr", data, meta, key)
        _check_reads(path, key, data)
    assert (path / "nested" / "1" / "2" / "1").is_file()
    # fill values: tensorstore writes one window; the chunks it leaves out read as the fill value
    for key, dtype, fill in (("fill7", "uint16", 7), ("fill_nan", "float32", "NaN"), ("fill_neg", "int16", -3)):
        spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": str(path)}, "path": key,
                "metadata": {"shape": list(SHAPE), "chunks": list(CHUNKS), "dtype": np.dtype(dtype).str,
                             "fill_value": fill, "compressor": blosc_lz4}}
        store = ts.open(spec, create=True, delete_existing=True).result()
        store[1:4, 2:9, 30:40] = _array(dtype, (3, 7, 10), seed=5)
        expected = np.full(SHAPE, np.nan if fill == "NaN" else fill, dtype=dtype)
        expected[1:4, 2:9, 30:40] = _array(dtype, (3, 7, 10), seed=5)
        ours = io.load_data(str(path), key)
        np.testing.assert_array_equal(ours[...], expected)
        np.testing.assert_array_equal(ours[...], store.read().result())
        assert len(_files(path / key)) < 1 + 12  # chunks are missing


def test_filters_and_v3_raise(tmp_path):
    folder = tmp_path / "d.zarr" / "a"
    folder.mkdir(parents=True)
    meta = {"chunks": [4], "compressor": None, "dtype": "<u2", "fill_value": 0, "filters": [{"id": "delta",
            "dtype": "<u2"}], "order": "C", "shape": [8], "zarr_format": 2}
    (folder / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="delta"):
        io.load_data(str(tmp_path / "d.zarr"), "a")
    (folder / ".zarray").unlink()
    (folder / "zarr.json").write_text(json.dumps({"zarr_format": 3}))
    with pytest.raises(NotImplementedError, match="v3"):
        io.load_data(str(tmp_path / "d.zarr"), "a")


def _n5_block(mode, dims_xyz, data, count=None):
    import struct

    header = struct.pack(">HH", mode, len(dims_xyz)) + struct.pack(f">{len(dims_xyz)}I", *dims_xyz)
    if mode == 1:
        header += struct.pack(">I", data.size if count is None else count)
    return header + data.astype(data.dtype.newbyteorder(">")).tobytes()


def test_hand_written_n5_truncated_edges_and_mode_1(tmp_path):
    """z5py's and the Java N5's layout: edge blocks truncated to the array (their size in the header), a missing
    block, a root ``attributes.json``; then one block in mode 1 (varlength, its element count after the shape),
    which tensorstore refuses and the port reads."""
    import gzip

    data = _array("int32", seed=6)
    root = tmp_path / "hand.n5"
    (root / "raw").mkdir(parents=True)
    (root / "attributes.json").write_text(json.dumps({"n5": "2.5.1"}))
    (root / "raw" / "attributes.json").write_text(json.dumps(
        {"dimensions": list(SHAPE)[::-1], "blockSize": list(CHUNKS)[::-1], "dataType": "int32",
         "compression": {"type": "gzip", "useZlib": False}}))

    def write_block(iz, iy, ix, mode):
        block = data[iz * 3:(iz + 1) * 3, iy * 8:(iy + 1) * 8, ix * 32:(ix + 1) * 32]
        raw = _n5_block(mode, block.shape[::-1], block)
        head = 4 + 4 * 3 + (4 if mode else 0)
        (root / "raw" / str(ix) / str(iy)).mkdir(parents=True, exist_ok=True)
        (root / "raw" / str(ix) / str(iy) / str(iz)).write_bytes(raw[:head] + gzip.compress(raw[head:]))

    expected = data.copy()
    expected[3:6, 8:16, 0:32] = 0  # block (1, 1, 0) is left out and reads as zero
    for iz, iy, ix in np.ndindex(3, 3, 2):
        if (iz, iy, ix) != (1, 1, 0):
            write_block(iz, iy, ix, 0)
    ours, theirs = io.load_data(str(root), "raw"), jax_io.load_data(str(root), "raw")
    np.testing.assert_array_equal(ours[...], expected)
    np.testing.assert_array_equal(ours[...], theirs[...])
    np.testing.assert_array_equal(ours[5:7, 10:19, 20:45], expected[5:7, 10:19, 20:45])
    write_block(2, 2, 1, 1)  # the truncated corner block, in mode 1
    with pytest.raises(ValueError, match="varlength"):
        jax_io.load_data(str(root), "raw")[...]
    np.testing.assert_array_equal(io.load_data(str(root), "raw")[...], expected)


# -- the port writes, tensorstore reads ------------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_port_writes_read_back_by_jax(fmt, tmp_path):
    path = str(tmp_path / f"d.{fmt}")
    for k, dtype in enumerate(DTYPES + (("bool",) if fmt == "zarr" else ())):
        data = _array(dtype, seed=20 + k)
        for chunks in (CHUNKS, None, (7, 19, 45), (1, 5, 4)):
            io.write_data(path, f"volumes/a{k}", data, chunks=chunks)
            theirs = jax_io.load_data(path, f"volumes/a{k}")
            assert theirs.dtype == data.dtype and theirs.shape == data.shape
            np.testing.assert_array_equal(np.asarray(theirs[...]), data)
            np.testing.assert_array_equal(io.load_data(path, f"volumes/a{k}")[...], data)


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_windowed_writes_read_modify_write(fmt, tmp_path):
    """Windows written into an array that tensorstore wrote and into one the port created; partial chunks keep
    the rest, and an N5 block the writes leave all zero is deleted; JAX reads the result."""
    data = _array("float32", seed=30)
    patch = _array("float32", (4, 10, 30), seed=31)
    windows = [(np.s_[1:5, 3:11, 20:41], 1.5), (np.s_[2:6, 5:15, 10:40], patch), (np.s_[0, :, 33:], -2.0),
               (np.s_[..., 4], 7.0), (np.s_[6], 0.0)]
    expected = data.copy()
    for window, value in windows:
        expected[window] = value
    field = "compressor" if fmt == "zarr" else "compression"
    path = tmp_path / f"d.{fmt}"
    _ts_write(path, fmt, data, {field: {"id" if fmt == "zarr" else "type": "gzip"}}, "ts")
    zarr_n5.create_array(path, "port", SHAPE, "float32", CHUNKS, fmt)[...] = data
    for key in ("ts", "port"):
        arr = io.load_data(str(path), key, mode="a")
        for window, value in windows:
            arr[window] = value
        np.testing.assert_array_equal(np.asarray(jax_io.load_data(str(path), key)[...]), expected)
        last_block = path / key / ("2.2.1" if fmt == "zarr" else "1/2/2")
        assert last_block.exists() == (fmt == "zarr")
    with pytest.raises(PermissionError):
        io.load_data(str(path), "port")[0] = 1


GRID = [(256, 256), (40, 512, 512), (3, 1000, 1000), (64, 512, 512), (5_000_000,), (7,), (1025, 1025), (3, 4, 5),
        (1, 1, 3_000_000), (100, 100, 100, 100), (17, 33, 1999, 3), (1500, 1500, 2), (9,) * 7, (1024, 1025)]


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_metadata_equals_jax_write_data(fmt, tmp_path):
    """The port's metadata is the JAX ``write_data``'s (its tensorstore spec, opened without data), with default
    chunks on a grid of shapes and dtypes, and given chunks."""
    for k, (shape, dtype) in enumerate([(s, d) for s in GRID for d in ("uint8", "float64")] +
                                       [((33, 70), d) for d in DTYPES]):
        for chunks in (None, (4,) * len(shape)) if k % 3 == 0 else (None,):
            spec = jax_io._tensorstore_spec(str(tmp_path / f"jax.{fmt}"), f"a{k}", fmt)
            if fmt == "zarr":
                spec["metadata"] = dict({"shape": list(shape)}, **({"chunks": list(chunks)} if chunks else {}))
            else:
                spec["metadata"] = dict({"dimensions": list(shape)[::-1]},
                                        **({"blockSize": list(chunks)[::-1]} if chunks else {}))
            ts.open(spec, create=True, delete_existing=True, dtype=ts.dtype(np.dtype(dtype))).result()
            arr = zarr_n5.create_array(tmp_path / f"port.{fmt}", f"a{k}", shape, dtype, chunks, fmt)
            name = ".zarray" if fmt == "zarr" else "attributes.json"
            ours = (tmp_path / f"port.{fmt}" / f"a{k}" / name).read_text()
            theirs = (tmp_path / f"jax.{fmt}" / f"a{k}" / name).read_text()
            assert json.loads(ours) == json.loads(theirs), (shape, dtype)
            assert arr.chunks == tuple(chunks or zarr_n5.default_chunks(shape))
    # the JAX write_data itself, with data, on a small case
    data = _array("uint16")
    jax_io.write_data(str(tmp_path / f"w.{fmt}"), "a", data)
    io.write_data(str(tmp_path / f"v.{fmt}"), "a", data)
    name = ".zarray" if fmt == "zarr" else "attributes.json"
    assert (tmp_path / f"v.{fmt}" / "a" / name).read_text() == (tmp_path / f"w.{fmt}" / "a" / name).read_text()


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_same_chunk_files_as_tensorstore(fmt, tmp_path):
    """Every zarr chunk (all-zero ones too), no all-zero N5 block, no .zgroup or root attributes.json; rewriting
    a key with a smaller array deletes its old chunks."""
    data = _array("uint32", seed=40)
    data[3:6, 8:16, :32] = 0  # one chunk all zero
    for module, name in ((jax_io, "jax"), (io, "port")):
        path = str(tmp_path / name / f"d.{fmt}")
        module.write_data(path, "g/big", data, chunks=CHUNKS)
        module.write_data(path, "g/small", data, chunks=CHUNKS)
        module.write_data(path, "g/small", data[:2, :5], chunks=CHUNKS)
        module.write_data(path, "zeros", np.zeros((4, 9), "uint8"), chunks=(2, 4))
    ours, theirs = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert ours == theirs
    assert (f"d.{fmt}/g/big/1.1.0" in ours) == (fmt == "zarr")
    np.testing.assert_array_equal(jax_io.load_data(str(tmp_path / "port" / f"d.{fmt}"), "g/small")[...], data[:2, :5])


def test_default_chunks_rule():
    for shape in GRID:
        chunks = zarr_n5.default_chunks(shape)
        assert np.prod(chunks) <= 1 << 20 and all(1 <= c <= n for c, n in zip(chunks, shape))
    assert zarr_n5.default_chunks((40, 512, 512)) == (40, 161, 161)
    assert zarr_n5.default_chunks((3, 1000, 1000)) == (3, 591, 591)


# -- the lazy array ---------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_threads_read_overlapping_windows_and_pickle(fmt, tmp_path):
    """Twelve threads read overlapping windows (each window's chunks decoded on the module's pool) at once; the
    array pickles as (path, key, mode) and opens again."""
    data = _array("uint16", (12, 64, 96), seed=50)
    path = str(tmp_path / f"d.{fmt}")
    io.write_data(path, "raw", data, chunks=(4, 16, 32))
    arr = io.load_data(path, "raw")
    windows = [np.s_[z:z + 6, y:y + 40, x:x + 70] for z in (0, 3, 6) for y in (0, 11, 24) for x in (0, 13, 26)]
    errors = []

    def read(offset):
        try:
            for w in windows[offset:] + windows[:offset]:
                np.testing.assert_array_equal(arr[w], data[w])
        except AssertionError as e:  # pragma: no cover - reported below
            errors.append(e)

    # more readers than cores, switching often: every window still reads as written
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=read, args=(k % len(windows),)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    again = pickle.loads(pickle.dumps(arr))
    assert isinstance(again, io.LazyTensorStore) and (again.path, again.key, again.mode) == (path, "raw", "r")
    np.testing.assert_array_equal(again[2:9, 5:50, 1], data[2:9, 5:50, 1])
    assert len(again) == 12 and again.ndim == 3 and again.chunks == (4, 16, 32)


# -- the native codec -------------------------------------------------------------------------------------------------


def _frames_through_tensorstore(tmp_path, frame, size, typesize):
    """tensorstore's c-blosc decodes a frame of the port's: it is written as the one chunk of a uint8 zarr array."""
    folder = tmp_path / "f.zarr"
    folder.mkdir(exist_ok=True)
    (folder / ".zarray").write_text(json.dumps({"chunks": [size], "compressor": {"id": "blosc", "cname": "lz4",
                                                "clevel": 5, "shuffle": 1, "blocksize": 0}, "dtype": "|u1",
                                                "fill_value": None, "filters": None, "order": "C", "shape": [size],
                                                "zarr_format": 2}))
    (folder / "0").write_bytes(frame)
    return ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": str(folder)}}).result().read().result()


@settings(max_examples=60, deadline=None)
@given(data=st.binary(min_size=0, max_size=3000), repeats=st.integers(1, 200), typesize=st.sampled_from([1, 2, 4, 8, 3]),
       shuffle=st.sampled_from(["none", "byte", "bit"]))
def test_native_codec_round_trips(tmp_path_factory, data, repeats, typesize, shuffle):
    """Random bytes, repeated into runs the LZ4 compressor finds, round-trip through the port's frames, and
    tensorstore's c-blosc reads the same bytes out of them."""
    raw = np.frombuffer(data * repeats, dtype=np.uint8)[:200_000]
    frame = blosc.compress(raw, typesize, shuffle)
    assert len(frame) <= raw.size + 16
    np.testing.assert_array_equal(blosc.decompress(frame), raw)
    if raw.size:
        got = _frames_through_tensorstore(tmp_path_factory.mktemp("f"), frame, raw.size, typesize)
        np.testing.assert_array_equal(got, raw)


def test_native_codec_large_blocks_and_frames_of_c_blosc(tmp_path):
    """Frames of several blocks (a 4 MiB chunk) both ways, and a tensorstore frame with small blocks."""
    data = _array("float32", (32, 128, 256), seed=60)
    frame = blosc.compress(data, 4, "byte")
    assert blosc.frame_header(frame)["blocksize"] < data.nbytes
    np.testing.assert_array_equal(blosc.decompress(frame).view("float32").reshape(data.shape), data)
    got = _frames_through_tensorstore(tmp_path, frame, data.nbytes, 4)
    np.testing.assert_array_equal(got.view("float32").reshape(data.shape), data)
    store = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": str(tmp_path / "c.zarr")},
                     "metadata": {"shape": list(data.shape), "chunks": list(data.shape), "dtype": "<f4",
                                  "compressor": {"id": "blosc", "cname": "lz4", "clevel": 9, "shuffle": 2,
                                                 "blocksize": 8192}}}, create=True).result()
    store[...] = data
    c_frame = (tmp_path / "c.zarr" / "0.0.0").read_bytes()
    assert blosc.frame_header(c_frame)["blocksize"] < data.nbytes // 16
    np.testing.assert_array_equal(blosc.decompress(c_frame).view("float32").reshape(data.shape), data)
    # a chunk of 100 float64: blocks of fewer than 128 elements are not split into streams (flag 0x10)
    small = _array("float64", (100,), seed=61)
    store = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": str(tmp_path / "s.zarr")},
                     "metadata": {"shape": [100], "chunks": [100], "dtype": "<f8",
                                  "compressor": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}}},
                    create=True).result()
    store[...] = small
    s_frame = (tmp_path / "s.zarr" / "0").read_bytes()
    assert blosc.frame_header(s_frame)["flags"] & 0x12 == 0x10
    np.testing.assert_array_equal(blosc.decompress(s_frame).view("float64"), small)


def test_corrupt_frames_raise():
    """A truncated frame, a header whose block outgrows its buffer, a stream cut short: ``ValueError``, no crash."""
    data = _array("uint16", (64, 64), seed=62)
    frame = bytearray(blosc.compress(data, 2, "byte"))
    assert not blosc.frame_header(frame)["flags"] & 0x02  # a compressed frame, not a copy
    for bad in (frame[:10], frame[:-5], frame[:8] + (2 ** 31).to_bytes(4, "little") + frame[12:],
                frame[:16] + bytes(4) + frame[20:]):
        with pytest.raises(ValueError):
            blosc.decompress(bytes(bad))


def test_fixtures_read_equal_in_both_packages():
    """The committed tensorstore fixtures: every one reads equal to its regenerated array in both packages."""
    assert len(fixtures.CASES) == 35
    formats = {(c["fmt"], c["name"].split("_shuffle")[0]) for c in fixtures.CASES}
    assert {("zarr", "blosc_zlib"), ("n5", "blosc_blosclz"), ("n5", "xz"), ("zarr", "bz2")} <= formats
    for case in fixtures.CASES:
        expected = fixtures.fixture_array(case)
        for module in (io, jax_io):
            arr = module.load_data(fixtures.container(case["fmt"]), case["name"])
            assert arr.dtype == expected.dtype and arr.shape == expected.shape, case["name"]
            np.testing.assert_array_equal(np.asarray(arr[...]), expected)
    size = sum(p.stat().st_size for p in fixtures.OUT.rglob("*") if p.is_file())
    assert size < 256 * 1024


_BROKEN_BUILD = """
import sys
from pathlib import Path
from torch_em_tpu_torch.ops import _build
from torch_em_tpu_torch.ops.native import GXX_FLAGS, _find_gxx
source = Path(sys.argv[1])
source.write_text("this is not C++\\n")
try:
    _build.compile_library("tem_blosc", _find_gxx, GXX_FLAGS, [source])
except RuntimeError as e:
    print("raised", "tem_blosc" in str(e))
"""


def test_blosc_builds_under_the_package_and_a_failed_build_raises(tmp_path):
    lib = Path(blosc.load_library()._name)
    assert lib.name == "libtem_blosc.so" and lib.parent.parent == _build.BUILD_DIR
    assert lib.parent.name.startswith("tem_blosc-")
    proc = subprocess.run([sys.executable, "-c", _BROKEN_BUILD, str(tmp_path / "blosc.cpp")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.split() == ["raised", "True"], proc.stderr
