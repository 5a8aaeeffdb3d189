"""Small zarr v2 and N5 arrays written by tensorstore (c-blosc and the other codecs of its build), one
per (format, codec, shuffle) that the port reads, as evidence that the port's own reader
(``torch_em_tpu_torch/utils/zarr_n5.py`` and ``ops/native/blosc.cpp``) decodes their bytes.

    JAX_PLATFORMS=cpu python scripts/make_zarr_n5_fixtures.py

writes ``scripts/records/zarr_n5/fixtures.zarr`` and ``fixtures.n5`` (one array per case of
``CASES``, under the case's name) with tensorstore, which only this function imports. Each array
is ``fixture_array(case)``, regenerated from the case's seed, so a reader holds what it reads
against it without the files' author: ``tests/test_torch_zarr_n5.py`` does so for both packages
on the CPU, ``chip_smoke.py`` (phase 23c) for the port on the card. The arrays are smooth, so
every compressor shrinks them, with ragged edge chunks; dtypes cycle through uint8 (bit shuffle by
default), uint16, float32 and int64.
"""

import os
import shutil
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "records" / "zarr_n5"
SHAPE, CHUNKS = (5, 12, 40), (3, 8, 32)
DTYPES = ("uint8", "uint16", "float32", "int64")
BLOSC_CODECS = ("lz4", "lz4hc", "blosclz", "zlib")


def _cases():
    cases = []
    for fmt in ("zarr", "n5"):
        for cname in BLOSC_CODECS:
            for shuffle in (0, 1, 2):
                codec = {"cname": cname, "clevel": 5, "shuffle": shuffle, "blocksize": 0}
                codec.update({"id": "blosc"} if fmt == "zarr" else {"type": "blosc"})
                cases.append((fmt, f"blosc_{cname}_shuffle{shuffle}", codec, {}))
        if fmt == "zarr":
            cases += [("zarr", "raw", None, {}), ("zarr", "zlib", {"id": "zlib", "level": 5}, {}),
                      ("zarr", "gzip", {"id": "gzip", "level": 5}, {}), ("zarr", "bz2", {"id": "bz2", "level": 5}, {}),
                      ("zarr", "blosc_lz4_order_f", {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1},
                       {"order": "F"}),
                      ("zarr", "raw_big_endian_nested", None, {"dtype": ">u2", "dimension_separator": "/"})]
        else:
            cases += [("n5", "raw", {"type": "raw"}, {}), ("n5", "gzip", {"type": "gzip", "level": 5}, {}),
                      ("n5", "gzip_zlib", {"type": "gzip", "level": 5, "useZlib": True}, {}),
                      ("n5", "bzip2", {"type": "bzip2", "blockSize": 9}, {}), ("n5", "xz", {"type": "xz"}, {})]
    return tuple({"fmt": fmt, "name": name, "codec": codec, "extra": extra, "seed": seed,
                  "dtype": extra.get("dtype", DTYPES[seed % len(DTYPES)])}
                 for seed, (fmt, name, codec, extra) in enumerate(cases))


CASES = _cases()


def fixture_array(case) -> np.ndarray:
    """The array of ``case``: a seeded random walk along the last axis, in the case's dtype (native byte order, as
    a reader returns it)."""
    rng = np.random.default_rng(case["seed"])
    walk = rng.integers(0, 3, SHAPE).cumsum(axis=-1) % 200
    dtype = np.dtype(case["dtype"]).newbyteorder("=")
    return (walk / 8).astype(dtype) if dtype.kind == "f" else walk.astype(dtype)


def container(fmt) -> str:
    return str(OUT / f"fixtures.{fmt}")


def main():
    import tensorstore as ts

    for fmt in ("zarr", "n5"):
        if os.path.isdir(container(fmt)):
            shutil.rmtree(container(fmt))
    for case in CASES:
        data = fixture_array(case)
        spec = {"driver": case["fmt"], "kvstore": {"driver": "file", "path": container(case["fmt"])},
                "path": case["name"]}
        if case["fmt"] == "zarr":
            spec["metadata"] = dict({"shape": list(SHAPE), "chunks": list(CHUNKS), "compressor": case["codec"],
                                     "dtype": np.dtype(case["dtype"]).str}, **case["extra"])
        else:
            spec["metadata"] = {"dimensions": list(SHAPE)[::-1], "blockSize": list(CHUNKS)[::-1],
                                "compression": case["codec"], "dataType": case["dtype"]}
        store = ts.open(spec, create=True).result()
        (store.T if case["fmt"] == "n5" else store)[...] = data
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"{len(CASES)} arrays, {total} bytes under {OUT}")


if __name__ == "__main__":
    main()
