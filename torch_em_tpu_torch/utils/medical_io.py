"""Pure-numpy readers and writers of medical and cryo-EM volume formats.

The port's own copy of ``torch_em_tpu/utils/medical_io.py``. torch-em's
medical datasets read NIfTI through nibabel and MetaImage through SimpleITK;
neither is installed, and the formats are simple enough to parse directly:

- NIfTI-1 (``.nii``, ``.nii.gz``): a 348-byte header and the voxels,
  optionally gzipped; arrays come back with shape (X, Y, Z[, T]) and the scl
  slope and intercept applied, as ``nibabel.load(...).get_fdata()`` gives;
- MetaImage (``.mha``, ``.mhd`` with its raw file): an ASCII key = value
  header and the voxels, optionally zlib-compressed; arrays come back
  C-ordered (Z, Y, X), as SimpleITK's ``GetArrayFromImage`` gives;
- NRRD (``.nrrd``): shape equal to the header's ``sizes``, as ``nrrd.read``;
- MRC2014 (``.mrc``, ``.rec``): C-ordered (Z, Y, X), as ``mrcfile``.
"""

import gzip
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_nifti", "save_nifti", "load_mha", "save_mha", "load_nrrd", "save_nrrd", "load_mrc", "save_mrc"]

# NIfTI datatype codes -> numpy dtypes (nifti1.h)
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def _open_maybe_gzip(path, mode="rb"):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


def load_nifti(path: str, return_affine: bool = False, apply_scaling: bool = True):
    """Read a NIfTI-1 volume; returns a Fortran-ordered (X, Y, Z[, ...]) array
    like nibabel's ``get_fdata``."""
    with _open_maybe_gzip(path) as f:
        header = f.read(348)
        if len(header) < 348:
            raise ValueError(f"Truncated NIfTI header in {path}.")
        sizeof_hdr = struct.unpack("<i", header[:4])[0]
        byteorder = "<"
        if sizeof_hdr != 348:
            byteorder = ">"
            if struct.unpack(">i", header[:4])[0] != 348:
                raise ValueError(f"{path} is not a NIfTI-1 file.")
        magic = header[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path} has invalid NIfTI magic {magic!r}.")

        dim = struct.unpack(byteorder + "8h", header[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1:1 + ndim])
        datatype = struct.unpack(byteorder + "h", header[70:72])[0]
        vox_offset = int(struct.unpack(byteorder + "f", header[108:112])[0])
        scl_slope = struct.unpack(byteorder + "f", header[112:116])[0]
        scl_inter = struct.unpack(byteorder + "f", header[116:120])[0]
        if datatype not in _NIFTI_DTYPES:
            raise ValueError(f"Unsupported NIfTI datatype code {datatype} in {path}.")
        dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(byteorder)

        f.seek(max(vox_offset, 348))
        data = np.frombuffer(f.read(int(np.prod(shape)) * dtype.itemsize), dtype=dtype)
    array = data.reshape(shape, order="F")
    if apply_scaling and scl_slope not in (0.0, 1.0) or (apply_scaling and scl_inter != 0.0):
        array = array.astype("float64") * (scl_slope if scl_slope != 0 else 1.0) + scl_inter
    if return_affine:
        return np.ascontiguousarray(array), _nifti_affine(header, byteorder)
    return np.ascontiguousarray(array)


def _nifti_affine(header, bo):
    srow_x = struct.unpack(bo + "4f", header[280:296])
    srow_y = struct.unpack(bo + "4f", header[296:312])
    srow_z = struct.unpack(bo + "4f", header[312:328])
    sform_code = struct.unpack(bo + "h", header[254:256])[0]
    if sform_code > 0:
        return np.array([srow_x, srow_y, srow_z, (0, 0, 0, 1)], dtype="float64")
    pixdim = struct.unpack(bo + "8f", header[76:108])
    aff = np.eye(4)
    aff[0, 0], aff[1, 1], aff[2, 2] = pixdim[1], pixdim[2], pixdim[3]
    return aff


def save_nifti(path: str, array: np.ndarray, affine: Optional[np.ndarray] = None) -> None:
    """Write a NIfTI-1 volume (Fortran voxel order, optional .gz)."""
    array = np.asarray(array)
    if array.dtype not in _NIFTI_CODES:
        array = array.astype("float32")
    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)
    dim = [array.ndim] + list(array.shape) + [1] * (7 - array.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, _NIFTI_CODES[array.dtype])
    struct.pack_into("<h", header, 72, array.dtype.itemsize * 8)
    pixdim = [1.0] * 8
    struct.pack_into("<8f", header, 76, *pixdim)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)    # scl_slope
    struct.pack_into("<f", header, 116, 0.0)    # scl_inter
    if affine is None:
        affine = np.eye(4)
    struct.pack_into("<h", header, 252, 1)  # qform_code
    struct.pack_into("<h", header, 254, 1)  # sform_code
    struct.pack_into("<4f", header, 280, *affine[0])
    struct.pack_into("<4f", header, 296, *affine[1])
    struct.pack_into("<4f", header, 312, *affine[2])
    header[344:348] = b"n+1\x00"
    payload = bytes(header) + b"\x00" * 4 + np.asfortranarray(array).tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


_MHA_DTYPES = {
    "MET_UCHAR": np.uint8, "MET_CHAR": np.int8, "MET_USHORT": np.uint16,
    "MET_SHORT": np.int16, "MET_UINT": np.uint32, "MET_INT": np.int32,
    "MET_ULONG": np.uint64, "MET_LONG": np.int64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MHA_CODES = {np.dtype(v): k for k, v in _MHA_DTYPES.items()}


def load_mha(path: str) -> np.ndarray:
    """Read a MetaImage (.mha, or .mhd + raw) volume; returns a C-ordered
    (Z, Y, X) array like SimpleITK's GetArrayFromImage."""
    header = {}
    data_start = None
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"No ElementDataFile key in {path}.")
            key, _, value = line.decode("latin-1").partition("=")
            key, value = key.strip(), value.strip()
            header[key] = value
            if key == "ElementDataFile":
                data_start = f.tell()
                break
        dims = tuple(int(d) for d in header["DimSize"].split())
        dtype = np.dtype(_MHA_DTYPES[header.get("ElementType", "MET_UCHAR")])
        if header.get("BinaryDataByteOrderMSB", "False").lower() == "true" or \
                header.get("ElementByteOrderMSB", "False").lower() == "true":
            dtype = dtype.newbyteorder(">")
        n_bytes = int(np.prod(dims)) * dtype.itemsize

        if header["ElementDataFile"] == "LOCAL":
            raw = f.read()
        else:
            data_path = os.path.join(os.path.dirname(path), header["ElementDataFile"])
            with open(data_path, "rb") as df:
                raw = df.read()
    if header.get("CompressedData", "False").lower() == "true":
        raw = zlib.decompress(raw)
    data = np.frombuffer(raw[:n_bytes], dtype=dtype)
    return data.reshape(dims[::-1])  # (Z, Y, X)


def save_mha(path: str, array: np.ndarray, compressed: bool = True) -> None:
    """Write a MetaImage volume from a C-ordered (Z, Y, X) array."""
    array = np.ascontiguousarray(array)
    if array.dtype not in _MHA_CODES:
        array = array.astype("float32")
    dims = " ".join(str(d) for d in array.shape[::-1])
    raw = array.tobytes()
    if compressed:
        raw = zlib.compress(raw)
    lines = [
        "ObjectType = Image",
        f"NDims = {array.ndim}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    if compressed:
        lines.append(f"CompressedDataSize = {len(raw)}")
    lines += [
        f"DimSize = {dims}",
        f"ElementType = {_MHA_CODES[array.dtype]}",
        "ElementDataFile = LOCAL",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("latin-1"))
        f.write(raw)


_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8, "uint8_t": np.uint8,
    "short": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16, "uint16_t": np.uint16,
    "int": np.int32, "int32": np.int32, "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32, "uint32_t": np.uint32,
    "long long": np.int64, "int64": np.int64, "int64_t": np.int64,
    "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}
_NRRD_CODES = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


def load_nrrd(path: str, return_header: bool = False):
    """Read an NRRD volume; returns a Fortran-ordered array with shape equal
    to the header's ``sizes`` (matching ``nrrd.read``)."""
    header = {}
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path} is not an NRRD file.")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("latin-1").strip()
            if text.startswith("#"):
                continue
            for sep in (": ", ":="):
                if sep in text:
                    key, value = text.split(sep, 1)
                    header[key.strip().lower()] = value.strip()
                    break
        raw = f.read()

    if "data file" in header or "datafile" in header:
        data_file = header.get("data file", header.get("datafile"))
        with open(os.path.join(os.path.dirname(path), data_file), "rb") as df:
            raw = df.read()
    encoding = header.get("encoding", "raw").lower()
    if encoding in ("gzip", "gz"):
        raw = gzip.decompress(raw)
    elif encoding not in ("raw",):
        raise ValueError(f"Unsupported NRRD encoding: {encoding}.")
    sizes = tuple(int(s) for s in header["sizes"].split())
    dtype = np.dtype(_NRRD_DTYPES[header["type"].strip()])
    if header.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    data = np.frombuffer(raw[: int(np.prod(sizes)) * dtype.itemsize], dtype=dtype)
    array = data.reshape(sizes, order="F")
    if return_header:
        return array, header
    return array


def save_nrrd(path: str, array: np.ndarray, compressed: bool = True) -> None:
    """Write an NRRD volume (Fortran voxel order, matching ``nrrd.write``)."""
    array = np.asarray(array)
    if array.dtype not in _NRRD_CODES:
        array = array.astype("float32")
    raw = np.asfortranarray(array).tobytes(order="F")
    if compressed:
        raw = gzip.compress(raw)
    header = [
        "NRRD0004",
        f"type: {_NRRD_CODES[array.dtype]}",
        f"dimension: {array.ndim}",
        f"sizes: {' '.join(str(s) for s in array.shape)}",
        f"encoding: {'gzip' if compressed else 'raw'}",
        "endian: little",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n\n").encode("latin-1"))
        f.write(raw)


_MRC_MODES = {0: np.int8, 1: np.int16, 2: np.float32, 3: np.complex64,
              4: np.complex64, 6: np.uint16, 12: np.float16, 101: np.uint8}
_MRC_CODES = {np.dtype(np.int8): 0, np.dtype(np.int16): 1, np.dtype(np.float32): 2,
              np.dtype(np.uint16): 6, np.dtype(np.float16): 12}


def load_mrc(path: str) -> np.ndarray:
    """Read an MRC2014 volume (cryo-EM standard); returns a C-ordered
    (Z, Y, X) array like ``mrcfile.open(path).data``."""
    with _open_maybe_gzip(path) as f:
        header = f.read(1024)
        if len(header) < 1024:
            raise ValueError(f"Truncated MRC header in {path}.")
        machst = header[212:216]
        bo = ">" if machst[:2] == b"\x11\x11" else "<"
        nx, ny, nz = struct.unpack(bo + "3i", header[0:12])
        mode = struct.unpack(bo + "i", header[12:16])[0]
        nsymbt = struct.unpack(bo + "i", header[92:96])[0]
        if mode not in _MRC_MODES:
            raise ValueError(f"Unsupported MRC mode {mode} in {path}.")
        dtype = np.dtype(_MRC_MODES[mode]).newbyteorder(bo)
        f.seek(1024 + nsymbt)
        data = np.frombuffer(f.read(nx * ny * nz * dtype.itemsize), dtype=dtype)
    return data.reshape(nz, ny, nx)


def save_mrc(path: str, array: np.ndarray) -> None:
    """Write an MRC2014 volume from a C-ordered (Z, Y, X) array."""
    array = np.ascontiguousarray(array)
    if array.dtype not in _MRC_CODES:
        array = array.astype("float32")
    nz, ny, nx = array.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)
    struct.pack_into("<i", header, 12, _MRC_CODES[array.dtype])
    struct.pack_into("<3i", header, 28, nx, ny, nz)   # mx, my, mz
    struct.pack_into("<3f", header, 40, float(nx), float(ny), float(nz))  # cella
    struct.pack_into("<3i", header, 64, 1, 2, 3)      # axis mapping
    struct.pack_into("<2f", header, 76, float(array.min()), float(array.max()))
    struct.pack_into("<f", header, 84, float(array.mean()))
    struct.pack_into("<i", header, 92, 0)             # nsymbt
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"             # little-endian machine stamp
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(array.tobytes())
