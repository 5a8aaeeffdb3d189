"""Seeded layouts of the zoo's conversions, for ``chip_smoke.py`` phase 25 and the CPU tests.

Each function writes a dataset's files as they come from the source, with every size an argument: a DICOM series
(``dcmwrite``, in any of the five transfer syntaxes ``utils/dicom.py`` reads), 3D-IRCADb's archive, PUMA's ROIs
and GeoJSON nuclei, OrgLine's COCO masks and HEST's patches, CellViT GeoJSON and Xenium WKB. The brute-force
references (``inside``, ``even_odd``, ``puma_reference``, ``hest_reference``) give the masks the readers must
burn: a pixel is inside where its centre lies inside by the even-odd rule, each edge counted over [lower y,
upper y). This module imports numpy and the port, and PIL and pandas inside the functions that write images and
parquet; never pydicom, rasterio or shapely.
"""

import gzip
import hashlib
import io as bytes_io
import json
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Union

import numpy as np

from torch_em_tpu_torch.data.datasets.histopathology.puma import NUCLEI_CLASS_DICT
from torch_em_tpu_torch.utils import dicom, hdf5

SECONDARY_CAPTURE = "1.2.840.10008.5.1.4.1.1.7"
IMPLEMENTATION_CLASS = "1.2.826.0.1.3680043.10.1379.1"


def packbits_encode(data: np.ndarray) -> bytes:
    """PackBits of a uint8 vector: runs of 3 or more equal bytes as replicate runs, the rest as literal runs, each
    of at most 128 bytes (vectorized)."""
    n = data.size
    if n == 0:
        return b""
    starts = np.flatnonzero(np.concatenate(([True], data[1:] != data[:-1])))
    lengths = np.diff(np.append(starts, n))
    repeat = lengths >= 3
    # a run of its own for each replicate run; literal runs in a row join into one
    begins = repeat | np.concatenate(([True], repeat[:-1]))
    run_start, run_repeat = starts[begins], repeat[begins]
    run_length = np.add.reduceat(lengths, np.flatnonzero(begins))
    pieces = (run_length + 127) // 128
    owner = np.repeat(np.arange(len(run_length)), pieces)
    k = np.arange(int(pieces.sum())) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    start = run_start[owner] + 128 * k
    length = np.minimum(128, run_length[owner] - 128 * k)
    replicate = run_repeat[owner] & (length >= 2)
    size = np.where(replicate, 2, 1 + length)
    offset = np.cumsum(size) - size
    out = np.empty(int(size.sum()), np.uint8)
    out[offset] = np.where(replicate, 257 - length, length - 1).astype(np.uint8)
    out[offset[replicate] + 1] = data[start[replicate]]
    literal = ~replicate
    lit_length = length[literal]
    within = np.arange(int(lit_length.sum())) - np.repeat(np.cumsum(lit_length) - lit_length, lit_length)
    out[np.repeat(offset[literal] + 1, lit_length) + within] = data[np.repeat(start[literal], lit_length) + within]
    return out.tobytes()


def rle_encode_frame(frame: np.ndarray) -> bytes:
    """One frame (rows, cols[, samples]) of 8-, 16- or 32-bit integers as an RLE Lossless fragment."""
    planes = frame[..., None] if frame.ndim == 2 else frame
    planes = np.ascontiguousarray(np.moveaxis(planes, -1, 0), planes.dtype.newbyteorder("<"))
    nbytes = planes.dtype.itemsize
    words = planes.reshape(planes.shape[0], -1).view(np.uint8).reshape(planes.shape[0], -1, nbytes)
    segments = [packbits_encode(np.ascontiguousarray(words[s, :, b]))
                for s in range(words.shape[0]) for b in range(nbytes - 1, -1, -1)]
    segments = [seg + b"\0" * (len(seg) % 2) for seg in segments]
    offsets, position = [], 64
    for seg in segments:
        offsets.append(position)
        position += len(seg)
    return struct.pack("<16I", len(segments), *offsets, *([0] * (15 - len(segments)))) + b"".join(segments)


def format_ds(value) -> str:
    for precision in range(16, 0, -1):
        text = f"{value:.{precision}g}"
        if len(text) <= 16:
            return text
    raise ValueError(f"{value} does not fit a DS value")


def encode_value(vr, value, little) -> bytes:
    if vr in dicom.NUMBERS:
        values = value if isinstance(value, (list, tuple)) else [value]
        return struct.pack(("<" if little else ">") + dicom.NUMBERS[vr] * len(values), *values)
    if isinstance(value, (bytes, bytearray)):
        raw = bytes(value)
        return raw + b"\0" * (len(raw) % 2)
    values = value if isinstance(value, (list, tuple)) else [value]
    if vr == "DS":
        values = [format_ds(float(v)) for v in values]
    raw = "\\".join(str(v) for v in values).encode("latin-1")
    return raw + (b"\0" if vr == "UI" else b" ") * (len(raw) % 2)


def element(tag, vr, raw, little, explicit) -> bytes:
    order = "<" if little else ">"
    head = struct.pack(order + "HH", tag >> 16, tag & 0xFFFF)
    if not explicit:
        return head + struct.pack(order + "I", len(raw)) + raw
    if vr in dicom.LONG_VRS:
        return head + vr.encode() + b"\0\0" + struct.pack(order + "I", len(raw)) + raw
    return head + vr.encode() + struct.pack(order + "H", len(raw)) + raw


def dcmwrite(path: Union[str, os.PathLike, Any], pixel_array: np.ndarray,
             transfer_syntax: str = dicom.EXPLICIT_VR_LITTLE_ENDIAN, **elements) -> None:
    """Write ``pixel_array`` as a DICOM Part 10 file (a path or a binary file object) in one of the five supported
    transfer syntaxes.

    ``pixel_array`` holds 8-, 16- or 32-bit integers: (rows, cols), (frames, rows, cols), or with
    ``SamplesPerPixel=n`` given (rows, cols, n) or (frames, rows, cols, n), written interleaved. ``elements``
    are further data elements by keyword (``InstanceNumber=3``, ``ImagePositionPatient=[0, 0, 1.5]``,
    ``Modality="CT"``, ...); ``SOPClassUID`` defaults to Secondary Capture Image Storage and
    ``SOPInstanceUID`` to a UID derived from the pixels and the elements.
    """
    if transfer_syntax not in dicom.SUPPORTED:
        raise NotImplementedError(f"dcmwrite writes the transfer syntaxes {', '.join(dicom.SUPPORTED)}, not "
                                  f"{transfer_syntax}")
    array = np.asarray(pixel_array)
    if array.dtype.kind not in "ui" or array.dtype.itemsize not in (1, 2, 4):
        raise ValueError(f"dcmwrite writes 8-, 16- and 32-bit integers, not {array.dtype}")
    samples = int(elements.pop("SamplesPerPixel", 1))
    multi_frame = array.ndim == (3 if samples == 1 else 4)
    frame_shape = array.shape[1:] if multi_frame else array.shape
    if len(frame_shape) != (2 if samples == 1 else 3) or (samples > 1 and frame_shape[2] != samples):
        raise ValueError(f"dcmwrite: a pixel array of shape {array.shape} with {samples} sample(s) per pixel")
    bits = array.dtype.itemsize * 8
    values = {"SOPClassUID": SECONDARY_CAPTURE, "SamplesPerPixel": samples,
              "PhotometricInterpretation": "MONOCHROME2" if samples == 1 else "RGB", "Rows": frame_shape[0],
              "Columns": frame_shape[1], "BitsAllocated": bits, "BitsStored": bits, "HighBit": bits - 1,
              "PixelRepresentation": int(array.dtype.kind == "i")}
    if samples > 1:
        values["PlanarConfiguration"] = 0
    if multi_frame:
        values["NumberOfFrames"] = array.shape[0]
    values.update(elements)
    if "SOPInstanceUID" not in values:
        digest = hashlib.sha1(array.tobytes() + repr(sorted(values.items())).encode()).digest()[:15]
        values["SOPInstanceUID"] = "2.25." + str(int.from_bytes(digest, "big"))
    little = transfer_syntax != dicom.EXPLICIT_VR_BIG_ENDIAN
    explicit = transfer_syntax != dicom.IMPLICIT_VR_LITTLE_ENDIAN
    body = []
    for keyword in sorted(values, key=lambda k: dicom.TAGS[k]):
        tag = dicom.TAGS[keyword]
        if tag != dicom.PIXEL_DATA:
            vr = dicom.DICTIONARY[tag][1]
            body.append(element(tag, vr, encode_value(vr, values[keyword], little), little, explicit))
    pixel_vr = "OB" if bits == 8 else "OW"
    if transfer_syntax == dicom.RLE_LOSSLESS:
        fragments = [rle_encode_frame(f) for f in (array if multi_frame else [array])]
        items = b"".join(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f
                         for f in [b""] + [f + b"\0" * (len(f) % 2) for f in fragments])
        body.append(struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\0\0" + struct.pack("<I", dicom.UNDEFINED) + items
                    + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    else:
        raw = array.astype(array.dtype.newbyteorder("<" if little else ">")).tobytes()
        body.append(element(dicom.PIXEL_DATA, pixel_vr, raw + b"\0" * (len(raw) % 2), little, explicit))
    body = b"".join(body)
    if transfer_syntax == dicom.DEFLATED_EXPLICIT_VR_LITTLE_ENDIAN:
        deflate = zlib.compressobj(6, zlib.DEFLATED, -zlib.MAX_WBITS)
        body = deflate.compress(body) + deflate.flush()
        body += b"\0" * (len(body) % 2)
    meta = b"".join(element(tag, dicom.DICTIONARY[tag][1], encode_value(dicom.DICTIONARY[tag][1], value, True), True,
                            True) for tag, value in ((0x00020001, b"\0\1"), (0x00020002, values["SOPClassUID"]),
                                       (0x00020003, values["SOPInstanceUID"]), (0x00020010, transfer_syntax),
                                       (0x00020012, IMPLEMENTATION_CLASS)))
    meta = element(0x00020000, "UL", struct.pack("<I", len(meta)), True, True) + meta
    data = b"\0" * 128 + b"DICM" + meta + body
    if hasattr(path, "write"):
        path.write(data)
        return
    with open(path, "wb") as f:
        f.write(data)


def ct_patient(rng, shape):
    """One seeded CT series (Z, Y, X) of int16 Hounsfield-like values and its liver mask (uint8, 0 and 255 as
    3D-IRCADb's masks): air (-1000) around an elliptic body of soft tissue (40) with two lungs (-850), a spine (700)
    and the liver (60), an ellipsoid placed by the seed; noise of 12 HU."""
    z = (np.arange(shape[0], dtype=np.float32) / shape[0])[:, None, None]
    y = (np.arange(shape[1], dtype=np.float32) / shape[1])[None, :, None]
    x = (np.arange(shape[2], dtype=np.float32) / shape[2])[None, None, :]
    raw = np.full(shape, -1000, np.int16)
    raw[np.broadcast_to(((y - 0.5) / 0.38) ** 2 + ((x - 0.5) / 0.45) ** 2 <= 1, shape)] = 40
    for cx in (0.32, 0.68):
        raw[np.broadcast_to(((y - 0.42) / 0.16) ** 2 + ((x - cx) / 0.11) ** 2 <= 1, shape) & (z > 0.55)] = -850
    raw[np.broadcast_to(((y - 0.78) / 0.06) ** 2 + ((x - 0.5) / 0.05) ** 2 <= 1, shape)] = 700
    c = np.array([0.3, 0.5, 0.35]) + rng.uniform(-0.05, 0.05, 3)
    r = np.array([0.3, 0.17, 0.19]) * rng.uniform(0.9, 1.1, 3)
    liver = ((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((x - c[2]) / r[2]) ** 2 <= 1
    raw[liver] = 60
    raw += (12 * rng.standard_normal(shape, dtype=np.float32)).astype(np.int16)
    return raw, liver.astype(np.uint8) * 255


def ircadb_layout(folder, patients, syntaxes, seed, shape):
    """3D-IRCADb's archive ``<folder>/ircadb.zip``: ``Dataset/3Dircadb1.<k>/PATIENT_DICOM/image_<i>`` and
    ``MASKS_DICOM/liver/image_<i>``, one DICOM file a slice (uncompressed in the archive), each patient's CT and mask
    series (``ct_patient`` of ``shape``) in its (CT, mask) transfer syntaxes, the files encoded on a thread pool.
    Returns [(name, raw, mask)]."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    out = []

    def encode(array, syntax, k, modality):
        buffer = bytes_io.BytesIO()
        extra = dict(BitsStored=12, HighBit=11) if array.dtype == np.int16 else {}
        dcmwrite(buffer, array, syntax, Modality=modality, InstanceNumber=k + 1,
                       ImagePositionPatient=[0.0, 0.0, 1.6 * k], PixelSpacing=[0.74, 0.74], **extra)
        return buffer.getvalue()

    with zipfile.ZipFile(os.path.join(folder, "ircadb.zip"), "w", zipfile.ZIP_STORED) as zf, \
            ThreadPoolExecutor(max_workers=8) as pool:
        for name, (ct_syntax, mask_syntax) in zip(patients, syntaxes):
            raw, mask = ct_patient(rng, shape)
            jobs = [(f"Dataset/{name}/PATIENT_DICOM/image_{k}", pool.submit(encode, raw[k], ct_syntax, k, "CT"))
                    for k in range(len(raw))]
            jobs += [(f"Dataset/{name}/MASKS_DICOM/liver/image_{k}",
                      pool.submit(encode, mask[k], mask_syntax, k, "SEG")) for k in range(len(mask))]
            for arcname, job in jobs:
                zf.writestr(arcname, job.result())
            out.append((name, raw, mask))
    return out


def star(rng, c, r_min, r_max, n):
    """A star-shaped ring around ``c`` (closed, counter-clockwise), radii in [r_min, r_max]."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = rng.uniform(r_min, r_max, n)
    ring = np.stack([c[0] + radii * np.cos(angles), c[1] + radii * np.sin(angles)], axis=1)
    return np.vstack([ring, ring[:1]])


def seeded_nuclei(rng, n, extent, r_range=(5.0, 12.0)):
    """``n`` nuclei as lists of parts (each a list of rings, exterior first) inside circles that lie 2 px apart within
    ``extent``; about a tenth with a hole and a tenth as two parts (a MultiPolygon)."""
    centres, radii, nuclei = np.zeros((0, 2)), np.zeros(0), []
    while len(nuclei) < n:
        c, r = rng.uniform(r_range[1], extent - r_range[1], 2), rng.uniform(*r_range)
        if len(radii) and np.min(np.hypot(*(centres - c).T) - radii - r) < 2:
            continue
        centres, radii = np.vstack([centres, c]), np.append(radii, r)
        kind = rng.random()
        if kind < 0.1:
            parts = [[star(rng, c, 0.7 * r, r, 16), star(rng, c, 0.15 * r, 0.4 * r, 8)[::-1]]]
        elif kind < 0.2:
            parts = [[star(rng, c - (0.5 * r, 0), 0.2 * r, 0.45 * r, 10)],
                     [star(rng, c + (0.5 * r, 0), 0.2 * r, 0.45 * r, 10)]]
        else:
            parts = [[star(rng, c, 0.6 * r, r, int(rng.integers(8, 20)))]]
        nuclei.append(parts)
    return nuclei


def geojson(parts):
    """The GeoJSON geometry of a nucleus' parts."""
    if len(parts) == 1:
        return {"type": "Polygon", "coordinates": [ring.tolist() for ring in parts[0]]}
    return {"type": "MultiPolygon", "coordinates": [[ring.tolist() for ring in part] for part in parts]}


def inside(rings, x, y):
    """Brute force: whether the points (x, y) lie inside ``rings`` by the even-odd rule, each edge counted over
    [lower y, upper y) and a point on an edge inside only where the edge lies left of it."""
    inside = np.zeros(np.shape(x), bool)
    for ring in rings:
        for (x1, y1), (x2, y2) in zip(ring[:-1], ring[1:]):
            if y1 != y2:
                inside ^= (y >= min(y1, y2)) & (y < max(y1, y2)) & (x > x1 + (y - y1) * (x2 - x1) / (y2 - y1))
    return inside


def even_odd(out, rings, value):
    """Burn ``value`` into ``out`` where a pixel centre lies inside ``rings`` (pixel coordinates), by brute force."""
    stack = np.concatenate(rings)
    r0, r1 = max(int(np.floor(stack[:, 1].min())), 0), min(int(np.ceil(stack[:, 1].max())) + 1, out.shape[0])
    c0, c1 = max(int(np.floor(stack[:, 0].min())), 0), min(int(np.ceil(stack[:, 0].max())) + 1, out.shape[1])
    if r0 < r1 and c0 < c1:
        cy, cx = np.mgrid[r0:r1, c0:c1] + 0.5
        out[r0:r1, c0:c1][inside(rings, cx, cy)] = value


def puma_layout(folder, n_rois, n_nuclei, seed=0):
    """PUMA's layout: ``n_rois`` (at most 4) 1024x1024 RGBA TIFFs under ``data/01_training_dataset_tif_ROIs`` (two
    metastatic, two primary) and ``annotations.zip`` with one GeoJSON FeatureCollection of ``n_nuclei`` nuclei a
    ROI, each a Polygon or a MultiPolygon with its class as a raw GeoJSON object. Returns {name: (rgb, nuclei,
    classes)}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    roi_dir = os.path.join(folder, "data", "01_training_dataset_tif_ROIs")
    os.makedirs(roi_dir, exist_ok=True)
    names = [f"training_set_{kind}_roi_{k:03d}" for kind in ("metastatic", "primary") for k in (1, 2)]
    out = {}
    with zipfile.ZipFile(os.path.join(folder, "annotations.zip"), "w") as zf:
        for name in names[:n_rois]:
            rgba = rng.integers(0, 256, (1024, 1024, 4), dtype=np.uint8)
            Image.fromarray(rgba).save(os.path.join(roi_dir, f"{name}.tif"))
            nuclei = seeded_nuclei(rng, n_nuclei, 1024.0)
            classes = [str(c) for c in rng.choice(list(NUCLEI_CLASS_DICT), len(nuclei))]
            features = [{"type": "Feature", "geometry": geojson(parts), "properties": {
                "objectType": "annotation", "classification": {"name": cls, "color": [0, 0, 0]}}}
                for parts, cls in zip(nuclei, classes)]
            zf.writestr(f"01_training_dataset_geojson_nuclei/{name}_nuclei.geojson",
                        json.dumps({"type": "FeatureCollection", "features": features}))
            out[name] = (rgba[..., :3], nuclei, classes)
    return out


def puma_reference(nuclei, classes):
    """The instance and semantic masks that PUMA's conversion must give: the nuclei mapped from the bounds of all
    their vertices onto 1024x1024 pixels (rasterio's ``from_bounds`` and GDAL's inverse), each burned by brute force
    where a pixel centre lies inside, then flipped upside down as the reader does."""
    vertices = np.concatenate([ring for parts in nuclei for part in parts for ring in part])
    minx, miny = vertices.min(axis=0)
    maxx, maxy = vertices.max(axis=0)
    a, e = (maxx - minx) / 1024, (miny - maxy) / 1024
    t0, t1, t3, t5 = -minx / a, 1.0 / a, -maxy / e, 1.0 / e
    instances, semantic = np.zeros((1024, 1024), np.int32), np.zeros((1024, 1024), np.uint8)
    for k, (parts, cls) in enumerate(zip(nuclei, classes), 1):
        for part in parts:
            rings = [np.stack([t0 + t1 * r[:, 0], t3 + t5 * r[:, 1]], axis=1) for r in part]
            even_odd(instances, rings, k)
            even_odd(semantic, rings, NUCLEI_CLASS_DICT[cls])
    return np.fliplr(np.flip(instances)), np.fliplr(np.flip(semantic))


def coco_counts(mask):
    """COCO's compressed RLE counts of a binary mask, written out here: column-major runs starting with zeros, each
    from the fourth on less the one two before, in 5-bit characters from 48 with 0x20 to continue."""
    flat = mask.ravel(order="F").astype(np.int8)
    runs = [int(r) for r in np.diff(np.concatenate(([0], np.flatnonzero(np.diff(flat)) + 1, [flat.size])))]
    if flat[0]:
        runs = [0] + runs
    text = ""
    for i, run in enumerate(runs):
        x = run - (runs[i - 2] if i > 2 else 0)
        while True:
            c, x = x & 0x1F, x >> 5
            more = x != -1 if c & 0x10 else x != 0
            text += chr((c | 0x20 if more else c) + 48)
            if not more:
                break
    return text


def orgline_layout(folder, n_images, shape, seed=0):
    """OrgLine's COCO layout for stomach (``n_images[0]`` images) and breast (``n_images[1]``) of ``shape``: grey
    PNGs under ``images/`` and ``coco.json`` whose organoids are compressed-RLE ellipses and polygon rectangles
    (integer corners: pycocotools fills the pixels [x0, x1) x [y0, y1)), each with its pixel count as ``area``, all
    of distinct sizes and apart. Returns {organ: {file name: (image, expected instance mask)}}, the ids by
    ascending area as the reader pastes them."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = shape
    out = {}
    for organ, n_images in zip(("stomach", "breast"), n_images):
        root = os.path.join(folder, organ)
        os.makedirs(os.path.join(root, "images"), exist_ok=True)
        images, annotations, out[organ] = [], [], {}
        for i in range(n_images):
            image = rng.integers(0, 256, (h, w), dtype=np.uint8)
            file_name = f"images/{organ}_{i:03d}.png"
            Image.fromarray(image).save(os.path.join(root, file_name))
            images.append({"id": 100 + i, "file_name": file_name, "height": h, "width": w})
            masks = []
            for k, (y0, x0) in enumerate((y, x) for y in range(4, h - 40, 48) for x in range(4, w - 40, 48)):
                mask = np.zeros((h, w), bool)
                if k % 2:
                    bh, bw = (int(v) for v in rng.integers(8, 40, 2))
                    mask[y0:y0 + bh, x0:x0 + bw] = True
                    seg = [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]
                else:
                    ry, rx = rng.uniform(5, 19, 2)
                    yy, xx = np.mgrid[:h, :w]
                    mask = ((yy - y0 - 20) / ry) ** 2 + ((xx - x0 - 20) / rx) ** 2 <= 1
                    seg = {"size": [h, w], "counts": coco_counts(mask)}
                if int(mask.sum()) in {int(m.sum()) for m in masks}:
                    continue
                masks.append(mask)
                annotations.append({"id": len(annotations) + 1, "image_id": 100 + i, "category_id": 1, "iscrowd": 0,
                                    "segmentation": seg, "area": int(mask.sum()), "bbox": [0, 0, 0, 0]})
            expected = np.zeros((h, w), np.uint16)
            for seg_id, k in enumerate(np.argsort([m.sum() for m in masks]), 1):
                expected[masks[k]] = seg_id
            out[organ][os.path.basename(file_name)] = (image, expected)
        with open(os.path.join(root, "coco.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": [{"id": 1, "name": "organoid"}]}, f)
    return out


def wkb(parts, big_endian, z):
    """WKB of a nucleus: a Polygon (3, or 1003 with z) or a MultiPolygon (6 or 1006) in either byte order."""
    order = ">" if big_endian else "<"

    def polygon(rings):
        data = bytes([0 if big_endian else 1]) + struct.pack(order + "II", 1003 if z else 3, len(rings))
        for ring in rings:
            coords = np.hstack([ring, np.full((len(ring), 1), 7.5)]) if z else ring
            data += struct.pack(order + "I", len(ring)) + coords.astype(order + "f8").tobytes()
        return data

    if len(parts) == 1:
        return polygon(parts[0])
    head = bytes([0 if big_endian else 1]) + struct.pack(order + "II", 1006 if z else 6, len(parts))
    return head + b"".join(polygon(p) for p in parts)


def hest_reference(nuclei, coord, patch_size, native_scale):
    """One patch's instance mask as HEST's conversion must give it: the nuclei (each a list of parts, in file order)
    that meet the closed window box, tested here by vertex, corner and edge crossing, numbered from 1, mapped into
    the patch and burned part by part by brute force."""
    span = round(patch_size * native_scale)
    x0, y0, x1, y1 = coord[0], coord[1], coord[0] + span, coord[1] + span
    corners = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]

    def side(u, v, w):
        return np.sign((v[0] - u[0]) * (w[1] - u[1]) - (v[1] - u[1]) * (w[0] - u[0]))

    def meets(rings):
        pts = np.concatenate(rings)
        if ((pts[:, 0] >= x0) & (pts[:, 0] <= x1) & (pts[:, 1] >= y0) & (pts[:, 1] <= y1)).any():
            return True
        if inside(rings, np.array(float(x0)), np.array(float(y0))):
            return True
        return any(side(p, q, a) * side(p, q, b) < 0 and side(a, b, p) * side(a, b, q) < 0
                   for ring in rings for p, q in zip(ring[:-1], ring[1:])
                   for a, b in zip(corners, corners[1:] + corners[:1]))

    out = np.zeros((patch_size, patch_size), np.int32)
    selected = [parts for parts in nuclei if any(meets(rings) for rings in parts)]
    for k, parts in enumerate(selected, 1):
        for rings in parts:
            even_odd(out, [(r + (-coord[0], -coord[1])) * (1.0 / native_scale) for r in rings], k)
    return out


def hest_layout(folder, n_nuclei, seed=0):
    """Two HEST slides: ``patches/<id>.h5`` (4 patches of 224x224 on a grid), ``n_nuclei`` nuclei a slide in the
    CellViT GeoJSON (a list of features, each nucleus type a MultiPolygon, one Polygon feature) zipped under
    ``cellvit_seg/``, ``n_nuclei`` Xenium nuclei as WKB (polygons and multipolygons, both byte orders, ISO Z) in a
    parquet under ``xenium_seg/``, the metadata table (0.5 and 0.25 um/px) and the marker table's cache.
    Returns {id: (coords, native scale, CellViT nuclei, Xenium nuclei)}, each nucleus a list of parts, in the order
    the reader numbers them."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    for sub in ("patches", "cellvit_seg", "xenium_seg", "_db_cache"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    out, rows = {}, []
    for sid, pixel_size in (("TENX90", 0.5), ("NCBI91", 0.25)):
        scale = 0.5 / pixel_size
        span = round(224 * scale)
        coords = np.array([(x, y) for y in range(0, 2 * span, span) for x in range(0, 2 * span, span)], np.int64)
        with hdf5.File(os.path.join(folder, "patches", f"{sid}.h5"), "w") as f:
            f.create_dataset("img", data=rng.integers(0, 256, (len(coords), 224, 224, 3), dtype=np.uint8))
            f.create_dataset("coords", data=coords)
        extent = 2 * span
        cellvit = seeded_nuclei(rng, n_nuclei, float(extent), (4.0 * scale, 9.0 * scale))
        # CellViT groups the nuclei by type: a MultiPolygon a type, the reader takes its polygons one by one
        by_type = [cellvit[k::3] for k in range(3)]
        features = [{"type": "Feature", "geometry": {"type": "MultiPolygon", "coordinates": [
            [ring.tolist() for ring in part] for parts in group for part in parts]}, "properties": {"type": k}}
            for k, group in enumerate(by_type[:2])]
        features += [{"type": "Feature", "geometry": geojson(parts), "properties": {}} for parts in by_type[2]]
        cellvit_order = [part for group in by_type[:2] for parts in group for part in parts] + \
            [part for parts in by_type[2] for part in parts]
        with zipfile.ZipFile(os.path.join(folder, "cellvit_seg", f"{sid}_cellvit_seg.geojson.zip"), "w") as zf:
            zf.writestr(f"{sid}_cellvit_seg.geojson", json.dumps(features))
        xenium = seeded_nuclei(rng, n_nuclei, float(extent), (4.0 * scale, 9.0 * scale))
        wkbs = [wkb(parts, big_endian=k % 3 == 1, z=k % 4 == 2) for k, parts in enumerate(xenium)]
        pd.DataFrame({"geometry": wkbs}, index=[f"cell{k}" for k in range(len(wkbs))]).to_parquet(
            os.path.join(folder, "xenium_seg", f"{sid}_xenium_nucleus_seg.parquet"))
        # a CellViT polygon is a nucleus of its own; a Xenium MultiPolygon is one nucleus, its parts under one id
        out[sid] = (coords, scale, [[part] for part in cellvit_order], xenium)
        rows.append(f"{sid},Breast,{pixel_size}")
    with open(os.path.join(folder, "HEST_v1_3_0.csv"), "w") as f:
        f.write("id,organ,pixel_size_um_estimated\n" + "\n".join(rows) + "\n")
    marker_rows = "species\tofficial gene symbol\tcell type\nHs\tKRT8\tHepatocytes\nHs\tCD3E\tT cells\n"
    with open(os.path.join(folder, "_db_cache", "PanglaoDB_markers_27_Mar_2020.tsv.gz"), "wb") as f:
        f.write(gzip.compress(marker_rows.encode(), mtime=0))
    return out
