"""DICOM Part 10 files in numpy and the standard library, with no pydicom.

``dcmread(path)`` gives a ``Dataset`` whose ``pixel_array`` and data elements read as
``pydicom.dcmread(path)`` gives them: elements by their keyword (``ds.Rows``,
``ds.ImagePositionPatient``, ...), numbers as ``int`` or ``float`` and several values as a
list, text with its padding stripped, sequences as lists of ``Dataset``.

A file is the 128-byte preamble, ``DICM``, the file meta group (0002,xxxx) in explicit VR
little endian, then the data set in the transfer syntax that (0002,0010) names: implicit VR
little endian, explicit VR little endian, deflated explicit VR little endian (a raw deflate
stream), explicit VR big endian, or RLE Lossless (explicit VR little endian with the pixel
data encapsulated: one fragment a frame, a 64-byte header of segment offsets, PackBits
segments, the most significant byte of each sample first). A JPEG or JPEG 2000 transfer
syntax raises ``NotImplementedError`` naming the UID and the file; a file without ``DICM``
after its preamble raises ``InvalidDicomError`` naming the file, as ``dcmread`` does without
``force``.

``pixel_array`` follows pydicom: the dtype is the unsigned or signed integer of
``BitsAllocated`` bits by ``PixelRepresentation`` (``BitsAllocated`` 1 unpacks the bits,
least significant first, to ``uint8``); the shape is (rows, cols), (frames, rows, cols),
(rows, cols, samples) or (frames, rows, cols, samples), with ``PlanarConfiguration`` 1 (and
RLE, which is always planar) moved to samples-last; no modality LUT and no rescale are
applied. Where ``BitsStored`` is less than ``BitsAllocated`` the stored words are kept as
they are: the bits above ``HighBit`` are neither masked nor sign-extended.
"""

import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["dcmread", "Dataset", "InvalidDicomError", "IMPLICIT_VR_LITTLE_ENDIAN",
           "EXPLICIT_VR_LITTLE_ENDIAN", "DEFLATED_EXPLICIT_VR_LITTLE_ENDIAN", "EXPLICIT_VR_BIG_ENDIAN",
           "RLE_LOSSLESS"]

IMPLICIT_VR_LITTLE_ENDIAN = "1.2.840.10008.1.2"
EXPLICIT_VR_LITTLE_ENDIAN = "1.2.840.10008.1.2.1"
DEFLATED_EXPLICIT_VR_LITTLE_ENDIAN = "1.2.840.10008.1.2.1.99"
EXPLICIT_VR_BIG_ENDIAN = "1.2.840.10008.1.2.2"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
SUPPORTED = (IMPLICIT_VR_LITTLE_ENDIAN, EXPLICIT_VR_LITTLE_ENDIAN, DEFLATED_EXPLICIT_VR_LITTLE_ENDIAN,
             EXPLICIT_VR_BIG_ENDIAN, RLE_LOSSLESS)
JPEG_FAMILY = "1.2.840.10008.1.2.4."

# VRs whose explicit-VR header has 2 reserved bytes and a 4-byte length (PS3.5 7.1.2); the others a 2-byte length
LONG_VRS = frozenset({"OB", "OD", "OF", "OL", "OV", "OW", "SQ", "SV", "UC", "UN", "UR", "UT", "UV"})
UNDEFINED = 0xFFFFFFFF
ITEM, ITEM_END, SEQUENCE_END = 0xFFFEE000, 0xFFFEE00D, 0xFFFEE0DD
PIXEL_DATA = 0x7FE00010
# binary VRs: struct code of one value
NUMBERS = {"US": "H", "SS": "h", "UL": "I", "SL": "i", "FL": "f", "FD": "d", "UV": "Q", "SV": "q"}
# text VRs that hold one value, backslashes included
SINGLE_TEXT = frozenset({"LT", "ST", "UT", "UR"})

# tag: (keyword, VR) of the elements the readers use and their neighbours; an implicit-VR element not listed here
# reads as UN (its bytes)
DICTIONARY = {
    0x00020000: ("FileMetaInformationGroupLength", "UL"), 0x00020001: ("FileMetaInformationVersion", "OB"),
    0x00020002: ("MediaStorageSOPClassUID", "UI"), 0x00020003: ("MediaStorageSOPInstanceUID", "UI"),
    0x00020010: ("TransferSyntaxUID", "UI"), 0x00020012: ("ImplementationClassUID", "UI"),
    0x00020013: ("ImplementationVersionName", "SH"), 0x00080008: ("ImageType", "CS"),
    0x00080016: ("SOPClassUID", "UI"), 0x00080018: ("SOPInstanceUID", "UI"), 0x00080020: ("StudyDate", "DA"),
    0x00080060: ("Modality", "CS"), 0x00081115: ("ReferencedSeriesSequence", "SQ"),
    0x00081140: ("ReferencedImageSequence", "SQ"), 0x00081150: ("ReferencedSOPClassUID", "UI"),
    0x00081155: ("ReferencedSOPInstanceUID", "UI"), 0x00100010: ("PatientName", "PN"),
    0x00100020: ("PatientID", "LO"), 0x00180050: ("SliceThickness", "DS"), 0x0020000D: ("StudyInstanceUID", "UI"),
    0x0020000E: ("SeriesInstanceUID", "UI"), 0x00200011: ("SeriesNumber", "IS"),
    0x00200013: ("InstanceNumber", "IS"), 0x00200032: ("ImagePositionPatient", "DS"),
    0x00200037: ("ImageOrientationPatient", "DS"), 0x00201041: ("SliceLocation", "DS"),
    0x00280002: ("SamplesPerPixel", "US"), 0x00280004: ("PhotometricInterpretation", "CS"),
    0x00280006: ("PlanarConfiguration", "US"), 0x00280008: ("NumberOfFrames", "IS"), 0x00280010: ("Rows", "US"),
    0x00280011: ("Columns", "US"), 0x00280030: ("PixelSpacing", "DS"), 0x00280100: ("BitsAllocated", "US"),
    0x00280101: ("BitsStored", "US"), 0x00280102: ("HighBit", "US"), 0x00280103: ("PixelRepresentation", "US"),
    0x00281050: ("WindowCenter", "DS"), 0x00281051: ("WindowWidth", "DS"), 0x00281052: ("RescaleIntercept", "DS"),
    0x00281053: ("RescaleSlope", "DS"), 0x7FE00010: ("PixelData", "OW"),
}
TAGS = {keyword: tag for tag, (keyword, _) in DICTIONARY.items()}


class InvalidDicomError(Exception):
    """A file that is not DICOM Part 10: no ``DICM`` after the 128-byte preamble."""


class Dataset:
    """The data elements of one DICOM data set (or sequence item), by tag; read by keyword as attributes."""

    def __init__(self, elements: Dict[int, Tuple[str, Any]], little_endian: bool = True,
                 file_meta: Optional["Dataset"] = None, filename: Optional[str] = None):
        self._elements = elements  # tag: (VR, raw bytes, a list of Datasets for SQ, or a list of fragments)
        self._little = little_endian
        self.file_meta = file_meta
        self.filename = filename
        self._pixels = None

    def __getattr__(self, name):
        if name.startswith("_") or name not in TAGS:
            raise AttributeError(f"'Dataset' object has no attribute '{name}'")
        tag = TAGS[name]
        if tag not in self._elements:
            raise AttributeError(f"'Dataset' object has no attribute '{name}'")
        return self._value(tag)

    def __contains__(self, name) -> bool:
        return (TAGS.get(name) if isinstance(name, str) else name) in self._elements

    def get(self, name: str, default=None):
        return getattr(self, name) if name in self else default

    def _value(self, tag):
        vr, raw = self._elements[tag]
        if vr == "SQ" or isinstance(raw, list):
            return raw
        return _decode(vr, raw, self._little)

    @property
    def pixel_array(self) -> np.ndarray:
        """The pixel data as pydicom's ``pixel_array`` gives it (decoded once)."""
        if self._pixels is None:
            self._pixels = _pixel_array(self)
        return self._pixels


def _decode(vr, raw, little):
    if vr in NUMBERS:
        code = NUMBERS[vr]
        values = struct.unpack(("<" if little else ">") + code * (len(raw) // struct.calcsize(code)), raw)
        return values[0] if len(values) == 1 else list(values)
    if vr in ("OB", "OD", "OF", "OL", "OV", "OW", "UN"):
        return bytes(raw)
    text = bytes(raw).decode("latin-1")
    if vr in SINGLE_TEXT:
        return text.rstrip("\x00 ")
    values = [v.strip("\x00 ") for v in text.split("\\")]
    if vr == "IS":
        values = [int(float(v)) if v else None for v in values]
    elif vr == "DS":
        values = [float(v) if v else None for v in values]
    return values[0] if len(values) == 1 else values


def _sniff_explicit(buf, pos) -> bool:
    """Whether the data set at ``pos`` starts with an explicit-VR element (its bytes 4-5 two capitals)."""
    vr = bytes(buf[pos + 4:pos + 6])
    return len(vr) == 2 and vr.isalpha() and vr.isupper()


class _Parser:
    """Walks a data set's elements in one byte order and VR encoding."""

    def __init__(self, buf, little, explicit, filename):
        self.buf, self.little, self.explicit, self.filename = buf, little, explicit, filename
        self.tag_fmt = struct.Struct("<HH" if little else ">HH")
        self.u16 = struct.Struct("<H" if little else ">H")
        self.u32 = struct.Struct("<I" if little else ">I")

    def header(self, pos):
        """(tag, VR or None, length, position of the value) of the element at ``pos``."""
        group, element = self.tag_fmt.unpack_from(self.buf, pos)
        tag = group << 16 | element
        if group == 0xFFFE:  # items and delimiters have no VR in either encoding
            return tag, None, self.u32.unpack_from(self.buf, pos + 4)[0], pos + 8
        if not self.explicit:
            return tag, DICTIONARY.get(tag, ("", "UN"))[1], self.u32.unpack_from(self.buf, pos + 4)[0], pos + 8
        vr = bytes(self.buf[pos + 4:pos + 6]).decode("latin-1")
        if vr in LONG_VRS:
            return tag, vr, self.u32.unpack_from(self.buf, pos + 8)[0], pos + 12
        if not vr.isalpha():
            raise ValueError(f"{self.filename}: an invalid VR {vr!r} at byte {pos} of the data set")
        return tag, vr, self.u16.unpack_from(self.buf, pos + 6)[0], pos + 8

    def dataset(self, pos, end, until_item_end=False) -> Tuple[Dict[int, Tuple[str, Any]], int]:
        """The elements from ``pos`` to ``end`` (or to an item delimiter); returns them and the position after."""
        elements = {}
        while pos < end:
            if end - pos < 8:  # trailing padding
                return elements, end
            tag, vr, length, pos = self.header(pos)
            if tag == ITEM_END:
                if until_item_end:
                    return elements, pos
                continue
            if tag == PIXEL_DATA and length == UNDEFINED:
                fragments, pos = self.fragments(pos)
                elements[tag] = (vr, fragments)
                continue
            if vr == "SQ" or (length == UNDEFINED and (vr == "UN" or not self.explicit)):
                # an undefined length means a sequence in implicit VR; an explicit UN of undefined length holds one
                # in implicit VR little endian (PS3.5 6.2.2)
                parser = self if vr == "SQ" or not self.explicit else _Parser(self.buf, True, False, self.filename)
                items, pos = parser.sequence(pos, length, end)
                elements[tag] = ("SQ", items)
                continue
            if length == UNDEFINED:
                raise ValueError(f"{self.filename}: element ({tag >> 16:04X},{tag & 0xFFFF:04X}) of VR {vr} has an "
                                 "undefined length")
            elements[tag] = (vr, self.buf[pos:pos + length])
            pos += length
        return elements, pos

    def sequence(self, pos, length, end):
        """The items of a sequence of defined or undefined length (walked to (FFFE,E0DD))."""
        stop = end if length == UNDEFINED else pos + length
        items = []
        while pos < stop:
            tag, _, item_length, pos = self.header(pos)
            if tag == SEQUENCE_END:
                return items, pos
            if tag != ITEM:
                raise ValueError(f"{self.filename}: ({tag >> 16:04X},{tag & 0xFFFF:04X}) inside a sequence, "
                                 "where an item was expected")
            if item_length == UNDEFINED:
                elements, pos = self.dataset(pos, stop, until_item_end=True)
            else:
                elements, _ = self.dataset(pos, pos + item_length)
                pos += item_length
            items.append(Dataset(elements, self.little, filename=self.filename))
        if length == UNDEFINED:
            raise ValueError(f"{self.filename}: a sequence of undefined length has no delimiter")
        return items, pos

    def fragments(self, pos):
        """Encapsulated pixel data: ([basic offset table, fragment, ...], position after (FFFE,E0DD))."""
        items = []
        while True:
            tag, _, length, pos = self.header(pos)
            if tag == SEQUENCE_END:
                return items, pos
            if tag != ITEM:
                raise ValueError(f"{self.filename}: ({tag >> 16:04X},{tag & 0xFFFF:04X}) inside the encapsulated "
                                 "pixel data, where a fragment was expected")
            items.append(self.buf[pos:pos + length])
            pos += length


def _read_bytes(source) -> Tuple[bytes, str]:
    if hasattr(source, "read"):
        return source.read(), getattr(source, "name", "<file object>")
    with open(source, "rb") as f:
        return f.read(), os.fspath(source)


def dcmread(path: Union[str, os.PathLike]) -> Dataset:
    """Read a DICOM Part 10 file (a path or a binary file object) as a ``Dataset``."""
    data, filename = _read_bytes(path)
    if len(data) < 132 or data[128:132] != b"DICM":
        raise InvalidDicomError(f"{filename} is not a DICOM Part 10 file: the 'DICM' prefix is missing after the "
                                "128-byte preamble (File Meta Information header)")
    buf = memoryview(data)
    meta_parser = _Parser(buf, True, True, filename)
    pos, meta = 132, {}
    while pos + 8 <= len(data) and struct.unpack_from("<H", buf, pos)[0] == 0x0002:
        tag, vr, length, pos = meta_parser.header(pos)
        meta[tag] = (vr, buf[pos:pos + length])
        pos += length
    file_meta = Dataset(meta, True, filename=filename)
    syntax = file_meta.get("TransferSyntaxUID")
    if syntax is not None and syntax not in SUPPORTED:
        kind = "JPEG-family compressed pixel data" if syntax.startswith(JPEG_FAMILY) else "this transfer syntax"
        raise NotImplementedError(f"{filename}: transfer syntax {syntax} ({kind}) is not supported; supported are "
                                  f"{', '.join(SUPPORTED)}")
    if syntax == DEFLATED_EXPLICIT_VR_LITTLE_ENDIAN:
        buf, pos = memoryview(zlib.decompress(data[pos:], -zlib.MAX_WBITS)), 0
    little = syntax != EXPLICIT_VR_BIG_ENDIAN
    explicit = syntax != IMPLICIT_VR_LITTLE_ENDIAN if syntax is not None else _sniff_explicit(buf, pos)
    elements, _ = _Parser(buf, little, explicit, filename).dataset(pos, len(buf))
    return Dataset(elements, little, file_meta=file_meta, filename=filename)


def _packbits_decode(segment: memoryview) -> bytearray:
    """One PackBits segment, as pydicom decodes it: a header byte n < 128 copies the next n + 1 bytes, n > 128
    repeats the next byte 257 - n times, 128 does nothing; a header with nothing after it ends the segment."""
    out = bytearray()
    pos, size = 0, len(segment)
    while pos < size:
        n = segment[pos]
        pos += 1
        if n < 128:
            out += segment[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            out += bytes(segment[pos:pos + 1]) * (257 - n)
            pos += 1
    return out


def _rle_frame(fragment, rows, cols, samples, bits, filename) -> np.ndarray:
    """One RLE Lossless frame as (samples, rows * cols) little-endian words of ``bits`` bits."""
    if bits % 8:
        raise NotImplementedError(f"{filename}: RLE Lossless with BitsAllocated {bits} is not supported")
    nbytes = bits // 8
    header = struct.unpack_from("<16I", fragment, 0)
    n_segments = header[0]
    if n_segments != samples * nbytes:
        raise ValueError(f"{filename}: the RLE header names {n_segments} segments, where {samples} sample(s) of "
                         f"{bits} bits need {samples * nbytes}")
    offsets = list(header[1:1 + n_segments]) + [len(fragment)]
    planes = np.empty((samples, nbytes, rows * cols), np.uint8)
    for k in range(n_segments):
        decoded = _packbits_decode(fragment[offsets[k]:offsets[k + 1]])
        if len(decoded) < rows * cols:
            raise ValueError(f"{filename}: RLE segment {k} decodes to {len(decoded)} bytes, fewer than the "
                             f"{rows * cols} pixels of a frame")
        # segments run from the most significant byte of a sample to the least
        planes[k // nbytes, nbytes - 1 - k % nbytes] = np.frombuffer(decoded, np.uint8, rows * cols)
    return planes.transpose(0, 2, 1).copy()  # (samples, pixels, bytes): little-endian words in C order


def _frames_of(fragments, n_frames, filename) -> List[bytes]:
    """The frames of encapsulated pixel data: by the basic offset table where it has entries, one fragment a frame
    where there are as many, all fragments joined for a single frame."""
    table, fragments = bytes(fragments[0]), fragments[1:]
    if table:
        offsets = list(struct.unpack(f"<{len(table) // 4}I", table)) + [None]
        starts, position = [], 0
        for fragment in fragments:
            starts.append(position)
            position += 8 + len(fragment)
        frames = []
        for first, last in zip(offsets[:-1], offsets[1:]):
            frames.append(b"".join(bytes(f) for f, s in zip(fragments, starts)
                                   if s >= first and (last is None or s < last)))
        return frames
    if n_frames == 1:
        return [b"".join(bytes(f) for f in fragments)]
    if len(fragments) == n_frames:
        return [bytes(f) for f in fragments]
    raise ValueError(f"{filename}: {len(fragments)} fragments for {n_frames} frames and no basic offset table")


def _pixel_array(ds: Dataset) -> np.ndarray:
    if PIXEL_DATA not in ds._elements:
        raise AttributeError(f"{ds.filename}: the data set has no Pixel Data element (7FE0,0010)")
    rows, cols, bits = int(ds.Rows), int(ds.Columns), int(ds.BitsAllocated)
    samples = int(ds.get("SamplesPerPixel", 1) or 1)
    frames = int(ds.get("NumberOfFrames", 1) or 1)
    signed = int(ds.get("PixelRepresentation", 0) or 0) == 1
    syntax = ds.file_meta.get("TransferSyntaxUID") if ds.file_meta is not None else None
    vr, raw = ds._elements[PIXEL_DATA]
    if syntax == RLE_LOSSLESS:
        words = [_rle_frame(memoryview(f), rows, cols, samples, bits, ds.filename)
                 for f in _frames_of(raw, frames, ds.filename)]
        dtype = np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")
        planar = np.stack(words).view(dtype).reshape(len(words), samples, rows, cols)
        array = planar.transpose(0, 2, 3, 1) if samples > 1 else planar[:, 0]
        array = array.astype(dtype.newbyteorder("="))
        return array[0] if frames == 1 else array
    if isinstance(raw, list):
        raise ValueError(f"{ds.filename}: encapsulated pixel data in transfer syntax {syntax}")
    count = rows * cols * samples * frames
    if bits == 1:
        needed = (count + 7) // 8
        if len(raw) < needed:
            raise ValueError(f"{ds.filename}: {len(raw)} bytes of pixel data, {needed} expected")
        flat = np.unpackbits(np.frombuffer(raw, np.uint8, needed), bitorder="little")[:count]
    else:
        if bits not in (8, 16, 32, 64):
            raise NotImplementedError(f"{ds.filename}: BitsAllocated {bits} is not supported")
        dtype = np.dtype(f"{'i' if signed else 'u'}{bits // 8}").newbyteorder("<" if ds._little else ">")
        needed = count * dtype.itemsize
        if len(raw) < needed:
            raise ValueError(f"{ds.filename}: {len(raw)} bytes of pixel data, {needed} expected")
        data = bytes(raw[:needed])
        if bits == 8 and not ds._little and vr == "OW":  # 8-bit samples in big-endian 16-bit words
            data = np.frombuffer(data, np.uint16).byteswap().tobytes()
        flat = np.frombuffer(data, dtype).astype(dtype.newbyteorder("="))
    planar = samples > 1 and int(ds.get("PlanarConfiguration", 0) or 0) == 1
    if samples == 1:
        shape = (frames, rows, cols)
        array = flat.reshape(shape)
    elif planar:
        array = flat.reshape(frames, samples, rows, cols).transpose(0, 2, 3, 1)
    else:
        array = flat.reshape(frames, rows, cols, samples)
    array = np.ascontiguousarray(array)
    return array[0] if frames == 1 else array
