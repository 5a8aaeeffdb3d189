"""The port's DICOM reader (``utils/dicom.py``) on byte streams built here by hand from the standard (PS3.5,
PS3.10), in every transfer syntax it reads: implicit and explicit VR little endian, deflated explicit VR little
endian, explicit VR big endian and RLE Lossless; with an undefined-length sequence in implicit VR, planar
configuration 1, several frames, ``BitsAllocated`` 1, signed 16-bit pixels and ``BitsStored`` below
``BitsAllocated``. A JPEG-family transfer syntax and a file without ``DICM`` raise. The test data writer
``scripts/torch_conversion_layouts.py:dcmwrite`` round trips through ``dcmread`` in each syntax. pydicom is
installed on neither machine: what pydicom gives is taken from the standard and from pydicom's documented
``pixel_array`` rules."""

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from torch_em_tpu_torch.utils import dicom

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_conversion_layouts as layouts  # noqa: E402

LONG = {"OB", "OD", "OF", "OL", "OV", "OW", "SQ", "SV", "UC", "UN", "UR", "UT", "UV"}
IMPLICIT, EXPLICIT, DEFLATED, BIG, RLE = ("1.2.840.10008.1.2", "1.2.840.10008.1.2.1", "1.2.840.10008.1.2.1.99",
                                          "1.2.840.10008.1.2.2", "1.2.840.10008.1.2.5")


def pad(raw, fill=b" "):
    return raw + fill * (len(raw) % 2)


def explicit(tag, vr, value, order="<"):
    head = struct.pack(order + "HH", tag >> 16, tag & 0xFFFF) + vr.encode()
    if vr in LONG:
        return head + b"\0\0" + struct.pack(order + "I", len(value)) + value
    return head + struct.pack(order + "H", len(value)) + value


def implicit(tag, value, length=None):
    return struct.pack("<HHI", tag >> 16, tag & 0xFFFF, len(value) if length is None else length) + value


def part10(syntax, dataset):
    """Preamble, DICM and the file meta group in explicit VR little endian, then ``dataset`` as given."""
    meta = explicit(0x00020001, "OB", b"\0\1") + explicit(0x00020010, "UI", pad(syntax.encode(), b"\0"))
    return b"\0" * 128 + b"DICM" + explicit(0x00020000, "UL", struct.pack("<I", len(meta))) + meta + dataset


def image_elements(rows, cols, bits, signed=False, samples=1, stored=None, frames=None, planar=None,
                   order="<", write=explicit):
    """The image pixel module's elements in tag order, (0028,0002) to (0028,0103)."""
    def us(v):
        return struct.pack(order + "H", v)

    items = [(0x00280002, "US", us(samples)),
             (0x00280004, "CS", pad(b"MONOCHROME2" if samples == 1 else b"RGB"))]
    if planar is not None:
        items.append((0x00280006, "US", us(planar)))
    if frames is not None:
        items.append((0x00280008, "IS", pad(str(frames).encode())))
    items += [(0x00280010, "US", us(rows)), (0x00280011, "US", us(cols)), (0x00280100, "US", us(bits)),
              (0x00280101, "US", us(stored or bits)), (0x00280102, "US", us((stored or bits) - 1)),
              (0x00280103, "US", us(int(signed)))]
    if write is explicit:
        return b"".join(explicit(tag, vr, value, order) for tag, vr, value in items)
    return b"".join(implicit(tag, value) for tag, _, value in items)


def read(tmp_path, data, name="x.dcm"):
    path = tmp_path / name
    path.write_bytes(data)
    return dicom.dcmread(str(path))


def test_explicit_little_endian_signed_16bit_and_attributes(tmp_path):
    pixels = np.array([[-1000, 0, 1], [32767, -32768, 40]], np.int16)
    dataset = (explicit(0x00080060, "CS", pad(b"CT")) + explicit(0x00200013, "IS", pad(b"7"))
               + explicit(0x00200032, "DS", pad(b"1.5\\-2\\3.25")) + image_elements(2, 3, 16, signed=True)
               + explicit(0x7FE00010, "OW", pixels.astype("<i2").tobytes()))
    ds = read(tmp_path, part10(EXPLICIT, dataset))
    assert ds.file_meta.TransferSyntaxUID == EXPLICIT
    assert (ds.Modality, ds.InstanceNumber, ds.ImagePositionPatient) == ("CT", 7, [1.5, -2.0, 3.25])
    assert (ds.Rows, ds.Columns, ds.BitsAllocated, ds.PixelRepresentation, ds.SamplesPerPixel) == (2, 3, 16, 1, 1)
    assert ds.PhotometricInterpretation == "MONOCHROME2"
    assert "Rows" in ds and "NumberOfFrames" not in ds and ds.get("NumberOfFrames", 1) == 1
    assert ds.pixel_array.dtype == np.int16
    np.testing.assert_array_equal(ds.pixel_array, pixels)
    with pytest.raises(AttributeError):
        ds.NumberOfFrames


def test_explicit_long_vrs_and_defined_length_sequence(tmp_path):
    """OB, UN, UT take 2 reserved bytes and a 4-byte length; a sequence of defined length holds an item of
    defined length; a 2-byte-length VR (LO) next to them."""
    item = explicit(0x0020000E, "UI", pad(b"1.2.3", b"\0"))
    sequence = struct.pack("<HHI", 0xFFFE, 0xE000, len(item)) + item
    pixels = np.arange(6, dtype=np.uint8).reshape(2, 3)
    dataset = (explicit(0x00081115, "SQ", sequence) + explicit(0x00091001, "UN", b"\1\2\3\4")
               + explicit(0x00100020, "LO", pad(b"patient")) + explicit(0x00291010, "UT", pad(b"a\\b text"))
               + explicit(0x00291011, "OB", b"\xff\0") + image_elements(2, 3, 8)
               + explicit(0x7FE00010, "OB", pad(pixels.tobytes(), b"\0")))
    ds = read(tmp_path, part10(EXPLICIT, dataset))
    assert ds.PatientID == "patient"
    assert [item.SeriesInstanceUID for item in ds.ReferencedSeriesSequence] == ["1.2.3"]
    assert 0x00291010 in ds and 0x00091001 in ds
    np.testing.assert_array_equal(ds.pixel_array, pixels)


def test_implicit_undefined_length_sequence(tmp_path):
    """In implicit VR an undefined length means a sequence, walked through items of undefined and defined length
    to (FFFE,E0DD), for a tag the dictionary knows and for a private one; the image follows it."""
    inner = implicit(0x0020000E, pad(b"1.2.840.1", b"\0"))
    items = (implicit(0xFFFEE000, inner, 0xFFFFFFFF) + implicit(0xFFFEE00D, b"")
             + implicit(0xFFFEE000, inner))
    nested = implicit(0x00091002, b"", 0xFFFFFFFF) + implicit(0xFFFEE000, b"", 0xFFFFFFFF) + \
        implicit(0x00100020, pad(b"in nested")) + implicit(0xFFFEE00D, b"") + implicit(0xFFFEE0DD, b"")
    pixels = np.array([[1, 2], [300, 65535]], np.uint16)
    dataset = (implicit(0x00081115, b"", 0xFFFFFFFF) + items + implicit(0xFFFEE0DD, b"")
               + implicit(0x00091001, b"", 0xFFFFFFFF) + implicit(0xFFFEE000, nested) + implicit(0xFFFEE0DD, b"")
               + implicit(0x00200013, pad(b"12")) + image_elements(2, 2, 16, write=implicit)
               + implicit(0x7FE00010, pixels.astype("<u2").tobytes()))
    ds = read(tmp_path, part10(IMPLICIT, dataset))
    assert [item.SeriesInstanceUID for item in ds.ReferencedSeriesSequence] == ["1.2.840.1", "1.2.840.1"]
    private = ds._value(0x00091001)
    assert private[0]._value(0x00091002)[0].PatientID == "in nested"
    assert ds.InstanceNumber == 12 and ds.pixel_array.dtype == np.uint16
    np.testing.assert_array_equal(ds.pixel_array, pixels)


def test_deflated_explicit_little_endian(tmp_path):
    pixels = np.array([[5, -5], [7, -7]], np.int16)
    dataset = image_elements(2, 2, 16, signed=True) + explicit(0x7FE00010, "OW", pixels.tobytes())
    deflate = zlib.compressobj(9, zlib.DEFLATED, -15)
    ds = read(tmp_path, part10(DEFLATED, deflate.compress(dataset) + deflate.flush()))
    np.testing.assert_array_equal(ds.pixel_array, pixels)


def test_explicit_big_endian(tmp_path):
    pixels = np.array([[0x0102, 0xFF00, 7]], np.uint16)
    dataset = (explicit(0x00200013, "IS", pad(b"3"), ">") + image_elements(1, 3, 16, order=">")
               + explicit(0x7FE00010, "OW", pixels.astype(">u2").tobytes(), ">"))
    ds = read(tmp_path, part10(BIG, dataset))
    assert (ds.Rows, ds.Columns, ds.InstanceNumber) == (1, 3, 3)
    assert ds.pixel_array.dtype == np.uint16 and ds.pixel_array.dtype.isnative
    np.testing.assert_array_equal(ds.pixel_array, pixels)


def encapsulated(fragments, table=b""):
    items = struct.pack("<HHI", 0xFFFE, 0xE000, len(table)) + table
    items += b"".join(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f for f in fragments)
    return (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\0\0" + struct.pack("<I", 0xFFFFFFFF) + items
            + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))


def rle_fragment(segments):
    """The 64-byte header (segment count, then offsets from the fragment's start) and the segments."""
    offsets, position = [], 64
    for seg in segments:
        offsets.append(position)
        position += len(seg)
    frag = struct.pack("<16I", len(segments), *offsets, *[0] * (15 - len(segments))) + b"".join(segments)
    return pad(frag, b"\0")


def test_rle_lossless_16bit(tmp_path):
    """Values 0x0102 0x0102 0x0102 / 0x0304 0x0305 0x0306: the high bytes 01 01 01 03 03 03 as two replicate runs
    (header 257 - 3 = 0xFE), the low bytes 02 02 02 04 05 06 as a replicate run and a literal run (header 3 - 1),
    with a no-op header 0x80 between them."""
    high = bytes([0xFE, 0x01, 0xFE, 0x03])
    low = bytes([0xFE, 0x02, 0x80, 0x02, 0x04, 0x05, 0x06])
    dataset = image_elements(2, 3, 16) + encapsulated([rle_fragment([high, low])])
    ds = read(tmp_path, part10(RLE, dataset))
    np.testing.assert_array_equal(ds.pixel_array, np.array([[0x0102] * 3, [0x0304, 0x0305, 0x0306]], np.uint16))


def test_rle_lossless_rgb_frames_and_offset_table(tmp_path):
    """8-bit RGB, two frames, one fragment each, found through the basic offset table: RLE is planar (one segment a
    sample), and ``pixel_array`` is samples-last, whatever the planar configuration says."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 2, 3, 3), dtype=np.uint8)  # (frames, rows, cols, samples)

    def literal(plane):
        data = plane.ravel().tobytes()
        return bytes([len(data) - 1]) + data

    fragments = [rle_fragment([literal(f[..., s]) for s in range(3)]) for f in frames]
    table = struct.pack("<2I", 0, 8 + len(fragments[0]))
    dataset = image_elements(2, 3, 8, samples=3, frames=2, planar=0) + encapsulated(fragments, table)
    ds = read(tmp_path, part10(RLE, dataset))
    assert ds.pixel_array.shape == (2, 2, 3, 3)
    np.testing.assert_array_equal(ds.pixel_array, frames)


def test_planar_configuration_one_is_moved_to_samples_last(tmp_path):
    rgb = np.arange(2 * 2 * 3, dtype=np.uint8).reshape(2, 2, 3) * 10
    planes = np.ascontiguousarray(rgb.transpose(2, 0, 1)).tobytes()  # R plane, G plane, B plane
    dataset = image_elements(2, 2, 8, samples=3, planar=1) + explicit(0x7FE00010, "OB", planes)
    ds = read(tmp_path, part10(EXPLICIT, dataset))
    np.testing.assert_array_equal(ds.pixel_array, rgb)
    dataset = image_elements(2, 2, 8, samples=3, planar=0) + explicit(0x7FE00010, "OB", rgb.tobytes())
    np.testing.assert_array_equal(read(tmp_path, part10(EXPLICIT, dataset)).pixel_array, rgb)


def test_multi_frame_signed(tmp_path):
    frames = np.arange(-6, 6, dtype=np.int16).reshape(3, 2, 2)
    dataset = image_elements(2, 2, 16, signed=True, frames=3) + explicit(0x7FE00010, "OW", frames.tobytes())
    ds = read(tmp_path, part10(EXPLICIT, dataset))
    assert ds.NumberOfFrames == 3 and ds.pixel_array.shape == (3, 2, 2)
    np.testing.assert_array_equal(ds.pixel_array, frames)


def test_one_bit_pixels_unpack_least_significant_first(tmp_path):
    """3x5 pixels of 1 bit: the 15 bits fill two bytes, the first pixel in bit 0 of the first byte."""
    bits = np.array([[1, 0, 0, 0, 1], [1, 0, 1, 1, 0], [1, 0, 1, 0, 1]], np.uint8)
    packed = bytes([0b10110001, 0b01010101])  # bits 0-7 then 8-14 of the raster order
    dataset = image_elements(3, 5, 1) + explicit(0x7FE00010, "OB", packed)
    ds = read(tmp_path, part10(EXPLICIT, dataset))
    assert ds.pixel_array.dtype == np.uint8
    np.testing.assert_array_equal(ds.pixel_array, bits)


@pytest.mark.parametrize("signed", [False, True])
def test_bits_stored_below_bits_allocated_keeps_the_stored_words(tmp_path, signed):
    """BitsStored 12 of 16: the words come back as stored, their top 4 bits neither masked nor sign-extended
    (0xF123 stays 0xF123; a 12-bit -1, 0x0FFF, stays 4095). Well-formed CT files sign-extend, so either rule
    gives the same values there."""
    words = np.array([[0xF123, 0x0FFF, 0x0800, 0x7FF]], np.uint16)
    dataset = image_elements(1, 4, 16, signed=signed, stored=12) + explicit(0x7FE00010, "OW", words.tobytes())
    ds = read(tmp_path, part10(EXPLICIT, dataset))
    assert ds.BitsStored == 12 and ds.HighBit == 11
    np.testing.assert_array_equal(ds.pixel_array, words.view(np.int16) if signed else words)


@pytest.mark.parametrize("uid", ["1.2.840.10008.1.2.4.50", "1.2.840.10008.1.2.4.70", "1.2.840.10008.1.2.4.90",
                                 "1.2.840.10008.1.2.4.201"])
def test_jpeg_family_raises_naming_the_uid_and_file(tmp_path, uid):
    dataset = image_elements(1, 1, 8) + encapsulated([b"\xff\xd8\xff\xd9"])
    with pytest.raises(NotImplementedError, match=uid.replace(".", r"\.")) as info:
        read(tmp_path, part10(uid, dataset), name="slice_7.dcm")
    assert "slice_7.dcm" in str(info.value)


def test_missing_dicm_raises_naming_the_file(tmp_path):
    dataset = image_elements(1, 1, 8) + explicit(0x7FE00010, "OB", b"\0\0")
    with pytest.raises(dicom.InvalidDicomError, match="no_prefix.dcm"):
        read(tmp_path, b"\0" * 128 + b"DICX" + dataset, name="no_prefix.dcm")
    with pytest.raises(dicom.InvalidDicomError, match="short.dcm"):
        read(tmp_path, b"DICM", name="short.dcm")


@pytest.mark.parametrize("syntax", [IMPLICIT, EXPLICIT, DEFLATED, BIG, RLE])
@pytest.mark.parametrize("case", ["int16", "uint8 frames", "uint16 rgb", "int32 rgb frames"])
def test_dcmwrite_round_trips(tmp_path, syntax, case):
    rng = np.random.default_rng(1)
    array, kwargs = {
        "int16": (rng.integers(-1100, 1100, (64, 48)).astype(np.int16), {}),
        "uint8 frames": (rng.integers(0, 4, (3, 16, 20)).astype(np.uint8) * 60, {}),
        "uint16 rgb": (rng.integers(0, 2 ** 16, (6, 5, 3)).astype(np.uint16), {"SamplesPerPixel": 3}),
        "int32 rgb frames": (rng.integers(-2 ** 31, 2 ** 31, (2, 4, 5, 3)).astype(np.int32), {"SamplesPerPixel": 3}),
    }[case]
    path = tmp_path / "w.dcm"
    layouts.dcmwrite(str(path), array, syntax, InstanceNumber=4, ImagePositionPatient=[0.0, -1.5, 2.25], **kwargs)
    data = path.read_bytes()
    assert data[128:132] == b"DICM" and syntax.encode() in data[132:400]
    ds = dicom.dcmread(str(path))
    assert ds.file_meta.TransferSyntaxUID == syntax and ds.InstanceNumber == 4
    assert ds.ImagePositionPatient == [0.0, -1.5, 2.25]
    assert ds.pixel_array.dtype == array.dtype
    np.testing.assert_array_equal(ds.pixel_array, array)


def test_packbits_encoder_runs(tmp_path):
    """The writer's PackBits: long runs split at 128, a run of 2 stays literal, a replicate piece of 1 byte
    becomes literal; decoded back exactly."""
    data = np.concatenate([np.full(300, 7), [1, 2, 2, 3], np.full(129, 9), np.arange(200) % 256]).astype(np.uint8)
    encoded = layouts.packbits_encode(data)
    assert bytes(dicom._packbits_decode(memoryview(encoded))) == data.tobytes()
    assert encoded[:2] == bytes([257 - 128, 7])
