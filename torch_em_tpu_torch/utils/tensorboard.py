"""TensorBoard event files, written and read with neither tensorboardX nor tensorboard.

The port's loggers write through ``SummaryWriter``; ``read_events`` reads the files back, on a
machine that has no tensorboard (the one with the card). The format:

- A file ``<log_dir>/events.out.tfevents.<10-digit time>.<hostname>`` is a sequence of TFRecord
  records: the data's length as a little-endian uint64, the masked CRC-32C of those 8 bytes, the
  data, then the masked CRC-32C of the data. The mask is ``((crc >> 15) | (crc << 17)) +
  0xa282ead8`` mod 2^32; the CRC is the native ``ops/native/crc32c.py``.
- Each record is a protocol buffer ``Event {double wall_time = 1; int64 step = 2; string
  file_version = 3; Summary summary = 5}``, with ``Summary {repeated Value value = 1}``,
  ``Value {string tag = 1; float simple_value = 2; Image image = 4}`` and ``Image {int32 height
  = 1; int32 width = 2; int32 colorspace = 3; bytes encoded_image_string = 4}``, encoded here
  by hand as proto3 does (fields in order, zeros left out but in a ``oneof``). The first
  record carries ``file_version = "brain.Event:2"``.
- An image is stored as tensorboardX stores it: CHW becomes HWC, one channel is repeated to
  three, a non-``uint8`` image is written as ``(x * 255).astype(uint8)``, then PNG-encoded with
  PIL, so the bytes equal tensorboardX's for the same call.

The writer has no thread of its own: ``add_scalar`` and ``add_image`` append records to the
file's buffer from the caller, ``flush`` writes the buffer out (the trainer flushes after each
batch of buffered logger calls, each validation and the end of ``fit``). The file is opened for
appending, so a second writer of the same directory within the same second adds to the file
and loses nothing.
"""

import os
import re
import socket
import struct
import time
from typing import Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np

from ..ops.native import crc32c as _crc32c

__all__ = ["SummaryWriter", "Image", "read_events", "encode_png", "masked_crc32c"]

FILE_VERSION = "brain.Event:2"
_MASK_DELTA = 0xA282EAD8
_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


class Image(NamedTuple):
    """An image value of an event: its PNG and the shape it was logged with."""

    height: int
    width: int
    colorspace: int
    encoded_image_string: bytes


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC-32C of ``data``."""
    crc = _crc32c.crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ------------------------------------------------------------------ protocol buffers
def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # negative int32 and int64 take ten bytes, as two's complement
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _length_delimited(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value) if value else b""


def _event(wall_time: float, step: Optional[int], payload: bytes) -> bytes:
    """An Event with ``payload``, its file_version or summary field, already encoded."""
    head = _key(1, 1) + struct.pack("<d", wall_time) if wall_time else b""
    return head + (_int_field(2, int(step)) if step is not None else b"") + payload


def _summary_value(tag: str, value: bytes) -> bytes:
    """An Event's summary field holding one Value: ``tag`` and ``value``, the Value's encoded oneof field.
    The tag is cleaned as tensorboardX cleans it: characters outside ``[-/\\w.]`` become ``_``, leading
    slashes go."""
    tag = _INVALID_TAG_CHARACTERS.sub("_", tag).lstrip("/")
    tagged = (_length_delimited(1, tag.encode()) if tag else b"") + value
    return _length_delimited(5, _length_delimited(1, tagged))


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, Union[int, bytes]]]:
    """(field, value) of each field of an encoded message: an int for a varint, bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, pos = buf[pos: pos + size], pos + size
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            value, pos = buf[pos: pos + size], pos + size
        else:
            raise ValueError(f"wire type {wire} of field {field} is not one of protobuf's 0, 1, 2 and 5")
        if pos > len(buf):
            raise ValueError(f"field {field} runs past the end of its message")
        yield field, value


def _signed(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _image(buf: bytes) -> Image:
    values = {1: 0, 2: 0, 3: 0, 4: b""}
    for field, value in _fields(buf):
        if field in values:
            values[field] = value
    return Image(_signed(values[1]), _signed(values[2]), _signed(values[3]), bytes(values[4]))


# ------------------------------------------------------------------ images
def _hwc(image: np.ndarray, dataformats: str) -> np.ndarray:
    """tensorboardX's ``convert_to_HWC`` for an image of 2 or 3 axes."""
    dataformats = dataformats.upper()
    if len(set(dataformats)) != len(dataformats) or len(dataformats) != image.ndim or image.ndim not in (2, 3):
        raise ValueError(f"an image of shape {image.shape} does not fit the data format {dataformats!r} "
                         "(HW, or CHW in any order)")
    if image.ndim == 2:
        image = image.transpose([dataformats.find(c) for c in "HW"])
        return np.stack([image, image, image], 2)
    image = image.transpose([dataformats.find(c) for c in "HWC"])
    return np.concatenate([image] * 3, 2) if image.shape[2] == 1 else image


def encode_png(image: np.ndarray) -> bytes:
    """The PNG of an (H, W, C) ``uint8`` image, with PIL, as tensorboardX encodes it."""
    import io

    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError("Writing an image to a TensorBoard event file needs PIL (Pillow), which is not "
                          "installed") from e
    output = io.BytesIO()
    PILImage.fromarray(image).save(output, format="PNG")
    return output.getvalue()


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------------------ writer and reader
class SummaryWriter:
    """Writes scalars and images to a TensorBoard event file in ``log_dir``; the calls of
    tensorboardX's ``SummaryWriter`` that the port's loggers make."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"events.out.tfevents.{str(time.time())[:10]}.{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._write(_event(time.time(), None, _length_delimited(3, FILE_VERSION.encode())))
        self.flush()

    def _write(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._file.write(b"".join((header, struct.pack("<I", masked_crc32c(header)), data,
                                   struct.pack("<I", masked_crc32c(data)))))

    def add_scalar(self, tag: str, scalar_value, global_step: Optional[int] = None,
                   walltime: Optional[float] = None):
        """A float32 scalar ``scalar_value`` (a number, a numpy or torch scalar) under ``tag``."""
        with np.errstate(over="ignore"):  # beyond float32's range is +-inf, as protobuf stores it
            value = np.array(float(_to_numpy(scalar_value).squeeze()), dtype="<f4").tobytes()
        self._write(_event(time.time() if walltime is None else walltime, global_step,
                           _summary_value(tag, _key(2, 5) + value)))

    def add_image(self, tag: str, img_tensor, global_step: Optional[int] = None, walltime: Optional[float] = None,
                  dataformats: str = "CHW"):
        """An image under ``tag``: ``uint8`` as it is, any other dtype as values in [0, 1]."""
        image = _hwc(_to_numpy(img_tensor), dataformats)
        if image.dtype != np.uint8:
            image = (image * 255.0).astype(np.uint8)
        height, width, channels = image.shape
        encoded = (_int_field(1, height) + _int_field(2, width) + _int_field(3, channels)
                   + _length_delimited(4, encode_png(image)))
        self._write(_event(time.time() if walltime is None else walltime, global_step,
                           _summary_value(tag, _length_delimited(4, encoded))))

    def flush(self):
        """Write the buffered records to the file."""
        self._file.flush()

    def close(self):
        """Flush and close the file."""
        if not self._file.closed:
            self._file.flush()
            self._file.close()


def _records(path: str) -> Iterator[bytes]:
    """The data of each TFRecord record of the file ``path``, both CRCs checked."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: the record at byte {pos} is cut short in its header")
        header = data[pos: pos + 8]
        (length,), (crc,) = struct.unpack("<Q", header), struct.unpack("<I", data[pos + 8: pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: the length of the record at byte {pos} fails its CRC")
        end = pos + 12 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: the record at byte {pos} is cut short")
        body = data[pos + 12: end]
        if struct.unpack("<I", data[end: end + 4])[0] != masked_crc32c(body):
            raise ValueError(f"{path}: the data of the record at byte {pos} fails its CRC")
        yield body
        pos = end + 4


def _event_files(path: str):
    """The event files of a log folder, in name order, or ``[path]`` for a file."""
    if not os.path.isdir(path):
        return [path]
    return [os.path.join(path, name) for name in sorted(os.listdir(path)) if "tfevents" in name]


def _event_values(record: bytes, file: str):
    """``(wall_time, step, tag, value)`` of each summary value of one Event record."""
    wall_time, step, summary = 0.0, 0, None
    for field, value in _fields(record):
        if field == 1:
            wall_time = struct.unpack("<d", value)[0]
        elif field == 2:
            step = _signed(value)
        elif field == 5:
            summary = value
    values = []
    for field, value_message in _fields(summary or b""):
        if field != 1:
            continue
        tag, entry = "", None
        for vfield, value in _fields(value_message):
            if vfield == 1:
                tag = bytes(value).decode()
            elif vfield == 2:
                entry = float(np.frombuffer(value, dtype="<f4")[0])
            elif vfield == 4:
                entry = _image(value)
            elif vfield in (3, 5, 6, 8):
                kind = {3: "an old-style histogram", 5: "a histogram", 6: "audio", 8: "a tensor"}[vfield]
                raise NotImplementedError(f"{file}: {tag or 'a value'} holds {kind}, which is not read")
        if entry is None:
            raise ValueError(f"{file}: the value {tag!r} at step {step} holds neither a scalar nor an image")
        values.append((wall_time, step, tag, entry))
    return values


def read_events(path: str) -> Iterator[Tuple[float, int, str, Union[float, Image]]]:
    """``(wall_time, step, tag, value)`` of every summary value in the event file ``path``, or in
    every event file of the folder ``path`` in name order; ``value`` is a float for a scalar, an
    ``Image`` for an image. Raises ``ValueError`` on a record that fails its CRCs or does not
    parse, ``NotImplementedError`` on a value of another kind (histogram, audio, tensor)."""
    for file in _event_files(path):
        for record in _records(file):
            try:
                values = _event_values(record, file)
            except (struct.error, TypeError, UnicodeDecodeError) as e:  # a field of another wire type or size
                raise ValueError(f"{file}: a record does not parse as an Event: {e}") from e
            yield from values
