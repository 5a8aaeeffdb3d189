"""Tiled inference: padding-based and halo-based block-wise prediction.

Counterpart of ``torch_em_tpu/utils/prediction.py``. Blocks are loaded on
the host with their halo (reflect-padded at the volume border), copied to
the model's device, predicted, cropped to the inner block on the device and
copied back into a host output array. The blocking math is plain numpy.
"""

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..transforms.raw import standardize

__all__ = ["Blocking", "predict_with_padding", "predict_with_halo"]


class Blocking:
    """Grid decomposition of a volume into blocks (replaces nifty.tools.blocking)."""

    def __init__(self, start: Sequence[int], stop: Sequence[int], block_shape: Sequence[int]):
        self.start = tuple(int(s) for s in start)
        self.stop = tuple(int(s) for s in stop)
        self.block_shape = tuple(int(b) for b in block_shape)
        self.blocks_per_axis = tuple(
            int(np.ceil((sp - st) / bs)) for st, sp, bs in zip(self.start, self.stop, self.block_shape)
        )
        self.n_blocks = int(np.prod(self.blocks_per_axis))

    def get_block(self, block_id: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(begin, end) of a block; blocks at the upper border are clipped to ``stop``."""
        coords = np.unravel_index(block_id, self.blocks_per_axis)
        begin = tuple(st + int(c) * bs for st, c, bs in zip(self.start, coords, self.block_shape))
        end = tuple(min(b + bs, sp) for b, bs, sp in zip(begin, self.block_shape, self.stop))
        return begin, end


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def predict_with_padding(
    model,
    input_: np.ndarray,
    min_divisible: Tuple[int, ...],
    with_channels: bool = False,
) -> np.ndarray:
    """Reflect-pad the input to divisibility, run one forward on the model's device, crop back."""
    if with_channels:
        if len(min_divisible) + 1 != input_.ndim:
            raise ValueError(f"{min_divisible} does not match an input with channels of rank {input_.ndim}")
        min_divisible_ = (1,) + tuple(min_divisible)
    else:
        if len(min_divisible) != input_.ndim:
            raise ValueError(f"{min_divisible} does not match an input of rank {input_.ndim}")
        min_divisible_ = tuple(min_divisible)

    crop_padding = None
    if any(sh % md != 0 for sh, md in zip(input_.shape, min_divisible_)):
        pad_width = tuple(
            (0, 0 if sh % md == 0 else md - sh % md) for sh, md in zip(input_.shape, min_divisible_)
        )
        crop_padding = tuple(slice(0, sh) for sh in input_.shape)
        input_ = np.pad(input_, pad_width, mode="reflect")

    model_input = input_[None] if with_channels else input_[None, None]
    x = torch.from_numpy(np.ascontiguousarray(model_input, dtype=np.float32)).to(_model_device(model))
    with torch.inference_mode():
        output = model(x).cpu().numpy()

    if crop_padding is not None:
        crop_padding = (slice(None),) * (output.ndim - len(crop_padding)) + crop_padding
        output = output[crop_padding]
    return output


def _load_block(input_, offset, block_shape, halo, padding_mode="reflect", with_channels=False):
    """Read a block with its halo, padding where it reaches past the volume border."""
    shape = input_.shape
    if with_channels:
        shape = shape[1:]

    starts = [off - ha for off, ha in zip(offset, halo)]
    stops = [off + bs + ha for off, bs, ha in zip(offset, block_shape, halo)]

    pad_left = None
    pad_right = None
    if any(start < 0 for start in starts):
        pad_left = tuple(abs(start) if start < 0 else 0 for start in starts)
        starts = [max(0, start) for start in starts]
    if any(stop > shape[i] for i, stop in enumerate(stops)):
        pad_right = tuple(stop - shape[i] if stop > shape[i] else 0 for i, stop in enumerate(stops))
        stops = [min(shape[i], stop) for i, stop in enumerate(stops)]

    bb = tuple(slice(start, stop) for start, stop in zip(starts, stops))
    data = np.asarray(input_[(slice(None),) + bb] if with_channels else input_[bb])

    ndim = len(shape)
    if pad_left is not None or pad_right is not None:
        pad_left = (0,) * ndim if pad_left is None else pad_left
        pad_right = (0,) * ndim if pad_right is None else pad_right
        pad_width = tuple((pl, pr) for pl, pr in zip(pad_left, pad_right))
        if with_channels:
            pad_width = ((0, 0),) + pad_width
        data = np.pad(data, pad_width, mode=padding_mode)
        bb = tuple(slice(b.start - pl, b.stop + pr) for b, pl, pr in zip(bb, pad_left, pad_right))
    return data, bb


def _check_gpu_ids(gpu_ids, model_device: torch.device):
    """``gpu_ids`` must name one device ("cpu", an index, or "cuda:<i>"), the model's:
    the port runs the model where its parameters lie."""
    if len(gpu_ids) != 1:
        raise NotImplementedError("predict_with_halo on several devices is not ported yet; "
                                  "pass one entry in gpu_ids or None")
    gpu = gpu_ids[0]
    if gpu == "cpu":
        device = torch.device("cpu")
    elif isinstance(gpu, int) or (isinstance(gpu, str) and gpu.isdigit()):
        device = torch.device("cuda", int(gpu))
    else:
        device = torch.device(gpu)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    if device != model_device:
        raise ValueError(f"gpu_ids names {device}, but the model lies on {model_device}; "
                         f"move the model there first")


# options of the reference's predict_with_halo that the port does not take yet
_NOT_PORTED = ("output", "postprocess", "skip_block", "mask", "prediction_function", "roi",
               "iter_list", "grid_shift", "devices", "n_threads")


def predict_with_halo(
    input_: np.ndarray,
    model,
    gpu_ids: Optional[Sequence] = None,
    block_shape: Optional[Tuple[int, ...]] = None,
    halo: Optional[Tuple[int, ...]] = None,
    output=None,
    preprocess: Optional[Callable] = standardize,
    postprocess: Optional[Callable] = None,
    with_channels: bool = False,
    skip_block: Optional[Callable] = None,
    mask=None,
    disable_tqdm: bool = False,
    tqdm_desc: str = "predict with halo",
    prediction_function: Optional[Callable] = None,
    roi=None,
    iter_list=None,
    grid_shift=None,
    batch_size: int = 1,
    devices=None,
    n_threads: Optional[int] = None,
    output_dtype=None,
) -> np.ndarray:
    """Block-wise prediction with a halo around each block.

    The reference's signature and argument order. ``input_`` is (*spatial)
    or, ``with_channels``, (C, *spatial). Each block of ``block_shape`` is
    loaded with ``halo`` voxels on every side, run through ``preprocess`` on
    the host and through ``model`` on its device in batches of
    ``batch_size``; the halo is cropped on the device, and the inner block is
    cast to ``output_dtype`` (a numpy dtype, e.g. "float16") there before it
    is copied back. Returns a float32 (C_out, *spatial) array.

    ``gpu_ids`` may name the model's one device (None: wherever the model
    lies). The port shows no progress bar, so ``disable_tqdm`` and
    ``tqdm_desc`` change nothing. ``output``, ``postprocess``,
    ``skip_block``, ``mask``, ``prediction_function``, ``roi``,
    ``iter_list``, ``grid_shift``, ``devices`` and ``n_threads`` are not
    ported yet and raise ``NotImplementedError`` when given.
    """
    given = locals()
    for name in _NOT_PORTED:
        if given[name] is not None:
            raise NotImplementedError(f"predict_with_halo's {name!r} is not ported yet")
    if block_shape is None or halo is None:
        raise ValueError("predict_with_halo needs block_shape and halo")
    device = _model_device(model)
    if gpu_ids is not None:
        _check_gpu_ids(gpu_ids, device)
    spatial = tuple(input_.shape[1:] if with_channels else input_.shape)
    ndim = len(spatial)
    block_shape, halo = tuple(block_shape), tuple(halo)
    if not len(block_shape) == len(halo) == ndim:
        raise ValueError(f"block_shape {block_shape} and halo {halo} need {ndim} entries")
    out_dtype = None if output_dtype is None else getattr(torch, np.dtype(output_dtype).name)
    blocking = Blocking([0] * ndim, spatial, block_shape)
    output = np.zeros((model.out_channels or 1,) + spatial, dtype="float32")
    inner = (slice(None), slice(None)) + tuple(slice(h, h + b) for h, b in zip(halo, block_shape))
    batch_size = max(1, int(batch_size))

    for first in range(0, blocking.n_blocks, batch_size):
        ids = range(first, min(first + batch_size, blocking.n_blocks))
        blocks = [blocking.get_block(i) for i in ids]
        inputs = []
        for begin, _ in blocks:
            inp, _ = _load_block(input_, begin, block_shape, halo, with_channels=with_channels)
            if preprocess is not None:
                inp = preprocess(inp)
            inputs.append(inp if with_channels else inp[None])
        x = torch.from_numpy(np.ascontiguousarray(np.stack(inputs), dtype=np.float32)).to(device)
        with torch.inference_mode():
            pred = model(x)[inner]
        if out_dtype is not None:
            pred = pred.to(out_dtype)
        pred = pred.cpu().numpy()
        for (begin, end), p in zip(blocks, pred):
            actual = tuple(slice(0, e - b) for b, e in zip(begin, end))
            bb = tuple(slice(b, e) for b, e in zip(begin, end))
            output[(slice(None),) + bb] = p[(slice(None),) + actual]
    return output
