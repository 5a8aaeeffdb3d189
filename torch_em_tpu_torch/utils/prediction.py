"""Tiled inference: padding-based and halo-based block-wise prediction.

Counterpart of ``torch_em_tpu/utils/prediction.py``, with its options
(``output``, ``postprocess``, ``mask``, ``skip_block``, ``roi``,
``iter_list``, ``grid_shift``, ``prediction_function``) and its two paths:

- the host path: a thread pool loads blocks with their halo (numpy only,
  reflect-padded at the volume border) a bounded lookahead ahead of the
  device; the calling thread stacks them into batches in a ring of pinned
  staging buffers, copies them to the model's device without blocking, runs
  the forward (with the default ``standardize`` computed there), crops the
  halo and casts there, and drains the results two deep through CUDA events
  into pinned output buffers while the next batch is loaded and sent;
- the device-resident path, for an input tensor already on the model's
  device: the volume is reflect-padded once on the device, blocks are sliced
  from it and the prediction is written into a tensor there, with no
  per-block traffic to the host.

With several devices (``gpu_ids`` or ``devices`` naming more than one) the
host path keeps one replica of the model per device and sends the batches
to them in turn, each replica with its own stream and staging buffers, as
the JAX package dispatches round-robin over its devices. Device indices
wrap around the cards present, so on one card ``gpu_ids=[0, 1]`` gives two
replicas there, on two streams.

The blocking math is plain numpy.
"""

import contextlib
import copy
import itertools
from collections import deque
from concurrent import futures
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.base import resolve_device
from ..transforms.raw import standardize

__all__ = ["Blocking", "predict_with_padding", "predict_with_halo"]

# results in flight between the device and the host writes, as in the JAX package
MAX_INFLIGHT = 2


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

    @property
    def numberOfBlocks(self) -> int:  # nifty's name
        return self.n_blocks

    def get_block(self, block_id: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(begin, end) of a block; blocks at the upper border are clipped to ``stop``."""
        coords = np.unravel_index(block_id, self.blocks_per_axis)
        begin = tuple(st + int(c) * bs for st, c, bs in zip(self.start, coords, self.block_shape))
        end = tuple(min(b + bs, sp) for b, bs, sp in zip(begin, self.block_shape, self.stop))
        return begin, end

    def getBlock(self, block_id: int) -> "_Block":  # nifty's name
        begin, end = self.get_block(block_id)
        return _Block(list(begin), list(end), [e - b for b, e in zip(begin, end)])


class _Block:
    """A block as nifty describes it: ``begin``, ``end`` and ``shape`` lists."""

    def __init__(self, begin, end, shape):
        self.begin, self.end, self.shape = begin, end, shape


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _as_device(gpu) -> torch.device:
    """A device named as the reference names one: "cpu", an index (modulo the cards
    present, as the JAX package maps it), "cuda:<i>" or a torch.device."""
    if isinstance(gpu, int) or (isinstance(gpu, str) and gpu.isdigit()):
        return torch.device("cuda", int(gpu) % max(torch.cuda.device_count(), 1))
    device = torch.device(gpu)
    return torch.device("cuda", 0) if device.type == "cuda" and device.index is None else device


def _check_gpu_ids(gpu_ids, model_device: torch.device):
    """The devices that ``gpu_ids`` names. One name must name the model's device: the port
    runs the model where its parameters lie; several get a replica each."""
    devices = [_as_device(g) for g in gpu_ids]
    if len(devices) == 1 and devices[0] != model_device:
        raise ValueError(f"{gpu_ids[0]!r} names {devices[0]}, but the model lies on {model_device}; "
                         f"move the model there first")
    for device in devices:
        resolve_device(device)
    return devices


def _replicas(model, devices):
    """One model per entry of ``devices``: the model itself for the first entry naming its
    device, a copy for each other."""
    replicas, own = [], _model_device(model)
    for device in devices:
        if device == own and not any(r is model for r in replicas):
            replicas.append(model)
        else:
            replicas.append(copy.deepcopy(model).to(device))
    return replicas


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _first(output):
    return output[0] if isinstance(output, (list, tuple)) else output


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def predict_with_padding(
    model,
    input_: np.ndarray,
    min_divisible: Tuple[int, ...],
    device=None,
    with_channels: bool = False,
    prediction_function: Optional[Callable] = None,
) -> np.ndarray:
    """Reflect-pad the input to divisibility, run one forward on the model's device, crop back.

    The reference's signature: ``device`` may name the model's device (None:
    wherever the model lies); ``prediction_function(model, x)`` runs in place of
    the model, with ``x`` on the model's device.
    """
    if with_channels:
        if len(min_divisible) + 1 != input_.ndim:
            raise ValueError(f"{min_divisible} does not match an input with channels of rank {input_.ndim}")
        min_divisible_ = (1,) + tuple(min_divisible)
    else:
        if len(min_divisible) != input_.ndim:
            raise ValueError(f"{min_divisible} does not match an input of rank {input_.ndim}")
        min_divisible_ = tuple(min_divisible)
    model_device = _model_device(model)
    if device is not None:
        _check_gpu_ids([device], model_device)

    crop_padding = None
    if any(sh % md != 0 for sh, md in zip(input_.shape, min_divisible_)):
        pad_width = tuple(
            (0, 0 if sh % md == 0 else md - sh % md) for sh, md in zip(input_.shape, min_divisible_)
        )
        crop_padding = tuple(slice(0, sh) for sh in input_.shape)
        input_ = np.pad(input_, pad_width, mode="reflect")

    model_input = input_[None] if with_channels else input_[None, None]
    x = torch.from_numpy(np.ascontiguousarray(model_input, dtype=np.float32)).to(model_device)
    with torch.inference_mode():
        output = model(x) if prediction_function is None else prediction_function(model, x)
        output = _to_numpy(_first(output).cpu())

    if crop_padding is not None:
        crop_padding = (slice(None),) * (output.ndim - len(crop_padding)) + crop_padding
        output = output[crop_padding]
    return output


def _load_block(input_, offset, block_shape, halo, padding_mode="reflect", with_channels=False):
    """Read a block with its halo, padding where it reaches past the volume border.
    A tensor input is read slice by slice through the host."""
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
    data = input_[(slice(None),) + bb] if with_channels else input_[bb]
    data = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)

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


def _standardize_batch(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """``standardize`` of each item of a batch, over all its axes, in float32 on x's device.
    The population std, as numpy's and jax's."""
    axes = tuple(range(1, x.ndim))
    x = x - x.mean(dim=axes, keepdim=True)
    return x / (x.std(dim=axes, keepdim=True, correction=0) + eps)


def _halo_forward(model, x, inner, out_dtype, device_standardize):
    """(Standardize,) run the model, crop the halo and cast, all on x's device."""
    if device_standardize:
        x = _standardize_batch(x)
    out = _first(model(x))
    out = out[(slice(None),) * (out.ndim - len(inner)) + inner]
    return out if out_dtype is None else out.to(out_dtype)


def _reflect_pad(vol: torch.Tensor, pads) -> torch.Tensor:
    """numpy's reflect padding of the spatial axes of (C, *spatial), at any pad width:
    a gather along each axis (``F.pad`` refuses pads as large as the axis)."""
    for axis, (left, right) in enumerate(pads, start=1):
        if left or right:
            idx = np.pad(np.arange(vol.shape[axis]), (left, right), mode="reflect")
            vol = vol.index_select(axis, torch.from_numpy(idx).to(vol.device))
    return vol


def _predict_on_device(input_, model, block_shape, halo, with_channels, device_standardize,
                       out_dtype, batch_size):
    """Tiled prediction of a volume on the model's device; returns a (C_out, *spatial) tensor there.

    The volume is reflect-padded once as a whole (the JAX package's ``jnp.pad``),
    which can differ from the host path's per-block padding within a receptive
    field of the border when a partial edge block is thinner than the pad."""
    spatial = tuple(input_.shape[1:] if with_channels else input_.shape)
    grid = tuple(-(-s // b) for s, b in zip(spatial, block_shape))
    vol = (input_ if with_channels else input_[None]).to(torch.float32)
    vol = _reflect_pad(vol, [(h, g * b - s + h) for h, g, b, s in zip(halo, grid, block_shape, spatial)])
    starts = list(itertools.product(*[range(0, g * b, b) for g, b in zip(grid, block_shape)]))
    inner = tuple(slice(h, h + b) for h, b in zip(halo, block_shape))
    out = torch.empty((model.out_channels or 1,) + spatial, dtype=out_dtype or torch.float32,
                      device=input_.device)
    with torch.inference_mode():
        for first in range(0, len(starts), batch_size):
            batch = starts[first:first + batch_size]
            x = torch.stack([vol[(slice(None),) + tuple(slice(st, st + b + 2 * h) for st, b, h
                                                         in zip(begin, block_shape, halo))]
                             for begin in batch])
            pred = _halo_forward(model, x, inner, out.dtype, device_standardize)
            for begin, p in zip(batch, pred):
                bb = tuple(slice(st, min(st + b, s)) for st, b, s in zip(begin, block_shape, spatial))
                out[(slice(None),) + bb] = p[(slice(None),) + tuple(slice(0, s.stop - s.start) for s in bb)]
    return out


def _load_ahead(load, ids, n_threads, lookahead):
    """``load(i)`` for each of ``ids``, in order, computed by ``n_threads`` threads that keep
    ``lookahead`` loads queued ahead of the consumer."""
    ids = iter(ids)
    pool = futures.ThreadPoolExecutor(n_threads)
    try:
        queue = deque(pool.submit(load, i) for i in itertools.islice(ids, lookahead))
        while queue:
            payload = queue.popleft().result()
            for i in itertools.islice(ids, 1):
                queue.append(pool.submit(load, i))
            yield payload
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


class _Transfers:
    """Host/device copies of the host path's batches.

    On a CUDA device each batch is stacked into one of ``MAX_INFLIGHT + 1``
    pinned staging buffers (reused once the event of the copy that read it has
    completed) and copied without blocking; each result is copied without
    blocking into a pinned output buffer, and its event tells when it can be
    read. On the CPU batches are stacked and results read directly."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slot = 0
        self.staging, self.results, self.copied = [], [], []

    def to_device(self, blocks) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(np.stack(blocks))
        if not self.staging:
            shape = (len(blocks),) + blocks[0].shape  # the first batch is a full one
            self.staging = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                            for _ in range(MAX_INFLIGHT + 1)]
            self.copied = [None] * len(self.staging)
        slot = self.slot
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        host = self.staging[slot][:len(blocks)]
        for dst, block in zip(host.numpy(), blocks):
            dst[...] = block
        x = host.to(self.device, non_blocking=True)
        self.copied[slot] = self._event()
        return x

    def _event(self):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def to_host(self, pred: torch.Tensor):
        """Start reading ``pred`` back; returns a handle for ``result``."""
        if not self.cuda:
            return None, pred
        if not self.results:
            self.results = [torch.empty(pred.shape, dtype=pred.dtype, pin_memory=True)
                            for _ in range(MAX_INFLIGHT + 1)]
        host = self.results[self.slot][:len(pred)]
        host.copy_(pred, non_blocking=True)
        self.slot = (self.slot + 1) % len(self.staging)
        return self._event(), host

    @staticmethod
    def result(handle) -> np.ndarray:
        done, host = handle
        if done is not None:
            done.synchronize()
        return _to_numpy(host)


def _progress_bar(total: int, disable: bool, desc: str):
    """A tqdm bar over ``total`` blocks, or None when disabled or where tqdm is not installed."""
    if disable:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total, desc=desc)


def predict_with_halo(
    input_,
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
):
    """Block-wise prediction with a halo around each block.

    The reference's signature and argument order. ``input_`` is (*spatial) or,
    ``with_channels``, (C, *spatial): a numpy array (or array-like), or a
    tensor. Each block of ``block_shape`` is loaded with ``halo`` voxels on
    every side and predicted on the model's device in batches of
    ``batch_size``; the halo is cropped and the block cast to ``output_dtype``
    (e.g. "float16") there. The default ``preprocess``, ``standardize``, runs
    on the device unless a ``prediction_function`` is given; another one runs
    on the host in the load threads (``n_threads``, default
    ``max(4, 2 * batch_size)``). Returns ``output``, by default a float32
    (C_out, *spatial) numpy array.

    A tensor on the model's device with no hooks (``output``, ``postprocess``,
    ``mask``, ``skip_block``, ``roi``, ``iter_list``, ``grid_shift``,
    ``prediction_function``, a ``preprocess`` other than ``standardize`` or
    None) takes the device-resident path and returns a (C_out, *spatial)
    tensor there in ``output_dtype`` (float32 when None). With hooks, a
    tensor is read slice by slice through the host.

    ``skip_block(block)`` sees each raw block with its halo and skips it when
    true; ``mask`` skips blocks whose inner part it does not touch and zeroes
    the prediction outside it. ``postprocess`` runs on each block's prediction
    after the halo crop, or, with a ``prediction_function(model, x)`` (run per
    block, unbatched, in place of the model), before it. ``roi`` limits the
    blocking to a region, ``iter_list`` to some block ids, and ``grid_shift``
    shifts the grid by fractions of a block.

    ``gpu_ids`` or ``devices`` may name the model's one device (None: wherever
    the model lies), or several devices, which take the blocks' batches in
    turn, each through its own replica of the model (the same device may be
    named more than once); then a tensor input takes the host path.

    The host path shows a tqdm progress bar over the blocks, labelled
    ``tqdm_desc``, unless ``disable_tqdm``; tqdm is imported only then, and
    where it is not installed the call runs without a bar. The
    device-resident path shows none.
    """
    if block_shape is None or halo is None:
        raise ValueError("predict_with_halo needs block_shape and halo")
    device = _model_device(model)
    names = devices if devices is not None else gpu_ids
    targets = [device] if names is None else _check_gpu_ids(names, device)
    shape0 = tuple(input_.shape)
    spatial0 = shape0[1:] if with_channels else shape0
    ndim = len(spatial0)
    block_shape, halo = tuple(block_shape), tuple(halo)
    if not len(block_shape) == len(halo) == ndim:
        raise ValueError(f"block_shape {block_shape} and halo {halo} need {ndim} entries")
    out_dtype = _torch_dtype(output_dtype)
    batch_size = max(1, int(batch_size))
    n_threads = max(4, 2 * batch_size) if n_threads is None else int(n_threads)

    if (isinstance(input_, torch.Tensor) and len(targets) == 1 and prediction_function is None and mask is None
            and skip_block is None and roi is None and grid_shift is None and output is None
            and iter_list is None and postprocess is None
            and (preprocess is standardize or preprocess is None)):
        if input_.device != device:
            raise ValueError(f"the input lies on {input_.device}, but the model on {device}; "
                             f"move the input there first")
        return _predict_on_device(input_, model, block_shape, halo, with_channels,
                                  preprocess is standardize, out_dtype, batch_size)

    pad_left = (0,) * ndim
    if grid_shift is not None:
        if len(grid_shift) != ndim:
            raise ValueError("grid_shift must match the number of spatial axes")
        if output is not None:
            raise ValueError("grid_shift is not supported together with a user-provided `output`. "
                             "Pass `output=None` or disable `grid_shift`.")
        if not isinstance(input_, np.ndarray) or (mask is not None and not isinstance(mask, np.ndarray)):
            raise TypeError("grid_shift needs input_ (and mask) to be numpy arrays")
        pad_left = tuple(int(np.rint(abs(gs) * bs)) for gs, bs in zip(grid_shift, block_shape))
        input_ = np.pad(input_, ((0, 0),) * (input_.ndim - ndim) + tuple((p, 0) for p in pad_left))
        if mask is not None:
            mask = np.pad(mask, tuple((p, 0) for p in pad_left))
    spatial = tuple(input_.shape[1:] if with_channels else input_.shape)

    if roi is None:
        blocking = Blocking([0] * ndim, spatial, block_shape)
    else:
        if len(roi) != ndim:
            raise ValueError(f"roi {roi} needs {ndim} entries")
        blocking = Blocking([0 if r.start is None else r.start for r in roi],
                            [sh if r.stop is None else r.stop for r, sh in zip(roi, spatial)], block_shape)
    if output is None:
        output = np.zeros((model.out_channels or 1,) + spatial, dtype="float32")
    ids = range(blocking.n_blocks) if iter_list is None else list(iter_list)
    device_standardize = preprocess is standardize and prediction_function is None

    def load(block_id):
        """The host side of one block, numpy only: None for a skipped block, else
        (begin, end, inner mask or None, block (C, *block + 2 halo) in float32)."""
        begin, end = blocking.get_block(block_id)
        mask_block = None
        if mask is not None:
            mask_block, _ = _load_block(mask, begin, block_shape, halo)
            mask_block = mask_block[tuple(slice(h, h + e - b) for h, b, e in zip(halo, begin, end))]
            mask_block = mask_block.astype(bool)
            if mask_block.sum() == 0:
                return None
        inp, _ = _load_block(input_, begin, block_shape, halo, with_channels=with_channels)
        if skip_block is not None and skip_block(inp):
            return None
        if preprocess is not None and not device_standardize:
            inp = preprocess(inp)
        if not with_channels:
            inp = inp[None]
        return begin, end, mask_block, np.ascontiguousarray(inp, dtype=np.float32)

    bar = _progress_bar(len(ids), disable_tqdm, tqdm_desc)

    def write(begin, end, mask_block, prediction):
        """Write one block's prediction, cropped to its inner part of the block's own size."""
        if bar is not None:
            bar.update(1)
        prediction = prediction[(slice(None),) * (prediction.ndim - ndim)
                                + tuple(slice(0, e - b) for b, e in zip(begin, end))]
        if mask_block is not None:
            prediction = np.where(np.broadcast_to(mask_block, prediction.shape), prediction, 0)
        bb = tuple(slice(b, e) for b, e in zip(begin, end))
        if isinstance(output, list):  # several outputs, each taking a slice of the channels
            for out, channel_slice in output:
                out[bb if out.ndim == ndim else (slice(None),) + bb] = prediction[channel_slice]
        else:
            output[(slice(None),) + bb if output.ndim == ndim + 1 else bb] = prediction

    inner = tuple(slice(h, h + b) for h, b in zip(halo, block_shape))
    replicas = _replicas(model, targets)
    n_workers = len(replicas)
    lookahead = max(2 * batch_size * n_workers, n_threads)
    def counted(payloads):
        """The payloads, the skipped blocks (None) counted on the bar."""
        for payload in payloads:
            if payload is None and bar is not None:
                bar.update(1)
            yield payload

    with contextlib.closing(_load_ahead(load, ids, n_threads, lookahead)) as loaded, torch.inference_mode(), \
            contextlib.ExitStack() as closing:
        payloads = counted(loaded)
        if bar is not None:
            closing.callback(bar.close)
        if prediction_function is not None:
            # one block at a time, the prediction_function on the calling thread, the replicas in turn
            for i, payload in enumerate(p for p in payloads if p is not None):
                begin, end, mask_block, inp = payload
                replica = replicas[i % n_workers]
                pred = _first(prediction_function(replica, torch.from_numpy(inp[None]).to(targets[i % n_workers])))
                pred = _to_numpy(pred.cpu()).squeeze(0)
                if postprocess is not None:
                    pred = postprocess(pred)
                write(begin, end, mask_block, pred[(slice(None),) * (pred.ndim - ndim) + inner])
        else:
            transfers = [_Transfers(d) for d in targets]
            # several replicas on the card each take their own stream, after the copies that made them
            streams = [None] * n_workers
            if n_workers > 1:
                for k, d in enumerate(targets):
                    if d.type == "cuda":
                        streams[k] = torch.cuda.Stream(d)
                        streams[k].wait_stream(torch.cuda.current_stream(d))
            pending, batch, dispatched = deque(), [], 0

            def drain():
                handle, metas = pending.popleft()
                for meta, pred in zip(metas, _Transfers.result(handle)):
                    write(*meta, pred if postprocess is None else postprocess(pred))

            end_of_blocks = object()
            for payload in itertools.chain(payloads, [end_of_blocks]):
                last = payload is end_of_blocks
                if not last and payload is not None:
                    batch.append(payload)
                if batch and (len(batch) == batch_size or last):
                    k = dispatched % n_workers
                    dispatched += 1
                    with torch.cuda.stream(streams[k]):
                        x = transfers[k].to_device([p[3] for p in batch])
                        pred = _halo_forward(replicas[k], x, inner, out_dtype, device_standardize)
                        pending.append((transfers[k].to_host(pred), [p[:3] for p in batch]))
                    batch = []
                while pending and (len(pending) > MAX_INFLIGHT * n_workers or last):
                    drain()

    if grid_shift is not None:
        output = output[(slice(None),) * (output.ndim - ndim)
                        + tuple(slice(p, p + s) for p, s in zip(pad_left, spatial0))]
    return output
