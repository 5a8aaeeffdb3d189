"""Spatially sharded inference and training with a halo exchange.

Counterpart of ``torch_em_tpu/parallel/halo.py``. A volume is split along its
first spatial axis among the processes of a mesh axis; each process trades
border slabs of ``halo`` planes with its neighbours, runs the network on its
slab and the halo around it, and crops the halo off. The processes at the
mesh border reflect their own data, as the tiled path pads at the volume
border. The JAX package's ``ppermute`` becomes ``dist.batch_isend_irecv``:
each process sends its first planes to the previous process and its last to
the next, and receives theirs. Under gloo, which moves CUDA tensors only
through ``all_reduce`` and ``broadcast``, a card's slabs go through pinned
host memory (the backend's rule, chosen by the caller's ``backend``).

``halo=None`` derives the halo from the model's receptive field
(``receptive_field_halo``), so that a norm-free model's sharded output
equals its unsharded forward away from the volume border. A spatial norm
(InstanceNorm, the U-Net's default) normalises each process's slab with its
halo, not the whole volume: the sharded prediction then equals
``predict_with_halo`` with slab-shaped blocks and the same halo, as in the
JAX package.

``spatial_sharded_train_step`` trains on such slabs. The exchange is a
``torch.autograd.Function`` whose backward sends the gradient of each
received halo back to the process it came from, which adds it to its border
planes. A loss with the shard protocol (the Dice losses) is formed from its
parts summed over the processes, so the step's loss is the loss of the whole
volume; another loss is the mean of the processes' losses.
"""

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..trainer.optimizers import OptimizerSpec
from .data_parallel import global_loss, has_shard_protocol
from .mesh import _axis_group, replicate

__all__ = ["halo_sharded_predict", "halo_sharded_predict_large", "receptive_field_halo", "total_downscale",
           "spatial_sharded_train_step"]


def _axis_scale_factors(model, spatial_axis: int) -> Sequence[int]:
    """Per-level downscale factors of ``spatial_axis`` from the model's ``init_kwargs``
    (AnisotropicUNet's per-axis lists; UNet2d's and UNet3d's 2 per level)."""
    kwargs = getattr(model, "init_kwargs", {}) or {}
    sf = kwargs.get("scale_factors")
    if sf is not None:
        return [int(level[spatial_axis]) if isinstance(level, (list, tuple)) else int(level) for level in sf]
    return [2] * int(kwargs.get("depth", 4))


def receptive_field_halo(model, spatial_axis: int = 0) -> int:
    """One-sided receptive field of the U-Net along ``spatial_axis``: two 3x3 convs per level
    on either path at its stride, one coarse pixel per upsampler, the base's two convs,
    rounded up to the total downscale."""
    stride, rf = 1, 0
    for f in _axis_scale_factors(model, spatial_axis):
        rf += 4 * stride
        stride *= max(int(f), 1)
        if int(f) > 1:
            rf += stride
    rf += 2 * stride
    return int(int(np.ceil(rf / stride)) * stride)


def total_downscale(model, spatial_axis: int = 0) -> int:
    """Product of the model's per-level downscale factors along an axis."""
    return int(np.prod([max(int(f), 1) for f in _axis_scale_factors(model, spatial_axis)]))


def _swap(to_prev: torch.Tensor, to_next: torch.Tensor, group):
    """Send ``to_prev`` to the previous process of ``group`` and ``to_next`` to the next;
    returns what they sent this way (None at the group's border)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    staged = to_prev.is_cuda and dist.get_backend(group) == "gloo"

    def buffer(t):
        if staged:
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)

    def outgoing(t):
        return buffer(t).copy_(t) if staged else t.contiguous()

    ops, received = [], [None, None]
    for side, j, send in ((0, i - 1, to_prev), (1, i + 1, to_next)):
        if 0 <= j < n:
            peer = dist.get_global_rank(group, j) if group is not None else j
            received[side] = buffer(send)
            ops += [dist.P2POp(dist.isend, outgoing(send), peer, group),
                    dist.P2POp(dist.irecv, received[side], peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        received = [None if r is None else r.to(to_prev.device, non_blocking=True) for r in received]
    return received


class HaloExchange(torch.autograd.Function):
    """(from_prev, from_next): the last ``halo`` planes along ``axis`` of the previous process
    of ``group`` and the first of the next, empty at the group's border. The backward sends
    the gradients of the received planes back to where they came from."""

    @staticmethod
    def forward(ctx, local, halo, axis, group):
        ctx.halo, ctx.axis, ctx.group, ctx.shape = halo, axis, group, local.shape
        size = local.shape[axis]
        from_prev, from_next = _swap(local.narrow(axis, 0, halo), local.narrow(axis, size - halo, halo), group)
        empty = local.new_empty(0)
        ctx.has = (from_prev is not None, from_next is not None)
        return (empty if from_prev is None else from_prev), (empty if from_next is None else from_next)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        halo, axis = ctx.halo, ctx.axis
        slab = list(ctx.shape)
        slab[axis] = halo
        zeros = g_prev.new_zeros(slab)
        # what this process sent to the previous one was its first planes, to the next its last
        to_top, to_bottom = _swap(g_prev if ctx.has[0] else zeros, g_next if ctx.has[1] else zeros, ctx.group)
        grad = zeros.new_zeros(ctx.shape)
        if to_top is not None:
            grad.narrow(axis, 0, halo).add_(to_top)
        if to_bottom is not None:
            grad.narrow(axis, ctx.shape[axis] - halo, halo).add_(to_bottom)
        return grad, None, None, None


def _extend(local: torch.Tensor, halo: int, axis: int, group) -> torch.Tensor:
    """``local`` with the neighbours' halos along ``axis``; at the group's border its own
    planes reflected."""
    size = local.shape[axis]
    from_prev, from_next = HaloExchange.apply(local, halo, axis, group)
    if from_prev.numel() == 0:
        from_prev = local.narrow(axis, 1, halo).flip(axis)
    if from_next.numel() == 0:
        from_next = local.narrow(axis, size - halo - 1, halo).flip(axis)
    return torch.cat([from_prev, local, from_next], dim=axis)


def _first(output):
    return output[0] if isinstance(output, (list, tuple)) else output


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every process's ``t`` concatenated along ``dim`` in rank order, on the host."""
    t = t.cpu() if dist.get_backend(group) == "gloo" else t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).cpu()


def halo_sharded_predict(model, volume, mesh, halo: Optional[int] = None, axis_name: str = "space"):
    """Predict a (C, S0, *rest) volume split along S0 among the processes of ``mesh[axis_name]``.

    Every process passes the whole volume (a numpy array or a tensor) and takes its slab;
    returns the whole (C_out, S0, *rest) prediction as a float32 numpy array on every
    process. The model runs in inference mode at its own dtype on its device. ``halo=None``
    derives the halo from the receptive field; each slab must be longer than the halo."""
    group, n, i = _axis_group(mesh, axis_name)
    s0 = volume.shape[1]
    if s0 % n:
        raise ValueError(f"Spatial axis {s0} must divide the mesh axis {n}.")
    halo = receptive_field_halo(model, spatial_axis=0) if halo is None else int(halo)
    slab = s0 // n
    if slab <= halo:
        raise ValueError(f"Per-device slab {slab} must exceed the halo {halo} (reflection at the mesh border "
                         "sources from the device's own slab); use fewer devices or halo_sharded_predict_large.")
    local = volume[:, i * slab:(i + 1) * slab]
    local = local if isinstance(local, torch.Tensor) else torch.from_numpy(np.require(local, requirements="CW"))
    local = local.to(_model_device(model), torch.float32)
    with torch.inference_mode():
        pred = _first(model(_extend(local, halo, 1, group)[None]))[0]
        pred = pred[:, halo:halo + slab]
        return _all_gather(pred.float(), group, dim=1).numpy()


def halo_sharded_predict_large(model, volume: np.ndarray, mesh, chunk: int, halo: Optional[int] = None,
                               axis_name: str = "space") -> np.ndarray:
    """Sharded prediction in outer chunks of ``chunk`` planes along S0, each extended by the
    halo on the host (reflected at the volume border) and padded to divide the mesh axis
    times the model's downscale, so that any extent works and the chunk seams are exact.
    ``chunk`` must divide by the mesh axis; one chunk's slabs bound each process's memory."""
    _, n, _ = _axis_group(mesh, axis_name)
    halo = receptive_field_halo(model, spatial_axis=0) if halo is None else int(halo)
    if chunk % n:
        raise ValueError(f"chunk {chunk} must divide the mesh axis {n}")
    s0 = volume.shape[1]
    rest = [(0, 0)] * (volume.ndim - 2)
    quantum = n * total_downscale(model, spatial_axis=0)
    out = None
    for a in range(0, s0, chunk):
        b = min(a + chunk, s0)
        lo, hi = a - halo, b + halo
        ext = volume[:, max(0, lo):min(s0, hi)]
        pad_lo, pad_hi = max(0, -lo), max(0, hi - s0)
        if pad_lo or pad_hi:
            ext = np.pad(ext, [(0, 0), (pad_lo, pad_hi)] + rest, mode="reflect")
        tail = -ext.shape[1] % quantum
        if tail:
            ext = np.pad(ext, [(0, 0), (0, tail)] + rest, mode="reflect")
        pred = halo_sharded_predict(model, ext, mesh, halo=halo, axis_name=axis_name)[:, halo:halo + b - a]
        if out is None:
            out = np.empty((pred.shape[0], s0) + pred.shape[2:], dtype=pred.dtype)
        out[:, a:b] = pred
    return out


def spatial_sharded_train_step(model, loss, optimizer, mesh, halo: Optional[int] = None,
                               axis_name: str = "space", batch_axis: Optional[str] = None):
    """A training step on (B, C, S0, *rest) batches split along S0 among the processes of
    ``mesh[axis_name]`` (and, with ``batch_axis``, along B among those of that axis).

    ``optimizer`` is a torch optimizer over the model's parameters or an ``OptimizerSpec``.
    Builds the step after copying rank 0's parameters to every process. Returns ``(step,
    shard_batch)``: ``shard_batch(x, y)`` takes this process's part of a whole batch (numpy
    or tensors) onto the model's device, and ``step(x, y)`` on those parts exchanges the
    halo, runs the model on the extended slab in training mode, crops the halo, forms the
    global loss over all processes of the mesh, all-reduces the parameter gradients,
    steps the optimizer in place and returns the loss (detached). With ``batch_axis`` the
    loss and the gradients reduce over both axes, the halo over ``axis_name`` only.
    """
    space_group, n_space, i_space = _axis_group(mesh, axis_name)
    if batch_axis is None:
        reduce_group, n_reduce = space_group, n_space
        n_batch, i_batch = 1, 0
    else:
        _, n_batch, i_batch = _axis_group(mesh, batch_axis)
        reduce_group, n_reduce = None, dist.get_world_size()
    halo = receptive_field_halo(model, spatial_axis=0) if halo is None else int(halo)
    if isinstance(optimizer, OptimizerSpec):
        optimizer = optimizer.build(model.parameters())
    replicate(model, optimizer)
    device = _model_device(model)

    def shard_batch(x, y):
        def part(t):
            t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(t))
            b, s = t.shape[0] // n_batch, t.shape[2] // n_space
            return t[i_batch * b:(i_batch + 1) * b, :, i_space * s:(i_space + 1) * s].to(device)
        return part(x), part(y)

    def step(x, y):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        pred = _first(model(_extend(x, halo, 2, space_group)))
        pred = pred[:, :, halo:halo + x.shape[2]]
        if has_shard_protocol(loss):
            value = global_loss(loss, pred, y, reduce_group)
        else:
            from torch.distributed.nn.functional import all_reduce

            value = all_reduce(loss(pred, y), group=reduce_group) / n_reduce
        value.backward()
        # each process's backward holds n_reduce times its share (the all_reduce's backward sums the
        # equal loss's gradient over the processes): the sum over them, over n_reduce, is the gradient
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=reduce_group)
                p.grad.div_(n_reduce)
        optimizer.step()
        return value.detach()

    return step, shard_batch
