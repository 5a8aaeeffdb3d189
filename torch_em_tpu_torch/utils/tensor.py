"""Host-side array helpers for the data path (numpy, channel-first).

The port's own copy of ``torch_em_tpu/utils/tensor.py`` (``ensure_array``,
``ensure_spatial_array``, ``ensure_array_with_channels``,
``ensure_patch_shape``, ``validate_roi``, ``squeeze_singleton_dims``), after torch-em's
``util/util.py``. Samples stay numpy arrays until the loader collates them
into tensors.
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "ensure_array", "ensure_spatial_array", "ensure_array_with_channels",
    "ensure_patch_shape", "validate_roi", "squeeze_singleton_dims",
]


def ensure_array(data, dtype: Optional[Union[str, np.dtype]] = None) -> np.ndarray:
    """Coerce array-likes (lazy readers, CPU tensors, lists) to numpy."""
    if hasattr(data, "__array__"):
        arr = np.asarray(data)
    elif hasattr(data, "shape"):
        arr = np.asarray(data[...])
    else:
        arr = np.asarray(data)
    if dtype is not None:
        arr = arr.astype(dtype, copy=False)
    return arr


def ensure_spatial_array(data, ndim: int, dtype=None) -> np.ndarray:
    """Squeeze leading singleton axes until the array has ``ndim`` (spatial) axes."""
    arr = ensure_array(data, dtype)
    while arr.ndim > ndim and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != ndim:
        raise ValueError(f"Cannot convert array of shape {np.shape(data)} to {ndim} spatial dimensions.")
    return arr


def ensure_array_with_channels(data, ndim: int, dtype=None) -> np.ndarray:
    """Shape (C, *spatial) with ``ndim`` spatial axes: add a channel axis if absent,
    drop extra leading singleton axes."""
    arr = ensure_array(data, dtype)
    if arr.ndim == ndim:
        arr = arr[None]
    while arr.ndim > ndim + 1 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim == ndim:  # may have squeezed the channel too
        arr = arr[None]
    if arr.ndim != ndim + 1:
        raise ValueError(
            f"Cannot convert array of shape {np.shape(data)} to channel layout with {ndim} spatial dims."
        )
    return arr


def ensure_patch_shape(
    raw: np.ndarray,
    labels: Optional[np.ndarray],
    patch_shape: Sequence[int],
    have_raw_channels: bool = False,
    have_label_channels: bool = False,
    channel_first: bool = True,
) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Pad raw (reflect) and labels (zeros) at the upper end until they reach ``patch_shape``."""
    patch_shape = tuple(patch_shape)

    def _pad(arr, have_channels, mode):
        shape = arr.shape
        if have_channels:
            spatial = shape[1:] if channel_first else shape[:-1]
        else:
            spatial = shape
        pshape = patch_shape[-len(spatial):] if len(patch_shape) > len(spatial) else patch_shape
        if len(pshape) != len(spatial):
            raise ValueError(f"Patch shape {patch_shape} incompatible with array shape {shape}.")
        if all(s >= p for s, p in zip(spatial, pshape)):
            return arr
        pad_width = [(0, max(p - s, 0)) for s, p in zip(spatial, pshape)]
        if have_channels:
            pad_width = ([(0, 0)] + pad_width) if channel_first else (pad_width + [(0, 0)])
        kwargs = {} if mode == "reflect" else {"constant_values": 0}
        # reflect needs an axis longer than 1; a singleton axis repeats its edge
        if mode == "reflect" and any(s == 1 and pw[1] > 0 for s, pw in zip(arr.shape, pad_width)):
            mode = "edge"
        return np.pad(arr, pad_width, mode=mode, **kwargs)

    raw = _pad(raw, have_raw_channels, "reflect")
    if labels is None:
        return raw
    return raw, _pad(labels, have_label_channels, "constant")


def validate_roi(roi: Sequence[slice], shape: Sequence[int]) -> None:
    """Raise unless ``roi`` is a tuple of unstrided, non-empty slices inside ``shape``."""
    if not isinstance(roi, (tuple, list)):
        raise ValueError(f"Expect roi to be a tuple of slices, got {type(roi)}.")
    if len(roi) > len(shape):
        raise ValueError(f"ROI has {len(roi)} dimensions but the data only has {len(shape)}.")
    for i, (r, s) in enumerate(zip(roi, shape)):
        if not isinstance(r, slice):
            raise ValueError(f"ROI entry {i} is not a slice: {r}.")
        if r.step not in (None, 1):
            raise ValueError("Strided ROIs are not supported.")
        start = 0 if r.start is None else r.start
        stop = s if r.stop is None else r.stop
        if not (0 <= start < stop <= s):
            raise ValueError(f"ROI slice {r} is invalid for axis {i} with size {s}.")


def squeeze_singleton_dims(arr: np.ndarray, target_ndim: int) -> np.ndarray:
    """Squeeze leading singleton axes until the array has ``target_ndim`` dims."""
    while arr.ndim > target_ndim and arr.shape[0] == 1:
        arr = arr[0]
    return arr
