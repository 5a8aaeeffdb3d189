"""Generic shape and composition transforms (numpy).

The port's own copy of ``torch_em_tpu/transforms/generic.py`` (after
torch-em's ``transform/generic.py``): ``Tile``, ``Compose``, ``Rescale``,
``ResizeInputs``, ``ResizeLongestSideInputs`` (SAM-style longest-side
resize and centre pad) and ``PadIfNecessary``. Resizing goes through the
port's ``ops.host.resize`` (scipy zoom).
"""

from math import ceil, floor
from typing import Sequence, Tuple

import numpy as np

from ..ops import host as ops

__all__ = ["Tile", "Compose", "Rescale", "ResizeInputs", "ResizeLongestSideInputs", "PadIfNecessary"]


class Tile:
    """Tile the input by repetition (torch-em generic.py:11)."""

    def __init__(self, reps: Sequence[int] = (2,), match_shape_exactly: bool = True):
        self.reps = reps
        self.match_shape_exactly = match_shape_exactly
        self.init_kwargs = {"reps": reps, "match_shape_exactly": match_shape_exactly}

    def __call__(self, input_: np.ndarray):
        assert not self.match_shape_exactly or len(input_.shape) == len(self.reps), (input_.shape, self.reps)
        return np.tile(np.asarray(input_), self.reps)


class Compose:
    """Compose multi-tensor transforms (torch-em generic.py:38)."""

    def __init__(self, *transforms, is_multi_tensor: bool = True):
        self.transforms = transforms
        self.is_multi_tensor = is_multi_tensor
        self.init_kwargs = {"transforms": transforms, "is_multi_tensor": is_multi_tensor}

    def __call__(self, *inputs):
        outputs = self.transforms[0](*inputs)
        for trafo in self.transforms[1:]:
            outputs = trafo(*outputs) if self.is_multi_tensor else trafo(outputs)
        return outputs


class Rescale:
    """Rescale inputs by a scale factor (torch-em generic.py:54)."""

    def __init__(self, scale, with_channels=None, is_label: bool = False):
        self.scale = scale
        self.with_channels = with_channels
        self.is_label = is_label
        self.init_kwargs = {"scale": scale, "with_channels": with_channels, "is_label": is_label}

    def _target_shape(self, shape):
        scale = self.scale
        if np.isscalar(scale):
            scale = [scale] * len(shape)
        return tuple(int(round(s * sc)) for s, sc in zip(shape, scale))

    def _rescale(self, inp):
        order = 0 if self.is_label else 1
        return ops.resize(inp, self._target_shape(inp.shape), order=order)

    def _rescale_with_channels(self, inp):
        return np.concatenate([self._rescale(c)[None] for c in inp], axis=0)

    def __call__(self, *inputs):
        if self.with_channels is None:
            outputs = tuple(self._rescale(inp) for inp in inputs)
        else:
            wc = self.with_channels
            if not isinstance(wc, (tuple, list)):
                wc = [wc] * len(inputs)
            assert len(wc) == len(inputs)
            outputs = tuple(
                self._rescale_with_channels(inp) if w else self._rescale(inp) for inp, w in zip(inputs, wc)
            )
        return outputs[0] if len(outputs) == 1 else outputs


class ResizeInputs:
    """Resize inputs to a fixed target shape (torch-em generic.py:89)."""

    def __init__(self, target_shape, is_label: bool = False, is_rgb: bool = False):
        self.target_shape = target_shape
        self.is_label = is_label
        self.is_rgb = is_rgb
        self.init_kwargs = {"target_shape": target_shape, "is_label": is_label, "is_rgb": is_rgb}

    def __call__(self, inputs: np.ndarray) -> np.ndarray:
        if self.is_rgb:
            assert inputs.ndim == 3 and inputs.shape[0] == 3
            patch_shape = (3, *self.target_shape)
        else:
            patch_shape = self.target_shape
        order = 0 if self.is_label else 1
        return ops.resize(inputs, patch_shape, order=order).astype(inputs.dtype)


class ResizeLongestSideInputs:
    """SAM-style longest-side resize + center pad (torch-em generic.py:117)."""

    def __init__(self, target_shape: Tuple[int, int], is_label: bool = False, is_rgb: bool = False,
                 padding_mode: str = "constant"):
        self.target_shape = target_shape
        self.is_label = is_label
        self.is_rgb = is_rgb
        self.padding_mode = padding_mode
        self.init_kwargs = {
            "target_shape": target_shape, "is_label": is_label, "is_rgb": is_rgb, "padding_mode": padding_mode,
        }
        h, w = target_shape[-2], target_shape[-1]
        if h != w:
            raise ValueError("'ResizeLongestSideInputs' does not support non-square shaped target shapes.")
        self.target_length = target_shape[-1]
        self.order = 0 if is_label else 1

    def _get_preprocess_shape(self, oldh, oldw):
        scale = self.target_length * 1.0 / max(oldh, oldw)
        return int(oldh * scale + 0.5), int(oldw * scale + 0.5)

    def convert_transformed_inputs_to_original_shape(self, resized_inputs, resize_kwargs=None):
        if not hasattr(self, "pre_pad_shape"):
            raise RuntimeError(
                "'convert_transformed_inputs_to_original_shape' is only valid after the '__call__' method has run."
            )
        inputs = resized_inputs[tuple(self.pre_pad_shape)]
        order = self.order if resize_kwargs is None else (0 if resize_kwargs.get("order") == 0 else 1)
        return ops.resize(inputs, self.original_shape, order=order)

    def __call__(self, inputs: np.ndarray) -> np.ndarray:
        self.original_shape = inputs.shape
        new_shape = self._get_preprocess_shape(inputs.shape[-2], inputs.shape[-1])
        if self.is_rgb:
            assert inputs.ndim == 3 and inputs.shape[0] == 3
            patch_shape = (3, *new_shape)
        elif inputs.ndim == 3:
            patch_shape = (inputs.shape[0], *new_shape)
        else:
            patch_shape = new_shape
        inputs = ops.resize(inputs, patch_shape, order=self.order).astype(inputs.dtype)

        pad_width = [(sh - dsh) / 2 for sh, dsh in zip(self.target_shape, new_shape)]
        pad_width = ((ceil(pad_width[0]), floor(pad_width[0])), (ceil(pad_width[1]), floor(pad_width[1])))
        if self.is_rgb or inputs.ndim == 3:
            pad_width = ((0, 0), *pad_width)
        self.pre_pad_shape = [slice(pw[0], -pw[1] if pw[1] > 0 else None) for pw in pad_width]
        return np.pad(inputs, pad_width, mode=self.padding_mode)


class PadIfNecessary:
    """Pad trailing dims up to a target shape (torch-em generic.py:209)."""

    def __init__(self, shape, padding_mode: str = "reflect"):
        self.shape = tuple(shape)
        self.padding_mode = padding_mode
        self.init_kwargs = {"shape": shape, "padding_mode": padding_mode}

    def _pad_if_necessary(self, data):
        if data.ndim == len(self.shape):
            pad_shape = self.shape
        else:
            dim_diff = data.ndim - len(self.shape)
            pad_shape = data.shape[:dim_diff] + self.shape
        if all(dsh == sh for dsh, sh in zip(data.shape, pad_shape)):
            return data
        pad_width = [(0, sh - dsh) for dsh, sh in zip(data.shape, pad_shape)]
        assert all(pw[1] >= 0 for pw in pad_width)
        return np.pad(data, pad_width, mode=self.padding_mode)

    def __call__(self, *inputs):
        outputs = tuple(self._pad_if_necessary(inp) for inp in inputs)
        return outputs[0] if len(outputs) == 1 else outputs
