"""Geometric augmentations, on the host per sample and on the card per batch.

Counterpart of ``torch_em_tpu/transforms/augmentation.py``: the flips,
rotations, affine maps and elastic deformations of its registry
(``AUGMENTATIONS``), the shared-parameter ``AugmentationPipeline`` (alias
``KorniaAugmentationPipeline``) and ``get_augmentations``. Each augmentation
is a pair: ``sample_params(generator, spatial_shape)`` draws its randomness
from an explicit ``torch.Generator`` on the generator's device, and
``apply(x, params, order)`` is deterministic. The same parameters warp every
tensor of a sample; non-float tensors are resampled with order 0.

The pipeline has two paths:

- ``pipeline(*arrays)``, the host path for one sample: numpy in, torch on
  the CPU, numpy out cast to ``pipeline.dtype``. It draws one seed per call
  from the pipeline's numpy generator under a lock, since the loader's
  threads share the pipeline, and never touches the card. Its torch calls
  run with torch's intra-op threads as set for the process: each loader
  thread that enters a parallel region gets a team of
  ``torch.get_num_threads()``.
- ``pipeline.apply_batched(generator, *tensors)`` on the tensors' device:
  tensors are (B, C, *spatial), each batch element gets its own parameter
  draw, and ``torch.where`` on the per-element ``apply`` flag keeps the
  elements that are not transformed.

Resampling follows ``jax.scipy.ndimage.map_coordinates(mode="nearest")``
rather than ``F.grid_sample``: indices are floored (order 1) or rounded half
away from zero (order 0), clamped to the axis and gathered, and the 2**ndim
neighbours are weighted and summed in jax's order. Coordinates come from
float32 products and chains of fused multiply-adds as XLA rounds them
(``_fma_dot``; sines and cosines are rounded once from float64), so the CPU
and the card compute the same coordinates, and the JAX package's to its
rounding. ``gaussian_blur`` and the elastic field's cubic resize are
products with small per-axis matrices: the blur's matrix folds numpy's
"reflect" padding in at any pad width, and the resize's weights are jax's
``compute_weight_mat`` (Keys cubic, a = -0.5, half-pixel centres, weights
outside the input dropped and renormalised).
"""

import functools
import itertools
import operator
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "RandomHorizontalFlip", "RandomVerticalFlip", "RandomDepthicalFlip3D",
    "RandomHorizontalFlip3D", "RandomVerticalFlip3D", "RandomRotation",
    "RandomRotation3D", "RandomAffine", "RandomAffine3D",
    "RandomElasticDeformation", "RandomElasticDeformation3D",
    "AugmentationPipeline", "KorniaAugmentationPipeline", "AUGMENTATIONS",
    "DEFAULT_2D_AUGMENTATIONS", "DEFAULT_3D_AUGMENTATIONS",
    "DEFAULT_ANISOTROPIC_AUGMENTATIONS", "get_augmentations", "gaussian_blur",
]

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Resampling and smoothing
# ---------------------------------------------------------------------------

def _round_half_away_from_zero(c: torch.Tensor) -> torch.Tensor:
    whole = torch.trunc(c)
    return whole + torch.where((c - whole).abs() >= 0.5, torch.sign(c), torch.zeros_like(c))


def map_coordinates(x: torch.Tensor, coords: Sequence[torch.Tensor], order: int) -> torch.Tensor:
    """Sample ``x`` (B, C, *spatial) at ``coords``, one float32 tensor (B, *out) per spatial
    axis, with order 0 or 1 and indices clamped to the axis (mode "nearest")."""
    if order not in (0, 1):
        raise NotImplementedError(f"order {order}: only 0 and 1 are supported")
    spatial = x.shape[2:]
    if len(coords) != len(spatial):
        raise ValueError(f"{len(coords)} coordinate arrays for {len(spatial)} spatial axes")
    b, c = x.shape[:2]
    out_shape = coords[0].shape[1:]
    nodes = []
    for coord, size in zip(coords, spatial):
        if order == 0:
            nodes.append([(_round_half_away_from_zero(coord).long().clamp_(0, size - 1), None)])
        else:
            lower = torch.floor(coord)
            upper_weight = coord - lower
            index = lower.long()
            nodes.append([(index.clamp(0, size - 1), 1 - upper_weight),
                          ((index + 1).clamp_(0, size - 1), upper_weight)])
    strides = [int(np.prod(spatial[d + 1:])) for d in range(len(spatial))]
    flat_x = x.reshape(b, c, -1)
    result = None
    for corner in itertools.product(*nodes):
        flat = sum(index * stride for (index, _), stride in zip(corner, strides))
        values = flat_x.gather(2, flat.reshape(b, 1, -1).expand(b, c, -1))
        if order == 0:
            return values.reshape((b, c) + tuple(out_shape))
        weight = functools.reduce(operator.mul, [w for _, w in corner]).reshape(b, 1, -1)
        term = weight * values
        result = term if result is None else result + term
    if not x.is_floating_point():
        result = _round_half_away_from_zero(result)
    return result.reshape((b, c) + tuple(out_shape)).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _blur_matrix(length: int, sigma: float, truncate: float) -> np.ndarray:
    """(length, length) float32 matrix of a Gaussian blur along one axis with numpy's
    "reflect" padding folded in; row i holds the weights of output i."""
    radius = max(int(np.ceil(truncate * sigma)), 1)
    t = np.arange(-radius, radius + 1, dtype="float32")
    kernel = np.exp(-0.5 * (t / max(sigma, 1e-6)) ** 2)
    kernel = kernel / kernel.sum()
    source = np.pad(np.arange(length), radius, mode="reflect")
    rows = np.repeat(np.arange(length), 2 * radius + 1)
    cols = source[np.arange(length)[:, None] + np.arange(2 * radius + 1)[None, :]].ravel()
    matrix = np.zeros((length, length), dtype="float64")
    np.add.at(matrix, (rows, cols), np.tile(kernel.astype("float64"), length))
    return matrix.astype("float32")


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype("float32")


@functools.lru_cache(maxsize=64)
def _cubic_weights(input_size: int, output_size: int) -> np.ndarray:
    """(input_size, output_size) float32 weights of jax.image.resize(method="cubic") along
    one axis (``jax/_src/image/scale.py:compute_weight_mat``, antialiased, no translation)."""
    inv_scale = 1.0 / (output_size / input_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (np.arange(output_size, dtype="float32") + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype="float32")[:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype("float32")


@functools.lru_cache(maxsize=64)
def _on_device(make, device: torch.device, *args) -> torch.Tensor:
    return torch.from_numpy(make(*args)).to(device)


def _along_axis(x: torch.Tensor, axis: int, matrix: torch.Tensor) -> torch.Tensor:
    """Contract axis ``axis`` of ``x`` with the first axis of ``matrix`` (in, out)."""
    return torch.movedim(torch.movedim(x, axis, -1) @ matrix, -1, axis)


def gaussian_blur(field: torch.Tensor, sigma: float, truncate: float = 3.0) -> torch.Tensor:
    """Separable Gaussian blur over the spatial axes of (C, *spatial), radius
    ``ceil(truncate * sigma)``, reflecting (numpy "reflect") at any pad width."""
    out = field.float()
    for axis in range(1, field.ndim):
        matrix = _on_device(_blur_matrix, field.device, field.shape[axis], float(sigma), float(truncate))
        out = _along_axis(out, axis, matrix.T)
    return out


def cubic_resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, method="cubic")``: axes whose size does not change are
    left alone, every other one is a product with its weight matrix."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match an array of {x.ndim} dimensions")
    out = x.float()
    for axis, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            out = _along_axis(out, axis, _on_device(_cubic_weights, x.device, m, n))
    return out


def _centered_grid(spatial_shape, device):
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=device) for s in spatial_shape],
                           indexing="ij")
    centers = [(s - 1) / 2.0 for s in spatial_shape]
    return [g - c for g, c in zip(grids, centers)], centers


def _fma_dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_k a[k] * b[k] in float32 as XLA computes a product: the first product rounded,
    then a chain of fused multiply-adds, each adding the exact float64 product and
    rounding once. Every device computes it alike."""
    acc = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        acc = (acc.double() + x.double() * y.double()).float()
    return acc


def _affine_coords(spatial_shape, matrix: torch.Tensor) -> List[torch.Tensor]:
    """Coordinates (B, *spatial) of the inverse warp out(p) = in(M @ (p - c) + c) about the
    centre c = (s - 1) / 2, for a batch of float32 matrices (B, ndim, ndim)."""
    centered, centers = _centered_grid(spatial_shape, matrix.device)
    b, ndim = matrix.shape[0], len(spatial_shape)
    if tuple(matrix.shape[1:]) != (ndim, ndim):
        raise ValueError(f"a {tuple(matrix.shape[1:])} matrix cannot warp a {ndim}-D patch")
    m = matrix.reshape(b, ndim, ndim, *([1] * ndim))
    return [_fma_dot([m[:, d, k] for k in range(ndim)], centered) + centers[d] for d in range(ndim)]


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, n, n) @ (B, n, n) in float32 with XLA's rounding (``_fma_dot``)."""
    n = a.shape[-1]
    return _fma_dot([a[:, :, k, None] for k in range(n)], [b[:, None, k, :] for k in range(n)])


def _trig(angle: torch.Tensor):
    """cos and sin of float32 angles, computed in float64 and rounded once."""
    return torch.cos(angle.double()).float(), torch.sin(angle.double()).float()


def _stack_matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot2d(angle: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2) float32 rotation matrices."""
    c, s = _trig(angle)
    return _stack_matrix([(c, -s), (s, c)])


def _rot3d(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) float32 rotation matrices rz @ ry @ rx in (D, H, W) order."""
    (cy, sy), (cp, sp), (cr, sr) = _trig(yaw), _trig(pitch), _trig(roll)
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)
    rz = _stack_matrix([(one, zero, zero), (zero, cy, -sy), (zero, sy, cy)])
    ry = _stack_matrix([(cp, zero, sp), (zero, one, zero), (-sp, zero, cp)])
    rx = _stack_matrix([(cr, -sr, zero), (sr, cr, zero), (zero, zero, one)])
    return _matmul(_matmul(rz, ry), rx)


def _uniform(generator: torch.Generator, low: float, high: float, shape=()) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return low + (high - low) * u


def _deg2rad(degrees: torch.Tensor) -> torch.Tensor:
    return degrees * (np.pi / 180.0)


# ---------------------------------------------------------------------------
# Augmentation primitives
# ---------------------------------------------------------------------------

class _Augmentation:
    """Base: ``sample_params`` draws the randomness, ``apply`` is deterministic."""

    #: whether apply() resamples and must respect the interpolation order
    interpolating = False

    def __init__(self, p: float = 0.5):
        self.p = p

    def sample_params(self, generator: torch.Generator, spatial_shape: Tuple[int, ...]) -> Params:
        """One parameter set for a patch of ``spatial_shape``, on the generator's device."""
        params = self._sample(generator, tuple(spatial_shape))
        params["apply"] = _uniform(generator, 0.0, 1.0) < self.p
        return params

    def _sample(self, generator, spatial_shape) -> Params:
        return {}

    def apply(self, x: torch.Tensor, params: Params, order: int) -> torch.Tensor:
        """Apply to one sample (C, *spatial) with the parameters of ``sample_params``."""
        return self.apply_batch(x[None], {k: v[None] for k, v in params.items()}, order)[0]

    def apply_batch(self, x: torch.Tensor, params: Params, order: int) -> torch.Tensor:
        """Apply to (B, C, *spatial) with per-element parameters stacked along a leading axis."""
        transformed = self._apply(x, params, order)
        keep = params["apply"].reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(keep, transformed, x)

    def _apply(self, x, params, order):
        raise NotImplementedError


class _Flip(_Augmentation):
    """Flip along a spatial axis counted from the end (-1 = W, -2 = H, -3 = D)."""

    def __init__(self, axis_from_end: int, p: float = 0.5):
        super().__init__(p)
        self.axis_from_end = axis_from_end

    def _apply(self, x, params, order):
        return torch.flip(x, dims=(x.ndim - self.axis_from_end,))


class RandomHorizontalFlip(_Flip):
    def __init__(self, p: float = 0.5):
        super().__init__(axis_from_end=1, p=p)


class RandomVerticalFlip(_Flip):
    def __init__(self, p: float = 0.5):
        super().__init__(axis_from_end=2, p=p)


class RandomDepthicalFlip3D(_Flip):
    def __init__(self, p: float = 0.5):
        super().__init__(axis_from_end=3, p=p)


# the 3D flip variants act on the same trailing axes
class RandomHorizontalFlip3D(RandomHorizontalFlip):
    pass


class RandomVerticalFlip3D(RandomVerticalFlip):
    pass


class _Warp(_Augmentation):
    """An augmentation that resamples the patch at ``coords(spatial_shape, params)``."""

    interpolating = True

    def coords(self, spatial_shape, params: Params) -> List[torch.Tensor]:
        """The sampling coordinates, one float32 tensor (B, *spatial) per spatial axis."""
        raise NotImplementedError

    def _apply(self, x, params, order):
        return map_coordinates(x, self.coords(x.shape[2:], params), order)


class _AffineWarp(_Warp):
    """An inverse affine warp about the patch centre by ``matrix(params)``, (B, ndim, ndim)."""

    def matrix(self, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def coords(self, spatial_shape, params):
        return _affine_coords(spatial_shape, self.matrix(params))


class RandomRotation(_AffineWarp):
    """2D rotation by a uniform angle in [-degrees, degrees]."""

    def __init__(self, degrees: float = 90, p: float = 0.5):
        super().__init__(p)
        self.degrees = degrees

    def _sample(self, generator, spatial_shape):
        return {"angle": _deg2rad(_uniform(generator, -self.degrees, self.degrees))}

    def matrix(self, params):
        return _rot2d(params["angle"])


class RandomRotation3D(_AffineWarp):
    """3D rotation with independent yaw, pitch and roll angles."""

    def __init__(self, degrees: Tuple[float, float, float] = (90, 90, 90), p: float = 0.5):
        super().__init__(p)
        self.degrees = degrees

    def _sample(self, generator, spatial_shape):
        yaw, pitch, roll = (_deg2rad(_uniform(generator, -d, d)) for d in self.degrees)
        return {"yaw": yaw, "pitch": pitch, "roll": roll}

    def matrix(self, params):
        return _rot3d(params["yaw"], params["pitch"], params["roll"])


class RandomAffine(_AffineWarp):
    """2D rotation and isotropic scale."""

    def __init__(self, degrees: float = 90, scale: Tuple[float, float] = (0.9, 1.1), p: float = 0.5):
        super().__init__(p)
        self.degrees = degrees
        self.scale = scale

    def _sample(self, generator, spatial_shape):
        angle = _deg2rad(_uniform(generator, -self.degrees, self.degrees))
        return {"angle": angle, "scale": _uniform(generator, self.scale[0], self.scale[1])}

    def matrix(self, params):
        return _rot2d(params["angle"]) / params["scale"][:, None, None]


class RandomAffine3D(_AffineWarp):
    """3D rotation and isotropic scale; the scale's lower end is clamped to 1e-2, since
    the registry gives (0.0, 1.1)."""

    def __init__(self, degrees: Tuple[float, float, float] = (90, 90, 90),
                 scale: Tuple[float, float] = (0.9, 1.1), p: float = 0.5):
        super().__init__(p)
        self.degrees = degrees
        self.scale = scale

    def _sample(self, generator, spatial_shape):
        yaw, pitch, roll = (_deg2rad(_uniform(generator, -d, d)) for d in self.degrees)
        low = max(min(self.scale), 1e-2)
        return {"yaw": yaw, "pitch": pitch, "roll": roll,
                "scale": _uniform(generator, low, max(self.scale))}

    def matrix(self, params):
        return _rot3d(params["yaw"], params["pitch"], params["roll"]) / params["scale"][:, None, None]


class RandomElasticDeformation(_Warp):
    """2D elastic deformation from smoothed control-point noise: uniform noise on a
    grid of ``size // control_point_spacing`` points (at least 2), resized to the patch
    (cubic), blurred with sigma ``mean(sigma)``; the displacement is
    ``noise * alpha * (size - 1) / 2`` pixels."""

    def __init__(self, control_point_spacing: Union[int, Sequence[int]] = 1,
                 sigma: Tuple[float, float] = (32.0, 32.0), alpha: Tuple[float, float] = (4.0, 4.0),
                 p: float = 0.5):
        super().__init__(p)
        if isinstance(control_point_spacing, int):
            control_point_spacing = [control_point_spacing] * 2
        self.control_point_spacing = list(control_point_spacing)
        self.sigma = sigma
        self.alpha = alpha

    def control_shape(self, shape2d) -> Tuple[int, int]:
        return tuple(max(sh // sp, 2) for sh, sp in zip(shape2d, self.control_point_spacing))

    def smooth_noise(self, control: torch.Tensor, shape2d) -> torch.Tensor:
        """The displacement field's noise (2, H, W) from control-point noise (2, h, w)."""
        noise = cubic_resize(control, (2,) + tuple(shape2d))
        return gaussian_blur(noise, float(np.mean(self.sigma)))

    def _sample(self, generator, spatial_shape):
        shape2d = spatial_shape[-2:]
        control = _uniform(generator, -1.0, 1.0, (2,) + self.control_shape(shape2d))
        return {"noise": self.smooth_noise(control, shape2d)}

    def coords(self, spatial_shape, params):
        """The in-plane coordinates (B, H, W) of the last two axes of ``spatial_shape``."""
        shape2d, noise = spatial_shape[-2:], params["noise"]
        scale = torch.tensor([float(self.alpha[0]) * (shape2d[0] - 1) / 2.0,
                              float(self.alpha[1]) * (shape2d[1] - 1) / 2.0],
                             dtype=torch.float32, device=noise.device)
        disp = noise * scale[:, None, None]
        gy, gx = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=noise.device) for s in shape2d],
                                indexing="ij")
        return [gy + disp[:, 0], gx + disp[:, 1]]


class RandomElasticDeformation3D(RandomElasticDeformation):
    """Plane-consistent 3D elastic deformation: one 2D field warps every z-plane.

    Every axis before the last two is folded into the planes, so a (C, D, H, W)
    sample is warped as C * D planes, as in the JAX package, and a sample without a
    channel axis, (D, H, W) as a dataset hands it over, as D planes (the JAX
    package raises on it)."""

    def __init__(self, control_point_spacing: Union[int, Sequence[int]] = 1,
                 sigma: Tuple[float, float] = (32.0, 32.0), alpha: Tuple[float, float] = (4.0, 4.0),
                 p: float = 0.5):
        super().__init__(control_point_spacing, sigma, alpha, p)

    def _apply(self, x, params, order):
        planes = x.reshape((x.shape[0], -1) + tuple(x.shape[-2:]))
        return map_coordinates(planes, self.coords(x.shape[2:], params), order).reshape(x.shape)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

_FLOAT_DTYPES = (np.dtype("float16"), np.dtype("float32"), np.dtype("float64"))


def _stack(draws: List[Params]) -> Params:
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


class AugmentationPipeline:
    """Applies augmentations with shared parameters to raw and label tensors: one
    parameter draw per augmentation per sample, the same geometry for every tensor,
    order 1 for float tensors and order 0 for the others.

    Call it with numpy arrays for the host path, or use :meth:`apply_batched` with a
    ``torch.Generator`` on the tensors' device."""

    def __init__(self, *augmentations: _Augmentation, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = None):
        self.augmentations = list(augmentations)
        self.dtype = dtype
        self._np_rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.halo = self.compute_halo()

    def compute_halo(self):
        halo = None
        for aug in self.augmentations:
            if isinstance(aug, RandomRotation):
                halo = [32, 32]
            if isinstance(aug, RandomRotation3D):
                halo = [32, 32, 32]
        return halo

    def is_interpolatable(self, tensor) -> bool:
        return np.dtype(tensor.dtype) in _FLOAT_DTYPES

    def _apply(self, generator: torch.Generator, tensors: Sequence[torch.Tensor],
               orders: Sequence[int]) -> List[torch.Tensor]:
        batch, spatial = tensors[0].shape[0], tuple(tensors[0].shape[2:])
        out = list(tensors)
        for aug in self.augmentations:
            params = _stack([aug.sample_params(generator, spatial) for _ in range(batch)])
            for i, t in enumerate(out):
                out[i] = aug.apply_batch(t, params, orders[i] if aug.interpolating else 0)
        return out

    def apply_batched(self, generator: torch.Generator, *tensors: torch.Tensor,
                      interpolatable: Optional[Sequence[bool]] = None) -> Tuple[torch.Tensor, ...]:
        """Tensors (B, C, *spatial) on the generator's device; an independent parameter
        draw per batch element."""
        for t in tensors:
            if t.device.type != generator.device.type:
                raise ValueError(f"a tensor on {t.device} with a generator on {generator.device}")
        if interpolatable is None:
            interpolatable = [t.is_floating_point() for t in tensors]
        return tuple(self._apply(generator, tensors, [1 if it else 0 for it in interpolatable]))

    def __call__(self, *arrays) -> List[np.ndarray]:
        """The host path: one sample's arrays (C, *spatial), numpy in and out."""
        orders = [1 if self.is_interpolatable(a) else 0 for a in arrays]
        tensors = [torch.tensor(np.asarray(a), dtype=self.dtype)[None] for a in arrays]
        with self._lock:
            seed = int(self._np_rng.integers(0, 2 ** 31 - 1))
        generator = torch.Generator().manual_seed(seed)
        return [t[0].numpy() for t in self._apply(generator, tensors, orders)]


# the name torch-em gives the pipeline
KorniaAugmentationPipeline = AugmentationPipeline


AUGMENTATIONS = {
    "RandomAffine": {"degrees": 90, "scale": (0.9, 1.1)},
    "RandomAffine3D": {"degrees": (90, 90, 90), "scale": (0.0, 1.1)},
    "RandomDepthicalFlip3D": {},
    "RandomHorizontalFlip": {},
    "RandomHorizontalFlip3D": {},
    "RandomRotation": {"degrees": 90},
    "RandomRotation3D": {"degrees": (90, 90, 90)},
    "RandomVerticalFlip": {},
    "RandomVerticalFlip3D": {},
    "RandomElasticDeformation": {},
    "RandomElasticDeformation3D": {"alpha": [5, 5], "sigma": [30, 30]},
}
"""Every augmentation of the registry and its default parameters."""

DEFAULT_2D_AUGMENTATIONS = ["RandomHorizontalFlip", "RandomVerticalFlip"]
DEFAULT_3D_AUGMENTATIONS = ["RandomHorizontalFlip3D", "RandomVerticalFlip3D", "RandomDepthicalFlip3D"]
DEFAULT_ANISOTROPIC_AUGMENTATIONS = ["RandomHorizontalFlip3D", "RandomVerticalFlip3D", "RandomDepthicalFlip3D"]


def create_augmentation(trafo: str) -> _Augmentation:
    if trafo not in AUGMENTATIONS:
        raise ValueError(f"Transformation {trafo} not defined")
    return globals()[trafo](**AUGMENTATIONS[trafo])


def get_augmentations(ndim: Union[int, str] = 2, transforms: Optional[Sequence] = None,
                      dtype: torch.dtype = torch.float32) -> AugmentationPipeline:
    """The default augmentation pipeline for ``ndim`` (2, 3 or "anisotropic"), or one of
    the named ``transforms`` (names of the registry or augmentation objects)."""
    if transforms is None:
        if ndim not in (2, 3, "anisotropic"):
            raise ValueError(f"Expect ndim to be one of (2, 3, 'anisotropic'), got {ndim}")
        transforms = {2: DEFAULT_2D_AUGMENTATIONS, 3: DEFAULT_3D_AUGMENTATIONS}.get(
            ndim, DEFAULT_ANISOTROPIC_AUGMENTATIONS)
    augs = [create_augmentation(t) if isinstance(t, str) else t for t in transforms]
    pipeline = AugmentationPipeline(*augs, dtype=dtype)
    pipeline.init_kwargs = {"ndim": ndim, "transforms": [t for t in transforms if isinstance(t, str)] or None}
    pipeline.factory = "torch_em_tpu_torch.transforms.augmentation.get_augmentations"
    return pipeline
