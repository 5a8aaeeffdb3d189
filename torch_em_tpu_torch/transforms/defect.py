"""EM defect augmentations on the host (numpy and scipy).

The port's own copy of ``torch_em_tpu/transforms/defect.py`` (after
torch-em's ``transform/defect.py``): per z-slice of a 3D EM stack, dropped
slices, low contrast, slice deformations (a compressed cut with a dead
stripe, or an undirected smooth warp) and pasted artifacts from an artifact
source with alpha masks, chosen by cumulative probabilities. The slice
deformations are built analytically (signed distances to the cut), as in
the JAX package.
"""

from typing import Optional

import numpy as np
from scipy import ndimage

from ..data.sampler import MinForegroundSampler
from ..data.segmentation_dataset import SegmentationDataset
from .augmentation import get_augmentations
from .raw import standardize

__all__ = ["EMDefectAugmentation", "get_artifact_source"]


def get_artifact_source(artifact_path, patch_shape, min_mask_fraction, normalizer=standardize,
                        raw_key="artifacts", mask_key="alpha_mask"):
    """Artifact source dataset for paste-artifact augmentation (torch-em defect.py:23)."""
    augmentation = get_augmentations(ndim=2)
    sampler = MinForegroundSampler(min_mask_fraction)
    return SegmentationDataset(
        artifact_path, raw_key, artifact_path, mask_key,
        patch_shape=patch_shape, raw_transform=normalizer, transform=augmentation, sampler=sampler,
    )


def _random_cut(shape, rng=np.random):
    """Sample a random cut through a 2D slice: a segment whose endpoints sit on
    two opposite borders (rows spanned or columns spanned with equal
    probability). Returns the first endpoint ``p0`` and the unit direction
    ``d``, both as (row, col) float vectors."""
    h, w = shape
    if rng.rand() < 0.5:  # endpoints on the top/bottom borders
        p0 = np.array([0.0, rng.randint(1, w - 2)])
        p1 = np.array([h - 1.0, rng.randint(1, w - 2)])
    else:  # endpoints on the left/right borders
        p0 = np.array([rng.randint(1, h - 2), 0.0])
        p1 = np.array([rng.randint(1, h - 2), w - 1.0])
    d = p1 - p0
    return p0, d / np.linalg.norm(d)


class EMDefectAugmentation:
    """Augment raw data with EM-defect-like transformations (torch-em defect.py:40)."""

    def __init__(
        self,
        p_drop_slice: float,
        p_low_contrast: float,
        p_deform_slice: float,
        p_paste_artifact: float = 0.0,
        contrast_scale: float = 0.1,
        deformation_mode: str = "undirected",
        deformation_strength: float = 10.0,
        artifact_source=None,
        mean_val: Optional[float] = None,
        std_val: Optional[float] = None,
    ):
        if p_paste_artifact > 0.0:
            assert artifact_source is not None
        self.artifact_source = artifact_source

        # cumulative probabilities
        self.p_drop_slice = p_drop_slice
        self.p_low_contrast = self.p_drop_slice + p_low_contrast
        self.p_deform_slice = self.p_low_contrast + p_deform_slice
        self.p_paste_artifact = self.p_deform_slice + p_paste_artifact
        assert self.p_paste_artifact < 1.0

        self.contrast_scale = contrast_scale
        self.mean_val = mean_val
        self.std_val = std_val

        if isinstance(deformation_mode, str):
            assert deformation_mode in ("all", "undirected", "compress")
            self.deformation_mode = deformation_mode
        elif isinstance(deformation_mode, (list, tuple)):
            assert len(deformation_mode) == 2
            assert "undirected" in deformation_mode and "compress" in deformation_mode
            self.deformation_mode = "all"
        self.deformation_strength = deformation_strength

        self.init_kwargs = {
            "p_drop_slice": p_drop_slice, "p_low_contrast": p_low_contrast,
            "p_deform_slice": p_deform_slice, "p_paste_artifact": p_paste_artifact,
            "contrast_scale": contrast_scale, "deformation_mode": deformation_mode,
            "deformation_strength": deformation_strength, "artifact_source": artifact_source,
            "mean_val": mean_val, "std_val": std_val,
        }

    def drop_slice(self, raw):
        raw[:] = 0
        return raw

    def low_contrast(self, raw):
        mean = raw.mean()
        raw -= mean
        raw *= self.contrast_scale
        raw += mean
        return raw

    def compress_slice(self, raw):
        """Dead stripe along a random cut, with both half-planes compressed
        towards it (torch-em's behavior: torch_em/transform/defect.py:105-146).

        Fully vectorized: instead of rasterizing the cut and labelling the two
        half-planes with connected components, the perpendicular signed
        distance of every pixel to the cut is computed analytically in one
        broadcast expression — it gives the side (its sign), the compression
        flow (constant per side, along the cut normal) and the dead stripe
        (|distance| below the stripe half-width) at once.
        """
        h, w = raw.shape
        p0, d = _random_cut(raw.shape)
        rows, cols = np.indices(raw.shape, dtype="float32")
        # perpendicular signed distance to the cut (d is unit length)
        dist = (rows - p0[0]) * d[1] - (cols - p0[1]) * d[0]
        # each half-plane samples from beyond itself along the cut normal
        # (-d[1], d[0]) scaled by its side, so content moves towards the cut
        side = -np.sign(dist) * self.deformation_strength
        jitter = self.deformation_strength / 8.0
        src = np.stack([
            rows - side * d[1] + np.random.uniform(-jitter, jitter, raw.shape),
            cols + side * d[0] + np.random.uniform(-jitter, jitter, raw.shape),
        ])
        cval = 0.0 if self.mean_val is None else self.mean_val
        warped = ndimage.map_coordinates(raw, src, mode="constant", order=3, cval=cval)
        # dead stripe: radius-10 band around the cut (torch-em dilates the
        # rasterized line 10x; the analytic band is its smooth equivalent)
        warped[np.abs(dist) <= 10.0] = 0.0
        return warped

    def undirected_deformation(self, raw):
        """Smooth random warp (torch-em's behavior: defect.py:148-160): a
        uniform white-noise flow field low-passed with a Gaussian (sigma 3 in
        the spatial axes), applied as a relative displacement."""
        noise = np.random.uniform(-1.0, 1.0, (2,) + raw.shape) * self.deformation_strength
        flow = ndimage.gaussian_filter(noise, sigma=(0.0, 3.0, 3.0))
        src = np.indices(raw.shape, dtype="float64") + flow
        return ndimage.map_coordinates(raw, src, mode="constant")

    def deform_slice(self, raw):
        if self.deformation_mode in ("undirected", "compress"):
            mode = self.deformation_mode
        else:
            mode = "undirected" if np.random.rand() < 0.5 else "compress"
        return self.compress_slice(raw) if mode == "compress" else self.undirected_deformation(raw)

    def paste_artifact(self, raw):
        artifact_index = np.random.randint(len(self.artifact_source))
        artifact, alpha_mask = self.artifact_source[artifact_index]
        artifact = np.asarray(artifact).squeeze()
        alpha_mask = np.asarray(alpha_mask).squeeze()
        assert artifact.shape == raw.shape, f"{artifact.shape}, {raw.shape}"
        assert alpha_mask.shape == raw.shape
        assert alpha_mask.min() >= 0.0 and alpha_mask.max() <= 1.0
        return raw * (1.0 - alpha_mask) + artifact * alpha_mask

    def __call__(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw).astype("float32")
        for z in range(raw.shape[0]):
            r = np.random.rand()
            if r < self.p_drop_slice:
                raw[z] = self.drop_slice(raw[z])
            elif r < self.p_low_contrast:
                raw[z] = self.low_contrast(raw[z])
            elif r < self.p_deform_slice:
                raw[z] = self.deform_slice(raw[z])
            elif r < self.p_paste_artifact:
                raw[z] = self.paste_artifact(raw[z])
        return raw
