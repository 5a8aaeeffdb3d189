"""nnU-Net raw transform: the port's own copy of ``torch_em_tpu/transforms/nnunet_raw.py``.

Applies nnU-Net v2's per-channel normalization from an ``nnUNetPlans.json``
(percentile clip and z-score for CT channels).
"""

import json
from typing import Union

import numpy as np

__all__ = ["nnUNetRawTransform"]


class nnUNetRawTransform:
    """Apply the nnUNet normalization scheme to raw inputs (CT/PET)."""

    def __init__(
        self,
        plans_file: str,
        expected_dtype: Union[np.dtype, str] = np.float32,
        tolerance: float = 1e-8,
        model_name: str = "3d_fullres",
    ):
        self.expected_dtype = expected_dtype
        self.tolerance = tolerance
        self.plans_file = plans_file
        self.model_name = model_name

        json_file = self.load_json(plans_file)
        self.intensity_properties = json_file["foreground_intensity_properties_per_channel"]
        self.per_channel_scheme = json_file["configurations"][model_name]["normalization_schemes"]
        self.init_kwargs = {
            "plans_file": plans_file, "expected_dtype": str(np.dtype(expected_dtype)),
            "tolerance": tolerance, "model_name": model_name,
        }

    def load_json(self, _file: str):
        """@private"""
        with open(_file, "r") as f:
            return json.load(f)

    def ct_transform(self, channel, properties):
        """@private"""
        mean = properties["mean"]
        std = properties["std"]
        lower_bound = properties["percentile_00_5"]
        upper_bound = properties["percentile_99_5"]
        transformed_channel = np.clip(channel, lower_bound, upper_bound)
        return (transformed_channel - mean) / max(std, self.tolerance)

    def __call__(self, raw: np.ndarray) -> np.ndarray:
        assert raw.shape[0] == len(self.per_channel_scheme), \
            "Number of channels & transforms from data plan must match"
        raw = raw.astype(self.expected_dtype)
        normalized_channels = []
        for idxx, (channel_transform, channel) in enumerate(zip(self.per_channel_scheme, raw)):
            properties = self.intensity_properties[str(idxx)]
            if channel_transform == "CTNormalization":
                channel = self.ct_transform(channel, properties)
            elif channel_transform in [
                "ZScoreNormalization", "NoNormalization", "RescaleTo01Normalization",
                "RGBTo01Normalization",
            ]:
                raise NotImplementedError(f"{channel_transform} is not supported by nnUNetRawTransform yet.")
            else:
                raise ValueError(f"Transform is not known: {channel_transform}.")
            normalized_channels.append(channel)
        return np.stack(normalized_channels)
