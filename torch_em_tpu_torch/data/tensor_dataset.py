"""In-memory tensor dataset: the port's own copy of ``torch_em_tpu/data/tensor_dataset.py``
(after torch-em's ``data/tensor_dataset.py``), an ``ImageCollectionDataset`` over numpy arrays."""

from typing import Callable, List, Optional, Tuple

import numpy as np

from .image_collection_dataset import ImageCollectionDataset


class TensorDataset(ImageCollectionDataset):
    """Dataset over in-memory images and segmentation labels (numpy arrays)."""

    def __init__(
        self,
        images: List[np.ndarray],
        labels: List[np.ndarray],
        patch_shape: Tuple[int, ...],
        raw_transform: Optional[Callable] = None,
        label_transform: Optional[Callable] = None,
        label_transform2: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        dtype="float32",
        label_dtype="float32",
        n_samples: Optional[int] = None,
        sampler: Optional[Callable] = None,
        with_padding: bool = True,
        with_channels: bool = False,
    ):
        self.raw_images = [np.asarray(im) for im in images]
        self.label_images = [np.asarray(lab) for lab in labels]
        self.patch_shape = tuple(patch_shape)
        self.with_channels = with_channels
        self._check_tensor_inputs()
        self._ndim = len(self.patch_shape)

        self.with_label_channels = False
        self.have_tensor_data = True

        self.raw_transform = raw_transform
        self.label_transform = label_transform
        self.label_transform2 = label_transform2
        self.transform = transform
        self.sampler = sampler
        self.with_padding = with_padding
        self.pre_label_transform = None

        self.dtype = dtype
        self.label_dtype = label_dtype

        if n_samples is None:
            self._len = len(self.raw_images)
            self.sample_random_index = False
        else:
            self._len = n_samples
            self.sample_random_index = True

        self.init_kwargs = {
            "images": images, "labels": labels, "patch_shape": patch_shape, "raw_transform": raw_transform,
            "label_transform": label_transform, "label_transform2": label_transform2, "transform": transform,
            "dtype": dtype, "label_dtype": label_dtype, "n_samples": n_samples, "sampler": sampler,
            "with_padding": with_padding, "with_channels": with_channels,
        }

    def _check_tensor_inputs(self):
        ndim = len(self.patch_shape)
        if len(self.raw_images) != len(self.label_images):
            raise ValueError(
                f"Number of images and labels does not match: {len(self.raw_images)}, {len(self.label_images)}"
            )
        for image, labels in zip(self.raw_images, self.label_images):
            im_shape = image.shape
            if self.with_channels and len(im_shape) != ndim + 1:
                raise ValueError("Image shape does not match the patch shape")
            elif not self.with_channels and len(im_shape) != ndim:
                raise ValueError("Image shape does not match the patch shape")
            if self.with_channels and tuple(im_shape[1:]) != tuple(labels.shape):
                raise ValueError("Image and label shape does not match")
            elif not self.with_channels and tuple(im_shape) != tuple(labels.shape):
                raise ValueError("Image and label shape does not match")
