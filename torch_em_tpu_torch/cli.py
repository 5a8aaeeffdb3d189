"""Command line interface: training and prediction entry points.

The port's own copy of ``torch_em_tpu/cli.py`` (after torch-em's
``cli.py``). Console scripts ``tpu_em_torch.train_2d_unet``,
``tpu_em_torch.train_3d_unet``, ``tpu_em_torch.predict`` and
``tpu_em_torch.predict_with_tiling``; the label modes affinities,
affinities_and_foreground, boundaries, boundaries_and_foreground and
foreground; the default affinity offset ladders (1, 3, 9, 27); a random
train/val split when no validation data is given; the channels read off a
probe batch. Training and prediction run on ``--device cuda`` (``-d``)
unless another device is named, e.g. ``-d cpu``; ``predict_with_tiling``
takes ``--devices``, default ``cuda``.
"""

import argparse
import json
import multiprocessing
import uuid

import numpy as np
import torch

from . import loss as losses
from . import transforms
from .data.base import Dataset
from .models import AnisotropicUNet, UNet2d, UNet3d
from .segmentation import default_segmentation_dataset, default_segmentation_trainer, get_data_loader
from .utils.io import load_data, write_data
from .utils.prediction import predict_with_halo, predict_with_padding
from .utils.util import get_trainer


def _get_training_parser(description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-i", "--training_inputs", required=True, type=str, nargs="+",
                        help="The input file path(s): image formats (tif, png, ...) or container "
                        "formats (hdf5, zarr) with 'training_input_key'.")
    parser.add_argument("-l", "--training_labels", required=True, type=str, nargs="+",
                        help="The label file path(s); see 'training_inputs'.")
    parser.add_argument("-k", "--training_input_key",
                        help="The key (internal path) for the input data (hdf5/zarr) or glob pattern.")
    parser.add_argument("--training_label_key", help="The key for the labels.")
    parser.add_argument("--validation_inputs", type=str, nargs="+",
                        help="Validation inputs; if not given a fraction of the training data is used.")
    parser.add_argument("--validation_labels", type=str, nargs="+", help="Validation labels.")
    parser.add_argument("--validation_input_key", help="The key for the validation inputs.")
    parser.add_argument("--validation_label_key", help="The key for the validation labels.")
    parser.add_argument("-b", "--batch_size", type=int, required=True, help="The batch size.")
    parser.add_argument("-p", "--patch_shape", type=int, nargs="+", required=True,
                        help="The training patch shape")
    parser.add_argument("-n", "--n_iterations", type=int, default=25000,
                        help="The number of iterations to train for.")
    parser.add_argument("-m", "--label_mode",
                        help="Label transformation: 'affinities', 'affinities_and_foreground', "
                        "'boundaries', 'boundaries_and_foreground', 'foreground'.")
    parser.add_argument("--name", help="The name of the trained model (checkpoint).")
    parser.add_argument("--train_fraction", type=float, default=0.8,
                        help="Fraction of data used for training when no validation data is given.")
    parser.add_argument("-d", "--device", default="cuda", help="The device to train on (cuda, cpu).")
    return parser


def _get_offsets(ndim, scale_factors):
    """Default affinity offset ladders (torch-em cli.py:74-91)."""
    if ndim == 2:
        return [[-1, 0], [0, -1], [-3, 0], [0, -3], [-9, 0], [0, -9], [-27, 0], [0, -27]]
    if ndim == 3 and scale_factors is None:
        return [
            [-1, 0, 0], [0, -1, 0], [0, 0, -1],
            [-3, 0, 0], [0, -3, 0], [0, 0, -3],
            [-9, 0, 0], [0, -9, 0], [0, 0, -9],
            [-27, 0, 0], [0, -27, 0], [0, 0, -27],
        ]
    return [
        [-1, 0, 0], [0, -1, 0], [0, 0, -1],
        [-2, 0, 0], [0, -3, 0], [0, 0, -3],
        [-3, 0, 0], [0, -9, 0], [0, 0, -9],
        [-4, 0, 0], [0, -27, 0], [0, 0, -27],
    ]


class _Subset(Dataset):
    """Index-subset of a dataset (replaces torch random_split); its ``init_kwargs`` let a
    trainer checkpoint rebuild the split."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = [int(i) for i in indices]
        self.ndim = dataset.ndim
        self.raw_transform = getattr(dataset, "raw_transform", None)
        self.init_kwargs = {"dataset": dataset, "indices": self.indices}

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def _random_split(ds, fractions):
    """Random train/val split (torch-em cli.py:95-113)."""
    n = len(ds)
    n_train = int(round(fractions[0] * n))
    perm = np.random.permutation(n)
    return _Subset(ds, perm[:n_train]), _Subset(ds, perm[n_train:])


def _get_loader(input_paths, input_key, label_paths, label_key, args, ndim, perform_split=False):
    label_transform, label_transform2 = None, None
    scale_factors = getattr(args, "scale_factors", None)
    if isinstance(scale_factors, str):
        scale_factors = json.loads(scale_factors)

    label_modes = ("affinities", "affinities_and_foreground", "boundaries",
                   "boundaries_and_foreground", "foreground")
    if args.label_mode is None:
        pass
    elif args.label_mode == "affinities":
        label_transform = transforms.AffinityTransform(
            offsets=_get_offsets(ndim, scale_factors), add_binary_target=False, add_mask=True,
        )
    elif args.label_mode == "affinities_and_foreground":
        label_transform = transforms.AffinityTransform(
            offsets=_get_offsets(ndim, scale_factors), add_binary_target=True, add_mask=True,
        )
    elif args.label_mode == "boundaries":
        label_transform = transforms.BoundaryTransform(add_binary_target=False)
    elif args.label_mode == "boundaries_and_foreground":
        label_transform = transforms.BoundaryTransform(add_binary_target=True)
    elif args.label_mode == "foreground":
        label_transform = transforms.labels_to_binary
    else:
        raise ValueError(f"Unknown label mode {args.label_mode}, expect one of {label_modes}")

    patch_shape = args.patch_shape
    if ndim == 2:
        if len(patch_shape) != 2 and patch_shape[0] != 1:
            raise ValueError(f"Invalid patch_shape {patch_shape} for 2d data.")
    elif ndim == 3:
        if len(patch_shape) != 3:
            raise ValueError(f"Invalid patch_shape {patch_shape} for 3d data.")
    else:
        raise RuntimeError(f"Invalid ndim: {ndim}")

    input_paths = input_paths[0] if len(input_paths) == 1 else input_paths
    label_paths = label_paths[0] if len(label_paths) == 1 else label_paths
    ds = default_segmentation_dataset(
        input_paths, input_key, label_paths, label_key,
        patch_shape=patch_shape, ndim=ndim,
        label_transform=label_transform, label_transform2=label_transform2,
    )

    n_workers = min(multiprocessing.cpu_count(), 8)
    if perform_split:
        fractions = [args.train_fraction, 1.0 - args.train_fraction]
        ds_train, ds_val = _random_split(ds, fractions)
        train_loader = get_data_loader(ds_train, batch_size=args.batch_size,
                                                shuffle=True, num_workers=n_workers)
        val_loader = get_data_loader(ds_val, batch_size=args.batch_size,
                                              shuffle=True, num_workers=n_workers)
        return train_loader, val_loader
    return get_data_loader(ds, batch_size=args.batch_size, shuffle=True,
                                    num_workers=n_workers)


def _get_loaders(args, ndim):
    if args.validation_inputs is None:
        print("You haven't provided validation data so the validation set will be split off the input data.")
        print(f"A fraction of {args.train_fraction} will be used for training "
              f"and {1 - args.train_fraction} for val.")
        return _get_loader(
            args.training_inputs, args.training_input_key, args.training_labels,
            args.training_label_key, args=args, ndim=ndim, perform_split=True,
        )
    train_loader = _get_loader(
        args.training_inputs, args.training_input_key, args.training_labels,
        args.training_label_key, args=args, ndim=ndim,
    )
    val_loader = _get_loader(
        args.validation_inputs, args.validation_input_key, args.validation_labels,
        args.validation_label_key, args=args, ndim=ndim,
    )
    return train_loader, val_loader


def _determine_channels(train_loader, args):
    x, y = next(iter(train_loader))
    out_channels = y.shape[1]
    if args.label_mode is not None and "affinities" in args.label_mode:
        # the affinity targets carry their masks as extra channels, which the loss removes
        # (ApplyAndRemoveMask); the JAX package's CLI counts them as outputs and fails there
        out_channels //= 2
    return x.shape[1], out_channels


def _get_loss(label_mode):
    if label_mode is not None and "affinities" in label_mode:
        # masked dice for affinity training (torch-em cli.py:222-228)
        return losses.LossWrapper(
            losses.DiceLoss(), transform=losses.ApplyAndRemoveMask(masking_method="multiply"),
        )
    return losses.DiceLoss()


def train_2d_unet():
    """@private"""
    parser = _get_training_parser("Train a 2D UNet.")
    args = parser.parse_args()
    train_loader, val_loader = _get_loaders(args, ndim=2)
    in_channels, out_channels = _determine_channels(train_loader, args)
    model = UNet2d(in_channels, out_channels, device=args.device)
    loss = _get_loss(args.label_mode)
    name = f"2d-unet-training-{uuid.uuid1()}" if args.name is None else args.name
    print("Start 2d unet training for", name)
    trainer = default_segmentation_trainer(
        name=name, model=model, train_loader=train_loader, val_loader=val_loader,
        loss=loss, metric=loss, compile_model=False, device=args.device,
    )
    trainer.fit(args.n_iterations)


def train_3d_unet():
    """@private"""
    parser = _get_training_parser("Train a 3D UNet.")
    parser.add_argument("-s", "--scale_factors", type=str,
                        help="JSON-encoded scale factors, e.g. '[[1,2,2],[2,2,2],[2,2,2]]' "
                        "for anisotropic scaling; isotropic 3D U-Net if not given.")
    args = parser.parse_args()
    scale_factors = None if args.scale_factors is None else json.loads(args.scale_factors)
    train_loader, val_loader = _get_loaders(args, ndim=3)
    in_channels, out_channels = _determine_channels(train_loader, args)
    if scale_factors is None:
        model = UNet3d(in_channels, out_channels, device=args.device)
    else:
        model = AnisotropicUNet(in_channels, out_channels, scale_factors, device=args.device)
    loss = _get_loss(args.label_mode)
    name = f"3d-unet-training-{uuid.uuid1()}" if args.name is None else args.name
    print("Start 3d unet training for", name)
    trainer = default_segmentation_trainer(
        name=name, model=model, train_loader=train_loader, val_loader=val_loader,
        loss=loss, metric=loss, compile_model=False, device=args.device,
    )
    trainer.fit(args.n_iterations)


#
# CLI for prediction
#

def _get_prediction_parser(description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-c", "--checkpoint", required=True,
                        help="The model checkpoint to use for prediction.")
    parser.add_argument("-i", "--input_path", required=True, help="The input path.")
    parser.add_argument("-k", "--input_key", help="The key (path in file) of the input data.")
    parser.add_argument("-o", "--output_path", required=True,
                        help="The path where to save the prediction.")
    parser.add_argument("--output_key", help="The key for saving the output.")
    parser.add_argument("-p", "--preprocess", default="standardize")
    parser.add_argument("--chunks", nargs="+", type=int, help="Chunks for container outputs.")
    parser.add_argument("--compression", help="Compression for container outputs.")
    return parser


def _prediction(args, predict, device):
    model = get_trainer(args.checkpoint, device=device).model

    input_ = load_data(args.input_path, args.input_key)
    pred = predict(model, input_)
    pred = np.asarray(pred)

    if args.output_key is None:
        write_data(args.output_path, None, pred.squeeze())
    else:
        chunks = tuple(args.chunks) if args.chunks is not None else None
        write_data(args.output_path, args.output_key, pred, chunks=chunks)


def predict():
    """@private"""
    parser = _get_prediction_parser("Run prediction (with padding if necessary).")
    parser.add_argument("--min_divisible", nargs="+", type=int,
                        help="Minimal divisible factors for the input shape.")
    parser.add_argument("-d", "--device", default="cuda", help="The device (cuda, cpu) to use for prediction.")
    args = parser.parse_args()

    preprocess = getattr(transforms.raw, args.preprocess)
    device = args.device

    def predict_fn(model, input_):
        data = preprocess(np.asarray(input_[:]))
        if args.min_divisible is None:
            with torch.inference_mode():
                pred = model(torch.from_numpy(np.ascontiguousarray(data[None, None])).to(device))
            return pred.float().cpu().numpy().squeeze()
        return predict_with_padding(model, data, tuple(args.min_divisible), device).squeeze()

    _prediction(args, predict_fn, device)


def _pred_2d(model, input_):
    assert input_.shape[2] == 1
    pred = model(input_[:, :, 0])
    return pred[:, :, None]


def predict_with_tiling():
    """@private"""
    parser = _get_prediction_parser("Run prediction over tiled input.")
    parser.add_argument("-b", "--block_shape", nargs="+", required=True, type=int,
                        help="The shape of the blocks used to tile the input.")
    parser.add_argument("--halo", nargs="+", type=int, help="The overlap of the tiles.")
    parser.add_argument("-d", "--devices", nargs="+", default=["cuda"], help="The devices used for prediction.")
    args = parser.parse_args()

    block_shape = args.block_shape
    preprocess = getattr(transforms.raw, args.preprocess)
    halo = args.halo if args.halo is not None else [0] * len(block_shape)
    assert len(halo) == len(block_shape)
    devices = args.devices
    pred_function = _pred_2d if block_shape[0] == 1 else None

    def predict_fn(model, input_):
        return predict_with_halo(
            input_, model, gpu_ids=devices, block_shape=block_shape, halo=halo,
            prediction_function=pred_function, preprocess=preprocess,
        )

    _prediction(args, predict_fn, devices[0])
