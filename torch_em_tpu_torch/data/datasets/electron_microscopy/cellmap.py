"""CellMap Segmentation Challenge dataset: organelle segmentation crops in EM
across several species (reference
torch_em/data/datasets/electron_microscopy/cellmap.py).

- Challenge: https://cellmapchallenge.janelia.org/
- Toolbox: https://github.com/janelia-cellmap/cellmap-segmentation-challenge
- Data DOI: https://doi.org/10.25378/janelia.c.7456966

Downloading requires the optional ``cellmap_segmentation_challenge`` package,
whose crop manifest + remote zarr readers drive the fetch (the reference's
download path stays close to the upstream ``csc fetch-data`` CLI for the same
reason). Crops are cached as ``crop_<id>.h5`` files with keys ``raw_crop``
and ``label_crop/<organelle>`` (unannotated voxels labelled -1).
"""

import os
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _h5py, open_container
from .. import util


def _download_cellmap_data(path, crops, resolution, padding, download=False):
    """Fetch CellMap crops via the challenge toolbox and cache them as h5.

    Mirrors the upstream ``csc fetch-data`` CLI behavior: resolve the crop
    manifest, match EM and GT resolution levels by scale, cut the EM region
    around each GT crop (+padding voxels, unannotated padding labelled -1),
    and store raw + per-organelle label volumes per crop.
    """
    h5py = _h5py()

    # explicit crop lists that are fully cached need neither the manifest nor
    # the (optional) challenge toolbox
    if crops not in ("all", "test"):
        crop_ids = [int(x) for x in crops.split(",")]
        if all(os.path.exists(os.path.join(path, f"crop_{c}.h5")) for c in crop_ids):
            return path, crop_ids

    try:
        from cellmap_segmentation_challenge.utils.fetch_data import read_group, subset_to_slice
        from cellmap_segmentation_challenge.utils.crops import fetch_crop_manifest, get_test_crops, TestCropRow
        from xarray import DataArray
        from xarray_ome_ngff import read_multiscale_group
        from xarray_ome_ngff.v04.multiscale import transforms_from_coords
    except ImportError:
        raise ModuleNotFoundError(
            "Please install the 'cellmap_segmentation_challenge' package: "
            "'pip install git+https://github.com/janelia-cellmap/cellmap-segmentation-challenge.git'."
        )

    array_wrapper = {"name": "dask_array", "config": {"chunks": "auto"}}
    os.makedirs(path, exist_ok=True)

    manifest = fetch_crop_manifest()
    if crops == "all":
        crops_parsed = manifest
    elif crops == "test":
        crops_parsed = get_test_crops()
    else:
        crop_ids = tuple(int(x) for x in crops.split(","))
        crops_parsed = tuple(c for c in manifest if c.id in crop_ids)
    if len(crops_parsed) == 0:
        return path, []

    all_crops = []
    for crop in crops_parsed:
        all_crops.append(crop.id)
        crop_path = os.path.join(path, f"crop_{crop.id}.h5")
        if os.path.exists(crop_path):
            continue
        if not download:
            raise RuntimeError(f"Cannot download crop '{crop.id}' as download=False.")

        is_test = isinstance(crop.gt_source, TestCropRow)
        label_names, gt_group, gt_level, gt_translation = [], None, None, None

        em_group = read_group(str(crop.em_url), storage_options={"anon": True})
        em_arrays = read_multiscale_group(em_group, array_wrapper)
        em_resolutions = {}
        for res_key, array in em_arrays.items():
            try:
                _, (em_scale, em_trans) = transforms_from_coords(array.coords, transform_precision=4)
                em_resolutions[res_key] = (em_scale.scale, em_trans.translation)
            except Exception:
                continue

        if is_test:
            # match the EM level whose scale covers the GT voxel size
            em_level = next((k for k, (scale, _) in em_resolutions.items()
                             if all(s / vs > 0.8 for s, vs in zip(scale, crop.gt_source.voxel_size))), None)
            assert em_level is not None
            scale = em_resolutions[em_level][0]
            em_array = em_arrays[em_level]
            starts = crop.gt_source.translation
            stops = tuple(st + sz * vs for st, sz, vs
                          in zip(starts, crop.gt_source.shape, crop.gt_source.voxel_size))
            coords = em_array.coords.copy()
            for k, v in zip(em_array.coords.keys(), np.array((starts, stops)).T):
                coords[k] = v
            slices = subset_to_slice(outer_array=em_array,
                                     inner_array=DataArray(dims=em_array.dims, coords=coords))
        else:
            gt_group = read_group(str(crop.gt_source), storage_options={"anon": True})
            fs, store_path = gt_group.store.fs, gt_group.store.path
            inventory = np.unique([fn.split(store_path)[-1][1:].split("/")[0]
                                   for fn in fs.find(store_path)]).tolist()
            label_names = [n for n in inventory if n not in (".zattrs", ".zgroup")]

            crop_ms = None
            for _, group in gt_group.groups():
                try:
                    crop_ms = read_multiscale_group(group, array_wrapper=array_wrapper)
                    break
                except (ValueError, TypeError):
                    continue
            if crop_ms is None:
                continue

            gt_resolutions = {}
            for res_key, array in crop_ms.items():
                try:
                    _, (gt_scale, gt_trans) = transforms_from_coords(array.coords, transform_precision=4)
                    gt_resolutions[res_key] = (gt_scale.scale, gt_trans.translation)
                except Exception:
                    continue
            matching = [(gk, ek, gs, gt, et)
                        for gk, (gs, gt) in gt_resolutions.items()
                        for ek, (es, et) in em_resolutions.items()
                        if np.allclose(gs, es, rtol=1e-3, atol=1e-6)]
            if not matching:
                continue
            matching.sort(key=lambda x: np.prod(x[2]))
            gt_level, em_level, scale, gt_translation, em_translation = matching[0]
            em_array = em_arrays[em_level]
            gt_shape = gt_group[f"all/{gt_level}"].shape  # "all" always exists
            starts = gt_translation
            stops = [st + sz * vs for st, sz, vs in zip(starts, gt_shape, scale)]
            em_starts = [int(round((p - em_translation[i]) / scale[i])) for i, p in enumerate(starts)]
            em_stops = [int(round((p - em_translation[i]) / scale[i])) for i, p in enumerate(stops)]
            slices = tuple(slice(a, b) for a, b in zip(em_starts, em_stops))

        slices_padded = tuple(
            slice(max(0, sl.start - padding), min(sl.stop + padding, dim), sl.step)
            for sl, dim in zip(slices, em_array.shape)
        )
        em_crop = em_array[tuple(slices_padded)].data.compute()

        with h5py.File(crop_path, "w") as f:
            f.attrs["crop_id"] = crop.id
            f.attrs["scale"] = scale
            f.attrs["em_level"] = em_level
            if gt_level is not None:
                f.attrs["translation"] = gt_translation
                f.attrs["gt_level"] = gt_level
            f.create_dataset("raw_crop", data=em_crop, compression="gzip")
            if gt_level is not None:
                pad_width = [(max(0, orig.start - padded.start), max(0, padded.stop - orig.stop))
                             for orig, padded in zip(slices, slices_padded)]
                for name in label_names:
                    gt_crop = gt_group[f"{name}/{gt_level}"][:]
                    gt_crop = np.pad(gt_crop.astype(np.int16), pad_width,
                                     mode="constant", constant_values=-1)
                    f.create_dataset(f"label_crop/{name}", data=gt_crop, compression="gzip")

    return path, all_crops


def get_cellmap_data(path: Union[os.PathLike, str], crops: Union[str, Sequence[str]] = "all",
                     resolution: str = "s0", padding: int = 64,
                     download: bool = False) -> Tuple[str, List[str]]:
    """Download CellMap crops; returns (crop folder, crop ids)."""
    data_path = os.path.join(str(path), "data_crops")
    os.makedirs(data_path, exist_ok=True)
    if isinstance(crops, Sequence) and not isinstance(crops, str):
        crops = ",".join(str(c) for c in crops)
    _data_path, final_crops = _download_cellmap_data(
        path=data_path, crops=crops, resolution=resolution, padding=padding, download=download)
    if _data_path is None or len(_data_path) == 0:
        raise RuntimeError("The CellMap download did not produce any data.")
    assert len(final_crops) > 0, "There seems to be no valid crops in the list."
    return data_path, final_crops


def get_cellmap_paths(path: Union[os.PathLike, str],
                      organelles: Optional[Union[str, List[str]]] = None,
                      crops: Union[str, Sequence[str]] = "all", resolution: str = "s0",
                      voxel_size: Optional[Tuple[float]] = None, padding: int = 64,
                      download: bool = False, return_test_crops: bool = False) -> List[str]:
    """Paths to cached CellMap crop h5 files, filtered by organelle and voxel size."""
    if not return_test_crops and ("test" in crops if isinstance(crops, (list, tuple)) else crops == "test"):
        raise NotImplementedError("The 'test' crops cannot be used in the dataloader.")

    data_path, crop_ids = get_cellmap_data(path=path, crops=crops, resolution=resolution,
                                           padding=padding, download=download)
    volume_paths = [os.path.join(data_path, f"crop_{c}.h5") for c in crop_ids]

    if organelles is None:
        organelles = "all"
    if isinstance(organelles, str):
        organelles = [organelles]

    filtered = []
    for organelle in organelles:
        if organelle != "all":
            warnings.warn(
                f"You have chosen '{organelle}' annotations instead of 'all'; correct masks "
                "are not guaranteed — we suggest 'all' labels with the corresponding label ids."
            )
        for vpath in volume_paths:
            if f"label_crop/{organelle}" in open_container(vpath) and vpath not in filtered:
                filtered.append(vpath)
    if len(filtered) == 0:
        raise ValueError(f"'{organelles}' are not valid organelle(s) found in the crops: '{crop_ids}'.")

    if voxel_size is not None:
        filtered = [vpath for vpath in filtered
                    if np.all(np.array(voxel_size) == open_container(vpath).attrs["scale"])]
        if len(filtered) == 0:
            raise ValueError(f"'{voxel_size}' is not a valid voxel size found in the crops.")

    for volume_path in filtered:
        if not os.path.exists(volume_path):
            raise FileNotFoundError(f"The volume '{volume_path}' could not be found.")
    return filtered


def get_cellmap_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, ...],
                        organelles: Optional[Union[str, List[str]]] = None,
                        crops: Union[str, Sequence[str]] = "all", resolution: str = "s0",
                        voxel_size: Optional[Tuple[float]] = None, padding: int = 64,
                        download: bool = False, **kwargs):
    """Dataset over CellMap crops for organelle segmentation."""
    volume_paths = get_cellmap_paths(path=path, organelles=organelles, crops=crops,
                                     resolution=resolution, voxel_size=voxel_size,
                                     padding=padding, download=download)
    if organelles is None:
        organelles = "label_crop/all"
    elif isinstance(organelles, str):
        organelles = f"label_crop/{organelles}"
    else:
        organelles = [f"label_crop/{o}" for o in organelles]
        kwargs = util.update_kwargs(kwargs, "with_label_channels", True)

    return default_segmentation_dataset(
        raw_paths=volume_paths, raw_key="raw_crop",
        label_paths=volume_paths, label_key=organelles,
        patch_shape=patch_shape, is_seg_dataset=True, **kwargs,
    )


def get_cellmap_loader(path: Union[os.PathLike, str], batch_size: int,
                       patch_shape: Tuple[int, ...],
                       organelles: Optional[Union[str, List[str]]] = None,
                       crops: Union[str, Sequence[str]] = "all", resolution: str = "s0",
                       voxel_size: Optional[Tuple[float]] = None, padding: int = 64,
                       download: bool = False, **kwargs) -> DataLoader:
    """DataLoader over CellMap crops for organelle segmentation."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_cellmap_dataset(path, patch_shape, organelles, crops, resolution,
                             voxel_size, padding, download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
