"""OrgLine dataset: organoid images and segmentation masks assembled from
several prior publications across organs (intestine, brain, colon, PDAC,
stomach, breast) — reference torch_em/data/datasets/light_microscopy/orgline.py.

Please cite https://zenodo.org/records/16355179 and the relevant original
publications. Stomach/breast ground truth is COCO-encoded: it is decoded by the
port's own ``utils/coco.py`` (pycocotools' mask algorithms in numpy), with no
pycocotools.
"""

import os
import shutil
from glob import glob
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.coco import COCO
from ....utils.io import _h5py, load_image
from .. import util

URL1 = "https://zenodo.org/records/16355179/files/InstanceSeg.zip?download=1"
URL2 = "https://zenodo.org/records/18447547/files/data.zip?download=1"

CHECKSUM1 = "6787dc47ee5f800e7ecf4a51d958fc88591c877ca7f8f03c2aa3e7fa7c4aca50"
CHECKSUM2 = "8b5984ee19232c06cdf5366080a3f3b27fb2109f38a2a345316e22dd2bb9a1c2"

ORGANS1 = ("PDAC", "colon", "Intestine", "brain")
ORGANS2 = ("stomach", "breast")


def _annotations_to_instances(coco, image_metadata):
    from ....ops.host import connected_components, relabel_consecutive

    annotation_ids = coco.getAnnIds(imgIds=image_metadata["id"])
    annotations = coco.loadAnns(annotation_ids)
    assert len(annotations) <= np.iinfo("uint16").max
    seg = np.zeros((image_metadata["height"], image_metadata["width"]), dtype="uint32")

    # paste larger organoids first so small ones stay on top
    annotations = [annotations[i] for i in np.argsort([ann["area"] for ann in annotations])]
    for seg_id, annotation in enumerate(annotations, 1):
        mask = coco.annToMask(annotation).astype(bool)
        assert mask.shape == seg.shape
        seg[mask] = seg_id

    # filter out small pieces left over from pasting organoids on top of each other;
    # value-aware CC (per instance id, skimage.measure.label semantics) so touching
    # organoids with distinct ids stay separate
    min_size = 25
    cc = np.zeros_like(seg)
    offset = 0
    for val in np.unique(seg):
        if val == 0:
            continue
        sub = connected_components(seg == val)
        mask = sub > 0
        cc[mask] = sub[mask] + offset
        offset = cc.max()
    seg = cc
    seg_ids, sizes = np.unique(seg, return_counts=True)
    seg[np.isin(seg, seg_ids[sizes < min_size])] = 0
    seg = relabel_consecutive(seg)[0]
    return seg.astype("uint16")


def _prepare_data(data_dir, organ):
    h5py = _h5py()

    if organ in ORGANS1:
        for org in ORGANS1:
            input_root = os.path.join(data_dir, "InstanceSeg", org)
            output_root = os.path.join(data_dir, org)
            for split in ("train", "val", "test"):
                images = sorted(glob(os.path.join(input_root, split, "images", "*")))
                masks = sorted(glob(os.path.join(input_root, split, "masks", "*")))
                if len(images) != len(masks):
                    continue
                output_folder = os.path.join(output_root, split)
                os.makedirs(output_folder, exist_ok=True)
                for im_path, mask_path in zip(images, masks):
                    im = np.asarray(load_image(im_path))
                    mask = np.load(mask_path) if mask_path.endswith(".npy") \
                        else np.asarray(load_image(mask_path))
                    if im.ndim == 3:
                        im = im[..., 0]
                    assert im.shape == mask.shape
                    out_path = os.path.join(output_folder, f"{os.path.basename(im_path)}.h5")
                    with h5py.File(out_path, mode="w") as f:
                        f.create_dataset("image", data=im, compression="gzip")
                        f.create_dataset("masks", data=mask, compression="gzip")
        shutil.rmtree(os.path.join(data_dir, "InstanceSeg"))
    else:
        for org in ORGANS2:
            input_root = output_root = os.path.join(data_dir, org)
            coco = COCO(os.path.join(input_root, "coco.json"))
            image_ids = coco.getImgIds()

            # 80/8/12 splits with a fixed seed (matches the reference's
            # sklearn train_test_split(test_size=.2) then (test_size=.6))
            rng = np.random.RandomState(42)
            ids = np.array(image_ids)
            perm = rng.permutation(len(ids))
            n_holdout = int(round(0.2 * len(ids)))
            holdout = set(ids[perm[:n_holdout]].tolist())
            perm2 = rng.permutation(n_holdout)
            n_val = int(round(0.6 * n_holdout))
            val_ids = set(np.array(sorted(holdout))[perm2[:n_val]].tolist())

            for split in ("train", "val", "test"):
                os.makedirs(os.path.join(output_root, split), exist_ok=True)
            for image_id in image_ids:
                image_metadata = coco.loadImgs(image_id)[0]
                image_path = os.path.join(input_root, image_metadata["file_name"])
                im = np.asarray(load_image(image_path))
                if im.ndim == 3:
                    im = np.mean(im[..., :3], axis=-1)
                mask = _annotations_to_instances(coco, image_metadata)
                assert im.shape == mask.shape
                if image_id not in holdout:
                    split = "train"
                elif image_id in val_ids:
                    split = "val"
                else:
                    split = "test"
                out_path = os.path.join(output_root, split, f"{os.path.basename(image_path)}.h5")
                with h5py.File(out_path, mode="w") as f:
                    f.create_dataset("image", data=im, compression="gzip")
                    f.create_dataset("masks", data=mask, compression="gzip")

            shutil.rmtree(os.path.join(input_root, "images"), ignore_errors=True)
            for json_file in glob(os.path.join(input_root, "*.json")):
                os.remove(json_file)


def get_orgline_data(path: Union[os.PathLike, str], organ: str, download: bool = False) -> str:
    """Download and prepare the OrgLine data for an organ."""
    if organ in ORGANS1:
        url, checksum, data_folder = URL1, CHECKSUM1, "data1"
    elif organ in ORGANS2:
        url, checksum, data_folder = URL2, CHECKSUM2, "data2"
    else:
        raise ValueError(f"Invalid organ: {organ}. Must be one of {ORGANS1 + ORGANS2}.")

    data_dir = os.path.join(str(path), data_folder)
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    zip_path = os.path.join(data_dir, "data.zip")
    util.download_source(path=zip_path, url=url, download=download, checksum=checksum)
    util.unzip(zip_path=zip_path, dst=data_dir, remove=True)
    _prepare_data(data_dir, organ)
    return data_dir


def get_orgline_paths(path: Union[os.PathLike, str], split: str,
                      organs: Optional[Union[str, Sequence[str]]] = None,
                      download: bool = False) -> List[str]:
    """Paths to the prepared OrgLine h5 files for a split."""
    if isinstance(organs, str):
        organs = [organs]
    elif organs is None:
        organs = ORGANS1 + ORGANS2
    paths = []
    for organ in organs:
        data_dir = get_orgline_data(path, organ, download)
        paths.extend(sorted(glob(os.path.join(data_dir, organ, split, "*.h5"))))
    return paths


def get_orgline_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        split: str, organs: Optional[Union[str, Sequence[str]]] = None,
                        download: bool = False, **kwargs):
    """Dataset for organoid segmentation in brightfield microscopy."""
    paths = get_orgline_paths(path, split, organs, download)
    return default_segmentation_dataset(
        raw_paths=paths, raw_key="image",
        label_paths=paths, label_key="masks",
        is_seg_dataset=True, patch_shape=patch_shape, ndim=2, **kwargs,
    )


def get_orgline_loader(path: Union[os.PathLike, str], batch_size: int,
                       patch_shape: Tuple[int, int], split: str,
                       organs: Optional[Union[str, Sequence[str]]] = None,
                       download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for organoid segmentation in brightfield microscopy."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_orgline_dataset(path, patch_shape, split=split, organs=organs,
                             download=download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
