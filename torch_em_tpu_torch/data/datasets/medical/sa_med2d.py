"""SA-Med2D-20M dataset: multi-modality biomedical segmentation at scale
(3.7M images / 15.8M masks in the current release) — reference
torch_em/data/datasets/medical/sa_med2d.py.

Hosted at https://huggingface.co/datasets/OpenGVLab/SA-Med2D-20M; publications
https://arxiv.org/abs/2311.11969 and https://doi.org/10.48550/arXiv.2308.16184.

Download is manual (multi-part zip, ~1.5 TB deflated): fetch the
``SA-Med2D-16M.z01..z10`` + ``SA-Med2D-16M.zip`` parts from the HuggingFace
``raw/`` folder and merge them with
``zip SA-Med2D-16M.zip SA-Med2D-16M.z0* SA-Med2D-16M.z10 -s=0 --out data.zip``.
Preprocessing then shards each sub-dataset into h5 files of 512x512
longest-side-resized images ('raw' (3, N, 512, 512)) and merged instance
masks ('labels' (N, 512, 512)).
"""

import json
import os
import shutil
import zipfile
from glob import glob
from math import ceil
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....transforms.generic import ResizeLongestSideInputs
from ....utils.io import _h5py, load_image
from .. import util

DATASET_NAMES = [
    "ACDC", "AMOS2022", "ATM2022", "AbdomenCT1K", "ASC18", "COSMOS2022",
    "BTCV", "BTCV_Cervix", "BraTS2013", "BraTS2015", "BraTS2018", "BraTS2019",
    "BraTS2020", "BraTS2021", "Brain_PTM", "CAD_PE", "CHAOS_Task_4",
    "CMRxMotions", "COVID19CTscans", "COVID-19-20", "covid_19_ct_cxr", "crass",
    "CTPelvic1k", "CTSpine1K_Full", "cvc_clinicdb", "Chest_Image_Pneum",
    "cranium", "CrossMoDA21", "CrossMoDA22", "EMIDEC", "endovis15", "FLARE21",
    "FLARE22", "fusc2021", "hvsmr_2016", "Heart_Seg_MRI",
    "ichallenge_adam_task2", "PALM19", "gamma", "gamma3", "ISLES_SPES",
    "ISLES_SISS", "ISLES2016", "ISLES2017", "ISLES2018", "ISLES2022",
    "Instance22", "KiTS", "KiTS2021", "LNDb", "LUNA16",
    "LongitudinalMultipleSclerosisLesionSegmentation", "mnms2", "MMWHS",
    "BrainTumour", "MSD_Heart", "MSD_Liver", "MSD_Prostate", "MSD_Lung",
    "MSD_Pancreas", "MSD_HepaticVessel", "MSD_Spleen", "MSD_Colon", "CT_ORG",
    "picai_baseline", "picai_semi", "Promise09", "PROMISE12", "Parse22",
    "chest_x_ray_images_with_pneumothorax_masks",
    "Prostate_MRI_Segmentation_Dataset", "Pulmonary_Chest_X-Ray_Abnormalities_seg",
    "QUBIQ2020", "StructSeg2019_subtask1", "StructSeg2019_subtask2",
    "Totalsegmentator_dataset", "ultrasound_nerve_segmentation", "VESSEL2012",
    "VerSe20", "VerSe19", "WORD", "autoPET", "braimMRI",
    "breast_ultrasound_images_dataset", "kvasircapsule_seg", "sz_cxr",
    "EndoVis_2017_RIS", "kvasir_seg", "isic2018_task1", "isic2017_task1",
    "isic2016_task1",
]

MODALITY_NAMES = [
    # CT
    "ct_00", "ct_cbf", "ct_cbv", "ct_mtt", "ct_tmax",
    # RGB-image
    "dermoscopy_00", "endoscopy_00", "fundus_photography",
    # MRI
    "mr_00", "mr_adc", "mr_cbf", "mr_cbv", "mr_cmr", "mr_dwi",
    "mr_flair", "mr_hbv", "mr_lge", "mr_mprage", "mr_mtt",
    "mr_pd", "mr_rcbf", "mr_rcbv", "mr_t1", "mr_t1c", "mr_t1ce",
    "mr_t1gd", "mr_t1w", "mr_t2", "mr_t2w", "mr_tmax", "mr_ttp",
    # mono-channel
    "pet_00", "ultrasound_00", "x_ray",
]

# datasets under 1000 samples
SMALL_DATASETS = [
    "crass", "covid_19_ct_cxr", "cvc_clinicdb", "cranium", "CrossMoDA21", "EMIDEC",
    "endovis15", "fusc2021", "Heart_Seg_MRI", "ichallenge_adam_task2", "gamma", "gamma3",
    "Instance22", "LNDb", "MSD_Heart", "MSD_Prostate", "MSD_Spleen", "MSD_Colon",
    "picai_baseline", "picai_semi", "Promise09", "PROMISE12",
    "Pulmonary_Chest_X-Ray_Abnormalities_seg",
    "QUBIQ2020", "breast_ultrasound_images_dataset", "kvasircapsule_seg", "sz_cxr", "kvasir_seg",
]

SHARD_SIZE = 50000  # maximum images per dataset container file


def _process_each_image(image_path, data, dataset_name, data_dir, raw_transform, label_transform):
    from ....ops.host import relabel_consecutive

    image = np.asarray(load_image(image_path))
    if image.ndim == 3:
        image = image.transpose(2, 0, 1)
    else:
        assert image.ndim == 2, image.ndim
        image = np.stack([image] * 3, axis=0)
    shape = image.shape[1:]

    image_fname = f"images/{os.path.basename(image_path)}"
    instances = np.zeros(shape, dtype="uint8")

    for idx, gt_fname in enumerate(sorted(data.get(image_fname, [])), start=1):
        # skip the whole-ventricular-cavity roi in ACDC (reference HACK)
        if dataset_name == "ACDC" and "0003_000" in gt_fname and len(data[image_fname]) > 1:
            continue
        gt_mask = np.asarray(load_image(os.path.join(data_dir, "SAMed2Dv1", gt_fname)))
        if gt_mask.shape != shape:
            print("Skipping these images with mismatching ground-truth shapes.")
            continue
        # optic disc is mapped as 0, background as 1 (reference HACK)
        if dataset_name == "ichallenge_adam_task2":
            gt_mask = (gt_mask == 0).astype("uint8")
        instances[gt_mask > 0] = idx

    # require at least one foreground object and non-constant raw data
    if len(np.unique(instances)) > 1 and len(np.unique(image)) > 1:
        instances, _, _ = relabel_consecutive(instances)
        return raw_transform(image), label_transform(instances)
    return None


def _preprocess_data(path):
    h5py = _h5py()

    data_dir = os.path.join(str(path), "data")
    if os.path.exists(data_dir):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)

    zip_path = os.path.join(str(path), "data.zip")  # hard-coded archive name
    if not os.path.exists(zip_path):
        raise FileNotFoundError(
            f"The combined zip file does not exist under the file name 'data.zip' at '{path}'. "
            "Please see 'get_sa_med2d_data' for details.")

    with zipfile.ZipFile(zip_path, "r") as f:
        all_members = f.namelist()
        f.extractall(path=data_dir, members=[m for m in all_members if m.endswith(".json")])
        with open(os.path.join(data_dir, "SAMed2Dv1", "SAMed2D_v1.json")) as j:
            data = json.load(j)

        raw_transform = ResizeLongestSideInputs(target_shape=(512, 512), is_rgb=True)
        label_transform = ResizeLongestSideInputs(target_shape=(512, 512), is_label=True)

        for dataset_name in DATASET_NAMES:
            if len(glob(os.path.join(data_dir, f"{dataset_name}*.h5"))) > 0:
                continue
            f.extractall(path=data_dir, members=[m for m in all_members if dataset_name in m])

            image_paths = util.natsorted(glob(os.path.join(data_dir, "SAMed2Dv1", "images", "*")))
            num_shards = ceil(len(image_paths) / SHARD_SIZE)

            for shard_idx in range(num_shards):
                shard_image_paths = image_paths[shard_idx * SHARD_SIZE:(shard_idx + 1) * SHARD_SIZE]
                shard_fpath = os.path.join(data_dir, f"{dataset_name}_{shard_idx:02d}.h5")
                if os.path.exists(shard_fpath):
                    continue

                with h5py.File(shard_fpath, "w") as h:
                    raw_ds = h.create_dataset(
                        "raw", shape=(3, 0, 512, 512), maxshape=(3, None, 512, 512),
                        chunks=(3, 1, 512, 512), compression="lzf")
                    label_ds = h.create_dataset(
                        "labels", shape=(0, 512, 512), maxshape=(None, 512, 512),
                        chunks=(1, 512, 512), compression="lzf")
                    curr_len = 0
                    for image_path in shard_image_paths:
                        result = _process_each_image(
                            image_path, data, dataset_name, data_dir, raw_transform, label_transform)
                        if result is None:
                            continue
                        image_transformed, label_transformed = result
                        raw_ds.resize((3, curr_len + 1, 512, 512))
                        label_ds.resize((curr_len + 1, 512, 512))
                        raw_ds[:, curr_len] = image_transformed
                        label_ds[curr_len] = label_transformed
                        curr_len += 1

            shutil.rmtree(os.path.join(data_dir, "SAMed2Dv1", "images"), ignore_errors=True)
            shutil.rmtree(os.path.join(data_dir, "SAMed2Dv1", "masks"), ignore_errors=True)

    shutil.rmtree(os.path.join(data_dir, "SAMed2Dv1"), ignore_errors=True)
    return data_dir


def get_sa_med2d_data(path: Union[os.PathLike, str], download: bool = False) -> str:
    """Locate + preprocess SA-Med2D-20M (manual multi-part download; see the
    module docstring for the wget + zip-merge recipe)."""
    if download:
        print("Download is not supported, as the data is huge and takes quite a while to download and extract.")
    return _preprocess_data(path)


def get_sa_med2d_paths(path: Union[os.PathLike, str], download: bool = False) -> List[str]:
    """Paths to the preprocessed SA-Med2D shard h5 files."""
    data_dir = get_sa_med2d_data(path, download)
    return util.natsorted(glob(os.path.join(data_dir, "*.h5")))


def get_sa_med2d_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                         download: bool = False, **kwargs):
    """Dataset over the SA-Med2D-20M shards for medical image segmentation."""
    input_paths = get_sa_med2d_paths(path, download)
    return default_segmentation_dataset(
        raw_paths=input_paths, raw_key="raw",
        label_paths=input_paths, label_key="labels",
        patch_shape=patch_shape, ndim=2, with_channels=True,
        is_seg_dataset=True, verify_paths=False, **kwargs,
    )


def get_sa_med2d_loader(path: Union[os.PathLike, str], batch_size: int,
                        patch_shape: Tuple[int, int], download: bool = False,
                        **kwargs) -> DataLoader:
    """DataLoader over the SA-Med2D-20M shards."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_sa_med2d_dataset(path, patch_shape, download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
