"""IDR0095 (idr0095-ali-asymmetry): fluorescence microscopy of E. coli cells
with hand-segmented instance masks (reference
torch_em/data/datasets/light_microscopy/idr0095.py).

Phase-contrast frames (channel 0 of Nikon ND2 acquisitions) are paired with
`*-Mask.tif` instance masks; annotations are sparse. Hosted on EBI FTP
(ftp.ebi.ac.uk, accession idr0095); reading ND2 files requires the optional
``nd2`` package. Publication: Ali et al. 2020, https://doi.org/10.7554/eLife.56517.
"""

import ftplib
import os
from glob import glob
from typing import List, Tuple, Union

import numpy as np

from ... import DataLoader
from ....segmentation import default_segmentation_dataset, get_data_loader
from ....utils.io import _pil_image
from .. import util

FTP_HOST = "ftp.ebi.ac.uk"
FTP_BASE = "/pub/databases/IDR/idr0095-ali-asymmetry/20200804-ftp"

EXPERIMENT_DIRS = {
    "A": "Experiment_A_Figure3",
    "B": "Experiment_B_Figure4",
    "C": "Experiment_C_Figure5",
}


def _ftp_download_recursive(ftp, remote_dir, local_dir):
    os.makedirs(local_dir, exist_ok=True)
    ftp.cwd(remote_dir)
    entries = []
    ftp.retrlines("LIST", entries.append)
    for entry in entries:
        name = entry.split()[-1]
        local_path = os.path.join(local_dir, name)
        if entry.startswith("d"):
            _ftp_download_recursive(ftp, f"{remote_dir}/{name}", local_path)
            ftp.cwd(remote_dir)
        elif not os.path.exists(local_path):
            with open(local_path, "wb") as f:
                ftp.retrbinary(f"RETR {name}", f.write)


def _get_phase_channel_index(nd2_file) -> int:
    """Index of the Phase channel, defaulting to 0."""
    try:
        names = [ch.channel.name.lower() for ch in nd2_file.metadata.channels]
        for i, name in enumerate(names):
            if "phase" in name or "bf" in name or "trans" in name:
                return i
    except Exception:
        pass
    return 0


def _extract_phase_tiffs(exp_dir: str, experiment: str) -> None:
    """Extract Phase-channel frames from all ND2 files next to their masks.
    The optional ``nd2`` package is only required when a file actually needs
    extraction, so pre-extracted Phase tiffs load without it."""
    Image = _pil_image()

    nd2_files = util.natsorted(glob(os.path.join(exp_dir, "**", "*.nd2"), recursive=True))
    if not nd2_files:
        # pre-extracted layouts ship Phase tiffs without the raw acquisitions
        if glob(os.path.join(exp_dir, "**", "*-Phase.tif"), recursive=True):
            return
        raise RuntimeError(f"No ND2 files found in {exp_dir}.")

    for nd2_path in nd2_files:
        condition = os.path.splitext(os.path.basename(nd2_path))[0]
        mask_dir = os.path.join(os.path.dirname(nd2_path), condition)
        if not os.path.isdir(mask_dir):
            continue
        mask_paths = util.natsorted(glob(os.path.join(mask_dir, "*-Mask.tif")))
        if not mask_paths:
            continue
        phase_paths = [p.replace("-Mask.tif", "-Phase.tif") for p in mask_paths]
        if all(os.path.exists(p) for p in phase_paths):
            continue
        try:
            import nd2
        except ImportError:
            raise ImportError("The 'nd2' package is required to read ND2 files from IDR0095.")
        try:
            with nd2.ND2File(nd2_path) as f:
                phase_idx = _get_phase_channel_index(f)
                arr = f.asarray()
        except Exception as e:
            print(f"Warning: skipping {nd2_path} - could not read ND2 file: {e}")
            continue

        # normalize to (N_fields, N_channels, H, W)
        if arr.ndim == 2:
            arr = arr[np.newaxis, np.newaxis]
        elif arr.ndim == 3:
            arr = arr[:, np.newaxis]
        n_frames = arr.shape[0]

        for i, (mask_path, phase_path) in enumerate(zip(mask_paths, phase_paths)):
            if os.path.exists(phase_path):
                continue
            frame_idx = min(i, n_frames - 1)
            frame = arr[frame_idx, phase_idx] if arr.ndim == 4 else arr[frame_idx, 0]
            Image.fromarray(frame.astype(np.uint16)).save(phase_path)


def get_idr0095_data(path: Union[os.PathLike, str], experiment: str = "A",
                     download: bool = False) -> str:
    """Download one IDR0095 experiment ('A' ~6GB / 'B' ~9GB / 'C' ~18GB) from
    EBI FTP and extract the Phase-channel tiffs."""
    assert experiment in EXPERIMENT_DIRS, \
        f"'{experiment}' is not a valid experiment. Choose from {list(EXPERIMENT_DIRS)}."
    data_dir = os.path.join(str(path), "idr0095")
    exp_dir = os.path.join(data_dir, EXPERIMENT_DIRS[experiment])

    if not download and not os.path.exists(exp_dir):
        raise RuntimeError(f"IDR0095 experiment {experiment} not found at {exp_dir}; "
                           "set download=True to download from EBI FTP.")
    if download:
        os.makedirs(data_dir, exist_ok=True)
        with ftplib.FTP(FTP_HOST) as ftp:
            ftp.login()  # anonymous
            _ftp_download_recursive(ftp, f"{FTP_BASE}/{EXPERIMENT_DIRS[experiment]}", exp_dir)

    _extract_phase_tiffs(exp_dir, experiment)
    return data_dir


def get_idr0095_paths(path: Union[os.PathLike, str], experiment: str = "A",
                      download: bool = False) -> Tuple[List[str], List[str]]:
    """Paired (phase image, instance mask) tiff paths for an experiment."""
    data_dir = get_idr0095_data(path, experiment, download)
    exp_dir = os.path.join(data_dir, EXPERIMENT_DIRS[experiment])

    mask_paths = util.natsorted(glob(os.path.join(exp_dir, "**", "*-Mask.tif"), recursive=True))
    pairs = [(p.replace("-Mask.tif", "-Phase.tif"), p) for p in mask_paths
             if os.path.exists(p.replace("-Mask.tif", "-Phase.tif"))]
    if not pairs:
        raise RuntimeError(f"No Phase TIFFs found in {exp_dir}.")
    raw_paths, mask_paths = zip(*pairs)
    return list(raw_paths), list(mask_paths)


def get_idr0095_dataset(path: Union[os.PathLike, str], patch_shape: Tuple[int, int],
                        experiment: str = "A", download: bool = False, **kwargs):
    """Dataset for E. coli phase-contrast cell segmentation."""
    raw_paths, label_paths = get_idr0095_paths(path, experiment, download)
    return default_segmentation_dataset(
        raw_paths=raw_paths, raw_key=None,
        label_paths=label_paths, label_key=None,
        patch_shape=patch_shape, **kwargs,
    )


def get_idr0095_loader(path: Union[os.PathLike, str], batch_size: int,
                       patch_shape: Tuple[int, int], experiment: str = "A",
                       download: bool = False, **kwargs) -> DataLoader:
    """DataLoader for E. coli phase-contrast cell segmentation."""
    ds_kwargs, loader_kwargs = util.split_kwargs(default_segmentation_dataset, **kwargs)
    ds = get_idr0095_dataset(path, patch_shape, experiment, download, **ds_kwargs)
    return get_data_loader(ds, batch_size, **loader_kwargs)
