"""``instance_segmentation_grid_search`` in the port against the JAX package's.

The segmenter decodes fixed embeddings (seeded numpy, one cluster per
instance) with the embedding mutex watershed, each side with its own
``EmbeddingMWS``, over ``.npy`` files. Both sides must pick the same best
parameters with the same score (1e-12: the decodes are bitwise equal and
the metric is float64) and write the same CSV tables, the JAX package's
with pandas, the port's with the ``csv`` module.
"""

import os

import numpy as np
import pytest

from torch_em_tpu.metric.instance_segmentation_metric import EmbeddingMWS as JaxEmbeddingMWS
from torch_em_tpu.utils.grid_search import instance_segmentation_grid_search as jax_grid_search
from torch_em_tpu_torch.metric.instance_segmentation_metric import EmbeddingMWS
from torch_em_tpu_torch.utils import grid_search

OFFSETS = [[-1, 0], [0, -1], [-3, 0], [0, -3], [-9, 0], [0, -9]]
GRID = {"delta": [0.5, 1.0, 2.0], "min_seg_size": [0, 20, 60]}


class EmbeddingSegmenter:
    """The segmenter of ``experiments/parity/train_spoco2d.py``, on embeddings read from the image file."""

    def __init__(self, decoder):
        self.decoder = decoder

    def initialize(self, image):
        self._emb = image

    def generate(self, delta=1.5, min_seg_size=150):
        return self.decoder(delta=delta, offsets=OFFSETS, with_background=True, min_seg_size=min_seg_size)(self._emb)


def _images(folder, n=3, shape=(40, 44), e=4):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        gt = np.zeros(shape, dtype=np.uint32)
        for k in range(1, 7):
            y, x = rng.integers(0, shape[0] - 10), rng.integers(0, shape[1] - 10)
            gt[y:y + int(rng.integers(4, 12)), x:x + int(rng.integers(4, 12))] = k
        centers = rng.normal(scale=2.0, size=(7, e))
        emb = (centers[gt].transpose(2, 0, 1) + rng.normal(scale=0.4, size=(e,) + shape)).astype(np.float32)
        paths.append((os.path.join(folder, f"emb{i}.npy"), os.path.join(folder, f"gt{i}.npy")))
        np.save(paths[-1][0], emb)
        np.save(paths[-1][1], gt)
    return [p for p, _ in paths], [g for _, g in paths]


def test_grid_search_matches_jax(tmp_path):
    images, gts = _images(str(tmp_path))
    expected = jax_grid_search(EmbeddingSegmenter(JaxEmbeddingMWS), images, gts, str(tmp_path / "jax"), GRID)
    got = grid_search.instance_segmentation_grid_search(EmbeddingSegmenter(EmbeddingMWS), images, gts,
                                                        str(tmp_path / "port"), GRID)
    assert got[0] == expected[0]
    assert abs(got[1] - expected[1]) <= 1e-12 and 0 < got[1] < 1
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["best_params.csv", "emb0.csv", "emb1.csv", "emb2.csv"]
    for name in names:
        with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
            assert f.read() == g.read(), name
    # the scores differ across the grid: the search chooses
    with open(tmp_path / "port" / "emb0.csv") as f:
        scores = {line.rsplit(",", 1)[1] for line in f.read().splitlines()[1:]}
    assert len(scores) > 2


def test_boundary_segmenter_runs_on_a_model(tmp_path):
    import torch_em_tpu_torch as port

    model = port.UNet2d(1, 2, depth=1, initial_features=2, final_activation="Sigmoid", device="cpu")
    rng = np.random.default_rng(1)
    np.save(tmp_path / "raw.npy", rng.normal(size=(24, 20)).astype(np.float32))
    np.save(tmp_path / "gt.npy", (rng.random((24, 20)) > 0.5).astype(np.uint32))
    grid = grid_search.default_grid_search_values_boundary_based_instance_segmentation(min_size_values=[0, 5])
    for segmenter in (grid_search.BoundaryBasedInstanceSegmentation(model),
                      grid_search.BoundaryBasedInstanceSegmentation(model, block_shape=(16, 16), halo=(4, 4))):
        best, score = grid_search.instance_segmentation_grid_search(
            segmenter, [str(tmp_path / "raw.npy")], [str(tmp_path / "gt.npy")], str(tmp_path / "out"), grid)
        assert set(best) == {"threshold1", "threshold2", "min_size"} and 0 <= score <= 1
        with open(tmp_path / "out" / "raw.csv") as f:
            assert len(f.read().splitlines()) == 1 + 3 * 3 * 2


def test_distance_segmenter_matches_jax():
    from torch_em_tpu.utils.grid_search import DistanceBasedInstanceSegmentation as JaxDistanceBased

    ours, theirs = grid_search.DistanceBasedInstanceSegmentation(model=None), JaxDistanceBased(model=None)
    assert not ours.is_initialized
    yy, xx = np.mgrid[:32, :48]
    radius = np.minimum(np.hypot(yy - 16, xx - 12), np.hypot(yy - 16, xx - 36))
    fg = (radius < 10).astype(np.float32)
    ours._prediction = theirs._prediction = np.stack([fg, radius / 10 * fg, np.clip(1 - radius / 10, 0, 1)])
    seg = ours.generate(min_size=5)
    np.testing.assert_array_equal(seg, theirs.generate(min_size=5))
    assert seg.shape == (32, 48) and seg.max() >= 2


@pytest.mark.parametrize("value,written", [(np.float64(0.25), 0.25), (np.int64(3), 3), (True, True)])
def test_table_cells_are_python_numbers(value, written):
    cell = grid_search._cell(value)
    assert cell == written and type(cell) is type(written)
