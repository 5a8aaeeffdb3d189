"""Controlled pairs on the CPU: the JAX package's SPOCO and SNEMI probe recipes beside the port's, step for step.

    JAX_PLATFORMS=cpu python scripts/jax_quality_pairs.py --mode spoco --seed 0 --steps 160 -o OUT
    JAX_PLATFORMS=cpu python scripts/jax_quality_pairs.py --mode spoco --seed 0 --steps 160 --noise-floor -o OUT
    JAX_PLATFORMS=cpu python scripts/jax_quality_pairs.py --mode affinity --seed 0 --steps 200 -o OUT
    JAX_PLATFORMS=cpu python scripts/jax_quality_pairs.py --mode spoco --seed 0 --decode CHECKPOINT_FOLDER -o OUT

Training pair: both packages start from the same weights (the JAX init of
``seed``, carried into the port by ``utils/convert.py``), take the same
batches in the same order (drawn once from the JAX recipe's own loaders,
seeded as ``scripts/jax_quality_seeds.py`` seeds them) and the same
validation batches, and train as the recipes do (AdamW at lr 1e-4, the
plateau scheduler, a validation per epoch) in float32 (``--mixed-precision``
runs both in bfloat16 as the SNEMI recipe does). SPOCO's loss in the port
takes the anchors that the JAX loss draws from the JAX trainer's keys. The
pair's per-step losses, per-epoch validation metrics and final weights are
written to ``OUT/<mode>_pair_s<seed>.json`` with their largest gaps.
``--noise-floor`` (SPOCO) puts a second JAX run in the port's place, its
init moved by one float32 ulp: how far two runs of one package part on the
same data, the scale against which the pair's gaps are read.

Decode pair (``--decode``): the embeddings or affinities of a JAX checkpoint
(a ``checkpoints/<name>`` folder of ``jax_quality_seeds.py``) go through
both packages' decode and scores: SPOCO's grid search over the tune images,
its embedding mutex watershed and VOI / Rand on the held-out images; SNEMI's
mutex watershed and VOI / Rand / F1 on the val crops.

This script imports the JAX package and the port; the port imports neither it nor the JAX package.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "experiments", "parity")
sys.path.insert(0, REPO)
sys.path.insert(0, PARITY)

SPOCO_LOSS = dict(delta_var=0.75, delta_dist=2.0, max_instances=64)  # the recipe's loss, and its metric's
EMBED_DIM, SPOCO_BATCH = 8, 4
SPOCO_OFFSETS = [[-1, 0], [0, -1], [-3, 0], [0, -3], [-9, 0], [0, -9]]
SPOCO_GRID = {"delta": [1.0, 1.5, 2.0, 2.5], "min_seg_size": [50, 100, 200, 400]}
PATCH3D = (8, 64, 64)
AFFINITY_OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -3, 0], [0, 0, -3]]


def _pin_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


class ReplayLoader:
    """A loader that gives, for epoch ``e``, the batches ``epochs[e]`` (the last list again past the end);
    ``convert`` makes each array what the trainer takes."""

    def __init__(self, epochs, convert=lambda a: a):
        self.epochs, self.convert, self.epoch = epochs, convert, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.epochs[0])

    def __iter__(self):
        batches = self.epochs[min(self.epoch, len(self.epochs) - 1)]
        return iter([tuple(self.convert(a) for a in batch) for batch in batches])


class ValReplayLoader(ReplayLoader):
    """A val loader that gives the next list of batches at each pass."""

    def __init__(self, epochs, convert=lambda a: a):
        super().__init__(epochs, convert)
        self.calls = 0

    def __iter__(self):
        self.epoch, self.calls = self.calls, self.calls + 1
        return super().__iter__()


class Curves:
    """A logger of both packages' trainers: each step's loss and each validation's metric."""

    def __init__(self, trainer, save_root, **kwargs):
        self.losses, self.metrics = [], []

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.losses.append(float(loss))

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.metrics.append(float(metric))


def _gaps(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    d = np.abs(a - b)
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "max_rel": float((d / np.maximum(np.abs(b), 1e-12)).max())}


def _flat_params(variables):
    from flax.traverse_util import flatten_dict
    import jax
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables["params"]), sep="/").items()}


def _weight_gaps(port_model, jax_variables):
    from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params
    expected = state_dict_from_jax_params(_flat_params(jax_variables))
    got = port_model.state_dict()
    rel = {k: float((got[k].double() - expected[k].double()).norm() / max(float(expected[k].double().norm()), 1e-12))
           for k in expected}
    worst = max(rel, key=rel.get)
    return {"max_relative_l2": rel[worst], "at": worst, "median_relative_l2": float(np.median(list(rel.values())))}


def _jax_keys(seed, n):
    """The keys of the JAX trainer's steps: PRNGKey(seed) split once per step."""
    import jax
    keys, key = [], jax.random.PRNGKey(seed)
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


def _jax_anchors(max_anchors, key, target):
    """The anchors that the JAX ``SPOCOLoss.__call__`` draws from ``key``, one array per sample."""
    import jax
    import jax.numpy as jnp
    _, rng_cons = jax.random.split(key)
    rngs = jax.random.split(rng_cons, target.shape[0])
    out = []
    for b in range(target.shape[0]):
        logits = jnp.where(jnp.asarray(target[b, 0] == 0).reshape(-1), 0.0, -1e9)
        out.append(np.asarray(jax.random.categorical(rngs[b], logits, shape=(max_anchors,))))
    return out


def spoco_pair(seed, steps, mixed_precision=False, noise_floor=False):
    jax = _pin_cpu()
    import h5py
    import torch

    import torch_em_tpu as jtem
    import torch_em_tpu_torch as port
    from torch_em_tpu.data import TensorDataset
    from torch_em_tpu.loss import ContrastiveLoss as JaxContrastiveLoss, SPOCOLoss as JaxSPOCOLoss
    from torch_em_tpu.models import UNet2d as JaxUNet2d
    from torch_em_tpu.trainer.spoco_trainer import SPOCOTrainer as JaxSPOCOTrainer
    from torch_em_tpu_torch.loss import ContrastiveLoss, SPOCOLoss
    from torch_em_tpu_torch.trainer import SPOCOTrainer
    from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

    data = os.path.join(PARITY, "parity_data")
    with h5py.File(os.path.join(data, "train.h5"), "r") as f:
        raw_tr, lab_tr = f["raw"][:], f["labels"][:]
    with h5py.File(os.path.join(data, "val.h5"), "r") as f:
        raw_va, lab_va = f["raw"][:], f["labels"][:]
    np.random.seed(seed)
    train_ds = TensorDataset(images=list(raw_tr), labels=list(lab_tr), patch_shape=raw_tr.shape[1:],
                             label_dtype="int64")
    val_ds = TensorDataset(images=list(raw_va), labels=list(lab_va), patch_shape=raw_va.shape[1:],
                           label_dtype="int64")
    loader = jtem.get_data_loader(train_ds, batch_size=SPOCO_BATCH, shuffle=True, seed=seed)
    n_epochs = -(-steps // len(loader))
    epochs = []
    for e in range(n_epochs):
        loader.set_epoch(e)
        epochs.append([(np.asarray(x), np.asarray(y)) for x, y in loader])
    val = [[(np.asarray(x), np.asarray(y)) for x, y in jtem.get_data_loader(val_ds, batch_size=SPOCO_BATCH)]]

    jax_model = JaxUNet2d(in_channels=1, out_channels=EMBED_DIM, initial_features=16, seed=seed)
    init = jax.device_get(jax_model.variables)
    state = state_dict_from_jax_params(_flat_params(init))

    def jax_fit(model, name):
        trainer = jtem.default_segmentation_trainer(
            name, model, ReplayLoader(epochs), ReplayLoader(val), loss=JaxSPOCOLoss(**SPOCO_LOSS),
            metric=JaxContrastiveLoss(**SPOCO_LOSS),
            learning_rate=1e-4, mixed_precision=mixed_precision, save_root=os.path.join(tmp, name), logger=Curves,
            trainer_class=JaxSPOCOTrainer)
        trainer._rng = jax.random.PRNGKey(seed)
        t = time.perf_counter()
        trainer.fit(iterations=steps)
        return trainer, time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        jax_trainer, jax_s = jax_fit(jax_model, "pair-jax")
        if noise_floor:
            # the noise floor: JAX against JAX from the same init moved by one float32 ulp
            other = JaxUNet2d(in_channels=1, out_channels=EMBED_DIM, initial_features=16, seed=seed)
            other.replace_variables(jax.tree_util.tree_map(
                lambda p: np.nextafter(np.asarray(p), np.float32(np.inf)).astype(np.float32), init))
            floor, floor_s = jax_fit(other, "pair-jax-ulp")
            return {"mode": "spoco", "seed": seed, "steps": steps, "mixed_precision": mixed_precision,
                    "noise_floor": True, "jax_s": jax_s, "floor_s": floor_s,
                    "jax": {"losses": jax_trainer.logger.losses, "val_metrics": jax_trainer.logger.metrics},
                    "port": {"losses": floor.logger.losses, "val_metrics": floor.logger.metrics},
                    "loss_gaps": _gaps(floor.logger.losses, jax_trainer.logger.losses),
                    "val_metric_gaps": _gaps(floor.logger.metrics, jax_trainer.logger.metrics)}

        model = port.UNet2d(in_channels=1, out_channels=EMBED_DIM, initial_features=16, device="cpu")
        model.load_state_dict(state, strict=True)
        trainer = port.default_segmentation_trainer(
            "pair-port", model, ReplayLoader(epochs, torch.from_numpy), ReplayLoader(val, torch.from_numpy),
            loss=SPOCOLoss(**SPOCO_LOSS), metric=ContrastiveLoss(**SPOCO_LOSS),
            learning_rate=1e-4, mixed_precision=mixed_precision, device="cpu", save_root=os.path.join(tmp, "port"),
            logger=Curves, trainer_class=SPOCOTrainer)
        keys, calls = _jax_keys(seed, steps), []
        targets = [y for batches in epochs for _, y in batches]
        draw, max_anchors = trainer.loss.draw_anchors, trainer.loss.max_anchors

        def jax_draw(mask, generator=None):
            """Sample ``b`` of step ``step``: the anchors the JAX loss draws from the step's key."""
            if not torch.is_grad_enabled():  # validation: its anchors change no parameter
                return draw(mask, generator)
            step, b = divmod(len(calls), SPOCO_BATCH)
            calls.append(step)
            return torch.from_numpy(_jax_anchors(max_anchors, keys[step], targets[step])[b].copy())

        trainer.loss.draw_anchors = jax_draw
        torch.manual_seed(seed)
        t = time.perf_counter()
        trainer.fit(iterations=steps)
        port_s = time.perf_counter() - t
        assert len(calls) == steps * SPOCO_BATCH, len(calls)
        result = {"mode": "spoco", "seed": seed, "steps": steps, "mixed_precision": mixed_precision,
                  "jax_s": jax_s, "port_s": port_s,
                  "jax": {"losses": jax_trainer.logger.losses, "val_metrics": jax_trainer.logger.metrics},
                  "port": {"losses": trainer.logger.losses, "val_metrics": trainer.logger.metrics},
                  "loss_gaps": _gaps(trainer.logger.losses, jax_trainer.logger.losses),
                  "val_metric_gaps": _gaps(trainer.logger.metrics, jax_trainer.logger.metrics),
                  "weights": _weight_gaps(trainer.model, jax_trainer.variables),
                  "model2": _weight_gaps(trainer.model2, jax_trainer.variables2),
                  "lr": {"jax": _jax_lr(jax_trainer), "port": trainer.torch_optimizer.param_groups[0]["lr"]}}
    return result


def _jax_lr(trainer):
    from torch_em_tpu.trainer.optimizers import get_learning_rate
    return float(get_learning_rate(trainer.opt_state))


def _affinity_loaders(seed, jtem, paths, n_samples):
    """The SNEMI recipe's loader over ``paths`` with ``n_samples`` patches, seeded as the seed driver seeds it."""
    from torch_em_tpu.transforms.label import AffinityTransform
    trafo = AffinityTransform(offsets=AFFINITY_OFFSETS, add_binary_target=True, add_mask=True)
    return jtem.default_segmentation_loader(
        paths, "raw", paths, "labels", batch_size=1, patch_shape=PATCH3D, ndim=3, label_transform2=trafo,
        label_dtype="float32", n_samples=n_samples, seed=seed)


def _affinity_model(module, seed=None, **kwargs):
    extra = {} if seed is None else {"seed": seed}
    return module(in_channels=1, out_channels=1 + len(AFFINITY_OFFSETS), initial_features=8,
                  scale_factors=[[1, 2, 2], [2, 2, 2]], final_activation="Sigmoid", **extra, **kwargs)


def affinity_pair(seed, steps, mixed_precision=False):
    jax = _pin_cpu()
    from glob import glob

    import torch

    import torch_em_tpu as jtem
    import torch_em_tpu_torch as port
    from torch_em_tpu.loss import ApplyAndRemoveMask as JaxMask, DiceLoss as JaxDice, LossWrapper as JaxWrapper
    from torch_em_tpu.models import AnisotropicUNet as JaxAnisotropicUNet
    from torch_em_tpu_torch.loss import ApplyAndRemoveMask, DiceLoss, LossWrapper
    from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params

    data = os.path.join(PARITY, "parity_data3d")
    train_paths = sorted(glob(os.path.join(data, "train", "vol*.h5")))
    val_paths = sorted(glob(os.path.join(data, "val", "vol*.h5")))
    np.random.seed(seed)
    loaders = [_affinity_loaders(seed, jtem, train_paths, 50), _affinity_loaders(seed, jtem, val_paths, 8)]
    for i, loader in enumerate(loaders):
        loader.dataset.datasets[0].transform._np_rng = np.random.default_rng([seed, i])
    n_epochs = -(-steps // len(loaders[0]))
    epochs, vals = [], []
    for e in range(n_epochs):  # the recipe's order of draws: an epoch's patches, then its validation's
        loaders[0].set_epoch(e)
        epochs.append([(np.asarray(x), np.asarray(y)) for x, y in loaders[0]])
        vals.append([(np.asarray(x), np.asarray(y)) for x, y in loaders[1]])

    jax_model = _affinity_model(JaxAnisotropicUNet, seed)
    state = state_dict_from_jax_params(_flat_params(jax_model.variables))
    with tempfile.TemporaryDirectory() as tmp:
        loss = JaxWrapper(JaxDice(), transform=JaxMask())
        jax_trainer = jtem.default_segmentation_trainer(
            "pair-jax", jax_model, ReplayLoader(epochs), ValReplayLoader(vals), loss=loss, metric=loss,
            learning_rate=1e-4, mixed_precision=mixed_precision, save_root=os.path.join(tmp, "jax"), logger=Curves)
        jax_trainer._rng = jax.random.PRNGKey(seed)
        t = time.perf_counter()
        jax_trainer.fit(iterations=steps)
        jax_s = time.perf_counter() - t

        model = _affinity_model(port.AnisotropicUNet, device="cpu")
        model.load_state_dict(state, strict=True)
        loss = LossWrapper(DiceLoss(), transform=ApplyAndRemoveMask())
        trainer = port.default_segmentation_trainer(
            "pair-port", model, ReplayLoader(epochs, torch.from_numpy), ValReplayLoader(vals, torch.from_numpy),
            loss=loss, metric=loss, learning_rate=1e-4, mixed_precision=mixed_precision, device="cpu",
            save_root=os.path.join(tmp, "port"), logger=Curves)
        t = time.perf_counter()
        trainer.fit(iterations=steps)
        port_s = time.perf_counter() - t
    return {"mode": "affinity", "seed": seed, "steps": steps, "mixed_precision": mixed_precision,
            "jax_s": jax_s, "port_s": port_s,
            "jax": {"losses": jax_trainer.logger.losses, "val_metrics": jax_trainer.logger.metrics},
            "port": {"losses": trainer.logger.losses, "val_metrics": trainer.logger.metrics},
            "loss_gaps": _gaps(trainer.logger.losses, jax_trainer.logger.losses),
            "val_metric_gaps": _gaps(trainer.logger.metrics, jax_trainer.logger.metrics),
            "weights": _weight_gaps(trainer.model, jax_trainer.variables),
            "lr": {"jax": _jax_lr(jax_trainer), "port": trainer.torch_optimizer.param_groups[0]["lr"]}}


def _jax_checkpoint(folder, name="best"):
    """The ``params`` tree and bookkeeping of a JAX trainer's checkpoint."""
    from flax import serialization
    from flax.traverse_util import flatten_dict
    with open(os.path.join(folder, f"{name}.ckpt"), "rb") as f:
        save_dict = serialization.msgpack_restore(f.read())
    params = {k: np.asarray(v) for k, v in flatten_dict(save_dict["model_state"]["params"], sep="/").items()}
    return save_dict["model_state"], params, int(save_dict["iteration"])


def spoco_decode(folder, seed):
    """Both packages' grid search, decode and scores on the embeddings of the JAX checkpoint in ``folder``."""
    _pin_cpu()
    import h5py
    import jax
    import torch

    import torch_em_tpu_torch as port
    from torch_em_tpu.metric.eval import rand_index as jax_rand_index
    from torch_em_tpu.metric.eval import variation_of_information as jax_voi
    from torch_em_tpu.metric.instance_segmentation_metric import EmbeddingMWS as JaxEmbeddingMWS
    from torch_em_tpu.models import UNet2d as JaxUNet2d
    from torch_em_tpu.utils.grid_search import instance_segmentation_grid_search as jax_grid_search
    from torch_em_tpu_torch.metric import rand_index, variation_of_information
    from torch_em_tpu_torch.metric.instance_segmentation_metric import EmbeddingMWS
    from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params
    from torch_em_tpu_torch.utils.grid_search import instance_segmentation_grid_search

    state, params, iteration = _jax_checkpoint(folder)
    with h5py.File(os.path.join(PARITY, "parity_data", "val.h5"), "r") as f:
        raw_va, lab_va = f["raw"][:], f["labels"][:]
    module = JaxUNet2d(in_channels=1, out_channels=EMBED_DIM, initial_features=16, seed=seed).module
    fwd = jax.jit(lambda p, x: module.apply({"params": p}, x, train=False))
    jax_emb = [np.asarray(fwd(state["params"], r[None, None].astype("float32")))[0] for r in raw_va]
    model = port.UNet2d(in_channels=1, out_channels=EMBED_DIM, initial_features=16, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    model.eval()
    with torch.no_grad():
        port_emb = [model(torch.from_numpy(r[None, None].astype("float32")))[0].numpy() for r in raw_va]
    emb_gap = max(float(np.abs(a - b).max()) for a, b in zip(port_emb, jax_emb))

    n_tune = len(raw_va) // 2

    class Segmenter:  # both packages' grid search, on the JAX embeddings of the image it is given
        def __init__(self, decoder):
            self.decoder = decoder

        def initialize(self, image):
            self._emb = jax_emb[int(np.argmin([np.abs(image - r).sum() for r in raw_va[:n_tune]]))]

        def is_initialized(self):
            return hasattr(self, "_emb")

        def generate(self, delta=1.5, min_seg_size=150):
            return self.decoder(delta=delta, offsets=SPOCO_OFFSETS, with_background=True,
                                min_seg_size=min_seg_size)(self._emb)

    result = {"mode": "spoco", "seed": seed, "checkpoint": folder, "best_checkpoint_iteration": iteration,
              "embedding_max_abs_gap": emb_gap}
    with tempfile.TemporaryDirectory() as tmp:
        h5_paths, raw_paths, gt_paths = [], [], []
        for i in range(n_tune):
            p = os.path.join(tmp, f"tune_{i}.h5")
            with h5py.File(p, "w") as f:
                f.create_dataset("raw", data=raw_va[i])
                f.create_dataset("gt", data=lab_va[i].astype("uint32"))
            h5_paths.append(p)
            raw_paths.append(os.path.join(tmp, f"raw_{i}.npy"))
            gt_paths.append(os.path.join(tmp, f"gt_{i}.npy"))
            np.save(raw_paths[-1], raw_va[i])
            np.save(gt_paths[-1], lab_va[i])
        jax_best, jax_score = jax_grid_search(Segmenter(JaxEmbeddingMWS), h5_paths, h5_paths,
                                              os.path.join(tmp, "jax"), grid_search_values=SPOCO_GRID,
                                              image_key="raw", gt_key="gt")
        port_best, port_score = instance_segmentation_grid_search(Segmenter(EmbeddingMWS), raw_paths, gt_paths,
                                                                  os.path.join(tmp, "port"),
                                                                  grid_search_values=SPOCO_GRID)
    for side, decoder, best, voi, ri_of in (
            ("jax", JaxEmbeddingMWS, jax_best, jax_voi, lambda s, g: jax_rand_index(s, g)),
            ("port", EmbeddingMWS, port_best, variation_of_information, lambda s, g: rand_index(s, g))):
        dec = decoder(delta=best["delta"], offsets=SPOCO_OFFSETS, with_background=True,
                      min_seg_size=int(best["min_seg_size"]))
        images = []
        for i in range(n_tune, len(raw_va)):
            seg = dec(jax_emb[i]).astype("uint64")
            gt = lab_va[i].astype("uint64")
            vs, vm = voi(seg, gt)
            are, ri = ri_of(seg, gt)
            images.append({"voi": float(vs + vm), "adapted_rand_error": float(are), "one_minus_rand_index":
                           float(1 - ri), "n_pred": int(len(np.unique(seg)) - 1), "seg_sha": _digest(seg)})
        result[side] = {"best": {k: float(v) for k, v in best.items()},
                        "tune_score": float(jax_score if side == "jax" else port_score), "images": images,
                        "mean_voi": float(np.mean([r["voi"] for r in images]))}
    result["segmentations_equal"] = [a["seg_sha"] == b["seg_sha"] for a, b in
                                     zip(result["jax"]["images"], result["port"]["images"])]
    return result


def _digest(a):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def affinity_decode(folder, seed):
    """Both packages' mutex watershed and scores on the affinities of the JAX checkpoint in ``folder``."""
    _pin_cpu()
    from glob import glob

    import h5py
    import jax
    import torch

    import torch_em_tpu_torch as port
    from torch_em_tpu.metric.eval import matching as jax_matching
    from torch_em_tpu.metric.eval import rand_index as jax_rand_index
    from torch_em_tpu.metric.eval import variation_of_information as jax_voi
    from torch_em_tpu.models import AnisotropicUNet as JaxAnisotropicUNet
    from torch_em_tpu.utils.segmentation import mutex_watershed_segmentation as jax_mws
    from torch_em_tpu_torch.metric import matching, rand_index, variation_of_information
    from torch_em_tpu_torch.utils.convert import state_dict_from_jax_params
    from torch_em_tpu_torch.utils.segmentation import mutex_watershed_segmentation

    state, params, iteration = _jax_checkpoint(folder)
    module = _affinity_model(JaxAnisotropicUNet, seed).module
    fwd = jax.jit(lambda p, x: module.apply({"params": p}, x, train=False))
    model = _affinity_model(port.AnisotropicUNet, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    model.eval()
    result = {"mode": "affinity", "seed": seed, "checkpoint": folder, "best_checkpoint_iteration": iteration,
              "volumes": []}
    for path in sorted(glob(os.path.join(PARITY, "parity_data3d", "val", "vol*.h5"))):
        with h5py.File(path, "r") as f:
            raw = f["raw"][:PATCH3D[0], :PATCH3D[1], :PATCH3D[2]].astype("float32")
            gt = f["labels"][:PATCH3D[0], :PATCH3D[1], :PATCH3D[2]].astype("uint64")
        pred = np.asarray(fwd(state["params"], raw[None, None]))[0]
        with torch.no_grad():
            port_pred = model(torch.from_numpy(raw[None, None]))[0].numpy()
        entry = {"prediction_max_abs_gap": float(np.abs(pred - port_pred).max())}
        for side, mws, voi, ri_of, match in (("jax", jax_mws, jax_voi, jax_rand_index, jax_matching),
                                             ("port", mutex_watershed_segmentation, variation_of_information,
                                              rand_index, matching)):
            seg = mws(np.ones_like(pred[0]), pred[1:], offsets=AFFINITY_OFFSETS, min_size=10)
            vs, vm = voi(seg, gt)
            are, ri = ri_of(seg, gt)
            entry[side] = {"voi_split": float(vs), "voi_merge": float(vm), "adapted_rand_error": float(are),
                           "one_minus_rand_index": float(1 - ri), "f1": float(match(seg, gt, threshold=0.5)["f1"]),
                           "n_pred": int(len(np.unique(seg)) - 1), "seg_sha": _digest(np.asarray(seg, "uint64"))}
        entry["segmentations_equal"] = entry["jax"]["seg_sha"] == entry["port"]["seg_sha"]
        result["volumes"].append(entry)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("spoco", "affinity"), required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=160)
    parser.add_argument("--mixed-precision", action="store_true")
    parser.add_argument("--noise-floor", action="store_true",
                        help="spoco: JAX against JAX from the init moved by one ulp, in place of the port")
    parser.add_argument("--decode", help="a JAX checkpoint folder whose best checkpoint both packages decode")
    parser.add_argument("--threads", type=int, default=2,
                        help="torch's CPU threads (the JAX side's XLA pool takes the others)")
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)
    import torch
    torch.set_num_threads(args.threads)
    os.makedirs(args.output, exist_ok=True)
    if args.decode:
        result = (spoco_decode if args.mode == "spoco" else affinity_decode)(args.decode, args.seed)
        name = f"{args.mode}_decode_s{args.seed}.json"
    else:
        if args.mode == "spoco":
            result = spoco_pair(args.seed, args.steps, args.mixed_precision, args.noise_floor)
        else:
            result = affinity_pair(args.seed, args.steps, args.mixed_precision)
        name = (f"{args.mode}_pair_s{args.seed}{'_bf16' if args.mixed_precision else ''}"
                f"{'_floor' if args.noise_floor else ''}.json")
    with open(os.path.join(args.output, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("jax", "port")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
