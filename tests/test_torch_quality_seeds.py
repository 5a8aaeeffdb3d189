"""The SPOCO and SNEMI quality points against the JAX package's seeds, on the CPU.

- The record ``scripts/records/jax_cpu_quality_seeds.json`` (``scripts/jax_quality_seeds.py``, the JAX
  recipes run per seed on the CPU): its per-seed values give its means and standard deviations, and the
  port's probes compare with it (``scripts/torch_spoco2d.py``, ``scripts/torch_parity3d.py --mode
  affinity``).
- ``--deterministic`` sets and records the flags, restores them afterwards, and the same seed gives the
  same weights twice.
- The JAX driver's seeding: the same seed gives the same initial weights and first batches, another seed
  other ones (nothing is trained).
- The deterministic 3-D pooling that the U-Net takes under ``torch.use_deterministic_algorithms(True)``
  against ``F.max_pool`` and the JAX package's pooling, forward and backward, and the whole model with and
  without the mode.
- The augmentations' host generator follows ``torch.manual_seed``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "scripts", "records", "jax_cpu_quality_seeds.json")


def _script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


parity3d, spoco2d = _script("torch_parity3d"), _script("torch_spoco2d")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel workers; torch's thread pool in each would oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.mark.parametrize("mode, n_seeds", [("spoco", 4), ("affinity", 6)])
def test_record_summaries_follow_from_its_seeds(mode, n_seeds):
    """Each mode holds at least ``n_seeds`` JAX recipe runs of distinct seeds, all trained the recipe's
    iterations, and its summary's means and standard deviations are its seeds'."""
    record = _record()
    assert record["cpu"] and record["jax"] and record["command"]
    entry = record["modes"][mode]
    seeds = entry["seeds"]
    assert len(seeds) >= n_seeds and len({s["seed"] for s in seeds}) == len(seeds)
    assert all(s["trained_iterations"] == entry["iterations"] == {"spoco": 2000, "affinity": 1200}[mode]
               for s in seeds)
    assert all(s["command"].startswith("python scripts/jax_quality_seeds.py") and s["wall_s"] > 0 for s in seeds)
    for key, stats in entry["summary"].items():
        values = np.array([s[key] for s in seeds], dtype=np.float64)
        assert stats["n"] == len(values)
        np.testing.assert_allclose(stats["mean"], values.mean(), rtol=1e-12)
        np.testing.assert_allclose(stats["std"], values.std(ddof=1), rtol=1e-12)
    for s in seeds:  # the recipes round to 4 places what the record keeps unrounded
        np.testing.assert_allclose(s["mean_one_minus_rand_index"], s["mean_arand_error"], atol=5e-5)


def test_port_yardsticks_are_the_record():
    """The probes' comparison reads the record's seeds, and the t it gives is Welch's over both sides."""
    record = _record()["modes"]
    for script, mode, keys in ((spoco2d, "spoco", spoco2d.SPOCO_KEYS), (parity3d, "affinity", parity3d.AFFINITY_KEYS)):
        assert script.__name__ and parity3d.jax_cpu_record(mode) == record[mode]
        runs = [{key: 0.5 + 0.1 * i + 0.01 * j for j, (key, _) in enumerate(keys)} | {"seed": i} for i in range(3)]
        compared = parity3d.against_jax_cpu(runs, mode, keys)
        assert compared["jax_cpu_seeds"] == [s["seed"] for s in record[mode]["seeds"]]
        for key, record_key in keys:
            jax_values = [s[record_key] for s in record[mode]["seeds"]]
            assert compared[key]["jax_cpu"] == parity3d.distribution(jax_values)
            t, dof = parity3d.welch([r[key] for r in runs], jax_values)
            assert compared[key]["welch_t"] == t and compared[key]["miss"] == (abs(t) >= 2)
    assert {k for k, _ in spoco2d.SPOCO_KEYS} == {"mean_voi", "mean_one_minus_rand_index", "mean_adapted_rand_error",
                                                  "mean_pred_instances"}
    assert {"mean_voi", "mean_f1"} <= {k for k, _ in parity3d.AFFINITY_KEYS}


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())


def test_affinity_probe_deterministic_repeats(tmp_path):
    """``--deterministic`` at 2 iterations: the flags recorded, restored afterwards, and the same weights,
    curves and scores from the same seed twice."""
    before = _flags()
    results = []
    for k in range(2):
        out = tmp_path / str(k)
        assert parity3d.main(["--mode", "affinity", "--seeds", "0", "-n", "2", "-d", "cpu", "--deterministic",
                              "-o", str(out)]) == 0
        assert _flags() == before
        with open(out / "affinity_results.json") as f:
            results.append(json.load(f))
    backend = results[0]["backend"]
    assert backend["deterministic_algorithms"] is True and backend["cudnn.allow_tf32"] is False
    assert backend["cuda.matmul.allow_tf32"] is False and backend["cudnn.benchmark"] is False
    assert backend["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    first, second = (r["runs"][0] for r in results)
    assert first["best_state_sha256"] == second["best_state_sha256"]
    assert first["curves"] == second["curves"] and first["per_volume"] == second["per_volume"]


def test_spoco_probe_deterministic_repeats(tmp_path, monkeypatch):
    """The SPOCO probe's training and decode under the deterministic settings for 2 iterations on the first
    8 train and 4 val images, with a grid of one setting: the same weights, curves and scores from the
    same seed twice."""
    monkeypatch.setattr(spoco2d, "GRID", {"delta": [2.0], "min_seg_size": [50]})
    paths = spoco2d.make_data(str(tmp_path / "data"), "probe", 8, 4)
    runs = []
    before = _flags()
    for k in range(2):
        with parity3d.deterministic():
            assert torch.are_deterministic_algorithms_enabled()
            np.random.seed(0)
            torch.manual_seed(0)
            run, _ = spoco2d.train_seed(paths, 0, 2, "cpu", str(tmp_path / str(k)))
        runs.append(run)
    assert _flags() == before
    assert runs[0]["best_state_sha256"] == runs[1]["best_state_sha256"]
    assert runs[0]["curves"] == runs[1]["curves"] and runs[0]["per_image"] == runs[1]["per_image"]


def test_jax_driver_seeding(tmp_path):
    """``jax_quality_seeds.build_seeded``: the recipe's trainer as ``fit`` would get it. Seed 0 twice gives
    the same initial weights and first two batches, seed 1 others."""
    import jax

    driver = _script("jax_quality_seeds")

    def built(seed):
        trainer = driver.build_seeded("spoco", seed, str(tmp_path / str(seed)))
        batches = []
        trainer.train_loader.set_epoch(0)
        for x, y in trainer.train_loader:
            batches.append((np.asarray(x), np.asarray(y)))
            if len(batches) == 2:
                break
        params = [np.asarray(p) for p in jax.tree_util.tree_leaves(trainer.model.variables)]
        return params, batches, np.asarray(trainer._rng)

    (p0, b0, k0), (p0b, b0b, k0b), (p1, b1, k1) = built(0), built(0), built(1)
    assert all(np.array_equal(a, b) for a, b in zip(p0, p0b)) and np.array_equal(k0, k0b)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(b0, b0b))
    assert not all(np.array_equal(a, b) for a, b in zip(p0, p1)) and not np.array_equal(k0, k1)
    assert not np.array_equal(b0[0][0], b1[0][0])
    np.testing.assert_array_equal(k0, np.asarray(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("shape, window", [((2, 3, 5, 7), (2, 2)), ((1, 2, 3, 6, 5), (1, 2, 2)),
                                           ((1, 2, 4, 6, 6), (2, 2, 2)), ((1, 1, 4, 5), (3, 1))])
def test_window_max_pool_matches(shape, window):
    """``window_max_pool`` against ``F.max_pool`` in float64, forward and backward bitwise with ties in
    most windows (and odd sizes cut as ``F.max_pool`` cuts them), and in float32 against the JAX package's
    pooling where its pairwise maxima apply (windows of 1 and 2 that divide the shape)."""
    from torch_em_tpu_torch.models.unet import window_max_pool

    g = torch.Generator().manual_seed(0)
    x = torch.round(torch.randn(shape, generator=g, dtype=torch.float64) * 2).requires_grad_()
    pooled = window_max_pool(x, window)
    plain = (F.max_pool2d if len(window) == 2 else F.max_pool3d)(x, window, window)
    assert torch.equal(pooled, plain)
    gy = torch.randn(pooled.shape, generator=g, dtype=torch.float64)
    assert torch.equal(torch.autograd.grad(pooled, x, gy)[0], torch.autograd.grad(plain, x, gy)[0])
    if all(w in (1, 2) for w in window) and all(n % w == 0 for n, w in zip(shape[2:], window)):
        import jax
        import jax.numpy as jnp

        from torch_em_tpu.models import unet as jax_unet

        x32 = torch.randn(shape, generator=g).requires_grad_()
        channels_last = jnp.asarray(np.moveaxis(x32.detach().numpy(), 1, -1))
        expected, vjp = jax.vjp(lambda v: jax_unet._max_pool_reshape(v, tuple(window)), channels_last)
        gy = torch.randn(pooled.shape, generator=g)
        got = window_max_pool(x32, window)
        np.testing.assert_array_equal(got.detach().numpy(), np.moveaxis(np.asarray(expected), -1, 1))
        np.testing.assert_array_equal(torch.autograd.grad(got, x32, gy)[0].numpy(),
                                      np.moveaxis(np.asarray(vjp(jnp.asarray(np.moveaxis(gy.numpy(), 1, -1)))[0]),
                                                  -1, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_under_deterministic_algorithms(dtype):
    """The SNEMI probe's ``AnisotropicUNet`` (f=4 here) with and without
    ``torch.use_deterministic_algorithms(True)``, which pools through ``window_max_pool``: outputs and
    gradients bitwise equal."""
    import torch_em_tpu_torch as port

    model = port.AnisotropicUNet(in_channels=1, out_channels=7, initial_features=4,
                                 scale_factors=[[1, 2, 2], [2, 2, 2]], final_activation="Sigmoid", device="cpu",
                                 seed=0)
    model.dtype = dtype
    x = torch.randn((1, 1, 8, 32, 32), generator=torch.Generator().manual_seed(1))
    outs = []
    for mode in (False, True):
        torch.use_deterministic_algorithms(mode)
        try:
            model.zero_grad()
            y = model(x)
            y.square().sum().backward()
            outs.append((y.detach(), [p.grad.clone() for p in model.parameters()]))
        finally:
            torch.use_deterministic_algorithms(False)
    assert torch.equal(outs[1][0], outs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[1][1], outs[0][1]))


def test_augmentation_host_generator_follows_torch_manual_seed():
    """A pipeline built without a seed takes one from torch's global generator: the same
    ``torch.manual_seed`` gives the same augmented samples, another seed others."""
    from torch_em_tpu_torch.transforms import get_augmentations

    raw = np.random.default_rng(0).random((32, 32)).astype("float32")
    labels = (raw > 0.5).astype("float32")

    def draws(seed):
        torch.manual_seed(seed)
        pipeline = get_augmentations(2)
        return [pipeline(raw, labels)[0] for _ in range(4)]

    assert all(np.array_equal(a, b) for a, b in zip(draws(3), draws(3)))
    assert not all(np.array_equal(a, b) for a, b in zip(draws(3), draws(4)))


def test_summarize_reads_result_files(tmp_path, capsys):
    """``--summarize`` merges result files one run per seed (the first file wins) and compares them with
    the record as a run of the probe would."""
    keys = [k for k, _ in spoco2d.SPOCO_KEYS] + ["mean_gt_instances"]
    files = []
    for name, seeds, shift in (("a", [0, 1], 0.0), ("b", [1, 2], 0.5)):
        runs = [dict({k: 0.4 + 0.1 * seed + shift for k in keys}, seed=seed) for seed in seeds]
        files.append(tmp_path / f"{name}.json")
        files[-1].write_text(json.dumps({"device": "cuda", "card": "card", "backend": {}, "runs": runs}))
    assert spoco2d.main(["--summarize"] + [str(f) for f in files]) == 0
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert [s["seeds"] for s in printed["sources"]] == [[0, 1], [1, 2]]
    runs, _ = parity3d.read_runs([str(f) for f in files])
    assert [r["seed"] for r in runs] == [0, 1, 2] and runs[1]["mean_voi"] == 0.5
    assert printed["summary"] == json.loads(json.dumps(spoco2d.summarize(runs)))
