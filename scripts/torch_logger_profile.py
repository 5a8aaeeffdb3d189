"""Where the default TensorBoard logger's time goes in the tracked model's fit, on the card.

    python3 scripts/torch_logger_profile.py

builds the tracked AnisotropicUNet (``chip_smoke.TRACKED``) over ``chip_smoke.training_volume``'s
seeded volume, as phase 24a of ``chip_smoke.py`` does, and prints: the training epochs' ms per
iteration of fits of 8 steps with the default logger at ``log_image_interval`` 4 and 100 and with
``logger=None``, three of each in turns after a warm-up; ``cProfile``'s cumulative table of one
fit with the default logger at interval 4; and the host ms of the three parts of writing one
image grid: the slice copied to the host, the grid, the PNG (PIL, as tensorboardX encodes it).
It needs a CUDA device.
"""

import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
import torch_em_tpu_torch as port  # noqa: E402
import torch_em_tpu_torch.ops.device as device_ops  # noqa: E402
from torch_em_tpu_torch.trainer.tensorboard_logger import _select_2d, make_grid  # noqa: E402
from torch_em_tpu_torch.utils.tensorboard import encode_png  # noqa: E402


def main():
    with tempfile.TemporaryDirectory() as tmp:
        raw, labels = cs.training_volume(port)
        np.save(os.path.join(tmp, "raw.npy"), raw)
        np.save(os.path.join(tmp, "labels.npy"), labels)

        def loader(n, shuffle):
            ds = port.SegmentationDataset(os.path.join(tmp, "raw.npy"), None, os.path.join(tmp, "labels.npy"), None,
                                          patch_shape=cs.TRAIN_PATCH, n_samples=n, raw_transform=port.standardize)
            return port.DataLoader(ds, batch_size=1, shuffle=shuffle, num_workers=cs.LOADER_THREADS)

        def tracked(name, interval, **logger):
            np.random.seed(0)
            model = port.AnisotropicUNet(**cs.TRACKED, device="cuda", seed=0)
            return port.default_segmentation_trainer(
                name, model, loader(8, True), loader(2, False), learning_rate=cs.LEARNING_RATE,
                log_image_interval=interval, save_root=tmp,
                device_label_transform=device_ops.DeviceAffinityTransform(offsets=cs.OFFSETS), **logger)

        tracked("warm_up", 4, logger=None).fit(iterations=2)
        times = {}
        for rep in range(3):
            for kind, interval, logger in (("default@4", 4, {}), ("none", 4, {"logger": None}),
                                           ("default@100", 100, {})):
                trainer = tracked(f"{kind.replace('@', '_')}_{rep}", interval, **logger)
                cs.timed_epochs(trainer, times.setdefault(kind, []))
                trainer.fit(iterations=8)
        print("ms per iteration:", {k: [round(x * 1e3, 2) for x in v] for k, v in times.items()}, flush=True)
        tracked("profile_warm_up", 4).fit(iterations=8)
        trainer = tracked("profiled", 4)
        profile = cProfile.Profile()
        profile.enable()
        trainer.fit(iterations=8)
        profile.disable()
        out = io.StringIO()
        pstats.Stats(profile, stream=out).sort_stats("cumulative").print_stats(45)
        print(out.getvalue(), flush=True)
    x = torch.randn((1, 1) + cs.TRAIN_PATCH, device="cuda")
    torch.cuda.synchronize()
    for name, fn in (("slice to the host", lambda: _select_2d(x)), ("grid", lambda: make_grid([_select_2d(x)])),
                     ("grid and PNG", lambda: encode_png((make_grid([_select_2d(x)]).transpose(1, 2, 0) * 255)
                                                         .astype(np.uint8)))):
        fn()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        print(f"{name}: {(time.perf_counter() - t) / 10 * 1e3:.2f} ms", flush=True)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
