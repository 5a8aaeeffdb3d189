"""Time one checkout's tiled inference as ``chip_smoke.py`` phase 4 does.

    python3 scripts/compare_serving.py ROOT [--paths host,device]

``ROOT`` holds a ``torch_em_tpu_torch`` package: ``.`` for this checkout, or
an unpacked ``git archive`` of another commit, so that two versions can be
timed in turns within one run on one card. The script builds that package's
forward instance-norm kernel, builds the tracked AnisotropicUNet (full width
and depth, bf16, seed 0) and times ``predict_with_halo`` on ``chip_smoke.py``'s
serving volumes and paths (``host``: a numpy volume; ``device``: a tensor on
the card, which a version before the device-resident path does not take),
each after a warm-up call, with ``chip_smoke.serve`` of this checkout. Needs
one CUDA card. Prints the card's name and power limit, then one JSON line.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root")
    parser.add_argument("--paths", default="host,device")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_serving: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch_em_tpu_torch as port
    import torch_em_tpu_torch.ops.instance_norm as inorm

    inorm.load_kernel()
    model = port.AnisotropicUNet(**smoke.TRACKED, dtype=torch.bfloat16, device="cuda", seed=0)
    results = []
    for shape in smoke.SERVING_VOLUMES:
        volume = np.random.default_rng(0).random(shape, dtype=np.float32)
        for path in args.paths.split(","):
            results.append(smoke.serve(port, inorm, model, volume, path)[1])
    print(smoke.nvidia_smi(), flush=True)
    print(json.dumps({"root": args.root, "package": os.path.dirname(port.__file__), "serving": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
