"""Shared argparse helper for training scripts (counterpart of ``torch_em_tpu/utils/training.py``)."""

import argparse
from typing import Optional

__all__ = ["parser_helper"]


def parser_helper(description: Optional[str] = None, default_iterations: int = int(1e5),
                  default_batch_size: int = 1, require_input: bool = True) -> argparse.ArgumentParser:
    description = "Run torch_em_tpu_torch training" if description is None else description
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-i", "--input", required=require_input,
                        help="Path to the training data")
    parser.add_argument("--check", "-c", type=int, default=0,
                        help="Check the loader instead of running training")
    parser.add_argument("-n", "--n_iterations", type=int, default=default_iterations)
    parser.add_argument("-b", "--batch_size", type=int, default=default_batch_size)
    parser.add_argument("--from_checkpoint", type=int, default=0)
    return parser
