"""bfloat16 training of parameters and optimizer state.

Counterpart of ``torch_em_tpu/trainer/flashoptim_trainer.py`` (torch-em's
``trainer/flashoptim_trainer.py``, which wraps FlashAdamW and a bf16 cast of
the model): the parameters, floating buffers and AdamW moments are held in
bfloat16, halving their device memory. ``mixed_precision`` (bf16 compute)
and ``compile_model`` are pinned, as in the reference, and any optimizer
other than AdamW is refused.
"""

import torch

from .default_trainer import DefaultTrainer

__all__ = ["FlashOptimTrainer"]


class FlashOptimTrainer(DefaultTrainer):
    """``DefaultTrainer`` with bfloat16 parameters and bfloat16 AdamW moments."""

    def __init__(self, **kwargs):
        optimizer = kwargs.get("optimizer")
        if optimizer is not None and getattr(optimizer, "name", "adamw") != "adamw":
            raise ValueError(f"FlashOptimTrainer is tested with the AdamW optimizer only, got "
                             f"'{getattr(optimizer, 'name', type(optimizer).__name__)}'.")
        kwargs["mixed_precision"] = True
        kwargs["compile_model"] = False
        super().__init__(**kwargs)

    def _build_optimizer(self):
        # the optimizer holds the same Parameter objects, whose data become bf16 in place; AdamW
        # makes its moments in their dtype, and a loaded state is cast to it
        super()._build_optimizer()
        self.model.to(torch.bfloat16)
        for state in self.torch_optimizer.state.values():
            for key, value in state.items():
                if torch.is_tensor(value) and value.is_floating_point() and value.ndim > 0:
                    state[key] = value.to(torch.bfloat16)
