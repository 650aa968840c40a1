"""Polynomial learning-rate decay per epoch (ref: dinounet/training/
lr_scheduler/polylr.py:4-20; ``dinounet_tpu/training/lr_scheduler.py``)."""


def poly_lr(initial_lr: float, epoch: int, max_epochs: int, exponent: float = 0.9) -> float:
    return initial_lr * (1 - epoch / max_epochs) ** exponent
