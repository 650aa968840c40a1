"""Trainer checkpoints as ``torch.save`` files.

The reference's single-file checkpoint (ref: nnUNetTrainer.py:1083-1144;
``dinounet_tpu/training/checkpointing.py`` keeps the same key set in a
pickled msgpack envelope): a dict with

    network_weights                    the model state_dict, reference names
    optimizer_state                    the optimizer's state_dict
    grad_scaler_state                  None (bf16 needs no loss scaling)
    logging, _best_ema, current_epoch, init_args, trainer_name,
    inference_allowed_mirroring_axes

written as checkpoint_latest / checkpoint_best / checkpoint_final.pth.
Tensors are stored on the CPU. The file holds only tensors and plain Python
values, so it loads with ``weights_only=True``. The sharded form (the JAX
package's orbax directories for a model-sharded 7B) and a JAX <-> torch
checkpoint converter are not ported yet.
"""

import os
from typing import Any, Dict

import torch

CHECKPOINT_KEYS = ("network_weights", "optimizer_state", "grad_scaler_state",
                   "logging", "_best_ema", "current_epoch", "init_args",
                   "trainer_name", "inference_allowed_mirroring_axes")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(checkpoint: Dict[str, Any], filename: str) -> None:
    """Write atomically (a temporary file renamed over `filename`)."""
    missing = set(CHECKPOINT_KEYS) - set(checkpoint)
    if missing:
        raise KeyError(f"checkpoint lacks {sorted(missing)}")
    tmp = filename + ".tmp"
    torch.save(_to_cpu(checkpoint), tmp)
    os.replace(tmp, filename)


def load_checkpoint(filename: str) -> Dict[str, Any]:
    return torch.load(filename, map_location="cpu", weights_only=True)
