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
Tensors are written as they are held, each copied from the device on its
own while the file is written, so a checkpoint of the ViT-7B trainer holds
its bf16 backbone as bf16 and the host never holds the whole state at once;
they load onto the CPU. ``load_checkpoint`` maps the file instead of
reading it: the tensors are views of the page cache (no anonymous host
memory), copied wherever a ``load_state_dict`` puts them. The file holds
only tensors and plain Python values, so it loads with
``weights_only=True``. The JAX package's orbax directories (a
model-sharded 7B) are not ported (ROADMAP.md, queue item 11).
"""

import os
from typing import Any, Dict

import torch

CHECKPOINT_KEYS = ("network_weights", "optimizer_state", "grad_scaler_state",
                   "logging", "_best_ema", "current_epoch", "init_args",
                   "trainer_name", "inference_allowed_mirroring_axes")


def save_checkpoint(checkpoint: Dict[str, Any], filename: str) -> None:
    """Write atomically (a temporary file renamed over `filename`)."""
    missing = set(CHECKPOINT_KEYS) - set(checkpoint)
    if missing:
        raise KeyError(f"checkpoint lacks {sorted(missing)}")
    tmp = filename + ".tmp"
    torch.save(checkpoint, tmp)
    os.replace(tmp, filename)


def load_checkpoint(filename: str) -> Dict[str, Any]:
    """The checkpoint with its tensors on the CPU, mapped from the file."""
    return torch.load(filename, map_location="cpu", weights_only=True, mmap=True)
