"""Trainer checkpoints: ``torch.save`` files, and sharded directories.

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
``weights_only=True``.

A trainer whose backbone is split over a model axis writes a directory at
the same name instead (JAX ``checkpointing.py:64-145`` writes orbax
directories; the port uses ``torch.distributed.checkpoint``, as the
reference's dormant checkpointer does, ref dinov3/checkpointer/
checkpointer.py:45-330): every rank writes its shards of the tensors
(network weights as DTensors over the mesh, the optimizer's tensors) under
``arrays/``, replicated tensors once; the other keys, the optimizer's
other entries and the full shapes of the entries saved as views go to a
sidecar, ``meta.pth``. ``load_checkpoint`` on such a directory reads the
arrays onto a template's tensors in place (a rank's shards), or, without
one, as whole CPU tensors in one process.

``load_checkpoint`` and ``load_checkpoint_meta`` also read what the JAX
package's trainer writes (``training/jax_checkpoint.py``), with the JAX
``load_checkpoint``'s dispatch on file or directory, and no JAX installed:
its single pickled file and its orbax directory (``meta.pkl`` beside
``arrays/_METADATA``). ``checkpoint_format`` tells the four forms apart: a
file starting with a zip header (``PK``) is ``torch.save``'s, one starting
with a pickle's protocol byte (0x80) the JAX envelope; a directory with
``meta.pth`` is the port's, one with ``meta.pkl`` and ``arrays/_METADATA``
orbax's. Every form comes back as the port's dict: the weights as the
port's state dict (or read into a template's tensors), the optimizer state
as its SGD's (for a JAX checkpoint given the trainable parameters' names in
optimizer order, else None; there the momentum alone, without
``param_groups``, which the resuming trainer's optimizer keeps), the other
keys as they were.
"""

import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist

TORCH_FILE, TORCH_DIRECTORY, JAX_FILE, JAX_DIRECTORY = (
    "torch", "torch_sharded", "jax_pickle", "jax_orbax")
JAX_FORMATS = (JAX_FILE, JAX_DIRECTORY)
CHECKPOINT_KEYS = ("network_weights", "optimizer_state", "grad_scaler_state",
                   "logging", "_best_ema", "current_epoch", "init_args",
                   "trainer_name", "inference_allowed_mirroring_axes")
_WEIGHTS, _OPT = "network_weights", "optimizer_state"


def save_checkpoint(checkpoint: Dict[str, Any], filename: str,
                    sharded_views: Optional[Mapping[str, tuple]] = None) -> None:
    """Write atomically (a temporary file renamed over `filename`). With
    `sharded_views` (``parallel.sharding.dcp_state_dict``'s second value),
    every rank calls this and a directory is written."""
    missing = set(CHECKPOINT_KEYS) - set(checkpoint)
    if missing:
        raise KeyError(f"checkpoint lacks {sorted(missing)}")
    if sharded_views is not None:
        _save_sharded(checkpoint, filename, dict(sharded_views))
        return
    tmp = filename + ".tmp"
    torch.save(checkpoint, tmp)
    os.replace(tmp, filename)


def checkpoint_format(filename: str) -> str:
    """Which of the four checkpoint forms `filename` holds."""
    if os.path.isdir(filename):
        if os.path.isfile(os.path.join(filename, "meta.pth")):
            return TORCH_DIRECTORY
        if (os.path.isfile(os.path.join(filename, "meta.pkl"))
                and os.path.isfile(os.path.join(filename, "arrays", "_METADATA"))):
            return JAX_DIRECTORY
        raise ValueError(f"{filename}: a directory with neither meta.pth nor "
                         "meta.pkl and arrays/_METADATA is no checkpoint")
    with open(filename, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        return TORCH_FILE
    if head[:1] == bytes([0x80]):
        return JAX_FILE
    raise ValueError(f"{filename}: neither a torch.save zip nor a pickle")


def load_checkpoint(filename: str, network_template: Optional[Mapping] = None,
                    shard: Optional[tuple] = None,
                    trainable_names: Optional[list] = None) -> Dict[str, Any]:
    """The checkpoint with its tensors on the CPU, mapped from the file; or,
    from a sharded directory, the network weights read into
    `network_template`'s tensors in place (whole CPU tensors without one).
    A JAX checkpoint reads into `network_template` too where one is given
    (plain tensors, a model-axis rank's shards with `shard` = (rank, size)),
    and its optimizer state needs `trainable_names`."""
    fmt = checkpoint_format(filename)
    if fmt in JAX_FORMATS:
        from dinounet_tpu_torch.training.jax_checkpoint import load_jax_checkpoint

        return load_jax_checkpoint(filename, network_template, shard, trainable_names)
    if fmt == TORCH_DIRECTORY:
        return _load_sharded(filename, network_template)
    return torch.load(filename, map_location="cpu", weights_only=True, mmap=True)


def load_checkpoint_meta(filename: str) -> Dict[str, Any]:
    """The checkpoint's keys other than its tensors' (the training log, the
    epoch, ...): a file mapped as ``load_checkpoint`` maps it, or a sharded
    directory's sidecar alone."""
    fmt = checkpoint_format(filename)
    if fmt == TORCH_DIRECTORY:
        return torch.load(os.path.join(filename, "meta.pth"), weights_only=True)
    if fmt in JAX_FORMATS:
        from dinounet_tpu_torch.training import jax_checkpoint

        if fmt == JAX_DIRECTORY:
            return jax_checkpoint._plain(jax_checkpoint.unpickle(
                os.path.join(filename, "meta.pkl")))
        return {k: v for k, v in jax_checkpoint.read_jax_pickle(filename).items()
                if k not in (_WEIGHTS, _OPT)}
    return load_checkpoint(filename)


def _split_optimizer_state(state: Optional[dict]):
    """An optimizer state_dict -> its tensors by flat name, and the rest."""
    if state is None:
        return {}, None
    tensors, rest = {}, {"param_groups": state["param_groups"], "state": {}}
    for pid, entry in state["state"].items():
        rest["state"][pid] = {}
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                tensors[f"{pid}.{key}"] = value
            else:
                rest["state"][pid][key] = value
    return tensors, rest


def _join_optimizer_state(tensors: Mapping[str, torch.Tensor], rest: Optional[dict]):
    if rest is None:
        return None
    state = {pid: dict(entry) for pid, entry in rest["state"].items()}
    for name, value in tensors.items():
        pid, key = name.split(".", 1)
        state[int(pid)][key] = value
    return {"state": state, "param_groups": rest["param_groups"]}


def _save_sharded(checkpoint: Dict[str, Any], directory: str, views: dict) -> None:
    import torch.distributed.checkpoint as dcp

    opt_tensors, opt_rest = _split_optimizer_state(checkpoint[_OPT])
    arrays = {_WEIGHTS: dict(checkpoint[_WEIGHTS]), _OPT: opt_tensors}
    meta = {k: v for k, v in checkpoint.items() if k not in (_WEIGHTS, _OPT)}
    meta.update(optimizer_rest=opt_rest, views=views)
    main = dist.get_rank() == 0
    tmp = directory + ".tmp"
    if main:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    dist.barrier()
    dcp.save(arrays, storage_writer=dcp.FileSystemWriter(os.path.join(tmp, "arrays")))
    if main:
        torch.save(meta, os.path.join(tmp, "meta.pth"))
        if os.path.isfile(directory):
            os.remove(directory)  # a single file of an earlier run
        shutil.rmtree(directory, ignore_errors=True)
        os.replace(tmp, directory)
    dist.barrier()


def _load_sharded(directory: str, network_template: Optional[Mapping]) -> Dict[str, Any]:
    import torch.distributed.checkpoint as dcp

    meta = torch.load(os.path.join(directory, "meta.pth"), weights_only=True)
    views = meta.pop("views")
    reader = dcp.FileSystemReader(os.path.join(directory, "arrays"))
    stored = reader.read_metadata().state_dict_metadata

    def whole(key):
        md = stored[key]
        return torch.empty(tuple(md.size), dtype=md.properties.dtype)

    prefix = {k: k.split(".", 1) for k in stored}
    opt = {name: whole(k) for k, (top, name) in prefix.items() if top == _OPT}
    if network_template is None:
        weights = {name: whole(k) for k, (top, name) in prefix.items() if top == _WEIGHTS}
    else:  # a whole tensor held as a view in the directory is read as that view
        weights = {name: t.view(stored[f"{_WEIGHTS}.{name}"].size)
                   if name in views and not hasattr(t, "placements")
                   and tuple(t.shape) == tuple(views[name]) else t
                   for name, t in network_template.items()}
    no_dist = not (dist.is_available() and dist.is_initialized())
    dcp.load({_WEIGHTS: weights, _OPT: opt}, storage_reader=reader, no_dist=no_dist)
    if network_template is None:
        weights = {name: t.reshape(views[name]) if name in views else t
                   for name, t in weights.items()}
    else:
        weights = dict(network_template)
    meta[_WEIGHTS] = weights
    meta[_OPT] = _join_optimizer_state(opt, meta.pop("optimizer_rest"))
    return meta
