"""The JAX package's trained checkpoints, read without JAX.

The JAX trainer (``dinounet_tpu/training/checkpointing.py``) writes
``checkpoint_*.pth`` in one of two forms, and its ``load_checkpoint``
dispatches on which it finds:

* **a single pickled file** (model axis 1): the checkpoint dict with the
  flax variables as nested dicts of numpy arrays (``ml_dtypes.bfloat16``
  for bf16 ones) and the optax state as optax's own classes. ``read_jax_
  pickle`` reads it with a restricted unpickler: numpy's array and dtype
  globals, bf16 arrays turned into ``torch.bfloat16`` tensors from their
  raw bits (``numpy.dtype(ml_dtypes.bfloat16)`` is itself a pickled call,
  intercepted in ``find_class``), optax's state classes (and flax's
  containers, if any) as plain stand-ins that keep the class name and the
  fields. Any other global, ``jax.*`` included, raises
  ``JaxCheckpointError`` without being imported.
* **an orbax directory** (model axis > 1): ``arrays/`` is an OCDBT database
  of zarr v2 arrays (``compression/ocdbt.py``, ``compression/zarr2.py``)
  whose tree ``arrays/_METADATA`` lists, the optimizer state flattened to
  ``leaf_0000, leaf_0001, ...`` in ``jax.tree.leaves`` order; the other
  keys are in ``meta.pkl``, read by the same unpickler.
  ``read_orbax_directory`` returns the nested tree.

``load_jax_checkpoint`` returns the port's checkpoint dict: the weights as
the port's state dict, the optimizer state as its SGD's, the other keys as
they were. Without a template the weights go through ``models/convert.py::
state_dict_from_flax`` (fp32 tensors). With a template (a state dict of the
port's network: whole tensors, a model-axis rank's shards with `shard`, or
DTensors' local parts) each tensor is read in place, in its own dtype, from
only the region of the stored array that it holds: ``_torch_layout``'s
transposes and transposed-conv flips inverted, the scanned backbone's
stacked blocks indexed, and a rank's fused qkv shard read as three regions
(the port splits q, k and v by heads, ``parallel/sharding.py``).

The optimizer: the trainer's optax chain (``trainer.py:227-242``) is
``multi_transform`` of SGD over the trainable leaves and ``set_to_zero`` over
the frozen backbone. Its ``TraceState.trace`` is torch's SGD momentum
buffer step for step (Nesterov 0.99 after decoupled-in-gradient decay, the
port's ``sgd_nesterov``); frozen leaves are ``MaskedNode``s. In the orbax
list the leaves are the trainable params' traces in the sorted order of the
flax tree's keys, then the schedule's count. ``optimizer_state_from_optax``
maps the traces to the port's SGD state dict, in the order of the port's
``configure_optimizers``, without its ``param_groups``: the resuming trainer
loads the momentum under its own optimizer's hyperparameters.
"""

import json
import os
import pickle
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dinounet_tpu_torch.compression.ocdbt import OcdbtStore
from dinounet_tpu_torch.compression.zarr2 import ZarrArray
from dinounet_tpu_torch.models.convert import (_torch_layout, _torch_name,
                                               state_dict_from_flax)
from dinounet_tpu_torch.parallel.sharding import _is_qkv, shard_dim

_WEIGHTS, _OPT = "network_weights", "optimizer_state"
_SCAN = "blocks_scan"


class JaxCheckpointError(ValueError):
    """A JAX checkpoint this reader refuses (an unknown pickled global, a
    layout it does not take) or that does not match its template."""


# ---------------------------------------------------------------- pickles


class StandIn(tuple):
    """A pickled class of optax or flax, kept as its name and field values."""

    _module, _name, _fields = "", "", ()

    def __new__(cls, *args):
        return tuple.__new__(cls, args)

    def __getattr__(self, field):
        if field in type(self)._fields:
            return self[type(self)._fields.index(field)]
        raise AttributeError(f"{type(self)._name} has no field {field!r}")

    def __setstate__(self, state):  # NamedTuples pickle no state; others keep none
        pass

    def __repr__(self):
        fields = type(self)._fields or [f"_{i}" for i in range(len(self))]
        inner = ", ".join(f"{f}={v!r}" for f, v in zip(fields, self))
        return f"{type(self)._name}({inner})"


# the optax state classes of the JAX trainer's chain and their fields
_OPTAX_FIELDS = {
    "EmptyState": (), "MaskedNode": (), "TraceState": ("trace",),
    "MaskedState": ("inner_state",), "PartitionState": ("inner_states",),
    "MultiTransformState": ("inner_states",), "ScaleByScheduleState": ("count",),
    "ScaleByLearningRateState": ("count",), "ScaleByScheduleOrLearningRateState":
    ("count",), "InjectHyperparamsState": ("count", "hyperparams", "inner_state"),
}
_STAND_INS: Dict[Tuple[str, str], type] = {}


def _stand_in(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STAND_INS:
        _STAND_INS[key] = type(name, (StandIn,), {
            "_module": module, "_name": name, "_fields": _OPTAX_FIELDS.get(name, ())})
    return _STAND_INS[key]


class _BF16:
    """``ml_dtypes.bfloat16`` as found by the unpickler; also the dtype
    built from it (``numpy.dtype(bfloat16, ...)`` then BUILD)."""

    def __setstate__(self, state):
        pass


_BF16_DTYPE = _BF16()


def _dtype(obj, align=False, copy=False):
    if obj is _BF16 or obj is _BF16_DTYPE:
        return _BF16()
    return np.dtype(obj, align, copy)


def _tensor(raw, dtype, shape, fortran: bool = False) -> torch.Tensor:
    """A tensor of `shape` over raw little-endian bytes of `dtype`, without
    a copy: a read-only view of the pickle's bytes (the readers copy from
    it, never into it), so the file's arrays are held once."""
    array = np.frombuffer(raw, np.uint16 if isinstance(dtype, _BF16) else dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(array)
    if isinstance(dtype, _BF16):
        t = t.view(torch.bfloat16)
    if fortran:
        return t.reshape(tuple(reversed(shape))).permute(*reversed(range(len(shape))))
    return t.reshape(tuple(shape))


class _ArrayBuilder:
    """What ``numpy``'s ``_reconstruct`` returns to the unpickler: BUILD
    hands it (version, shape, dtype, fortran, raw bytes), and the loaded
    tree's builders are swapped for their tensors after the load."""

    value = None

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(raw, list):  # object arrays pickle their elements
            raise JaxCheckpointError("object arrays are not read")
        self.value = _tensor(raw, dtype, shape, fortran)


def _reconstruct(cls, shape, typecode):
    return _ArrayBuilder()


def _frombuffer(buf, dtype, shape, order):
    return _tensor(buf, dtype, shape, order == "F")


def _scalar(dtype, raw=None):
    if isinstance(dtype, _BF16):
        return float(_tensor(raw, dtype, ()).float())
    return np.frombuffer(raw, dtype)[0].item()


def _frozen_dict(*args):
    return dict(*args)


_NUMPY_GLOBALS = {
    "_reconstruct": _reconstruct, "_frombuffer": _frombuffer, "scalar": _scalar,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BF16
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if (module, name) == ("numpy", "ndarray"):
            return np.ndarray
        if module in ("numpy.core.multiarray", "numpy._core.multiarray",
                      "numpy.core.numeric", "numpy._core.numeric") and name in _NUMPY_GLOBALS:
            return _NUMPY_GLOBALS[name]
        if (module, name) == ("collections", "OrderedDict"):
            return OrderedDict
        if root == "optax":
            return _stand_in(module, name)
        if root == "flax" and name in ("FrozenDict", "freeze"):
            return _frozen_dict
        raise JaxCheckpointError(
            f"the checkpoint names the global {module}.{name}, which the reader "
            "of JAX checkpoints does not take (it imports no JAX package)")


def _finish(obj):
    """Swap the array builders for their tensors, everywhere in a tree."""
    if isinstance(obj, _ArrayBuilder):
        if obj.value is None:
            raise JaxCheckpointError("an array was never given its contents")
        return obj.value
    if isinstance(obj, StandIn):
        return type(obj)(*[_finish(v) for v in obj])
    if isinstance(obj, dict):
        return type(obj)((k, _finish(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_finish(v) for v in obj)
    return obj


def _plain(obj):
    """A meta value as plain Python: tensors as lists."""
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def unpickle(path: str):
    with open(path, "rb") as f:
        return _finish(_Unpickler(f).load())


def read_jax_pickle(path: str) -> Dict[str, Any]:
    """The single-file checkpoint: flax variables as nested dicts of
    tensors, the optax state as stand-ins, the rest as plain values."""
    out = unpickle(path)
    if not isinstance(out, dict) or _WEIGHTS not in out:
        raise JaxCheckpointError(f"{path} is not a JAX trainer checkpoint")
    return {k: v if k in (_WEIGHTS, _OPT) else _plain(v) for k, v in out.items()}


# ------------------------------------------------------------------ orbax


class _TensorLeaf:
    """A stored array held in memory, read by region as a zarr array is."""

    def __init__(self, t: torch.Tensor):
        self.t, self.shape, self.dtype = t, tuple(t.shape), t.dtype

    def read_region(self, index) -> torch.Tensor:
        return self.t[tuple(index)]

    def read(self) -> torch.Tensor:
        return self.t


def orbax_leaves(directory: str) -> Dict[Tuple[str, ...], ZarrArray]:
    """The arrays of an orbax directory by their tree paths."""
    arrays = os.path.join(directory, "arrays")
    with open(os.path.join(arrays, "_METADATA")) as f:
        metadata = json.load(f)
    if metadata.get("use_zarr3"):
        raise JaxCheckpointError(f"{arrays}: zarr v3 arrays are not supported")
    if not metadata.get("use_ocdbt", False):
        raise JaxCheckpointError(f"{arrays}: orbax's layout without OCDBT is not supported")
    store = OcdbtStore(arrays)
    leaves = {}
    for entry in metadata["tree_metadata"].values():
        path = tuple(str(k["key"]) for k in entry["key_metadata"])
        leaves[path] = ZarrArray(store, ".".join(path))
    return leaves


def _nest(leaves: Mapping[Tuple[str, ...], Any]) -> dict:
    tree: dict = {}
    for path, value in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def read_orbax_directory(directory: str) -> Dict[str, Any]:
    """The orbax checkpoint as nested dicts of whole tensors (the optimizer
    state as its ``leaf_NNNN`` dict), with meta.pkl's keys."""
    out = _plain(unpickle(os.path.join(directory, "meta.pkl")))
    out.update(_nest({p: a.read() for p, a in orbax_leaves(directory).items()}))
    return out


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """Either form, as the JAX ``load_checkpoint`` returns it."""
    if os.path.isdir(path):
        return read_orbax_directory(path)
    return read_jax_pickle(path)


# ------------------------------------------------------------ the optax tree


def tree_leaves(obj) -> List[Any]:
    """``jax.tree.leaves`` of a read tree: dicts by sorted key, tuples,
    lists and stand-ins in order, None and empty stand-ins no leaf."""
    if obj is None:
        return []
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in tree_leaves(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in tree_leaves(v)]
    return [obj]


def _paths(tree: Mapping, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            out += _paths(tree[k], prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


def trainable(path: Tuple[str, ...]) -> bool:
    """The JAX trainer's label (``_trainable_label_tree`` with
    ``backbone_param_filter``): everything but the backbone trains."""
    return not (len(path) > 0 and path[0] == "backbone")


def trace_leaf_paths(params: Mapping) -> List[Tuple[str, ...]]:
    """The params paths whose traces are the optax state's leaves, in
    ``jax.tree.leaves(tx.init(params))`` order (the count comes after)."""
    return [p for p in _paths(params) if trainable(p)]


def _traces(opt_state) -> Optional[Mapping]:
    """The trace tree of the one TraceState in a stand-in tree."""
    found = []

    def walk(obj):
        if isinstance(obj, StandIn):
            if type(obj)._name == "TraceState":
                found.append(obj.trace)
                return
        if isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise JaxCheckpointError(f"the optax state holds {len(found)} TraceStates, not 1")
    return found[0]


def trace_by_path(opt_state, params: Mapping) -> Dict[Tuple[str, ...], torch.Tensor]:
    """The momentum of every trainable param, by flax path: from the single
    file's stand-ins or from the orbax ``leaf_NNNN`` dict."""
    paths = trace_leaf_paths(params)
    if isinstance(opt_state, Mapping) and opt_state and all(
            str(k).startswith("leaf_") for k in opt_state):
        leaves = [opt_state[k] for k in sorted(opt_state)]
        if len(leaves) != len(paths) + 1:
            raise JaxCheckpointError(
                f"{len(leaves)} optimizer leaves for {len(paths)} trainable params "
                "(the trace of each, then the count)")
        out = dict(zip(paths, leaves[:-1]))
    else:
        trace = _traces(opt_state)
        out = {}
        for p in paths:
            node = trace
            for k in p:
                node = node[k]
            out[p] = node
    for p, t in out.items():
        shape = _shape_at(params, p)
        if tuple(t.shape) != shape:
            raise JaxCheckpointError(f"the trace of {'/'.join(p)} is {tuple(t.shape)}, "
                                     f"its param {shape}")
    return out


def _shape_at(tree: Mapping, path: Tuple[str, ...]) -> Tuple[int, ...]:
    node = tree
    for k in path:
        node = node[k]
    return tuple(node.shape)


def port_names(path: Tuple[str, ...], depth: Optional[int] = None):
    """[(port name, scan index or None, flax path below the top)] of one
    flax leaf (its path below the collection); a leaf of the scanned
    backbone gives one per block of its `depth`."""
    top, rest = path[0], path[1:]
    if top == "backbone" and rest and rest[0] == _SCAN:
        below = "/".join(rest[2:])  # blocks_scan/block/<...>
        return [(_torch_name(top, f"block{i}/{below}"), i, f"block{i}/{below}")
                for i in range(depth)]
    sub = "/".join(rest)
    return [(_torch_name(top, sub), None, sub)]


def optimizer_state_from_optax(traces: Mapping[Tuple[str, ...], torch.Tensor],
                               trainable_names: Sequence[str]) -> dict:
    """The port's SGD state dict without its ``param_groups``: parameter i
    of `trainable_names` (the order of ``configure_optimizers``) gets its
    trace, in its weight's layout, as ``momentum_buffer``. The learning
    rate, momentum and decay are the resuming trainer's own (its
    optimizer's groups), not read from the optax state."""
    by_name = {}
    for path, t in traces.items():
        for name, _, sub in port_names(path):
            by_name[name] = torch.as_tensor(
                np.ascontiguousarray(_torch_layout(sub, _numpy(t)))).float()
    missing = [n for n in trainable_names if n not in by_name]
    extra = sorted(set(by_name) - set(trainable_names))
    if missing or extra:
        raise JaxCheckpointError(f"the optax traces do not match the trainable "
                                 f"parameters: missing {missing[:5]}, extra {extra[:5]}")
    return {"state": {i: {"momentum_buffer": by_name[n]}
                      for i, n in enumerate(trainable_names)}}


# ------------------------------------------------------------------ weights


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _as_numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _as_numpy_tree(v) for k, v in tree.items()}
    return _numpy(tree)


def weights_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict_from_flax`` of read variables (fp32 tensors)."""
    return state_dict_from_flax(_as_numpy_tree(variables))


def _regions(name: str, full: Tuple[int, ...], local: Tuple[int, ...], shard):
    """[(port slice of the template, port slice of the whole)] for a
    template tensor of shape `local` of the whole `full`."""
    whole = tuple(slice(0, n) for n in full)
    if tuple(local) == tuple(full):
        return [(whole, whole)]
    d = shard_dim(name)
    if d is None or shard is None:
        raise JaxCheckpointError(f"{name}: template {tuple(local)}, stored {tuple(full)}")
    rank, n = shard
    if _is_qkv(name):
        c, per = full[0] // 3, full[0] // 3 // n
        out = []
        for j in range(3):
            mine = (slice(j * per, (j + 1) * per),) + whole[1:]
            theirs = (slice(j * c + rank * per, j * c + (rank + 1) * per),) + whole[1:]
            out.append((mine, theirs))
        return out
    size = full[d] // n
    mine = tuple(slice(0, size) if i == d else s for i, s in enumerate(whole))
    theirs = tuple(slice(rank * size, (rank + 1) * size) if i == d else s
                   for i, s in enumerate(whole))
    if tuple(local) != tuple(s.stop - s.start for s in mine):
        raise JaxCheckpointError(f"{name}: template {tuple(local)} is not a {n}-way "
                                 f"shard of {tuple(full)}")
    return [(mine, theirs)]


def _stored_index(sub: str, scan: Optional[int], port_slice, ndim_stored: int):
    """The stored array's region that holds a port slice of one leaf: a 2-D
    kernel is the port weight transposed; a scanned leaf adds its block's
    index. Everything else is read whole (it is never split)."""
    lead = () if scan is None else (slice(scan, scan + 1),)
    if sub.endswith("/kernel") and len(port_slice) == 2:
        return lead + (port_slice[1], port_slice[0])
    if len(port_slice) == 1:
        return lead + tuple(port_slice)
    return lead + (slice(None),) * (ndim_stored - len(lead))


def fill_template(leaves: Mapping[Tuple[str, ...], Any], template: Mapping[str, torch.Tensor],
                  shard=None) -> None:
    """Read every tensor of `template` in place from the stored leaves
    (``{(collection, *flax path): array}``), each from the region it holds."""
    sources = {}
    for key, arr in leaves.items():
        collection, path = key[0], key[1:]
        if collection not in ("params", "batch_stats"):
            continue
        for name, scan, sub in port_names(path, arr.shape[0] if arr.shape else None):
            sources[name] = (arr, scan, sub)
    missing = [n for n in template if n not in sources
               and not n.endswith("num_batches_tracked")]
    if missing:
        raise JaxCheckpointError(f"the checkpoint lacks {missing[:5]}")
    with torch.no_grad():
        for name, t in template.items():
            if name.endswith("num_batches_tracked") and name not in sources:
                t.zero_()
                continue
            arr, scan, sub = sources[name]
            local = t.to_local() if hasattr(t, "to_local") else t
            stored = tuple(arr.shape[1:] if scan is not None else arr.shape)
            full = tuple(_torch_layout(sub, torch.empty(stored, device="meta")).shape)
            linear = sub.endswith("/kernel") and len(full) == 2
            if local.dim() == 3 and linear and _is_qkv(name):
                local = local.view(-1, local.shape[-1])  # a DTensor's (3, C/n, C) view
            for mine, theirs in _regions(name, full, tuple(local.shape), shard):
                piece = arr.read_region(_stored_index(sub, scan, theirs, len(arr.shape)))
                piece = piece[0] if scan is not None else piece
                local[mine].copy_(piece.t() if linear else _torch_layout(sub, piece))


# --------------------------------------------------------------- the entry


def load_jax_checkpoint(path: str, network_template: Optional[Mapping] = None,
                        shard=None, trainable_names: Optional[Sequence[str]] = None
                        ) -> Dict[str, Any]:
    """A JAX trainer checkpoint (file or orbax directory) as the port's
    checkpoint dict. `network_template`: read the weights into its tensors
    in place (`shard` (rank, model axis size) for a rank's shards), else
    ``network_weights`` is ``state_dict_from_flax``'s. `trainable_names`:
    the port's trainable parameters in optimizer order, for
    ``optimizer_state`` (the momentum alone: ``optimizer_state_from_
    optax``); without them it is None."""
    directory = os.path.isdir(path)
    if directory:
        out = _plain(unpickle(os.path.join(path, "meta.pkl")))
        leaves = orbax_leaves(path)
        weights = {p[1:]: a for p, a in leaves.items() if p[0] == _WEIGHTS}
        opt = {p[1]: a.read() for p, a in leaves.items() if p[0] == _OPT}
    else:
        out = read_jax_pickle(path)
        flat = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, Mapping):
                    walk(v, prefix + (k,))
                else:
                    flat[prefix + (k,)] = _TensorLeaf(v)

        walk(out[_WEIGHTS], ())
        weights = flat
        opt = out.get(_OPT)
    params = _nest({p[1:]: a for p, a in weights.items() if p[0] == "params"})
    if network_template is None:
        variables = _nest({p: a.read() for p, a in weights.items()})
        out[_WEIGHTS] = weights_from_flax(variables)
    else:
        fill_template(weights, network_template, shard)
        out[_WEIGHTS] = dict(network_template)
    if opt is None or trainable_names is None:
        out[_OPT] = None
    else:
        out[_OPT] = optimizer_state_from_optax(trace_by_path(opt, params), trainable_names)
    out.setdefault("grad_scaler_state", None)
    return out
