"""The megatron split of the backbone's blocks over the 'model' axis.

Counterpart of ``dinounet_tpu/parallel/sharding.py`` (``_BLOCK_RULES``,
``:32-85``), on the port's state-dict names (torch's (out, in) weights):

  * qkv / fc1 / w1 / w2: column-parallel, the output rows split
    (their biases with them);
  * proj / fc2 / w3:     row-parallel, the input columns split (their
    biases stay whole and are added once, after the all-reduce);
  * everything else -- patch embedding, norms, prefix tokens, LayerScale and
    every trainable parameter outside the backbone -- is replicated.

Only the frozen backbone's blocks are split, so nothing trainable is ever
sharded. The fused qkv projection is split by heads, not contiguously: its
(3C, C) weight is viewed as (3, C, C) and split along the middle C, so that
each rank holds whole heads of q, k and v and its attention runs on its
M / n_model heads (the JAX package splits the 3C columns contiguously and
lets GSPMD reshard behind it). The backbone runs under ``no_grad``: no
gradient flows back through the column-parallel inputs, so the only
collective is one all-reduce a matrix pair in the forward pass.

``shard_state_dict`` carries a full state dict (``models/convert.py``'s
output, a published backbone) to one rank's shard; ``dcp_state_dict``
wraps a rank's shards as DTensors over the mesh for
``torch.distributed.checkpoint`` (the qkv weight and bias as their (3, C,
...) views), with the full shape of each such view, so that a checkpoint
read back into one process gets the model's shapes.
"""

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

COLUMN = ("qkv", "fc1", "w1", "w2")
ROW = ("proj", "fc2", "w3")
# a backbone block's, a ViT's (blocks.N.) or a Block's own state-dict names
_BLOCK_PARAM = re.compile(r"^(?:(?:.*\.)?backbone\.blocks\.\d+\.|blocks\.\d+\.)?"
                          r"(?:attn|mlp)\.(qkv|proj|fc1|fc2|w1|w2|w3)\.(weight|bias)$")


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A rank's place on the model axis: its index, the axis's size and the
    process group of its model axis (None where no forward runs)."""
    rank: int
    size: int
    group: Any = None


def shard_dim(name: str) -> Optional[int]:
    """The dim of the torch tensor `name` that the model axis splits, or None
    where it is replicated."""
    m = _BLOCK_PARAM.match(name)
    if m is None:
        return None
    layer, kind = m.groups()
    if layer in COLUMN:
        return 0
    return 1 if kind == "weight" else None


def _is_qkv(name: str) -> bool:
    m = _BLOCK_PARAM.match(name)
    return m is not None and m.group(1) == "qkv"


def local_shape(name: str, shape: Tuple[int, ...], n_model: int) -> Tuple[int, ...]:
    """The shape of a rank's shard of a tensor of `shape`."""
    d = shard_dim(name)
    if d is None or n_model == 1:
        return tuple(shape)
    if shape[d] % (3 * n_model if _is_qkv(name) else n_model):
        raise ValueError(f"{name}: dim {d} of {tuple(shape)} does not split {n_model} ways")
    return tuple(s // n_model if i == d else s for i, s in enumerate(shape))


def shard_tensor(name: str, t: torch.Tensor, rank: int, n_model: int) -> torch.Tensor:
    """Rank `rank`'s shard of the full tensor `t` (a view where it can be)."""
    d = shard_dim(name)
    if d is None or n_model == 1:
        return t
    local_shape(name, tuple(t.shape), n_model)  # checks divisibility
    if _is_qkv(name):  # whole heads of q, k and v: split (3, C, ...) along C
        per = t.shape[0] // 3 // n_model
        v = t.reshape(3, t.shape[0] // 3, *t.shape[1:])
        return v[:, rank * per:(rank + 1) * per].reshape(3 * per, *t.shape[1:])
    return t.chunk(n_model, dim=d)[rank]


def shard_state_dict(state: Mapping[str, torch.Tensor], rank: int,
                     n_model: int) -> Dict[str, torch.Tensor]:
    """A full state dict -> rank `rank`'s: the block matrices split, the rest
    as they are."""
    return {k: shard_tensor(k, v, rank, n_model) for k, v in state.items()}


def dcp_state_dict(state: Mapping[str, torch.Tensor], mesh,
                   n_model: int) -> Tuple[Dict[str, Any], Dict[str, Tuple[int, ...]]]:
    """A rank's state dict with its shards as DTensors over `mesh` (replicated
    on 'data', split on 'model'), sharing the tensors' storage; and the full
    shapes of the entries held as (3, C, ...) views (qkv)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out, views = {}, {}
    for name, t in state.items():
        d = shard_dim(name)
        if d is None or n_model == 1:
            out[name] = t
            continue
        full = tuple(s * n_model if i == d else s for i, s in enumerate(t.shape))
        if _is_qkv(name):
            views[name] = full
            t = t.view(3, t.shape[0] // 3, *t.shape[1:])
            full = (3, full[0] // 3, *full[1:])
            d = 1
        out[name] = DTensor.from_local(t, mesh, [Replicate(), Shard(d)], run_check=False,
                                       shape=torch.Size(full),
                                       stride=torch.empty(full, device="meta").stride())
    return out, views
