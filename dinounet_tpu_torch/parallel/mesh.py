"""Process groups and the ('data', 'model') device mesh.

Counterpart of ``dinounet_tpu/parallel/mesh.py`` (ref: dinounet/run/
run_training.py:104-138): the JAX package initialises ``jax.distributed``
once per host and lays a ``Mesh`` over its devices; the port runs one
process a device, joined by ``torch.distributed`` (NCCL between cards,
gloo on the CPU), and lays a ``DeviceMesh`` over the processes.

``init_distributed`` joins the group from its arguments or from the
``torchrun`` / ``mp.spawn`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``). Only a repeated call with the same rank,
world size and backend is tolerated; a malformed address, a rank outside
the world, a world size other than the environment's, or more NCCL ranks
than visible cards raises (the rendezvous is ``tcp://host:port`` or a
shared ``file:///path``), so a misconfiguration never degrades to one
process. ``make_mesh`` puts the model axis innermost, as the JAX package
does: the ranks of one model group are consecutive.
"""

import datetime
import os
import re
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_ADDRESS = re.compile(r"^tcp://[^:/\s]+:(\d+)$")
_FILE = re.compile(r"^file:///\S+$")
# how long a rank waits for the others at the rendezvous and at a collective
_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                     backend: Optional[str] = None, init_method: Optional[str] = None,
                     device_type: str = "cuda") -> None:
    """Join the default process group (idempotent for the same rank, world
    size and backend). Arguments left None come from the environment that
    ``torchrun`` or the port's launcher sets."""
    env_rank, env_world = _env_int("RANK"), _env_int("WORLD_SIZE")
    rank = env_rank if rank is None else rank
    world_size = env_world if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("init_distributed needs a rank and a world size (arguments, or "
                         "RANK and WORLD_SIZE as torchrun sets them)")
    if env_world is not None and env_world != world_size:
        raise ValueError(f"world size {world_size} differs from the environment's "
                         f"WORLD_SIZE={env_world}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    backend = backend or default_backend(device_type)
    if dist.is_initialized():
        have = (dist.get_rank(), dist.get_world_size(), dist.get_backend())
        if have != (rank, world_size, backend):
            raise RuntimeError(f"the process group is already initialised as (rank, world "
                               f"size, backend) {have}, not {(rank, world_size, backend)}")
        return
    if backend == "nccl":
        visible = torch.cuda.device_count()
        if world_size > visible:
            raise ValueError(f"{world_size} NCCL ranks, but {visible} visible CUDA "
                             "device(s): NCCL takes one card a rank")
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            raise ValueError("no init_method, and no MASTER_ADDR / MASTER_PORT in the "
                             "environment")
        init_method = "env://"
    elif not (_FILE.match(init_method) or _ADDRESS.match(init_method)
              and 0 < int(_ADDRESS.match(init_method)[1]) < 65536):
        raise ValueError("init_method must be tcp://<host>:<port> or file:///<path>, got "
                         f"{init_method!r}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=_TIMEOUT)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; its backward sums the ranks' gradients (the
    reference's ``AllGatherGrad``, ref ddp_allgather.py:25-48)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group`'s ranks, differentiable."""
    return _AllReduceSum.apply(t, group)


def make_mesh(n_model: int = 1, device_type: str = "cuda"):
    """A 2-D ('data', 'model') DeviceMesh over every rank of the default
    group, the model axis innermost (``mesh.py:24-49``)."""
    world = dist.get_world_size()
    if n_model < 1 or world % n_model != 0:
        raise ValueError(f"world size {world} not divisible by n_model={n_model}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (world // n_model, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def wrap_data_parallel(network: torch.nn.Module, data_group, device: torch.device):
    """The trainer's data-parallel network (ref nnUNetTrainer.py:216-218):
    its BatchNorms take their statistics over `data_group`'s global batch,
    and it is wrapped in DistributedDataParallel over every rank of the
    default group, its frozen parameters left out (they are neither
    broadcast nor bucketed). The graph is static: the same parameters get a
    gradient every step, and a parameter the outputs do not reach (a head
    whose output the caller detached) none; the BatchNorm buffers are equal
    on every rank and are not broadcast."""
    from torch.nn.parallel import DistributedDataParallel

    from dinounet_tpu_torch.models.layers import BatchNorm

    for m in network.modules():
        if isinstance(m, BatchNorm):
            m.process_group = data_group
    frozen = [n for n, p in network.named_parameters() if not p.requires_grad]
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(network, frozen)
    return DistributedDataParallel(
        network, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, static_graph=True)
