"""Starting one process a rank, and what each rank runs under.

``spawn(fn, world_size, *args, backend=, devices=)`` starts `world_size`
processes with ``torch.multiprocessing`` (the spawn method: a fresh
interpreter each, as CUDA requires), joins them into one process group
through a file in a temporary directory of the call's own (no port to
collide with another group's), calls ``fn(device, *args)`` in each and
returns the ranks' return values in rank order (each written by its rank
with ``torch.save`` to that directory, read after every rank has ended).
A rank that raises ends the others and the call re-raises. `fn` and `args`
are pickled: `fn` must be a module-level function.

Devices: by default rank r takes ``cuda:r`` (more ranks than visible cards
raise), or every rank the CPU when ``devices="cpu"``; an explicit list
gives each rank its own (two ranks may share a card under gloo). The
backend defaults to NCCL on cards and gloo on the CPU. CPU ranks share the
host's cores between them (``torch.set_num_threads``).
"""

import os
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from dinounet_tpu_torch.parallel.mesh import default_backend, init_distributed


def rank_devices(world_size: int,
                 devices: Union[None, str, Sequence] = None) -> List[torch.device]:
    """One device a rank: `devices` as given (a list), every rank on the CPU
    ("cpu"), or rank r on ``cuda:r`` (None or "cuda")."""
    if devices is not None and not isinstance(devices, str):
        out = [torch.device(d) for d in devices]
        if len(out) != world_size:
            raise ValueError(f"{len(out)} devices for {world_size} ranks")
        return out
    kind = torch.device(devices or "cuda").type
    if kind == "cpu":
        return [torch.device("cpu")] * world_size
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > visible:
        raise ValueError(f"{world_size} ranks on their own cards, but {visible} visible "
                         "CUDA device(s)")
    return [torch.device("cuda", r) for r in range(world_size)]


def cpu_threads(world_size: int) -> int:
    """The torch threads of each of `world_size` CPU ranks: the host's cores
    shared between them."""
    return max(1, (os.cpu_count() or 1) // world_size)


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               devices: List[torch.device], args: tuple, out_dir: str) -> None:
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(cpu_threads(world_size))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    init_distributed(rank, world_size, backend, f"file://{os.path.join(out_dir, 'store')}",
                     device_type=device.type)
    try:
        result = fn(device, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, backend: Optional[str] = None,
          devices: Union[None, str, Sequence] = None) -> list:
    """Run ``fn(device, *args)`` on `world_size` ranks; their return values."""
    devs = rank_devices(world_size, devices)
    backend = backend or default_backend(devs[0].type)
    out_dir = tempfile.mkdtemp(prefix="dinounet_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, backend, devs, args, out_dir),
            nprocs=world_size, join=True)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
