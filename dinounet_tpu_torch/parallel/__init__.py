"""Multi-GPU training and the backbone's model axis, ``torch.distributed``.

Counterpart of ``dinounet_tpu/parallel/`` (ref: dinounet/run/run_training.py:
104-194, dinounet/utilities/ddp_allgather.py:25-48). The JAX package lays a
GSPMD mesh over the devices of one process; the port runs one process a
device (``launch.spawn``, or ``torchrun``), joins them with NCCL on cards or
gloo on the CPU (``mesh.init_distributed``) and lays a ('data', 'model')
``DeviceMesh`` over them (``mesh.make_mesh``). The trainer wraps its network
in ``DistributedDataParallel``; batch Dice, BatchNorm statistics and the
validation counts are all-reduced over the 'data' axis; the backbone's blocks
(ViT-S/B/L and 7B) split megatron-style over the 'model' axis (``sharding``), and sharded
checkpoints go through ``torch.distributed.checkpoint``
(``training/checkpointing.py``). ``dryrun`` holds the counterparts of
``__graft_entry__.py``'s two multi-device gates.
"""

from dinounet_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, init_distributed,
                                              make_mesh)
from dinounet_tpu_torch.parallel.sharding import (ModelShard, shard_dim, shard_state_dict,
                                                  shard_tensor)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "ModelShard", "init_distributed", "make_mesh",
           "shard_dim", "shard_state_dict", "shard_tensor"]
