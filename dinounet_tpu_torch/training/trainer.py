"""nnUNetTrainer: the training loop, PyTorch.

Counterpart of ``dinounet_tpu/training/trainer.py`` (ref: dinounet/training/
nnUNetTrainer/nnUNetTrainer.py) for 2-D and 3-D configurations on one device:
  * the reference's hyperparameters and folder layout: results/<dataset>/
    <Trainer>__<plans>__<configuration>/fold_N, the 5-fold split seeded 12345,
    250 train / 50 validation iterations per epoch, SGD with Nesterov momentum
    0.99 and weight decay 3e-5, PolyLR set per epoch, gradient clipping at 12,
    DC+CE loss, foreground oversampling 0.33, EMA(0.9) pseudo-Dice model
    selection, checkpoint_{latest,best,final}.pth;
  * the torch optimizer matches the JAX package's optax chain
    (clip_by_global_norm(12) -> add_decayed_weights -> trace(0.99, nesterov)
    -> scale by -lr, ``trainer.py:230-242``) step for step: clip first, then
    SGD adds the decay to the clipped gradient;
  * the device is explicit (``device=``, default ``cuda``) and nothing falls
    back to the CPU: a trainer built for ``cuda`` without a card raises;
  * augmentation runs on the device in torch (``augmentation.py``), fed by a
    host thread that prefetches numpy batches; compute is bf16 (the model's
    dtype), parameters and optimizer state fp32, no loss scaling;
  * the plans' networks, ``PlainConvUNet`` and ``ResidualEncoderUNet``
    (``models/plain_unet.py``, ``models/residual_unet.py``), in 2-D or 3-D,
    trained with deep supervision: every decoder head's DC+CE against the
    label map taken down to its size by nearest neighbour, weighted 1/2^i
    with the lowest head at 0 (JAX ``trainer.py:449-468``);
  * 3-D configurations: the enlarged patch for +-30 degrees about each
    axis (in-plane only and no through-plane growth for a dummy-2D patch),
    ``nnUNetDataLoader3D`` and the 3-D augmentation on the device (JAX
    ``trainer.py:324-380``);
  * one build makes the network at all three sites that need one (the
    trainer, its final validation, the predictor): ``build_network``, the
    plans' network on a device, built on the host and moved there unless
    the trainer class builds it there itself (``DinoUNetTrainer_7b``);
  * labels declared as regions train with DC+BCE on sigmoid outputs, the
    region targets made from the label map on the device, and validate with
    per-region counts of sigmoid > 0.5 (JAX ``trainer.py:386-412,494-505``);
  * the cascade: a configuration with a previous stage (3d_cascade_fullres
    after 3d_lowres) reads that stage's validation segmentations as a
    second label channel, which the spatial augmentation moves with the
    labels; the train step then turns it into augmented one-hot input
    channels (``cascade_augment_batch``), the validation step into plain
    one-hot ones (JAX ``trainer.py:425-449,476-483``).

Data parallelism (``parallel/``): where the process belongs to an initialised
``torch.distributed`` group (one process a card, started by ``run.py``'s
``num_gpus`` or by ``torchrun``), the trainer lays a ('data', 'model') mesh
over the ranks, the model axis from ``DINOUNET_TPU_MODEL_AXIS`` (default 1,
JAX ``trainer.py:146-165``), and
  * wraps the network in ``DistributedDataParallel`` for the train step.
    The frozen backbone is left out of it (no broadcast of its weights, no
    gradient buckets); a head that the loss weighs 0 (deep supervision's
    lowest, as in JAX) comes out of it detached and goes without a
    gradient, as in one process. The wrapper spans every rank: the ranks of one model group hold one batch,
    and averaging their equal gradients too keeps their trainable weights
    equal bit for bit;
  * takes the plans' batch as the global batch, rounded up to a multiple of
    the data axis, each data rank loading its part (JAX
    ``trainer.py:348-351``), the foreground oversampling decided by a
    sample's index in the global batch;
  * draws each data rank's loader, augmentation and drop-path from its own
    streams (seeded from the trainer's seed and the data rank; the ranks of
    one model group share them);
  * makes batch Dice, a masked cross-entropy's count and the BatchNorm
    statistics those of the global batch (all-reduced over 'data', with
    their gradients), and the logged losses and validation counts too;
  * writes files on rank 0 only (log, ``debug.json``, plans copies, splits,
    checkpoints), except that with a model axis every rank writes its
    shards of a ``torch.distributed.checkpoint`` directory;
  * predicts the final validation's cases a data rank a case in turn, then
    rank 0 computes the metrics.

The final validation (``perform_actual_validation``) predicts the
validation cases by sliding window with mirror TTA on the trainer's device,
exports them through the plans' reader/writer and writes their metrics to
``validation/summary.json``, as the JAX trainer does.

A configuration with next stages (3d_lowres) also writes each validation
case's segmentation, resampled to every next stage's preprocessed shape, to
``predicted_next_stage/<stage>/<case>.npz`` (``export.resample_and_save``),
which the next stage trains and validates on.
"""

import os
import shutil
import time
from typing import List, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.configuration import ANISO_THRESHOLD
from dinounet_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, make_mesh,
                                              wrap_data_parallel)
from dinounet_tpu_torch.parallel.sharding import ModelShard, dcp_state_dict
from dinounet_tpu_torch.training.augmentation import (AugmentConfig, AugmentConfig3D,
                                                      augment_batch_2d, augment_batch_3d,
                                                      cascade_augment_batch,
                                                      downsample_seg_for_ds,
                                                      get_enlarged_patch_size,
                                                      get_enlarged_patch_size_3d)
from dinounet_tpu_torch.training.checkpointing import (JAX_FORMATS, TORCH_DIRECTORY,
                                                       checkpoint_format, load_checkpoint,
                                                       save_checkpoint)
from dinounet_tpu_torch.training.dataloading import (nnUNetDataLoader2D, nnUNetDataLoader3D,
                                                     nnUNetDataset, unpack_dataset)
from dinounet_tpu_torch.training.logger import nnUNetLogger
from dinounet_tpu_torch.training.losses import (dc_and_bce_loss, dc_and_ce_loss,
                                                deep_supervision_loss,
                                                deep_supervision_weights,
                                                one_hot_channels)
from dinounet_tpu_torch.training.lr_scheduler import poly_lr
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.json_export import load_json, save_json
from dinounet_tpu_torch.utilities.label_handling import (convert_labelmap_to_one_hot,
                                                        determine_num_input_channels)
from dinounet_tpu_torch.utilities.misc import generate_crossval_split
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


def sgd_nesterov(params, lr: float, weight_decay: float) -> torch.optim.SGD:
    """SGD with Nesterov momentum 0.99 and weight decay: with the gradients
    clipped to norm 12 before each step (``clip_and_step``) this is the JAX
    package's optax chain step for step: decay added to the clipped
    gradient, trace m = g + 0.99 m, update g + 0.99 m, scaled by -lr."""
    return torch.optim.SGD(params, lr=lr, momentum=0.99, nesterov=True,
                           weight_decay=weight_decay)


def clip_and_step(optimizer: torch.optim.Optimizer, max_norm: float = 12.0) -> None:
    """Clip the gradients of the optimizer's parameters to a global norm of
    `max_norm`, then step."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    torch.nn.utils.clip_grad_norm_(params, max_norm)
    optimizer.step()


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trainer was asked for a CUDA device and none is "
                           "available; pass device='cpu' to train on the CPU")
    return dev


class _UnweightedDetached(torch.nn.Module):
    """What the data-parallel wrapper runs: the network, its outputs that the
    loss weighs 0 (deep supervision's lowest head, JAX
    ``trainer.py:449-468``) detached. DDP traces the graph back from the
    outputs to learn which parameters get a gradient; a head left in the
    graph that no loss term reaches is waited for, and the next step's
    gradients are not reduced."""

    def __init__(self, network: torch.nn.Module):
        super().__init__()
        self.network = network

    def forward(self, x):
        out = self.network(x)
        if not isinstance(out, (list, tuple)):
            return out
        return [o if w else o.detach()
                for w, o in zip(deep_supervision_weights(len(out)), out)]


def model_axis() -> int:
    """The model axis's size, ``DINOUNET_TPU_MODEL_AXIS`` (JAX
    ``trainer.py:157``), 1 by default."""
    return int(os.environ.get("DINOUNET_TPU_MODEL_AXIS", "1"))


@registry.trainers.register("nnUNetTrainer")
class nnUNetTrainer:
    def __init__(self, plans: dict, configuration: str, fold: int, dataset_json: dict,
                 unpack_dataset: bool = True, device=None):
        self.device = _device(device)
        self.plans_manager = PlansManager(plans)
        self.configuration_manager = self.plans_manager.get_configuration(configuration)
        self.configuration_name = configuration
        self.dataset_json = dataset_json
        self.fold = fold
        self.unpack_dataset = unpack_dataset

        self.preprocessed_dataset_folder_base = os.path.join(
            paths.nnUNet_preprocessed(), self.plans_manager.dataset_name)
        self.output_folder_base = os.path.join(
            paths.nnUNet_results(), self.plans_manager.dataset_name,
            self.__class__.__name__ + "__" + self.plans_manager.plans_name + "__"
            + configuration)
        self.output_folder = os.path.join(self.output_folder_base, f"fold_{fold}")
        self.preprocessed_dataset_folder = os.path.join(
            self.preprocessed_dataset_folder_base,
            self.configuration_manager.data_identifier)

        # hyperparameters (ref :146-153)
        self.initial_lr = 1e-2
        self.weight_decay = 3e-5
        self.oversample_foreground_percent = 0.33
        self.num_iterations_per_epoch = 250
        self.num_val_iterations_per_epoch = 50
        self.num_epochs = 1000
        self.current_epoch = 0
        self.enable_deep_supervision = True

        self.label_manager = self.plans_manager.get_label_manager(dataset_json)

        # seeds the weights, the augmentation draws and the drop-path draws;
        # set it before initialize() for a reproducible run
        self.seed = int(np.random.SeedSequence().entropy % (2 ** 63))
        self.num_input_channels = None
        self.network = None
        self.optimizer = None
        self.augment_cfg = None
        self._aug_gen = None
        self.dataloader_train = None
        self.dataloader_val = None
        self.logger = nnUNetLogger()
        self._best_ema = None
        self.inference_allowed_mirroring_axes = None
        self.was_initialized = False
        self._init_ranks()

        os.makedirs(self.output_folder, exist_ok=True)
        self.log_file = os.path.join(self.output_folder,
                                     f"training_log_{int(time.time())}.txt")

    def _init_ranks(self):
        """The rank's place on the ('data', 'model') mesh: one data rank of
        one, no groups, outside a process group."""
        self.distributed = dist.is_available() and dist.is_initialized()
        n_model = model_axis()
        self.mesh = self.data_group = self.model_shard = self._ddp = None
        if not self.distributed:
            if n_model != 1:
                raise ValueError(f"DINOUNET_TPU_MODEL_AXIS={n_model} needs {n_model} or "
                                 "more ranks; this process is not in a process group")
            self.rank, self.world_size, self.n_model = 0, 1, 1
            self.data_rank, self.n_data = 0, 1
            return
        self.rank, self.world_size = dist.get_rank(), dist.get_world_size()
        self.n_model = n_model
        self.mesh = make_mesh(n_model, self.device.type)
        self.data_rank, self.n_data = self.rank // n_model, self.world_size // n_model
        self.data_group = self.mesh.get_group(DATA_AXIS)
        if n_model > 1:
            self.model_shard = ModelShard(self.rank % n_model, n_model,
                                          self.mesh.get_group(MODEL_AXIS))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def train_network(self) -> torch.nn.Module:
        """What the train step calls: the DistributedDataParallel wrapper in
        a process group, else the network."""
        return self.network if self._ddp is None else self._ddp

    def _barrier(self):
        if self.distributed:
            dist.barrier()

    def _stream_seed(self, k: int) -> int:
        """The seed of the k-th random stream of this data rank (the
        trainer's seed + k on data rank 0)."""
        return (self.seed + k + self.data_rank * 0x9E3779B97F4A7C15) % 2 ** 64

    def _shard_kw(self) -> dict:
        return {} if self.model_shard is None else {"shard": self.model_shard}

    def print_to_log_file(self, *args):
        if not self.is_main:
            return
        msg = " ".join(str(a) for a in args)
        timestamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with open(self.log_file, "a") as f:
            f.write(f"{timestamp}: {msg}\n")
        print(msg, flush=True)

    # ------------------------------------------------------------------ setup

    @property
    def is_cascaded(self) -> bool:
        """A cascade stage: the configuration names a previous stage."""
        return self.configuration_manager.previous_stage_name is not None

    @property
    def folder_with_segs_from_previous_stage(self):
        """results/<dataset>/<Trainer>__<plans>__<previous stage>/
        predicted_next_stage/<configuration> (ref nnUNetTrainer.py:131-137)."""
        if not self.is_cascaded:
            return None
        return os.path.join(
            paths.nnUNet_results(), self.plans_manager.dataset_name,
            self.__class__.__name__ + "__" + self.plans_manager.plans_name + "__"
            + self.configuration_manager.previous_stage_name,
            "predicted_next_stage", self.configuration_name)

    @staticmethod
    def build_network_architecture(architecture_class_name: str, arch_init_kwargs: dict,
                                   arch_init_kwargs_req_import, num_input_channels: int,
                                   num_output_channels: int,
                                   enable_deep_supervision: bool = True, shard=None):
        """The conv U-Net the plans name (ref get_network_from_plans.py:9):
        dotted torch class paths map onto the port's networks by their
        trailing class name, PlainConvUNet by default. Built on the host,
        fp32 parameters, weights not yet drawn. It has no backbone, so a
        `shard` of a model axis leaves it whole."""
        from dinounet_tpu_torch.models.plain_unet import PlainConvUNet, PlainUNetConfig
        from dinounet_tpu_torch.models.residual_unet import (ResidualEncoderUNet,
                                                             ResidualUNetConfig)

        class_name = (architecture_class_name or "PlainConvUNet").rsplit(".", 1)[-1]
        if class_name == "ResidualEncoderUNet":
            return ResidualEncoderUNet(ResidualUNetConfig.from_plans_arch(
                arch_init_kwargs, num_output_channels, enable_deep_supervision),
                num_input_channels)
        return PlainConvUNet(PlainUNetConfig.from_plans_arch(
            arch_init_kwargs, num_output_channels, enable_deep_supervision),
            num_input_channels)

    @classmethod
    def build_network(cls, device, configuration_manager, num_input_channels: int,
                      num_output_channels: int, enable_deep_supervision: bool = True,
                      seed=None, shard=None):
        """The configuration's network on `device`, its weights drawn from
        `seed` where one is given (else left for a state_dict to fill). The
        trainer, its final validation and the predictor all build through
        here. This one builds on the host, draws there and moves the
        network; a trainer class whose network should not pass through the
        host in full builds it on the device itself. `shard` is a rank's
        place on a model axis, passed on to ``build_network_architecture``:
        the model axis splits only a DINOv3 backbone's blocks (the DinoUNet
        trainers build them as the rank's shards); a network without a
        backbone (the plans' conv U-Nets) is built whole on every rank, as
        GSPMD replicates it in the JAX package."""
        cm = configuration_manager
        network = cls.build_network_architecture(
            cm.network_arch_class_name, cm.network_arch_init_kwargs,
            cm.network_arch_init_kwargs_req_import, num_input_channels,
            num_output_channels, enable_deep_supervision,
            **({} if shard is None else {"shard": shard}))
        if seed is not None:
            network.init_weights(seed)
        return network.to(device)

    def initialize(self):
        if self.was_initialized:
            raise RuntimeError("initialize called twice")
        self.num_input_channels = determine_num_input_channels(
            self.plans_manager, self.configuration_manager, self.dataset_json)
        self.network = self.build_network(
            self.device, self.configuration_manager, self.num_input_channels,
            self.label_manager.num_segmentation_heads, self.enable_deep_supervision,
            seed=self.seed, **self._shard_kw())
        adapter = getattr(getattr(self.network, "encoder", None), "dinov3_adapter", None)
        if adapter is not None:
            adapter.drop_path_generator = torch.Generator().manual_seed(
                self._stream_seed(1))
        self._aug_gen = torch.Generator().manual_seed(self._stream_seed(2))
        self.optimizer = self.configure_optimizers()
        if self.distributed:
            self._ddp = wrap_data_parallel(_UnweightedDetached(self.network),
                                           self.data_group, self.device)
        n_params = sum(p.numel() for p in self.network.parameters())
        n_train = sum(p.numel() for p in self.trainable_parameters())
        self.print_to_log_file(f"Network initialized: {n_params / 1e6:.2f}M parameters, "
                               f"{n_train / 1e6:.2f}M trainable, on {self.device}"
                               + (f", rank 0 of {self.world_size} (data axis {self.n_data}, "
                                  f"model axis {self.n_model})" if self.distributed else ""))
        self.was_initialized = True


    def trainable_parameters(self) -> List[torch.nn.Parameter]:
        return [p for p in self.network.parameters() if p.requires_grad]

    def configure_optimizers(self) -> torch.optim.Optimizer:
        """SGD, Nesterov momentum 0.99, weight decay 3e-5 over the trainable
        parameters; the learning rate is set per epoch (PolyLR) and the
        gradients are clipped to norm 12 before each step (ref :485-490)."""
        return sgd_nesterov(self.trainable_parameters(), self.initial_lr,
                            self.weight_decay)

    def current_lr(self) -> float:
        return poly_lr(self.initial_lr, self.current_epoch, self.num_epochs)

    # -------------------------------------------------------------- splitting

    def do_split(self) -> Tuple[List[str], List[str]]:
        """5-fold CV split seeded 12345, kept in splits_final.json
        (ref :530-585)."""
        dataset = nnUNetDataset(self.preprocessed_dataset_folder)
        splits_file = os.path.join(self.preprocessed_dataset_folder_base,
                                   "splits_final.json")
        if self.fold == "all":
            keys = sorted(dataset.keys())
            return keys, keys
        if not os.path.isfile(splits_file) and self.is_main:
            save_json(generate_crossval_split(sorted(dataset.keys()), seed=12345, n_splits=5),
                      splits_file)
        self._barrier()
        splits = load_json(splits_file)
        if self.fold < len(splits):
            return splits[self.fold]["train"], splits[self.fold]["val"]
        # fold outside the split file: random 80/20 (ref :570-580)
        rnd = np.random.RandomState(seed=12345 + self.fold)
        keys = np.sort(list(dataset.keys()))
        idx_tr = rnd.choice(len(keys), int(len(keys) * 0.8), replace=False)
        idx_val = [i for i in range(len(keys)) if i not in idx_tr]
        return [keys[i] for i in idx_tr], [keys[i] for i in idx_val]

    # ------------------------------------------------------------ dataloaders

    def _configure_rotation_dummyDA_mirroring_and_initial_patch_size(self):
        """Rotation ranges, the loader's enlarged patch and the mirror axes
        (ref :391-446). 2-D: +-15 degrees for an elongated patch, else any
        angle. 3-D: +-30 degrees about each axis, or for an anisotropic
        (dummy-2D) patch any in-plane angle, no through-plane rotation and
        no through-plane growth of the patch."""
        patch_size = self.configuration_manager.patch_size
        if len(patch_size) == 2:
            if max(patch_size) / min(patch_size) > 1.5:
                rotation = (-15.0 / 360 * 2 * np.pi, 15.0 / 360 * 2 * np.pi)
            else:
                rotation = (-np.pi, np.pi)
            mirror_axes = (0, 1)
            initial_patch_size = get_enlarged_patch_size(
                patch_size, max(abs(rotation[0]), abs(rotation[1])), (0.85, 1.25))
            self.inference_allowed_mirroring_axes = mirror_axes
            return rotation, False, initial_patch_size, mirror_axes
        do_dummy_2d = (max(patch_size) / patch_size[0]) > ANISO_THRESHOLD
        if do_dummy_2d:
            rotation = ((-np.pi, np.pi), (0.0, 0.0), (0.0, 0.0))
        else:
            r = 30.0 / 360 * 2 * np.pi
            rotation = ((-r, r),) * 3
        mirror_axes = (0, 1, 2)
        initial_patch_size = get_enlarged_patch_size_3d(
            patch_size, [max(abs(a), abs(b)) for a, b in rotation], (0.85, 1.25))
        if do_dummy_2d:
            initial_patch_size[0] = patch_size[0]
        self.inference_allowed_mirroring_axes = mirror_axes
        return rotation, do_dummy_2d, initial_patch_size, mirror_axes

    def get_dataloaders(self):
        rotation, do_dummy_2d, initial_patch_size, mirror_axes = \
            self._configure_rotation_dummyDA_mirroring_and_initial_patch_size()
        tr_keys, val_keys = self.do_split()
        prev = self.folder_with_segs_from_previous_stage
        dataset_tr = nnUNetDataset(self.preprocessed_dataset_folder, tr_keys,
                                   folder_with_segs_from_previous_stage=prev)
        dataset_val = nnUNetDataset(self.preprocessed_dataset_folder, val_keys,
                                    folder_with_segs_from_previous_stage=prev)
        cm = self.configuration_manager
        loader = nnUNetDataLoader2D if len(cm.patch_size) == 2 else nnUNetDataLoader3D
        # the plans' batch is the global batch, rounded up to a multiple of
        # the data axis; this data rank loads its part of it
        global_batch = -(-cm.batch_size // self.n_data) * self.n_data
        local = global_batch // self.n_data
        part = dict(global_batch_size=global_batch, global_offset=self.data_rank * local)
        self.dataloader_train = loader(
            dataset_tr, local, initial_patch_size, cm.patch_size,
            self.label_manager, self.oversample_foreground_percent,
            rng=np.random.default_rng(self._stream_seed(3)), **part)
        self.dataloader_val = loader(
            dataset_val, local, cm.patch_size, cm.patch_size,
            self.label_manager, self.oversample_foreground_percent,
            rng=np.random.default_rng(self._stream_seed(4)), **part)
        if len(cm.patch_size) == 2:
            self.augment_cfg = AugmentConfig(
                patch_size=tuple(cm.patch_size)[-2:], rotation_range=rotation,
                mirror_axes=mirror_axes, use_mask_for_norm=tuple(cm.use_mask_for_norm))
        else:
            self.augment_cfg = AugmentConfig3D(
                patch_size=tuple(cm.patch_size), rotation_ranges=rotation,
                mirror_axes=mirror_axes, use_mask_for_norm=tuple(cm.use_mask_for_norm),
                scale_in_plane_only=do_dummy_2d)

    # ------------------------------------------------------------- loss/steps

    def _seg_to_region_onehot(self, seg: torch.Tensor) -> torch.Tensor:
        """(B, H, W) labels -> (B, R, H, W) float region channels, with a
        trailing channel marking the ignore label where there is one (ref
        ConvertSegmentationToRegionsTransform, JAX ``trainer.py:386-400``)."""
        lm = self.label_manager
        channels = []
        for region in lm.all_regions:
            labels = region if isinstance(region, (list, tuple)) else (region,)
            mask = torch.zeros_like(seg, dtype=torch.bool)
            for label in labels:
                mask = mask | (seg == label)
            channels.append(mask)
        if lm.has_ignore_label:
            channels.append(seg == lm.ignore_label)
        return torch.stack(channels, dim=1).float()

    def _loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The rank's share of the global batch's loss (its loss outside a
        process group)."""
        group = getattr(self, "data_group", None)
        if self.label_manager.has_regions:
            return dc_and_bce_loss(logits, self._seg_to_region_onehot(target),
                                   batch_dice=self.configuration_manager.batch_dice,
                                   use_ignore_label=self.label_manager.has_ignore_label,
                                   reduce_group=group)
        return dc_and_ce_loss(logits, target, batch_dice=self.configuration_manager.batch_dice,
                              smooth=1e-5, do_bg=False,
                              ignore_label=self.label_manager.ignore_label,
                              reduce_group=group)

    def _train_loss(self, output, target: torch.Tensor) -> torch.Tensor:
        """The loss of a train-mode forward: with deep supervision (a list of
        heads, highest resolution first) the weighted sum over the heads of
        the loss against the target taken down to each head's size (JAX
        ``trainer.py:449-468``), else the plain loss."""
        if not isinstance(output, (list, tuple)):
            return self._loss(output, target)
        top = output[0].shape[2:]
        scales = [tuple(o.shape[2 + i] / top[i] for i in range(len(top)))
                  for o in output]
        return deep_supervision_loss(self._loss, output,
                                     downsample_seg_for_ds(target, scales),
                                     deep_supervision_weights(len(output)))

    def _augment(self, data: torch.Tensor, seg: torch.Tensor):
        if isinstance(self.augment_cfg, AugmentConfig3D):
            return augment_batch_3d(data, seg, self.augment_cfg, self._aug_gen)
        return augment_batch_2d(data, seg, self.augment_cfg, self._aug_gen)

    def _batch_to_device(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Loader batch -> data (B, C, *spatial) float32 and labels
        (B, *spatial) int64 on the device; a cascade stage keeps both label
        channels, (B, 2, *spatial): the labels, then the previous stage's
        segmentation."""
        data = torch.from_numpy(batch["data"]).to(self.device, non_blocking=True)
        seg = batch["seg"] if self.is_cascaded else batch["seg"][:, 0]
        return data, torch.from_numpy(seg).to(self.device, non_blocking=True).long()

    def _with_previous_stage(self, data: torch.Tensor, seg: torch.Tensor, augment: bool):
        """A cascade batch's (data, seg with its two channels) -> data with the
        previous stage's one-hot channels appended (augmented in training),
        and the labels alone."""
        labels = self.label_manager.foreground_labels
        prev = seg[:, 1]
        if augment:
            onehot = cascade_augment_batch(prev, labels, self._aug_gen)
        else:
            prev = torch.where(prev < 0, torch.zeros_like(prev), prev)
            onehot = torch.stack([prev == label for label in labels], 1)
        return torch.cat([data, onehot.to(data.dtype)], 1), seg[:, 0]

    def train_step_host(self, batch) -> torch.Tensor:
        """Augment on the device, forward, DC+CE (over the deep-supervision
        heads where the network returns them), backward, clip, SGD step.
        Returns the loss as a device scalar (reading it synchronises)."""
        data, seg = self._batch_to_device(batch)
        data, seg = self._augment(data, seg)
        if self.is_cascaded:
            data, seg = self._with_previous_stage(data, seg, augment=True)
        self.network.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._train_loss(self.train_network(data), seg)
        loss.backward()
        clip_and_step(self.optimizer, 12.0)
        return loss.detach()

    @torch.no_grad()
    def validation_step_host(self, batch):
        """Eval-mode forward (the fused serving path), loss and hard
        pseudo-Dice counts tp / fp / fn per class, or per region: sigmoid >
        0.5 against each region's target, outside the ignore label
        (ref :946-1008)."""
        data, seg = self._batch_to_device(batch)
        if self.is_cascaded:
            data, seg = self._with_previous_stage(data, seg, augment=False)
        seg = torch.where(seg < 0, torch.zeros_like(seg), seg)
        self.network.eval()
        out = self.network(data)
        loss = self._loss(out, seg)
        axes = (0,) + tuple(range(2, out.dim()))
        if self.label_manager.has_regions:
            target = self._seg_to_region_onehot(seg)
            if self.label_manager.has_ignore_label:
                mask = 1.0 - target[:, -1:]
                target = target[:, :-1]
            else:
                mask = 1.0
            pred = (torch.sigmoid(out.float()) > 0.5).float()
            tp = (pred * target * mask).sum(axes)
            fp = (pred * (1 - target) * mask).sum(axes)
            fn = ((1 - pred) * target * mask).sum(axes)
            return loss, tp, fp, fn
        num_classes = self.label_manager.num_segmentation_heads
        ignore = self.label_manager.ignore_label
        if ignore is not None:
            mask = (seg != ignore)[:, None].float()
            seg = torch.where(seg == ignore, torch.zeros_like(seg), seg)
        else:
            mask = 1.0
        pred = one_hot_channels(out.argmax(1), num_classes)
        target = one_hot_channels(seg, num_classes)
        tp = (pred * target * mask).sum(axes)
        fp = (pred * (1 - target) * mask).sum(axes)
        fn = ((1 - pred) * target * mask).sum(axes)
        return loss, tp, fp, fn

    # ------------------------------------------------------------ train loop

    def on_train_start(self):
        if not self.was_initialized:
            self.initialize()
        if self.unpack_dataset:
            self.print_to_log_file("unpacking dataset...")
            if self.is_main:
                unpack_dataset(self.preprocessed_dataset_folder)
            self._barrier()
        self.get_dataloaders()
        if self.is_main:
            save_json(self.plans_manager.plans,
                      os.path.join(self.output_folder_base, "plans.json"), sort_keys=False)
            save_json(self.dataset_json, os.path.join(self.output_folder_base, "dataset.json"))
            self._save_debug_information()

    def _save_debug_information(self):
        dct = {k: str(v) for k, v in self.__dict__.items()
               if not k.startswith("_") and isinstance(v, (str, int, float, bool))}
        dct["device"] = str(self.device)
        if self.device.type == "cuda":
            dct["device_name"] = torch.cuda.get_device_name(self.device)
        save_json(dct, os.path.join(self.output_folder, "debug.json"))

    class _BatchPrefetcher:
        """A host thread that generates batches a bounded distance ahead: the
        host's work per iteration is the memmap patch extraction, overlapped
        with the device step (ref nnUNetTrainer.py:643-649 uses worker
        processes for the CPU augmentation, which runs on the device here)."""

        def __init__(self, loader, depth: int = 2):
            import queue
            import threading

            self._loader = loader
            self._q = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._exc = None
            self._t = threading.Thread(target=self._work, daemon=True)
            self._t.start()

        def _work(self):
            import queue

            try:
                while not self._stop.is_set():
                    batch = self._loader.generate_train_batch()
                    while not self._stop.is_set():
                        try:
                            self._q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced on the consumer side
                self._exc = e

        def next(self):
            import queue

            while True:
                if self._exc is not None:
                    raise self._exc
                try:
                    return self._q.get(timeout=1.0)
                except queue.Empty:
                    if not self._t.is_alive() and self._exc is None:
                        raise RuntimeError("batch prefetcher thread died")

        def close(self):
            self._stop.set()
            self._t.join(timeout=5.0)

    def run_training(self):
        self.on_train_start()
        prefetch = self._BatchPrefetcher(self.dataloader_train)
        try:
            self._run_training_epochs(prefetch)
        finally:
            prefetch.close()
        self.on_train_end()

    def _run_training_epochs(self, prefetch):
        for epoch in range(self.current_epoch, self.num_epochs):
            self.logger.log("epoch_start_timestamps", time.time(), epoch)
            self.print_to_log_file(f"\nEpoch {epoch}")
            lr = self.current_lr()
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.print_to_log_file(f"Current learning rate: {round(lr, 5)}")

            losses = [self.train_step_host(prefetch.next())
                      for _ in range(self.num_iterations_per_epoch)]
            val = [self.validation_step_host(self.dataloader_val.generate_train_batch())
                   for _ in range(self.num_val_iterations_per_epoch)]
            # the two mean losses and the summed counts; over the data axis
            # the ranks' shares of the losses average to the global ones
            C = val[0][1].numel()
            packed = torch.cat([torch.stack(losses).mean().view(1).float(),
                                torch.stack([v[0] for v in val]).mean().view(1).float()]
                               + [torch.stack([v[i] for v in val]).sum(0).float()
                                  for i in (1, 2, 3)])
            if self.distributed:
                dist.all_reduce(packed, group=self.data_group)
                packed[:2] /= self.n_data
            packed = packed.cpu().numpy()
            self.logger.log("train_losses", float(packed[0]), epoch)
            tp, fp, fn = (packed[2 + i * C:2 + (i + 1) * C] for i in range(3))
            self.on_validation_epoch_end(float(packed[1]), tp, fp, fn, epoch)

            self.logger.log("epoch_end_timestamps", time.time(), epoch)
            self.logger.log("lrs", lr, epoch)
            self.on_epoch_end(epoch)
            self.current_epoch = epoch + 1

    def on_validation_epoch_end(self, val_loss, tp, fp, fn, epoch):
        """Global Dice per foreground class (the counts past the background's)
        or per region (every count) from the summed counts (ref :1010-1052)."""
        self.logger.log("val_losses", val_loss, epoch)
        if not self.label_manager.has_regions:
            tp, fp, fn = tp[1:], fp[1:], fn[1:]
        dice = [float(2 * i / (2 * i + j + k)) if (2 * i + j + k) > 0 else float("nan")
                for i, j, k in zip(tp, fp, fn)]
        self.logger.log("mean_fg_dice", float(np.nanmean(dice)), epoch)
        self.logger.log("dice_per_class_or_region", dice, epoch)
        self.print_to_log_file(
            f"train_loss {round(self.logger.my_fantastic_logging['train_losses'][epoch], 4)}")
        self.print_to_log_file(f"val_loss {round(val_loss, 4)}")
        self.print_to_log_file(f"Pseudo dice {[round(x, 4) for x in dice]}")

    def on_epoch_end(self, epoch):
        """checkpoint_latest every 50 epochs and at the last, checkpoint_best
        on a new best EMA pseudo-Dice (ref :1057-1081)."""
        if (epoch + 1) % 50 == 0 or epoch == self.num_epochs - 1:
            self.save_checkpoint(os.path.join(self.output_folder, "checkpoint_latest.pth"))
        ema = self.logger.my_fantastic_logging["ema_fg_dice"][epoch]
        if self._best_ema is None or ema > self._best_ema:
            self._best_ema = ema
            self.print_to_log_file(f"Yayy! New best EMA pseudo Dice: {round(ema, 4)}")
            self.save_checkpoint(os.path.join(self.output_folder, "checkpoint_best.pth"))
        if self.is_main:
            self.logger.plot_progress_png(self.output_folder)

    def on_train_end(self):
        self.current_epoch -= 1
        self.save_checkpoint(os.path.join(self.output_folder, "checkpoint_final.pth"))
        self.current_epoch += 1
        latest = os.path.join(self.output_folder, "checkpoint_latest.pth")
        if self.is_main and os.path.isfile(latest):
            os.remove(latest)
        elif self.is_main and os.path.isdir(latest):  # a sharded checkpoint
            shutil.rmtree(latest)
        self.print_to_log_file("Training done.")

    # ------------------------------------------------------------ checkpoints

    def save_checkpoint(self, filename: str):
        """ref :1083-1106 (the same key set). Rank 0 writes the file; with a
        model axis every rank writes its shards of a
        ``torch.distributed.checkpoint`` directory at `filename`."""
        sharded = self.n_model > 1
        if not (sharded or self.is_main):
            return
        weights, views = self.network.state_dict(), None
        if sharded:
            weights, views = dcp_state_dict(weights, self.mesh, self.n_model)
        save_checkpoint({
            "network_weights": weights,
            "optimizer_state": self.optimizer.state_dict(),
            "grad_scaler_state": None,
            "logging": self.logger.get_checkpoint(),
            "_best_ema": self._best_ema,
            "current_epoch": self.current_epoch + 1,
            "init_args": {"configuration": self.configuration_name, "fold": self.fold},
            "trainer_name": self.__class__.__name__,
            "inference_allowed_mirroring_axes": self.inference_allowed_mirroring_axes,
        }, filename, sharded_views=views)

    def load_checkpoint(self, filename_or_checkpoint: Union[str, dict]):
        """ref :1108-1144. A sharded checkpoint's directory is read onto this
        rank's shards in place (in one process, into the whole network). A
        checkpoint of the JAX package's trainer (its pickled file or its
        orbax directory) is read in place too, each tensor from the region
        this rank holds, its momentum into this trainer's SGD under the
        SGD's own learning rate, momentum and decay."""
        if not self.was_initialized:
            self.initialize()
        fmt = (checkpoint_format(filename_or_checkpoint)
               if isinstance(filename_or_checkpoint, str) else None)
        if fmt in JAX_FORMATS:
            shard = self.model_shard
            checkpoint = load_checkpoint(
                filename_or_checkpoint, network_template=self.network.state_dict(),
                shard=None if shard is None else (shard.rank, shard.size),
                trainable_names=[n for n, p in self.network.named_parameters()
                                 if p.requires_grad])
        elif fmt == TORCH_DIRECTORY:
            weights = self.network.state_dict()
            if self.n_model > 1:
                weights, _ = dcp_state_dict(weights, self.mesh, self.n_model)
            checkpoint = load_checkpoint(filename_or_checkpoint, network_template=weights)
        else:
            checkpoint = (load_checkpoint(filename_or_checkpoint)
                          if isinstance(filename_or_checkpoint, str)
                          else filename_or_checkpoint)
            self.network.load_state_dict(checkpoint["network_weights"])
        optimizer_state = checkpoint.get("optimizer_state")
        if optimizer_state is not None:
            if fmt in JAX_FORMATS:  # the momentum alone, under this optimizer's groups
                optimizer_state = dict(optimizer_state,
                                       param_groups=self.optimizer.state_dict()["param_groups"])
            self.optimizer.load_state_dict(optimizer_state)
        self.logger.load_checkpoint(checkpoint["logging"])
        self._best_ema = checkpoint["_best_ema"]
        self.current_epoch = checkpoint["current_epoch"]
        self.inference_allowed_mirroring_axes = checkpoint.get(
            "inference_allowed_mirroring_axes")

    # --------------------------------------------------- final validation

    def perform_actual_validation(self, save_probabilities: bool = False):
        """Sliding-window prediction of every validation case of the split
        on the trainer's device, export to <output_folder>/validation, and
        the metrics against gt_segmentations into its summary.json
        (ref :1146-1293). A cascade stage feeds the previous stage's
        segmentation in as one-hot channels; each case is also exported,
        resampled, for every next stage (ref :1240-1256). Each case's exports
        (host resampling and writing: the case's, each next stage's) run
        behind the device in a thread pool, each its own task, at most two
        cases behind, as ``predict_from_files`` exports (the reference's
        export pool). In a process group the data ranks take the cases in
        turn (the ranks of one model group predict a case together, the
        first of them exports it); after a barrier rank 0 computes the
        metrics (ref :1146-1293). Returns the metrics (None without
        gt_segmentations, and on the other ranks)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from dinounet_tpu_torch.evaluation.metrics import compute_metrics_on_folder
        from dinounet_tpu_torch.inference.export import (export_prediction_from_logits,
                                                         resample_and_save)
        from dinounet_tpu_torch.inference.predictor import nnUNetPredictor

        inference_network = self.build_network(
            self.device, self.configuration_manager, self.num_input_channels,
            self.label_manager.num_segmentation_heads, enable_deep_supervision=False,
            **self._shard_kw())
        predictor = nnUNetPredictor(tile_step_size=0.5, use_gaussian=True,
                                    use_mirroring=True, device=self.device)
        predictor.manual_initialization(
            inference_network, self.plans_manager, self.configuration_manager,
            [self.network.state_dict()], self.dataset_json, self.__class__.__name__,
            self.inference_allowed_mirroring_axes)

        validation_output_folder = os.path.join(self.output_folder, "validation")
        os.makedirs(validation_output_folder, exist_ok=True)
        _, val_keys = self.do_split()
        dataset_val = nnUNetDataset(
            self.preprocessed_dataset_folder, val_keys,
            folder_with_segs_from_previous_stage=self.folder_with_segs_from_previous_stage)
        next_stages = self.configuration_manager.next_stage_names or []
        for n in next_stages:
            os.makedirs(os.path.join(self.output_folder_base, "predicted_next_stage", n),
                        exist_ok=True)

        def export_next_stage(prediction, properties, k, n):
            next_cfg = self.plans_manager.get_configuration(n)
            next_case = nnUNetDataset(os.path.join(self.preprocessed_dataset_folder_base,
                                                   next_cfg.data_identifier), [k])
            resample_and_save(
                prediction, next_case.load_case(k)[0].shape[1:],
                os.path.join(self.output_folder_base, "predicted_next_stage", n, k + ".npz"),
                self.plans_manager, self.configuration_manager, properties,
                self.dataset_json)

        exporting = self.model_shard is None or self.model_shard.rank == 0
        with ThreadPoolExecutor(max_workers=2 * (1 + len(next_stages))) as pool:
            exports = deque()
            for k in val_keys[self.data_rank::self.n_data]:
                self.print_to_log_file(f"predicting {k}")
                data, seg, properties = dataset_val.load_case(k)
                data = np.asarray(data)
                if self.is_cascaded:
                    data = np.vstack((data, convert_labelmap_to_one_hot(
                        np.asarray(seg[-1]), self.label_manager.foreground_labels,
                        data.dtype)))
                prediction = predictor.predict_logits_from_preprocessed_data(data)
                if not exporting:
                    continue
                exports.append([pool.submit(
                    export_prediction_from_logits, prediction, properties,
                    self.configuration_manager, self.plans_manager, self.dataset_json,
                    os.path.join(validation_output_folder, k), save_probabilities)] + [
                    pool.submit(export_next_stage, prediction, properties, k, n)
                    for n in next_stages])
                while len(exports) > 2:
                    [f.result() for f in exports.popleft()]
            while exports:
                [f.result() for f in exports.popleft()]

        self._barrier()
        gt_folder = os.path.join(self.preprocessed_dataset_folder_base, "gt_segmentations")
        if not self.is_main or not os.path.isdir(gt_folder):
            return None
        metrics = compute_metrics_on_folder(
            gt_folder, validation_output_folder,
            os.path.join(validation_output_folder, "summary.json"),
            self.plans_manager.image_reader_writer_class(),
            self.dataset_json["file_ending"],
            self.label_manager.foreground_regions if self.label_manager.has_regions
            else self.label_manager.foreground_labels,
            self.label_manager.ignore_label)
        self.print_to_log_file("Mean Validation Dice:", metrics["foreground_mean"]["Dice"])
        return metrics
