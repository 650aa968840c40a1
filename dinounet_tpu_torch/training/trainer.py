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
    per-region counts of sigmoid > 0.5 (JAX ``trainer.py:386-412,494-505``).

The final validation (``perform_actual_validation``) predicts the
validation cases by sliding window with mirror TTA on the trainer's device,
exports them through the plans' reader/writer and writes their metrics to
``validation/summary.json``, as the JAX trainer does.

The cascade is not ported yet and raises ``NotImplementedError``.
"""

import os
import time
from typing import List, Tuple, Union

import numpy as np
import torch

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.configuration import ANISO_THRESHOLD
from dinounet_tpu_torch.training.augmentation import (AugmentConfig, AugmentConfig3D,
                                                      augment_batch_2d, augment_batch_3d,
                                                      downsample_seg_for_ds,
                                                      get_enlarged_patch_size,
                                                      get_enlarged_patch_size_3d)
from dinounet_tpu_torch.training.checkpointing import load_checkpoint, save_checkpoint
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
from dinounet_tpu_torch.utilities.label_handling import determine_num_input_channels
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
        if self.configuration_manager.previous_stage_name is not None:
            raise NotImplementedError("cascade training is not ported yet")

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

        os.makedirs(self.output_folder, exist_ok=True)
        self.log_file = os.path.join(self.output_folder,
                                     f"training_log_{int(time.time())}.txt")

    def print_to_log_file(self, *args):
        msg = " ".join(str(a) for a in args)
        timestamp = time.strftime("%Y-%m-%d %H:%M:%S")
        with open(self.log_file, "a") as f:
            f.write(f"{timestamp}: {msg}\n")
        print(msg, flush=True)

    # ------------------------------------------------------------------ setup

    @staticmethod
    def build_network_architecture(architecture_class_name: str, arch_init_kwargs: dict,
                                   arch_init_kwargs_req_import, num_input_channels: int,
                                   num_output_channels: int,
                                   enable_deep_supervision: bool = True):
        """The conv U-Net the plans name (ref get_network_from_plans.py:9):
        dotted torch class paths map onto the port's networks by their
        trailing class name, PlainConvUNet by default. Built on the host,
        fp32 parameters, weights not yet drawn."""
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
                      seed=None):
        """The configuration's network on `device`, its weights drawn from
        `seed` where one is given (else left for a state_dict to fill). The
        trainer, its final validation and the predictor all build through
        here. This one builds on the host, draws there and moves the
        network; a trainer class whose network should not pass through the
        host in full builds it on the device itself."""
        network = cls.build_network_architecture(
            configuration_manager.network_arch_class_name,
            configuration_manager.network_arch_init_kwargs,
            configuration_manager.network_arch_init_kwargs_req_import,
            num_input_channels, num_output_channels, enable_deep_supervision)
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
            seed=self.seed)
        adapter = getattr(getattr(self.network, "encoder", None), "dinov3_adapter", None)
        if adapter is not None:
            adapter.drop_path_generator = torch.Generator().manual_seed(self.seed + 1)
        self._aug_gen = torch.Generator().manual_seed(self.seed + 2)
        self.optimizer = self.configure_optimizers()
        n_params = sum(p.numel() for p in self.network.parameters())
        n_train = sum(p.numel() for p in self.trainable_parameters())
        self.print_to_log_file(f"Network initialized: {n_params / 1e6:.2f}M parameters, "
                               f"{n_train / 1e6:.2f}M trainable, on {self.device}")
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
        if not os.path.isfile(splits_file):
            splits = generate_crossval_split(sorted(dataset.keys()), seed=12345, n_splits=5)
            save_json(splits, splits_file)
        else:
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
        dataset_tr = nnUNetDataset(self.preprocessed_dataset_folder, tr_keys)
        dataset_val = nnUNetDataset(self.preprocessed_dataset_folder, val_keys)
        cm = self.configuration_manager
        loader = nnUNetDataLoader2D if len(cm.patch_size) == 2 else nnUNetDataLoader3D
        self.dataloader_train = loader(
            dataset_tr, cm.batch_size, initial_patch_size, cm.patch_size,
            self.label_manager, self.oversample_foreground_percent)
        self.dataloader_val = loader(
            dataset_val, cm.batch_size, cm.patch_size, cm.patch_size,
            self.label_manager, self.oversample_foreground_percent)
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
        if self.label_manager.has_regions:
            return dc_and_bce_loss(logits, self._seg_to_region_onehot(target),
                                   batch_dice=self.configuration_manager.batch_dice,
                                   use_ignore_label=self.label_manager.has_ignore_label)
        return dc_and_ce_loss(logits, target, batch_dice=self.configuration_manager.batch_dice,
                              smooth=1e-5, do_bg=False,
                              ignore_label=self.label_manager.ignore_label)

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
        (B, *spatial) int64 on the device."""
        data = torch.from_numpy(batch["data"]).to(self.device, non_blocking=True)
        seg = torch.from_numpy(batch["seg"][:, 0]).to(self.device, non_blocking=True)
        return data, seg.long()

    def train_step_host(self, batch) -> torch.Tensor:
        """Augment on the device, forward, DC+CE (over the deep-supervision
        heads where the network returns them), backward, clip, SGD step.
        Returns the loss as a device scalar (reading it synchronises)."""
        data, seg = self._batch_to_device(batch)
        data, seg = self._augment(data, seg)
        self.network.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._train_loss(self.network(data), seg)
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
            unpack_dataset(self.preprocessed_dataset_folder)
        self.get_dataloaders()
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
            self.logger.log("train_losses", float(torch.stack(losses).mean()), epoch)

            val = [self.validation_step_host(self.dataloader_val.generate_train_batch())
                   for _ in range(self.num_val_iterations_per_epoch)]
            val_loss = float(torch.stack([v[0] for v in val]).mean())
            tp, fp, fn = (torch.stack([v[i] for v in val]).sum(0).cpu().numpy()
                          for i in (1, 2, 3))
            self.on_validation_epoch_end(val_loss, tp, fp, fn, epoch)

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
        self.logger.plot_progress_png(self.output_folder)

    def on_train_end(self):
        self.current_epoch -= 1
        self.save_checkpoint(os.path.join(self.output_folder, "checkpoint_final.pth"))
        self.current_epoch += 1
        latest = os.path.join(self.output_folder, "checkpoint_latest.pth")
        if os.path.isfile(latest):
            os.remove(latest)
        self.print_to_log_file("Training done.")

    # ------------------------------------------------------------ checkpoints

    def save_checkpoint(self, filename: str):
        """ref :1083-1106 (the same key set)."""
        save_checkpoint({
            "network_weights": self.network.state_dict(),
            "optimizer_state": self.optimizer.state_dict(),
            "grad_scaler_state": None,
            "logging": self.logger.get_checkpoint(),
            "_best_ema": self._best_ema,
            "current_epoch": self.current_epoch + 1,
            "init_args": {"configuration": self.configuration_name, "fold": self.fold},
            "trainer_name": self.__class__.__name__,
            "inference_allowed_mirroring_axes": self.inference_allowed_mirroring_axes,
        }, filename)

    def load_checkpoint(self, filename_or_checkpoint: Union[str, dict]):
        """ref :1108-1144."""
        if not self.was_initialized:
            self.initialize()
        checkpoint = (load_checkpoint(filename_or_checkpoint)
                      if isinstance(filename_or_checkpoint, str) else filename_or_checkpoint)
        self.network.load_state_dict(checkpoint["network_weights"])
        if checkpoint.get("optimizer_state") is not None:
            self.optimizer.load_state_dict(checkpoint["optimizer_state"])
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
        (ref :1146-1293). Returns the metrics (None without
        gt_segmentations)."""
        from dinounet_tpu_torch.evaluation.metrics import compute_metrics_on_folder
        from dinounet_tpu_torch.inference.export import export_prediction_from_logits
        from dinounet_tpu_torch.inference.predictor import nnUNetPredictor

        if self.configuration_manager.next_stage_names:
            raise NotImplementedError(
                "exporting the validation for a cascade's next stage is not "
                "ported yet (ROADMAP.md, queue item 8)")
        inference_network = self.build_network(
            self.device, self.configuration_manager, self.num_input_channels,
            self.label_manager.num_segmentation_heads, enable_deep_supervision=False)
        predictor = nnUNetPredictor(tile_step_size=0.5, use_gaussian=True,
                                    use_mirroring=True, device=self.device)
        predictor.manual_initialization(
            inference_network, self.plans_manager, self.configuration_manager,
            [self.network.state_dict()], self.dataset_json, self.__class__.__name__,
            self.inference_allowed_mirroring_axes)

        validation_output_folder = os.path.join(self.output_folder, "validation")
        os.makedirs(validation_output_folder, exist_ok=True)
        _, val_keys = self.do_split()
        dataset_val = nnUNetDataset(self.preprocessed_dataset_folder, val_keys)
        for k in val_keys:
            self.print_to_log_file(f"predicting {k}")
            data, _, properties = dataset_val.load_case(k)
            prediction = predictor.predict_logits_from_preprocessed_data(np.asarray(data))
            export_prediction_from_logits(
                prediction, properties, self.configuration_manager, self.plans_manager,
                self.dataset_json, os.path.join(validation_output_folder, k),
                save_probabilities)

        gt_folder = os.path.join(self.preprocessed_dataset_folder_base, "gt_segmentations")
        if not os.path.isdir(gt_folder):
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
