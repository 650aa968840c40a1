"""nnUNetTrainer: the 2-D training loop, PyTorch.

Counterpart of ``dinounet_tpu/training/trainer.py`` (ref: dinounet/training/
nnUNetTrainer/nnUNetTrainer.py) for 2-D configurations on one device:
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
    dtype), parameters and optimizer state fp32, no loss scaling.

Regions (DC+BCE training), the cascade, 3-D configurations, deep-supervision
outputs and ``perform_actual_validation`` (export, image I/O and metrics) are
not ported yet and raise ``NotImplementedError``.
"""

import os
import time
from typing import List, Tuple, Union

import numpy as np
import torch

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.training.augmentation import (AugmentConfig, augment_batch_2d,
                                                      get_enlarged_patch_size)
from dinounet_tpu_torch.training.checkpointing import load_checkpoint, save_checkpoint
from dinounet_tpu_torch.training.dataloading import (nnUNetDataLoader2D, nnUNetDataset,
                                                     unpack_dataset)
from dinounet_tpu_torch.training.logger import nnUNetLogger
from dinounet_tpu_torch.training.losses import dc_and_ce_loss, one_hot_channels
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
        if len(self.configuration_manager.patch_size) != 2:
            raise NotImplementedError("3-D training is not ported yet: the port "
                                      "trains 2-D configurations")
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
        if self.label_manager.has_regions:
            raise NotImplementedError("region-based (DC+BCE) training is not "
                                      "ported yet")

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
        """The plans' own networks (PlainConvUNet, ResidualEncoderUNet) are
        not ported yet; the DinoUNet trainers override this."""
        raise NotImplementedError(
            f"the port builds DinoUNet only (DinoUNetTrainer*); "
            f"{architecture_class_name} is not ported yet")

    def initialize(self):
        if self.was_initialized:
            raise RuntimeError("initialize called twice")
        self.num_input_channels = determine_num_input_channels(
            self.plans_manager, self.configuration_manager, self.dataset_json)
        network = self.build_network_architecture(
            self.configuration_manager.network_arch_class_name,
            self.configuration_manager.network_arch_init_kwargs,
            self.configuration_manager.network_arch_init_kwargs_req_import,
            self.num_input_channels,
            self.label_manager.num_segmentation_heads,
            self.enable_deep_supervision)
        self.network = network.init_weights(self.seed).to(self.device)
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
        """Rotation range, the loader's enlarged patch and the mirror axes
        (ref :391-446, the 2-D case: no dummy-2D)."""
        patch_size = self.configuration_manager.patch_size
        if max(patch_size) / min(patch_size) > 1.5:
            rotation = (-15.0 / 360 * 2 * np.pi, 15.0 / 360 * 2 * np.pi)
        else:
            rotation = (-np.pi, np.pi)
        mirror_axes = (0, 1)
        initial_patch_size = get_enlarged_patch_size(
            patch_size, max(abs(rotation[0]), abs(rotation[1])), (0.85, 1.25))
        self.inference_allowed_mirroring_axes = mirror_axes
        return rotation, initial_patch_size, mirror_axes

    def get_dataloaders(self):
        rotation, initial_patch_size, mirror_axes = \
            self._configure_rotation_dummyDA_mirroring_and_initial_patch_size()
        tr_keys, val_keys = self.do_split()
        dataset_tr = nnUNetDataset(self.preprocessed_dataset_folder, tr_keys)
        dataset_val = nnUNetDataset(self.preprocessed_dataset_folder, val_keys)
        cm = self.configuration_manager
        self.dataloader_train = nnUNetDataLoader2D(
            dataset_tr, cm.batch_size, initial_patch_size, cm.patch_size,
            self.label_manager, self.oversample_foreground_percent)
        self.dataloader_val = nnUNetDataLoader2D(
            dataset_val, cm.batch_size, cm.patch_size, cm.patch_size,
            self.label_manager, self.oversample_foreground_percent)
        self.augment_cfg = AugmentConfig(
            patch_size=tuple(cm.patch_size)[-2:], rotation_range=rotation,
            mirror_axes=mirror_axes, use_mask_for_norm=tuple(cm.use_mask_for_norm))

    # ------------------------------------------------------------- loss/steps

    def _loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return dc_and_ce_loss(logits, target, batch_dice=self.configuration_manager.batch_dice,
                              smooth=1e-5, do_bg=False,
                              ignore_label=self.label_manager.ignore_label)

    def _batch_to_device(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Loader batch -> data (B, C, H, W) float32 and labels (B, H, W)
        int64 on the device."""
        data = torch.from_numpy(batch["data"]).to(self.device, non_blocking=True)
        seg = torch.from_numpy(batch["seg"][:, 0]).to(self.device, non_blocking=True)
        return data, seg.long()

    def train_step_host(self, batch) -> torch.Tensor:
        """Augment on the device, forward, DC+CE, backward, clip, SGD step.
        Returns the loss as a device scalar (reading it synchronises)."""
        data, seg = self._batch_to_device(batch)
        data, seg = augment_batch_2d(data, seg, self.augment_cfg, self._aug_gen)
        self.network.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(self.network(data), seg)
        loss.backward()
        clip_and_step(self.optimizer, 12.0)
        return loss.detach()

    @torch.no_grad()
    def validation_step_host(self, batch):
        """Eval-mode forward (the fused serving path), loss and hard
        pseudo-Dice counts tp / fp / fn per class (ref :946-1008)."""
        data, seg = self._batch_to_device(batch)
        seg = torch.where(seg < 0, torch.zeros_like(seg), seg)
        self.network.eval()
        out = self.network(data)
        loss = self._loss(out, seg)
        num_classes = self.label_manager.num_segmentation_heads
        ignore = self.label_manager.ignore_label
        if ignore is not None:
            mask = (seg != ignore)[:, None].float()
            seg = torch.where(seg == ignore, torch.zeros_like(seg), seg)
        else:
            mask = 1.0
        pred = one_hot_channels(out.argmax(1), num_classes)
        target = one_hot_channels(seg, num_classes)
        axes = (0, 2, 3)
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
        """Global per-class Dice from the summed counts (ref :1010-1052)."""
        self.logger.log("val_losses", val_loss, epoch)
        dice = [float(2 * i / (2 * i + j + k)) if (2 * i + j + k) > 0 else float("nan")
                for i, j, k in zip(tp[1:], fp[1:], fn[1:])]
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
        raise NotImplementedError(
            "perform_actual_validation (sliding-window prediction of the "
            "validation cases, export and metrics) waits for the port's "
            "validation slice")
