"""Training launch: building a trainer from a preprocessed dataset folder,
resuming it, pretrained weights, and the training run with its final
validation.

Counterpart of ``dinounet_tpu/run.py`` (ref: dinounet/run/run_training.py:
31-277 and run/load_pretrained_weights.py:6-64): ``get_trainer_from_args``
looks the trainer up in the registry and reads the plans and dataset.json
from ``nnUNet_preprocessed/<dataset>``; ``maybe_load_checkpoint`` resumes
from checkpoint_final -> latest -> best; ``load_pretrained_weights``
transfers every weight of matching shape except the segmentation heads;
``run_training`` trains and ends in ``perform_actual_validation``;
``run_training_entry`` is its CLI.

``num_gpus`` > 1 trains data-parallel, one process a rank (ref
run_training.py:104-194): ``run_training`` starts them with
``parallel.launch.spawn``, rank r on ``cuda:r`` over NCCL (more than the
visible cards raise), or with ``device="cpu"`` that many CPU ranks over
gloo; each rank runs the same training in a process group. Under ``torchrun`` (``LOCAL_RANK`` and
``WORLD_SIZE`` set, ``WORLD_SIZE`` == ``num_gpus``) the process joins the
group itself and trains on ``cuda:LOCAL_RANK``. Rank 0's output folder and
training log come back as a ``RankZero``. ``num_gpus == 1`` is one
plain process. ``DINOUNET_TPU_MODEL_AXIS`` splits a DinoUNet trainer's
backbone (s / b / l / 7b) over a model axis of that many ranks
(``training/dinounet_trainer.py``); a network without a backbone is whole on
every rank.
"""

import dataclasses
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.training.logger import nnUNetLogger
from dinounet_tpu_torch.utilities import registry
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name


def get_trainer_from_args(dataset_name_or_id: Union[int, str], configuration: str,
                          fold: int, trainer_name: str = "nnUNetTrainer",
                          plans_identifier: str = "nnUNetPlans",
                          use_compressed: bool = False, device=None):
    """ref run_training.py:31-70 (a registry lookup replaces the module walk)."""
    trainer_class = registry.trainers.get(trainer_name)
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    preprocessed = os.path.join(paths.nnUNet_preprocessed(), dataset_name)
    plans = load_json(os.path.join(preprocessed, plans_identifier + ".json"))
    dataset_json = load_json(os.path.join(preprocessed, "dataset.json"))
    return trainer_class(plans=plans, configuration=configuration, fold=fold,
                         dataset_json=dataset_json, unpack_dataset=not use_compressed,
                         device=device)


def maybe_load_checkpoint(trainer, continue_training: bool,
                          validation_only: bool) -> None:
    """Resume from final -> latest -> best (ref run_training.py:73-101)."""
    if continue_training and validation_only:
        raise RuntimeError("Cannot both continue a training AND only run validation")
    expected = None
    if continue_training:
        for name in ("checkpoint_final.pth", "checkpoint_latest.pth", "checkpoint_best.pth"):
            cand = os.path.join(trainer.output_folder, name)
            if os.path.exists(cand):
                expected = cand
                break
        if expected is None:
            print("WARNING: Cannot continue training because there is no checkpoint. "
                  "Starting a new training...")
    elif validation_only:
        expected = os.path.join(trainer.output_folder, "checkpoint_final.pth")
        if not os.path.exists(expected):
            raise RuntimeError("Cannot run validation because the training is not "
                               "finished yet!")
    if expected is not None:
        trainer.load_checkpoint(expected)


def load_pretrained_weights(trainer, pretrained_weights_file: str,
                            verbose: bool = False) -> None:
    """Copy every tensor of the checkpoint's network weights whose name and
    shape match the trainer's network, except the segmentation heads
    (any name with a component containing "seg"), as the JAX package
    transfers its variable tree (ref run/load_pretrained_weights.py:6-64).
    A trainer on a model axis takes its shards of the file's tensors."""
    from dinounet_tpu_torch.parallel.sharding import shard_tensor
    from dinounet_tpu_torch.training.checkpointing import load_checkpoint

    source = load_checkpoint(pretrained_weights_file)["network_weights"]
    state = trainer.network.state_dict()
    shard = getattr(trainer, "model_shard", None)
    with torch.no_grad():
        for name, dst in state.items():
            src = source.get(name)
            if src is None or any("seg" in part for part in name.split(".")):
                continue
            if shard is not None:
                src = shard_tensor(name, src, shard.rank, shard.size)
            if tuple(src.shape) == tuple(dst.shape):
                dst.copy_(src.to(dst.dtype))
                if verbose:
                    print(f"transferred {name}")


def run_training(dataset_name_or_id: Union[str, int], configuration: str,
                 fold: Union[int, str], trainer_class_name: str = "nnUNetTrainer",
                 plans_identifier: str = "nnUNetPlans",
                 pretrained_weights: Optional[str] = None, num_gpus: int = 1,
                 use_compressed_data: bool = False,
                 export_validation_probabilities: bool = False,
                 continue_training: bool = False, only_run_validation: bool = False,
                 disable_checkpointing: bool = False, val_with_best: bool = False,
                 device=None):
    """ref run_training.py:141-215: one process on one device, or with
    `num_gpus` > 1 one process a rank (the module's docstring)."""
    if num_gpus < 1:
        raise ValueError(f"num_gpus must be at least 1, got {num_gpus}")
    if num_gpus > 1 and not dist.is_initialized():
        kwargs = dict(dataset_name_or_id=dataset_name_or_id, configuration=configuration,
                      fold=fold, trainer_class_name=trainer_class_name,
                      plans_identifier=plans_identifier,
                      pretrained_weights=pretrained_weights, num_gpus=num_gpus,
                      use_compressed_data=use_compressed_data,
                      export_validation_probabilities=export_validation_probabilities,
                      continue_training=continue_training,
                      only_run_validation=only_run_validation,
                      disable_checkpointing=disable_checkpointing,
                      val_with_best=val_with_best)
        trainer_class = registry.trainers.get(trainer_class_name)
        return data_parallel(_train_rank, num_gpus, device, kwargs, trainer_class,
                             injected_config(trainer_class))[0]
    if fold != "all":
        fold = int(fold)

    trainer = get_trainer_from_args(dataset_name_or_id, configuration, fold,
                                    trainer_class_name, plans_identifier,
                                    use_compressed_data, device)
    if disable_checkpointing:
        trainer.save_checkpoint = lambda *a, **k: None

    if not only_run_validation:
        maybe_load_checkpoint(trainer, continue_training, only_run_validation)
        if pretrained_weights is not None:
            if not trainer.was_initialized:
                trainer.initialize()
            load_pretrained_weights(trainer, pretrained_weights, verbose=True)
        trainer.run_training()
    else:
        if not trainer.was_initialized:
            trainer.initialize()
        maybe_load_checkpoint(trainer, continue_training, only_run_validation)

    if val_with_best:
        trainer.load_checkpoint(os.path.join(trainer.output_folder, "checkpoint_best.pth"))
    trainer.perform_actual_validation(export_validation_probabilities)
    return trainer


@dataclasses.dataclass
class RankZero:
    """What a data-parallel run returns: rank 0's output folder and logger
    (the attributes of a trainer that ``api.training`` reads)."""
    output_folder: str
    logger: nnUNetLogger


def injected_config(trainer_class) -> Optional[tuple]:
    """A DinoUNet trainer's class-level network configuration
    (``set_network_config``'s arguments), which a spawned rank, a fresh
    interpreter, does not inherit; None where none was injected."""
    config = getattr(trainer_class, "_network_config", None)
    return None if config is None else (config, trainer_class._dinov3_pretrained_path,
                                        trainer_class._dinov3_model_name)


def _train_rank(device, kwargs: dict, trainer_class, injection) -> RankZero:
    registry.trainers.add(kwargs["trainer_class_name"], trainer_class)
    if injection is not None:
        trainer_class.set_network_config(*injection)
    trainer = run_training(**kwargs, device=device)
    return RankZero(trainer.output_folder, trainer.logger)


def data_parallel(fn, num_gpus: int, device, *args) -> list:
    """``fn(rank_device, *args)`` on `num_gpus` ranks in one process group,
    spawned, rank r on ``cuda:r`` (NCCL) or all on the CPU (gloo) by
    `device`'s type: the ranks' return values. Under ``torchrun`` this
    process is its rank, and the list holds its own value."""
    from dinounet_tpu_torch.parallel.launch import spawn
    from dinounet_tpu_torch.parallel.mesh import init_distributed

    kind = torch.device(device or "cuda").type
    if "LOCAL_RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != num_gpus:
            raise ValueError(f"num_gpus {num_gpus}, but torchrun started "
                             f"WORLD_SIZE={os.environ['WORLD_SIZE']} ranks")
        rank_device = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
                       if kind == "cuda" else torch.device("cpu"))
        if kind == "cuda":
            torch.cuda.set_device(rank_device)
        init_distributed(device_type=kind)
        try:
            return [fn(rank_device, *args)]
        finally:
            dist.destroy_process_group()
    return spawn(fn, num_gpus, *args, devices=kind)


def run_training_entry():
    """Training CLI (ref run/run_training.py:218-277, nnUNetv2_train)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_name_or_id", type=str)
    parser.add_argument("configuration", type=str)
    parser.add_argument("fold", type=str, help="0..4 or 'all'")
    parser.add_argument("-tr", type=str, default="nnUNetTrainer")
    parser.add_argument("-p", type=str, default="nnUNetPlans")
    parser.add_argument("-pretrained_weights", type=str, default=None)
    parser.add_argument("-num_gpus", type=int, default=1,
                        help="ranks, one a GPU (or CPU ranks with -device cpu)")
    parser.add_argument("--use_compressed", action="store_true")
    parser.add_argument("--npz", action="store_true",
                        help="export softmax probabilities of the validation set")
    parser.add_argument("--c", action="store_true", help="continue training")
    parser.add_argument("--val", action="store_true", help="only run validation")
    parser.add_argument("--val_best", action="store_true",
                        help="validate with checkpoint_best")
    parser.add_argument("--disable_checkpointing", action="store_true")
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device: cuda (the default), cuda:N or cpu")
    args = parser.parse_args()

    run_training(
        args.dataset_name_or_id, args.configuration, args.fold,
        trainer_class_name=args.tr, plans_identifier=args.p,
        pretrained_weights=args.pretrained_weights, num_gpus=args.num_gpus,
        use_compressed_data=args.use_compressed,
        export_validation_probabilities=args.npz, continue_training=args.c,
        only_run_validation=args.val, disable_checkpointing=args.disable_checkpointing,
        val_with_best=args.val_best, device=args.device)


if __name__ == "__main__":
    run_training_entry()
