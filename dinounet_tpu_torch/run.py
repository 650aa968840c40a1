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
``run_training_entry`` is its CLI. One process trains on one device:
``num_gpus`` must be 1 (multi-GPU training is not ported yet).
"""

import os
from typing import Optional, Union

import torch

from dinounet_tpu_torch import paths
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
    transfers its variable tree (ref run/load_pretrained_weights.py:6-64)."""
    from dinounet_tpu_torch.training.checkpointing import load_checkpoint

    source = load_checkpoint(pretrained_weights_file)["network_weights"]
    state = trainer.network.state_dict()
    with torch.no_grad():
        for name, dst in state.items():
            src = source.get(name)
            if src is None or any("seg" in part for part in name.split(".")):
                continue
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
    """ref run_training.py:141-215, one process on one device."""
    if num_gpus != 1:
        raise NotImplementedError(
            "training on more than one GPU is not ported yet (ROADMAP.md, queue "
            "item 11); num_gpus must be 1")
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
    parser.add_argument("-num_gpus", type=int, default=1, help="must be 1")
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
