"""Building a trainer from a preprocessed dataset folder, and resuming it.

Counterpart of the first half of ``dinounet_tpu/run.py`` (ref: dinounet/run/
run_training.py:31-101): ``get_trainer_from_args`` looks the trainer up in
the registry and reads the plans and dataset.json from
``nnUNet_preprocessed/<dataset>``; ``maybe_load_checkpoint`` resumes from
checkpoint_final -> latest -> best. ``run_training`` (which ends in
``perform_actual_validation``), the pretrained-weight transfer and the CLI
wait for the port's validation slice.
"""

import os
from typing import Union

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
