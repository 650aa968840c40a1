"""Public Python API: plan_and_preprocess / training / evaluate.

Capability parity with ref: dinounet/api.py:15-656, same signatures and return
values. The reference spawns a child process per pipeline stage to isolate CUDA
contexts (ref :363-391); here the stages run in-process, as in the JAX
package: one process trains on one device.

JAX-free copy of ``dinounet_tpu/api.py``. ``training`` runs on ``device``
(``None`` means ``cuda``, through the trainer; a trainer asked for CUDA
without a card raises), and ``_load_training_log_from_folder`` reads the
port's ``torch.save`` checkpoints (``training/checkpointing.py``).
"""

import os
from typing import List, Optional, Tuple, Type, Union

from dinounet_tpu_torch import paths
from dinounet_tpu_torch.planning.plan_and_preprocess_api import (
    extract_fingerprints,
    plan_experiments,
    preprocess,
)
from dinounet_tpu_torch.utilities.json_export import load_json
from dinounet_tpu_torch.utilities.misc import maybe_convert_to_dataset_name
from dinounet_tpu_torch.utilities.plans_handler import PlansManager


def _extract_training_log(logger) -> dict:
    """ref api.py:15-40."""
    if logger is None or not hasattr(logger, "my_fantastic_logging"):
        return {"epochs": [], "train_losses": [], "val_losses": []}
    log_data = logger.my_fantastic_logging
    num_epochs = len(log_data.get("train_losses", []))
    return {
        "epochs": list(range(num_epochs)),
        "train_losses": log_data.get("train_losses", []),
        "val_losses": log_data.get("val_losses", []),
        "mean_fg_dice": log_data.get("mean_fg_dice", []),
        "ema_fg_dice": log_data.get("ema_fg_dice", []),
        "lrs": log_data.get("lrs", []),
    }


def _load_training_log_from_folder(output_folder: str) -> dict:
    """ref api.py:123-160: recover the log from a checkpoint on disk."""
    from dinounet_tpu_torch.training.checkpointing import load_checkpoint

    for name in ("checkpoint_final.pth", "checkpoint_latest.pth", "checkpoint_best.pth"):
        f = os.path.join(output_folder, name)
        if os.path.isfile(f):
            ckpt = load_checkpoint(f)
            logging_ = ckpt.get("logging", {})
            n = len(logging_.get("train_losses", []))
            return {
                "epochs": list(range(n)),
                "train_losses": logging_.get("train_losses", []),
                "val_losses": logging_.get("val_losses", []),
            }
    return {"epochs": [], "train_losses": [], "val_losses": []}


def _extract_network_configurations(dataset_id, plans_identifier: str,
                                    configurations: List[str]) -> dict:
    """ref api.py:42-121."""
    if isinstance(dataset_id, list):
        dataset_id = dataset_id[0]
    dataset_name = maybe_convert_to_dataset_name(dataset_id)
    plans_file = os.path.join(
        paths.nnUNet_preprocessed(), dataset_name, f"{plans_identifier}.json"
    )
    if not os.path.isfile(plans_file):
        print(f"Warning: Plans file not found at {plans_file}")
        return {}
    plans = load_json(plans_file)
    network_configurations = {}
    for config_name in configurations:
        if config_name not in plans["configurations"]:
            print(f"Warning: Configuration '{config_name}' not found in plans file")
            continue
        config = plans["configurations"][config_name]
        arch_info = config.get("architecture", {})
        arch_kwargs = arch_info.get("arch_kwargs", {})
        network_configurations[config_name] = {
            "architecture": {
                "network_class_name": arch_info.get("network_class_name", ""),
                "n_stages": arch_kwargs.get("n_stages", 0),
                "features_per_stage": arch_kwargs.get("features_per_stage", []),
                "kernel_sizes": arch_kwargs.get("kernel_sizes", []),
                "strides": arch_kwargs.get("strides", []),
                "n_conv_per_stage": arch_kwargs.get("n_conv_per_stage", []),
                "n_conv_per_stage_decoder": arch_kwargs.get("n_conv_per_stage_decoder", []),
                "conv_op": arch_kwargs.get("conv_op", ""),
                "norm_op": arch_kwargs.get("norm_op", ""),
                "nonlin": arch_kwargs.get("nonlin", ""),
                "conv_bias": arch_kwargs.get("conv_bias", True),
                "dropout_op": arch_kwargs.get("dropout_op", None),
                "norm_op_kwargs": arch_kwargs.get("norm_op_kwargs", {}),
                "nonlin_kwargs": arch_kwargs.get("nonlin_kwargs", {}),
                "dropout_op_kwargs": arch_kwargs.get("dropout_op_kwargs", {}),
            },
            "data_config": {
                "batch_size": config.get("batch_size"),
                "patch_size": config.get("patch_size", []),
                "spacing": config.get("spacing", []),
                "median_image_size_in_voxels": config.get("median_image_size_in_voxels", []),
            },
        }
    return network_configurations


def _check_preprocessing_completed(dataset_id, plans_identifier: str,
                                   configurations: List[str]) -> bool:
    """ref api.py:206-268: fingerprint + plans jsons present and >=1 .npz per
    configured folder."""
    dataset_ids = [dataset_id] if isinstance(dataset_id, int) else dataset_id
    for did in dataset_ids:
        try:
            dataset_name = maybe_convert_to_dataset_name(did)
        except RuntimeError:
            return False
        pre = os.path.join(paths.nnUNet_preprocessed(), dataset_name)
        if not os.path.isfile(os.path.join(pre, "dataset_fingerprint.json")):
            return False
        plans_file = os.path.join(pre, f"{plans_identifier}.json")
        if not os.path.isfile(plans_file):
            return False
        try:
            plans_manager = PlansManager(load_json(plans_file))
            for config in configurations:
                if config not in plans_manager.available_configurations:
                    continue
                cm = plans_manager.get_configuration(config)
                folder = os.path.join(pre, cm.data_identifier)
                if not os.path.isdir(folder):
                    return False
                if not any(f.endswith(".npz") for f in os.listdir(folder)):
                    return False
        except Exception:
            return False
    return True


def plan_and_preprocess(
    dataset_id: Union[int, List[int]],
    verify_dataset_integrity: bool = False,
    gpu_memory_target: float = 8,
    preprocessor_name: str = "DefaultPreprocessor",
    overwrite_plans_name: Optional[str] = None,
    overwrite_target_spacing: Optional[List[float]] = None,
    force_target_shape: Optional[List[int]] = None,
    max_batch_size: int = 32,
    force_n_stages: Optional[int] = None,
    clean: bool = False,
    configurations: List[str] = ["2d", "3d_fullres", "3d_lowres"],
    num_processes: Optional[List[int]] = None,
    verbose: bool = False,
    force_rerun: bool = False,
) -> Tuple[str, dict]:
    """ref api.py:270-396. Returns (plans_identifier, network_configurations)."""
    plans_identifier = overwrite_plans_name if overwrite_plans_name else "nnUNetPlans"
    dataset_ids = [dataset_id] if isinstance(dataset_id, int) else list(dataset_id)

    if not force_rerun and _check_preprocessing_completed(
        dataset_id, plans_identifier, configurations
    ):
        print("Preprocessing already completed, skipping...")
        return plans_identifier, _extract_network_configurations(
            dataset_id, plans_identifier, configurations
        )

    extract_fingerprints(
        dataset_ids, check_dataset_integrity=verify_dataset_integrity, clean=True,
        verbose=verbose,
    )
    plans_identifier = plan_experiments(
        dataset_ids,
        gpu_memory_target_in_gb=gpu_memory_target,
        preprocess_class_name=preprocessor_name,
        overwrite_plans_name=overwrite_plans_name,
        overwrite_target_spacing=overwrite_target_spacing,
        force_target_shape=force_target_shape,
        max_batch_size=max_batch_size,
        force_n_stages=force_n_stages,
    )
    if num_processes is None:
        default_np = {"2d": 8, "3d_fullres": 4, "3d_lowres": 8}
        num_processes = [default_np.get(c, 4) for c in configurations]
    preprocess(dataset_ids, plans_identifier, configurations, num_processes, verbose)

    return plans_identifier, _extract_network_configurations(
        dataset_id, plans_identifier, configurations
    )


def training(
    dataset_id: Union[int, str],
    configuration: str,
    fold: Union[int, str] = 0,
    trainer_class: Union[type, str] = "nnUNetTrainer",
    plans_identifier: str = "nnUNetPlans",
    pretrained_weights: Optional[str] = None,
    num_gpus: int = 1,
    use_compressed_data: bool = False,
    export_validation_probabilities: bool = False,
    continue_training: bool = False,
    only_run_validation: bool = False,
    disable_checkpointing: bool = False,
    val_with_best: bool = False,
    device: Union[str, None] = None,
    initial_lr: Optional[float] = None,
    num_epochs: Optional[int] = None,
    batch_size: Optional[int] = None,
) -> Tuple[str, dict]:
    """ref api.py:399-587. Returns (output_folder, training_log)."""
    from dinounet_tpu_torch.run import (
        load_pretrained_weights,
        maybe_load_checkpoint,
        run_training,
    )
    from dinounet_tpu_torch.utilities import registry

    if isinstance(dataset_id, int):
        dataset_id = str(dataset_id)

    custom = initial_lr is not None or num_epochs is not None or batch_size is not None
    if custom:
        # instantiate the trainer directly and override hyperparameters before
        # initialize (ref :459-507)
        dataset_name = maybe_convert_to_dataset_name(dataset_id)
        preprocessed_folder = os.path.join(paths.nnUNet_preprocessed(), dataset_name)
        plans = load_json(os.path.join(preprocessed_folder, f"{plans_identifier}.json"))
        dataset_json = load_json(os.path.join(preprocessed_folder, "dataset.json"))

        if isinstance(trainer_class, str):
            trainer_class = registry.trainers.get(trainer_class)
        if batch_size is not None:
            for cfg in plans["configurations"].values():
                if "batch_size" in cfg:
                    cfg["batch_size"] = batch_size

        trainer = trainer_class(
            plans=plans, configuration=configuration, fold=fold,
            dataset_json=dataset_json, device=device,
        )
        if initial_lr is not None:
            trainer.initial_lr = initial_lr
        if num_epochs is not None:
            trainer.num_epochs = num_epochs

        if pretrained_weights is not None:
            if not trainer.was_initialized:
                trainer.initialize()
            load_pretrained_weights(trainer, pretrained_weights, verbose=True)
        if disable_checkpointing:
            trainer.save_checkpoint = lambda *a, **k: None

        if not only_run_validation:
            maybe_load_checkpoint(trainer, continue_training, only_run_validation)
            trainer.run_training()
        else:
            if not trainer.was_initialized:
                trainer.initialize()
            trainer.load_checkpoint(
                os.path.join(trainer.output_folder, "checkpoint_final.pth")
            )
        if val_with_best:
            trainer.load_checkpoint(
                os.path.join(trainer.output_folder, "checkpoint_best.pth")
            )
        trainer.perform_actual_validation(export_validation_probabilities)
        return trainer.output_folder, _extract_training_log(trainer.logger)

    trainer_class_name = (
        trainer_class if isinstance(trainer_class, str) else trainer_class.__name__
    )
    if not isinstance(trainer_class, str):
        registry.trainers.add(trainer_class_name, trainer_class)
    trainer = run_training(
        dataset_name_or_id=dataset_id, configuration=configuration, fold=fold,
        trainer_class_name=trainer_class_name, plans_identifier=plans_identifier,
        pretrained_weights=pretrained_weights, num_gpus=num_gpus,
        use_compressed_data=use_compressed_data,
        export_validation_probabilities=export_validation_probabilities,
        continue_training=continue_training, only_run_validation=only_run_validation,
        disable_checkpointing=disable_checkpointing, val_with_best=val_with_best,
        device=device,
    )
    return trainer.output_folder, _extract_training_log(trainer.logger)


def evaluate(
    dataset_id: Union[int, str],
    result_folder: str,
    fold: Optional[Union[int, str]] = 0,
    output_file: Optional[str] = None,
    num_processes: int = 8,
    chill: bool = True,
) -> dict:
    """ref api.py:590-656: gt = preprocessed/gt_segmentations; pred =
    result_folder/validation when a fold is given (fold=None with no fold_N in
    the path means test predictions, ref :632-639); returns the summary dict."""
    from dinounet_tpu_torch.evaluation.metrics import compute_metrics_on_folder2, load_summary_json

    dataset_name = maybe_convert_to_dataset_name(dataset_id)
    preprocessed_folder = os.path.join(paths.nnUNet_preprocessed(), dataset_name)
    gt_folder = os.path.join(preprocessed_folder, "gt_segmentations")
    if fold is None and "fold_" in result_folder:
        fold = result_folder.split("fold_")[-1].split("/")[0]
    pred_folder = os.path.join(
        result_folder, "validation" if fold is not None else "test_predictions")
    if not os.path.isdir(pred_folder):
        pred_folder = result_folder
    if output_file is None:
        output_file = os.path.join(pred_folder, "summary.json")

    # plans identifier comes from the result-folder naming convention
    # <Trainer>__<plans>__<config> (ref api.py:628-630), with fallbacks to the
    # plans.json copied into the results folder / the default identifier
    plans_file = os.path.join(preprocessed_folder, "nnUNetPlans.json")
    base = os.path.basename(os.path.dirname(result_folder.rstrip("/"))) \
        if "fold_" in os.path.basename(result_folder.rstrip("/")) \
        else os.path.basename(result_folder.rstrip("/"))
    if "__" in base:
        cand = os.path.join(preprocessed_folder, base.split("__")[1] + ".json")
        if os.path.isfile(cand):
            plans_file = cand
    if os.path.isfile(os.path.join(result_folder, "plans.json")):
        plans_file = os.path.join(result_folder, "plans.json")

    compute_metrics_on_folder2(
        gt_folder, pred_folder,
        os.path.join(preprocessed_folder, "dataset.json"),
        plans_file,
        output_file=output_file, num_processes=num_processes, chill=chill,
    )
    return load_summary_json(output_file)
