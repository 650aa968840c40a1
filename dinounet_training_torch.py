#!/usr/bin/env python
"""Dino U-Net end-to-end CLI on one CUDA card: preprocess -> train -> evaluate.

    python3 dinounet_training_torch.py --model dinounet_b --datasetid N --epoch E

The PyTorch counterpart of ``dinounet_training.py`` (ref: dinounet_training.py:
958-1084), with the same pipeline and flags: fingerprint, plan with
force_target_shape=[512,512] and force_n_stages=4 on the '2d' configuration,
preprocess, inject the planned network configuration into the size-variant
trainer (class level), train at lr 1e-3 with the plans' batch size, run the
final validation, then evaluate. ``--gpuid N`` trains on ``cuda:N``, one
process on one card, as the reference's CUDA_VISIBLE_DEVICES does (ref
:1074). It needs a card: nothing falls back to the CPU. The raw dataset lives
under ``nnUNet_raw``; ``nnUNet_preprocessed`` and ``nnUNet_results`` receive
the plans, the preprocessed cases and the trained model.

The published DINOv3 weights are not loaded yet: the frozen backbone is
randomly initialized, and the training log says so.
"""

import argparse

from dinounet_tpu_torch.api import evaluate, plan_and_preprocess, training
from dinounet_tpu_torch.models.dinounet import DINOV3_MODEL_NAMES
from dinounet_tpu_torch.models.vit import VIT_CONFIGS
from dinounet_tpu_torch.training.dinounet_trainer import (
    DINOV3_TRAINERS,
    get_dinov3_trainer,
)


def main_dinov3(model_name: str = "dinounet_s", dataset_id: int = 4,
                num_epochs: int = 200, device="cuda"):
    """ref dinounet_training.py:958-1051. Returns (result_folder, training_log,
    evaluation results)."""
    trainer_class = get_dinov3_trainer(model_name)
    vit_cfg = VIT_CONFIGS[DINOV3_MODEL_NAMES[model_name]]

    print(f"Selected model: {model_name}")
    print(f"  Trainer class: {trainer_class.__name__}")
    print(f"  Backbone: {DINOV3_MODEL_NAMES[model_name]} "
          f"(embed_dim={vit_cfg.embed_dim}, depth={vit_cfg.depth})")

    configuration = "2d"
    print(f"\nPreprocessing dataset {dataset_id} ...")
    plans_identifier, network_configs = plan_and_preprocess(
        dataset_id=dataset_id,
        verify_dataset_integrity=True,
        force_target_shape=[512, 512],
        force_n_stages=4,
        configurations=[configuration],
        verbose=True,
        force_rerun=False,
    )
    config = network_configs[configuration]
    arch, data = config["architecture"], config["data_config"]
    print(f"Network: {arch['n_stages']} stages, features {arch['features_per_stage']}")
    print(f"Batch size {data['batch_size']}, patch size {data['patch_size']}")

    trainer_class.set_network_config(config)

    print(f"\nTraining {model_name} on {device} ...")
    result_folder, training_log = training(
        dataset_id=dataset_id,
        configuration=configuration,
        trainer_class=trainer_class,
        plans_identifier=plans_identifier,
        device=device,
        initial_lr=1e-3,
        num_epochs=num_epochs,
        batch_size=data["batch_size"],
    )
    print(f"Training done. Result folder: {result_folder}")
    if training_log.get("train_losses"):
        print(f"  epochs: {len(training_log['epochs'])}, "
              f"final train loss {training_log['train_losses'][-1]:.4f}, "
              f"final val loss {training_log['val_losses'][-1]:.4f}")

    print("\nEvaluating ...")
    results = evaluate(dataset_id=dataset_id, result_folder=result_folder)
    print(f"Mean foreground Dice: {results['foreground_mean']['Dice']:.4f}")
    print(f"Mean foreground HD95: {results['foreground_mean']['HD95']:.4f}")
    return result_folder, training_log, results


def main():
    parser = argparse.ArgumentParser(
        description="Run Dino U-Net (PyTorch, one CUDA card) with specified model "
                    "and dataset")
    parser.add_argument("--gpuid", type=int, default=0,
                        help="index of the CUDA card to train on (default: 0)")
    parser.add_argument("--model", type=str, default="dinounet_s",
                        choices=sorted(DINOV3_TRAINERS),
                        help="model size variant (default: dinounet_s)")
    parser.add_argument("--datasetid", type=int, default=9,
                        help="nnU-Net dataset ID (default: 9)")
    parser.add_argument("--epoch", type=int, default=200,
                        help="number of training epochs (default: 200)")
    args = parser.parse_args()

    print("--- Configuration ---")
    print(f"Model: {args.model}\nDataset ID: {args.datasetid}\nEpochs: {args.epoch}\n"
          f"GPU: cuda:{args.gpuid}")
    print("---------------------")
    main_dinov3(model_name=args.model, dataset_id=args.datasetid,
                num_epochs=args.epoch, device=f"cuda:{args.gpuid}")


if __name__ == "__main__":
    main()
