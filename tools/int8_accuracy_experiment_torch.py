"""Accuracy bounds of the int8 serving mode on the PyTorch/CUDA port.

The counterpart of ``tools/int8_accuracy_experiment.py``, with its two parts
and its JSON keys. ``DINOUNET_TPU_VIT_INT8=1`` runs the frozen backbone's
qkv, attention projection, fc1 and fc2 as w8a8 ops (per-output-channel int8
weights quantized once and cached on the weight, per-token int8
activations):

  A. random weights: ``dinounet_b`` with seeded fp32 weights in eval mode,
     two 512 x 512 tiles in bf16, the forward with the flag 0, then 1. The
     per-layer weight-quantization relative L2 over the backbone's linears
     is taken from the int8 levels and scales the mode caches
     (``ops/dense_q8.py::quantized_weight``, per output channel, from the
     fp32 weights), dequantized and set against the weight they were made
     from; end to end the logits' relative L2 and mean absolute error and
     the argmax agreement over the class axis (the logits are NCHW);
  B. (``--trained <workdir>``) the trained fold that
     ``tools/learnability_run_torch.py`` wrote under ``<workdir>/results``:
     ``run.run_training(..., only_run_validation=True)`` (the checkpoint
     loaded, the sliding-window validation and its export) with the flag 0,
     then 1, each followed by ``api.evaluate``: the two foreground Dice
     values and their difference.

    python3 tools/int8_accuracy_experiment_torch.py [--device cpu]
    python3 tools/int8_accuracy_experiment_torch.py --trained <workdir> [--device cpu]

It runs on the card unless ``--device cpu`` is given (there the int8 ops
run their plain PyTorch versions). The last line of stdout is one JSON
object; progress goes to stderr. It imports no JAX.
"""

import argparse
import contextlib
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

INT8_FLAG = "DINOUNET_TPU_VIT_INT8"
PART_A_MODEL = "dinounet_b"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@contextlib.contextmanager
def int8_flag(on: bool):
    """DINOUNET_TPU_VIT_INT8 set to 1 or 0 for the block, then put back."""
    saved = os.environ.get(INT8_FLAG)
    os.environ[INT8_FLAG] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(INT8_FLAG, None)
        else:
            os.environ[INT8_FLAG] = saved


def quant_error_per_layer(backbone: torch.nn.Module) -> dict:
    """Relative L2 error of each of the backbone's linear weights as the
    int8 mode holds it: the cached levels and per-output-channel scales
    (``quantized_weight(layer.weight.t())``, filled by the int8 forward on a
    card, filled here on the CPU) dequantized against the weight they were
    quantized from. Keyed by module path."""
    from dinounet_tpu_torch.ops.dense_q8 import quantized_weight

    errs = {}
    for name, layer in backbone.named_modules():
        if not isinstance(layer, torch.nn.Linear):
            continue
        w = layer.weight.detach()  # (D, K): a row an output channel
        wq, ws = quantized_weight(layer.weight.t())  # (D, Kpad) int8, (D,)
        deq = wq[:, :w.shape[1]].to(ws.dtype) * ws[:, None]
        rel = torch.linalg.vector_norm(deq - w) / torch.clamp(
            torch.linalg.vector_norm(w), min=1e-9)
        errs[name] = float(rel)
    return errs


def part_a_model(device) -> torch.nn.Module:
    """dinounet_b (the JAX tool's configuration: its ViT-B, interaction
    indexes and 3 classes, the other fields at their defaults) built on
    `device` with fp32 weights drawn from seed 0, in eval mode."""
    from dinounet_tpu_torch.models.dinounet import (DINOV3_INTERACTION_INDEXES,
                                                    DINOV3_MODEL_NAMES, DinoUNet,
                                                    DinoUNetConfig)
    from dinounet_tpu_torch.models.vit import VIT_CONFIGS

    cfg = DinoUNetConfig(vit=VIT_CONFIGS[DINOV3_MODEL_NAMES[PART_A_MODEL]],
                         interaction_indexes=DINOV3_INTERACTION_INDEXES[PART_A_MODEL],
                         num_classes=3)
    with torch.device(device):
        model = DinoUNet(cfg)
    return model.init_weights(0).eval()


def fp_and_int8_logits(model: torch.nn.Module, x: torch.Tensor) -> tuple:
    """The eval-mode model's fp32 logits on x (NCHW, numpy) with the int8
    flag 0, then 1."""
    model = model.eval()

    def run(int8: bool) -> np.ndarray:
        with int8_flag(int8), torch.no_grad():
            out = model(x)
        if isinstance(out, (list, tuple)):
            out = out[0]
        return out.float().cpu().numpy()

    log("[int8 A] fp forward ...")
    ref = run(False)
    log("[int8 A] int8 forward ...")
    return ref, run(True)


def part_a(device="cuda", model: torch.nn.Module = None, x: torch.Tensor = None) -> dict:
    """Part A on `model` (default ``part_a_model``) and the NCHW input `x`
    (default: two 512 x 512 one-channel tiles of ``default_rng(0)`` normal
    draws in bf16, the JAX tool's NHWC tiles transposed)."""
    device = torch.device(device)
    if model is None:
        log(f"[int8 A] building {PART_A_MODEL} (random fp32 weights, seed 0) on {device}")
        model = part_a_model(device)
    if x is None:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(np.moveaxis(rng.normal(0.0, 1.0, (2, 512, 512, 1)), -1, 1)
                             .astype(np.float32)).to(torch.bfloat16)
    ref, q = fp_and_int8_logits(model, x.to(device))
    backbone = model.encoder.dinov3_adapter.backbone
    dtypes = sorted({str(m.weight.dtype) for m in backbone.modules()
                     if isinstance(m, torch.nn.Linear)})
    errs = sorted(quant_error_per_layer(backbone).values())
    log(f"[int8 A] {len(errs)} backbone linears quantized from {', '.join(dtypes)} weights")
    rel = float(np.linalg.norm(q - ref) / max(np.linalg.norm(ref), 1e-9))
    return {
        "logit_rel_l2": rel,
        "logit_mae": float(np.abs(q - ref).mean()),
        "argmax_agreement": float((q.argmax(1) == ref.argmax(1)).mean()),  # classes
        "weight_quant_rel_l2_median": errs[len(errs) // 2] if errs else None,
        "weight_quant_rel_l2_worst": errs[-1] if errs else None,
        "n_quantized_layers": len(errs),
    }


@contextlib.contextmanager
def folder_network(trainer_class, dataset_id: int, plans_identifier: str,
                   configuration: str):
    """For a DinoUNet trainer, the network configuration that
    ``main_dinov3`` injected when it trained the folder (the plans'
    configuration, with the trainer's own model), injected for the block
    whatever another trainer injected before; the trainers' class-level
    state put back after. Other trainers build from the plans unchanged."""
    from dinounet_tpu_torch.api import _extract_network_configurations
    from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer

    if not issubclass(trainer_class, DinoUNetTrainer):
        yield
        return
    attrs = ("_network_config", "_dinov3_model_name", "_dinov3_pretrained_path")
    classes = {DinoUNetTrainer, trainer_class}
    missing = object()
    saved = {(cls, a): vars(cls).get(a, missing) for cls in classes for a in attrs}
    config = _extract_network_configurations(dataset_id, plans_identifier,
                                             [configuration])[configuration]
    trainer_class.set_network_config(config)
    try:
        yield
    finally:
        for (cls, a), v in saved.items():
            if v is missing:
                if a in vars(cls):
                    delattr(cls, a)
            else:
                setattr(cls, a, v)


def trained_fold(workdir: str) -> tuple:
    """The first fold under <workdir>/results: (fold dir, dataset id,
    trainer name, plans identifier, configuration, fold)."""
    folds = sorted(glob.glob(os.path.join(workdir, "results", "*", "*", "fold_*")))
    if not folds:
        raise SystemExit(f"no trained fold under {workdir}/results")
    fold_dir = folds[0]
    result_folder = os.path.dirname(fold_dir)
    # <results>/Dataset<ID>_<name>/<Trainer>__<plans>__<configuration>/fold_<f>
    dataset_id = int(os.path.basename(os.path.dirname(result_folder))
                     .split("_")[0][len("Dataset"):])
    trainer_name, plans_id, configuration = os.path.basename(result_folder).split("__")
    fold = int(os.path.basename(fold_dir).split("_")[1])
    return fold_dir, dataset_id, trainer_name, plans_id, configuration, fold


def part_b(workdir: str, device="cuda") -> dict:
    """Re-run the trained fold's sliding-window validation with int8 off,
    then on; returns both foreground Dice values and their difference."""
    from dinounet_tpu_torch import api
    from dinounet_tpu_torch.run import run_training
    from dinounet_tpu_torch.utilities import registry

    for sub in ("raw", "preprocessed", "results"):
        os.environ["nnUNet_" + sub] = os.path.join(workdir, sub)
    fold_dir, dataset_id, trainer_name, plans_id, configuration, fold = trained_fold(workdir)
    log(f"[int8 B] re-validating {fold_dir} on {device}")
    trainer_class = registry.trainers.get(trainer_name)

    def run(int8: bool):
        with int8_flag(int8):
            # the checkpoint loaded, the sliding-window validation and its
            # export (the CLI's --val path), then the metrics of the fold
            run_training(dataset_id, configuration, fold, trainer_class_name=trainer_name,
                         plans_identifier=plans_id, only_run_validation=True,
                         device=device)
            res = api.evaluate(dataset_id, fold_dir)
        return (res.get("foreground_mean") or {}).get("Dice")

    with folder_network(trainer_class, dataset_id, plans_id, configuration):
        dice_fp = run(False)
        dice_int8 = run(True)
    return {"val_fg_dice_fp": dice_fp, "val_fg_dice_int8": dice_int8,
            "dice_delta": (None if None in (dice_fp, dice_int8)
                           else dice_int8 - dice_fp)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trained", metavar="WORKDIR", default=None,
                        help="a learnability_run_torch.py work directory (part B)")
    parser.add_argument("--device", default="cuda",
                        help="the device to run on (default: cuda)")
    args = parser.parse_args(argv)
    out = {"metric": "int8_accuracy_bounds"}
    if args.trained:
        out.update(part_b(args.trained, args.device))
    else:
        out.update(part_a(args.device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
