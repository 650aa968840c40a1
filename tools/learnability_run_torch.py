"""End-to-end learnability run of the PyTorch/CUDA port on one card.

The counterpart of ``tools/learnability_run.py``: the same synthetic 2-D
dataset (ten 512 x 512 grey PNG cases of intensity-correlated disks, two
foreground classes, class-k pixels brighter by 45 k, so the task is
learnable from intensity alone), then the port's whole CLI path,
``dinounet_training_torch.main_dinov3("dinounet_s")``: fingerprint, plan
(forced 512 x 512, 4 stages, 2d), preprocess, ``DinoUNetTrainer_s`` at full
width (ViT-S/16, 12 blocks, a randomly initialised frozen backbone, batch 2,
lr 1e-3) for N epochs of the trainer's own 250 steps, the sliding-window
validation with mirror TTA and its export, then ``api.evaluate``. A
foreground Dice of 0.95 or more certifies that the whole stack trains: the
MSDA kernels' forward and backward, the attention and dense kernels of the
frozen backbone, the device augmentation, DC + CE and the final validation.

    python3 tools/learnability_run_torch.py [epochs] [workdir] [--device cpu]

It runs on the card (``cuda``) unless ``--device cpu`` is given. stderr
carries a line per epoch (its pseudo-Dice, losses, seconds and the median
ms a train step) and the run's totals; the last line of stdout is one JSON
object, the JAX tool's: ``{"metric": "learnability_fg_dice", "value",
"epochs", "workdir"}``. It imports no JAX: ``make_dataset`` is its own copy
of the JAX tool's, writing the same pixels and the same dataset.json.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DATASET_ID, DATASET_NAME = 606, "Dataset606_Learn"
MODEL_NAME = "dinounet_s"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def make_dataset(root: str, n_cases: int = 10, size: int = 512,
                 dataset_name: str = DATASET_NAME) -> None:
    """Intensity-correlated disks (tools/learnability_run.py's set, the same
    draws of ``default_rng(0)`` in the same order): class-k pixels are
    brighter by 45 k, so the task is learnable from intensity alone."""
    from dinounet_tpu_torch.imageio.natural_image import pil_image
    from dinounet_tpu_torch.utilities.json_export import save_json

    image = pil_image()
    rng = np.random.default_rng(0)
    folder = os.path.join(root, dataset_name)
    os.makedirs(os.path.join(folder, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(folder, "labelsTr"), exist_ok=True)
    for i in range(n_cases):
        img = rng.normal(90.0, 25.0, (size, size))
        seg = np.zeros((size, size), np.uint8)
        for c in (1, 2):
            for _ in range(3):
                cy, cx = rng.integers(40, size - 40, 2)
                r = rng.integers(20, 60)
                yy, xx = np.ogrid[:size, :size]
                disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
                seg[disk] = c
                img[disk] += 45.0 * c
        img = np.clip(img, 0, 255).astype(np.uint8)
        image.fromarray(img).save(os.path.join(folder, "imagesTr", f"case_{i:03d}_0000.png"))
        image.fromarray(seg).save(os.path.join(folder, "labelsTr", f"case_{i:03d}.png"))
    save_json(
        {
            "channel_names": {"0": "rescale_to_0_1"},
            "labels": {"background": 0, "disk1": 1, "disk2": 2},
            "numTraining": n_cases,
            "file_ending": ".png",
            "overwrite_image_reader_writer": "NaturalImage2DIO",
        },
        os.path.join(folder, "dataset.json"),
    )


def _mark(device: torch.device):
    """A point in time: a CUDA event recorded on the device's stream (the
    device's pace), else the host's clock."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _gaps_ms(marks: list, device: torch.device) -> list:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


@contextlib.contextmanager
def epoch_report(trainer_class, epochs: list):
    """Within the block every epoch of a `trainer_class` trainer appends
    {epoch, pseudo_dice, train_loss, val_loss, seconds, step_ms} to `epochs`
    and logs it: step_ms is the median spacing of the epoch's train step
    starts (batch wait, augmentation, forward, backward, optimizer), by CUDA
    events on a card, by the host's clock on the CPU; seconds the epoch's
    own (its steps and its validation batches) from the trainer's log."""
    patched = ("train_step_host", "on_epoch_end")
    own = {name: vars(trainer_class).get(name) for name in patched}
    step, end = trainer_class.train_step_host, trainer_class.on_epoch_end
    marks = []

    def timed_step(self, batch):
        marks.append(_mark(self.device))
        return step(self, batch)

    def reported_end(self, epoch):
        gaps = _gaps_ms(marks, self.device)
        marks.clear()
        series = self.logger.my_fantastic_logging
        record = {"epoch": epoch, "pseudo_dice": series["mean_fg_dice"][epoch],
                  "train_loss": series["train_losses"][epoch],
                  "val_loss": series["val_losses"][epoch],
                  "seconds": (series["epoch_end_timestamps"][epoch]
                              - series["epoch_start_timestamps"][epoch]),
                  "step_ms": float(np.median(gaps)) if gaps else None}
        epochs.append(record)
        step_txt = "n/a" if record["step_ms"] is None else f"{record['step_ms']:.1f}"
        log(f"[learnability] epoch {epoch}: pseudo-Dice {record['pseudo_dice']:.4f}, "
            f"train loss {record['train_loss']:.4f}, val loss {record['val_loss']:.4f}, "
            f"{record['seconds']:.1f} s, median step {step_txt} ms "
            f"({len(gaps) + 1} steps)")
        return end(self, epoch)

    trainer_class.train_step_host = timed_step
    trainer_class.on_epoch_end = reported_end
    try:
        yield
    finally:
        for name, fn in own.items():
            if fn is None:
                delattr(trainer_class, name)
            else:
                setattr(trainer_class, name, fn)


def main(epochs: int = 10, workdir: str = None, device="cuda") -> dict:
    """Write the dataset under `workdir` (a new temporary folder by
    default), point the three nnUNet_* folders into it, run
    ``main_dinov3("dinounet_s", 606, epochs)`` on `device` and print the
    JAX tool's JSON line. Returns the foreground Dice, the epochs' records,
    the training log, the evaluation, the result folder, the seconds of the
    whole run and the device's peak GiB (a card only)."""
    import dinounet_training_torch
    from dinounet_tpu_torch.training.dinounet_trainer import get_dinov3_trainer

    device = torch.device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="dinounet_learn_")
    for sub in ("raw", "preprocessed", "results"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)
        os.environ["nnUNet_" + sub] = os.path.join(workdir, sub)
    make_dataset(os.environ["nnUNet_raw"])
    log(f"[learnability] dataset ready under {workdir}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    t0 = time.perf_counter()
    with epoch_report(get_dinov3_trainer(MODEL_NAME), records):
        result_folder, training_log, results = dinounet_training_torch.main_dinov3(
            model_name=MODEL_NAME, dataset_id=DATASET_ID, num_epochs=epochs, device=device)
    seconds = time.perf_counter() - t0
    fg = None
    if isinstance(results, dict):
        fg = (results.get("foreground_mean") or {}).get("Dice")
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    steps = [r["step_ms"] for r in records if r["step_ms"] is not None]
    log(f"[learnability] {MODEL_NAME} on {device}: foreground Dice {fg}; pseudo-Dice by "
        f"epoch {[round(r['pseudo_dice'], 4) for r in records]}; epochs "
        f"{sum(r['seconds'] for r in records):.1f} s of the run's {seconds:.1f} s; "
        f"median step {np.median(steps) if steps else float('nan'):.1f} ms"
        + ("" if peak is None else f"; peak device memory {peak:.2f} GiB"))
    print(json.dumps({"metric": "learnability_fg_dice", "value": fg, "epochs": epochs,
                      "workdir": workdir}), flush=True)
    return {"fg_dice": fg, "epochs": records, "training_log": training_log,
            "results": results, "result_folder": result_folder, "seconds": seconds,
            "peak_gib": peak, "workdir": workdir}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("epochs", nargs="?", type=int, default=10)
    parser.add_argument("workdir", nargs="?", default=None)
    parser.add_argument("--device", default="cuda",
                        help="the device to train on (default: cuda)")
    args = parser.parse_args()
    main(args.epochs, args.workdir, args.device)
