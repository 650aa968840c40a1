"""A ``train`` mix: the trainer's own loop. ``_BatchPrefetcher`` over
``dataloader_train``, then ``train_step_host`` (device augmentation, forward,
DC+CE, backward, clip, SGD), as ``_run_training_epochs`` runs them in an
epoch.

Set-up writes the mix's dataset from the seed under TMPDIR, builds the
trainer (``on_train_start``: network, optimizer, loaders), fills the weights
from the seed and gives the adapter's drop-path a generator seeded from it,
then drives the first ``CHECKED_STEPS`` steps through the window's own call
and feed: they warm up every shape, and the reference follows them. The
same trainer then runs the window, which opens at a synchronize and closes
at the synchronize after the first step issued at or after ``seconds``.

The checked steps record what the augmentation takes in (the loader's
crops), the random draws it takes for each sample and what it returns, and
the backbone's features of the first step. The reference augments the same
crops by the same draws itself, is held to the program's augmented batches,
and trains on its own; the loader's crops are the program's, not redrawn.
The backbone's features are compared on the first step."""

import gc
import os
import shutil

import flops
import harness
import traffic
import weights
from reference import augment as refaug
from reference import model as refmodel
from reference import train as reftrain

DATASET = "Dataset900_Bench"
CHECKED_STEPS = 3  # the steps the reference follows
PROFILED_STEPS = 3  # the steps a traced run profiles after its window


def drop_path_seed(seed: int) -> int:
    return (int(seed) * 0x5851F42D + 11) % (1 << 63)


def keeps_for(cfg: dict, gen, batch: int, rate: float):
    """One forward's drop-path draws: per interaction block, per extractor,
    (batch,) True where the sample keeps its branch."""
    import torch

    return [[torch.rand(batch, generator=gen) < 1.0 - rate for _ in range(n)]
            for n in refmodel.n_extractors(cfg)]


def set_up(cell, seed: int, dev, log=None):
    """Write the mix's dataset, build the trainer as the CLI's loop has it,
    fill its weights from the seed and seed its drop-path draws; returns
    (trainer, prefetcher, data folder)."""
    import torch
    from dinounet_tpu_torch.run import get_trainer_from_args
    from dinounet_tpu_torch.training import dinounet_trainer  # noqa: F401  (registers)

    from kind_cases import check_widths

    cfg, mix = cell.cfg, cell.mix
    root = os.path.join(os.environ.get("TMPDIR", "/tmp"), "bench_train")
    shutil.rmtree(root, ignore_errors=True)
    for sub in ("raw", "preprocessed", "results"):
        os.makedirs(os.path.join(root, sub))
        os.environ[f"nnUNet_{sub}"] = os.path.join(root, sub)
    plans_2d = dict(cfg["plans_2d"], batch_size=int(cfg["batch_size"]))
    t = harness.now()
    traffic.write_dataset(mix, seed, os.environ["nnUNet_preprocessed"], DATASET, plans_2d,
                          cfg["assumed"]["num_input_channels"], dev)
    phases = {"dataset": harness.now() - t}
    t = harness.now()
    trainer = get_trainer_from_args(DATASET, "2d", 0, cfg["trainer"], device=dev)
    trainer.seed = int(seed) % (1 << 63)
    trainer.initial_lr = float(mix["initial_lr"])
    trainer.on_train_start()
    for group in trainer.optimizer.param_groups:  # epoch 0's rate, as the epoch loop sets it
        group["lr"] = trainer.current_lr()
    phases["trainer"] = harness.now() - t
    t = harness.now()
    check_widths(trainer.network, cfg)
    weights.fill(trainer.network.named_parameters(), seed, dev)
    trainer.network.encoder.dinov3_adapter.drop_path_generator = \
        torch.Generator().manual_seed(drop_path_seed(seed))
    phases["weights"] = harness.now() - t
    if log is not None:
        log("set-up phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    return trainer, trainer._BatchPrefetcher(trainer.dataloader_train), root


def first_steps(trainer, prefetch, n: int, replay=None):
    """The first n steps through the window's own call and feed. Returns per
    step what the augmentation took in (``raw``), its draws a sample
    (``draws``) and what it returned (``out``) (or, with `replay`, hands the
    step replay's ``out`` instead), and the program's readings: each step's
    loss, the first gradient's norms, each trainable leaf's change, the
    backbone's features of the first step."""
    import torch
    from dinounet_tpu_torch.training import augmentation

    captured = []
    augment, draw = trainer._augment, augmentation.draw_augment
    draws = []

    def drawing(*args, **kwargs):
        d = draw(*args, **kwargs)
        draws.append(dict(vars(d)))
        return d

    def capturing(data, seg):
        step = {"raw": (data.detach().cpu(), seg.detach().cpu())}
        if replay is not None:
            d, g = replay[len(captured)]["out"]
            out = (d.to(data.device), g.to(data.device))
        else:
            del draws[:]
            out = augment(data, seg)
            step["draws"] = list(draws)
        step["out"] = (out[0].detach().cpu(), out[1].detach().cpu())
        captured.append(step)
        return out

    trainer._augment, augmentation.draw_augment = capturing, drawing
    features = harness.Capture(trainer.network.encoder.dinov3_adapter.backbone, torch)
    named = {k: p for k, p in trainer.network.named_parameters() if p.requires_grad}
    start = {k: p.detach().clone() for k, p in named.items()}
    losses, first = [], None
    try:
        for i in range(n):
            features.armed = i == 0
            losses.append(trainer.train_step_host(prefetch.next()))
            if i == 0:
                first = reftrain.first_gradient(trainer.optimizer, named)
                first_vec = reftrain.first_gradient_vector(trainer.optimizer, named)
    finally:
        trainer._augment, augmentation.draw_augment = augment, draw
        features.remove()
    delta = {k: p.detach() - start[k] for k, p in named.items()}
    return captured, {"losses": [float(x) for x in losses], "first_grad": first,
                      "first_vec": first_vec, "change": reftrain.leaf_norms(delta),
                      "change_vec": reftrain.flat(delta),
                      "features": [o for _, outs in features.calls[:1] for o in outs]}


def checked_steps(cell, seed: int, dev, replay=None, env=None):
    """(captured steps, readings) of a fresh trainer's first steps, under `env`."""
    import torch

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    trainer, prefetch, root = set_up(cell, seed, dev)
    try:
        return first_steps(trainer, prefetch, CHECKED_STEPS, replay)
    finally:
        prefetch.close()
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
        del trainer, prefetch
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)


def run(cell, seed: int, seconds: float, trace: bool, dev, t0: float, log) -> dict:
    import torch

    cfg, mix = cell.cfg, cell.mix
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainer, prefetch, root = set_up(cell, seed, dev, log)
    try:
        t = harness.now()
        captured, program = first_steps(trainer, prefetch, CHECKED_STEPS)
        sync()
        log(f"set-up phases (s): first steps {harness.now() - t:.3f}")
        network = trainer.network
        timer = counter = None
        if trace:
            timer = harness.ModuleTimer(network.encoder.dinov3_adapter.backbone, torch)
            counter = harness.SlotCounter(network)
        batch = int(cfg["batch_size"])
        step_losses, waits = [], []
        sync()
        t_open = harness.now()
        setup_s = t_open - t0
        while True:
            tb = harness.now()
            b = prefetch.next()
            waits.append(harness.now() - tb)
            step_losses.append(trainer.train_step_host(b))
            if harness.now() - t_open >= seconds:
                break
        sync()
        window_s = harness.now() - t_open
        steps = len(step_losses)
        log(f"set-up {setup_s:.3f} s; window: {steps} steps of batch {batch} in "
            f"{window_s:.3f} s")
        failed = int((~torch.isfinite(torch.stack(step_losses))).sum())
        metrics = {"setup_s": setup_s, "train.patches_per_s": steps * batch / window_s}
        H, W = cfg["plans_2d"]["patch_size"]
        device = {"memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
        ctx = breakdown = None
        if trace:
            timer.remove()
            counter.remove()
            sync()
            ctx = {"kind": "train", "cfg": cfg, "mix": mix, "window_s": window_s,
                   "steps": steps, "batch": batch, "batch_wait_s": waits,
                   "step_flops": flops.train_step_flops(cfg, H, W, batch),
                   "backbone_ms": timer.ms()}
            ctx["profile"] = profile_steps(trainer, prefetch)
            ctx["profile"]["dense_bound_s"] = flops.dense_bound_s(
                cfg, H, W, batch, backward=True) * ctx["profile"]["steps"]
            device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
            device["busy_s"] = ctx["profile"]["busy_s"]
            device["window_s"] = ctx["profile"]["window_s"]
            breakdown = {"device_ops": ctx["profile"]["device_ops"],
                         "idle_gaps": ctx["profile"]["idle_gaps"]}
    finally:
        prefetch.close()

    del trainer, network, prefetch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = harness.now()
    checks, uncompared = check(cell, seed, captured, program, dev)
    log(f"reference check {harness.now() - t:.3f} s")
    for k, v in uncompared.items():
        log(f"reading {k}: {v!r} (not compared: the cell has no limit for it)")
    shutil.rmtree(root, ignore_errors=True)
    return {"metrics": metrics, "ctx": ctx, "device": device, "breakdown": breakdown,
            "attempted": steps, "failed": failed, "checks": checks}


def profile_steps(trainer, prefetch) -> dict:
    """Whole steps of the loop under the device profiler, reduced."""
    import torch

    def steps():
        for _ in range(PROFILED_STEPS):
            trainer.train_step_host(prefetch.next())

    out = harness.profiled(steps, torch)
    out["steps"] = PROFILED_STEPS
    return out


def relative_gaps(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap of norms, against the larger of the reference
    leaf's norm and the median leaf's."""
    import statistics

    names = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in names)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in names)


def augmented(cfg: dict, captured, dev, dtype=None):
    """The reference's augmentation of each checked step's crops by the
    program's draws, on `dev` (in `dtype`, default float32), and its gaps
    from the program's augmented batches: the worst sample's relative L2 gap
    of the data, and of the labels the worst sample's share that differ."""
    import torch

    patch = tuple(cfg["plans_2d"]["patch_size"])
    use_mask = cfg["plans_2d"]["use_mask_for_norm"]
    batches, data_gap, label_share = [], 0.0, 0.0
    for step in captured:
        raw_data, raw_seg = (t.to(dev) for t in step["raw"])
        got_data, got_seg = step["out"]
        if "draws" not in step or len(step["draws"]) != len(raw_data):
            return None, float("inf"), float("inf")
        xs, ys = [], []
        for b, d in enumerate(step["draws"]):
            x, y = refaug.augment(raw_data[b], raw_seg[b], d, patch, use_mask,
                                  dtype or torch.float32)
            xs.append(x.float())
            ys.append(y)
            if got_data[b].shape != x.shape or got_seg[b].shape != y.shape:
                return None, float("inf"), float("inf")
            g = got_data[b].to(dev, torch.float32)
            gap = float(torch.linalg.vector_norm(g - xs[-1]) / torch.linalg.vector_norm(xs[-1]))
            data_gap = max(data_gap, gap if gap == gap else float("inf"))
            label_share = max(label_share,
                              float((got_seg[b].to(dev) != y).float().mean()))
        batches.append((torch.stack(xs), torch.stack(ys)))
    return batches, data_gap, label_share


def drop_path_keeps(cfg: dict, seed: int, batches):
    """The drop-path draws the program's forwards took from the seed's
    generator, in its order, for each of `batches`."""
    import torch

    gen = torch.Generator().manual_seed(drop_path_seed(seed))
    rate = cfg["adapter"]["drop_path_rate"]
    return [keeps_for(cfg, gen, data.shape[0], rate) for data, _ in batches]


def compare(program: dict, want: dict) -> dict:
    """Each step's loss by its relative gap (the worst step); the first
    gradient and the change by their relative L2 gap and by the worst leaf's
    gap of norms; the first step's backbone features by the worst output's
    relative L2 gap. Leaves whose reference gradient is nought to rounding
    (under a thousandth of the median leaf's) move by round-off alone, and
    are left out of the change."""
    import statistics

    if set(want["first_grad"]) != set(program["first_grad"]):
        raise RuntimeError("the program's trainable leaves differ from the reference's")
    med = statistics.median(want["first_grad"].values())
    moved = {k for k, v in want["first_grad"].items() if v >= 1e-3 * med}
    import torch

    def rel_l2(key):
        return float(torch.linalg.vector_norm(program[key] - want[key])
                     / torch.linalg.vector_norm(want[key]))

    def features():
        got, ref = program["features"], want["features"]
        if len(got) != len(ref) or not got or any(g.shape != r.shape for g, r in zip(got, ref)):
            return float("inf")
        gaps = [float(torch.linalg.vector_norm(g.float() - r.float())
                      / torch.linalg.vector_norm(r.float())) for g, r in zip(got, ref)]
        return max(g if g == g else float("inf") for g in gaps)

    return {"loss_rel_gap": max(abs(a - b) / abs(b)
                                for a, b in zip(program["losses"], want["losses"])),
            "backbone_rel_l2": features(),
            "first_grad_rel_l2": rel_l2("first_vec"), "change_rel_l2": rel_l2("change_vec"),
            "first_grad_leaf_gap": relative_gaps(program["first_grad"], want["first_grad"]),
            "change_leaf_gap": relative_gaps(program["change"], want["change"], moved)}


def check(cell, seed, captured, program: dict, dev) -> dict:
    """The reference augments the checked steps' crops by their draws and
    follows the steps from the same weights and drop-path draws."""
    from kind_cases import reference

    cfg = cell.cfg
    batches, data_gap, label_share = augmented(cfg, captured, dev)
    readings = {"augment_rel_l2": data_gap, "augment_label_share": label_share}
    if batches is not None:
        ref = reference(cell, seed, dev)
        want = reftrain.run_steps(ref, batches, drop_path_keeps(cfg, seed, batches),
                                  float(cell.mix["initial_lr"]))
        readings.update(compare(program, want))
    else:
        readings.update({k: float("inf") for k in cell.limits})
    return {k: (v, cell.limits[k]) for k, v in readings.items() if k in cell.limits}, {
        k: v for k, v in readings.items() if k not in cell.limits}
