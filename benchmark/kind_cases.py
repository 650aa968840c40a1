"""A ``cases`` mix: one client predicts preprocessed cases in a closed loop
through ``nnUNetPredictor.predict_logits_from_preprocessed_data``, as
``nnUNetv2_predict`` walks a folder.

Set-up builds the configuration's network through its trainer class (as a
trained model folder is read), fills its weights from the seed, and predicts
one case of each size of the cycle. The window opens at a synchronize and
closes when the first case that ends at or after ``seconds`` has come back;
a case's latency runs from the call until its float16 logits are on the
host. Every case of the window is held to the plain reference, once the
window has closed and the program is freed: its logits, and for one case
drawn from the seed, the backbone's features of every tile batch it sent
(copied to the host as the window runs them)."""

import gc
import random

import numpy as np

import flops
import harness
import traffic
import weights
from reference import model as refmodel
from reference import predict as refpredict


def _labels(k: int) -> dict:
    return {"background": 0, **{f"class_{i}": i for i in range(1, k)}}


def build(cell, seed: int, dev):
    """(predictor, network) of the cell's configuration, weights from the seed."""
    from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
    from dinounet_tpu_torch.training import dinounet_trainer  # noqa: F401  (registers)
    from dinounet_tpu_torch.utilities import registry
    from dinounet_tpu_torch.utilities.plans_handler import PlansManager

    cfg, mix = cell.cfg, cell.mix
    pm = PlansManager({"dataset_name": "Dataset900_Bench", "plans_name": "nnUNetPlans",
                       "configurations": {"2d": cfg["plans_2d"]}})
    cm = pm.get_configuration("2d")
    C, K = cfg["assumed"]["num_input_channels"], cfg["assumed"]["num_classes"]
    network = registry.trainers.get(cfg["trainer"]).build_network(
        dev, cm, C, K, enable_deep_supervision=False)
    check_widths(network, cfg)
    weights.fill(network.named_parameters(), seed, dev)
    predictor = nnUNetPredictor(tile_step_size=mix["tile_step_size"],
                                use_gaussian=mix["use_gaussian"],
                                use_mirroring=bool(mix["mirror_axes"]), device=dev,
                                tile_batch=mix["tile_batch"])
    predictor.manual_initialization(network, pm, cm, None,
                                    {"labels": _labels(K), "channel_names": {"0": "x"}},
                                    cfg["trainer"], tuple(mix["mirror_axes"]))
    return predictor, network


def check_widths(network, cfg: dict) -> None:
    """The program's backbone is the configuration's, and holds its matrices
    in the type the configuration states."""
    vit = network.encoder.dinov3_adapter.backbone
    want = cfg["backbone"]
    got = {"embed_dim": vit.cfg.embed_dim, "depth": vit.cfg.depth,
           "num_heads": vit.cfg.num_heads, "ffn_hidden": vit.cfg.ffn_hidden,
           "ffn_layer": vit.cfg.ffn_layer, "qkv_bias": vit.cfg.qkv_bias}
    bad = {k: v for k, v in got.items() if want[k] != v}
    held = str(vit.blocks[0].attn.qkv.weight.dtype).replace("torch.", "")
    if held != cfg["precision"]["frozen_backbone_matrices"]:
        bad["frozen_backbone_matrices"] = held
    if bad:
        raise RuntimeError(f"the program's backbone differs from the configuration: {bad}")


MATCH = 0.02  # a batch slot further than this from every tile variant holds none


def sampled_case(seed: int, n: int) -> int:
    """The slot of the cycle whose backbone features are compared."""
    return random.Random(int(seed)).randrange(n)


def run(cell, seed: int, seconds: float, trace: bool, dev, t0: float, log) -> dict:
    import torch

    cfg, mix = cell.cfg, cell.mix
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = harness.now()
    predictor, network = build(cell, seed, dev)
    cases = traffic.cases(mix, seed, cfg["assumed"]["num_input_channels"], dev)
    sync()
    t_built = harness.now()
    capture = harness.Capture(network.encoder.dinov3_adapter.backbone, torch)
    capture.armed = True  # its host buffers too
    seen = set()
    for case in cases:  # every size of the cycle, once
        if case.shape not in seen:
            seen.add(case.shape)
            predictor.predict_logits_from_preprocessed_data(case)
    sync()
    capture.armed, capture.calls = False, []
    j_feat = sampled_case(seed, len(cases))
    log(f"set-up phases (s): build and weights {t_built - t:.3f}, "
        f"warm-up {harness.now() - t_built:.3f}")

    timers = counter = None
    if trace:
        adapter = network.encoder.dinov3_adapter
        timers = (harness.ModuleTimer(adapter.backbone, torch),
                  harness.ModuleTimer(adapter, torch))
        counter = harness.SlotCounter(network)
    outs, slots, lat = [], [], []
    t_open = harness.now()
    setup_s = t_open - t0
    while True:
        j = len(outs) % len(cases)
        capture.armed = len(outs) == j_feat  # the sampled case's first turn
        ts = harness.now()
        outs.append(predictor.predict_logits_from_preprocessed_data(cases[j]))
        te = harness.now()
        lat.append(te - ts)
        slots.append(j)
        if te - t_open >= seconds:
            break
    window_s = harness.now() - t_open
    capture.armed = False
    capture.remove()
    sync()
    log(f"set-up {setup_s:.3f} s; window: {len(outs)} cases in {window_s:.3f} s")

    patch = tuple(cfg["plans_2d"]["patch_size"])
    n_var = 2 ** len(mix["mirror_axes"])
    tiles = [traffic.tiles_of(tuple(c.shape[2:]), patch, mix["tile_step_size"]) for c in cases]
    area = sum(int(np.prod(cases[j].shape[2:])) for j in slots)
    metrics = {"setup_s": setup_s, "predict.mpx_per_s": area / window_s / 1e6,
               "predict.case_p90_s": harness.quantile(lat, 0.9)}
    ctx = None
    breakdown = None
    device = {"memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
    if trace:
        for t in timers:
            t.remove()
        counter.remove()
        sync()
        backbone_ms, adapter_ms = (t.ms() for t in timers)
        ctx = {"kind": "cases", "cfg": cfg, "mix": mix, "window_s": window_s,
               "slots": counter.slots, "calls": counter.calls,
               "tile_forwards": sum(tiles[j] * n_var for j in slots),
               "tile_flops": flops.forward_flops(cfg, *patch),
               "backbone_ms": backbone_ms,
               "adapter_ms": [a - b for a, b in zip(adapter_ms, backbone_ms)]}
        ctx["profile"] = profile_cycle(predictor, network, cases)
        ctx["profile"]["dense_bound_s"] = flops.dense_bound_s(
            cfg, *patch, mix["tile_batch"], backward=False) * ctx["profile"]["calls"]
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        device["busy_s"] = ctx["profile"]["busy_s"]
        device["window_s"] = ctx["profile"]["window_s"]
        breakdown = {"device_ops": ctx["profile"]["device_ops"],
                     "idle_gaps": ctx["profile"]["idle_gaps"]}

    del predictor, network
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = harness.now()
    worst, per_case, features = check(cell, seed, cases, outs, slots, capture.calls, dev)
    log(f"reference check {harness.now() - t:.3f} s")
    limit = cell.limits["logits_rel_l2"]
    failed = sum(1 for v in per_case if not v <= limit)
    return {"metrics": metrics, "ctx": ctx, "device": device, "breakdown": breakdown,
            "attempted": len(outs), "failed": failed,
            "checks": {"logits_rel_l2": (worst, limit),
                       "backbone_rel_l2": (features, cell.limits["backbone_rel_l2"])}}


def profile_cycle(predictor, network, cases) -> dict:
    """One whole cycle of the mix under the device profiler, reduced; with the
    tile-batch forwards it held."""
    import torch

    counter = harness.SlotCounter(network)

    def cycle():
        for case in cases:
            predictor.predict_logits_from_preprocessed_data(case)

    out = harness.profiled(cycle, torch)
    counter.remove()
    out["calls"] = counter.calls
    return out


def reference(cell, seed: int, dev):
    """The plain reference of the cell's configuration, weights from the seed,
    in eval mode; TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cell.cfg
    ref = refmodel.build(cfg, dev, getattr(torch, cfg["precision"]["frozen_backbone_matrices"]))
    weights.fill(ref.named_parameters(), seed, dev)
    return ref.eval()


def rel_l2(got, want) -> float:
    """The relative L2 gap of `got` (any type, on any device) from `want`;
    inf where it is not finite or not of want's shape."""
    import torch

    got = torch.as_tensor(got).to(want.device, torch.float32)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def features_gap(ref, case, calls, patch, step, axes, dev) -> float:
    """The worst relative L2 gap, over the captured backbone calls' batch
    slots and the backbone's outputs, between the program's features and the
    reference's of the tile variant the slot holds (the one its input lies
    nearest to; inf where none lies within MATCH, or nothing was captured)."""
    import torch

    x3 = ref.three_channels(refpredict.tile_inputs(case, patch, step, axes, dev))
    with torch.no_grad():
        want = [ref.encoder.dinov3_adapter.backbone(x3[i:i + 1]) for i in range(len(x3))]
    worst = float("inf") if not calls else 0.0
    for x, outs in calls:
        for s in range(x.shape[0]):
            gaps = [rel_l2(x[s], c) for c in x3]
            i = min(range(len(gaps)), key=gaps.__getitem__)
            if gaps[i] > MATCH or len(outs) != len(want[i]):
                return float("inf")
            worst = max([worst] + [rel_l2(o[s], w[0]) for o, w in zip(outs, want[i])])
    return worst


def check(cell, seed, cases, outs, slots, calls, dev):
    """Every case of the window against the reference's logits of its slot
    in the cycle (the relative L2 error of the logits, per case), and the
    sampled case's backbone features (``features_gap``)."""
    import torch

    cfg, mix = cell.cfg, cell.mix
    ref = reference(cell, seed, dev)
    patch = tuple(cfg["plans_2d"]["patch_size"])
    per_case = [None] * len(outs)
    for j, case in enumerate(cases):
        idx = [i for i, s in enumerate(slots) if s == j]
        if not idx:
            continue
        want = refpredict.predict_case(ref, case, patch, mix["tile_step_size"],
                                       mix["mirror_axes"], dev)
        for i in idx:
            per_case[i] = rel_l2(np.asarray(outs[i], dtype=np.float32), want)
    j = sampled_case(seed, len(cases))
    features = features_gap(ref, cases[j], calls, patch, mix["tile_step_size"],
                            mix["mirror_axes"], dev)
    return max(per_case), per_case, features
