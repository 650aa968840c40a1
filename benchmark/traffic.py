"""The one generator of the benchmark's traffic: it reads a mix's parameters
from ``benchmark/traffic/<name>.json`` and makes its inputs from the seed.

Two kinds of mix:

- ``cases``: a closed loop of one client that sends preprocessed cases
  (C, 1, H, W) float32 to the predictor, as ``nnUNetv2_predict`` walks a
  folder. ``cycle`` lists the case sizes in their fixed order; the seed draws
  the pixels only, so every seed sends the same sizes in the same order.
- ``train``: the trainer's own loop over a preprocessed 2-D dataset of
  ``n_cases`` cases of ``case_size``, written from the seed where the trainer
  reads it (nnU-Net's unpacked layout: ``<case>.npy``, ``<case>_seg.npy``,
  ``<case>.pkl`` with the loader's foreground locations, the plans and
  ``dataset.json``).

Every image is a disk-and-ring scene (a bright disk labelled 1, a dark ring
labelled 2, noise, z-scored), as preprocessed CT or MR slices look to the
network: the labels correlate with the intensities.
"""

import json
import os
import pickle
from typing import List, Tuple

import numpy as np

def disk_ring(gen, n: int, H: int, W: int, channels: int, device):
    """n scenes on `device` from the generator `gen`: images (n, channels,
    H, W) float32, z-scored a scene, and labels (n, H, W) int8."""
    import torch

    u = torch.rand((n, 7), generator=gen, device=device, dtype=torch.float64)
    m = min(H, W)
    r = (0.10 + 0.08 * u[:, 0]) * m
    cy, cx = r + 1 + u[:, 1] * (H - 2 * r - 2), r + 1 + u[:, 2] * (W - 2 * r - 2)
    r_out = (0.12 + 0.08 * u[:, 3]) * m
    r_in = r_out * (0.55 + 0.20 * u[:, 4])
    ry, rx = r_out + 1 + u[:, 5] * (H - 2 * r_out - 2), r_out + 1 + u[:, 6] * (W - 2 * r_out - 2)
    yy = torch.arange(H, device=device, dtype=torch.float64)[None, :, None]
    xx = torch.arange(W, device=device, dtype=torch.float64)[None, None, :]

    def d2(y, x):
        return (yy - y[:, None, None]) ** 2 + (xx - x[:, None, None]) ** 2

    disk = d2(cy, cx) <= (r ** 2)[:, None, None]
    dr = d2(ry, rx)
    ring = (dr <= (r_out ** 2)[:, None, None]) & (dr >= (r_in ** 2)[:, None, None]) & ~disk
    seg = disk.to(torch.int8) + 2 * ring.to(torch.int8)
    img = torch.randn((n, channels, H, W), generator=gen, device=device) * 0.6
    img += (2.0 * disk - 1.5 * ring).to(torch.float32)[:, None]
    flat = img.view(n, -1)
    img = (img - flat.mean(1)[:, None, None, None]) / flat.std(1)[:, None, None, None]
    return img, seg


def generator(seed: int, stream: int, device):
    import torch

    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (1 << 63))


def cases(mix: dict, seed: int, channels: int, device="cpu") -> List[np.ndarray]:
    """The cycle's cases, (channels, 1, H, W) float32 host arrays, in order;
    drawn on `device`."""
    gen = generator(seed, 1, device)
    out = []
    for h, w in mix["cycle"]:
        img, _ = disk_ring(gen, 1, int(h), int(w), channels, device)
        out.append(img[0, :, None].cpu().numpy())
    return out


def tiles_of(size: Tuple[int, int], patch: Tuple[int, int], step: float) -> int:
    """Tiles nnU-Net's sliding window lays over a case of `size`: the case
    padded to at least the patch and up to a multiple of half of it, then
    ceil((n - p) / (p * step)) + 1 origins an axis."""
    n = 1
    for s, p in zip(size, patch):
        half = max(1, p // 2)
        padded = -(-max(s, p) // half) * half
        n *= int(np.ceil((padded - p) / (p * step))) + 1
    return n


def _class_locations(gen, seg, max_per_class: int = 10000) -> dict:
    """The loader's foreground locations of one (H, W) label map on the
    device: up to `max_per_class` (channel, z, y, x) rows a label."""
    import torch

    out = {}
    for label in (1, 2):
        yx = torch.nonzero(seg == label)
        if len(yx) > max_per_class:
            yx = yx[torch.randperm(len(yx), generator=gen, device=yx.device)[:max_per_class]]
        rows = torch.zeros((len(yx), 4), dtype=torch.int64, device=yx.device)
        rows[:, 2:] = yx
        out[label] = rows.cpu().numpy()
    return out


def write_dataset(mix: dict, seed: int, root: str, name: str, plans_2d: dict,
                  channels: int, device="cpu", chunk: int = 50) -> str:
    """Write the mix's preprocessed dataset under `root`/`name`, drawn on
    `device` in chunks of cases; returns its folder. `plans_2d` is the
    configuration's 2d plans entry."""
    gen = generator(seed, 2, device)
    base = os.path.join(root, name)
    data_dir = os.path.join(base, plans_2d["data_identifier"])
    os.makedirs(data_dir, exist_ok=True)
    H, W = mix["case_size"]
    n = int(mix["n_cases"])
    for lo in range(0, n, chunk):
        k = min(chunk, n - lo)
        img, seg = disk_ring(gen, k, H, W, channels, device)
        imgs, segs = img[:, :, None].cpu().numpy(), seg[:, None, None].cpu().numpy()
        for j in range(k):
            stem = os.path.join(data_dir, f"case_{lo + j:04d}")
            np.save(stem + ".npy", imgs[j])
            np.save(stem + "_seg.npy", segs[j])
            np.savez(stem + ".npz")  # the packed file, which nothing reads once unpacked
            props = {"class_locations": _class_locations(gen, seg[j]),
                     "shape_before_cropping": (1, H, W), "spacing": [999.0, 1.0, 1.0]}
            with open(stem + ".pkl", "wb") as f:
                pickle.dump(props, f)
    labels = {"background": 0, "disk": 1, "ring": 2}
    dataset_json = {"labels": labels, "channel_names": {str(c): "synthetic"
                                                        for c in range(channels)},
                    "numTraining": int(mix["n_cases"]), "file_ending": ".npz"}
    plans = {"dataset_name": name, "plans_name": "nnUNetPlans",
             "configurations": {"2d": plans_2d}}
    with open(os.path.join(base, "dataset.json"), "w") as f:
        json.dump(dataset_json, f)
    with open(os.path.join(base, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f)
    return base
