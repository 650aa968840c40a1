"""Random weights from the run's seed, drawn on the device in a few large
calls and handed to the program and to the reference alike, by name.

The parameters are laid end to end in the order of their sorted names; the
stream is drawn in chunks of ``CHUNK`` normal numbers, chunk k from a
``torch.Generator`` on the device seeded with (seed, k). Each parameter takes
its slice, scaled by a rule on its name and shape (``scale``), and is written
in the type it is held in (a frozen backbone's bfloat16 matrices take the
rounded numbers, on both sides). So a parameter's numbers depend only on the
seed and on the names and shapes of the model, never on which side holds it.

The rule keeps the activations of a random model in range and lets every
layer matter: matrices and conv kernels N(0, 1 / fan_in), LayerScale gains
1 + N(0, 0.02), norm gains 1 + N(0, 0.1), biases and tokens N(0, 0.02 ..
0.1). In the pre-norm gains of the backbone's blocks every 64th channel is
ten times wider, as trained ViTs carry a few outlier channels. Such channels
set the scale of a token's int8 levels, so the program's int8 serving mode
departs from bfloat16 as it would on trained weights, and the check can tell
the two apart.
"""

import math
from typing import Iterable, Tuple

import torch

CHUNK = 1 << 27  # normal numbers a chunk (512 MB of float32)


OUTLIER, EVERY = 10.0, 64  # the backbone blocks' pre-norm gains: every 64th channel 10x


def scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float, bool]:
    """(mean, std, outliers) of the parameter `name` of `shape`; with
    outliers, every EVERY-th value is OUTLIER times what the rule draws."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf in ("cls_token", "storage_tokens", "level_embed"):
        return 0.0, 0.02, False
    if len(shape) >= 2:
        fan_in = math.prod(shape) // shape[0]
        return 0.0, 1.0 / math.sqrt(fan_in), False
    if leaf == "gamma":
        return 1.0, 0.02, False
    if leaf == "weight":
        return 1.0, 0.1, "blocks" in parts and parts[-2] in ("norm1", "norm2")
    return 0.0, 0.1 if leaf == "bias" else 0.02, False


def chunk_seed(seed: int, k: int) -> int:
    return (int(seed) * 0x9E3779B1 + 7919 * k + 1) % (1 << 63)


def layout(named: Iterable[Tuple[str, torch.Tensor]]):
    """[(name, tensor, offset)] in sorted-name order, and the total count."""
    out, offset = [], 0
    for name, t in sorted(named, key=lambda kv: kv[0]):
        out.append((name, t, offset))
        offset += t.numel()
    return out, offset


@torch.no_grad()
def fill(named: Iterable[Tuple[str, torch.Tensor]], seed: int, device) -> int:
    """Write every tensor of `named` (name, parameter) in place from the
    seed's stream; returns the number of values drawn."""
    items, total = layout(named)
    i = 0
    for k in range(0, -(-total // CHUNK)):
        lo, hi = k * CHUNK, min(total, (k + 1) * CHUNK)
        gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, k))
        block = torch.randn(hi - lo, generator=gen, device=device)
        while i < len(items):
            name, t, off = items[i]
            a, b = max(off, lo), min(off + t.numel(), hi)
            if a < b:
                mean, std, outliers = scale(name, tuple(t.shape))
                values = block[a - lo:b - lo] * std + mean
                if outliers:
                    idx = torch.arange(a - off, b - off, device=values.device)
                    values = torch.where(idx % EVERY == 0, values * OUTLIER, values)
                t.view(-1)[a - off:b - off].copy_(values)
            if off + t.numel() > hi:
                break  # continues in the next chunk
            i += 1
    return total
