"""Segmentation losses, PyTorch.

Counterpart of ``dinounet_tpu/training/losses.py`` (ref: dinounet/training/
loss/{dice.py,robust_ce_loss.py,compound_losses.py,deep_supervision.py}):
memory-efficient soft Dice (smooth 1e-5, denominator clipped at 1e-8,
batch-dice mode), robust cross-entropy with an ignore label, top-k CE, the
DC+CE / DC+BCE (regions) / DC+top-k compounds and the deep-supervision
weighting. The arithmetic and its rounding points follow the JAX functions
(fp32 softmax and log-softmax, sums over the spatial axes, then over the
batch for batch Dice). Layout is the port's NCHW: logits (B, C, *spatial),
integer targets (B, *spatial), one-hot targets and masks (B, C, *spatial) /
(B, 1, *spatial).
"""

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


def one_hot_channels(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, *spatial) int -> (B, C, *spatial) float one-hot; labels outside
    [0, num_classes) give an all-zero column, as jax.nn.one_hot does."""
    t = target.long()
    valid = (t >= 0) & (t < num_classes)
    oh = F.one_hot(torch.where(valid, t, 0), num_classes) * valid[..., None]
    return oh.movedim(-1, 1).float()


def soft_dice_loss(probs: torch.Tensor, target: torch.Tensor, *,
                   batch_dice: bool = False, do_bg: bool = True,
                   smooth: float = 1.0,
                   loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Memory-efficient soft Dice (ref dice.py:58-120). probs (B, C, ...)
    post-nonlin; target (B, ...) int labels or (B, C, ...) one-hot;
    loss_mask (B, 1, ...) with 1 = valid."""
    num_classes = probs.shape[1]
    if target.ndim == probs.ndim:
        y_onehot = target.to(probs.dtype)
    else:
        y_onehot = one_hot_channels(target, num_classes).to(probs.dtype)
    y_onehot = y_onehot.detach()

    if not do_bg:
        probs = probs[:, 1:]
        y_onehot = y_onehot[:, 1:]

    axes = tuple(range(2, probs.ndim))  # spatial axes
    if loss_mask is not None:
        intersect = (probs * y_onehot * loss_mask).sum(axes)
        sum_pred = (probs * loss_mask).sum(axes)
        sum_gt = (y_onehot * loss_mask).sum(axes)
    else:
        intersect = (probs * y_onehot).sum(axes)
        sum_pred = probs.sum(axes)
        sum_gt = y_onehot.sum(axes)

    if batch_dice:
        intersect = intersect.sum(0)
        sum_pred = sum_pred.sum(0)
        sum_gt = sum_gt.sum(0)

    dc = (2 * intersect + smooth) / torch.clamp(sum_gt + sum_pred + smooth, min=1e-8)
    return -dc.mean()


def _nll_at_labels(logp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-logp[:, target] as a one-hot contraction (the JAX function's form)."""
    return -(logp * one_hot_channels(target, logp.shape[1]).to(logp.dtype)).sum(1)


def robust_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax CE over the channel axis; target int labels
    (ref robust_ce_loss.py:6)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = _nll_at_labels(logp, target)
    if loss_mask is not None:
        m = loss_mask[:, 0] if loss_mask.ndim == nll.ndim + 1 else loss_mask
        return (nll * m).sum() / torch.clamp(m.sum(), min=1e-8)
    return nll.mean()


def topk_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                       k: float = 10.0) -> torch.Tensor:
    """Mean over the top-k % highest per-voxel CE values
    (ref robust_ce_loss.py:19)."""
    nll = _nll_at_labels(torch.log_softmax(logits.float(), dim=1), target)
    flat = nll.reshape(-1)
    n_keep = max(1, int(flat.shape[0] * k / 100))
    return torch.topk(flat, n_keep).values.mean()


def dc_and_ce_loss(logits: torch.Tensor, target: torch.Tensor, *,
                   weight_ce: float = 1.0, weight_dice: float = 1.0,
                   batch_dice: bool = False, smooth: float = 1e-5,
                   do_bg: bool = False,
                   ignore_label: Optional[int] = None) -> torch.Tensor:
    """ref compound_losses.py:8-56. logits (B, C, ...); target (B, ...) int."""
    if ignore_label is not None:
        mask = target != ignore_label
        target_dice = torch.where(mask, target, 0)
        loss_mask = mask[:, None].to(logits.dtype)
        num_fg = mask.sum()
    else:
        target_dice = target
        loss_mask = None
        num_fg = None

    probs = torch.softmax(logits.float(), dim=1)
    dc = soft_dice_loss(probs, target_dice, batch_dice=batch_dice, do_bg=do_bg,
                        smooth=smooth, loss_mask=loss_mask) if weight_dice != 0 else 0.0
    ce = robust_cross_entropy(logits, target_dice, loss_mask) if weight_ce != 0 else 0.0
    if ignore_label is not None and weight_ce != 0:
        ce = torch.where(num_fg > 0, ce, torch.zeros_like(ce))
    return weight_ce * ce + weight_dice * dc


def dc_and_bce_loss(logits: torch.Tensor, target_onehot: torch.Tensor, *,
                    weight_ce: float = 1.0, weight_dice: float = 1.0,
                    batch_dice: bool = True, smooth: float = 1e-5,
                    use_ignore_label: bool = False) -> torch.Tensor:
    """Region-based training: sigmoid + BCE over one-hot region targets
    (B, R, ...) (ref compound_losses.py:59-100). With use_ignore_label the
    LAST channel of target_onehot marks ignored voxels."""
    if use_ignore_label:
        mask = 1.0 - target_onehot[:, -1:]
        target_regions = target_onehot[:, :-1]
    else:
        mask = None
        target_regions = target_onehot
    target_regions = target_regions.float().detach()

    logits = logits.float()
    probs = torch.sigmoid(logits)
    dc = soft_dice_loss(probs, target_regions, batch_dice=batch_dice, do_bg=True,
                        smooth=smooth, loss_mask=mask)
    bce = (torch.clamp(logits, min=0) - logits * target_regions
           + torch.log1p(torch.exp(-logits.abs())))
    if mask is not None:
        ce = (bce * mask).sum() / torch.clamp(mask.sum(), min=1e-8)
    else:
        ce = bce.mean()
    return weight_ce * ce + weight_dice * dc


def dc_and_topk_loss(logits: torch.Tensor, target: torch.Tensor, *, k: float = 10.0,
                     weight_ce: float = 1.0, weight_dice: float = 1.0,
                     batch_dice: bool = False, smooth: float = 1e-5,
                     do_bg: bool = False) -> torch.Tensor:
    """ref compound_losses.py:102-150 (no-ignore-label path)."""
    probs = torch.softmax(logits.float(), dim=1)
    dc = soft_dice_loss(probs, target, batch_dice=batch_dice, do_bg=do_bg, smooth=smooth)
    return weight_ce * topk_cross_entropy(logits, target, k) + weight_dice * dc


def deep_supervision_weights(num_outputs: int, ddp: bool = False) -> List[float]:
    """1/2^i, the lowest set to 0 (1e-6 under data parallelism), normalised
    to sum 1 (ref nnUNetTrainer._build_loss:355-389)."""
    weights = [1 / (2 ** i) for i in range(num_outputs)]
    weights[-1] = 1e-6 if ddp else 0.0
    s = sum(weights)
    return [w / s for w in weights]


def deep_supervision_loss(loss_fn, outputs: Sequence[torch.Tensor],
                          targets: Sequence[torch.Tensor],
                          weights: Sequence[float]) -> torch.Tensor:
    """ref deep_supervision.py:5."""
    total = 0.0
    for w, o, t in zip(weights, outputs, targets):
        if w != 0:
            total = total + w * loss_fn(o, t)
    return total


def get_tp_fp_fn_tn(probs: torch.Tensor, target: torch.Tensor, axes=None,
                    mask: Optional[torch.Tensor] = None):
    """Per-class tp / fp / fn / tn sums (ref dice.py:122-181). probs
    (B, C, ...); target int (B, ...) or one-hot (B, C, ...); axes default to
    the spatial ones."""
    if target.ndim == probs.ndim:
        y_onehot = target.to(probs.dtype)
    else:
        y_onehot = one_hot_channels(target, probs.shape[1]).to(probs.dtype)
    if axes is None:
        axes = tuple(range(2, probs.ndim))
    tp = probs * y_onehot
    fp = probs * (1 - y_onehot)
    fn = (1 - probs) * y_onehot
    tn = (1 - probs) * (1 - y_onehot)
    if mask is not None:
        tp, fp, fn, tn = (t * mask for t in (tp, fp, fn, tn))
    if len(axes):
        tp, fp, fn, tn = (t.sum(axes) for t in (tp, fp, fn, tn))
    return tp, fp, fn, tn
