"""Plain reference of the DinoUNet trainers' step: train-mode forward with
the drop-path draws given, nnU-Net's DC + CE loss (batch Dice, smooth 1e-5,
no background in the Dice, equal weights), backward, the gradients clipped
to a global norm of 12, SGD with Nesterov momentum 0.99 and weight decay
3e-5 (nnU-Net v2's ``nnUNetTrainer``)."""

from typing import Dict, List

import torch
import torch.nn.functional as F


def dc_and_ce(logits: torch.Tensor, target: torch.Tensor, smooth: float = 1e-5):
    """logits (B, K, H, W) float32, target (B, H, W) int labels."""
    logits = logits.float()
    K = logits.shape[1]
    ce = F.cross_entropy(logits, target.long())
    probs = torch.softmax(logits, 1)[:, 1:]
    onehot = F.one_hot(target.long(), K).movedim(-1, 1).float()[:, 1:]
    axes = (0, 2, 3)  # batch Dice: sums over the batch and the image
    inter = (probs * onehot).sum(axes)
    denom = onehot.sum(axes) + probs.sum(axes)
    dice = (2 * inter + smooth) / torch.clamp(denom + smooth, min=1e-8)
    return ce - dice.mean()


def sgd(params, lr: float) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=0.99, nesterov=True,
                           weight_decay=3e-5, foreach=False)


def flat(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tensors in name order as one float32 vector on the host."""
    return torch.cat([tensors[k].detach().float().cpu().view(-1) for k in sorted(tensors)])


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def first_gradient(opt, named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's momentum after one SGD step (the gradient as the optimizer
    took it in) as a norm; 0 for a leaf that got no gradient (a head the
    forward does not use)."""
    return {k: float(torch.linalg.vector_norm(opt.state[p]["momentum_buffer"]))
            if "momentum_buffer" in opt.state.get(p, {}) else 0.0 for k, p in named.items()}


def first_gradient_vector(opt, named: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every leaf's momentum after one SGD step, in the leaves' name order,
    as one float32 vector on the host (zeros for a leaf with no gradient)."""
    parts = []
    for k in sorted(named):
        p = named[k]
        buf = opt.state.get(p, {}).get("momentum_buffer")
        parts.append(torch.zeros(p.numel()) if buf is None else buf.detach().float().cpu().view(-1))
    return torch.cat(parts)


def run_steps(model, batches: List[tuple], keeps: List[list], lr: float) -> dict:
    """Follow the program's first steps: batches [(data, seg)] on the model's
    device, keeps [per step: per block: per extractor: (B,) bool]. Returns
    each step's loss, the first gradient as the optimizer takes it in (its
    momentum after one step: the clipped gradient plus weight decay), and
    each trainable leaf's change over the steps, as norms by name, and the
    backbone's features of the first step (on the host)."""
    model.train()
    features = []

    def keep(_module, _args, out):
        if not features:
            features.extend(o.detach().cpu() for o in out)

    hook = model.encoder.dinov3_adapter.backbone.register_forward_hook(keep)
    named = {k: p for k, p in model.named_parameters() if p.requires_grad}
    start = {k: p.detach().clone() for k, p in named.items()}
    opt = sgd(list(named.values()), lr)
    losses, first = [], None
    for i, ((data, seg), keep) in enumerate(zip(batches, keeps)):
        opt.zero_grad(set_to_none=True)
        loss = dc_and_ce(model(data, keep), seg)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(named.values()), 12.0)
        opt.step()
        losses.append(float(loss.detach()))
        if i == 0:
            first = first_gradient(opt, named)
            first_vec = first_gradient_vector(opt, named)
    hook.remove()
    delta = {k: p.detach() - start[k] for k, p in named.items()}
    return {"losses": losses, "first_grad": first, "first_vec": first_vec,
            "change": leaf_norms(delta), "change_vec": flat(delta), "features": features}
