"""mfu.train: the FLOPs the traced run's window's steps need (every forward,
and the backward of the trainable layers: ``flops.train_step_flops``) over
the window times the card's bf16 peak. Layer: model step
(``models/dinounet.py``); moves ``train.patches_per_s``."""

import flops


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["steps"] * ctx["step_flops"] / (ctx["window_s"] * flops.BF16_FLOP_S)
