"""mfu.predict: the FLOPs of the real tile x variant forwards of the traced
run's window (``flops.forward_flops`` a 512^2 tile, from the configuration's
shapes) over the window times the card's bf16 peak. Layer: model step
(``models/dinounet.py``); moves ``predict.mpx_per_s``."""

import flops


def read(ctx):
    if ctx.get("kind") != "cases" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["tile_forwards"] * ctx["tile_flops"] / (ctx["window_s"]
                                                              * flops.BF16_FLOP_S)
