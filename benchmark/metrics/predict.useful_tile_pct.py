"""predict.useful_tile_pct: real tile x mirror-variant forwards over the tile
slots the network was given, in the traced run's window (the slots counted by
a forward pre-hook on the network, the real tiles from the cycle's sizes).
Layer: predictor (``inference/predictor.py``, ``sliding_window.py``); moves
``predict.mpx_per_s``."""


def read(ctx):
    if ctx.get("kind") != "cases" or not ctx.get("slots"):
        return None
    return 100.0 * ctx["tile_forwards"] / ctx["slots"]
