"""adapter_ms.predict: device ms of the ViT-Adapter a tile-batch forward, less
the backbone it runs inside (CUDA events from forward hooks on both modules),
the mean over the traced run's window. Layer: ViT-Adapter
(``models/adapter.py``); moves ``predict.mpx_per_s``."""


def read(ctx):
    if ctx.get("kind") != "cases" or not ctx.get("adapter_ms"):
        return None
    return sum(ctx["adapter_ms"]) / len(ctx["adapter_ms"])
