"""backbone_ms.predict: device ms of the ViT backbone a tile-batch forward,
between CUDA events recorded by forward pre- and post-hooks on the backbone
module, the mean over the traced run's window. Layer: ViT backbone
(``models/vit.py``); moves ``predict.mpx_per_s``."""


def read(ctx):
    if ctx.get("kind") != "cases" or not ctx.get("backbone_ms"):
        return None
    return sum(ctx["backbone_ms"]) / len(ctx["backbone_ms"])
