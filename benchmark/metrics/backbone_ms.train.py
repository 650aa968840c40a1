"""backbone_ms.train: device ms of the frozen backbone's forward a train step
(CUDA events from forward hooks on the backbone module), the mean over the
traced run's window. Layer: ViT backbone (``models/vit.py``); moves
``train.patches_per_s``."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("backbone_ms"):
        return None
    return sum(ctx["backbone_ms"]) / len(ctx["backbone_ms"])
