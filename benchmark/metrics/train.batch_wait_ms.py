"""train.batch_wait_ms: host ms a step blocks in the prefetcher's ``next()``,
the mean over the traced run's window. Layer: trainer (``training/trainer.py``
prefetcher, ``training/dataloading.py``); moves ``train.patches_per_s``."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("batch_wait_s"):
        return None
    waits = ctx["batch_wait_s"]
    return 1e3 * sum(waits) / len(waits)
