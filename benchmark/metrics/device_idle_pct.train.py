"""device_idle_pct.train: the share of the profiled span (whole train steps at the
end of the traced run) in which no kernel, copy or set ran on the device.
Layer: device; moves ``train.patches_per_s``."""


def read(ctx):
    prof = ctx.get("profile") if ctx.get("kind") == "train" else None
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
