"""device_idle_pct.predict: the share of the profiled span (whole case cycles at the
end of the traced run) in which no kernel, copy or set ran on the device.
Layer: device; moves ``predict.mpx_per_s``."""


def read(ctx):
    prof = ctx.get("profile") if ctx.get("kind") == "cases" else None
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
