"""Device milliseconds a completed frame spends in ``denoise_step``: the
device time of the kernels launched inside the benchmark's range around
the engine's ``denoise_step`` over the profiled part, over its frames."""


def read(ctx):
    p = ctx["profiled"]
    device_s = p.get("device_s_by_span", {}).get("denoise_step")
    if ctx.get("unit") != "frames" or not device_s or not p.get("done"):
        return None
    return device_s * 1e3 / p["done"]
