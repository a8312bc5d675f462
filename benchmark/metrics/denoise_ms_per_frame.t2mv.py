"""Device milliseconds a completed frame spends in the text-to-multiview
denoise steps: the device time of the kernels launched inside the
``bench/t2mv_denoise_step`` range around the engine's
``text_denoise_step`` (``kinds/t2mv.py``) over the profiled part, over
its frames."""


def read(ctx):
    p = ctx["profiled"]
    device_s = p.get("device_s_by_span", {}).get("t2mv_denoise_step")
    if ctx.get("unit") != "frames" or not device_s or not p.get("done"):
        return None
    return device_s * 1e3 / p["done"]
