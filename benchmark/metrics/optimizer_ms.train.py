"""Device milliseconds a micro-step spends in the optimizer: the device
time of the kernels launched inside the range around ``tx.apply`` over
the profiled micro-steps (updating and accumulating ones alike)."""


def read(ctx):
    p = ctx["profiled"]
    device_s = p.get("device_s_by_span", {}).get("optimizer_apply")
    if not device_s or not p.get("done"):
        return None
    return device_s * 1e3 / p["done"]
