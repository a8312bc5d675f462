"""``device_idle.*``: the device's idle share over the measured
window, in %. 1 - (device busy seconds a unit takes in the profiled part:
the union of its kernel, copy and set intervals over the units it
completed) x (units the window completed) / (the window's wall seconds).

The busy time a unit takes comes from the trace; it is scaled onto the
window's host clock because the profiler's host cost stretches the
profiled part's own wall time (nvs read 77-82 % idle against it, the
window 58 %). So it is an extrapolation that holds while a profiled unit
costs the device what a unit of the window does; where it does not, the
share can read below 0, and is left so to show it."""


def read(ctx):
    p = ctx["profiled"]
    if not p.get("busy_s") or not p.get("done") or not ctx["done"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["done"] * ctx["done"] / ctx["window_s"])
