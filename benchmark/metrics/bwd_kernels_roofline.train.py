"""The hand flash-attention backward kernels' share of their roofline:
the sum over the backward calls (dQ, then dK/dV/dbias) of the pair's bound
over the device time of the kernels launched inside the two ranges, in %."""

from benchmark import roofline


def read(ctx):
    p = ctx["profiled"]
    spans = p.get("device_s_by_span", {})
    device_s = spans.get("flash_bwd_dq", 0.0) + spans.get("flash_bwd_dkv", 0.0)
    if device_s <= 0:
        return None
    bound = sum(roofline.bound_s(**roofline.flash_backward(q, k, bias))
                for q, k, bias in p.get("calls", {}).get("flash_bwd_dq", []))
    return 100.0 * bound / device_s
