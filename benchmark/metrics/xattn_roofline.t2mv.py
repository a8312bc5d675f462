"""The text cross-attention's share of its roofline: the sum over the
calls of ``text_cross_attention`` (the flash forward onto the prompt's
text tokens, Lk = 77) of each call's bound, over the device time of the
kernels launched inside the ``bench/text_cross_attention`` range
(``kinds/t2mv.py``), in %."""

from benchmark import roofline


def read(ctx):
    p = ctx["profiled"]
    device_s = p.get("device_s_by_span", {}).get("text_cross_attention", 0.0)
    calls = p.get("calls", {}).get("text_cross_attention", [])
    if device_s <= 0 or not calls:
        return None
    bound = sum(roofline.bound_s(**roofline.flash_forward(q, k, bias)) for q, k, bias in calls)
    return 100.0 * bound / device_s
