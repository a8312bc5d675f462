"""The hand forward kernels' share of their roofline: the sum over the
calls of ``attention`` (flash forward), ``fused_ln_self_attention`` and
``fused_ln_geglu_ff`` of each call's bound, over the device time of the
kernels launched inside those calls' ranges, in %."""

from benchmark import roofline


def read(ctx):
    p = ctx["profiled"]
    spans = p.get("device_s_by_span", {})
    calls = p.get("calls", {})
    names = ("attention", "fused_ln_self_attention", "fused_ln_geglu_ff")
    device_s = sum(spans.get(n, 0.0) for n in names)
    if device_s <= 0:
        return None
    bound = 0.0
    for q, k, bias in calls.get("attention", []):
        bound += roofline.bound_s(**roofline.flash_forward(q, k, bias))
    for x, heads, head_dim in calls.get("fused_ln_self_attention", []):
        bound += roofline.bound_s(**roofline.ln_self_attention(x, heads, head_dim))
    for x, width in calls.get("fused_ln_geglu_ff", []):
        bound += roofline.bound_s(**roofline.ln_geglu_ff(x, width))
    return 100.0 * bound / device_s
