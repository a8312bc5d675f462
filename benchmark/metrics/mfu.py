"""``mfu.*``: the whole step's share of the card's bf16 peak: the
model FLOPs of the work the measured window completed (counted on the
plain reference, see ``flops.py``) over the window's wall seconds, over
989 TFLOP/s, in %."""

from benchmark import roofline


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["flops"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / roofline.PEAK_BF16_FLOPS
