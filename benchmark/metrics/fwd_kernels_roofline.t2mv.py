"""The hand forward kernels' share of their roofline in a text-to-multiview
cell, reckoned as ``fwd_kernels_roofline.video.py`` reckons it (the
calls of ``attention``, ``fused_ln_self_attention`` and
``fused_ln_geglu_ff`` under their ranges); the text cross-attention,
under a range of its own, is ``xattn_roofline.t2mv``'s."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_fwd_kernels_roofline_video",
    Path(__file__).with_name("fwd_kernels_roofline.video.py"))
_video = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_video)


def read(ctx):
    return _video.read(ctx)
