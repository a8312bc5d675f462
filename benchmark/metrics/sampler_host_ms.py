"""``sampler_host_ms.*``: host milliseconds a unit of the profiled part
(a frame or a request) spends in the ``VideoSampler``'s own code: the self
time of its ``sampler.*`` spans (``mvldm_tpu_torch.utils.profiling``):
planning, camera stacking and padding, without the engine's calls and the
``sync.*`` waits, which are spans of their own inside them.

The program fills its registry only while a profiler runs. In a run of the
benchmark that is the profiled part alone, so the registry holds that
part's spans, and its units are ``ctx["profiled"]["done"]``. A program
without the registry, or one that recorded no ``sampler.*`` span, gives
None."""


def read(ctx):
    p = ctx["profiled"]
    if not p or not p.get("done"):
        return None
    from mvldm_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    spans = snapshot()["spans"] if snapshot is not None else {}
    own = [s["self_ms"] for name, s in spans.items() if name.startswith("sampler.")]
    if not own:
        return None
    return sum(own) / p["done"]
