"""``host_syncs.*``: the program's host syncs a unit of the profiled part:
the sum of its ``sync.*`` counters (``mvldm_tpu_torch.utils.profiling``,
one for each call that holds the host until the device has drained) over
the units the profiled part completed (frames, requests or micro-steps).

The program fills its registry only while a profiler runs. In a run of the
benchmark that is the profiled part alone, so the registry holds that
part's counts, and its units are ``ctx["profiled"]["done"]``. A program
without the registry, or one that recorded nothing, gives None."""


def read(ctx):
    p = ctx["profiled"]
    if not p or not p.get("done"):
        return None
    from mvldm_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    recorded = snapshot() if snapshot is not None else {}
    if not recorded.get("spans") and not recorded.get("counters"):
        return None
    syncs = sum(n for name, n in recorded["counters"].items() if name.startswith("sync."))
    return syncs / p["done"]
