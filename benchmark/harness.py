"""One run of one cell: read the cell from ``BENCHMARK.json``, its
configuration, traffic mix and limits from their files, drive the
program, check what it produced against the reference, and print the
result as the last line of standard output.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in files of its own, found by the names in
``BENCHMARK.json``: ``configs/<file>``, ``traffic/<traffic>.json`` (whose
``kind`` names its loop, ``kinds/<kind>.py``), ``limits/<cell>.json`` and
``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mvldm_tpu")
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def load_spec(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: Dict, name: str) -> Tuple[Dict, Dict]:
    """The workload entry named ``name`` and its configuration entry."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if cell["config"] not in configs:
        raise KeyError(f"workload {name!r} names no known configuration {cell['config']!r}")
    return cell, configs[cell["config"]]


def metrics_of(spec: Dict, section: str, cell: str) -> List[Dict]:
    """The metrics of ``section`` that cell ``cell`` reports."""
    return [m for m in spec[section] if "workloads" not in m or cell in m["workloads"]]


def load_limits(cell: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{cell}.json"
    if not path.is_file():
        raise KeyError(f"no limits for workload {cell!r} ({path} is missing)")
    return {k: v["limit"] for k, v in json.loads(path.read_text())["limits"].items()}


def load_reader(metric: str):
    """The ``read`` of ``metrics/<metric>.py`` or, where there is none, of
    the reader of its family, ``metrics/<name before the first dot>.py``
    (``mfu.py`` reads ``mfu.video`` and ``mfu.train``)."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            break
    else:
        raise KeyError(f"no reader for metric {metric!r} (metrics/{metric}.py is missing)")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                breakdown: Optional[Dict], checks: List[Tuple[str, float, float]]) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                     for name, v, lim in checks}
    return json.dumps(out)


def load_kind(kind: str):
    """``kinds/<kind>.py``: the loop of a traffic kind (``drive``), its
    model FLOPs (``flops``), its check of ``correct`` (``check``) and
    its control's readings (``control``, read by ``control.py``)."""
    if not (HERE / "kinds" / f"{kind}.py").is_file():
        raise KeyError(f"no loop for traffic kind {kind!r} (kinds/{kind}.py is missing)")
    return importlib.import_module(f"benchmark.kinds.{kind}")


def reading_context(run, loop, config: Dict, mix: Dict) -> Dict:
    """What the per-layer readers read: the kind of traffic and its unit,
    the measured window (its wall seconds, the units it completed and
    their model FLOPs) and the profiled part."""
    from .flops import Counter

    return {"kind": run.kind, "unit": run.unit, "window_s": run.window_s, "done": run.done,
            "flops": loop.flops(Counter(config), run, config, mix),
            "profiled": run.profiled}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, spec: Optional[Dict] = None,
             config: Optional[Dict] = None, mix: Optional[Dict] = None,
             limits: Optional[Dict] = None, **hooks) -> Tuple[str, List[str]]:
    """Run cell ``name`` once; returns the result line and the lines that
    name each number compared beside its limit. Tests pass a small
    ``config`` / ``mix`` / ``limits`` and ``device="cpu"``."""
    import torch

    from . import check, program, traffic, weights
    from .reference import reference_of

    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec()
    cell, config_entry = cell_of(spec, name)
    config = config or json.loads((ROOT / config_entry["file"]).read_text())
    mix = mix or traffic.load(cell["traffic"])
    limits = limits or load_limits(name)
    with torch.device("meta"):
        shapes = weights.spec(reference_of(config).Model(config["model"]).named_parameters())

    on_card = torch.device(device).type == "cuda"
    system = program.System(config, shapes, seed, device)
    hook = hooks.pop("system_hook", None)
    if hook is not None:
        hook(system)
    loop = load_kind(mix["kind"])
    run = loop.drive(system, mix, config, shapes, seed, seconds, trace and on_card, t_start,
                       **hooks)
    del system
    check.free()
    correct, rows = check.judge(loop.check(run, config, mix, seed, device), limits)

    metrics: Dict[str, Dict] = {}
    breakdown = None
    dev: Dict = {"platform": "gpu" if on_card else "cpu",
                 "kind": torch.cuda.get_device_name() if on_card else "cpu",
                 "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    if trace and run.profiled:
        ctx = reading_context(run, loop, config, mix)
        for m in metrics_of(spec, "per_layer", name):
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=run.profiled["busy_s"], window_s=run.profiled["window_s"])
        breakdown = {"device_ops": run.profiled["device_ops"],
                     "idle_gaps": run.profiled["idle_gaps"]}
    elif not trace:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in metrics_of(spec, "end_to_end", name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    lines = [f"attempted {run.attempted} in {run.window_s:.3f} s"]
    if run.kind == "requests":
        lat = sorted(s.latency_s for s in run.items)
        lines.append(f"request latency samples {len(lat)}: min {lat[0]:.4f} median "
                     f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s")
    if run.profiled:
        p = run.profiled
        lines.append(f"profiled {p['window_s']:.3f} s: {p.get('kernels')} device operations, "
                     f"{p.get('attributed')} traced to their launch; device s by span "
                     + json.dumps(p.get("device_s_by_span")))
    lines += [f"check {n} = {v!r} (limit {lim!r})" for n, v, lim in rows]
    return result_line(correct, run.attempted, run.failed, metrics, dev, breakdown, rows), lines


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    spec = load_spec()
    cell, _ = cell_of(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    line, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=t_start, spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0
