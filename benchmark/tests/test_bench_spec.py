"""The harness finds every cell, configuration, traffic mix, traffic
kind's loop, limit file and per-layer reader by the names in
BENCHMARK.json, refuses an unknown one, and prints the contract's result
line."""

import json
import math
import sys

import pytest

from benchmark import harness, traffic
from conftest import ROOT, SEED

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_from_its_files(cell):
    workload, config = harness.cell_of(SPEC, cell)
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    loop = harness.load_kind(traffic.load(workload["traffic"])["kind"])
    assert callable(loop.drive) and callable(loop.flops) and callable(loop.check)
    assert callable(loop.control)
    assert harness.load_limits(cell)
    assert any(m["name"] == "setup_s" for m in harness.metrics_of(SPEC, "end_to_end", cell))
    assert len(harness.metrics_of(SPEC, "end_to_end", cell)) >= 2
    assert harness.metrics_of(SPEC, "per_layer", cell)


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    read = harness.load_reader(metric)
    # A reader that finds nothing to read returns nothing.
    assert read({"kind": "none", "window_s": 0.0, "flops": 0.0, "profiled": {}}) is None


@pytest.mark.parametrize("lookup", [
    lambda: harness.cell_of(SPEC, "no.such_cell"),
    lambda: traffic.load("no_such_mix"),
    lambda: harness.load_limits("no.such_cell"),
    lambda: harness.load_reader("no_such_metric"),
    lambda: harness.load_kind("no_such_kind"),
])
def test_unknown_names_are_refused(lookup):
    with pytest.raises(KeyError):
        lookup()


def test_result_line_has_the_contract_keys():
    line = harness.result_line(True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 1}, None, [("frame_rms", 0.5, 2.0)])
    out = json.loads(line)
    assert list(out) == list(harness.KEYS) + ["checks"]
    traced = json.loads(harness.result_line(False, 1, 0, {}, {}, {"device_ops": [],
                                                                  "idle_gaps": []},
                                            [("loss_rel", math.inf, 0.1)]))
    assert list(traced) == list(harness.KEYS) + ["breakdown", "checks"]
    assert traced["checks"]["loss_rel"]["value"] == "inf"


def test_an_unknown_kind_of_traffic_is_refused():
    path = traffic.TRAFFIC_DIR / "zz_no_kind.json"
    try:
        path.write_text(json.dumps(dict(traffic.load("video80"), kind="no_such_kind")))
        with pytest.raises(ValueError, match="no loop"):
            traffic.load("zz_no_kind")
    finally:
        path.unlink(missing_ok=True)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A throwaway configuration, traffic mix of a new kind with its
    loop, cell, limit file and per-layer metric, added as new files and
    entries only."""
    names = {"traffic": traffic.TRAFFIC_DIR / "zz_throwaway.json",
             "loop": traffic.KINDS_DIR / "zz_throwaway.py",
             "limits": harness.HERE / "limits" / "zz.throwaway.json",
             "metric": harness.HERE / "metrics" / "zz_throwaway.video.py"}
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="zz-config"))
    spec["workloads"].append({"name": "zz.throwaway", "config": "zz-config",
                              "traffic": "zz_throwaway", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "zz_throwaway.video", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "Sampling loop",
                              "moves": "frames_per_s", "workloads": ["zz.throwaway"]})
    for e in spec["end_to_end"]:
        if e["name"] == "frames_per_s":
            e["workloads"].append("zz.throwaway")
    try:
        names["loop"].write_text("from benchmark.kinds.scenes import check, control, drive\n"
                                   "def flops(counter, run, config, mix):\n    return 2.0\n")
        names["traffic"].write_text(json.dumps(dict(traffic.load("video80"), targets=4,
                                                    kind="zz_throwaway")))
        names["limits"].write_text(json.dumps({"limits": {"frame_rms": {"limit": 1.0}}}))
        names["metric"].write_text("def read(ctx):\n    return 1.0\n")
        cell, config = harness.cell_of(spec, "zz.throwaway")
        assert config["name"] == "zz-config"
        mix = traffic.load(cell["traffic"])
        assert mix["targets"] == 4
        assert harness.load_kind(mix["kind"]).flops(None, None, None, mix) == 2.0
        assert harness.load_limits("zz.throwaway") == {"frame_rms": 1.0}
        assert [m["name"] for m in harness.metrics_of(spec, "per_layer", "zz.throwaway")] == [
            "zz_throwaway.video"]
        assert harness.load_reader("zz_throwaway.video")({}) == 1.0
        assert {m["name"] for m in harness.metrics_of(spec, "end_to_end", "zz.throwaway")} == {
            "frames_per_s", "peak_mem_gib", "setup_s"}
    finally:
        for path in names.values():
            path.unlink(missing_ok=True)


# A second architecture: its own parameter names, and a denoiser that takes
# a conditioning vector besides (x, t).
THROWAWAY_REFERENCE = """
import torch
import torch.nn as nn

from .numerics import Numerics


class Denoiser(nn.Module):
    def __init__(self, nx, cfg):
        super().__init__()
        self.nx = nx
        self.body = nn.Linear(cfg["in_channels"], cfg["width"])
        self.cond_embed = nn.Linear(cfg["cond_dim"], cfg["width"], bias=False)

    def forward(self, x, t, cond):
        h = self.nx.linear(x, self.body.weight, self.body.bias)
        return h + self.nx.linear(cond, self.cond_embed.weight)[:, None, None, None]


class Model(nn.Module):
    def __init__(self, model_cfg, nx=None):
        super().__init__()
        self.denoiser = Denoiser(nx or Numerics(), model_cfg)
        self.autoencoder = nn.Linear(3, model_cfg["in_channels"])


def unet_inputs(model_cfg, b, v, hw, backward=False):
    x = torch.empty(b, v, hw, hw, model_cfg["in_channels"], device="meta",
                    requires_grad=backward)
    t = torch.zeros(b, v, dtype=torch.int64, device="meta")
    return x, t, torch.empty(b, model_cfg["cond_dim"], device="meta")
"""

# Its kind of traffic: a loop that runs nothing, FLOPs through the Counter,
# a check through check.reference_model and a control of its own.
THROWAWAY_KIND = """
import math

import torch

from benchmark import check as checks, program, weights

UNIT = "views"


def drive(system, mix, config, shapes, seed, seconds, trace, t_start):
    run = program.Run("zz_arch", UNIT, window_s=1.0, attempted=1, done=1)
    run.e2e = {"frames_per_s": 1.0, "peak_mem_gib": 0.0}
    run.items.append(shapes)
    run.profiled = {"busy_s": 0.5, "window_s": 1.0, "device_ops": [], "idle_gaps": [], "done": 1}
    return run


def flops(counter, run, config, mix):
    return counter.unet(2, 3, 4)


def check(run, config, mix, seed, device):
    model = checks.reference_model(config, seed, device)
    made = weights.make(run.items[0], seed, device, program.dtype_of(config))
    same = all(torch.equal(p, made[k].float()) for k, p in model.named_parameters())
    return {"frame_rms": 0.0 if same else math.inf}


def control(config, mix, seed, device, fault):
    return {"frame_rms": 99.0, "fault": fault}
"""


def test_a_new_architecture_needs_only_new_files(monkeypatch):
    """A configuration that names its own reference module, with a kind of
    its own: the harness's shapes, the check's reference, the FLOP count
    and the control's readings all come from the new files.

    The program under test is stubbed (``NoProgram``): ``program.System``
    builds the port's MV-LDM for every configuration, so this proves the
    yardstick's side only, not that the port builds a new architecture."""
    import importlib

    import torch

    from benchmark import check, control, program, weights
    from benchmark.flops import Counter

    names = {"reference": harness.HERE / "reference" / "zz_throwaway.py",
             "config": harness.HERE / "configs" / "zz-throwaway.json",
             "loop": traffic.KINDS_DIR / "zz_arch.py",
             "traffic": traffic.TRAFFIC_DIR / "zz_arch.json",
             "limits": harness.HERE / "limits" / "zz.arch.json",
             "metric": harness.HERE / "metrics" / "zz_arch.flops.py"}
    config = {"name": "zz-throwaway", "reference": "zz_throwaway", "dtype": "float32",
              "model": {"in_channels": 6, "width": 8, "cond_dim": 5}}
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "zz-throwaway", "source": "a test",
                            "file": "benchmark/configs/zz-throwaway.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "zz.arch", "config": "zz-throwaway", "traffic": "zz_arch",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "zz_arch.flops", "unit": "FLOP", "better": "higher",
                              "source": "host_clock", "layer": "Whole step",
                              "moves": "frames_per_s", "workloads": ["zz.arch"]})
    for e in spec["end_to_end"]:
        if e["name"] == "frames_per_s":
            e["workloads"].append("zz.arch")
    seen = {}

    class NoProgram:
        def __init__(self, config, shapes, seed, device):
            seen["shapes"] = shapes

    monkeypatch.setattr(program, "System", NoProgram)
    monkeypatch.setattr("sys.dont_write_bytecode", True)
    try:
        names["reference"].write_text(THROWAWAY_REFERENCE)
        names["loop"].write_text(THROWAWAY_KIND)
        names["config"].write_text(json.dumps(config))
        names["traffic"].write_text(json.dumps({"kind": "zz_arch", "why": "a test"}))
        names["limits"].write_text(json.dumps({"limits": {"frame_rms": {"limit": 1.0}}}))
        names["metric"].write_text("def read(ctx):\n    return ctx['flops']\n")
        importlib.invalidate_caches()

        line, _ = harness.run_cell("zz.arch", SEED, 1.0, True, device="cpu", spec=spec)
        out = json.loads(line)
        # The harness's shapes are the throwaway model's published names.
        assert seen["shapes"] == {"autoencoder.bias": (6,), "autoencoder.weight": (6, 3),
                                  "denoiser.body.bias": (8,), "denoiser.body.weight": (8, 6),
                                  "denoiser.cond_embed.weight": (8, 5)}
        # check.reference_model built it with the seeded weights.
        assert out["correct"] and out["checks"]["frame_rms"]["value"] == 0.0
        model = check.reference_model(config, SEED, "cpu")
        made = weights.make(seen["shapes"], SEED, "cpu", torch.float32)
        assert {k: p.shape for k, p in model.named_parameters()} == {
            k: w.shape for k, w in made.items()}
        assert all(torch.equal(p, made[k]) for k, p in model.named_parameters())
        assert model.denoiser.body.weight.abs().sum() > 0
        # The Counter counts its forward on its own unet_inputs: the two
        # products, over the views' tokens and over the conditioning.
        want = 2.0 * (2 * 3 * 4 * 4) * 6 * 8 + 2.0 * 2 * 5 * 8
        assert Counter(config).unet(2, 3, 4) == want
        assert out["metrics"]["zz_arch.flops"]["value"] == want
        # control.py dispatches to the kind's own control.
        mix = traffic.load("zz_arch")
        assert control.readings(config, mix, SEED, "cpu", "half_batch") == {
            "frame_rms": 99.0, "fault": "half_batch"}
    finally:
        for path in names.values():
            path.unlink(missing_ok=True)
        for module in ("benchmark.reference.zz_throwaway", "benchmark.kinds.zz_arch"):
            sys.modules.pop(module, None)


@pytest.mark.parametrize("reference", ["no_such_module", "numerics", "../model", 3])
def test_an_unknown_reference_is_refused(reference):
    """A name with no module under reference/, or a module that is no
    reference (it lacks Model or unet_inputs), is refused, naming the
    configuration."""
    from benchmark.reference import reference_of

    with pytest.raises(KeyError, match="zz-config"):
        reference_of({"name": "zz-config", "reference": reference, "model": {}})


def test_names_and_units_keep_the_contract():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[section]:
            assert name.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert unit.match(entry["unit"]), entry["unit"]
    for w in SPEC["workloads"]:
        assert name.match(w["traffic"]) and len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert all(name.match(k) for k in c["reduced"]) and len(c["source"]) <= 200


@pytest.mark.parametrize("metric,reader", [("mfu.video", "mfu"), ("mfu.train", "mfu"),
                                           ("device_idle.nvs", "device_idle"),
                                           ("denoise_ms_per_frame.video",
                                            "denoise_ms_per_frame.video")])
def test_a_metric_reads_with_its_own_reader_or_its_family_s(metric, reader):
    assert harness.load_reader(metric).__module__ == "benchmark_metric_" + reader.replace(".", "_")
