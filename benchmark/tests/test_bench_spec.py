"""The harness finds every cell, configuration, traffic mix, traffic
kind's loop, limit file and per-layer reader by the names in
BENCHMARK.json, refuses an unknown one, and prints the contract's result
line."""

import json
import math

import pytest

from benchmark import harness, traffic
from conftest import ROOT

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
        names["loop"].write_text("from benchmark.kinds.scenes import check, drive\n"
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
