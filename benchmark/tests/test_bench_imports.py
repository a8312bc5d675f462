"""No module the benchmark runs imports JAX or the JAX package; the plain
reference imports nothing of the program either. Top-level names are
compared whole: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "mvldm_tpu"}
RUN = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py")) + [BENCH / "weights.py",
                                                          BENCH / "flops.py"]


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", RUN, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_what_the_benchmark_runs(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"mvldm_tpu_torch"})


def test_loaded_modules_after_a_reference_run():
    """What a process loads, not what a file names: the reference, its
    weights and the FLOP counter leave no module of the program, JAX or
    the JAX package in ``sys.modules``."""
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.flops import Counter\n"
        "cfg = json.load(open(sys.argv[1]))\n"
        "Counter(cfg).unet(1, 2, 8)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(BENCH / "configs" / "mvldm-sd21-st3d.json")],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"mvldm_tpu_torch"})


def test_harness_refuses_a_run_that_loaded_jax(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib"]
