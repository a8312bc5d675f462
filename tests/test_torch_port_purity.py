"""The port stands alone: it imports neither JAX nor the JAX package."""

import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "mvldm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import mvldm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mvldm_tpu_torch.__path__, "mvldm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "mvldm_tpu" or m.startswith("mvldm_tpu."))
print(json.dumps({"imported": len(names), "bad": bad}))
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["imported"] >= 15
    assert result["bad"] == []


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|mvldm_tpu)\b(?!_torch)"
                         r"|mvldm_tpu\.", re.MULTILINE)
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in PORT_FILES for m in pattern.finditer(p.read_text())]
    assert offenders == []
