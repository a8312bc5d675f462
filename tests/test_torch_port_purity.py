"""The port stands alone: it imports neither JAX nor the JAX package, and
importing it loads neither PyYAML nor Pillow (each is imported where a
config or an image is read)."""

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
lazy = sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "PIL"))
print(json.dumps({"imported": names, "bad": bad, "lazy": lazy}))
"""

# The modules of the sampling CLI's slice, each of which must be among those
# imported.
CLI_SLICE = [
    "mvldm_tpu_torch.config",
    "mvldm_tpu_torch.data.chunk_reader",
    "mvldm_tpu_torch.data.dataset_re10k",
    "mvldm_tpu_torch.data.dataset_re10kv2",
    "mvldm_tpu_torch.data.loader",
    "mvldm_tpu_torch.data.shims",
    "mvldm_tpu_torch.data.types",
    "mvldm_tpu_torch.data.view_samplers",
    "mvldm_tpu_torch.models.standard_transformer",
    "mvldm_tpu_torch.scripts.generate_mvldm",
    "mvldm_tpu_torch.scripts.main",
    "mvldm_tpu_torch.utils.image_io",
    "mvldm_tpu_torch.utils.mp4",
    "mvldm_tpu_torch.utils.rotation_utils",
]
# The modules of the training CLI's slice.
TRAIN_SLICE = [
    "mvldm_tpu_torch.training.checkpoint",
    "mvldm_tpu_torch.training.optim",
    "mvldm_tpu_torch.training.trainer",
    "mvldm_tpu_torch.utils.profiling",
    *(f"mvldm_tpu_torch.visualization.{m}" for m in (
        "annotation", "camera_trajectory", "cameras", "color_map", "drawing", "layout",
        "validation_in_3d")),
]

# The modules of the training variants' and the evaluation's slice.
EVAL_SLICE = [
    "mvldm_tpu_torch.data.latent_cache",
    *(f"mvldm_tpu_torch.evaluation.{m}" for m in (
        "fid", "inception", "metric_computer", "metrics")),
    *(f"mvldm_tpu_torch.scripts.{m}" for m in (
        "compute_fid", "compute_metrics", "generate_gt", "generate_gt_image_directory",
        "precompute_latents")),
]

# The modules of the multi-rank training and the last modules' slice.
PARALLEL_SLICE = [
    "mvldm_tpu_torch.parallel.distributed",
    "mvldm_tpu_torch.parallel.mesh",
    "mvldm_tpu_torch.parallel.tp",
    "mvldm_tpu_torch.training.strategy",
    "mvldm_tpu_torch.evaluation.evaluation_index_generator",
    "mvldm_tpu_torch.evaluation.co3d_evaluation_index_generator",
    *(f"mvldm_tpu_torch.scripts.{m}" for m in (
        "generate_evaluation_index", "generate_co3d_evaluation_index", "verify_parity")),
    *(f"mvldm_tpu_torch.utils.{m}" for m in (
        "ckpt_manifest", "wandb_tools", "lpips_convert", "inception_convert")),
]


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["imported"]) >= 40
    assert [m for m in CLI_SLICE + TRAIN_SLICE + EVAL_SLICE + PARALLEL_SLICE
            if m not in result["imported"]] == []
    assert result["bad"] == []
    assert result["lazy"] == []


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|mvldm_tpu)\b(?!_torch)"
                         r"|mvldm_tpu\.", re.MULTILINE)
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in PORT_FILES for m in pattern.finditer(p.read_text())]
    assert offenders == []


def test_the_port_has_every_module_of_the_jax_package():
    """Comparing the two packages' file lists leaves only
    ``data/native_chunk.py``: the port reads chunks with
    ``torch.load(weights_only=True)`` and needs no native reader."""
    def modules(pkg):
        return {p.relative_to(REPO / pkg).as_posix() for p in (REPO / pkg).rglob("*.py")}

    assert modules("mvldm_tpu") - modules("mvldm_tpu_torch") == {"data/native_chunk.py"}
