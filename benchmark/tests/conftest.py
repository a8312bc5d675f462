"""Small configurations and traffic mixes for the benchmark's CPU tests:
the repository's ``tiny`` experiment (``configs/experiment/tiny.yaml``)
in place of the published widths, 64 px, short scenes."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 77  # more than 32 signed bits hold


def tiny_config(name: str = "mvldm-sd21-st3d", dtype: str = "float32") -> dict:
    from mvldm_tpu_torch.config import compose

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    tiny = compose(["+experiment=tiny"])["model"]
    tiny["denoiser"]["multi_view_attention"] = cfg["model"]["denoiser"]["multi_view_attention"]
    tiny["denoiser"]["multi_view_attention"]["num_heads"] = 4
    cfg["model"] = tiny
    cfg["dtype"] = dtype
    return cfg


def tiny_mix(traffic_name: str) -> dict:
    from benchmark import traffic

    mix = copy.deepcopy(traffic.load(traffic_name))
    mix["hw"] = 64
    if mix["kind"] == "scenes":
        mix.update(targets=8, max_parallel_groups=2)
    if mix["kind"] == "train":
        mix["batch_size"] = 2
    return mix


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    yield
    torch.set_num_threads(threads)
