"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, which is loaded with ``ctypes``.
The build happens at first use, from the sources in this package only, into
``build/mvldm_tpu_torch/`` at the repository root (listed in
``.gitignore``). A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a current one is reused.
:func:`build` starts one ``nvcc`` per missing library, all at once.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mvldm_tpu_torch"
SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "fused_ln_attn", "fused_ln_geglu_ff",
           "micro_matmul", "micro_attn", "micro_exp", "f32_route")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together. Returns {name: (seconds,
    compiler log)} for the libraries built by this call; raises with the
    compiler's output if any build fails."""
    names = [n for n in names if not _lib_path(n).exists()]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List[Tuple[str, Path, subprocess.Popen, float]] = []
    for name in names:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), time.perf_counter()))
    logs: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        logs[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry to its ``argtypes``. Every entry returns a CUDA error code
    as ``int``."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = open_lib(_lib_path(name), signatures)
    return lib


def open_lib(path: Path, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Load the built library at ``path`` and declare each C entry of
    ``signatures`` with its ``argtypes`` and an ``int`` (CUDA error) return."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
