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
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mvldm_tpu_torch"
SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "fused_ln_attn", "fused_ln_geglu_ff",
           "micro_matmul", "micro_attn", "micro_exp", "f32_route", "fused_adamw",
           "group_norm_nhwc")
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
            _lib_path(name).with_suffix(".log").write_text(log)
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build_log(name: str) -> Optional[str]:
    """nvcc's log of the current build of ``csrc/<name>.cu`` (``-Xptxas=-v``:
    registers and spills), kept beside the library; None before a build."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else None


def kernel_name(mangled: str) -> str:
    """A readable name of a mangled kernel entry: its function name and
    integer template arguments, as ``flash_bwd_dq_f32<40>``."""
    m = re.match(r"_ZN?(.*)", mangled)
    rest, name = (m.group(1) if m else mangled), mangled
    while True:  # the length-prefixed names of the nested scopes; the last is the function
        m = re.match(r"(\d+)", rest)
        if not m:
            break
        n = int(m.group(1))
        name, rest = rest[len(m.group(1)):len(m.group(1)) + n], rest[len(m.group(1)) + n:]
    args = re.match(r"I((?:Li\d+E)+)E", rest)
    if args:
        name += "<" + ", ".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(log: str) -> List[dict]:
    """Each kernel entry of an ``nvcc -Xptxas=-v`` log: its name
    (:func:`kernel_name`), registers, spill store and load bytes and static
    shared memory."""
    out: List[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append(dict(kernel=kernel_name(m.group(1)), registers=None, spill_stores=0,
                            spill_loads=0, static_smem=0))
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[-1]["static_smem"] = int(m.group(1)) if m else 0
    return out


def sass_report(name: str, ops: Sequence[str] = ("HGMMA", "HMMA")) -> Dict[str, dict]:
    """{kernel: {op: count, "HGMMA forms": [...]}} over the built library of
    ``csrc/<name>.cu`` by ``cuobjdump -sass`` (beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_lib_path(name))], capture_output=True,
                          text=True, check=True).stdout
    out: Dict[str, dict] = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(kernel_name(line.split("Function :")[1].strip()),
                                 {op: 0 for op in ops})
            cur["HGMMA forms"] = []
        elif cur is not None:
            for op in ops:
                if re.search(rf"\b{op}\.", line):
                    cur[op] += 1
            m = re.search(r"\bHGMMA\.(\S+)", line)
            if m and m.group(1) not in cur["HGMMA forms"]:
                cur["HGMMA forms"].append(m.group(1))
    return out


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
    """The current CUDA stream of ``device``, read without building a
    ``torch.cuda.Stream`` (a few microseconds of host time a launch)."""
    import torch

    index = torch.device(device).index
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index))
