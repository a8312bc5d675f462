"""Multi-process bootstrap (counterpart of
``mvldm_tpu/parallel/distributed.py``).

One process per card. The JAX package calls ``jax.distributed.initialize``;
the port calls ``torch.distributed.init_process_group``, from the same
variables. Launch recipe, one command per process:

    MVLDM_COORDINATOR=host0:8476 MVLDM_NUM_PROCESSES=4 MVLDM_PROCESS_ID=0 \\
        python -m mvldm_tpu_torch.scripts.main +experiment=baseline mode=train ...
    MVLDM_COORDINATOR=host0:8476 MVLDM_NUM_PROCESSES=4 MVLDM_PROCESS_ID=1 \\
        ... (and so on for each process)

or ``MVLDM_DISTRIBUTED=1 torchrun --nproc-per-node=4 -m
mvldm_tpu_torch.scripts.main ...``, which reads torchrun's ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``).

The backend is NCCL for a CUDA run and gloo for a CPU run;
``MVLDM_BACKEND`` (or the ``backend`` argument) overrides it, e.g. gloo
with CUDA tensors for two ranks that share one card, which NCCL refuses. A
CUDA rank binds ``cuda:<LOCAL_RANK>``, or ``cuda:<rank % device count>``
when ``LOCAL_RANK`` is unset.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False
# Seconds a collective or the rendezvous waits before it fails.
TIMEOUT_S = 1800


def is_main_process() -> bool:
    """True on the process that writes the job's files (rank 0, or the only
    process): the reference's ``rank_zero_only`` guards."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group, else (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sync_processes(name: str) -> None:
    """Barrier across processes; nothing in a single process. ``name``
    says in a hang's traceback which barrier it was."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shared_seed(device=None) -> int:
    """A seed from rank 0's OS entropy, the same on every rank (a broadcast
    from rank 0; collective); one process's own draw without a process
    group. ``device``: where the broadcast's tensor lives (NCCL needs a
    CUDA tensor)."""
    seed = torch.tensor([int.from_bytes(os.urandom(7), "little")], dtype=torch.int64,
                        device=device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast(seed, 0)
    return int(seed.item())


def _truthy(value: Optional[str]) -> bool:
    return (value or "").lower() in ("1", "true", "yes")


def maybe_initialize_distributed(env=os.environ, device=None,
                                 backend: Optional[str] = None) -> bool:
    """Start ``torch.distributed`` when the environment asks for it.

    Returns True when a process group was started (or already was). Returns
    False, and does nothing, when no variable is set, so one process never
    pays the rendezvous. Raises when only part of the explicit triplet
    (coordinator / number of processes / process id) is set. ``device`` is
    the run's device ("cuda" when None): it picks the default backend and
    the card a CUDA rank binds."""
    global _initialized
    if _initialized or dist.is_initialized():
        return True

    coordinator = env.get("MVLDM_COORDINATOR")
    num_processes = env.get("MVLDM_NUM_PROCESSES")
    process_id = env.get("MVLDM_PROCESS_ID")
    auto = _truthy(env.get("MVLDM_DISTRIBUTED"))

    explicit = (coordinator, num_processes, process_id)
    if any(v is not None for v in explicit) and not all(v is not None for v in explicit):
        raise ValueError(
            "Partial multi-host configuration: set all of MVLDM_COORDINATOR, "
            f"MVLDM_NUM_PROCESSES, MVLDM_PROCESS_ID (got {explicit}).")
    if not auto and coordinator is None:
        return False

    device = torch.device(device or "cuda")
    backend = backend or env.get("MVLDM_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if coordinator is not None:
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator}"
    else:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = "env://"
    if device.type == "cuda":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    _initialized = True
    return True


def shutdown_distributed() -> None:
    """Destroy the process group, if one was started."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
