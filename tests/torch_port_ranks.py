"""One rank of the port's multi-rank CPU tests (gloo). Not a test module:
``tests/test_torch_port_parallel*.py`` start it, one process a rank, as

    MVLDM_COORDINATOR=localhost:<port> MVLDM_NUM_PROCESSES=2 \\
        MVLDM_PROCESS_ID=<rank> python tests/torch_port_ranks.py <spec.pkl> <out_dir>

It imports neither JAX nor the JAX package. ``spec.pkl`` holds a list of
jobs, each a dict with a ``kind``; rank r writes what its jobs return to
``<out_dir>/rank<r>.pt``. Use :func:`launch` to start the ranks under a
time limit.
"""

from __future__ import annotations

import copy
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` rank processes running ``jobs`` (see :func:`launch`)."""

    def __init__(self, jobs, out_dir, world: int = 2, timeout: float = 240.0):
        self.out_dir, self.world = Path(out_dir), world
        self.deadline = time.monotonic() + timeout
        self.out_dir.mkdir(parents=True, exist_ok=True)
        spec = self.out_dir / "spec.pkl"
        spec.write_bytes(pickle.dumps(jobs))
        port = free_port()
        self.procs = []
        try:
            for r in range(world):
                env = dict(os.environ, MVLDM_COORDINATOR=f"localhost:{port}",
                           MVLDM_NUM_PROCESSES=str(world), MVLDM_PROCESS_ID=str(r),
                           OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), str(spec),
                     str(self.out_dir)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        except BaseException:
            self.kill()
            raise

    def kill(self) -> None:
        for p in self.procs:
            p.kill()

    def results(self) -> list:
        """Each rank's results, once all have ended; the ranks are killed,
        and the test fails, when the time limit passes first."""
        try:
            logs = [p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))[0]
                    for p in self.procs]
        finally:
            self.kill()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
        import torch

        return [dict(torch.load(self.out_dir / f"rank{r}.pt", weights_only=False),
                     log=logs[r]) for r in range(self.world)]


def launch(jobs, out_dir, world: int = 2, timeout: float = 240.0) -> list:
    """Run ``jobs`` on ``world`` ranks (gloo, a free localhost port) and
    return each rank's results. Every rank is killed if the ranks have not
    all ended within ``timeout`` seconds, so a hung rendezvous fails the
    test instead of stalling the suite."""
    return Ranks(jobs, out_dir, world, timeout).results()


# ------------------------------------------------------------------ jobs

def tiny_engine(model):
    """The tiny port engine of ``model`` = {"cfg": ModelCfg, "sd": state
    dict}, as ``tests/test_torch_port_training.port_train_engine`` builds it."""
    from mvldm_tpu_torch.builder import MVLDM
    from mvldm_tpu_torch.diffusion.engine import DiffusionEngine
    from mvldm_tpu_torch.diffusion.schedulers import DDIMScheduler, DDIMSchedulerKwargs

    net = MVLDM(model["cfg"])
    net.load_state_dict(model["sd"], strict=True)
    net.eval()
    sched = DDIMScheduler.create(DDIMSchedulerKwargs(clip_sample=False), num_inference_steps=4)
    engine = DiffusionEngine(model["cfg"], net.denoiser, net.autoencoder, sched, cfg_mode="auto")
    engine.unet.remat = False
    engine.vae.requires_grad_(False)
    return engine


def _rows(x, rows):
    return x if x is None else x[rows]


def job_attention(job):
    """head_sharded_attention (the joint cross-view attention under
    ``data_model``) of a ``CrossAttention`` with the weights ``job["sd"]``
    over a 1 x world grid: its output and this rank's gradients of
    sum(out * g)."""
    import torch

    from mvldm_tpu_torch.models.layers import CrossAttention
    from mvldm_tpu_torch.parallel.mesh import make_mesh
    from mvldm_tpu_torch.parallel.tp import head_sharded_attention, use_head_sharding

    mesh = make_mesh(num_data=1, num_model=job["world"])
    c, heads, dim = job["c"], job["heads"], job["head_dim"]
    attn = CrossAttention(c, c, heads, dim)
    attn.load_state_dict({k: torch.tensor(v) for k, v in job["sd"].items()})
    x = torch.tensor(job["x"], requires_grad=True)
    assert use_head_sharding(heads, mesh)
    out = head_sharded_attention(attn, x, torch.tensor(job["bias"]), mesh=mesh)
    (out * torch.tensor(job["g"])).sum().backward()
    return {"out": out.detach(), "dx": x.grad,
            **{f"d_{k}": p.grad for k, p in attn.named_parameters()}}


def job_step(job):
    """One train step of the tiny engine under ``job["strategy"]`` on this
    rank's share of the batch and draws; then the whole reduced gradient,
    the loss, the grad norm and the whole masters after the step. With
    ``job["ckpt"]`` the whole state after the step is saved there (rank 0)
    and a second step is taken."""
    import torch

    from mvldm_tpu_torch.diffusion.engine import Batch, TrainDraws
    from mvldm_tpu_torch.parallel.distributed import is_main_process, sync_processes
    from mvldm_tpu_torch.parallel.mesh import make_mesh
    from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer
    from mvldm_tpu_torch.training.checkpoint import CheckpointManager
    from mvldm_tpu_torch.training.optim import LRSchedulerCfg, OptimizerCfg
    from mvldm_tpu_torch.training.strategy import Strategy
    from mvldm_tpu_torch.training.trainer import TrainState, make_train_step, master_params

    engine = tiny_engine(job["model"])
    name, nd, nm = job["strategy"], job["num_data"], job["num_model"]
    mesh = make_mesh(nd, nm)
    tx = build_optimizer(OptimizerCfg(*job["opt"]),
                         build_lr_schedule(job["opt"][1], LRSchedulerCfg(*job["sched"])),
                         gradient_clip_val=job["clip"])
    strategy = Strategy(name, mesh, engine.unet, tx)
    params = strategy.store(master_params(engine.unet))
    state = TrainState(params=params, opt_state=tx.init(strategy.optimizer_params(params)),
                       ema_params={n: p.clone() for n, p in params.items()}, step=0)
    seen = {}
    apply = tx.apply

    def recording_apply(params_, grads, opt_state, noise=None, **callbacks):
        seen["grads"] = ({n: g.clone() for n, g in grads.items()} if strategy.whole_optimizer
                         else strategy.whole(grads, sliced=True))
        return apply(params_, grads, opt_state, noise, **callbacks)

    tx.apply = recording_apply
    step = make_train_step(engine, tx, job["v_c"], strategy=strategy)
    b = job["arrays"][0].shape[0] // nd
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    out = {}
    for i, draws in enumerate(job["draws"]):
        batch = Batch(*(torch.from_numpy(a[rows]) for a in job["arrays"]))
        d = TrainDraws(**{k: v[rows] for k, v in draws.items()})
        state, m = step(state, batch, d)
        out[f"loss{i}"] = float(m["loss/diffusion"])
        out[f"grad_norm{i}"] = float(m["grad_norm"])
        if i == 0:
            out["grads"] = seen["grads"]
            # deep-copied: on the CPU a whole leaf is the live tensor itself
            whole = copy.deepcopy(strategy.whole_state(state))
            out["masters"], out["ema"] = whole["params"], whole["ema_params"]
            out["mu"] = whole["opt_state"].get("mu")
            if job.get("ckpt"):
                if is_main_process():
                    CheckpointManager(job["ckpt"]).save(1, whole)
                sync_processes("ckpt")
    out["final"] = strategy.whole_state(state)["params"]
    named = dict(engine.unet.named_parameters())
    out["module_is_masters"] = all(torch.equal(named[n].detach(), p)
                                   for n, p in out["final"].items())
    out["sliced"] = list(strategy.sliced)
    return out


def job_fit(job):
    """Trainer.fit for 3 steps (log every step, a checkpoint every 2 and at
    the end, a validation hook every 2) with every file write recorded."""
    import json

    from mvldm_tpu_torch.parallel.mesh import make_mesh
    from mvldm_tpu_torch.training import Trainer, build_lr_schedule, build_optimizer
    from mvldm_tpu_torch.training.checkpoint import CheckpointManager
    from mvldm_tpu_torch.training.optim import OptimizerCfg
    from mvldm_tpu_torch.training.strategy import Strategy

    engine = tiny_engine(job["model"])
    tx = build_optimizer(OptimizerCfg("AdamW", 1e-4), build_lr_schedule(1e-4, None),
                         gradient_clip_val=0.1)
    strategy = Strategy(job["strategy"], make_mesh(), engine.unet, tx)
    saves, hooks = [], []
    save = CheckpointManager.save

    def recording_save(self, step, state):
        saves.append(step)
        return save(self, step, state)

    CheckpointManager.save = recording_save

    class Loader:
        def __iter__(self):
            return iter([job["raw"]] * 5)

        def close(self, timeout=None):
            pass

    class Data:
        def train_dataloader(self):
            return Loader()

    trainer = Trainer(engine, tx, Data(), job["run_dir"], max_steps=3,
                      num_context_views=job["v_c"], checkpoint_every=2, log_every=1,
                      use_ema=True, val_hook=lambda s, step: hooks.append(
                          (step, sorted(s.params) == sorted(s.ema_params),
                           all(p.shape == engine.unet.get_parameter(n).shape
                               for n, p in s.params.items()))),
                      val_check_interval=2, strategy=strategy)
    try:
        state = trainer.fit(trainer.init_state(), seed=4)
    finally:
        CheckpointManager.save = save
    log = trainer.metrics_log
    return {"saves": saves, "hooks": hooks, "step": state.step,
            "log": [json.loads(x) for x in log.read_text().splitlines()] if log.exists() else []}


def job_cli(job):
    """``scripts.main.main(argv, device="cpu")`` inside the rank's process
    group, with what it printed, the base learning rate of its config and
    a digest of each training batch the ``Trainer`` took."""
    import contextlib
    import hashlib
    import io

    import numpy as np

    from mvldm_tpu_torch.config import compose, load_typed_root_config
    from mvldm_tpu_torch.scripts import main as main_script
    from mvldm_tpu_torch.training.trainer import Trainer

    digests = []
    to_batch = Trainer._batch

    def recording_batch(self, raw):
        digests.append(hashlib.sha1(b"".join(
            np.ascontiguousarray(raw[role][k]).tobytes() for role in ("context", "target")
            for k in ("image", "extrinsics"))).hexdigest())
        return to_batch(self, raw)

    Trainer._batch = recording_batch
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main_script.main(job["argv"], device="cpu")
    finally:
        Trainer._batch = to_batch
    cfg = load_typed_root_config(compose(job["argv"]))
    return {"stdout": buf.getvalue(), "base_lr": main_script.base_lr(cfg), "batches": digests}


JOBS = {"attention": job_attention, "step": job_step, "fit": job_fit, "cli": job_cli}


def main() -> None:
    import torch

    from mvldm_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        shutdown_distributed,
    )

    torch.set_num_threads(1)
    spec, out_dir = Path(sys.argv[1]), Path(sys.argv[2])
    jobs = pickle.loads(spec.read_bytes())
    assert maybe_initialize_distributed(device="cpu")
    rank = torch.distributed.get_rank()
    results = {}
    try:
        for job in jobs:
            results[job["name"]] = JOBS[job["kind"]](job)
    finally:
        shutdown_distributed()
    torch.save(results, out_dir / f"rank{rank}.pt")


if __name__ == "__main__":
    main()
