"""The fused AdamW route of ``training/optim.Optimizer`` (``ops/fused_adamw.py``,
``csrc/fused_adamw.cu``).

On the CPU (Tier-1):

* the route rule (``Optimizer.fused_step``): the benchmark's
  ``mvldm-sd21-st3d`` optimizer takes the fused kernels on the card
  (``FakeTensorMode`` tensors stand in for CUDA ones: the rule reads only
  device, dtype, layout and size); a bf16 ``mu``, ``nu_dtype``, SGD,
  Adafactor, CPU tensors and non-contiguous gradients take the foreach
  chain; a plan serves the state it was built on and no other;
* the kernels' per-element arithmetic, as their plain versions
  (``accumulate_reference``, ``update_reference``) with the optimizer's f32
  scalars, is bitwise the foreach chain over 3 accumulation cycles, the
  device-side select of the clip with a non-finite norm included;
* the ``optim.*`` spans name their route.

On the card (``-m cuda``; they skip without one): the fused route against
the foreach chain on the card, and the plain versions on the card against
both, bitwise after every micro-step, and the launch counts. (On the card
PyTorch divides by a host scalar as a product with its f32 reciprocal, and
the kernels do the same; on the CPU it divides.) This file imports no JAX: on the GPU machine run
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_fused_adamw.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mvldm_tpu_torch.ops import fused_adamw
from mvldm_tpu_torch.training import build_lr_schedule, build_optimizer
from mvldm_tpu_torch.training.optim import (
    LRSchedulerCfg,
    Optimizer,
    OptimizerCfg,
    global_norm,
    global_norm_tensor,
)
from mvldm_tpu_torch.utils import profiling

ST3D = Path(__file__).resolve().parent.parent / "benchmark" / "configs" / "mvldm-sd21-st3d.json"
SIZES = (1, 3, 4, 5, 7, 33, 1000, 4099)  # odd sizes and tails past a multiple of 4


def st3d_optimizer(**kwargs) -> Optimizer:
    """The optimizer of the benchmark's ``mvldm-sd21-st3d`` configuration
    (AdamW, lr 2e-5 LinearLR, clip 0.1, accumulation 2), ``kwargs`` over
    its optimizer's."""
    cfg = json.loads(ST3D.read_text())
    opt, trainer = cfg["optimizer"], cfg["trainer"]
    name = kwargs.pop("name", opt["name"])
    sched = opt["scheduler"]
    return build_optimizer(
        OptimizerCfg(name, opt["lr"], {**opt.get("kwargs", {}), **kwargs}),
        build_lr_schedule(opt["lr"], LRSchedulerCfg(sched["name"], sched["kwargs"])),
        gradient_clip_val=trainer["gradient_clip_val"],
        accumulate_grad_batches=trainer["accumulate_grad_batches"])


def optimizer(name: str, every_k: int, clip) -> Optimizer:
    """AdamW with decay or Adam, lr 1e-3 LinearLR, ``clip`` and ``every_k``."""
    kwargs = {"weight_decay": 0.05} if name == "AdamW" else {"betas": (0.8, 0.99)}
    return build_optimizer(OptimizerCfg(name, 1e-3, kwargs),
                           build_lr_schedule(1e-3, LRSchedulerCfg(
                               "LinearLR", {"start_factor": 0.1, "total_iters": 4})),
                           gradient_clip_val=clip, accumulate_grad_batches=every_k)


# ----------------------------------------------------------------- route rule

def _fake_state(tx, device, grad_dtype=torch.bfloat16, contiguous=True):
    shapes = {"w": (8, 6), "b": (6,), "conv": (4, 3, 3, 3)}
    params = {k: torch.zeros(s, device=device) for k, s in shapes.items()}
    grads = {k: torch.zeros(s, device=device, dtype=grad_dtype) for k, s in shapes.items()}
    if not contiguous:
        grads["w"] = torch.zeros(6, 8, device=device, dtype=grad_dtype).t()
    return params, grads, tx.init(params)


@pytest.mark.parametrize("case,route", [
    ("st3d", "fused"),
    ("st3d_f32_grads", "fused"),
    ("st3d_mu_float32", "fused"),
    ("adam", "fused"),
    ("mu_bfloat16", "foreach"),
    ("nu_dtype", "foreach"),
    ("sgd", "foreach"),
    ("adafactor", "foreach"),
    ("cpu", "foreach"),
    ("non_contiguous_grads", "foreach"),
])
def test_route_rule(case, route):
    """The fused kernels take AdamW / Adam with f32 moments on one CUDA
    device; every other configuration, and the CPU, takes the foreach chain."""
    kwargs = {"st3d_mu_float32": {"mu_dtype": "float32"}, "adam": {"name": "Adam"},
              "mu_bfloat16": {"mu_dtype": "bfloat16"},
              "nu_dtype": {"mu_dtype": "bfloat16", "nu_dtype": "bfloat16"},
              "sgd": {"name": "SGD"}, "adafactor": {"name": "Adafactor"}}.get(case, {})
    tx = st3d_optimizer(**kwargs)
    with FakeTensorMode():
        device = "cpu" if case == "cpu" else "cuda"
        params, grads, state = _fake_state(
            tx, device, torch.float32 if case == "st3d_f32_grads" else torch.bfloat16,
            contiguous=case != "non_contiguous_grads")
        assert (tx.fused_step(params, grads, state) is not None) == (route == "fused")


def test_a_plan_lasts_as_long_as_its_state():
    """The plan built for a state serves every apply on the same tensors, a
    state with another tensor gets a new one, and a plan keeps no tensor
    of its state alive."""
    tx = st3d_optimizer()
    with FakeTensorMode():
        params, grads, state = _fake_state(tx, "cuda")
        plan = tx.fused_step(params, grads, state).plan
        assert tx.fused_step(params, grads, state).plan is plan
        state["mu"]["b"] = torch.zeros(6, device="cuda")
        assert tx.fused_step(params, grads, state).plan is not plan
        lists = ([params[k] for k in params], [state["mu"][k] for k in params],
                 [state["nu"][k] for k in params], [state["acc"][k] for k in params])
        plan = tx.fused_step(params, grads, state).plan
        assert plan.holds(*lists)
        del state["nu"]["w"]
        lists[2].pop(0)
        assert not plan.holds(*lists)


def test_spans_name_the_route(monkeypatch):
    """``optim.accumulate``, ``optim.clip`` and ``optim.update`` carry the
    route as their ``route`` arg: foreach on the CPU."""
    seen = []

    class Recorded(torch.autograd.profiler.record_function):
        def __enter__(self):
            seen.append((self.name, self.args))
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Recorded)
    tx = optimizer("AdamW", 2, 0.1)
    params = {"a": torch.ones(5), "b": torch.ones(3)}
    state = tx.init(params)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            tx.apply(params, {k: torch.full_like(p, 0.5) for k, p in params.items()}, state)
    optim = [(n, json.loads(a)) for n, a in seen if n.startswith("mvldm/optim.")]
    assert [n for n, _ in optim] == ["mvldm/optim.accumulate", "mvldm/optim.accumulate",
                                     "mvldm/optim.clip", "mvldm/optim.update"]
    assert all(a == {"route": "foreach"} for _, a in optim)
    profiling.reset()


# ---------------------------------------------------- arithmetic vs the chain

def grad_steps(sizes, steps: int, dtype, device, clip_case: str, seed: int = 0):
    """Seeded gradients for ``steps`` micro-steps, scaled so the global norm
    crosses a 0.1 clip from step to step; "inf" / "nan" plant one
    non-finite element on the second step (so the norm is non-finite)."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        scale = 0.3 if step % 3 else 0.001
        g = {f"t{i}": torch.from_numpy(rng.standard_normal(n).astype(np.float32) * scale)
             for i, n in enumerate(sizes)}
        if clip_case in ("inf", "nan") and step == 1:
            g["t1"][1] = float(clip_case)
        out.append({k: v.to(device=device, dtype=dtype) for k, v in g.items()})
    return out


CLIP_CASES = {  # clip, norm_fn
    "mixed": (0.1, None),
    "none": (None, None),
    "inf": (0.1, None),
    "nan": (0.1, None),
    "host_norm": (0.1, lambda g: global_norm(list(g.values()))),
    "host_nan": (0.1, lambda g: float("nan")),
}


def reference_apply(tx: Optimizer, params, grads, state, norm_fn=None) -> bool:
    """``Optimizer.apply``'s fused route with the kernels' plain versions."""
    names = list(params)
    acc = [state["acc"][k] for k in names] if tx.every_k > 1 else None
    if acc is not None:
        n = state["mini_step"]
        fused_adamw.accumulate_reference(acc, [grads[k] for k in names], n)
        state["mini_step"] = (n + 1) % tx.every_k
        if n != tx.every_k - 1:
            return False
        grads = state["acc"]
    norm = None
    if tx.clip is not None:
        norm = norm_fn(grads) if norm_fn else global_norm_tensor(list(grads.values()))
    fused_adamw.update_reference(
        [params[k] for k in names], [state["mu"][k] for k in names],
        [state["nu"][k] for k in names], [grads[k] for k in names],
        tx.hyper(state["count"], torch.float32), norm, acc)
    state["count"] += 1
    return True


def snapshot(params, state):
    out = [t.clone() for t in params.values()]
    for key in ("mu", "nu", "acc"):
        out += [t.clone() for t in state.get(key, {}).values()]
    return out


def assert_same_bits(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        nan = a.isnan()
        assert torch.equal(nan, b.isnan()), (what, i)
        assert torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]), (what, i)


@pytest.mark.parametrize("name", ["AdamW", "Adam"])
@pytest.mark.parametrize("clip_case", sorted(CLIP_CASES))
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("every_k", [1, 2])
def test_plain_versions_are_the_foreach_chain_bitwise(every_k, grad_dtype, clip_case, name):
    """3 accumulation cycles on the CPU: the kernels' per-element arithmetic
    (the plain versions) against ``Optimizer.apply``'s foreach chain, bit
    for bit after every micro-step."""
    clip, norm_fn = CLIP_CASES[clip_case]
    steps = grad_steps(SIZES, 3 * every_k, grad_dtype, "cpu", clip_case)
    init = {f"t{i}": torch.from_numpy(np.random.default_rng(9).standard_normal(n)
                                      .astype(np.float32)) for i, n in enumerate(SIZES)}
    runs = []
    for apply in ("chain", "plain"):
        tx = optimizer(name, every_k, clip)
        params = {k: v.clone() for k, v in init.items()}
        state = tx.init(params)
        seen = []
        for grads in steps:
            if apply == "chain":
                assert tx.fused_step(params, grads, state) is None
                tx.apply(params, grads, state, norm_fn=norm_fn)
            else:
                reference_apply(tx, params, grads, state, norm_fn)
            seen.append(snapshot(params, state))
        runs.append(seen)
    for step, (chain, plain) in enumerate(zip(*runs)):
        assert_same_bits(plain, chain, f"micro-step {step}")
    if clip_case in ("inf", "nan", "host_nan"):
        assert any(t.isnan().any() for t in runs[0][-1])


# ------------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _on_card(init, device, misaligned: bool):
    """Masters on the card; with ``misaligned`` each odd tensor a view at
    one element's offset into a larger buffer (contiguous, not 16-byte
    aligned)."""
    out = {}
    for i, (k, v) in enumerate(init.items()):
        if misaligned and i % 2:
            buf = torch.empty(v.numel() + 1, device=device)
            out[k] = buf[1:].view(v.shape)
            out[k].copy_(v)
        else:
            out[k] = v.to(device)
    return out


def _misalign(grads):
    """Each odd gradient a view one element into a larger buffer."""
    out = {}
    for i, (k, g) in enumerate(grads.items()):
        if i % 2:
            buf = torch.empty(g.numel() + 1, device=g.device, dtype=g.dtype)
            out[k] = buf[1:].view(g.shape)
            out[k].copy_(g)
        else:
            out[k] = g
    return out


class ForeachCounter:
    """Counts calls of every ``torch._foreach_*`` op but ``_foreach_norm``
    (the clip's norm, ``global_norm_tensor``'s reduction)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        for attr in dir(torch):
            if attr.startswith("_foreach_") and attr != "_foreach_norm":
                monkeypatch.setattr(torch, attr, self._wrap(getattr(torch, attr)))

    def _wrap(self, fn):
        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        return counted


def run_routes(cuda, monkeypatch, tx_of, sizes, steps, norm_fn=None, misaligned=False):
    """The fused route, the foreach chain (``Optimizer.fused_step`` stubbed off)
    and the plain versions on the card from the same masters and
    gradients; each run's snapshots after every micro-step and the fused
    run's launches a micro-step."""
    init = {f"t{i}": torch.from_numpy(np.random.default_rng(9).standard_normal(n)
                                      .astype(np.float32)) for i, n in enumerate(sizes)}
    runs, launches = [], []
    for route in ("fused", "foreach", "plain"):
        tx = tx_of()
        params = _on_card(init, cuda, misaligned)
        state = tx.init(params)
        seen = []
        with monkeypatch.context() as m:
            if route == "foreach":
                m.setattr(Optimizer, "fused_step", lambda self, *a: None)
            counter = ForeachCounter(m) if route == "fused" else None
            for grads in steps:
                grads = _misalign(grads) if misaligned else grads
                if route != "foreach":
                    assert tx.fused_step(params, grads, state) is not None
                before = (fused_adamw.accumulate.launches, fused_adamw.update.launches)
                if route == "plain":
                    applied = reference_apply(tx, params, grads, state, norm_fn)
                else:
                    applied = tx.apply(params, grads, state, norm_fn=norm_fn)
                if counter is not None:
                    launches.append((fused_adamw.accumulate.launches - before[0],
                                     fused_adamw.update.launches - before[1], applied,
                                     counter.calls))
                    counter.calls = 0
                seen.append(snapshot(params, state))
        torch.cuda.synchronize()
        runs.append(seen)
    return runs, launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AdamW", "Adam"])
@pytest.mark.parametrize("clip_case", sorted(CLIP_CASES))
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("every_k", [1, 2])
def test_fused_route_is_the_foreach_chain_bitwise(cuda, monkeypatch, every_k, grad_dtype,
                                                  clip_case, name):
    """3 accumulation cycles on the card, odd sizes, tensors of several
    chunks, misaligned masters and gradients: the fused route bit for bit
    the foreach chain after every micro-step; one accumulate launch a
    micro-step, one update launch an applying one, no foreach op but the
    norm's."""
    clip, norm_fn = CLIP_CASES[clip_case]
    sizes = SIZES + (3 * fused_adamw.CHUNK + 5, 2 * fused_adamw.CHUNK)
    steps = grad_steps(sizes, 3 * every_k, grad_dtype, cuda, clip_case)
    for misaligned in (False, True):
        runs, launches = run_routes(cuda, monkeypatch, lambda: optimizer(name, every_k, clip),
                                    sizes, steps, norm_fn, misaligned)
        for step, (fused, chain, plain) in enumerate(zip(*runs)):
            assert_same_bits(fused, chain, f"micro-step {step}, misaligned {misaligned}")
            assert_same_bits(plain, chain, f"plain, micro-step {step}, misaligned {misaligned}")
        for acc_n, upd_n, applied, foreach in launches:
            assert acc_n == (1 if every_k > 1 else 0)
            assert upd_n == (1 if applied else 0)
            assert foreach == 0


@pytest.mark.cuda
@pytest.mark.parametrize("every_k", [1, 2])
def test_more_tensors_than_a_launch_holds(cuda, monkeypatch, every_k):
    """Past the kernels' capacity of gradients a launch, a gradient pass
    takes more launches (the update from the accumulators still one), and
    the result is still the chain's."""
    cap = fused_adamw._lib().mvldm_fused_adamw_capacity()
    sizes = tuple(1 + i % 9 for i in range(cap + 3))
    steps = grad_steps(sizes, 2 * every_k, torch.bfloat16, cuda, "mixed")
    runs, launches = run_routes(cuda, monkeypatch, lambda: optimizer("AdamW", every_k, 0.1),
                                sizes, steps)
    for step, (fused, chain, plain) in enumerate(zip(*runs)):
        assert_same_bits(fused, chain, f"micro-step {step}")
        assert_same_bits(plain, chain, f"plain, micro-step {step}")
    for acc_n, upd_n, applied, _ in launches:
        assert acc_n == (2 if every_k > 1 else 0)
        assert upd_n == ((1 if every_k > 1 else 2) if applied else 0)


@pytest.mark.cuda
def test_update_refuses_a_norm_off_the_card(cuda):
    tx = optimizer("AdamW", 1, 0.1)
    params = {"a": torch.ones(5, device=cuda)}
    state = tx.init(params)
    step = tx.fused_step(params, {"a": torch.ones(5, device=cuda)}, state)
    with pytest.raises(TypeError):
        fused_adamw.update(step, tx.hyper(0, torch.float32), torch.tensor(1.0))
