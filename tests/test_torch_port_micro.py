"""The attention microbenchmark's plain versions against the TPU tool.

``tools/bench_attn_micro.py`` is loaded by path, unedited, and its ``fullk``
and ``flash`` run under Pallas's TPU interpret mode on the CPU. Its matmul
and exp probes return rates, not outputs, so their kernel bodies are
computed here with ``lax.dot_general`` and ``jnp.exp``.

Inputs are numpy-seeded and lie on a grid of eighths in [-2, 2], exact in
bf16. Every partial sum of q k^T is then exact in f32 in any order, so both
sides round the same f32 values to bf16 inside the function (p, or s in
the floor mode) and differ only in the f32 order of the sums rounded once,
at the output. Tolerance: one bf16 step of the output,
|a - b| <= 2^-7 max(|a|, |b|) + 1e-6. (With arbitrary bf16 inputs a score
now and then differs in its last f32 bit, which flips a bf16(p) and moves
an output near zero by more than a step.)

The TPU tool's output is defined only where L is a multiple of its blocks
(L = 256, blocks of 128). At L = 160 its rows past the last whole block are
never written, and ``flash`` also drops the keys there; the port computes
the whole attention at every L, which the ragged cases show.
"""

import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from mvldm_tpu_torch.tools import bench_attn_micro as micro

REPO = Path(__file__).resolve().parent.parent
L, BLOCK = 256, 128


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "tpu_bench_attn_micro", REPO / "tools" / "bench_attn_micro.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid_qkv(l, d, seed, pad_to=None):
    rng = np.random.default_rng(seed)
    out = [(rng.integers(-16, 17, (1, 2, l, d)) / 8).astype(np.float32) for _ in range(3)]
    if pad_to:
        out = [np.pad(x, ((0, 0), (0, 0), (0, 0), (0, pad_to - d))) for x in out]
    return out


def _jax(xs):
    return [jnp.asarray(x, jnp.bfloat16) for x in xs]


def _torch(xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_within_bf16_step(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    tol = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)) + 1e-6
    bad = ~(np.abs(a - b) <= tol)
    assert not bad.any(), f"{bad.sum()} of {bad.size} outside, worst {np.abs(a - b).max()}"


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("do_max", [True, False, "none"])
def test_fullk_vs_tool(tool, d, do_max):
    x = _grid_qkv(L, d, seed=d)
    scale = 1.0 / math.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        want = tool.fullk(*_jax(x), scale=scale, bq=BLOCK, do_max=do_max)
    got = micro.fullk_reference(*_torch(x), scale, do_max)
    assert got.dtype == torch.bfloat16
    assert_within_bf16_step(want, got)


# (d, pad_to, TPU dot dtype, TPU key block): f32 dots against the one-pass
# plain version the card uses; bf16 dots against the online rescale over the
# TPU's key blocks (it rounds p against the running max), and once over a
# single key block against the one pass.
FLASH_CASES = [(d, pad, dot, BLOCK) for d, pad in ((40, None), (80, None), (160, None),
                                                  (40, 128))
               for dot in ("float32", "bfloat16")] + [(40, None, "bfloat16", L)]


@pytest.mark.parametrize("d,pad_to,dot,bk", FLASH_CASES)
def test_flash_vs_tool(tool, d, pad_to, dot, bk):
    x = _grid_qkv(L, d, seed=d + 1, pad_to=pad_to)
    scale = 1.0 / math.sqrt(d)  # of the unpadded d, as the tool's probe
    with pltpu.force_tpu_interpret_mode():
        want = tool.flash(*_jax(x), scale=scale, bq=BLOCK, bk=bk,
                          dot_dtype=getattr(jnp, dot))
    block_k = bk if dot == "bfloat16" and bk < L else None
    got = micro.flash_reference(*_torch(x), scale, getattr(torch, dot), block_k=block_k)
    assert got.dtype == torch.bfloat16 and got.shape[-1] == (pad_to or d)
    assert_within_bf16_step(want, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_reference_vs_kernel_body(dtype):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((96, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    ja, jb = (jnp.asarray(x, getattr(jnp, dtype)) for x in (a, b))
    want = lax.dot_general(ja, jb, (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.float32).astype(ja.dtype)
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    got = micro.matmul_reference(ta, tb)
    assert got.dtype == ta.dtype
    if dtype == "float32":
        rel = np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(_np(want))
        assert rel <= 1e-6, rel
    else:
        assert_within_bf16_step(want, got)


def test_exp_reference_vs_kernel_body():
    x = np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    got = micro.exp_reference(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - want) / want) <= 1e-6


def _jnp_full_attention(q, k, v, scale, variant):
    """Softmax attention over every key in jnp, rounding as ``variant``."""
    f32, bf16 = jnp.float32, jnp.bfloat16
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(f32), k.astype(f32))
    if variant == "fullk none":
        pv = jnp.einsum("bhqk,bhkd->bhqd", s.astype(bf16).astype(f32), v.astype(f32))
        return (pv * scale).astype(bf16)
    if variant == "fullk nomax":
        p = jnp.exp(s * scale)
    else:
        p = jnp.exp((s - s.max(-1, keepdims=True)) * scale)
    pr = p if variant == "flash float32" else p.astype(bf16).astype(f32)
    l = (pr if variant.startswith("flash") else p).sum(-1, keepdims=True)
    return (jnp.einsum("bhqk,bhkd->bhqd", pr, v.astype(f32)) / l).astype(bf16)


@pytest.mark.parametrize("variant", ["flash float32", "flash bfloat16", "fullk max",
                                     "fullk nomax", "fullk none"])
def test_ragged_length_covers_every_row(variant):
    x = _grid_qkv(160, 40, seed=5)
    scale = 1.0 / math.sqrt(40)
    kind, mode = variant.split()
    if kind == "flash":
        got = micro.flash_reference(*_torch(x), scale, getattr(torch, mode))
    else:
        got = micro.fullk_reference(*_torch(x), scale,
                                    {"max": True, "nomax": False, "none": "none"}[mode])
    assert got.shape == (1, 2, 160, 40) and torch.isfinite(got).all()
    assert_within_bf16_step(_jnp_full_attention(*_jax(x), scale, variant), got)


def test_tpu_tool_leaves_ragged_rows_unwritten(tool):
    """The defect the port does not copy: at L = 160 with blocks of 128 the
    TPU grids cover 128 rows, and flash also only 128 keys."""
    x = _grid_qkv(160, 40, seed=5)
    scale = 1.0 / math.sqrt(40)
    with pltpu.force_tpu_interpret_mode():
        fl = _np(tool.flash(*_jax(x), scale=scale, bq=BLOCK, bk=BLOCK))
        fk = _np(tool.fullk(*_jax(x), scale=scale, bq=BLOCK))
    want = _np(micro.flash_reference(*_torch(x), scale))
    assert np.isnan(fl[:, :, BLOCK:]).all() and np.isnan(fk[:, :, BLOCK:]).all()
    assert np.abs(fl[:, :, :BLOCK] - want[:, :, :BLOCK]).max() > 0.1


@pytest.mark.parametrize("args,rc", [([], 1), (["flash"], 1), (["bogus"], 2)])
def test_cli_without_a_card_exits_nonzero(args, rc):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "mvldm_tpu_torch.tools.bench_attn_micro",
                          *args], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == rc, out.stderr
    assert "TF/s" not in out.stdout and "ms" not in out.stdout


def _cpu_pair(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("call", [
    lambda: micro.matmul(*_cpu_pair((16, 16))),
    lambda: micro.fullk(*_cpu_pair((1, 1, 16, 40)), _cpu_pair((1, 1, 16, 40))[0], 0.1),
    lambda: micro.flash(*_cpu_pair((1, 1, 16, 40)), _cpu_pair((1, 1, 16, 40))[0], 0.1),
    lambda: micro.exp(torch.zeros(16)),
], ids=["matmul", "fullk", "flash", "exp"])
def test_wrappers_refuse_cpu_tensors(call):
    before = [fn.launches for fn in micro.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert [fn.launches for fn in micro.KERNELS] == before


@pytest.mark.parametrize("probe,kwargs", [
    ("matmul", dict(m=64, k=64, dtype=torch.float32)),
    ("fullk", dict(b=1, h=1, l=64, d=40, bq=64)),
    ("flash", dict(b=1, h=1, l=64, d=40, dot_dtype=torch.bfloat16)),
    ("exp", dict(l=64)),
])
def test_probes_refuse_a_cpu_device(probe, kwargs):
    with pytest.raises(ValueError, match="CUDA"):
        micro.PROBES[probe](**kwargs, device="cpu")


# (case, kwargs, bound ms, bound_by): the bounds at the tool's shapes, from
# 989 TFLOP/s bf16 (three products for the f32-dot flash, P V on both
# halves of p; the function's two otherwise, fullk with the max too), the
# f32 matmul's three TF32 products at 494.7 TFLOP/s (its split-TF32 route),
# and 3.35 TB/s.
BOUNDS = [
    ("matmul", dict(m=4096, k=1024, dtype=torch.bfloat16), 8.684e-3, "operations"),
    ("matmul", dict(m=8192, k=512, dtype=torch.bfloat16), 5.164e-3, "bytes"),
    ("matmul", dict(m=4096, k=1024, dtype=torch.float32), 0.05209, "operations"),
    ("matmul", dict(m=8192, k=512, dtype=torch.float32), 0.02605, "operations"),
    ("flash", dict(b=16, h=8, l=5120, d=40, dot_dtype=torch.bfloat16), 0.5428, "operations"),
    ("flash", dict(b=16, h=8, l=5120, d=40, dot_dtype=torch.float32), 0.8142, "operations"),
    ("flash", dict(b=16, h=8, l=5120, d=40, dot_dtype=torch.bfloat16, pad_to=128), 1.7371,
     "operations"),
    ("flash", dict(b=16, h=8, l=1280, d=80, dot_dtype=torch.bfloat16), 0.06785, "operations"),
    ("flash", dict(b=16, h=8, l=320, d=160, dot_dtype=torch.bfloat16), 0.01565, "bytes"),
    ("fullk", dict(b=80, h=8, l=1024, d=40), 0.1085, "operations"),
    ("flash", dict(b=80, h=8, l=1024, d=40, dot_dtype=torch.bfloat16, pad_to=128), 0.3474,
     "operations"),
    ("exp", dict(l=1024), 2.504e-3, "bytes"),
]


@pytest.mark.parametrize("name,kwargs,bound_ms,bound_by", BOUNDS)
def test_bounds_at_the_tool_shapes(name, kwargs, bound_ms, bound_by):
    from mvldm_tpu_torch.tools import measure

    if name == "matmul":
        w = micro.matmul_work(**kwargs)
    elif name == "exp":
        w = micro.exp_work(**kwargs)
    elif name == "flash":
        d = kwargs["d"]
        dp = max(d, kwargs.get("pad_to") or d)
        w = micro.flash_work(kwargs["b"], kwargs["h"], kwargs["l"], d, dp, kwargs["dot_dtype"])
        assert w.peak == measure.PEAK_BF16_FLOPS
    else:
        w = micro.fullk_work(kwargs["b"], kwargs["h"], kwargs["l"], kwargs["d"],
                             kwargs.get("do_max", True))
    got_ms, got_by = measure.bound(w.flops, w.bytes, w.peak)
    assert got_by == bound_by
    assert got_ms == pytest.approx(bound_ms, rel=1e-3)


@pytest.mark.parametrize("name,kwargs,shape", [
    ("matmul", dict(m=32, k=16, dtype=torch.bfloat16), (32, 16)),
    ("fullk", dict(b=1, h=2, l=48, d=40, do_max="none"), (1, 2, 48, 40)),
    ("flash", dict(b=1, h=2, l=48, d=40, dot_dtype=torch.float32, pad_to=128),
     (1, 2, 48, 128)),
    ("exp", dict(l=16), (16, 16)),
])
def test_cases_build_and_run_plain_on_cpu(name, kwargs, shape):
    case = micro.CASES[name](**kwargs, device="cpu")
    out = case.plain(*case.inputs)
    assert out.shape == shape and out.dtype == case.inputs[0].dtype
    assert torch.isfinite(out).all()
    w = case.work
    assert w.bytes == sum(t.numel() * t.element_size() for t in case.inputs) + \
        out.numel() * out.element_size()


@pytest.mark.parametrize("name,kwargs", [
    ("fullk", dict(do_max=True)),
    ("fullk", dict(do_max=False)),
    ("flash", dict(dot_dtype=torch.bfloat16)),
    ("flash", dict(dot_dtype=torch.float32, pad_to=128)),
])
def test_library_yardstick_computes_the_probe_function(name, kwargs):
    """SDPA stands beside every softmax mode (with the max or without it,
    the same function up to rounding), within one bf16 step plus the
    rounding of p; the matmul floor has no library counterpart."""
    case = micro.CASES[name](b=1, h=2, l=96, d=40, **kwargs, device="cpu")
    want = case.plain(*(t.float() for t in case.inputs))
    got = case.library(*case.inputs).float()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 2 ** -6 * want.abs().max().item()
    assert micro.fullk_case(1, 2, 96, 40, "none", device="cpu").library is None


@pytest.mark.parametrize("name,kwargs", [
    ("fullk", dict(do_max=True)),
    ("flash", dict(dot_dtype=torch.bfloat16, pad_to=128)),
    ("matmul", None),
])
def test_chip_smoke_plain_by_rows_is_the_plain_version(name, kwargs):
    """The card check computes an attention probe's plain version two batch
    rows at a time; over an odd batch it equals one call exactly."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    if kwargs is None:
        case = micro.CASES[name](m=40, k=24, dtype=torch.bfloat16, device="cpu")
    else:
        case = micro.CASES[name](b=5, h=2, l=48, d=40, **kwargs, device="cpu")
    torch.testing.assert_close(chip_smoke._plain_by_rows(case.plain, *case.inputs),
                               case.plain(*case.inputs), atol=0, rtol=0)


def test_plan_runs_the_tool_sections():
    assert tuple(micro.PLAN) == micro.SECTIONS
    assert set(micro.DEFAULT_SECTIONS) == {"matmul", "exp", "flash", "fullk"}
    counts = {s: len(calls) for s, (_, calls) in micro.PLAN.items()}
    assert counts == {"matmul": 4, "exp": 1, "flash": 11, "fullk": 6, "floor": 4}
    for _, calls in micro.PLAN.values():
        for probe, case_kw, _ in calls:
            assert probe in micro.CASES and probe in micro.PROBES
            assert set(case_kw) <= set(micro.CASES[probe].__code__.co_varnames)


# (work, bound ms, route's bound ms, n_exp) at the tool's (16, 8, 5120, 40),
# at 989 TFLOP/s: the f32-dot flash needs three bf16 products (S, and P V on
# the hi and lo halves of p); fullk needs the function's two in every mode,
# and with the max its route runs a third (two passes: S; S and P V),
# reported apart; the exponentials of every softmax mode.
ROUTE_BOUNDS = [
    (lambda: micro.flash_work(16, 8, 5120, 40, 40, torch.float32), 0.8142, None,
     16 * 8 * 5120 ** 2),
    (lambda: micro.flash_work(16, 8, 5120, 40, 40, torch.bfloat16), 0.5428, None,
     16 * 8 * 5120 ** 2),
    (lambda: micro.fullk_work(16, 8, 5120, 40, True), 0.5428, 0.8142, 16 * 8 * 5120 ** 2),
    (lambda: micro.fullk_work(16, 8, 5120, 40, False), 0.5428, None, 16 * 8 * 5120 ** 2),
    (lambda: micro.fullk_work(16, 8, 5120, 40, "none"), 0.5428, None, 0),
]


@pytest.mark.parametrize("work,bound_ms,route_bound_ms,n_exp", ROUTE_BOUNDS)
def test_route_bounds_at_the_tool_shape(work, bound_ms, route_bound_ms, n_exp):
    from mvldm_tpu_torch.tools import measure

    w = work()
    rec = micro.bounds(w, 1980.0, 132)
    assert rec["bound_by"] == "operations" and w.peak == measure.PEAK_BF16_FLOPS
    assert rec["bound_ms"] == pytest.approx(bound_ms, rel=1e-3)
    if route_bound_ms is None:
        assert "route_bound_ms" not in rec
    else:
        assert rec["route_bound_ms"] == pytest.approx(route_bound_ms, rel=1e-3)
    assert w.useful_flops == 4.0 * 16 * 8 * 5120 ** 2 * 40
    assert rec["n_exp"] == n_exp
    # 16 exp2 a clock on each of 132 SMs at 1980 MHz: 0.8025 ms for 3.36e9.
    assert rec["exp_floor_ms"] == pytest.approx(n_exp / (16 * 132 * 1980e6) * 1e3)


def test_micro_records_carry_the_route_bound_and_exp_floor():
    """At one small shape: the f32-dot flash case's bound is its route's
    (three bf16 products) and its exp floor counts b h L^2 exp2; fullk with
    the max is held to the function's two products, with its route's three
    beside them; fullk's matmul floor needs no exp; the matmul and exp
    probes have no exp floor."""
    case = micro.flash_case(1, 2, 48, 40, torch.float32, device="cpu")
    rec = micro.bounds(case.work, 1500.0, 100)
    flops, moved = 6.0 * 2 * 48 * 48 * 40, 8 * 2 * 48 * 40
    assert case.work.flops == flops and case.work.bytes == moved
    assert rec["bound_ms"] == pytest.approx(max(flops / 989e12, moved / 3.35e12) * 1e3)
    assert "hi + lo" in rec["route"]
    assert rec["exp_floor_ms"] == pytest.approx(2 * 48 * 48 / (16 * 100 * 1500e6) * 1e3)
    two = micro.bounds(micro.fullk_case(1, 2, 48, 40, True, device="cpu").work, 1500.0, 100)
    assert two["bound_ms"] == pytest.approx(max(flops / 1.5 / 989e12, moved / 3.35e12) * 1e3)
    assert two["route_bound_ms"] == pytest.approx(rec["bound_ms"])
    assert "route_bound_ms" not in rec
    none = micro.bounds(micro.fullk_case(1, 2, 48, 40, "none", device="cpu").work, 1500.0, 100)
    assert none["exp_floor_ms"] == 0.0
    for work in (micro.matmul_work(64, 64, torch.bfloat16), micro.exp_work(64)):
        assert "exp_floor_ms" not in micro.bounds(work)


def test_f32_library_is_the_f32_dot_function():
    """The f32-dot flash's second yardstick, SDPA on f32 copies made with the
    case, computes its plain version's function (within one bf16 step of
    the plain version's bf16 output); the bf16-dot case has none."""
    case = micro.flash_case(1, 2, 96, 40, torch.float32, device="cpu")
    want = case.plain(*(t.float() for t in case.inputs))
    got = case.library_f32()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 2 ** -7 * want.abs().max().item()
    assert micro.flash_case(1, 2, 96, 40, torch.bfloat16, device="cpu").library_f32 is None


@pytest.mark.parametrize("l", [96, 320])
def test_f32_flash_limit_tells_split_p_from_bf16_p(l):
    """The f32-dot flash case carries F32_FLASH_REL_LIMIT (the bf16-dot case
    none), and the limit tells the precision apart: the plain version's
    exact output rounded to bf16 is within it, the plain version with p
    rounded to bf16 (what a body without the lo half of p would compute)
    is past it."""
    from mvldm_tpu_torch.tools.measure import error_record

    case = micro.flash_case(1, 2, l, 40, torch.float32, device="cpu")
    assert case.rel_limit == micro.F32_FLASH_REL_LIMIT == 1e-3
    assert micro.flash_case(1, 2, l, 40, torch.bfloat16, device="cpu").rel_limit is None
    q, k, v = (t.float() for t in case.inputs)
    scale = 1.0 / math.sqrt(40)
    want = micro.flash_reference(q, k, v, scale, torch.float32)
    bf16_p = micro.flash_reference(q, k, v, scale, torch.bfloat16)
    assert error_record(want.to(torch.bfloat16), want)["err_over_rms"] <= case.rel_limit
    assert error_record(bf16_p.to(torch.bfloat16), want)["err_over_rms"] > 4 * case.rel_limit
