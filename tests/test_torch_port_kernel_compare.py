"""The one-call kernel comparison tool (``mvldm_tpu_torch.tools.kernel_compare``)
and the channel gate of the LN-prologue kernels, on the CPU: the tool's
shapes and its refusal without a card. Its timings come only from the card."""

import pytest
import torch

from mvldm_tpu_torch.ops import fused_attn
from mvldm_tpu_torch.tools import bench_attn_micro as micro
from mvldm_tpu_torch.tools import kernel_compare, measure


@pytest.mark.parametrize("kernel", ["bwd", "fwd", "gemm", "micro", "f32bwd", "f32fwd", "f32gemm",
                                    "exp"])
def test_compare_tool_needs_a_card(capsys, kernel):
    """Every --kernel exits non-zero, with no result line, without a card."""
    assert kernel_compare.main(["--other", ".", "--kernel", kernel]) == 2
    assert capsys.readouterr().out == ""


def test_compare_tool_refuses_an_unknown_kernel():
    with pytest.raises(SystemExit):
        kernel_compare.main(["--other", ".", "--kernel", "conv"])


def test_fwd_shapes_cover_sampling_and_training():
    """The forward comparison covers every sampling shape without the lse
    and every training shape's forward with it."""
    shapes = kernel_compare.fwd_shapes()
    assert len({s[0] for s in shapes}) == len(shapes)
    n_sampling = len(kernel_compare.SAMPLING_SHAPES)
    assert [s[1:6] for s in shapes[:n_sampling]] == [
        tuple(s[1:]) for s in kernel_compare.SAMPLING_SHAPES]
    assert [s[1:6] for s in shapes[n_sampling:]] == [
        tuple(s[1:]) for s in kernel_compare.TRAIN_SHAPES]
    assert not any(s[6] for s in shapes[:n_sampling])
    assert all(s[6] for s in shapes[n_sampling:])
    assert {s[4] for s in shapes} == {40, 64, 80, 160, 512}


def test_f32gemm_builds_the_f32_route_and_the_probe():
    """``--kernel f32gemm`` builds both sources of f32 GEMM launches (the
    fused blocks' in f32_route.cu, the probe's f32 route in
    micro_matmul.cu), and another checkout's build declares the forward's
    route entries only where it has them."""
    assert kernel_compare.SOURCES["f32gemm"] == ("f32_route", "micro_matmul")
    assert "mvldm_f32_gemm" in kernel_compare.other_signatures("f32_route")
    assert set(kernel_compare.OPTIONAL_ENTRIES["f32_route"]).isdisjoint(
        kernel_compare.other_signatures("f32_route"))
    assert set(kernel_compare.OPTIONAL_ENTRIES["f32_route"]) <= set(
        kernel_compare.SIGNATURES["f32_route"])


# ptxas's report of a build with the split-TF32 tile and one of the FFMA
# bodies it replaced (the other build of a comparison), and a bf16 kernel.
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN8f32_gemm12_GLOBAL__N_111gemm_tf32x3ILi1EEEvNS0_4ArgsE' for 'sm_90a'
ptxas info    : Used 250 registers, used 1 barriers, 0 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_18gemm_f32EPKfS1_S1_S1_Pfiiiiiii' for 'sm_90a'
    48 bytes stack frame, 40 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8192 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113attn_rows_f32EPfS0_iiixx' for 'sm_90a'
ptxas info    : Used 32 registers
"""


def test_gemm_instances_reads_the_f32_gemm_kernels():
    """The f32gemm lines carry each build's f32 GEMM instances from its nvcc
    log: the split-TF32 tile's and the FFMA bodies', nothing else."""
    got = kernel_compare.gemm_instances(PTXAS_LOG)
    assert [r["kernel"] for r in got] == ["gemm_tf32x3<1>", "gemm_f32"]
    assert got[0]["registers"] == 250 and got[0]["spill_stores"] == 0
    assert (got[1]["spill_stores"], got[1]["spill_loads"], got[1]["static_smem"]) == (40, 60, 8192)
    assert kernel_compare.gemm_instances(None) == []


def test_gemm_shapes_are_the_fused_blocks_and_the_probe():
    """The GEMM comparison runs the fused blocks at their main-path shapes
    (C within the kernels' gate, head dims multiples of 8) and the matmul
    probe's two bf16 cases."""
    for _, n, l, c, heads, d in kernel_compare.ATTN_BLOCK_SHAPES:
        assert c <= fused_attn.MAX_KERNEL_CHANNELS and d % 8 == 0 and n == 10
        assert heads * d == c
    for _, n, l, c in kernel_compare.FF_BLOCK_SHAPES:
        assert c <= fused_attn.MAX_KERNEL_CHANNELS and n == 10
    assert kernel_compare.MATMUL_SHAPES == [(4096, 1024), (8192, 512)]
    assert set(kernel_compare.SOURCES["gemm"]) == {"fused_ln_attn", "fused_ln_geglu_ff",
                                                    "micro_matmul"}


def test_t2mv_shapes_are_mvdreams_step():
    """MVDream's shapes (4 prompts with batched CFG: 8 rows of 4 views at
    32x32 latents, heads of 64): the text attention onto 77 keys at each of
    the four levels and the C = 1280 joint attentions on the flash forward,
    the C = 320 and 640 joint sequences on the fused blocks (within their
    gate); the forward comparison runs the flash shapes after the others."""
    flash = kernel_compare.T2MV_FLASH_SHAPES
    assert sorted(lq for _, _, _, lq, lk, _ in flash if lk == 77) == [64, 256, 1024, 4096]
    assert sorted(lq for _, _, _, lq, lk, _ in flash if lk == lq) == [64, 256]
    assert {(b, d) for _, b, _, _, _, d in flash} == {(8, 64)}
    assert [(l, c, h * d) for _, n, l, c, h, d in kernel_compare.T2MV_ATTN_BLOCK_SHAPES] == [
        (4096, 320, 320), (1024, 640, 640)]
    for _, n, l, c in kernel_compare.T2MV_FF_BLOCK_SHAPES:
        assert n == 8 and c <= fused_attn.MAX_KERNEL_CHANNELS
    cases = kernel_compare.fwd_cases()
    assert len({c[0] for c in cases}) == len(cases)
    assert [c[:6] for c in cases if c[0].startswith("MVDream")] == flash


@pytest.mark.parametrize("c,ok", [(8, True), (320, True), (640, True), (644, False),
                                  (648, False), (1280, False)])
def test_kernel_channel_gate(c, ok):
    """The LN-prologue kernels keep 128 rows of LN(x) resident: C % 8 == 0
    and C <= 640, the JAX package's fused-block gate in bf16."""
    if ok:
        fused_attn.check_kernel_channels(c, "t")
    else:
        with pytest.raises(ValueError, match="C <= 640"):
            fused_attn.check_kernel_channels(c, "t")
    assert fused_attn.use_fused(c, torch.bfloat16) == (c <= 640)


def test_in_turns_order(monkeypatch):
    """Two builds are timed this, other, other, this in every round."""
    order = []
    monkeypatch.setattr(kernel_compare.measure, "time_ms",
                        lambda fn, iters=None: fn() or float(len(order)))
    times = kernel_compare.in_turns({"this": lambda: order.append("this"),
                                     "other": lambda: order.append("other")}, 2, None)
    assert order == ["this", "other", "other", "this"] * 2
    assert [len(t) for t in times.values()] == [4, 4]


def test_micro_cases_are_the_tool_sections_f32_flash_and_fullk():
    """The micro comparison runs every f32-dot flash case and every
    distinct fullk case of the TPU tool's flash, fullk and floor sections
    (the floor once, at the joint shape), each once, on micro_attn.cu."""
    def norm(probe, kw):  # the case's keyword arguments with their defaults filled
        kw = {k: v for k, v in kw.items() if v is not None}
        return (probe, dict(kw, do_max=kw.get("do_max", True)) if probe == "fullk" else kw)

    cases = [norm(probe, kw) for _, probe, kw in kernel_compare.MICRO_CASES]
    assert len({label for label, _, _ in kernel_compare.MICRO_CASES}) == len(cases)
    plan = [norm(probe, kw) for section in ("flash", "fullk", "floor")
            for probe, kw, _ in micro.PLAN[section][1]]
    flash_f32 = [c for c in plan if c[0] == "flash" and c[1]["dot_dtype"] == torch.float32]
    fullk = [c for c in plan if c[0] == "fullk" and c[1]["do_max"] != "none"]
    for c in flash_f32 + fullk:
        assert c in cases
    assert all(c in plan for c in cases)
    assert ("fullk", dict(b=16, h=8, l=5120, d=40, do_max="none")) in cases
    assert len(cases) == 9 and kernel_compare.SOURCES["micro"] == ("micro_attn",)


def test_f32bwd_shapes_are_the_training_shapes():
    """The f32 backward comparison runs every attention of a training step,
    which the f32 UNet runs through the f32 route, on f32_route.cu."""
    assert kernel_compare.F32_BWD_SHAPES == kernel_compare.TRAIN_SHAPES
    assert kernel_compare.SOURCES["f32bwd"] == ("f32_route",)
    assert set(kernel_compare.SIGNATURES["f32_route"]) >= {"mvldm_f32_flash_bwd_dq",
                                                            "mvldm_f32_flash_bwd_dkv"}
    # another checkout's f32_route.cu is declared with the entries the
    # comparisons call (an older one has no shared-memory queries; the f32
    # GEMM comparison calls its mvldm_f32_gemm)
    assert set(kernel_compare.other_signatures("f32_route")) == {
        "mvldm_f32_flash_fwd", "mvldm_f32_flash_bwd_dq", "mvldm_f32_flash_bwd_dkv",
        "mvldm_f32_gemm"}
    assert kernel_compare.other_signatures("flash_attn_bwd") == kernel_compare.SIGNATURES[
        "flash_attn_bwd"]


def test_f32_bwd_bounds_at_the_joint_shape():
    """At the joint 32x32 shape (B=2, H=8, L=5120, D=40) the five products
    take 1.678e11 flop: three TF32 products each at 494.7 TFLOP/s is
    1.017 ms, FFMA at 67 TFLOP/s 2.504 ms; both above the bytes."""
    b, h, l, d = 2, 8, 5120, 40
    moved = 4 * (b * h * l * d * 8 + b * h * l + 2 * b * l)
    got = measure.f32_bwd_bounds(b, h, l, l, d, moved)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(1.0174, abs=1e-4)
    assert got["ffma_bound_ms"] == pytest.approx(2.5041, abs=1e-4)
    assert measure.PEAK_TF32_FLOPS == 494.7e12


@pytest.mark.parametrize("b,h,l,d", [(2, 8, 1280, 80), (2, 8, 320, 160), (10, 5, 16, 64)])
def test_f32_bwd_bounds_scale_with_the_work(b, h, l, d):
    """The 3xTF32 bound is the FFMA bound times 3 x 67 / 494.7 where the
    products bound both, and the bytes where they outweigh them."""
    moved = 4 * (b * h * l * d * 8 + b * h * l + 2 * b * l)
    got = measure.f32_bwd_bounds(b, h, l, l, d, moved)
    bytes_ms = moved / measure.PEAK_BYTES * 1e3
    ops_ms = 30.0 * b * h * l * l * d / measure.PEAK_TF32_FLOPS * 1e3
    assert got["bound_ms"] == pytest.approx(max(ops_ms, bytes_ms))
    assert got["bound_by"] == ("operations" if ops_ms >= bytes_ms else "bytes")
    assert got["ffma_bound_ms"] >= got["bound_ms"]


def test_f32fwd_runs_the_forward_shapes():
    """The f32 forward comparison builds f32_route.cu and runs every forward
    shape of sampling and training (the fill and the D = 512 VAE among
    them), each timed with the lse where training writes it."""
    assert kernel_compare.SOURCES["f32fwd"] == ("f32_route",)
    assert set(kernel_compare.SIGNATURES["f32_route"]) >= {"mvldm_f32_flash_fwd",
                                                            "mvldm_f32_flash_fwd_smem"}
    shapes = kernel_compare.fwd_shapes()
    assert any("fill" in s[0] for s in shapes) and any(s[4] == 512 for s in shapes)
    assert {s[4] for s in shapes} == {40, 64, 80, 160, 512}
    assert len(shapes) == len(kernel_compare.SAMPLING_SHAPES) + len(kernel_compare.TRAIN_SHAPES)


def test_exp_compare_shapes():
    """The exp comparison runs the probe's 1024 x 1024 tile and one past the
    50 MB L2, on micro_exp.cu."""
    assert kernel_compare.SOURCES["exp"] == ("micro_exp",)
    assert (1024, 1024) in kernel_compare.EXP_SHAPES
    assert max(8 * a * b for a, b in kernel_compare.EXP_SHAPES) > 50e6


def test_f32_fwd_bounds_at_the_joint_shape():
    """At the joint 32x32 shape (B=2, H=8, L=5120, D=40) S = Q K^T and O = P
    V take 6.711e10 flop: three TF32 products each at 494.7 TFLOP/s is
    0.407 ms, FFMA at 67 TFLOP/s 1.0016 ms; both above the bytes."""
    b, h, l, d = 2, 8, 5120, 40
    moved = 4 * (b * h * l * d * 4 + b * l)
    got = measure.f32_fwd_bounds(b, h, l, l, d, moved)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(0.4070, abs=1e-4)
    assert got["ffma_bound_ms"] == pytest.approx(1.0016, abs=1e-4)


@pytest.mark.parametrize("b,h,lq,lk,d", [(2, 8, 1280, 1280, 80), (12, 1, 1024, 1024, 512),
                                         (20, 20, 16, 16, 64), (1, 2, 100, 300, 160)])
def test_f32_fwd_bounds_scale_with_the_work(b, h, lq, lk, d):
    """The forward's 3xTF32 bound is its two products three times over at
    the TF32 rate where they outweigh the bytes, the bytes elsewhere; the
    FFMA bound is never below it, and the backward's five products bound
    above the forward's two."""
    moved = 4 * (b * h * (2 * lq + 2 * lk) * d + b * lk)
    got = measure.f32_fwd_bounds(b, h, lq, lk, d, moved)
    bytes_ms = moved / measure.PEAK_BYTES * 1e3
    ops_ms = 12.0 * b * h * lq * lk * d / measure.PEAK_TF32_FLOPS * 1e3
    assert got["bound_ms"] == pytest.approx(max(ops_ms, bytes_ms))
    assert got["bound_by"] == ("operations" if ops_ms >= bytes_ms else "bytes")
    assert got["ffma_bound_ms"] >= got["bound_ms"]
    assert measure.f32_bwd_bounds(b, h, lq, lk, d, moved)["bound_ms"] >= got["bound_ms"]


@pytest.mark.parametrize("names,backend", [
    (["fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel"],
     "efficient"),
    (["flash_fwd_kernel<Flash_fwd_kernel_traits"], "flash"),
    (["ampere_sgemm_128x64_nn", "softmax_warp_forward"], "math"),
    ([], "not recorded"),
])
def test_sdpa_backend_names(monkeypatch, names, backend):
    """SDPA's backend is named from the device kernels a call ran; a profile
    that recorded none names no backend."""
    monkeypatch.setattr(measure, "device_kernels", lambda fn: names)
    assert measure.sdpa_backend(lambda: None)["backend"] == backend
