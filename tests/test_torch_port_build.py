"""The kernel build's reports, on the CPU: kernel names from mangled
entries and ptxas's registers and spills from an ``nvcc -Xptxas=-v`` log.
The builds themselves, and the SASS they read, happen only on the card."""

import pytest

from mvldm_tpu_torch.ops import _build

LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__eeb25706_12_f32_route_cu_24bc386b17flash_bwd_dkv_f32ILi160EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__eeb25706_12_f32_route_cu_24bc386b17flash_bwd_dkv_f32ILi160EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_iiiif
    56 bytes stack frame, 56 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compile time = 192.618 ms
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__eeb25706_12_f32_route_cu_24bc386b8gemm_f32EPKfS1_S1_S1_Pfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__eeb25706_12_f32_route_cu_24bc386b8gemm_f32EPKfS1_S1_S1_Pfiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 16384 bytes smem
"""


def test_ptxas_report_reads_each_entry():
    assert _build.ptxas_report(LOG) == [
        dict(kernel="flash_bwd_dkv_f32<160>", registers=255, spill_stores=56, spill_loads=60,
             static_smem=0),
        dict(kernel="gemm_f32", registers=127, spill_stores=0, spill_loads=0,
             static_smem=16384),
    ]


@pytest.mark.parametrize("mangled,name", [
    ("_ZN45_GLOBAL__N__eeb25706_12_f32_route_cu_24bc386b16flash_bwd_dq_f32ILi40EEEvPKfS2_",
     "flash_bwd_dq_f32<40>"),
    ("_ZN45_GLOBAL__N__eeb25706_12_f32_route_cu_24bc386b9geglu_f32EPKfPfxi", "geglu_f32"),
    ("mvldm_f32_gemm", "mvldm_f32_gemm"),
    ("_ZN8f32_gemm45_GLOBAL__N__eeb25706_12_f32_route_cu_24bc386b11gemm_tf32x3ILi1EEEvNS0_4ArgsE",
     "gemm_tf32x3<1>"),
])
def test_kernel_name(mangled, name):
    assert _build.kernel_name(mangled) == name


def test_ptxas_report_of_an_empty_log():
    assert _build.ptxas_report("") == []


def test_build_log_is_kept_beside_the_library(tmp_path, monkeypatch):
    """nvcc's log of a build stays beside its library (the comparison tool
    reads registers and spills from it after another process built it);
    None before any build."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.build_log("f32_route") is None
    _build._lib_path("f32_route").with_suffix(".log").write_text(LOG)
    assert _build.ptxas_report(_build.build_log("f32_route"))[1]["kernel"] == "gemm_f32"
