"""The build gate of ``chip_smoke.py`` (phase 2): how it reads
``cuobjdump``'s resource and SASS listings of the built kernels, and
that it refuses a bf16 forward, dQ or dK/dV kernel that is missing,
misses Hopper's instructions, may spill, or cannot be read at all."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

SM90 = "_ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi64ELi4EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiiiif"
F32 = "_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64EEEvPKfS2_S2_PfS3_iiiiif"
DQ = "_ZN12_GLOBAL__N_118flash_bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_PS2_iiiiif"
DQ_SM90 = "_ZN45_GLOBAL__N__e43c1707_12_flash_bwd_cu_26940ad524flash_bwd_dq_sm90_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiiiiff"
DKV_SM90 = "_ZN45_GLOBAL__N__e43c1707_12_flash_bwd_cu_26940ad525flash_bwd_dkv_sm90_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiiiff"

RES_USAGE = f"""
Resource usage:
 Common:
  GLOBAL:0
 Function {SM90}:
  REG:168 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:616 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function {F32}:
  REG:128 STACK:16 SHARED:0 LOCAL:0 CONSTANT[0]:588 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

SASS = f"""
	code for sm_90a
		Function : {SM90}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0120*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
		Function : {F32}
        /*0100*/                   FFMA R4, R5, R6, R4 ;
"""


FWD, BWD_DQ, BWD_DKV = (
    "flash_fwd_sm90_kernel<64,4>", "flash_bwd_dq_sm90_kernel<64>",
    "flash_bwd_dkv_sm90_kernel<64>",
)


def good_report():
    return {
        FWD: {
            "registers": 168, "stack": 0, "local": 0, "shared": 0,
            "HGMMA": 24, "UTMALDG": 3,
        },
        "flash_fwd_f32_kernel<64>": {
            "registers": 128, "stack": 16, "local": 0, "shared": 0,
            "HGMMA": 0, "UTMALDG": 0,
        },
        BWD_DQ: {
            "registers": 168, "stack": 0, "local": 0, "shared": 1024,
            "HGMMA": 12, "UTMALDG": 4,
        },
        BWD_DKV: {
            "registers": 168, "stack": 0, "local": 0, "shared": 1024,
            "HGMMA": 16, "UTMALDG": 4,
        },
        "flash_bwd_dq_f32_kernel<32>": {
            "registers": 64, "stack": 8, "local": 0, "shared": 0,
            "HGMMA": 0, "UTMALDG": 0,
        },
    }


@pytest.mark.parametrize(
    "mangled, label",
    [
        (SM90, "flash_fwd_sm90_kernel<64,4>"),
        (F32, "flash_fwd_f32_kernel<64>"),
        (DQ, "flash_bwd_dq_kernel<bf16,64>"),
        (DQ_SM90, "flash_bwd_dq_sm90_kernel<64>"),
        (DKV_SM90, "flash_bwd_dkv_sm90_kernel<128>"),
        ("some_other_function", "some_other_function"),
    ],
)
def test_kernel_label(mangled, label):
    assert chip_smoke.kernel_label(mangled) == label


def test_parse_res_usage_reads_each_kernel():
    assert chip_smoke.parse_res_usage(RES_USAGE) == {
        "flash_fwd_sm90_kernel<64,4>": {
            "registers": 168, "stack": 0, "local": 0, "shared": 0,
        },
        "flash_fwd_f32_kernel<64>": {
            "registers": 128, "stack": 16, "local": 0, "shared": 0,
        },
    }


def test_count_sass_ops_counts_per_kernel():
    assert chip_smoke.count_sass_ops(SASS) == {
        "flash_fwd_sm90_kernel<64,4>": {"HGMMA": 2, "UTMALDG": 1},
        "flash_fwd_f32_kernel<64>": {"HGMMA": 0, "UTMALDG": 0},
    }


def test_check_hopper_kernels_passes_a_good_build():
    # the f32 kernels' stack frames and missing Hopper units are allowed
    chip_smoke.check_hopper_kernels(good_report())


def _drop(kernel):
    def edit(report):
        report.pop(kernel)
    return edit


def _set(field, value, kernel=FWD):
    def edit(report):
        report[kernel][field] = value
    return edit


def _remove(field):
    def edit(report):
        del report[FWD][field]
    return edit


@pytest.mark.parametrize(
    "edit",
    [
        _drop(FWD),
        _set("HGMMA", 0),
        _set("UTMALDG", 0),
        _set("stack", 8),
        _set("local", 4),
        _set("registers", "not measured"),
        _remove("stack"),
        _remove("UTMALDG"),
        _drop(BWD_DQ),
        _drop(BWD_DKV),
        _set("HGMMA", 0, BWD_DQ),
        _set("HGMMA", 0, BWD_DKV),
        _set("stack", 8, BWD_DQ),
        _set("stack", 8, BWD_DKV),
    ],
    ids=[
        "no_hopper_kernel", "no_hgmma", "no_utmaldg", "stack_frame",
        "local_memory", "unread_field", "missing_stack", "missing_utmaldg",
        "no_dq_kernel", "no_dkv_kernel", "dq_no_hgmma", "dkv_no_hgmma",
        "dq_stack_frame", "dkv_stack_frame",
    ],
)
def test_check_hopper_kernels_refuses(edit):
    report = good_report()
    edit(report)
    with pytest.raises(AssertionError):
        chip_smoke.check_hopper_kernels(report)
