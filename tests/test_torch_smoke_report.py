"""The build gate of ``chip_smoke.py`` (phase 2): how it reads
``cuobjdump``'s resource and SASS listings of the built kernels, and
that it refuses a bf16 forward, dQ or dK/dV kernel that is missing,
misses Hopper's instructions, may spill, or cannot be read at all;
phase 14's gates (``check_master_ha``) on a report the card recorded,
refusing a phase that reports nothing, a missing case, and each gate
broken in turn; phase 15's (``check_slices``) the same way; phase 16's
(``check_serve_rpc_lm``, ``check_serve_cli_mnist``) on the card's rows,
each gate broken alone; and the ``phase_secs`` line."""

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


# ---- phase 14: master high availability -----------------------------------

# phase 14's rows as an NVIDIA H100 80GB HBM3 (700.00 W) reported them
# (the real kill's pids filtered to its worker processes, as the smoke
# reads them), trimmed to what the gates read; the real kill's adoption
# and generations, and 14c's 20 epochs, as the smoke now reports them
HA_ROWS = {
    "mid_epoch": {"rc": 0, "timed_out": False, "lives": 2, "job_secs": 24.574204794, "kill": {"fault_id": "master-kill-mid-epoch", "armed_at_version": 8, "step": 28}, "outage_secs": 2.2859589139999983, "replay_secs": 0.0001432749999992211, "journal_bytes": 8931, "rehome_secs": {"1": 3.078411982999995, "0": 4.001981926999996}, "rehomed": {"1": {"pid": 133, "adopted": True, "kept": [16], "requeued": []}, "0": {"pid": 132, "adopted": True, "kept": [], "requeued": []}}, "fenced": [], "old_pids": {"0": 132, "1": 133}, "generations": {"at_kill": 0, "final": 0}, "reforms": [], "new_world": [0, 1], "total_records": 32768, "violations": [], "master_recovery": {"name": "master_recovery", "status": "PASS", "violations": []}, "accuracy": 1.0, "preempt_step": None, "steps_trained_again": 0},
    "during_reform": {"rc": 0, "timed_out": False, "lives": 2, "job_secs": 54.895097658000005, "kill": {"fault_id": "master-kill-in-reform", "armed_at_version": None, "step": 4}, "outage_secs": 2.337429728999993, "replay_secs": 9.879399999590532e-05, "journal_bytes": 4662, "rehome_secs": {}, "rehomed": {}, "fenced": [0], "old_pids": {"0": 379, "1": 380}, "generations": {"at_kill": 1, "final": 2}, "reforms": [{"cluster_version": 2, "dead_workers": [0, 1], "reason": "worker_failure"}], "new_world": [2, 3], "total_records": 32768, "violations": [], "master_recovery": {"name": "master_recovery", "status": "PASS", "violations": []}, "accuracy": 1.0, "preempt_step": 6, "steps_trained_again": 0},
    "task_stream": {"rc": 0, "timed_out": False, "lives": 2, "job_secs": 19.17855974199999, "kill": {"fault_id": "master-kill-mid-epoch", "armed_at_version": 16, "step": 36}, "outage_secs": 2.5696574409999897, "replay_secs": 7.160399999861511e-05, "journal_bytes": 7288, "rehome_secs": {"0": 2.901953956}, "rehomed": {"0": {"pid": 674, "adopted": True, "kept": [12, 13], "requeued": []}}, "fenced": [], "old_pids": {"0": 674}, "generations": {"at_kill": 0, "final": 0}, "reforms": [], "new_world": [0], "total_records": 327680, "violations": [], "master_recovery": {"name": "master_recovery", "status": "PASS", "violations": []}, "accuracy": 1.0, "preempt_step": None, "steps_trained_again": 0},
    "real_kill": {"rc": 0, "timed_out": False, "lives": 2, "job_secs": 40.21233296599999, "kill": {"fault_id": "master-kill-mid-epoch", "step": 8}, "outage_secs": 9.622638715999983, "replay_secs": 0.00011789300000941694, "journal_bytes": 5112, "rehome_secs": {"0": 9.625049714999989, "1": 9.725499979999995}, "rehomed": {"0": {"pid": 847, "adopted": True, "kept": [], "requeued": []}, "1": {"pid": 848, "adopted": True, "kept": [3], "requeued": []}}, "fenced": [], "old_pids": [847, 848], "generations": {"at_kill": 0, "final": 0}, "reforms": [], "total_records": 32768, "violations": [], "master_recovery": {"name": "master_recovery", "status": "PASS", "violations": []}, "accuracy": 1.0, "first_rc": -9, "left_running": [], "steps_trained_again": 0},
}


def ha_report():
    import copy

    return copy.deepcopy(HA_ROWS)


def test_check_master_ha_passes_a_recorded_report():
    chip_smoke.check_master_ha(ha_report())


def _ha_set(case, path, value):
    def edit(report):
        *keys, last = path
        target = report[case]
        for key in keys:
            target = target[key]
        target[last] = value
    return edit


def _ha_drop(case, key=None):
    def edit(report):
        if key is None:
            report.pop(case)
        else:
            report[case].pop(key)
    return edit


HA_EDITS = {
    "nothing_reported": lambda report: report.clear(),
    "no_mid_epoch": _ha_drop("mid_epoch"),
    "no_during_reform": _ha_drop("during_reform"),
    "no_task_stream": _ha_drop("task_stream"),
    "no_real_kill": _ha_drop("real_kill"),
    "rc_non_zero": _ha_set("mid_epoch", ("rc",), 1),
    "timed_out": _ha_set("task_stream", ("timed_out",), True),
    "no_relaunch": _ha_set("mid_epoch", ("lives",), 1),
    "violation": _ha_set("during_reform", ("violations",), [{"invariant": "exactly_once"}]),
    "records_short": _ha_set("real_kill", ("total_records",), 32768 - 1024),
    "recovery_failed": _ha_set("mid_epoch", ("master_recovery", "status"), "FAIL"),
    "no_recovery_verdict": _ha_set("real_kill", ("master_recovery",), None),
    "accuracy_low": _ha_set("task_stream", ("accuracy",), 0.98),
    "accuracy_unread": _ha_set("mid_epoch", ("accuracy",), None),
    "kill_too_early": _ha_set("mid_epoch", ("kill", "step"), 4),
    "preemption_too_early": _ha_set("during_reform", ("preempt_step",), 2),
    "outage_not_measured": _ha_drop("real_kill", "outage_secs"),
    "replay_not_measured": _ha_set("mid_epoch", ("replay_secs",), "not measured"),
    "journal_bytes_missing": _ha_drop("task_stream", "journal_bytes"),
    "a_worker_not_rehomed": lambda r: r["mid_epoch"]["rehomed"].pop("1"),
    "rehomed_with_another_pid": _ha_set("mid_epoch", ("rehomed", "0", "pid"), 999),
    "not_adopted": _ha_set("task_stream", ("rehomed", "0", "adopted"), False),
    "generation_bumped": _ha_set("mid_epoch", ("generations", "final"), 1),
    "reformed": _ha_set("mid_epoch", ("reforms",), [{"cluster_version": 1}]),
    "fenced_a_live_world": _ha_set("mid_epoch", ("fenced",), [0]),
    "survivor_resurrected": _ha_set(
        "during_reform", ("rehomed",), {"0": {"pid": 379, "adopted": True, "kept": [], "requeued": []}}
    ),
    "survivor_not_fenced": _ha_set("during_reform", ("fenced",), []),
    "fence_not_journaled": _ha_set("during_reform", ("generations", "at_kill"), 0),
    "no_new_generation": _ha_set("during_reform", ("generations", "final"), 1),
    "old_ids_reused": _ha_set("during_reform", ("new_world",), [0, 1]),
    "no_reform": _ha_set("during_reform", ("reforms",), []),
    "no_lease_presented": _ha_set("task_stream", ("rehomed", "0", "kept"), []),
    "real_kill_worker_missing": lambda r: r["real_kill"]["rehomed"].pop("0"),
    "real_kill_stranger": _ha_set("real_kill", ("rehomed", "1", "pid"), 4242),
    "task_stream_records_of_2_epochs": _ha_set("task_stream", ("total_records",), 32768),
    "real_kill_not_adopted": _ha_set("real_kill", ("rehomed", "1", "adopted"), False),
    "real_kill_adoption_unrecorded": lambda r: r["real_kill"]["rehomed"]["0"].pop("adopted"),
    "real_kill_generation_bumped": _ha_set("real_kill", ("generations", "final"), 1),
    "real_kill_restored_past_a_fence": _ha_set("real_kill", ("generations", "at_kill"), 1),
    "real_kill_reformed": _ha_set("real_kill", ("reforms",), [{"cluster_version": 1}]),
    "real_kill_reforms_unread": _ha_drop("real_kill", "reforms"),
    "worker_left_running": _ha_set("real_kill", ("left_running",), [847]),
    "first_master_not_killed": _ha_set("real_kill", ("first_rc",), 0),
}


@pytest.mark.parametrize("name", sorted(HA_EDITS))
def test_check_master_ha_refuses(name):
    report = ha_report()
    HA_EDITS[name](report)
    with pytest.raises(AssertionError):
        chip_smoke.check_master_ha(report)


# ---- phase 9: each graph replay's flash kernels in its device trace ----------

CAPTURED = {"flash_bwd_dkv": 48, "flash_bwd_dq": 48, "flash_fwd": 96}


@pytest.mark.parametrize("traced, gaps", [
    (dict(CAPTURED), False),
    (dict(CAPTURED, flash_fwd=92), False),  # the most the H100's trace dropped
    (dict(CAPTURED, flash_fwd=86), True),  # over a tenth of 96
    (dict(CAPTURED, flash_bwd_dq=44), False),
    (dict(CAPTURED, flash_bwd_dq=43), True),  # over a tenth of 48
    (dict(CAPTURED, flash_bwd_dq=1), True),  # a replay the trace barely saw
    (dict(CAPTURED, flash_bwd_dkv=0), True),
    (dict(CAPTURED, flash_fwd=97), True),  # more than the graph holds
], ids=["all", "dropped_4", "dropped_10", "dq_dropped_4", "dq_dropped_5", "one_of_48",
        "unseen", "over"])
def test_replay_trace_gaps(traced, gaps):
    counts = [dict(CAPTURED)] * 3
    got = chip_smoke.replay_trace_gaps(counts, [dict(CAPTURED), traced, dict(CAPTURED)])
    assert got == ([(1, traced)] if gaps else [])


# ---- phase 15: standbys, slices, parking and the autoscaler -----------------

# phase 15's rows as an NVIDIA H100 80GB HBM3 (700.00 W) reported them
# (phase 10's cell: 2 epochs of 16 384 records), trimmed to what the
# gates read
SLICE_CFG = chip_smoke.SLICE_MNIST
SLICE_ROWS = {
    "standby": {"rc": 0, "job_secs": 29.233208248999972, "total_records": 32768, "reform_events": [{"cluster_version": 1, "dead_workers": [1], "reason": "worker_failure", "latency_secs": 0.6179992870000888}], "restored_secs_after_detection": 8.14796487000001, "violations": [], "fired": ["preempt-p1", "checkpoint_restore"], "dumps_bitwise_equal": True, "standby_activations": 2, "activated_pids": [5527, 5528], "reformed_world_pids": [5527, 5528], "reform_latency_secs": 0.6179992870000888, "reform_split": {"assignment_secs": 0.21941522300005545, "rendezvous_secs": 0.3985840640000333, "restore_secs": 7.529965582999921}, "accuracy": 1.0},
    "slice_loss": {"rc": 0, "job_secs": 46.083692875, "total_records": 32768, "reform_events": [{"cluster_version": 1, "dead_workers": [2, 3], "reason": "worker_failure", "harvest": {"complete": True, "version": 4, "bytes": 445524, "checksum": "3dff5972", "secs": 0.017127339000012398}, "latency_secs": 8.03050554999993}], "dumps_bitwise_equal": True, "violations": [], "slice_loss": [{"observation": "slice_loss", "generation": 1, "lost_slices": [1], "dead_workers": [2, 3], "old_slices": 2, "new_slices": 1, "parked": False}], "mesh_resize": [{"observation": "mesh_resize", "generation": 1, "old_world_size": 4, "new_world_size": 2, "old_slices": 2, "new_slices": 1}], "invariants": [{"name": "cross_slice_replica_coverage", "status": "PASS", "violations": []}], "no_lost_steps": {"name": "replication_no_lost_steps", "status": "PASS", "violations": []}, "restored_from": "replica@4", "world_after": 2, "accuracy": 1.0},
    "park_grant": {"rc": 0, "job_secs": 47.64139675900003, "total_records": 32768, "reform_events": [{"cluster_version": 2, "dead_workers": [], "reason": "capacity_grant", "latency_secs": 7.052289428999984}], "dumps_bitwise_equal": True, "violations": [], "slice_loss": [{"observation": "slice_loss", "generation": 1, "lost_slices": [1], "dead_workers": [1], "old_slices": 2, "new_slices": 1, "parked": True}], "park": {"parked_at": 727.043057749, "quiesced": True, "workers_while_parked": [], "generation": 1, "granted_at": 729.043407353}, "journaled_parked_worlds": [{"cluster_version": 1, "worker_ids": [], "num_slices": 1, "parked": True}], "generation": 2, "unparked_secs": 2.177147694000041, "accuracy": 1.0},
    "autoscale": {"rc": 0, "job_secs": 28.11634673900005, "total_records": 32768, "reform_events": [{"cluster_version": 1, "dead_workers": [], "reason": "autoscale:grow", "latency_secs": 10.918220266999924}], "dumps_bitwise_equal": True, "violations": [], "decisions": [{"action": "grow", "from_slices": 1, "to_slices": 2, "reason": "backlog 16 >= 4", "p95_step_ms": None, "backlog": 16}], "decision_events": [{"observation": "autoscale_decision", "generation": 0, "action": "grow", "from_slices": 1, "to_slices": 2, "reason": "backlog 16 >= 4", "p95_step_ms": None, "backlog": 16}], "mesh_resize": [{"observation": "mesh_resize", "generation": 1, "old_world_size": 1, "new_world_size": 2, "old_slices": 1, "new_slices": 2}], "worlds": [2], "accuracy": 1.0},
}


def slice_report():
    import copy

    return copy.deepcopy(SLICE_ROWS)


def test_check_slices_passes_a_recorded_report():
    chip_smoke.check_slices(slice_report(), SLICE_CFG)


def test_check_slices_takes_a_report_without_15a_only_when_it_says_so():
    report = slice_report()
    report.pop("standby")
    with pytest.raises(AssertionError):
        chip_smoke.check_slices(report, SLICE_CFG)
    chip_smoke.check_slices(dict(report, without_standby=True), SLICE_CFG)


SLICE_EDITS = {
    "nothing_reported": lambda report: report.clear(),
    "no_standby": _ha_drop("standby"),
    "no_slice_loss": _ha_drop("slice_loss"),
    "no_park_grant": _ha_drop("park_grant"),
    "no_autoscale": _ha_drop("autoscale"),
    "rc_non_zero": _ha_set("slice_loss", ("rc",), 1),
    "violation": _ha_set("park_grant", ("violations",), [{"invariant": "exactly_once"}]),
    "records_short": _ha_set("autoscale", ("total_records",), 32768 - 1024),
    "accuracy_low": _ha_set("standby", ("accuracy",), 0.98),
    "accuracy_unread": _ha_set("slice_loss", ("accuracy",), None),
    "ranks_differ": _ha_set("park_grant", ("dumps_bitwise_equal",), False),
    "standby_cold_started": _ha_set("standby", ("standby_activations",), 0),
    "standby_one_of_two": _ha_set("standby", ("standby_activations",), 1),
    "standby_pids_not_the_pools": _ha_set("standby", ("reformed_world_pids",), [1, 2]),
    "standby_no_reform": _ha_set("standby", ("reform_events",), []),
    "standby_latency_unmeasured": _ha_set("standby", ("reform_latency_secs",), None),
    "standby_split_unmeasured": _ha_set("standby", ("reform_split",), None),
    "standby_no_preemption": _ha_set("standby", ("fired",), ["checkpoint_restore"]),
    "slice_loss_unrecorded": _ha_set("slice_loss", ("slice_loss",), []),
    "slice_loss_of_slice_0": _ha_set("slice_loss", ("slice_loss", 0, "lost_slices"), [0]),
    "slice_loss_parked": _ha_set("slice_loss", ("slice_loss", 0, "parked"), True),
    "no_mesh_resize": _ha_set("slice_loss", ("mesh_resize",), []),
    "resize_kept_the_slices": _ha_set("slice_loss", ("mesh_resize", 0, "new_slices"), 2),
    "resize_kept_the_world": _ha_set("slice_loss", ("mesh_resize", 0, "new_world_size"), 4),
    "coverage_failed": _ha_set("slice_loss", ("invariants", 0, "status"), "FAIL"),
    "coverage_unchecked": _ha_set("slice_loss", ("invariants",), []),
    "lost_steps": _ha_set("slice_loss", ("no_lost_steps", "status"), "FAIL"),
    "restored_from_disk": _ha_set("slice_loss", ("restored_from",), "disk@4"),
    "shrunk_to_one_process": _ha_set("slice_loss", ("world_after",), 1),
    "not_parked": _ha_set("park_grant", ("slice_loss", 0, "parked"), False),
    "parked_world_running": _ha_set("park_grant", ("park", "workers_while_parked"), [0]),
    "parked_not_quiesced": _ha_set("park_grant", ("park", "quiesced"), False),
    "park_not_journaled": _ha_set("park_grant", ("journaled_parked_worlds",), []),
    "parked_world_journaled_with_workers": _ha_set(
        "park_grant", ("journaled_parked_worlds", 0, "worker_ids"), [0]),
    "no_grant": _ha_set("park_grant", ("reform_events",), []),
    "grant_reason_wrong": _ha_set("park_grant", ("reform_events", 0, "reason"), "worker_failure"),
    "grant_same_generation": _ha_set("park_grant", ("reform_events", 0, "cluster_version"), 1),
    "grant_before_the_delay": _ha_set("park_grant", ("unparked_secs",), 0.5),
    "no_decision": _ha_set("autoscale", ("decisions",), []),
    "shrink_decided": _ha_set("autoscale", ("decisions", 0, "action"), "shrink"),
    "decision_unlogged": _ha_set("autoscale", ("decision_events",), []),
    "decision_unrealized": _ha_set("autoscale", ("reform_events",), []),
    "realized_by_another_reform": _ha_set("autoscale", ("reform_events", 0, "reason"), "elective"),
    "grown_world_short": _ha_set("autoscale", ("worlds",), [1]),
    "autoscale_not_resized": _ha_set("autoscale", ("mesh_resize",), []),
}


@pytest.mark.parametrize("name", sorted(SLICE_EDITS))
def test_check_slices_refuses(name):
    report = slice_report()
    SLICE_EDITS[name](report)
    with pytest.raises(AssertionError):
        chip_smoke.check_slices(report, SLICE_CFG)


# ---- phase 16: serving over RPC ---------------------------------------------

# phase 16's rows as an NVIDIA H100 80GB HBM3 (700.00 W) reported them,
# trimmed to what the gates read (16a's in the row's present form: the
# versions of the four requests sent after the swap's acknowledgement,
# all 2, as that run's gate read them)
SERVE_LM_ROW = {
    "device": "cuda", "layers": 12, "warm": {"requests": 16}, "warm_failures": [],
    "warm_dispatches": 16, "warm_flash_fwd_launches": 192,
    "swap": {
        "accepted": True,
        "replicas": [
            {"replica_id": 0, "accepted": True, "absorbed": False, "reason": ""},
            {"replica_id": 1, "accepted": True, "absorbed": False, "reason": ""},
        ],
        "versions_after": [2, 2], "versions_during": [1, 2],
        "versions_after_ack": [2, 2, 2, 2], "replay_accepted": True,
        "replay_absorbed": [True, True],
    },
    "requests": 31, "dispatches": 31, "flash_fwd_launches": 372,
    "shapes_dispatched": [1, 1], "max_abs_err": 0.0, "mean_abs_err": 0.0, "failures": [],
    "cap": {"calls": 1, "code": "RESOURCE_EXHAUSTED", "replica_requests_served": 1},
}
SERVE_CLI_ROW = {
    "device": "cuda", "version": 32, "predicted_rows": 2048, "max_abs_err_to_local": 0.0,
    "watch": {"replica_versions": [33, 33], "failures": 0, "versions": [32, 33],
              "after_converged": [33]},
    "exit": {"replicas": 2, "gone": True, "rc": 0},
}


def _row_set(row, path, value):
    def edit(r):
        node = r
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    return row, edit


SERVE_EDITS = {
    "lm_failed_request": _row_set("lm", ("failures",), ["request 3: UNAVAILABLE"]),
    "lm_warm_failed_request": _row_set("lm", ("warm_failures",), ["request 0"]),
    "lm_warm_short": _row_set("lm", ("warm", "requests"), 15),
    "lm_kernel_bypassed": _row_set("lm", ("flash_fwd_launches",), 371),
    "lm_warm_kernel_bypassed": _row_set("lm", ("warm_flash_fwd_launches",), 180),
    # 30 dispatches, each with its 12 launches, for 31 requests
    "lm_fewer_dispatches": ("lm", lambda r: r.update(dispatches=30, flash_fwd_launches=360)),
    "lm_rows_disagree": _row_set("lm", ("max_abs_err",), 0.2),
    "lm_rows_disagree_on_average": _row_set("lm", ("mean_abs_err",), 0.02),
    "lm_rows_unchecked": _row_set("lm", ("max_abs_err",), None),
    "lm_swap_refused": _row_set("lm", ("swap", "accepted"), False),
    "lm_swap_one_replica": _row_set("lm", ("swap", "replicas", 1, "accepted"), False),
    "lm_swap_left_version_1": _row_set("lm", ("swap", "versions_after"), [2, 1]),
    "lm_unknown_version": _row_set("lm", ("swap", "versions_during"), [1, 2, 3]),
    "lm_old_version_after_ack": _row_set("lm", ("swap", "versions_after_ack"), [2, 1, 2, 2]),
    "lm_too_few_after_ack": _row_set("lm", ("swap", "versions_after_ack"), [2, 2]),
    "lm_replay_applied": _row_set("lm", ("swap", "replay_absorbed"), [False, True]),
    "lm_replay_refused": _row_set("lm", ("swap", "replay_accepted"), False),
    "lm_cap_unavailable": _row_set("lm", ("cap", "code"), "UNAVAILABLE"),
    "lm_cap_retried": _row_set("lm", ("cap", "replica_requests_served"), 3),
    "lm_cap_answered": _row_set("lm", ("cap", "code"), None),
    "lm_two_shapes": _row_set("lm", ("shapes_dispatched",), [1, 2]),
    "cli_predict_differs": _row_set("cli", ("max_abs_err_to_local",), 1e-3),
    "cli_predict_short": _row_set("cli", ("predicted_rows",), 2040),
    "cli_watch_failure": _row_set("cli", ("watch", "failures"), 1),
    "cli_watch_one_replica": _row_set("cli", ("watch", "replica_versions"), [33, 32]),
    "cli_old_version_after_swap": _row_set("cli", ("watch", "after_converged"), [32, 33]),
    "cli_replica_left": _row_set("cli", ("exit", "gone"), False),
    "cli_replicas_uncounted": _row_set("cli", ("exit", "replicas"), 0),
}


def test_check_serving_passes_the_recorded_rows():
    import copy

    assert chip_smoke.check_serve_rpc_lm(copy.deepcopy(SERVE_LM_ROW)) == []
    assert chip_smoke.check_serve_cli_mnist(copy.deepcopy(SERVE_CLI_ROW)) == []
    # the CPU rehearsal's plain path launches nothing
    cpu = dict(copy.deepcopy(SERVE_LM_ROW), device="cpu", flash_fwd_launches=0,
               warm_flash_fwd_launches=0)
    assert chip_smoke.check_serve_rpc_lm(cpu) == []


@pytest.mark.parametrize("name", sorted(SERVE_EDITS))
def test_check_serving_refuses(name):
    import copy

    which, edit = SERVE_EDITS[name]
    rows = {"lm": copy.deepcopy(SERVE_LM_ROW), "cli": copy.deepcopy(SERVE_CLI_ROW)}
    edit(rows[which])
    bad = (chip_smoke.check_serve_rpc_lm(rows["lm"]) if which == "lm"
           else chip_smoke.check_serve_cli_mnist(rows["cli"]))
    assert len(bad) == 1, bad


def test_the_phase_secs_line_has_each_phase_and_the_total(monkeypatch):
    now = [chip_smoke.STARTED_AT]
    monkeypatch.setattr(chip_smoke.time, "monotonic", lambda: now[0])
    clock = chip_smoke._PhaseClock()
    for name, secs in (("1_device", 2.0), ("2_build", 10.5), ("15_slices", 120.25)):
        now[0] += secs
        clock.done(name)
    now[0] += 1.0
    line = clock.line()
    assert line == {"phase_secs": {"1_device": 2.0, "2_build": 10.5, "15_slices": 120.25,
                                   "total": 133.75}}
