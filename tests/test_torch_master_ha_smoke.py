"""``chip_smoke.py``'s phase 14c and 14d at a small size on the CPU
(14a and 14b run in ``tests/test_torch_master_ha.py``): one task-stream
worker through a master kill at a tick, its leases presented on
re-homing before its first retried call; and a real SIGKILL
of ``python -m elasticdl_tpu_torch.master.main``, whose orphaned workers
re-home into the relaunched process and are adopted, read from the
journal and the chaos event log.  Each row goes through the phase's own
gates (``check_master_ha_case``)."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    """The worker processes this file starts inherit the environment: one
    intra-op thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


# 64 steps: the kill at version >= 6 lands with most of the job still to
# run, also when a loaded CPU delays the master's next tick
CFG = dict(
    chip_smoke.HA_MNIST, train_records=1024, eval_records=128, batch=32,
    records_per_task=64, shards=2, min_accuracy=0.0,
)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return chip_smoke._zoo_data(str(tmp_path_factory.mktemp("ha_data")), CFG)


def test_smoke_phase14c_rehearsal_on_the_cpu(tmp_path, monkeypatch, data):
    # a loaded CPU can delay a re-home past the smoke's 5 s grace
    monkeypatch.setattr(chip_smoke, "HA_GRACE_SECS", 8.0)
    # the card's 20 epochs run here at about 0.1 s a step: 4 leave the
    # worker over 10 s after the kill, two of its 5 s heartbeats
    monkeypatch.setattr(chip_smoke, "HA_TASK_STREAM_EPOCHS", 4)
    row = chip_smoke.master_ha_run(str(tmp_path), CFG, data, "task_stream", device="cpu")
    assert chip_smoke.check_master_ha_case("task_stream", row, CFG) == []
    (rehomed,) = row["rehomed"].values()
    assert rehomed["adopted"] and rehomed["kept"] and not rehomed["requeued"]
    assert row["steps_trained_again"] == 0
    assert row["total_records"] == 1024 * 4


def test_smoke_phase14d_rehearsal_on_the_cpu(tmp_path, monkeypatch, data):
    monkeypatch.setattr(chip_smoke, "HA_GRACE_SECS", 8.0)
    lives = chip_smoke._real_kill_lives(str(tmp_path), CFG, data, device="cpu")
    row = chip_smoke.master_ha_real_kill_run(CFG, data, lives, device="cpu")
    assert chip_smoke.check_master_ha_case("real_kill", row, CFG) == []
    assert row["first_rc"] == -9 and len(row["old_pids"]) == 2
    assert row["journal"]["tasks"] == 32 and row["journal"]["clean_shutdown"]
    assert not row["journal"]["done_twice"] and not row["journal"]["never_done"]
    assert row["journal"]["generation"] == 0 and row["journal"]["generation_bumps"] == []
    assert sorted(r["pid"] for r in row["rehomed"].values()) == row["old_pids"]
    assert all(r["adopted"] for r in row["rehomed"].values())
    timeline = row["timeline"]
    assert 0 < timeline["kill"] < timeline["relaunch"] < timeline["second_master_exit"]
