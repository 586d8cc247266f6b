"""``chip_smoke.py``'s phase 20 (streaming) rehearsed on the CPU at a
small size, ``scripts/streaming_smoke.py``'s stages through the port:

- (a) ``streaming_preempt_under_load`` on a two-rank mnist job over
  ``stream://mnist`` (256 records, 64 published at the start and 64 a
  second, windows of 64, 32 rows a step, replicated, no checkpoint): the
  SIGKILLed rank's world re-forms, restores from peer RAM and drains
  the stream exactly once within its lag bound;
- (b) the same job with ``--corrupt drop_stream_window`` and no fault:
  ``bounded_lag`` fails, and the run still ends;
- (c) a job pushing the replica ring's snapshots into ``serving.main``
  (a frontend and one replica process, eight rows) while hammer threads
  keep requests in flight: none fails, the served version passes the
  boot export's, the compile count stays flat, the freshness ledger
  has a row per push, and the served rows equal the pushed state's
  direct forward.

The three run side by side, as on the card.  Each test gates the job it
reads, and each gate is shown to trip on a row that breaks it; the
card's pace gates, which need a stream that outlasts the world's start,
are shown on scripted ticks.
"""

from __future__ import annotations

import copy
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

# the stream closes about 4 s in, before a CPU world's first step (whose
# time a loaded host does not bound), so the card's pace gates are off
# here and are tested on scripted ticks below
SMALL = dict(
    chip_smoke.STREAM, total=256, rate=64.0, initial=64, batch=32, records_per_task=64,
    lag_limit=0, pace_records=0, run_timeout_secs=240.0, serve_rows=8, probe_rows=4,
)
# a card-sized stream (1024 records a second for 64 s) for the pace gates
PACED = dict(SMALL, total=65536, rate=1024.0, lag_limit=36864, pace_records=3072)


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield chip_smoke.streaming_runs(
            str(tmp_path_factory.mktemp("phase20")), device="cpu", cfg=SMALL
        )
    finally:
        torch.set_num_threads(threads)


def _tail(path, n=3000):
    if not path or not os.path.exists(path):
        return None
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _why(rows, name, problems):
    """A failed gate's message: the problems and the tails of the logs
    of the job (and for 20c of the serving frontend)."""
    row = rows[name]
    return {"problems": problems, "log": _tail(row.get("log")),
            "job_log": _tail((row.get("job") or {}).get("log"))}


def _gated(rows, name):
    problems = chip_smoke.check_streaming(rows, SMALL)[name]
    assert problems == [], _why(rows, name, problems)
    return rows[name]


def test_the_preempted_stream_restores_from_peer_ram_and_drains(rows):
    row = _gated(rows, "preempt")
    assert row["reforms"] == 1 and row["restores"][0]["generation"] == 1
    # the kill at step 3 fell after the first window (2 steps) was pushed
    assert row["restores"][0]["step"] == 2
    assert row["bounded_lag"]["max_lag_records"] <= row["bounded_lag"]["lag_limit_records"]
    assert row["final"] == {"source_watermark": 256, "trained_watermark": 256, "lag": 0,
                            "next_offset": 256, "closed": True}


def test_a_dropped_window_trips_bounded_lag_and_the_run_ends(rows):
    row = _gated(rows, "drop_window")
    assert "final drain incomplete" in row["bounded_lag"]["violations"][0]
    assert row["final"]["trained_watermark"] < SMALL["total"]


def test_the_live_push_serves_the_pushed_state_under_hammer(rows):
    row = _gated(rows, "live")
    assert row["boot_version"] == 1 and row["served_version"] >= 2
    assert row["probe_max_abs_err"] <= chip_smoke.STREAM_SERVE_MAX_ABS_ERR
    assert len(row["push_ms"]) == len([r for r in row["ledger"] if r["accepted"]])
    assert any("freshness:" in line for line in row["job"]["report_lines"])


# each gate of phase 20, and a change of a passing row that must trip it
BREAKS = [
    ("preempt", lambda r: r.update(rc=None)),
    ("preempt", lambda r: r.update(timed_out=True)),
    ("preempt", lambda r: r["invariants"].update(bounded_lag="FAIL")),
    ("preempt", lambda r: r["invariants"].update(replication_no_lost_steps="FAIL")),
    ("preempt", lambda r: r["invariants"].update(exactly_once="FAIL")),
    ("preempt", lambda r: r["final"].update(trained_watermark=192)),
    ("preempt", lambda r: r["final"].update(closed=False)),
    ("preempt", lambda r: r.update(restores=[])),
    ("drop_window", lambda r: r["invariants"].update(bounded_lag="PASS")),
    ("drop_window", lambda r: r.update(invariants_ok=True)),
    ("drop_window", lambda r: r.update(timed_out=True)),
    ("live", lambda r: r.update(failed_requests=1)),
    ("live", lambda r: r.update(served_version=r["boot_version"])),
    ("live", lambda r: r.update(compile_counts=[1, 2])),
    ("live", lambda r: r["ledger"].append(dict(r["ledger"][-1], staleness=-1))),
    ("live", lambda r: r["job"].update(live_push_events=0)),
    ("live", lambda r: r["job"].update(report_lines=[])),
    ("live", lambda r: r.update(probe_max_abs_err=1.0)),
    ("live", lambda r: r["exit"].update(gone=False)),
    ("live", lambda r: r["job"]["invariants"].update(freshness_monotone="FAIL")),
]


@pytest.mark.parametrize("case", range(len(BREAKS)))
def test_each_phase20_gate_trips(rows, case):
    name, breaks = BREAKS[case]
    broken = copy.deepcopy(rows)
    # the job passes its gates, and the break trips one of them
    problems = chip_smoke.check_streaming(broken, SMALL)[name]
    assert problems == [], _why(rows, name, problems)
    breaks(broken[name])
    assert chip_smoke.check_streaming(broken, SMALL)[name]


def _tick(t, source, trained, closed=False):
    return {"event": "stream_watermark", "monotonic": 100.0 + t, "source_watermark": source,
            "trained_watermark": trained, "next_offset": source, "closed": closed}


# a world that steps first 10 s in, loses 2 s to a kill, catches up 20 s
# in with the source open, and trains at its pace until the close
TICKS = [
    _tick(0, 4096, 0), _tick(10, 10240, 512), _tick(12, 12288, 1024),
    _tick(20, 20480, 18944), _tick(30, 30720, 29696), _tick(64, 65536, 65024, True),
    _tick(65, 65536, 65536, True),
]


def test_the_stream_pace_reads_the_master_ticks():
    pace = chip_smoke.stream_pace(TICKS + [{"event": "stream_lag", "monotonic": 0.0}], 2048)
    assert pace == {
        "ticks": 7, "closed_secs": 64.0, "first_trained": {"secs": 10.0, "lag": 9728},
        "lag_growth": 1536, "held_lag": 1536,
        "caught_up": {"secs": 20.0, "source_watermark": 20480,
                      "records_per_s": (18944 - 512) / 10.0},
    }
    # the source closed before the world caught up: no catch-up
    assert "caught_up" not in chip_smoke.stream_pace(TICKS, 512)
    assert chip_smoke.stream_pace(TICKS[:1], 2048) == {"ticks": 1, "closed_secs": None}


PACE_BREAKS = [
    lambda r: r.update(kill_to_step_secs=None),
    lambda r: r["pace"].update(lag_growth=1024 * 1 + 2 * 3072 + 1),
    lambda r: r["pace"].pop("caught_up"),
    lambda r: r["pace"].update(held_lag=3073),
    lambda r: r["pace"].pop("first_trained"),
]


@pytest.mark.parametrize("case", range(len(PACE_BREAKS)))
def test_each_pace_gate_trips(case):
    """The preempted run: the lag may grow by the source's records over
    the kill's downtime plus twice ``pace_records``, and must come within
    ``pace_records`` of the open source and stay there."""
    row = {"pace": chip_smoke.stream_pace(TICKS, 3072), "kill_to_step_secs": 1.0}
    assert chip_smoke._pace_problems("preempt", row, PACED) == []
    PACE_BREAKS[case](row)
    assert chip_smoke._pace_problems("preempt", row, PACED)


def test_the_live_push_must_serve_a_fresh_model_while_the_source_is_open():
    rows = [{"source_watermark": 20480, "staleness": 4096},
            {"source_watermark": 30720, "staleness": 3072}]
    assert chip_smoke._fresh_push_problems(rows, PACED) == []
    assert chip_smoke._fresh_push_problems(rows[:1], PACED)
    # a push at the close does not count, however fresh
    assert chip_smoke._fresh_push_problems(
        [{"source_watermark": 65536, "staleness": 0}], PACED)


def test_with_a_bound_under_the_total_the_dropped_window_trips_the_lag_clause(rows):
    row = copy.deepcopy(rows["drop_window"])
    cfg = dict(SMALL, lag_limit=SMALL["total"] // 2)
    assert chip_smoke.check_stream_run("drop_window", row, cfg)  # the drain alone
    row["bounded_lag"]["violations"].insert(0, "lag peaked at 256 records > bound 128")
    assert chip_smoke.check_stream_run("drop_window", row, cfg) == []
