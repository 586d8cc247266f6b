"""Durable control-plane journal — master high availability's backbone;
a copy of ``elasticdl_tpu/master/journal.py``, whole but for its
memory-ledger registration (the port's ``telemetry/memory.py`` has no
component registry until slice 10b).

A write-ahead record of everything the master would otherwise lose with
its RAM: the task dispatcher's full lifecycle (todo/doing sets, epoch
cursor, counters), the servicer's control state (cluster generation,
model version, memoized lockstep step-stream), consumed deferred
callbacks, the worker-world composition, and replica-stage metadata.

Layout: ``<--master_journal_dir>/journal.jsonl`` — the same append-only
JSONL + rename-based rotation discipline as the telemetry event log
(:mod:`elasticdl_tpu_torch.telemetry.events`; the reader IS that
module's shard-aware ``read_jsonl``).  The file always begins with a full
``snapshot`` record; every subsequent record is one transition delta.
Replay = last snapshot + deltas after it, so rotation dropping old
shards never loses recoverable state as long as a snapshot lands in the
retained window (the writer re-snapshots every ``snapshot_every``
deltas; the master's run loop drives that via :meth:`maybe_snapshot`).

Durability: appends are buffered and fsync-BATCHED (every
``fsync_batch`` records or ``fsync_interval_secs``, whichever first;
generation bumps and snapshots flush inline — losing one is losing the
fence).  The tail of the batch window can die with the master; that is
by design — the worker re-homing handshake (lease reconciliation) and
the dispatcher's drop-unknown-report rule reconcile the window, so the
exactly-once accounting the journal CLAIMS is exactly the accounting
the restored master ENFORCES.

All journal dict keys are strings (JSON would coerce them silently and
replay would then see str where it wrote int; test-pinned like the
replica peer map's msgpack ``strict_map_key`` rule).
"""

from __future__ import annotations

import json
import os
import threading
import time

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

JOURNAL_FILENAME = "journal.jsonl"
MASTER_ADDR_FILENAME = "master_addr"

# env plumbing to workers (set by the master when --master_journal_dir
# is configured; read by worker/main.py and the crash-linger path)
MASTER_ADDR_FILE_ENV = "ELASTICDL_TPU_MASTER_ADDR_FILE"


def journal_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, JOURNAL_FILENAME)


def addr_file_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, MASTER_ADDR_FILENAME)


def write_master_addr(journal_dir: str, addr: str):
    """Publish the (re)started master's control-plane address for worker
    re-resolution — atomic rename so a reader never sees a torn write."""
    tmp = addr_file_path(journal_dir) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(addr + "\n")
    os.replace(tmp, addr_file_path(journal_dir))


def read_master_addr(path: str) -> str | None:
    """The re-resolve hook workers install on their RPC client."""
    try:
        with open(path, encoding="utf-8") as f:
            addr = f.read().strip()
        return addr or None
    except OSError:
        return None


class MasterJournal:
    """The writer half: a ``TaskDispatcher`` observer plus direct record
    hooks for the servicer/master.  Attach UNARMED (so the observer
    backlog replay is ignored), seed with :meth:`start` (writes the
    initial snapshot and arms), then every transition self-appends."""

    def __init__(
        self,
        journal_dir: str,
        fsync_batch: int = 16,
        fsync_interval_secs: float = 0.2,
        snapshot_every: int = 512,
    ):
        os.makedirs(journal_dir, exist_ok=True)
        self._dir = journal_dir
        self._path = journal_path(journal_dir)
        self._fsync_batch = max(1, fsync_batch)
        self._fsync_interval = fsync_interval_secs
        self._snapshot_every = max(1, snapshot_every)
        self._lock = threading.Lock()
        # serializes drain+write+fsync: without it a preempted flusher
        # thread could land its (earlier) chunk AFTER an inline critical
        # flush, and replay — which applies records in FILE order —
        # would see effects before their causes
        self._flush_lock = threading.Lock()
        self._flush_wake = threading.Event()
        self._buffer: list[str] = []
        self._armed = False
        self._closed = False
        self._seq = 0
        self._since_snapshot = 0
        self._last_version = -1
        self._callbacks_invoked = 0
        self._snapshot_provider = None
        self._flusher = threading.Thread(
            target=self._flush_loop, name="master-journal", daemon=True
        )
        self._flusher.start()

    def buffer_bytes(self) -> int:
        """Bytes buffered and not yet flushed to disk."""
        with self._lock:
            return sum(len(line) for line in self._buffer)

    # ---- lifecycle ---------------------------------------------------------

    def set_snapshot_provider(self, provider):
        """``provider(append)`` assembles the full snapshot state and
        calls ``append(state)`` with it — from INSIDE whatever critical
        section makes the capture atomic with its journal position.  The
        master captures the dispatcher under the dispatcher transition
        lock (``TaskDispatcher.atomic_state_snapshot``): replay is
        last-snapshot-plus-later-deltas, so a delta journaled between a
        capture and its record would be silently dropped while its
        effect is missing from the captured state (a lost completion).
        The run loop drives snapshots; never call from an observer."""
        self._snapshot_provider = provider

    def start(self):
        """Write the initial snapshot and arm the observer hooks."""
        self.write_snapshot()
        self._armed = True

    def write_snapshot(self):
        if self._snapshot_provider is None:
            return
        try:
            self._snapshot_provider(self._append_snapshot)
        except Exception:  # noqa: BLE001 — a failed snapshot must not
            # take down the control plane; deltas since the LAST good
            # snapshot still replay
            logger.exception("Journal snapshot provider failed")

    def _append_snapshot(self, state: dict):
        """The ``append`` callback handed to the snapshot provider."""
        self._append("snapshot", critical=True, state=state)
        with self._lock:
            self._since_snapshot = 0

    def maybe_snapshot(self):
        """Run-loop hook: re-snapshot once enough deltas accumulated
        (bounds replay work and makes rotation safe)."""
        with self._lock:
            due = self._since_snapshot >= self._snapshot_every
        if due:
            self.write_snapshot()

    def close(self):
        self.flush()
        self._closed = True

    def abort(self):
        """SIGKILL semantics for the in-process chaos harness: drop the
        unflushed buffer tail and stop writing — exactly what a real
        master kill loses (the fsync-batch window the re-homing
        handshake is designed to reconcile)."""
        with self._lock:
            self._buffer.clear()
            self._closed = True

    # ---- append machinery --------------------------------------------------

    def _append(self, kind: str, critical: bool = False, **fields):
        if self._closed:
            return
        with self._lock:
            self._seq += 1
            record = {
                "seq": self._seq,
                "kind": kind,
                "time": time.time(),
                "monotonic": time.monotonic(),
                **fields,
            }
            self._buffer.append(json.dumps(record))
            if kind != "snapshot":
                self._since_snapshot += 1
            batch_full = len(self._buffer) >= self._fsync_batch
        if critical:
            self.flush()
        elif batch_full:
            # fsync off the caller's thread: observer appends run under
            # the dispatcher/stream locks, and an inline disk flush there
            # would stall every concurrent lease/report/heartbeat RPC
            self._flush_wake.set()

    def flush(self):
        """Write + fsync everything buffered (reopen per flush so the
        rename-based rotation always lands appends in the ACTIVE file).
        Serialized: concurrent flushes drain and write whole buffer
        generations in order, so file order == seq order."""
        with self._flush_lock:
            with self._lock:
                lines, self._buffer = self._buffer, []
            if not lines:
                return
            from elasticdl_tpu_torch.telemetry.events import rotate_if_needed

            try:
                rotate_if_needed(self._path)
                with open(self._path, "a", encoding="utf-8") as f:
                    f.write("\n".join(lines) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                logger.exception("Control-plane journal write failed")

    def _flush_loop(self):
        while not self._closed:
            self._flush_wake.wait(self._fsync_interval)
            self._flush_wake.clear()
            self.flush()

    # ---- TaskDispatcher observer hooks -------------------------------------

    def on_tasks_created(self, tasks):
        if not self._armed or not tasks:
            return
        self._append(
            "tasks_created",
            tasks=[t.to_dict() for t in tasks],
            records=sum(t.num_records for t in tasks),
        )

    def on_epoch_opened(self, epoch: int):
        if self._armed:
            self._append("epoch", epoch=int(epoch))

    def on_task_leased(self, task_id: int, worker_id: int, task):
        if self._armed:
            self._append(
                "lease",
                task_id=int(task_id),
                worker_id=int(worker_id),
                uid=int(task.uid),
                task_type=int(task.type),
            )

    def on_task_done(
        self, task_id, task, worker_id, success, exec_counters=None
    ):
        if self._armed:
            # success reports flush inline: one lost in the batch-window
            # tail would make the restored dispatcher re-run a task whose
            # completion was already COUNTED by the first life — the one
            # loss the re-homing handshake cannot reconcile (the worker,
            # having been acked, no longer presents the lease).  Failure
            # reports just requeue, which a journal-less restart does
            # anyway, so they ride the batch.  Completions are per-task
            # (seconds apart), so the fsync cost is negligible
            self._append(
                "report",
                critical=bool(success),
                task_id=int(task_id),
                uid=int(task.uid),
                worker_id=int(worker_id),
                success=bool(success),
                task_type=int(task.type),
                records=int(task.num_records),
                exec_counters={
                    str(k): v for k, v in (exec_counters or {}).items()
                },
            )

    def on_task_reclaimed(self, task_id, task):
        if self._armed:
            self._append(
                "reclaim",
                task_id=int(task_id),
                uid=int(task.uid),
                task_type=int(task.type),
            )

    def on_callback_invoked(self):
        self._callbacks_invoked += 1
        if self._armed:
            self._append("callback")

    def set_callbacks_invoked(self, count: int):
        """Seed the cumulative consumed-callback counter after a
        restart (replay hands the restored value back so snapshots keep
        counting across master lives)."""
        self._callbacks_invoked = int(count)

    @property
    def callbacks_invoked(self) -> int:
        return self._callbacks_invoked

    # ---- servicer / master record hooks ------------------------------------

    def on_version_report(self, worker_id: int, model_version: int):
        if not self._armed or model_version <= self._last_version:
            return
        self._last_version = model_version
        self._append("version", model_version=int(model_version))

    def record_generation(self, cluster_version: int):
        """Generation bump — the fence itself; flushed inline (a lost
        fence record would let a restarted master resurrect a fenced
        generation)."""
        self._append(
            "generation", critical=True, cluster_version=int(cluster_version)
        )

    def record_stream_snapshot(self, stream: dict):
        """Full stream-memo capture, appended by the servicer UNDER its
        stream lock so the record's file position IS its capture point.
        Written right after each main snapshot: the main snapshot's
        stream field is captured before its (dispatcher-atomic) append,
        so a memo resolved in between would otherwise be lost — this
        record supersedes everything before it on replay."""
        self._append("stream_snapshot", critical=True, stream=stream)

    def record_stream(
        self, seq: int, response: dict, cluster_version: int = -1
    ):
        """One memoized lockstep step-stream resolution; replayed so a
        restarted master answers already-resolved seqs IDENTICALLY —
        the lockstep invariant must span the outage.  ``cluster_version``
        is the generation the resolution was FOR: a record that raced a
        reform lands after the ``generation`` record, and replay uses the
        stamp to drop it (-1 = unstamped legacy record, always applied)."""
        self._append(
            "stream",
            stream_seq=int(seq),
            response=response,
            cluster_version=int(cluster_version),
        )

    def record_world(
        self,
        cluster_version: int,
        worker_ids: list[int],
        world_size: int,
        num_slices: int = 1,
        slices: dict | None = None,
        parked: bool = False,
    ):
        """``num_slices``/``slices`` (worker_id -> slice_id, STRING keys
        — JSON would coerce them anyway) carry the slice topology so a
        restarted master keeps slice-granular reform working for the
        re-homed world; ``parked`` marks a world gracefully degraded
        below --min_slices (the restarted master must stay parked, not
        relaunch a fleet the capacity cannot run)."""
        self._append(
            "world",
            critical=True,
            cluster_version=int(cluster_version),
            worker_ids=sorted(int(w) for w in worker_ids),
            world_size=int(world_size),
            num_slices=int(num_slices),
            slices={str(k): int(v) for k, v in (slices or {}).items()},
            parked=bool(parked),
        )

    def record_stage(self, generation: int, version, complete: bool):
        """Replica-stage METADATA (the payload is RAM and dies with the
        master; a restarted master serves the disk-fallback answer)."""
        self._append(
            "stage",
            generation=int(generation),
            version=version,
            complete=bool(complete),
        )

    def record_stage_released(self, generation: int):
        """Every process of the restoring generation fetched its copy:
        the stage is no longer in flight, so a later restart must NOT
        report it as a lost replica set (a false disk-fallback)."""
        self._append("stage_released", generation=int(generation))

    def record_job_end(self, rc: int):
        self._append("job_end", critical=True, rc=int(rc))
        self.close()


# ---- replay -----------------------------------------------------------------


def _task_list_remove(tasks: list[dict], uid: int) -> dict | None:
    """Pop the task with ``uid`` searching from the END (leases pop the
    tail, so the match is O(1) on the common path)."""
    for i in range(len(tasks) - 1, -1, -1):
        if int(tasks[i].get("uid", -1)) == uid:
            return tasks.pop(i)
    return None


def replay(records: list[dict]) -> dict | None:
    """Reconstruct the control-plane state from journal records: the
    LAST snapshot plus every delta after it.  Pure function — the
    equivalence property test drives it with recorded transitions.

    Returns ``None`` when no snapshot exists (empty/unusable journal).
    The result dict mirrors the snapshot provider's shape plus
    ``clean_shutdown`` and bookkeeping the restarting master applies.
    """
    snap_index = None
    for i, rec in enumerate(records):
        if rec.get("kind") == "snapshot":
            snap_index = i
    if snap_index is None:
        return None
    state = json.loads(json.dumps(records[snap_index]["state"]))  # deep copy
    disp = state["dispatcher"]
    servicer = state.setdefault(
        "servicer", {"cluster_version": 0, "model_version": 0, "stream": {}}
    )
    state.setdefault("callbacks_invoked", 0)
    state["clean_shutdown"] = False
    from elasticdl_tpu_torch.utils.constants import TaskType

    def counters_for(task_type: int) -> dict:
        name = TaskType(task_type).name
        return disp.setdefault("counters", {}).setdefault(
            name,
            {"total_records": 0, "failed_records": 0, "exec_metrics": {}},
        )

    def queue_for(task_type: int) -> list:
        return (
            disp["pending_eval"]
            if task_type == int(TaskType.EVALUATION)
            else disp["pending"]
        )

    def stream_minted(task: dict):
        """A ``tasks_created`` delta in watermark-lease mode is a window
        mint: the offset cursor (and the source watermark floor — the
        source had published at least this much) advance with it."""
        stream = disp.get("stream")
        if stream is None or int(task["type"]) != int(TaskType.TRAINING):
            return
        end = int(task["end"])
        stream["next_offset"] = max(int(stream.get("next_offset", 0)), end)
        stream["source_watermark"] = max(
            int(stream.get("source_watermark", 0)), end
        )

    def stream_trained(task: dict):
        """A successful window report advances the trained watermark
        over the gap-free prefix — the same pop loop the live
        dispatcher runs (``_stream_complete_locked``)."""
        stream = disp.get("stream")
        if stream is None or int(task["type"]) != int(TaskType.TRAINING):
            return
        completed = stream.setdefault("completed", {})
        completed[str(task["start"])] = int(task["end"])
        watermark = int(stream.get("trained_watermark", 0))
        while str(watermark) in completed:
            watermark = int(completed.pop(str(watermark)))
        stream["trained_watermark"] = watermark

    for rec in records[snap_index + 1 :]:
        kind = rec.get("kind")
        if kind == "epoch":
            disp["epoch"] = int(rec["epoch"])
        elif kind == "tasks_created":
            tasks = rec.get("tasks", [])
            for t in tasks:
                queue_for(int(t["type"])).append(t)
                disp["next_task_uid"] = max(
                    int(disp.get("next_task_uid", 0)), int(t.get("uid", 0))
                )
                stream_minted(t)
            if tasks:
                counters_for(int(tasks[0]["type"]))["total_records"] += int(
                    rec.get("records", 0)
                )
        elif kind == "lease":
            task = _task_list_remove(
                queue_for(int(rec.get("task_type", 0))), int(rec["uid"])
            )
            if task is None:
                continue  # forged/duplicate lease: nothing to move
            disp["active"][str(rec["task_id"])] = {
                "worker_id": int(rec["worker_id"]),
                "task": task,
            }
            disp["next_task_id"] = max(
                int(disp.get("next_task_id", 0)), int(rec["task_id"])
            )
        elif kind == "report":
            entry = disp["active"].pop(str(rec["task_id"]), None)
            if entry is None:
                continue  # unknown lease (forged or double): dropped
            counters = counters_for(int(rec.get("task_type", 0)))
            exec_counters = rec.get("exec_counters", {}) or {}
            for key, value in exec_counters.items():
                if key == "fail_count":
                    counters["failed_records"] += int(value)
                else:
                    counters["exec_metrics"][key] = (
                        counters["exec_metrics"].get(key, 0) + value
                    )
            if not rec.get("success"):
                queue_for(int(rec.get("task_type", 0))).append(
                    entry["task"]
                )
            else:
                stream_trained(entry["task"])
        elif kind == "reclaim":
            entry = disp["active"].pop(str(rec["task_id"]), None)
            if entry is not None:
                queue_for(int(rec.get("task_type", 0))).append(
                    entry["task"]
                )
        elif kind == "version":
            servicer["model_version"] = max(
                int(servicer.get("model_version", 0)),
                int(rec["model_version"]),
            )
        elif kind == "generation":
            # monotone guard: a (forged or corrupt) rollback must not
            # resurrect a fenced generation on restore — the post-run
            # invariant checker still sees the raw record and trips
            prev = int(servicer.get("cluster_version", 0))
            servicer["cluster_version"] = max(prev, int(rec["cluster_version"]))
            # a generation bump is a reform: the live master resets the
            # step stream there, so replay must not resurrect the old
            # generation's memos into the new world — but a held (stale)
            # record must not clear memos the fenced generation produced
            if servicer["cluster_version"] > prev:
                servicer["stream"] = {}
        elif kind == "stream":
            # a resolution stamped for another world raced a reform: the
            # live master's reset_step_stream dropped it, so replay must
            # too — applying it would serve an old-world memo (an
            # already-recovered task) to the new generation
            stamp = int(rec.get("cluster_version", -1))
            if stamp in (-1, int(servicer.get("cluster_version", 0))):
                servicer.setdefault("stream", {})[
                    str(rec["stream_seq"])
                ] = rec["response"]
        elif kind == "stream_snapshot":
            # a full capture at this exact position: supersedes the main
            # snapshot's (earlier-captured) stream field and any deltas
            # replayed since
            servicer["stream"] = {
                str(seq): resp for seq, resp in rec["stream"].items()
            }
        elif kind == "callback":
            state["callbacks_invoked"] = (
                int(state.get("callbacks_invoked", 0)) + 1
            )
        elif kind == "world":
            state["world"] = {
                "cluster_version": int(rec["cluster_version"]),
                "worker_ids": [int(w) for w in rec["worker_ids"]],
                "world_size": int(rec["world_size"]),
                # slice topology (absent on pre-multislice journals)
                "num_slices": int(rec.get("num_slices", 1) or 1),
                "slices": {
                    str(k): int(v)
                    for k, v in (rec.get("slices") or {}).items()
                },
                "parked": bool(rec.get("parked")),
            }
        elif kind == "stage":
            state["stage"] = {
                "generation": int(rec["generation"]),
                "version": rec.get("version"),
                "complete": bool(rec.get("complete")),
            }
        elif kind == "stage_released":
            state["stage"] = None
        elif kind == "job_end":
            state["clean_shutdown"] = True
    return state


def load_state(journal_dir: str) -> dict | None:
    """Replay an on-disk journal (rotation shards included); ``None``
    when the directory holds no usable journal — a FIRST master start,
    not a restart."""
    from elasticdl_tpu_torch.telemetry.events import read_jsonl

    path = journal_path(journal_dir)
    if not any(
        os.path.exists(p) for p in (path, f"{path}.1")
    ):
        return None
    records = read_jsonl(path)
    if not records:
        return None
    return replay(records)
