"""Worker-side replication: snapshot cadence, ring push, hot restore;
the counterpart of ``elasticdl_tpu/replication/replicator.py``.

:class:`PeerReplicator` runs inside the lockstep worker at task
boundaries only (the periodic checkpointer's rule: every process
decides alike from the shared step).  The snapshot is
``parallel/elastic.py::state_checkpoint_parts``, so replication and
disk checkpoints cannot disagree about what "this host's share of the
state" means.

:func:`restore_from_replica` is the other half: the relaunched world's
process 0 asks the master for the harvested replica stage of ITS
generation and, when there is one, loads the state at the exact step of
the last replication through the disk restore's back half
(``trainer/checkpointing.py::apply_restored_values``); the world then
takes it by broadcast, as after a disk restore.

In a multi-slice world the ring is slice-aware: the neighbor is the
next process on ANOTHER slice (``parallel/mesh.py::slice_assignments``
is the map), so a whole-slice loss never takes a shard and its only
replica together; each push observation carries its source and target
slices, which ``chaos/harness.py::check_cross_slice_coverage`` audits.

Left out until the slices that bring them: the chaos corruption modes
(``same_slice_ring``, ``drop_shard_parts``: with the rest of the chaos
harness), and the telemetry spans and events (the push and restore
observations go to the chaos event log, ``chaos/hooks.py``, when a plan
is installed).
"""

from __future__ import annotations

import os
import time

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.parallel import elastic
from elasticdl_tpu_torch.parallel.mesh import slice_assignments
from elasticdl_tpu_torch.replication.blob import (
    blob_checksum,
    decode_snapshot,
    encode_snapshot,
)
from elasticdl_tpu_torch.replication.service import ReplicaClient
from elasticdl_tpu_torch.replication.store import ReplicaShard, ReplicaStore
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
from elasticdl_tpu_torch.trainer.checkpointing import apply_restored_values
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# a push is host RAM to host RAM over the local network: seconds, not
# minutes; a hung neighbor must not stall the training thread forever
PUSH_TIMEOUT_SECS = 30.0

REPLICA_HOST_ENV = "MY_POD_IP"  # k8s pods advertise their pod IP


def _parts_row_count(parts) -> int:
    """Table rows across a snapshot's sharded parts (``name -> (ids,
    rows)``)."""
    if not parts:
        return 0
    return sum(len(ids) for ids, _ in parts.values())


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def replica_host() -> str:
    return os.environ.get(REPLICA_HOST_ENV, "") or "127.0.0.1"


def ring_neighbor(
    process_id: int, num_processes: int, slice_map: list[int] | None = None
) -> int:
    """The ring-push target for ``process_id``.

    Single-slice worlds keep the classic ``(i+1) % n``.  On a
    multi-slice world the neighbor is REPINNED to the next process (in
    ring order) living on a DIFFERENT slice, so at least one copy of
    every shard survives a whole-slice preemption: with the classic
    ring, a slice loss takes state and replicas together whenever two
    ring-adjacent processes share a slice."""
    if num_processes < 2:
        return process_id
    if not slice_map or len(set(slice_map)) <= 1:
        return (process_id + 1) % num_processes
    my_slice = slice_map[process_id]
    for hop in range(1, num_processes):
        candidate = (process_id + hop) % num_processes
        if slice_map[candidate] != my_slice:
            return candidate
    return (process_id + 1) % num_processes


class PeerReplicator:
    """One lockstep process's replication: when due, snapshot its share
    of the state, commit it to its own ``store`` and push it to its ring
    neighbor's replica server, whose address the heartbeats bring
    (:meth:`set_peers`); ``generation`` is the world's cluster version,
    ``addr`` this process's own replica server."""

    def __init__(
        self,
        store: ReplicaStore,
        process_id: int,
        num_processes: int,
        generation: int,
        addr: str,
        replication_steps: int = 0,
        num_slices: int = 1,
    ):
        self._store = store
        self._process_id = process_id
        self._num_processes = num_processes
        # the process -> slice map of a multi-slice world ([]: one slice,
        # the classic ring)
        self._slice_map = (
            slice_assignments(num_processes, num_slices) if num_slices > 1 else []
        )
        if len(set(self._slice_map)) <= 1:
            self._slice_map = []
        self._slice_id = self._slice_map[process_id] if self._slice_map else 0
        self._generation = generation
        self._addr = addr
        # pushes are state transfer: the job's deadline policy's transfer
        # tier when the master exported one, else the fixed timeout
        self._deadlines = DeadlinePolicy.from_env()
        self._push_timeout = (
            self._deadlines.transfer_secs
            if self._deadlines is not None
            else PUSH_TIMEOUT_SECS
        )
        # 0 = replicate at EVERY task boundary (the default cadence);
        # N > 0 = at each crossing of a multiple of N, like the checkpointer
        self._steps = max(0, int(replication_steps or 0))
        self._last_milestone = 0
        self._last_version = -1
        # process_id -> replica addr, learned from heartbeat responses
        # (written by the heartbeat thread, read at task boundaries)
        self._peers: dict[int, str] = {}
        self._client: ReplicaClient | None = None
        self._client_addr = ""
        self.pushes = 0
        self.push_failures = 0
        # the last replication's costs: snapshot, encode with CRC, send
        self.last_push: dict = {}

    @property
    def neighbor(self) -> int:
        return ring_neighbor(self._process_id, self._num_processes, self._slice_map)

    def _slice_of(self, process_id: int) -> int:
        return self._slice_map[process_id] if self._slice_map else 0

    # ---- peer discovery (heartbeat thread) ---------------------------------

    def advertisement(self) -> dict:
        """The ``replica`` field of every heartbeat: where this process
        serves shards and what its RAM holds right now."""
        return {
            "addr": self._addr,
            "process_id": self._process_id,
            "slice_id": self._slice_id,
            "generation": self._generation,
            "holdings": self._store.holdings(),
        }

    def set_peers(self, peers: dict):
        if peers:
            self._peers = {int(k): v for k, v in peers.items()}

    def knows_neighbor(self) -> bool:
        return self.neighbor in self._peers

    # ---- replication cadence (training thread, task boundaries) ------------

    def note_restored_version(self, version: int):
        if self._steps:
            self._last_milestone = version // self._steps
        self._last_version = version

    def maybe_replicate(self, trainer, mesh=None) -> bool:
        """Replicate if due.  Call at task boundaries on EVERY process:
        the decision is a pure function of the shared step."""
        if trainer is None:
            return False
        version = int(trainer.step)
        if self._steps:
            milestone = version // self._steps
            if milestone <= self._last_milestone:
                return False
            self._last_milestone = milestone
        elif version <= self._last_version:
            return False
        self.replicate_now(trainer, mesh)
        return True

    def replicate_now(self, trainer, mesh=None):
        version = int(trainer.step)
        self._last_version = version
        t0 = time.perf_counter()
        # the disk checkpoint's split: the chief's shard carries the
        # replicated dense leaves, every shard its own table rows
        dense, parts = elastic.state_checkpoint_parts(
            trainer.state, mesh, materialize_dense=self._process_id == 0
        )
        snapshot_ms = _ms_since(t0)
        t0 = time.perf_counter()
        blob = encode_snapshot(dense, parts)
        shard = ReplicaShard(
            source=self._process_id,
            version=version,
            generation=self._generation,
            checksum=blob_checksum(blob),
            payload=blob,
        )
        encode_ms = _ms_since(t0)
        # local commit FIRST: this process is a harvest source for its
        # own shard even if the neighbor push below fails
        self._store.put(shard)
        # chaos hook: a KILL_DURING_REPLICATION fault dies HERE, after
        # the local commit and before the neighbor holds the new version,
        # so the harvest must see the incomplete set and fall back to an
        # older complete one (or to disk)
        chaos_hooks.notify_replica_push(version)
        t0 = time.perf_counter()
        ok, reason = self._push(shard)
        self.last_push = {
            "version": version,
            "bytes": len(blob),
            "snapshot_ms": snapshot_ms,
            "encode_ms": encode_ms,
            "send_ms": _ms_since(t0),
            "ok": ok,
            "reason": reason,
        }
        chaos_hooks.record_replica_push(
            **self.last_push,
            source=self._process_id,
            target=self.neighbor,
            # the push's slice placement: in a multi-slice world a
            # shard's replica must live on another slice than its owner
            source_slice=self._slice_id,
            target_slice=self._slice_of(self.neighbor),
            num_slices=len(set(self._slice_map)) if self._slice_map else 1,
            checksum=shard.checksum,
            has_sharded=bool(parts),
            sharded_tables=len(parts),
            sharded_rows=_parts_row_count(parts),
        )

    def _push(self, shard: ReplicaShard) -> tuple[bool, str]:
        """Push ``shard`` to the ring neighbor; returns whether it was
        accepted, and why not (the store's refusal reason, or the failed
        call's status code)."""
        if self._num_processes < 2:
            return False, "no_neighbor"
        addr = self._peers.get(self.neighbor, "")
        if not addr:
            # peers not discovered yet (first heartbeat round trip still
            # in flight); the local commit keeps this version
            # harvestable from ONE host meanwhile
            self.push_failures += 1
            logger.warning(
                "Replica push of version %d skipped: process %d's address "
                "is not known yet",
                shard.version,
                self.neighbor,
            )
            return False, "no_address"
        try:
            if self._client is None or self._client_addr != addr:
                self._client = ReplicaClient(addr, deadlines=self._deadlines)
                self._client_addr = addr
            resp = self._client.push_replica(
                msg.PushReplicaRequest(
                    source=shard.source,
                    version=shard.version,
                    generation=shard.generation,
                    checksum=shard.checksum,
                    payload=shard.payload,
                ),
                timeout=self._push_timeout,
            )
            accepted = bool(resp is not None and resp.accepted)
            reason = "" if accepted else getattr(resp, "reason", "")
            if not accepted:
                logger.warning(
                    "Replica push of version %d refused by process %d: %s",
                    shard.version,
                    self.neighbor,
                    reason,
                )
        except Exception as ex:  # noqa: BLE001 — a dead neighbor (or a
            # shard over the message cap) must not crash the pusher; the
            # master's failure detection owns declaring it dead
            logger.warning(
                "Replica push to process %d (%s) failed: %s",
                self.neighbor,
                addr,
                ex,
            )
            code = getattr(ex, "code", None)
            reason = code().name if callable(code) else type(ex).__name__
            accepted = False
        if accepted:
            self.pushes += 1
        else:
            self.push_failures += 1
        return accepted, reason

    def stats(self) -> dict:
        return {
            "pushes": self.pushes,
            "push_failures": self.push_failures,
            "rejected": self._store.rejected,
        }

    def close(self):
        self._client = None


def restore_from_replica(
    trainer,
    master,
    cluster_version: int,
    process_id: int = 0,
    min_version: int | None = None,
) -> int | None:
    """Restore the trainer from the master's harvested replica stage.

    Returns the restored step, or None when there is no stage for this
    generation, or one that must not be used (the caller falls back to
    the disk path): a stage older than ``min_version`` (the newest DISK
    checkpoint: possible only when ``replication_steps`` is coarser than
    ``checkpoint_steps``), so the replica path never loses work
    relative to disk; or one that fails its checksum.

    In the port only process 0 asks (the world then broadcasts its
    state), and its request releases the stage from master RAM.
    """
    try:
        resp = master.get_restore_state(
            msg.GetRestoreStateRequest(
                cluster_version=cluster_version, process_id=process_id
            )
        )
    except Exception as ex:  # noqa: BLE001 — a master without the RPC
        # must degrade to the disk path, not crash
        logger.warning("Replica restore-state query failed: %s", ex)
        return None
    if resp is None or not resp.has:
        return None
    if min_version is not None and int(resp.version) < min_version:
        logger.warning(
            "Replica stage at version %d is older than the disk "
            "checkpoint %d; restoring from disk instead",
            int(resp.version),
            min_version,
        )
        return None
    if blob_checksum(resp.payload) != resp.checksum:
        logger.warning("Replica restore stage failed its checksum; restoring from disk")
        return None
    version = int(resp.version)
    t0 = time.perf_counter()
    dense, parts = decode_snapshot(resp.payload)
    apply_restored_values(trainer, dense, parts, version)
    restore_ms = _ms_since(t0)
    observed = {}
    if chaos_hooks.get_injector() is not None:
        # what the chaos event log proves: the state now held is the
        # stage's, bit for bit (re-snapshotted and re-encoded)
        again, again_parts = elastic.state_checkpoint_parts(trainer.state)
        observed["restored_checksum"] = blob_checksum(encode_snapshot(again, again_parts))
    chaos_hooks.notify_replica_restore(
        version,
        checksum=resp.checksum,
        bytes=len(resp.payload),
        restore_ms=restore_ms,
        sharded_rows=_parts_row_count(parts),
        sharded_tables=len(parts),
        **observed,
    )
    logger.info(
        "Process %d restored state at version %d from peer replica "
        "(generation %d) in %.1f ms",
        process_id,
        version,
        cluster_version,
        restore_ms,
    )
    return version
