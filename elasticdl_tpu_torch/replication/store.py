"""In-RAM replica shard store, what a worker's replica server serves;
the counterpart of ``elasticdl_tpu/replication/store.py``.

One store per lockstep process, holding the newest verified shards per
SOURCE process: its own snapshot (committed locally at replication
time) plus whatever ring neighbors pushed.  Commits are atomic under a
lock and gated on checksum and generation, so a torn push (the sender
SIGKILLed mid-transfer, a truncated payload) can never shadow the last
good version: the freshest COMPLETE set is always servable.  The JAX
package also reports the store's bytes to its memory ledger, which
comes with the telemetry slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from elasticdl_tpu_torch.replication.blob import blob_checksum
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger


@dataclass(frozen=True)
class ReplicaShard:
    """One host's encoded state shard at one (version, generation)."""

    source: int
    version: int
    generation: int
    checksum: str
    payload: bytes


class ReplicaStore:
    """Holds the ``KEEP_VERSIONS`` newest verified shards per source.

    Keeping more than one version matters: a host commits its own new
    snapshot BEFORE the neighbor acknowledges the push, so with a
    keep-latest-only store a death in that window would destroy the last
    COMPLETE replica set (own shard already at v_new, peer's copy still
    v_old) and force a disk fallback.  With two versions retained, the
    harvest can still assemble the older complete set.
    """

    KEEP_VERSIONS = 2

    def __init__(self, generation: int = 0):
        self._generation = generation
        # source -> {version -> shard}, at most KEEP_VERSIONS newest
        self._shards: dict[int, dict[int, ReplicaShard]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # torn / stale pushes refused; unlocked reads are fine, increments
        # take the lock (+= on a shared int is not atomic)
        self.rejected = 0  # guarded-by: _lock (writes)

    def put(self, shard: ReplicaShard) -> tuple[bool, str]:
        """Commit a shard; returns ``(accepted, reason)``.

        Refuses: checksum mismatch (torn transfer), a generation other
        than this store's world (stale pusher after a re-formation), and
        duplicates / versions older than everything retained (a late
        copy must not evict a fresher shard).
        """
        if blob_checksum(shard.payload) != shard.checksum:
            with self._lock:
                self.rejected += 1
            logger.warning(
                "Replica shard source=%d version=%d refused: checksum "
                "mismatch (torn transfer)",
                shard.source,
                shard.version,
            )
            return False, "checksum_mismatch"
        if shard.generation != self._generation:
            with self._lock:
                self.rejected += 1
            return False, "generation_mismatch"
        with self._lock:
            held = self._shards.setdefault(shard.source, {})
            if shard.version in held or (
                len(held) >= self.KEEP_VERSIONS and shard.version < min(held)
            ):
                self.rejected += 1
                return False, "stale_version"
            held[shard.version] = shard
            while len(held) > self.KEEP_VERSIONS:
                del held[min(held)]
        return True, ""

    def get(self, source: int, version: int | None = None) -> ReplicaShard | None:
        """The newest shard for ``source``, or the exact ``version``."""
        with self._lock:
            held = self._shards.get(source)
            if not held:
                return None
            if version is None:
                return held[max(held)]
            return held.get(version)

    def versions(self, source: int) -> list[int]:
        with self._lock:
            return sorted(self._shards.get(source, ()))

    def holdings(self) -> list[dict]:
        """Metadata of the newest shard per source (the heartbeat
        advertisement; the harvest reads full version sets by probe)."""
        with self._lock:
            out = []
            for held in self._shards.values():
                shard = held[max(held)]
                out.append(
                    {
                        "source": shard.source,
                        "version": shard.version,
                        "generation": shard.generation,
                        "checksum": shard.checksum,
                    }
                )
            return out
