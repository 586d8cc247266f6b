"""Master-side replica directory and re-formation harvest; the
counterpart of ``elasticdl_tpu/replication/directory.py``.

The directory is the master's view of where replica shards live: every
worker heartbeat carries its replica server's address and current
holdings (:meth:`~.replicator.PeerReplicator.advertisement`), and the
directory answers two questions:

- ``peers(generation)``: the process -> address map heartbeat
  RESPONSES carry back down, so ring pushers find their neighbors with
  no new RPC;
- ``harvest(...)``: at a re-formation, fetch the freshest COMPLETE
  replica set out of the survivors' RAM and merge it into one staged
  restore payload.

The harvest trusts FETCHED metadata, not advertised holdings:
heartbeats lag by their interval, and the point is recovering a push
that landed milliseconds before the preemption.  Advertised holdings
feed :meth:`ReplicaDirectory.coverage_stats` (the job summary's
``replication``).

Generation fencing, as everywhere: holdings and shards are tagged with
the world generation they were made in; a harvest for generation
``g+1`` accepts only shards of generation ``g``, and the staged payload
is served only to workers presenting ``g+1``.
"""

from __future__ import annotations

import threading

from elasticdl_tpu_torch.replication.blob import (
    blob_checksum,
    decode_snapshot,
    encode_snapshot,
    merge_snapshots,
)
from elasticdl_tpu_torch.replication.service import ReplicaClient
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

FETCH_TIMEOUT_SECS = 30.0


class ReplicaDirectory:
    def __init__(self, deadlines=None):
        # the job-wide DeadlinePolicy (rpc/deadline.py): harvest probes and
        # fetches are state transfer, so its transfer tier replaces the
        # fixed FETCH_TIMEOUT_SECS when the master has --rpc_deadline_secs
        self._deadlines = deadlines
        self._fetch_timeout = (
            deadlines.transfer_secs if deadlines is not None else FETCH_TIMEOUT_SECS
        )
        self._lock = threading.Lock()
        # worker_id -> latest advertisement ({"addr", "process_id",
        # "generation", "holdings"}); written by heartbeat handler
        # threads, read by the harvest
        self._ads: dict[int, dict] = {}  # guarded-by: _lock
        # generation -> pushes observed (holdings versions advancing)
        self._pushes_by_generation: dict[int, int] = {}  # guarded-by: _lock
        self._last_versions: dict[tuple[int, int], int] = {}  # guarded-by: _lock
        self.harvests = 0
        self.harvest_failures = 0

    # ---- heartbeat plumbing ------------------------------------------------

    def update(self, worker_id: int, replica: dict):
        if not replica or "addr" not in replica:
            return
        with self._lock:
            self._ads[worker_id] = dict(replica)
            generation = int(replica.get("generation", 0))
            for holding in replica.get("holdings", ()):
                # a holding whose version advanced since the last
                # advertisement is one completed push or commit
                key = (int(holding.get("source", -1)), generation)
                version = int(holding.get("version", -1))
                if version > self._last_versions.get(key, -1):
                    self._last_versions[key] = version
                    self._pushes_by_generation[generation] = (
                        self._pushes_by_generation.get(generation, 0) + 1
                    )

    def forget_worker(self, worker_id: int):
        with self._lock:
            self._ads.pop(worker_id, None)

    def peers(self, generation: int) -> dict[str, str]:
        """process_id -> replica address for the advertisements of this
        generation (what heartbeat responses carry to ring pushers).
        The keys are STRINGS, as in the JAX package (msgpack refuses int
        map keys there; JSON object keys are strings here)."""
        with self._lock:
            return {
                str(int(ad["process_id"])): ad["addr"]
                for ad in self._ads.values()
                if int(ad.get("generation", -1)) == generation
            }

    # ---- observability -----------------------------------------------------

    def coverage_stats(self) -> dict:
        """Replica coverage as advertised: hosts covered per generation,
        shard versions held, pushes observed, harvests."""
        with self._lock:
            by_gen: dict[int, dict] = {}
            for ad in self._ads.values():
                generation = int(ad.get("generation", 0))
                gen = by_gen.setdefault(generation, {"hosts": set(), "shard_versions": {}})
                gen["hosts"].add(int(ad.get("process_id", -1)))
                for holding in ad.get("holdings", ()):  # freshest per source
                    source = int(holding.get("source", -1))
                    version = int(holding.get("version", -1))
                    if version > gen["shard_versions"].get(source, -1):
                        gen["shard_versions"][source] = version
            return {
                "generations": {
                    generation: {
                        "hosts_covered": sorted(gen["hosts"]),
                        "shard_versions": {
                            str(src): v for src, v in sorted(gen["shard_versions"].items())
                        },
                    }
                    for generation, gen in sorted(by_gen.items())
                },
                "pushes_by_generation": {
                    str(g): n for g, n in sorted(self._pushes_by_generation.items())
                },
                "harvests": self.harvests,
                "harvest_failures": self.harvest_failures,
            }

    # ---- re-formation harvest ----------------------------------------------

    def harvest(
        self,
        live_worker_ids: list[int],
        num_sources: int,
        generation: int,
        staged_for: int,
    ) -> dict | None:
        """Pull the freshest complete replica set from the survivors.

        ``num_sources``: how many process shards compose the state (the
        OLD world size); ``generation``: the world generation the shards
        were made in; ``staged_for``: the generation that may restore
        from the result.  Returns a stage dict ``{"generation",
        "version", "checksum", "payload", "sources"}`` or None when no
        complete verified set exists (the disk fallback).
        """
        live = set(live_worker_ids)
        with self._lock:
            addrs = sorted(
                {
                    ad["addr"]
                    for wid, ad in self._ads.items()
                    if wid in live and int(ad.get("generation", -1)) == generation
                }
            )
        if not addrs:
            self.harvest_failures += 1
            logger.warning(
                "Replica harvest: no live replica servers advertised for "
                "generation %d; falling back to disk",
                generation,
            )
            return None
        clients = [(addr, ReplicaClient(addr, deadlines=self._deadlines)) for addr in addrs]
        # probe every live server for every source's metadata (ALL
        # retained versions, not just the newest: an older shard may be
        # the only complete set left after a mid-push death), then pick
        # the highest version with COMPLETE coverage
        offers: dict[int, list[tuple[int, object, str]]] = {}
        for addr, client in clients:
            for source in range(num_sources):
                meta = self._probe(client, source, generation)
                if meta is None:
                    continue
                for version in meta.versions or [meta.version]:
                    offers.setdefault(source, []).append((version, client, addr))
        version = self._complete_version(offers, num_sources)
        if version is None:
            self.harvest_failures += 1
            logger.warning(
                "Replica harvest: coverage incomplete for generation %d "
                "(sources offered: %s of %d); falling back to disk",
                generation,
                sorted(offers),
                num_sources,
            )
            return None
        snapshots = []
        for source in range(num_sources):
            shard = self._fetch(offers[source], source, version, generation)
            if shard is None:
                self.harvest_failures += 1
                logger.warning(
                    "Replica harvest: shard %d@%d vanished mid-harvest; "
                    "falling back to disk",
                    source,
                    version,
                )
                return None
            snapshots.append(decode_snapshot(shard.payload))
        dense, parts = merge_snapshots(snapshots)
        payload = encode_snapshot(dense, parts)
        self.harvests += 1
        return {
            "generation": staged_for,
            "version": version,
            "checksum": blob_checksum(payload),
            "payload": payload,
            "sources": num_sources,
        }

    def _probe(self, client, source: int, generation: int):
        try:
            resp = client.fetch_replica(
                msg.FetchReplicaRequest(source=source, probe=True),
                timeout=self._fetch_timeout,
            )
        except Exception as ex:  # noqa: BLE001 — a dying survivor is a
            # missing offer, not a harvest crash
            logger.warning("Replica probe for source %d failed: %s", source, ex)
            return None
        if resp is None or not resp.has or resp.generation != generation:
            return None
        return resp

    @staticmethod
    def _complete_version(offers: dict[int, list], num_sources: int) -> int | None:
        """Highest version every source has at least one offer for."""
        if set(offers) != set(range(num_sources)):
            return None
        candidates = set.intersection(
            *({v for v, _c, _a in offer} for offer in offers.values())
        )
        return max(candidates) if candidates else None

    def _fetch(self, offer_list, source: int, version: int, generation: int):
        """Fetch and verify one shard from any holder that offered it."""
        for offered_version, client, addr in offer_list:
            if offered_version != version:
                continue
            try:
                resp = client.fetch_replica(
                    msg.FetchReplicaRequest(source=source, version=version),
                    timeout=self._fetch_timeout,
                )
            except Exception:  # noqa: BLE001 — try the next holder
                continue
            if (
                resp is None
                or not resp.has
                or resp.version != version
                or resp.generation != generation
                or blob_checksum(resp.payload) != resp.checksum
            ):
                logger.warning(
                    "Replica harvest: shard %d@%d from %s torn or stale; "
                    "trying another holder",
                    source,
                    version,
                    addr,
                )
                continue
            return resp
        return None
