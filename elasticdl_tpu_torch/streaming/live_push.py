"""The live train-to-serve push: the replica ring feeding serving; the
counterpart of ``elasticdl_tpu/streaming/live_push.py``.

A streaming job has no epochs and no checkpoints (the replica ring is
its durability), so "deploy the latest model" cannot mean "export a
directory and swap to it".  Instead the master, which already pulls a
complete verified state off the ring for a re-formation
(``replication/directory.py::ReplicaDirectory.harvest``), harvests it
outside re-formation too: whenever the model version passes the last
push, it takes the freshest complete snapshot from the live workers'
replica servers and sends the encoded blob inline to serving's
``swap_model`` (``SwapModelRequest.payload``).  The replica decodes it
and swaps it in through ``engine.swap_state_dicts``: same parameters,
same placement, no new input shape, requests in flight finishing on
the old version.

``--live_push_addr`` may name one replica or the serving frontend:
``swap_model`` is a versioned put either way, so a push delivered twice
is refused as stale the second time, which the pusher counts as
converged.

Every attempt goes to the freshness ledger through
``MasterTelemetry.live_push``: the trained watermark at the push beside
the source watermark is the served model's staleness, which the
``freshness_monotone`` chaos invariant and the report's streaming
section read.
"""

from __future__ import annotations

import time

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# a failed harvest (a worker mid-push) retries on a later tick; this
# floor keeps the pusher from probing the replica servers every poll
# while the ring catches up
MIN_ATTEMPT_INTERVAL_SECS = 1.0


class LivePusher:
    """Pushes harvested replica snapshots into serving when the model
    version advances.

    Owned by the master and ticked from its run loop.  It keeps no state
    across master restarts: a restarted master pushes the current
    version once more, and serving's version guard absorbs it as stale."""

    def __init__(
        self,
        addr: str,
        directory,
        telemetry=None,
        deadlines=None,
        min_interval_secs: float = MIN_ATTEMPT_INTERVAL_SECS,
        clock=time.monotonic,
    ):
        self._addr = addr
        self._directory = directory
        self._telemetry = telemetry
        self._deadlines = deadlines
        self._min_interval = float(min_interval_secs)
        self._clock = clock
        self._last_pushed_version = -1
        self._last_attempt = float("-inf")
        self.pushes_accepted = 0
        self.pushes_refused = 0
        self.harvest_skips = 0

    @property
    def last_pushed_version(self) -> int:
        return self._last_pushed_version

    def push_due(self, model_version: int) -> bool:
        """Whether ``model_version`` is past the last pushed one.  Version
        0: nothing trained, so no worker holds a replica; probing the
        ring would only warn every tick through the first step."""
        return int(model_version) > max(self._last_pushed_version, 0)

    def tick(
        self,
        *,
        model_version: int,
        generation: int,
        num_sources: int,
        live_worker_ids: list,
        stream_status: dict | None = None,
    ) -> bool:
        """One run-loop tick: harvest and push if the version advanced.
        True when a push was accepted, or absorbed as stale (serving is
        at or past this version either way)."""
        if not self.push_due(model_version):
            return False
        now = self._clock()
        if now - self._last_attempt < self._min_interval:
            return False
        self._last_attempt = now
        try:
            stage = self._directory.harvest(
                live_worker_ids=list(live_worker_ids),
                num_sources=int(num_sources),
                generation=int(generation),
                staged_for=int(generation),
            )
        except Exception:  # noqa: BLE001 — a push never takes the master
            # down; the next tick retries
            logger.exception("Live push: harvest failed; will retry")
            return False
        if stage is None:
            # incomplete coverage (a worker mid-push, or just preempted):
            # the ring converges and a later tick pushes
            self.harvest_skips += 1
            return False
        version = int(stage["version"])
        if version <= self._last_pushed_version:
            # the ring has not caught up with the reported version yet
            return False
        return self._push(version, stage["payload"], stream_status)

    def _push(self, version: int, payload: bytes, stream_status) -> bool:
        from elasticdl_tpu_torch.rpc import messages as msg
        from elasticdl_tpu_torch.serving.replica import ServingClient

        status = stream_status or {}
        trained = int(status.get("trained_watermark", -1))
        source_wm = int(status.get("source_watermark", -1))
        t0 = time.monotonic()
        client = None
        try:
            client = ServingClient(self._addr, deadlines=self._deadlines)
            resp = client.swap_model(
                msg.SwapModelRequest(
                    payload=payload,
                    version=version,
                    source=f"live-push@{trained}",
                    trained_watermark=trained,
                    source_watermark=source_wm,
                )
            )
        except Exception as ex:  # noqa: BLE001 — serving being down must
            # not stall training; the next version advance retries
            logger.warning("Live push of version %d failed: %s", version, ex)
            self._note(version, trained, source_wm, False, t0, str(ex))
            return False
        finally:
            if client is not None:
                client.close()
        # stale: serving is already at or past this version (a replayed
        # push, or another master's)
        converged = bool(resp.accepted or resp.stale)
        if converged:
            self._last_pushed_version = version
            self.pushes_accepted += 1
        else:
            self.pushes_refused += 1
            logger.warning("Live push of version %d refused: %s", version, resp.reason)
        self._note(version, trained, source_wm, bool(resp.accepted), t0, resp.reason)
        return converged

    def _note(self, version, trained, source_wm, accepted, t0, reason):
        if self._telemetry is None:
            return
        self._telemetry.live_push(
            model_version=version,
            trained_watermark=trained,
            source_watermark=source_wm,
            accepted=accepted,
            replica=self._addr,
            swap_ms=(time.monotonic() - t0) * 1000.0,
            started_at=t0,
            reason=reason or "",
        )
