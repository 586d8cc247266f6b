"""Worker-side replica service: the ring-push receiver and the harvest's
source; the counterpart of ``elasticdl_tpu/replication/service.py``.

It rides the job's socket transport (``rpc/service.py``) under its own
method table, so a replica push has the discipline of every other
control-plane call (status codes, deadlines, the 256 MiB message cap:
a shard over it is refused by the sender's client with
``RESOURCE_EXHAUSTED``).  The servicer is transport-agnostic like
``MasterServicer``: unit tests call it directly.
"""

from __future__ import annotations

from elasticdl_tpu_torch.replication.store import ReplicaShard, ReplicaStore
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc.service import RpcClient, RpcServer, create_server

REPLICA_SERVICE_NAME = "elasticdl_tpu.Replica"

REPLICA_METHODS = (
    "push_replica",
    "fetch_replica",
)


class ReplicaServicer:
    """Serves one process's :class:`ReplicaStore`.

    ``fetch_replica`` answers with whatever the store CURRENTLY holds
    for the requested source: the master's harvest trusts fetched
    metadata, not heartbeat-lagged advertisements, so a push that
    completed milliseconds before a preemption is still harvestable.
    """

    def __init__(self, store: ReplicaStore):
        self._store = store

    @property
    def store(self) -> ReplicaStore:
        return self._store

    def push_replica(self, request: msg.PushReplicaRequest) -> msg.PushReplicaResponse:
        accepted, reason = self._store.put(
            ReplicaShard(
                source=request.source,
                version=request.version,
                generation=request.generation,
                checksum=request.checksum,
                payload=request.payload,
            )
        )
        return msg.PushReplicaResponse(accepted=accepted, reason=reason)

    def fetch_replica(self, request: msg.FetchReplicaRequest) -> msg.FetchReplicaResponse:
        version = None if request.version < 0 else request.version
        shard = self._store.get(request.source, version=version)
        if shard is None:
            return msg.FetchReplicaResponse(source=request.source)
        return msg.FetchReplicaResponse(
            has=True,
            source=shard.source,
            version=shard.version,
            generation=shard.generation,
            checksum=shard.checksum,
            payload=b"" if request.probe else shard.payload,
            versions=self._store.versions(request.source),
        )


def start_replica_server(store: ReplicaStore, port: int = 0) -> tuple[RpcServer, int]:
    """Bind and start a replica server on ``port`` (0: a free one);
    returns ``(server, bound_port)``.  Its callers are one ring neighbor
    and, at a re-formation, the master's harvest."""
    server = create_server(
        ReplicaServicer(store),
        port,
        methods=REPLICA_METHODS,
        service_name=REPLICA_SERVICE_NAME,
    )
    server.start()
    return server, server.port


class ReplicaClient(RpcClient):
    """Stub for one peer's replica server (ring push, harvest pull).

    ``deadlines`` is the job-wide ``rpc/deadline.py`` policy: pushes
    and fetches are state transfer, so its transfer tier applies when a
    caller passes no timeout.  Each call is one connection: there is
    nothing to close."""

    def __init__(self, addr: str, deadlines=None):
        super().__init__(addr, methods=REPLICA_METHODS, deadlines=deadlines)

    def push_replica(
        self, request: msg.PushReplicaRequest, timeout: float | None = None
    ) -> msg.PushReplicaResponse:
        return self._call("push_replica", request, timeout=timeout)

    def fetch_replica(
        self, request: msg.FetchReplicaRequest, timeout: float | None = None
    ) -> msg.FetchReplicaResponse:
        return self._call("fetch_replica", request, timeout=timeout)
