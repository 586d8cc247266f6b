"""Worker process entry; the counterpart of
``elasticdl_tpu/worker/main.py``.

``python -m elasticdl_tpu_torch.worker.main --master_addr=... --worker_id=N
--coordinator_addr=... --num_processes=... --process_id=...`` joins the
job's ``torch.distributed`` world (``parallel/elastic.py``) and runs the
lockstep loop (``worker/lockstep.py``) against the master's control
plane; without ``--coordinator_addr`` it runs the task-stream worker
(``worker/worker.py``).  The master assembles this argv
(``master/main.py``).  The job runs on the card unless ``--device cpu``
was given; a worker that finds no card raises, and so does a flag whose
feature the port does not have yet (``check_ported_flags``).

With ``--standby 1`` the process is a hot standby (:func:`_standby_wait`):
it pays its imports, then blocks until the master writes its world
assignment as one JSON line on its stdin (with ``EDL_STANDBY_ID`` in its
environment it polls the master's mailbox instead); EOF means the job
ended without it.  A standby creates no CUDA context while it waits:
idle standbys would hold device memory on the card the world's
processes share, and the context is made at the join (the log gives its
seconds beside the rendezvous's).
"""

from __future__ import annotations

import json
import os
import sys
import time

from elasticdl_tpu_torch.rpc.service import MASTER_RETRYABLE_METHODS, MasterClient
from elasticdl_tpu_torch.utils.args import check_ported_flags, parse_worker_args
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# a hot standby reads its assignment on stdin, or polls the master's
# mailbox as this id
STANDBY_ID_ENV = "EDL_STANDBY_ID"


def build_master_client(master_addr: str) -> MasterClient:
    """A client with the per-method deadlines the master exported
    (``--rpc_deadline_secs``), and retries within the budget it exported
    (``--rpc_retry_secs``, implied by ``--master_journal_dir``).  With
    the master's address file in the environment (master high
    availability), a retry re-resolves the address from it, so the
    client follows a relaunched master.  With none of them, the
    fail-fast client."""
    from elasticdl_tpu_torch.master.journal import MASTER_ADDR_FILE_ENV, read_master_addr
    from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
    from elasticdl_tpu_torch.rpc.retry import (
        DEFAULT_RETRY_SECS,
        RETRY_SECS_ENV,
        RetryPolicy,
    )

    deadlines = DeadlinePolicy.from_env()
    budget = os.environ.get(RETRY_SECS_ENV, "")
    addr_file = os.environ.get(MASTER_ADDR_FILE_ENV, "")
    if not budget and not addr_file:
        return MasterClient(master_addr, deadlines=deadlines)
    try:
        budget_secs = float(budget) if budget else DEFAULT_RETRY_SECS
    except ValueError:
        logger.error("Unparseable %s=%r; using %.0f s", RETRY_SECS_ENV, budget, DEFAULT_RETRY_SECS)
        budget_secs = DEFAULT_RETRY_SECS
    return MasterClient(
        master_addr,
        retry=RetryPolicy.from_budget(budget_secs),
        retryable_methods=MASTER_RETRYABLE_METHODS,
        deadlines=deadlines,
        resolve_addr=(lambda: read_master_addr(addr_file)) if addr_file else None,
    )


def _standby_wait(args) -> bool:
    """Hot-standby mode: pay the cold start now (the imports of torch,
    the lockstep chain and the model-zoo module dominate a worker's
    start), then block until the master writes a world assignment as one
    JSON line on stdin.  False on EOF (the master shut the pool down
    without using this process)."""
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec
    from elasticdl_tpu_torch.worker import lockstep  # noqa: F401 — warm the chain

    try:  # the model-zoo import is part of the cold start too
        get_model_spec(args.model_zoo, args.model_def)
    except Exception:  # noqa: BLE001 — the live run will surface it
        pass
    standby_id = os.environ.get(STANDBY_ID_ENV, "")
    logger.info(
        "Standby worker warmed; waiting for a world assignment (%s)",
        f"RPC as {standby_id!r}" if standby_id else "stdin",
    )
    if standby_id:
        assignment = _poll_world_assignment(args, standby_id)
    else:
        line = sys.stdin.readline()
        assignment = json.loads(line) if line.strip() else None
    if assignment is None:
        return False
    for key, value in assignment.items():
        setattr(args, key, value)
    args.standby = 0
    return True


def _poll_world_assignment(
    args, standby_id: str, poll_secs: float = 0.5, max_unreachable_secs: float = 900.0,
) -> dict | None:
    """A standby that cannot read stdin polls the master's mailbox for
    its assignment (the stdin line's keys).  A master unreachable for
    ``max_unreachable_secs`` without a break is taken to be gone, and
    the standby exits cleanly; any answered poll resets that clock."""
    from elasticdl_tpu_torch.rpc import messages as msg
    from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy

    client = MasterClient(args.master_addr, deadlines=DeadlinePolicy.from_env())
    failures = 0
    unreachable_since = None
    while True:
        try:
            resp = client.get_world_assignment(
                msg.GetWorldAssignmentRequest(standby_id=standby_id)
            )
            failures = 0
            unreachable_since = None
        except Exception as ex:  # noqa: BLE001 — a standby outlives a
            # master's blip; crashing here would shrink the pool silently
            failures += 1
            now = time.monotonic()
            if unreachable_since is None:
                unreachable_since = now
            elif max_unreachable_secs > 0 and now - unreachable_since > max_unreachable_secs:
                logger.error(
                    "Standby %s: master unreachable for %.0fs; assuming the job "
                    "is gone and exiting", standby_id, now - unreachable_since,
                )
                return None
            if failures % 60 == 1:
                logger.warning(
                    "Standby %s cannot reach the master (%s); retrying", standby_id, ex
                )
            time.sleep(poll_secs)
            continue
        if resp.has:
            return {
                "worker_id": resp.worker_id,
                "coordinator_addr": resp.coordinator_addr,
                "num_processes": resp.num_processes,
                "process_id": resp.process_id,
                "cluster_version": resp.cluster_version,
                "slice_id": resp.slice_id,
                "num_slices": resp.num_slices,
            }
        if resp.shutdown:
            return None
        time.sleep(poll_secs)


def _join_world(args, activated_at: float | None):
    """Join the world, logging the CUDA context's creation and the
    rendezvous apart (a standby, activated at monotonic ``activated_at``,
    makes its context here)."""
    import torch

    from elasticdl_tpu_torch.parallel import elastic

    started_at = time.monotonic()
    rank_dev = elastic.rank_device(args.device, args.process_id)
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
        torch.empty(1, device=rank_dev)  # the context exists from here
    cuda_at = time.monotonic()
    world = elastic.initialize_world(
        args.coordinator_addr, args.num_processes, args.process_id, device=args.device,
    )
    logger.info(
        "Process %d joined generation %d (%s): CUDA context %.3f s, rendezvous %.3f s%s",
        args.process_id, args.cluster_version,
        "standby" if activated_at else "cold start", cuda_at - started_at,
        time.monotonic() - cuda_at,
        f", {started_at - activated_at:.3f} s after its assignment" if activated_at else "",
    )
    return world


def main(argv=None) -> int:
    args = parse_worker_args(argv)
    check_ported_flags(args)
    resolve_device(args.device)  # no card where one is asked for: raise
    activated_at = None
    if args.standby:
        if not _standby_wait(args):
            return 0
        activated_at = time.monotonic()
    if not args.coordinator_addr:
        from elasticdl_tpu_torch.worker.worker import Worker

        logger.info(
            "Worker %d (task stream) connecting to master at %s",
            args.worker_id, args.master_addr,
        )
        Worker(args, build_master_client(args.master_addr)).run()
        return 0
    from elasticdl_tpu_torch.parallel import elastic
    from elasticdl_tpu_torch.worker.lockstep import LockstepWorker

    logger.info(
        "Worker %d (process %d/%d, generation %d) connecting to master at %s",
        args.worker_id, args.process_id, args.num_processes,
        args.cluster_version, args.master_addr,
    )
    client = build_master_client(args.master_addr)
    world = _join_world(args, activated_at)
    LockstepWorker(args, client, world).run()
    # a clean end only: after a failure the peers may be gone, and the
    # process exits with the error instead
    elastic.shutdown_world()
    return 0


if __name__ == "__main__":
    sys.exit(main())
