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
"""

from __future__ import annotations

import os
import sys

from elasticdl_tpu_torch.rpc.service import MASTER_RETRYABLE_METHODS, MasterClient
from elasticdl_tpu_torch.utils.args import check_ported_flags, parse_worker_args
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger


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


def main(argv=None) -> int:
    args = parse_worker_args(argv)
    check_ported_flags(args)
    resolve_device(args.device)  # no card where one is asked for: raise
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
    world = elastic.initialize_world(
        args.coordinator_addr, args.num_processes, args.process_id,
        device=args.device,
    )
    LockstepWorker(args, client, world).run()
    # a clean end only: after a failure the peers may be gone, and the
    # process exits with the error instead
    elastic.shutdown_world()
    return 0


if __name__ == "__main__":
    sys.exit(main())
