"""Master process entry; the counterpart of
``elasticdl_tpu/master/main.py``.

``python -m elasticdl_tpu_torch.master.main --model_def=... --training_data=...
--distribution_strategy AllreduceStrategy --num_workers 2`` starts the
control plane and spawns the workers as local subprocesses, wired back
over ``rpc/service.py``; ``api.py`` runs it in the CLI's process, for
every job type: training, training with evaluation
(``--validation_data``), evaluation only and prediction only.
"""

from __future__ import annotations

import sys

from elasticdl_tpu_torch.master.master import LocalInstanceManager, Master
from elasticdl_tpu_torch.utils.args import (
    build_worker_arguments,
    check_ported_flags,
    parse_master_args,
)
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger


def worker_envs(args) -> dict[str, str]:
    """The environment the master adds to every worker's: ``--envs``,
    the RPC retry budget and deadlines, the device pipeline's flags
    (``--device_prefetch``, ``--boundary_fusion``, ``--pipeline_depth``),
    and with ``--master_journal_dir`` the master's address file (which
    also implies the retry budget that carries a worker across a master
    outage).  They travel by env, never argv, so that every process of a
    world resolves them alike and worker argv is the same with or
    without them."""
    from elasticdl_tpu_torch.master.journal import MASTER_ADDR_FILE_ENV, addr_file_path
    from elasticdl_tpu_torch.rpc.deadline import DEADLINE_SECS_ENV
    from elasticdl_tpu_torch.rpc.retry import DEFAULT_RETRY_SECS, RETRY_SECS_ENV
    from elasticdl_tpu_torch.trainer import device_pipeline as dp

    envs = dict(args.envs_dict)
    if args.device_prefetch:
        envs.setdefault(dp.DEVICE_PREFETCH_ENV, "1")
    if args.boundary_fusion:
        envs.setdefault(dp.BOUNDARY_FUSION_ENV, "1")
    if args.pipeline_depth is not None:
        envs.setdefault(dp.PIPELINE_DEPTH_ENV, str(args.pipeline_depth))
    if args.master_journal_dir:
        envs.setdefault(MASTER_ADDR_FILE_ENV, addr_file_path(args.master_journal_dir))
    if args.rpc_retry_secs is not None or args.master_journal_dir:
        retry_secs = args.rpc_retry_secs
        envs.setdefault(
            RETRY_SECS_ENV, str(DEFAULT_RETRY_SECS if retry_secs is None else retry_secs)
        )
    if args.rpc_deadline_secs is not None:
        envs.setdefault(DEADLINE_SECS_ENV, str(args.rpc_deadline_secs))
    return envs


def build_master(args) -> Master:
    """A Master with its local instance manager (exposed so tests and
    embedding callers can drive the lifecycle); with ``--num_workers 0``
    none, and the workers are started elsewhere.  Refuses what the port
    cannot run yet (``check_ported_flags``)."""
    check_ported_flags(args)

    def build_argv(worker_id, master_addr, **world_kwargs):
        argv = [
            "elasticdl_tpu_torch.worker.main",
            *build_worker_arguments(args, worker_id, master_addr),
        ]
        # the world coordinates, per process and per generation
        for key, value in world_kwargs.items():
            argv.extend([f"--{key}", str(value)])
        return argv

    def im_factory(master):
        if args.num_workers <= 0:
            return None
        return LocalInstanceManager(
            master,
            args.num_workers,
            build_argv,
            envs=worker_envs(args),
            # two or more workers train one model as one world; one is
            # the task-stream worker
            lockstep=args.num_workers > 1,
            max_reforms=args.relaunch_on_worker_failure,
            # -1: a warm standby per process of a lockstep world
            standby_workers=args.standby_workers,
            # the fleet split into slices; None is one slice
            num_slices=args.num_slices or 1,
        )

    return Master(args, instance_manager_factory=im_factory)


def main(argv=None) -> int:
    args = parse_master_args(argv)
    master = build_master(args)
    master.prepare()
    logger.info(
        "Master ready on port %d (job type %s)", master.port, master.job_type.value
    )
    rc = master.run()
    logger.info("Job summary: %s", master.job_summary())
    return rc


if __name__ == "__main__":
    sys.exit(main())
