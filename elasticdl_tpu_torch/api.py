"""Job-submission API: the backend of the port's CLI; the counterpart of
``elasticdl_tpu/api.py``.

The strategies map as in the JAX package:

- ``Local``: a :class:`LocalExecutor` in this process.
- ``AllreduceStrategy`` / ``ParameterServerStrategy``: a master control
  plane in this process with the workers as local subprocesses
  (``master/main.py``): two or more form one ``torch.distributed``
  world, one is the task-stream worker.

Each runs every job type: ``train`` (with ``--validation_data`` the
job also evaluates), ``evaluate`` and ``predict``.  Kubernetes
submission, predicting through a running serving endpoint
(``--serving_addr``) and the flags of the slices still to come raise,
naming the slice of ``ROADMAP.md`` queue 1 that brings them
(``utils/args.py::check_ported_flags``).
"""

from __future__ import annotations

from elasticdl_tpu_torch.utils.constants import DistributionStrategy


def _run_local(args) -> dict:
    from elasticdl_tpu_torch.trainer.local_executor import LocalExecutor

    return LocalExecutor(args).run()


def _run_distributed(args) -> dict:
    from elasticdl_tpu_torch.master.main import main as master_main
    from elasticdl_tpu_torch.utils.args import build_arguments_from_parsed_result

    rc = master_main(build_arguments_from_parsed_result(args))
    if rc != 0:
        raise RuntimeError(f"master exited with {rc}")
    return {"exit_code": rc}


def _dispatch(args) -> dict:
    if args.distribution_strategy == DistributionStrategy.LOCAL:
        return _run_local(args)
    # Kubernetes flags (an image, a repository, a manifest) raise in
    # check_ported_flags when the master is built
    return _run_distributed(args)


def train(args) -> dict:
    if not getattr(args, "training_data", ""):
        raise ValueError("train requires --training_data")
    return _dispatch(args)


def evaluate(args) -> dict:
    """An evaluation-only job over a checkpoint."""
    if not getattr(args, "validation_data", ""):
        raise ValueError("evaluate requires --validation_data")
    args.training_data = ""
    return _dispatch(args)


def predict(args) -> dict:
    if not getattr(args, "prediction_data", ""):
        raise ValueError("predict requires --prediction_data")
    args.training_data = ""
    args.validation_data = ""
    return _dispatch(args)


def clean() -> dict:
    """The JAX package's ``clean`` removes a job's docker images; the port
    builds none, so there is nothing to remove."""
    return {"removed": []}
