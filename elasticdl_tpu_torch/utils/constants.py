"""The vocabulary of strategies, job types and task types; a copy of the
part of ``elasticdl_tpu/utils/constants.py`` the port uses, so that the
CLI, the task dispatcher and the executor speak the JAX package's
words."""

from __future__ import annotations

import enum


class JobType(enum.Enum):
    TRAINING_ONLY = "training_only"
    EVALUATION_ONLY = "evaluation_only"
    PREDICTION_ONLY = "prediction_only"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"


class TaskType(enum.IntEnum):
    """Work-unit types served by the task dispatcher; WAIT is the 'no
    task right now, poll again' answer a master gives while evaluation
    tasks are pending."""

    TRAINING = 0
    EVALUATION = 1
    PREDICTION = 2
    WAIT = 3
    SAVE_MODEL = 4


class DistributionStrategy:
    """User-selectable strategies.  The port runs ``Local`` only; the
    other two come with the master and its workers."""

    LOCAL = "Local"
    PARAMETER_SERVER = "ParameterServerStrategy"
    ALLREDUCE = "AllreduceStrategy"

    ALL = (LOCAL, PARAMETER_SERVER, ALLREDUCE)


# Default port the master control-plane service listens on.
MASTER_DEFAULT_PORT = 50001

# Times the task-stream worker retries a minibatch after a failure
# before it reports the failure with the task.
MAX_MINIBATCH_RETRY_NUM = 64
