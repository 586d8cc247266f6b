"""Job-submission API: the backend of the port's CLI; the counterpart of
``elasticdl_tpu/api.py``.

``train``/``evaluate``/``predict`` run a :class:`LocalExecutor` in this
process (the ``Local`` strategy).  The JAX package's other strategies (a
master with worker processes, Kubernetes submission) and predicting
through a running serving endpoint (``--serving_addr``) raise, naming the
slice of ``ROADMAP.md`` queue 1 that brings them
(``utils/args.py::check_ported_flags``).
"""

from __future__ import annotations


def _dispatch(args) -> dict:
    # a strategy other than Local, like every other flag whose feature is
    # not ported, raises when the executor is built
    from elasticdl_tpu_torch.trainer.local_executor import LocalExecutor

    return LocalExecutor(args).run()


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
    builds none (it runs Local jobs only), so there is nothing to
    remove."""
    return {"removed": []}
