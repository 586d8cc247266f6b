"""The user hook for prediction outputs; a copy of
``elasticdl_tpu/worker/prediction_outputs_processor.py``."""

from __future__ import annotations

from abc import ABC, abstractmethod


class BasePredictionOutputsProcessor(ABC):
    """Subclass in the model module as ``PredictionOutputsProcessor`` to
    receive each prediction minibatch's outputs."""

    @abstractmethod
    def process(self, predictions, worker_id):
        """``predictions``: numpy array or dict of arrays for the batch."""
