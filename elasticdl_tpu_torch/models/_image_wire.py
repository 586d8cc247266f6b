"""The uint8-wire parse pair of the image models; the counterpart of
``elasticdl_tpu/models/_image_wire.py``.

Every image model decodes the same record schema (``image`` uint8,
``label`` int64) and normalises with /255.  :func:`batch_parse` ships
images at their on-disk uint8 (a quarter of the bytes of f32 on the
way to the device); :func:`device_parse` runs inside the step, on the
device, and gives the f32/255 input ``dataset_fn`` would have made on
the host.

Model modules re-export both names; ``get_model_spec`` picks them up off
the module like any other spec function.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticdl_tpu_torch.trainer.state import Modes


def batch_parse(example_batch, mode):
    """The batched ``dataset_fn`` (``data/fast_pipeline.py``): uint8
    images and int32 labels; the normalisation waits for
    :func:`device_parse`."""
    if mode == Modes.PREDICTION:
        return {"image": example_batch["image"]}
    return (
        {"image": example_batch["image"]},
        example_batch["label"].astype(np.int32),
    )


def device_parse(features):
    """The device-side half of :func:`batch_parse`: uint8 images to the
    f32/255 input the model trains on (``dataset_fn``'s arithmetic)."""
    return {"image": features["image"].to(torch.float32) / 255.0}
