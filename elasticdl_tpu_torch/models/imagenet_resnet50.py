"""ImageNet data prep for the ResNet-50 model; the port of
``elasticdl_tpu/models/imagenet_resnet50.py``.

The model and its contract are ``resnet50_subclass``'s, at 1000
classes.  :func:`prepare_data_for_a_single_file` packs a
``<label>_xxx.JPEG`` file into a labelled record of the decoded
``(224, 224, 3)`` pixels.  PIL is imported when a file is prepared, not
with the module, so the model trains where PIL is absent; preparing
without PIL, or from bytes that do not decode, raises, so a corrupt
dataset is never written.
"""

from __future__ import annotations

import io

import numpy as np

from elasticdl_tpu_torch.data.reader import encode_example

# the model's contract, so that --model_def imagenet_resnet50... resolves
from elasticdl_tpu_torch.models.resnet50_subclass import (  # noqa: F401
    CustomModel,
    batch_parse,
    dataset_fn,
    device_parse,
    eval_metrics_fn,
    loss,
    optimizer,
)


def custom_model(num_classes=1000, **kwargs):
    return CustomModel(num_classes=num_classes, **kwargs)


def prepare_data_for_a_single_file(file_object, filename: str) -> bytes:
    """A ``<label_id>_xxx.JPEG`` file as an encoded record."""
    label = int(filename.split("/")[-1].split("_")[0])
    payload = file_object.read()
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "imagenet data prep needs PIL to decode JPEGs; records must "
            "carry dense (224,224,3) arrays for resnet50's dataset_fn"
        ) from e
    try:
        img = Image.open(io.BytesIO(payload)).convert("RGB")
    except Exception as e:
        raise ValueError(f"{filename}: not a decodable image: {e}") from e
    image = np.asarray(img.resize((224, 224)), dtype=np.uint8)
    return encode_example({"image": image, "label": np.int64(label)})
