"""The census-income DNN, sequential style; the port of
``elasticdl_tpu/models/census_dnn_model/census_sequential.py``: the
functional variant's network and contract under the sequential entry
point."""

from elasticdl_tpu_torch.models.census_dnn_model.census_functional_api import (  # noqa: F401,E501
    CensusDNN,
    batch_parse,
    custom_model,
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
)
