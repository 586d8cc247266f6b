"""The census-income DNN, subclass style; the port of
``elasticdl_tpu/models/census_dnn_model/census_subclass.py``: the
functional variant's network as ``CustomModel``."""

from elasticdl_tpu_torch.models.census_dnn_model.census_functional_api import (  # noqa: F401,E501
    CensusDNN,
    batch_parse,
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
)


class CustomModel(CensusDNN):
    pass


def custom_model(**kwargs):
    return CustomModel(**kwargs)
