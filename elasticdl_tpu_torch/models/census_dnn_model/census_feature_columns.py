"""The census feature columns of the census model variants; the port of
``elasticdl_tpu/models/census_dnn_model/census_feature_columns.py``:
4 numeric columns and 8 categorical keys hashed into 64 buckets and
embedded at dimension 16."""

from __future__ import annotations

from elasticdl_tpu_torch import feature_column as fc

CATEGORICAL_FEATURE_KEYS = [
    "workclass",
    "education",
    "marital-status",
    "occupation",
    "relationship",
    "race",
    "sex",
    "native-country",
]
NUMERIC_FEATURE_KEYS = [
    "age",
    "capital-gain",
    "capital-loss",
    "hours-per-week",
]
LABEL_KEY = "label"


def get_feature_columns():
    columns = [fc.numeric_column(k) for k in NUMERIC_FEATURE_KEYS]
    for key in CATEGORICAL_FEATURE_KEYS:
        columns.append(
            fc.embedding_column(
                fc.categorical_column_with_hash_bucket(key, 64), dimension=16
            )
        )
    return tuple(columns)
