"""Feature columns; the port of ``elasticdl_tpu/feature_column``."""

from elasticdl_tpu_torch.feature_column.feature_column import (  # noqa: F401
    DenseFeatures,
    bucketized_column,
    categorical_column_with_hash_bucket,
    categorical_column_with_identity,
    categorical_column_with_vocabulary_list,
    embedding_column,
    indicator_column,
    numeric_column,
    transform_features,
)
