"""The census-income DNN in its three styles; the port of
``elasticdl_tpu/models/census_dnn_model``."""
