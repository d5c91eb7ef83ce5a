"""Hyperparameter search (port of ``uwcv_tpu/hpo``)."""
