"""Learned models: the port of ``splat_one_tpu/models/``."""
