"""Corpus-scale ranking of the port (single device for now), the counterpart
of ``wealy_tpu.parallel``."""
