"""Retrieval evaluation of the port: MAP / MR1 / P@k over chunk-set song
distances, the counterpart of ``wealy_tpu.eval``."""
