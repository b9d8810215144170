"""Dataset metadata, stores, sampling and collates of the port: host-side
numpy code copied from ``wealy_tpu.data`` (CSV through the stdlib ``csv``
module, no pandas)."""
