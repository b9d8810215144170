"""The benchmark of the PyTorch and CUDA port (``wealy_tpu_torch``): one
command, ``python3 portbench/run.py``, runs one cell (see README.md)."""
