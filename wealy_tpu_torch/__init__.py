"""PyTorch + CUDA port of wealy_tpu's Whisper embedding-extraction path.

The JAX package ``wealy_tpu`` is the reference; this package mirrors its
layout (``audio/``, ``ops/``, ``models/whisper/``, ``cli/``) and imports
torch and numpy only. The three Pallas kernels on the extraction path are
hand-written CUDA C++ for Hopper (``csrc/*.cu``), compiled with ``nvcc`` on
first use by :mod:`wealy_tpu_torch._build` and bound with ``ctypes``. Each
kernel wrapper runs its plain PyTorch version for CPU tensors and launches
the kernel (or raises) for CUDA tensors.
"""
