"""PyTorch + CUDA port of wealy_tpu: the Whisper embedding-extraction path
and the retrieval evaluate path.

The JAX package ``wealy_tpu`` is the reference; this package mirrors its
layout (``audio/``, ``ops/``, ``models/``, ``data/``, ``eval/``,
``parallel/``, ``train/``, ``cli/``) and imports torch and numpy only. The
Pallas kernels on those paths are hand-written CUDA C++ for Hopper
(``csrc/*.cu``), compiled with ``nvcc`` on first use by
:mod:`wealy_tpu_torch._build` and bound with ``ctypes``. Each kernel wrapper
runs its plain PyTorch version for CPU tensors and launches the kernel (or
raises) for CUDA tensors.
"""

import torch


def default_device() -> torch.device:
    """The card when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
