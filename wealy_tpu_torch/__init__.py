"""PyTorch + CUDA port of wealy_tpu: the Whisper embedding-extraction path,
the retrieval evaluate path, training and the serving path.

The JAX package ``wealy_tpu`` is the reference; this package mirrors its
layout (``audio/``, ``ops/``, ``models/``, ``data/``, ``eval/``,
``parallel/``, ``train/``, ``utils/``, ``cli/``) and imports torch and numpy
only. The Pallas kernels are hand-written CUDA C++ for Hopper
(``csrc/*.cu``), compiled with ``nvcc`` on first use by
:mod:`wealy_tpu_torch._build` and bound with ``ctypes``. Each kernel wrapper
runs its plain PyTorch version for CPU tensors and launches the kernel (or
raises) for CUDA tensors.

Entry points run on the card. The CPU is used only when the caller asks for
it (``device="cpu"``, ``--device cpu``); without a card and without that
request they raise, never falling back.
"""

import torch

NO_CARD = (
    "no CUDA device: the port runs on the card; pass --device cpu (device='cpu') "
    "to run on the CPU"
)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card. A CUDA device
    that does not exist raises ``RuntimeError`` (:data:`NO_CARD`)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    return device


def default_device() -> torch.device:
    """The card; raises ``RuntimeError`` when there is none."""
    return resolve_device(None)
