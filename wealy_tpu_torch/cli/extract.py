"""Model loading for embedding extraction (counterpart of
``wealy_tpu.cli.extract.load_whisper_model``; the split-level job
``extract_split`` follows with the data stack)."""

from __future__ import annotations

from typing import Optional

import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
from wealy_tpu_torch.models.whisper.convert import load_openai_state_dict
from wealy_tpu_torch.models.whisper.model import Whisper


def load_whisper_model(
    size: str = "tiny",
    checkpoint: Optional[str] = None,
    seed: int = 0,
    device="cuda",
    dtype=torch.bfloat16,
) -> tuple[Whisper, WhisperConfig]:
    """Build the extraction Whisper on ``device`` (the card unless the
    caller asks for the CPU): weights from an openai-whisper or HF
    checkpoint when given, otherwise a seeded random init drawn on the CPU,
    so that the card and the CPU get the same weights (no weights are
    downloaded)."""
    cfg = WHISPER_CONFIGS[size]
    device = resolve_device(device)
    model = Whisper(cfg, dtype=dtype, device=device)
    if checkpoint:
        model.load_state_dict(load_openai_state_dict(checkpoint))
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.eval(), cfg
