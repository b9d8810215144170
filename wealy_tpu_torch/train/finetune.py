"""Training through the Whisper encoder: the encoder and a projection head
trained as one model, the path whose backward runs the attention-backward
kernels K5a/K5b.

The JAX package has no module for this; its single-device form is the
``model_call`` of ``tests/test_pp.py`` (``call_sd``): ``head(encoder(mel),
all-valid mask)``, driven through ``make_train_step``. :class:`EncoderHead`
holds both, and :func:`encoder_head_call` is that ``model_call``; the batch
is ``{"emb": mel (B, n_mels, 2 * n_audio_ctx), "labels", "ids"}``. The
encoder computes in its dtype (bf16 in production, with f32 masters in the
train state) and the head in f32.
"""

from __future__ import annotations

import torch
from torch import nn


class EncoderHead(nn.Module):
    """``encoder`` (a WhisperEncoder) followed by ``head`` (a ProjectionHead)
    over every encoder state."""

    def __init__(self, encoder: nn.Module, head: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.head = head

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        states = self.encoder(mel)
        mask = torch.ones(states.shape[:2], dtype=torch.bool, device=states.device)
        return self.head(states.float(), mask)


def encoder_head_call(model: EncoderHead, batch: dict) -> torch.Tensor:
    """The ``model_call`` of the encoder+head step: z (B, zdim) from the mel."""
    return model(batch["emb"])
