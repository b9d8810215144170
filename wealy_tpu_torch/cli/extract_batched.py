"""The embed functions of the query path, the counterpart of the three
factories of ``wealy_tpu.cli.extract_batched`` that ``cli/serve.py`` uses:

- :func:`make_encoder_embed_fn`: mel (K1) -> encoder (K2/K3) -> mean pool,
  one ``x_concat`` row per 30 s chunk;
- :func:`make_decoder_embed_fn`: mel -> encoder -> greedy decode ->
  (decoder last hidden states, lengths), the ``hs_last_*`` kinds;
- :func:`make_wealy_embed_fn`: mel -> encoder -> bf16 ``ProjectionHead``.

Each builds the Whisper model once (``model.whisper_size``, weights from an
openai-whisper/HF checkpoint or the seeded init of ``load_whisper_model``)
and returns ``fn(audio)`` for a (B, 480000) batch of 16 kHz chunks. The
split-level jobs (``extract_split_batched*``) come with the extraction
slice (ROADMAP item 3); the int8 encoder, the f8 KV caches and the mesh/TP
options raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
from wealy_tpu_torch.cli.extract import load_whisper_model


def _refuse(**options) -> None:
    on = sorted(name for name, value in options.items() if value)
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: the int8 encoder and the f8 KV caches wait for ROADMAP item 5, "
            "the mesh and tensor-parallel paths for item 6"
        )


def _chunks(audio, device) -> torch.Tensor:
    return torch.as_tensor(audio, dtype=torch.float32).to(device)


def make_encoder_embed_fn(config, hf_checkpoint: Optional[str] = None, quant_int8: bool = False,
                          device=None, dtype=torch.bfloat16):
    """``fn(audio (B, 480000)) -> (B, D)``: the mean over time of the
    encoder states, in the model's dtype, on ``device``."""
    _refuse(quant_int8=quant_int8)
    device = resolve_device(device)
    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device, dtype=dtype)

    @torch.inference_mode()
    def embed(audio):
        mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=wcfg.n_mels)
        return model.encode(mel).mean(dim=1)

    return embed


def make_decoder_embed_fn(config, hf_checkpoint: Optional[str] = None,
                          language: Optional[int] = 0, max_len: int = 224,
                          cross_kv_f8: bool = False, self_kv_f8: bool = False, mesh=None,
                          tp: int = 1, device=None, dtype=torch.bfloat16):
    """``fn(audio (B, 480000)) -> (hidden (B, max_len, D), lengths (B,))``:
    greedy transcription of every chunk with the decoder's last hidden
    state per position (``language=0`` forces English, None omits the
    language and task tokens)."""
    from wealy_tpu_torch.models.whisper.extract import decoder_embeddings

    _refuse(cross_kv_f8=cross_kv_f8, self_kv_f8=self_kv_f8, mesh=mesh is not None, tp=tp > 1)
    device = resolve_device(device)
    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device, dtype=dtype)

    @torch.inference_mode()
    def decode_fn(audio):
        mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=wcfg.n_mels)
        out = decoder_embeddings(model, mel, wcfg, language=language, max_len=max_len)
        return out["hidden"], out["lengths"]

    return decode_fn


def make_wealy_embed_fn(config, hf_checkpoint: Optional[str] = None,
                        head_checkpoint: Optional[str] = None, device=None):
    """``fn(audio (B, 480000)) -> (B, zdim)``: the encoder states through a
    ``ProjectionHead(zdim, hidden=(zdim,))`` computed in bf16 (LayerNorm in
    f32), as the JAX factory's ``dtype=jnp.bfloat16`` head. Head weights
    from ``head_checkpoint`` or ``path.checkpoints`` (a state-dict file, a
    ``train`` payload or a checkpoint directory), else the seeded init."""
    from wealy_tpu_torch.cli.main import read_head_checkpoint, serving_checkpoint
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_

    device = resolve_device(device)
    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device)
    zdim = int(config.model.zdim)
    head = ProjectionHead(wcfg.n_audio_state, zdim=zdim, hidden=(zdim,))
    ckpt = serving_checkpoint(head_checkpoint, config)
    if ckpt:
        head.load_state_dict(read_head_checkpoint(ckpt)[0])
    else:
        seeded_init_(head, seed=0)
    head = head.to(device=device, dtype=torch.bfloat16)
    for name, module in head.named_modules():
        if name.endswith("norm"):
            module.float()

    @torch.inference_mode()
    def embed(audio):
        mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=wcfg.n_mels)
        states = model.encode(mel)
        return head(states, torch.ones(states.shape[:2], dtype=torch.bool, device=device))

    return embed
