"""Whisper in PyTorch: configs, model, weight conversion, decoding (greedy,
sampling, beam search, the long-form ladder) and embedding extraction
(counterpart of ``wealy_tpu.models.whisper``)."""

from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
from wealy_tpu_torch.models.whisper.convert import (
    load_openai_state_dict,
    state_dict_from_hf,
    state_dict_from_jax_params,
)
from wealy_tpu_torch.models.whisper.generate import (
    default_prompt,
    default_suppress_tokens,
    detect_language,
    greedy_decode,
    init_kv_caches,
)
from wealy_tpu_torch.models.whisper.model import (
    MultiHeadAttention,
    ResidualAttentionBlock,
    Whisper,
    WhisperDecoder,
    WhisperEncoder,
    sinusoids,
)

__all__ = [
    "MultiHeadAttention",
    "ResidualAttentionBlock",
    "WHISPER_CONFIGS",
    "Whisper",
    "WhisperConfig",
    "WhisperDecoder",
    "WhisperEncoder",
    "default_prompt",
    "default_suppress_tokens",
    "detect_language",
    "greedy_decode",
    "init_kv_caches",
    "load_openai_state_dict",
    "sinusoids",
    "state_dict_from_hf",
    "state_dict_from_jax_params",
]
