"""Weight conversion into the port's state dict (openai-whisper names),
counterpart of ``wealy_tpu.models.whisper.convert``.

- :func:`load_openai_state_dict` loads an openai-whisper checkpoint (or an
  HF ``WhisperModel`` one, renamed by :func:`state_dict_from_hf`).
- :func:`state_dict_from_jax_params` turns a wealy_tpu JAX param tree
  (numpy leaves, ``block_i`` or scanned ``blocks/block`` layout) into the
  port's state dict: the weight bridge of the parity tests
  (:func:`encoder_state_dict_from_jax_params` for an encoder alone).

Every function returns f32 tensors; ``Whisper.load_state_dict`` casts the
Dense and conv weights to the model's compute dtype.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


# --- openai-whisper / HF checkpoints ---------------------------------------


def load_openai_state_dict(path_or_state) -> dict[str, torch.Tensor]:
    """An openai-whisper checkpoint (file path or loaded dict, with or
    without ``model_state_dict``) as an f32 state dict; HF WhisperModel /
    WhisperForConditionalGeneration keys are renamed."""
    sd = path_or_state
    if not isinstance(sd, Mapping):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    sd = sd.get("model_state_dict", sd)
    if not any(k.startswith(("encoder.blocks.", "decoder.blocks.")) for k in sd):
        sd = state_dict_from_hf(sd)
    return {k: _t(v) for k, v in sd.items()}


_HF_ATTN = {"q_proj": "query", "k_proj": "key", "v_proj": "value", "out_proj": "out"}
_HF_BLOCK = {
    "self_attn_layer_norm": "attn_ln",
    "self_attn": "attn",
    "encoder_attn_layer_norm": "cross_attn_ln",
    "encoder_attn": "cross_attn",
    "final_layer_norm": "mlp_ln",
    "fc1": "mlp.0",
    "fc2": "mlp.2",
}
_HF_TOP = {
    "encoder.embed_positions.weight": "encoder.positional_embedding",
    "encoder.layer_norm": "encoder.ln_post",
    "decoder.embed_tokens.weight": "decoder.token_embedding.weight",
    "decoder.embed_positions.weight": "decoder.positional_embedding",
    "decoder.layer_norm": "decoder.ln",
}


def state_dict_from_hf(state_dict: Mapping[str, object]) -> dict[str, object]:
    """Rename HF ``WhisperModel`` keys to openai-whisper names (``model.``
    prefix accepted, ``proj_out`` dropped: it is tied to the embedding)."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("model."):
            key = key[len("model.") :]
        if key.startswith("proj_out"):
            continue
        for old, new in _HF_TOP.items():
            if key.startswith(old):
                key = new + key[len(old) :]
        parts = key.split(".")
        if len(parts) > 2 and parts[1] == "layers":
            parts[1] = "blocks"
            parts[3] = _HF_BLOCK.get(parts[3], parts[3])
            if parts[3] in ("attn", "cross_attn"):
                parts[4] = _HF_ATTN[parts[4]]
            key = ".".join(parts)
        out[key] = value
    return out


# --- JAX param trees ---------------------------------------------------------


def _dense(p, prefix, sd, bias=True):
    sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    if bias:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(p, prefix, sd):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _block(p, prefix, sd):
    for name in ("attn", "cross_attn"):
        if name in p:
            a = p[name]
            _dense(a["q"], f"{prefix}.{name}.query", sd)
            _dense(a["k"], f"{prefix}.{name}.key", sd, bias=False)
            _dense(a["v"], f"{prefix}.{name}.value", sd)
            _dense(a["out"], f"{prefix}.{name}.out", sd)
            _ln(p[f"{name}_ln"], f"{prefix}.{name}_ln", sd)
    _dense(p["mlp_fc1"], f"{prefix}.mlp.0", sd)
    _dense(p["mlp_fc2"], f"{prefix}.mlp.2", sd)
    _ln(p["mlp_ln"], f"{prefix}.mlp_ln", sd)


def _blocks(section) -> list:
    """Per-layer param dicts from either layout: ``block_i`` entries, or the
    scanned ``blocks/block`` tree whose leaves carry a leading layer axis."""
    if "blocks" in section:
        stacked = section["blocks"]["block"]

        def layer(tree, i):
            if isinstance(tree, Mapping):
                return {k: layer(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        n = len(np.asarray(stacked["mlp_ln"]["scale"]))
        return [layer(stacked, i) for i in range(n)]
    n = sum(1 for k in section if k.startswith("block_"))
    return [section[f"block_{i}"] for i in range(n)]


def encoder_state_dict_from_jax_params(enc: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """A wealy_tpu ``WhisperEncoder``'s params -> the f32 state dict of the
    port's ``WhisperEncoder`` (names prefixed with ``prefix``)."""
    sd: dict[str, torch.Tensor] = {}
    for i in (1, 2):
        # flax Conv kernel (k, in, out) -> torch Conv1d weight (out, in, k)
        sd[f"{prefix}conv{i}.weight"] = _t(enc[f"conv{i}"]["kernel"]).permute(2, 1, 0).contiguous()
        sd[f"{prefix}conv{i}.bias"] = _t(enc[f"conv{i}"]["bias"])
    sd[f"{prefix}positional_embedding"] = _t(enc["positions"])
    for i, p in enumerate(_blocks(enc)):
        _block(p, f"{prefix}blocks.{i}", sd)
    _ln(enc["ln_post"], f"{prefix}ln_post", sd)
    return sd


def state_dict_from_jax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """wealy_tpu ``{"encoder": ..., "decoder": ...}`` params (numpy or jax
    leaves) -> the port's f32 state dict."""
    dec = params["decoder"]
    sd = encoder_state_dict_from_jax_params(params["encoder"], "encoder.")

    sd["decoder.token_embedding.weight"] = _t(dec["token_embedding"])
    sd["decoder.positional_embedding"] = _t(dec["positional_embedding"])
    for i, p in enumerate(_blocks(dec)):
        _block(p, f"decoder.blocks.{i}", sd)
    _ln(dec["ln"], "decoder.ln", sd)
    return sd
