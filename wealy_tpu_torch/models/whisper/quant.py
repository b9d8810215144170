"""int8 W8A8 Whisper encoder for extraction (inference only), the
counterpart of ``wealy_tpu.models.whisper.quant``.

The dense projections of every encoder block (q/k/v/out and the two MLP
layers) run as int8 x int8 -> int32 products:

- weights: per-(layer, output-channel) absmax int8 with f32 scales,
  computed with numpy from the **f32** weights
  (:func:`quantize_encoder_state_dict`, the JAX module's arithmetic on the
  port's openai-whisper state dict; quantising bf16-rounded weights would
  give other codes and scales);
- activations: dynamic per-token absmax int8 (``sa = max(max|x|, 1e-8) /
  127``, ``round(x / sa)`` clipped to +-127), the product on
  ``torch._int_mm`` (the JAX module's ``dot_general`` with an int32 result,
  outside any Pallas kernel there), then ``acc * (sa * s) (+ b)`` in f32.

Everything else is :class:`~wealy_tpu_torch.models.whisper.model.WhisperEncoder`
itself (:func:`quant_encoder` puts a :class:`QuantLinear` in place of each
of a block's six dense layers): the conv stem and positions in the compute
dtype, the row-major stream, LayerNorm in f32 cast back (K6 on the card,
with the residual adds), attention through K2 as the JAX module goes
through its ``flash_mha``, exact GELU on the compute-dtype fc1 output. The
MLP's products are int8, so K3 does not run on this route.

:func:`load_quant_encoder` builds the encoder from a checkpoint's f32
weights or from the seeded f32 draw of ``load_whisper_model`` (the same
numbers the bf16 model rounds).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
from wealy_tpu_torch.models.whisper.model import Whisper, WhisperEncoder

# (name in the quantized tree, module path in a block, has a bias)
DENSE = (("q", "attn.query", True), ("k", "attn.key", False), ("v", "attn.value", True),
         ("out", "attn.out", True), ("fc1", "mlp.0", True), ("fc2", "mlp.2", True))


def _quant_kernel(w: np.ndarray):
    """(in, out) or (L, in, out) f32 kernel -> (int8 kernel, f32 per-output
    -channel scale): the JAX module's numpy arithmetic."""
    w = np.asarray(w, np.float32)
    s = np.maximum(np.abs(w).max(axis=-2), 1e-12) / 127.0  # (..., out)
    q = np.clip(np.round(w / s[..., None, :]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def quantize_encoder_state_dict(state_dict: Mapping, config: WhisperConfig) -> dict:
    """An f32 encoder state dict (openai-whisper names, with or without the
    ``encoder.`` prefix; a full model's dict works) -> the quantized tree
    of :func:`quant_encoder`: ``{"stem": {...}, "layers": [per layer
    {name: {"w" int8 (out, in), "s" f32 (out,)[, "b" f32 (out,)]}, "attn_ln",
    "mlp_ln"}], "ln_post"}``, numpy leaves. Weights only: activations
    quantize at run time."""
    pre = "encoder." if any(k.startswith("encoder.") for k in state_dict) else ""

    def get(name):
        return _f32(state_dict[pre + name])

    layers = []
    for i in range(config.n_audio_layer):
        blk = f"blocks.{i}."
        layer = {ln: {"weight": get(blk + ln + ".weight"), "bias": get(blk + ln + ".bias")}
                 for ln in ("attn_ln", "mlp_ln")}
        for name, path, has_bias in DENSE:
            # the (out, in) weight as the JAX kernel (in, out), quantised per output channel
            q, s = _quant_kernel(get(blk + path + ".weight").T)
            layer[name] = {"w": np.ascontiguousarray(q.T), "s": s}
            if has_bias:
                layer[name]["b"] = get(blk + path + ".bias")
        layers.append(layer)
    return {
        "stem": {k: get(k) for k in ("conv1.weight", "conv1.bias", "conv2.weight",
                                     "conv2.bias", "positional_embedding")},
        "layers": layers,
        "ln_post": {"weight": get("ln_post.weight"), "bias": get("ln_post.bias")},
    }


def qdense(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token dynamic int8 activations, an int8 x int8 -> int32 product
    against ``w`` (out, in) int8, then ``acc * (sa * s) (+ b)``. ``x`` (...,
    in) in any float dtype; returns f32. The division (not a reciprocal
    product) and ``sa * s`` before the product with ``acc`` keep the JAX
    module's order, so the codes agree at the .5 ties."""
    x32 = x.float()
    sa = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / sa).clamp_(-127, 127).to(torch.int8)
    acc = torch._int_mm(q.reshape(-1, q.shape[-1]), w.t())
    # int32 * f32 promotes to f32: acc.float() * (sa * s), without the f32 copy of acc
    out = torch.mul(acc.view(*x.shape[:-1], w.shape[0]), sa * s)
    return out.add_(b) if b is not None else out


class QuantLinear(nn.Module):
    """An int8 dense layer: ``weight`` int8 (out, in), ``scale`` f32 (out,),
    ``bias`` f32 (out,) or None; returns :func:`qdense`'s f32 result rounded
    to the input's dtype, as the JAX route rounds every product before the
    next operation."""

    def __init__(self, tree: dict, device=None):
        super().__init__()
        self.register_buffer("weight", torch.from_numpy(tree["w"]).to(device))
        self.register_buffer("scale", torch.from_numpy(tree["s"]).to(device))
        b = tree.get("b")
        self.register_buffer("bias", None if b is None else torch.from_numpy(b).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qdense(x, self.weight, self.scale, self.bias).to(x.dtype)


def quant_encoder(config: WhisperConfig, state_dict: Mapping, dtype=torch.bfloat16,
                  device="cpu") -> WhisperEncoder:
    """The :class:`WhisperEncoder` of ``config`` whose blocks hold
    :class:`QuantLinear` projections quantised from the f32 ``state_dict``
    (:func:`quantize_encoder_state_dict`'s names). The stem, the position
    table and the LayerNorms take the f32 weights, rounded into their
    parameters' dtypes as ``load_whisper_model`` rounds them."""
    qtree = quantize_encoder_state_dict(state_dict, config)
    pre = "encoder." if any(k.startswith("encoder.") for k in state_dict) else ""
    quantised = {f"blocks.{i}.{path}.{p}" for i in range(config.n_audio_layer)
                 for _, path, _ in DENSE for p in ("weight", "bias")}
    # no init: the dense layers are replaced and every other weight is loaded
    encoder = WhisperEncoder(config, dtype=dtype, device="meta").to_empty(device=device)
    loaded = encoder.load_state_dict(
        {k[len(pre):]: torch.as_tensor(v) for k, v in state_dict.items()
         if k.startswith(pre) and k[len(pre):] not in quantised}, strict=False)
    if loaded.unexpected_keys or set(loaded.missing_keys) - quantised:
        raise KeyError(f"not an encoder state dict of this config: {loaded}")
    for block, layer in zip(encoder.blocks, qtree["layers"]):
        for name, path, _ in DENSE:
            parent, attr = path.split(".")
            setattr(block.get_submodule(parent), attr, QuantLinear(layer[name], device))
    return encoder.eval()


def f32_encoder_state_dict(size: str = "tiny", checkpoint: Optional[str] = None,
                           seed: int = 0) -> dict:
    """The f32 encoder weights the int8 route quantises: a checkpoint's
    (openai-whisper or HF names), else the seeded draw of
    ``load_whisper_model(size, seed=seed)`` before any cast to the compute
    dtype (``Whisper.seeded_weights`` over the encoder's parameters)."""
    from wealy_tpu_torch.models.whisper.convert import load_openai_state_dict

    if checkpoint:
        return {k: v for k, v in load_openai_state_dict(checkpoint).items()
                if k.startswith("encoder.")}
    shapes = Whisper(WHISPER_CONFIGS[size], dtype=torch.float32, device="meta")
    sd = {}
    for name, value in shapes.seeded_weights(torch.Generator().manual_seed(seed)):
        if not name.startswith("encoder."):
            break  # the encoder's parameters come first
        sd[name] = value
    return sd


def load_quant_encoder(size: str = "tiny", checkpoint: Optional[str] = None, seed: int = 0,
                       device="cuda", dtype=torch.bfloat16) -> WhisperEncoder:
    """The int8 encoder of ``size`` on ``device`` (the card unless the caller
    asks for the CPU), quantised from :func:`f32_encoder_state_dict`."""
    return quant_encoder(WHISPER_CONFIGS[size], f32_encoder_state_dict(size, checkpoint, seed),
                         dtype=dtype, device=resolve_device(device))
