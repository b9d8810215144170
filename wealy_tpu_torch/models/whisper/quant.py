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

Everything else stays as in the bf16 encoder: the conv stem and positions
in the compute dtype, LayerNorm in f32 cast back, attention through K2
(``ops/flash_attention.py::flash_mha``) as the JAX module goes through its
``flash_mha``, exact GELU on the compute-dtype fc1 output. The MLP's
products are int8, so K3 does not run on this route.

:func:`load_quant_encoder` builds the encoder from a checkpoint's f32
weights or from the seeded f32 draw of ``load_whisper_model`` (the same
numbers the bf16 model rounds).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig
from wealy_tpu_torch.ops.flash_attention import flash_mha

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
    of :class:`QuantWhisperEncoder`: ``{"stem": {...}, "layers": [per layer
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
    ``bias`` f32 (out,) or None; returns f32."""

    def __init__(self, tree: dict, device=None):
        super().__init__()
        self.register_buffer("weight", torch.from_numpy(tree["w"]).to(device))
        self.register_buffer("scale", torch.from_numpy(tree["s"]).to(device))
        b = tree.get("b")
        self.register_buffer("bias", None if b is None else torch.from_numpy(b).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qdense(x, self.weight, self.scale, self.bias)


def _layer_norm(d: dict, device=None) -> nn.LayerNorm:
    ln = nn.LayerNorm(d["weight"].shape[0], eps=1e-5, device=device)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(d["weight"]))
        ln.bias.copy_(torch.from_numpy(d["bias"]))
    return ln


def _ln(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """LayerNorm in f32, cast to the compute dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class QuantBlock(nn.Module):
    """One encoder block with int8 dense layers (attention through K2)."""

    def __init__(self, layer: dict, n_head: int, dtype, device=None):
        super().__init__()
        self.n_head, self.dtype = n_head, dtype
        self.attn_ln = _layer_norm(layer["attn_ln"], device)
        self.mlp_ln = _layer_norm(layer["mlp_ln"], device)
        for name, _, _ in DENSE:
            self.add_module(name, QuantLinear(layer[name], device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H, dt = self.n_head, self.dtype
        h = _ln(self.attn_ln, x, dt)
        q, k, v = (getattr(self, n)(h).reshape(B, T, H, D // H).to(dt) for n in ("q", "k", "v"))
        att = flash_mha(q, k, v, (D // H) ** -0.5).reshape(B, T, D)
        x = x + self.out(att.to(dt)).to(dt)
        h = self.fc1(_ln(self.mlp_ln, x, dt))
        h = self.fc2(F.gelu(h.to(dt), approximate="none"))
        return x + h.to(dt)


class QuantWhisperEncoder(nn.Module):
    """Mel (B, n_mels, 3000) -> audio states (B, 1500, D) through the int8
    blocks; the stem and positions in ``dtype`` as the bf16 encoder."""

    def __init__(self, config: WhisperConfig, qtree: dict, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config, self.dtype = config, dtype
        st = qtree["stem"]
        D = config.n_audio_state
        kw = dict(dtype=dtype, device=device)
        self.conv1 = nn.Conv1d(config.n_mels, D, 3, padding=1, **kw)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2, padding=1, **kw)
        with torch.no_grad():
            for name in ("conv1", "conv2"):
                conv = getattr(self, name)
                conv.weight.copy_(torch.from_numpy(st[f"{name}.weight"]))
                conv.bias.copy_(torch.from_numpy(st[f"{name}.bias"]))
        self.register_buffer("positional_embedding",
                             torch.from_numpy(st["positional_embedding"]).to(device))
        self.blocks = nn.ModuleList(QuantBlock(layer, config.n_audio_head, dtype, device)
                                    for layer in qtree["layers"])
        self.ln_post = _layer_norm(qtree["ln_post"], device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.conv1(mel.to(self.dtype)), approximate="none")
        x = F.gelu(self.conv2(x), approximate="none").transpose(1, 2)  # (B, T, D)
        x = x + self.positional_embedding[: x.shape[1]].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return _ln(self.ln_post, x, self.dtype)


def f32_encoder_state_dict(size: str = "tiny", checkpoint: Optional[str] = None,
                           seed: int = 0) -> dict:
    """The f32 encoder weights the int8 route quantises: a checkpoint's
    (openai-whisper or HF names), else the seeded draw of
    ``load_whisper_model(size, seed=seed)`` before any cast to the compute
    dtype (``Whisper.seeded_weights`` over the encoder's parameters)."""
    from wealy_tpu_torch.models.whisper.convert import load_openai_state_dict
    from wealy_tpu_torch.models.whisper.model import Whisper

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
                       device="cuda", dtype=torch.bfloat16) -> QuantWhisperEncoder:
    """The int8 encoder of ``size`` on ``device`` (the card unless the caller
    asks for the CPU), quantised from :func:`f32_encoder_state_dict`."""
    cfg = WHISPER_CONFIGS[size]
    device = resolve_device(device)
    qtree = quantize_encoder_state_dict(f32_encoder_state_dict(size, checkpoint, seed), cfg)
    return QuantWhisperEncoder(cfg, qtree, dtype=dtype, device=device).eval()
