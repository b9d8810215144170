"""Seeded Whisper weights under openai-whisper's names, drawn on the card.

:func:`whisper_state_dict` makes the f32 state dict of a configuration file
from the seed with a CUDA generator, in one draw for all the weights (then
scaled in place): Dense and conv weights N(0, 1/fan_in); biases N(0, 0.02);
LayerNorm scales 1 + N(0, 0.05) and shifts N(0, 0.02); the token embedding
N(0, 0.02); the decoder's positions N(0, 0.01); the encoder's position table
the exact sinusoids, as in a published checkpoint. The program and the
reference are each handed this dict; nothing of what the program makes
from it comes back.

The end-of-text row of the token embedding is zero: its logit is 0 where the
best of 51,866 random logits lies some four standard deviations above, so no
chunk ends early and every seed decodes ``max_len`` positions a chunk (with
random weights, where a decode ends is an accident of the draw).

The configuration file's ``decoder_design.attention_gain`` scales the
decoder's query and key projections (self and cross), so its attention
logits spread by the gain's square and attend to a few positions, as trained
heads do; random ones spread their weight evenly over all 1,500 audio
positions, which averages any rounding of the cached K/V away.
"""

from __future__ import annotations

import math

# <|endoftext|> of the multilingual vocabularies (openai-whisper's tokenizer)
EOT = 50257


def shapes(cfg: dict) -> dict:
    """{openai-whisper name: shape} of a configuration file's sizes."""
    D, M, V = cfg["d_model"], cfg["num_mel_bins"], cfg["vocab_size"]
    out = {
        "encoder.conv1.weight": (D, M, 3), "encoder.conv1.bias": (D,),
        "encoder.conv2.weight": (D, D, 3), "encoder.conv2.bias": (D,),
        "encoder.positional_embedding": (cfg["max_source_positions"], D),
    }

    def attn(prefix):
        out.update({f"{prefix}.query.weight": (D, D), f"{prefix}.query.bias": (D,),
                    f"{prefix}.key.weight": (D, D),
                    f"{prefix}.value.weight": (D, D), f"{prefix}.value.bias": (D,),
                    f"{prefix}.out.weight": (D, D), f"{prefix}.out.bias": (D,)})

    def block(prefix, cross, Dff):
        attn(f"{prefix}.attn")
        out.update({f"{prefix}.attn_ln.weight": (D,), f"{prefix}.attn_ln.bias": (D,)})
        if cross:
            attn(f"{prefix}.cross_attn")
            out.update({f"{prefix}.cross_attn_ln.weight": (D,),
                        f"{prefix}.cross_attn_ln.bias": (D,)})
        out.update({f"{prefix}.mlp.0.weight": (Dff, D), f"{prefix}.mlp.0.bias": (Dff,),
                    f"{prefix}.mlp.2.weight": (D, Dff), f"{prefix}.mlp.2.bias": (D,),
                    f"{prefix}.mlp_ln.weight": (D,), f"{prefix}.mlp_ln.bias": (D,)})

    for i in range(cfg["encoder_layers"]):
        block(f"encoder.blocks.{i}", False, cfg["encoder_ffn_dim"])
    out.update({"encoder.ln_post.weight": (D,), "encoder.ln_post.bias": (D,),
                "decoder.token_embedding.weight": (V, D),
                "decoder.positional_embedding": (cfg["max_target_positions"], D)})
    for i in range(cfg["decoder_layers"]):
        block(f"decoder.blocks.{i}", True, cfg["decoder_ffn_dim"])
    out.update({"decoder.ln.weight": (D,), "decoder.ln.bias": (D,)})
    return out


def sinusoids(length: int, channels: int, device):
    """The encoder's fixed position table (sin | cos), f32 from f64."""
    import torch

    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64, device=device))
    t = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def whisper_state_dict(cfg: dict, seed: int, device) -> dict:
    """The seeded f32 state dict of ``cfg`` on ``device``: views of one
    buffer, drawn in one call."""
    import torch

    shp = shapes(cfg)
    sizes = [math.prod(s) for s in shp.values()]
    gain = cfg.get("decoder_design", {}).get("attention_gain", 1.0)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    with torch.no_grad():
        for (name, shape), n in zip(shp.items(), sizes):
            t = flat[at:at + n].view(shape)
            at += n
            if name == "encoder.positional_embedding":
                t.copy_(sinusoids(*shape, device))
            elif name.endswith("ln.weight") or name.endswith("ln_post.weight"):
                t.mul_(0.05).add_(1.0)
            elif name.endswith("bias"):
                t.mul_(0.02)
            elif name == "decoder.token_embedding.weight":
                t.mul_(0.02)
                t[EOT].zero_()
            elif name == "decoder.positional_embedding":
                t.mul_(0.01)
            else:
                t.mul_(math.prod(shape[1:]) ** -0.5)
            if name.startswith("decoder.") and (".query." in name or ".key." in name):
                t.mul_(gain)
            out[name] = t
    return out
