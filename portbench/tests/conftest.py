"""Tests of the benchmark itself, on the CPU (``python -m pytest
portbench/tests -q`` from the repository root); those marked ``cuda`` need
a card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a Whisper small enough for the CPU, with the published mel, context and
# vocabulary geometry (the port's "dev" size)
DEV = {"port_model": "dev", "d_model": 64, "encoder_layers": 1, "decoder_layers": 1,
       "encoder_attention_heads": 2, "decoder_attention_heads": 2, "encoder_ffn_dim": 256,
       "decoder_ffn_dim": 256, "num_mel_bins": 80, "vocab_size": 51865,
       "max_source_positions": 1500, "max_target_positions": 448}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The traffic generator's cache in a temporary directory."""
    from portbench import traffic

    monkeypatch.setattr(traffic, "CACHE", tmp_path / "cache")
    return tmp_path / "cache"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
