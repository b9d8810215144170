"""The counts equal hand-worked numbers at large-v3-turbo's sizes."""

import json
from pathlib import Path

from portbench import peaks
from portbench.counts import k2, k3, whisper

TURBO = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                    "wealy-large-v3-turbo.json").read_text())
MEDIUM = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                     "wealy-medium.json").read_text())


def test_encoder_flops():
    # stem 2*3000*1280*128*3 + 2*1500*1280^2*3; a block 8*1500*1280^2 +
    # 4*1500^2*1280 + 4*1500*1280*5120 = 70,502,400,000, times 32
    assert whisper.encoder_flops(TURBO) == 2_949_120_000 + 14_745_600_000 + 32 * 70_502_400_000
    assert round(whisper.encoder_flops(TURBO) / 1e12, 2) == 2.27
    assert round(whisper.encoder_flops(MEDIUM) / 1e12, 2) == 1.14


def test_decoder_flops():
    one = whisper.decoder_flops(TURBO, 1)
    D, V = 1280, 51866
    assert one == 4 * 2 * 2 * 1500 * D * D + 4 * (8 * D * D + 4 * D + 4 * D * D + 4 * 1500 * D
                                                   + 4 * D * 5120) + 2 * D * V
    assert whisper.decoder_flops(TURBO, 2) - one == \
        4 * (8 * D * D + 8 * D + 4 * D * D + 4 * 1500 * D + 4 * D * 5120) + 2 * D * V


def test_k2_at_turbo():
    shape = (32, 1500, 20, 64)
    assert k2.ops(*shape) == 368_640_000_000  # 4 * 32 * 20 * 1500^2 * 64
    assert k2.bytes_moved(*shape) == 491_520_000  # q, k, v and out in bf16
    s, basis = peaks.bound_s(k2.bytes_moved(*shape), k2.ops(*shape))
    assert basis == "operations" and abs(s - 368.64e9 / 989e12) < 1e-12


def test_k3_at_turbo():
    shape = (48_000, 1280, 5120)
    assert k3.ops(*shape) == 1_258_291_200_000  # 4 * 48000 * 1280 * 5120
    # x and out bf16, W1 and W2 bf16, the two f32 biases
    assert k3.bytes_moved(*shape) == 245_760_000 + 26_214_400 + 25_600
    assert peaks.bound_s(k3.bytes_moved(*shape), k3.ops(*shape))[1] == "operations"
