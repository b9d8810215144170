"""Port of the extraction slice (wealy_tpu_torch.models.whisper.extract)
against the JAX package: the same seeded song through both extract_song
pipelines (mel -> encoder -> greedy decode) at the real audio geometry
(n_audio_ctx 1500, full vocabulary) with a narrow model."""

import numpy as np
import pytest
import torch

from wealy_tpu.models.whisper import WhisperConfig
from wealy_tpu.models.whisper.extract import extract_song as j_extract_song
from wealy_tpu_torch.models.whisper.extract import (
    chunk_waveform,
    extract_song,
    flatten_decoder_sequence,
)

from _torch_parity import jax_and_port_whisper, min_row_cosine

RTOL = ATOL = 1e-4  # f32 activation parity
COS_MIN = 0.999  # bf16

CFG = WhisperConfig(
    n_mels=80, n_audio_ctx=1500, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=32, n_text_state=32, n_text_head=2, n_text_layer=2,
)
KINDS = ("x_concat", "x_all", "hs_last_all", "hs_last_seq", "hs_all", "hs_last_seq_en")


@pytest.fixture(scope="module")
def song():
    """35 s of noise: two chunks, the second mostly zero padding."""
    return (0.1 * np.random.default_rng(7).normal(size=35 * 16000)).astype(np.float32)


@pytest.fixture(scope="module")
def f32_outputs(song):
    jmodel, params, port = jax_and_port_whisper(CFG, "float32", seed=0)
    want = j_extract_song(jmodel, params, song, CFG, kinds=KINDS, max_len=8)
    got = extract_song(port, song, CFG, kinds=KINDS, max_len=8)
    return got, want


def test_chunking_matches_jax(song):
    from wealy_tpu.models.whisper.extract import chunk_waveform as j_chunk

    np.testing.assert_array_equal(chunk_waveform(song), j_chunk(song))
    assert chunk_waveform(np.ones(10, np.float32)).shape == (1, 480000)


def test_flatten_sequence():
    h = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    flat = flatten_decoder_sequence(h, np.array([2, 4]))
    np.testing.assert_array_equal(flat, np.concatenate([h[0, :2], h[1, :4]]))


def test_same_kinds_and_shapes(f32_outputs):
    got, want = f32_outputs
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
    assert got["x_all"].shape == (2, 1500, 32)
    assert got["hs_all"].shape == (3, 2, 8, 32)


@pytest.mark.parametrize("kind", ["x_concat", "x_all"])
def test_encoder_kinds_f32(f32_outputs, kind):
    got, want = f32_outputs
    np.testing.assert_allclose(got[kind], np.asarray(want[kind]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["hs_last_all", "hs_last_seq", "hs_all", "hs_last_seq_en"])
def test_decoder_kinds_f32(f32_outputs, kind):
    got, want = f32_outputs
    if f"{kind}_lengths" in want:
        np.testing.assert_array_equal(got[f"{kind}_lengths"], want[f"{kind}_lengths"])
    np.testing.assert_allclose(got[kind], np.asarray(want[kind]), rtol=RTOL, atol=ATOL)


def test_bf16_slice_agrees(song):
    """bf16 end to end (the encoder at 1500 frames goes through both kernel
    gates): pooled embeddings and the prompt positions' decoder states."""
    jmodel, params, port = jax_and_port_whisper(CFG, "bfloat16", seed=1)
    kinds = ("x_concat", "hs_last_all")
    want = j_extract_song(jmodel, params, song, CFG, kinds=kinds, max_len=6)
    got = extract_song(port, song, CFG, kinds=kinds, max_len=6)
    assert min_row_cosine(got["x_concat"], np.asarray(want["x_concat"], np.float32)) >= COS_MIN
    P = 2  # default prompt without a language: <|sot|> <|notimestamps|>
    assert min_row_cosine(got["hs_last_all"][:, :P], want["hs_last_all"][:, :P]) >= COS_MIN
    assert torch.isfinite(torch.from_numpy(got["hs_last_all"])).all()
