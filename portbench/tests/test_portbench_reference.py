"""The plain reference agrees with the port's plain CPU path on a small
Whisper (f32): resample, log-mel, encoder, teacher-forced decoder."""

import numpy as np
import torch

from portbench import weights
from portbench.reference import audio as ref_audio
from portbench.reference import mel as ref_mel
from portbench.reference import whisper as ref
from portbench.tests.conftest import DEV

CPU = torch.device("cpu")


def _song(seconds=31.0, sr=44100):
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * sr)) / sr
    return 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(len(t)), sr


def test_resample_and_mel_agree_with_the_port():
    from wealy_tpu_torch.audio.mel import log_mel_spectrogram
    from wealy_tpu_torch.audio.resample import resample

    x, sr = _song()
    ours = ref_audio.resample(x, sr, CPU, block=1 << 16)
    port = resample(x.astype(np.float32), sr, 16000).double()
    assert ours.shape == port.shape
    assert float((ours - port).abs().max()) < 2e-4
    chunks = ref_audio.chunks(ours)
    assert chunks.shape == (2, 480000)
    mel = ref_mel.log_mel(chunks, 80)
    port_mel = log_mel_spectrogram(chunks.float(), n_mels=80)
    assert float((mel - port_mel.double()).abs().max()) < 1e-3


def test_whisper_agrees_with_the_port():
    from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wealy_tpu_torch.models.whisper.convert import load_openai_state_dict
    from wealy_tpu_torch.models.whisper.model import Whisper

    sd = weights.whisper_state_dict(DEV, 123, CPU)
    model = Whisper(WHISPER_CONFIGS["dev"], dtype=torch.float32, device=CPU)
    model.load_state_dict(load_openai_state_dict(sd))
    mel = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(0))
    tokens = torch.tensor([[50258, 50259, 50360, 50364, 11, 503, 7, 7, 90]] * 2)
    with torch.no_grad():
        states = model.encode(mel)
        hidden, logits = model.decode(tokens, states)
        r_states = ref.encode(sd, DEV, mel)
        r_hidden, r_logits = ref.decode(sd, DEV, tokens, r_states)
    assert float((states - r_states).abs().max()) < 1e-4
    assert float((hidden - r_hidden).abs().max()) < 1e-4
    assert float((logits - r_logits).abs().max()) < 1e-4
