"""Card-only tests of the port's CUDA kernels. chip_smoke.py holds each kernel
against its plain PyTorch version at the main path's shapes; these tests
cover the edges it does not: a lone clip and a zero-padded tail (K1), one
query or key and unequal query and key lengths (K2), one row and rows that
fill no tile (K3), the launch counters, the shapes the kernels refuse, and
the encoder's routing through K2 and K3. Both use the tolerances defined
beside the kernels. Marked ``cuda``; each skips without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wealy_tpu_torch.audio import fused_mel
from wealy_tpu_torch.audio import mel as tmel
from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
from wealy_tpu_torch.cli.extract import load_whisper_model
from wealy_tpu_torch.models.whisper.model import Whisper
from wealy_tpu_torch.ops import bf16_agreement
from wealy_tpu_torch.ops.flash_attention import _reference_mha, flash_mha
from wealy_tpu_torch.ops.fused_mlp import _reference_mlp, fused_mlp

from _torch_parity import cuda_device, min_row_cosine, to_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    device = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are f32 products
    torch.backends.cudnn.allow_tf32 = False
    return device


def _assert_bf16_close(got, want):
    ok, err, cos = bf16_agreement(got, want)
    assert ok, f"max abs {err:.3g}, min row cosine {cos:.6f}"


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_lone_clip_with_silent_tail(dev, n_mels):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.1 * rng.normal(size=tmel.N_SAMPLES)).astype(np.float32))
    x[300000:] = 0.0  # zero-padded tail of a song's last chunk
    x = x.to(dev)
    before = log_mel_spectrogram_fused.launches
    got = log_mel_spectrogram_fused(x, n_mels=n_mels)
    want = tmel.log_mel_spectrogram(x, n_mels=n_mels)
    torch.cuda.synchronize()
    assert log_mel_spectrogram_fused.launches == before + 1
    assert got.shape == (n_mels, tmel.N_FRAMES)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=fused_mel.RTOL,
                               atol=fused_mel.ATOL)


@pytest.mark.parametrize("B,Tq,Tk,H", [(1, 1, 1, 1), (2, 17, 45, 2), (1, 300, 300, 3)])
def test_flash_kernel_edges(dev, B, Tq, Tk, H):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, t, H, 64)).astype(np.float32))
               .to(dev).bfloat16() for t in (Tq, Tk, Tk))
    before = flash_mha.launches
    got = flash_mha(q, k, v, 0.125)
    assert flash_mha.launches == before + 1
    assert got.shape == q.shape
    _assert_bf16_close(got, _reference_mha(q, k, v, 0.125))


@pytest.mark.parametrize("N,D", [(1, 64), (65, 384)])
def test_mlp_kernel_edges(dev, N, D):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(N, D, device=dev, generator=g).bfloat16()
    w1 = (torch.randn(4 * D, D, device=dev, generator=g) * D**-0.5).bfloat16()
    w2 = (torch.randn(D, 4 * D, device=dev, generator=g) * (4 * D) ** -0.5).bfloat16()
    b1 = 0.1 * torch.randn(4 * D, device=dev, generator=g)
    b2 = 0.1 * torch.randn(D, device=dev, generator=g)
    before = fused_mlp.launches
    got = fused_mlp(x, w1, b1, w2, b2)
    assert fused_mlp.launches == before + 1
    _assert_bf16_close(got, _reference_mlp(x, w1, b1, w2, b2))


def test_kernels_raise_on_shapes_they_do_not_take(dev):
    before = (flash_mha.launches, fused_mlp.launches)
    q = torch.zeros(1, 300, 2, 32, dtype=torch.bfloat16, device=dev)  # Dh 32 ("dev" size)
    with pytest.raises(ValueError, match="flash_mha"):
        flash_mha(q, q, q, 32**-0.5)
    with pytest.raises(ValueError, match="flash_mha"):
        flash_mha(q.float(), q.float(), q.float(), 32**-0.5)
    x = torch.zeros(4, 32, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(128, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="fused_mlp"):
        fused_mlp(x, w, torch.zeros(128, device=dev), w.T.contiguous(),
                  torch.zeros(32, device=dev))
    assert (flash_mha.launches, fused_mlp.launches) == before


def test_tiny_encoder_on_card_matches_cpu(dev):
    """whisper-tiny bf16 encoder: card (K2 + K3) against CPU (plain), same weights."""
    cpu_model, cfg = load_whisper_model("tiny", seed=0, device="cpu")
    card_model = Whisper(cfg, device=dev).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(3)
    mel = torch.from_numpy((0.5 * rng.normal(size=(1, 80, 3000))).astype(np.float32))
    before = (flash_mha.launches, fused_mlp.launches)
    with torch.no_grad():
        got = card_model.encode(mel.to(dev))
        want = cpu_model.encode(mel)
    assert (flash_mha.launches, fused_mlp.launches) == (before[0] + 4, before[1] + 4)
    assert min_row_cosine(to_numpy(got), to_numpy(want)) >= 0.999
