"""Card-only tests of the port's CUDA kernels. chip_smoke.py holds each kernel
against its plain PyTorch version at the main path's shapes; these tests
cover the edges it does not: a lone clip and a zero-padded tail, one clip
and 64 at 80 and 128 mels, and a pure tone's band (K1), one query or key,
unequal query and key lengths, the edges of the K/V tile ring, a ragged
tile inside a batch and 20 heads, with the row log-sum-exp and a
misaligned view that it refuses (K2, and the backward K5a/K5b with repeat
calls bit-equal, scores of +-60, rows whose softmax is nearly one-hot and
a misaligned view), row counts around the 128-row tile at every Whisper
width and the gradient through K3 alone at tiny and turbo width (K3),
tiles of one row, two pairs a warp, the serving blocks, tiles beyond 128
chunks up to one larger than shared memory, and bpwr-n rounds on each
route (K4, bit-equal to its plain version and to a repeat), the launch
counters, the shapes the kernels refuse, the encoder's routing through K2
and K3, the gradient of a two-block bf16 encoder through K2/K5a/K5b/K3
against its plain path, K6 at the shapes chip_smoke.py holds it at plus a
width off the 16-byte access and a misaligned row, and the serving
engine's resident corpus (f16 and int8) against its host path on the card.
All use the tolerances defined beside the kernels. Marked ``cuda``; each
skips without a card.

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
from wealy_tpu_torch.eval.retrieval import song_distance_matrix
from wealy_tpu_torch.ops import BF16_COS_MIN, BF16_GRAD_COS_MIN, NOISE_ROW_FLOOR, bf16_agreement
from wealy_tpu_torch.ops import flash_attention as fa
from wealy_tpu_torch.ops import fused_mlp as fm
from wealy_tpu_torch.ops.bpwr_redux import (
    ROUTES,
    _reference_bpwr_block,
    bpwr_block_redux,
    kernel_route,
)
from wealy_tpu_torch.parallel.similarity import streaming_relevant_ranks
from wealy_tpu_torch.ops.flash_attention import (
    _reference_mha,
    _reference_mha_grads,
    flash_mha,
    flash_mha_bwd_dkv,
    flash_mha_bwd_dq,
    flash_mha_fwd,
)
from wealy_tpu_torch.ops.fused_mlp import _reference_mlp, fused_mlp
from wealy_tpu_torch.ops import layer_norm as tln

from _torch_parity import cuda_device, min_row_cosine, to_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    device = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are f32 products
    torch.backends.cudnn.allow_tf32 = False
    return device


def _assert_bf16_close(got, want, cos_min=BF16_COS_MIN, row_floor=0.0):
    ok, err, cos = bf16_agreement(got, want, cos_min, row_floor)
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


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_batches(dev, B, n_mels):
    """One clip and phase 8's batch of 64 against the plain version."""
    g = torch.Generator(device=dev).manual_seed(10 + B)
    x = torch.randn(B, tmel.N_SAMPLES, device=dev, generator=g) * 0.1
    got = log_mel_spectrogram_fused(x, n_mels=n_mels)
    want = tmel.log_mel_spectrogram(x, n_mels=n_mels)
    assert got.shape == (B, n_mels, tmel.N_FRAMES)
    torch.testing.assert_close(got, want, rtol=fused_mel.RTOL, atol=fused_mel.ATOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_pure_tone(dev, n_mels):
    """A 1 kHz tone lies on DFT bin 25 (40 Hz apart): in every frame that
    the reflect pad leaves whole (frames 2 .. N_FRAMES - 3; at the ends the
    mirrored tone has a kink) the loudest mel band is the one whose filter
    weighs bin 25 most, and there the kernel holds the plain version's
    tolerance. (The other bands sit in the window's sidelobes, where any
    two f32 summation orders differ.)"""
    t = torch.arange(tmel.N_SAMPLES, device=dev) / tmel.SAMPLE_RATE
    x = 0.5 * torch.sin(2 * np.pi * 1000.0 * t)
    got = log_mel_spectrogram_fused(x, n_mels=n_mels)[:, 2:-2]
    want = tmel.log_mel_spectrogram(x, n_mels=n_mels)[:, 2:-2]
    band = int(np.argmax(tmel.mel_filterbank(n_mels)[1000 * tmel.N_FFT // tmel.SAMPLE_RATE]))
    assert (got.argmax(0) == band).all()
    torch.testing.assert_close(got[band], want[band], rtol=fused_mel.RTOL, atol=fused_mel.ATOL)


def _check_lse(q, k, lse, scale):
    """K2's lse against logsumexp of the plain f32 scores: 1e-4 relative
    plus 1e-4 (the kernel's exp2/log2 against torch's exp/log in f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,Tq,Tk,H", [
    (1, 1, 1, 1), (2, 17, 45, 2), (1, 300, 300, 3),
    # the edges of the K/V ring: one tile, two, two and one key
    (1, 64, 64, 1), (1, 128, 128, 2), (1, 129, 129, 2),
    # a ragged last tile (28 rows) inside a batch other than the last
    (3, 1500, 1500, 2),
    # Tq != Tk both ways, and the widest head count (large-v3 and turbo)
    (2, 100, 1500, 2), (2, 1500, 100, 2), (1, 200, 300, 20),
])
def test_flash_kernel_edges(dev, B, Tq, Tk, H):
    """K2 against _reference_mha, its lse against logsumexp of the f32
    scores, and repeat calls bit-equal."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, t, H, 64)).astype(np.float32))
               .to(dev).bfloat16() for t in (Tq, Tk, Tk))
    before = flash_mha.launches
    got = flash_mha(q, k, v, 0.125)
    assert flash_mha.launches == before + 1
    assert got.shape == q.shape
    _assert_bf16_close(got, _reference_mha(q, k, v, 0.125))
    out, lse = flash_mha_fwd(q, k, v, 0.125, with_lse=True)
    assert torch.equal(out, got) and lse.shape == (B, H, Tq)
    _check_lse(q, k, lse, 0.125)


def test_flash_kernel_refuses_a_misaligned_view(dev):
    """K2 loads its tiles by TMA: a view 2 bytes past a 16-byte boundary is
    refused, and nothing is launched."""
    q = torch.zeros(1, 300, 2, 64, dtype=torch.bfloat16, device=dev)
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device=dev)
    off = flat[1:1 + q.numel()].view(q.shape)
    before = flash_mha.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mha(off, q, q, 0.125)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mha(q, q, off, 0.125)
    assert flash_mha.launches == before


@pytest.mark.parametrize("B,Tq,Tk,H,shift,blow", [
    (1, 1, 1, 1, 0.0, 1.0), (2, 17, 45, 2, 0.0, 1.0), (1, 65, 64, 3, 0.0, 1.0),
    (1, 300, 129, 2, 0.0, 1.0),
    # the edges of the two-stage ring: one tile, exactly the stage count, one more
    (1, 64, 64, 1, 0.0, 1.0), (1, 128, 128, 2, 0.0, 1.0), (1, 129, 129, 2, 0.0, 1.0),
    # a ragged last tile (28 rows) inside a batch other than the last, Tq = Tk and Tq != Tk
    (3, 1500, 1500, 2, 0.0, 1.0), (2, 100, 1500, 2, 0.0, 1.0),
    (1, 200, 300, 20, 0.0, 1.0),  # the widest head count (large-v3 and turbo)
    (2, 300, 300, 2, 2.75, 1.0),  # scaled scores about +60 (head 0) and -60 (head 1)
    (2, 1500, 1500, 3, 0.0, 3.7),  # q and k scaled 3.7x: nearly one-hot rows
])
def test_flash_backward_kernel_edges(dev, B, Tq, Tk, H, shift, blow):
    """K5a/K5b against autograd of the plain attention, through the
    autograd Function; repeat calls bit-equal. With ``shift``, q and k are
    scaled up along one shared direction, the all-ones vector: q moves by
    shift in every dimension, and k, its own mean over the head dimension
    taken out, by shift with the sign flipped in odd heads. The scaled
    scores then reach +-60 while each row's softmax stays near that of the
    unshifted scores: the kernels' exp2 of s * scale * log2 e - lse * log2 e
    runs at large arguments. (A large shift along one coordinate would
    amplify the rounding of ds to bf16 in that coordinate of dq, since
    dq = ds . k and the row of ds sums to 0.) With ``blow``, q and k are
    scaled up as a whole, which makes most rows nearly one-hot (scaled
    scores to about +-75): there dp - delta cancels, and delta must be
    rowsum(p * dp) over every key, normalised, as the TPU kernels sum it (a
    delta read off the bf16 forward output fails this case with dq's row
    cosine below 0). On this case the bf16 plain route itself falls below
    0.999 against f32 autograd of the same bf16 inputs (dq row cosine 0.52,
    dk 0.68 in chip_smoke.py phase 12 on an H100), so the kernels are held
    to the f32 autograd, with dq's rows below NOISE_ROW_FLOOR of the RMS row
    norm held by the max-abs bound alone (ops/__init__.py)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, t, H, 64)).astype(np.float32))
               for t in (Tq, Tk, Tk))
    q, k = q * blow, k * blow
    if shift:
        q += shift
        k = k - k.mean(-1, keepdim=True) + shift * torch.tensor(
            [(-1.0) ** h for h in range(H)])[:, None]
        s = torch.einsum("bqhd,bkhd->bhqk", q.bfloat16().float(), k.bfloat16().float()) * 0.125
        assert s[:, 0].max() >= 60 and s[:, 1].min() <= -60
    q, k, v = (t.to(dev).bfloat16().requires_grad_(True) for t in (q, k, v))
    g = torch.from_numpy(rng.normal(size=(B, Tq, H, 64)).astype(np.float32)).to(dev).bfloat16()
    before = (flash_mha.launches, flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches)
    flash_mha(q, k, v, 0.125).backward(g)
    assert (flash_mha.launches, flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    if blow == 1.0:
        want, floor = _reference_mha_grads(q, k, v, g, 0.125), 0.0
    else:
        want = _reference_mha_grads(*(t.detach().float() for t in (q, k, v, g)), 0.125)
        floor = NOISE_ROW_FLOOR
    for got, w in zip((q.grad, k.grad, v.grad), want):
        if w.abs().max() > 0:  # one key: the softmax gradient is exactly 0
            _assert_bf16_close(got, w, BF16_GRAD_COS_MIN, floor)
        else:  # the kernel's two row sums differ in order only
            assert got.float().abs().max() < 1e-3
    _, lse = flash_mha_fwd(q, k, v, 0.125, with_lse=True)
    runs = [flash_mha_bwd_dq(q, k, v, g, lse, 0.125) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    runs = [flash_mha_bwd_dkv(q, k, v, g, lse, runs[0][1], 0.125) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_backward_kernels_refuse(dev):
    q = torch.zeros(1, 300, 2, 64, dtype=torch.bfloat16, device=dev)
    lse = torch.zeros(1, 2, 300, device=dev)
    with pytest.raises(ValueError, match="flash_mha_bwd_dq"):
        flash_mha_bwd_dq(q, q, q, q.float(), lse, 0.125)  # f32 cotangent
    with pytest.raises(ValueError, match="flash_mha_bwd_dkv"):
        flash_mha_bwd_dkv(q, q[..., :32], q[..., :32], q, lse, lse, 0.125)
    # a contiguous view 2 bytes past a 16-byte boundary: TMA cannot read it
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device=dev)
    off = flat[1:1 + q.numel()].view(q.shape)
    before = (flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mha_bwd_dq(off, q, q, q, lse, 0.125)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_mha_bwd_dkv(q, q, q, off, lse, lse, 0.125)
    assert (flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches) == before


def test_two_block_encoder_gradient_against_plain_path(dev, monkeypatch):
    """A two-block bf16 encoder at T = 1500: every parameter's gradient
    through K2/K5a/K5b/K3 against the same encoder on the card with every
    wrapper routed to its plain version (cosine >= 0.99)."""
    from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wealy_tpu_torch.models.whisper.model import WhisperEncoder

    cfg = WHISPER_CONFIGS["tiny"]
    enc = WhisperEncoder(cfg, dtype=torch.bfloat16, device=dev)
    enc.blocks = enc.blocks[:2]
    g = torch.Generator(device=dev).manual_seed(9)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if p.dim() > 1 and name != "positional_embedding":
                p.copy_(torch.randn(p.shape, device=dev, generator=g) * p[0].numel() ** -0.5)
    mel = torch.randn(2, cfg.n_mels, 3000, device=dev, generator=g) * 0.5
    # a fixed random readout: the output is LayerNorm'd, so a loss such as
    # mean(out ** 2) is nearly constant and its gradient is rounding noise
    readout = torch.randn(2, 1500, cfg.n_audio_state, device=dev, generator=g)

    def grads():
        enc.zero_grad()
        (enc(mel).float() * readout).mean().backward()
        return {n: p.grad.float().clone() for n, p in enc.named_parameters()}

    before = (flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches, fused_mlp.launches)
    got = grads()
    assert (flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches, fused_mlp.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    monkeypatch.setattr(fa, "_kernel_route", lambda t: False)
    monkeypatch.setattr(fm, "_kernel_route", lambda t: False)
    want = grads()
    for name in want:
        cos = torch.nn.functional.cosine_similarity(got[name].flatten(), want[name].flatten(),
                                                    dim=0).item()
        assert cos >= 0.99, (name, cos)


# every published Whisper width, and 64: the second product then fills half
# of a 128-column tile
@pytest.mark.parametrize("D", [64, 384, 512, 768, 1024, 1280])
@pytest.mark.parametrize("N", [1, 63, 127, 129, 4507, 6000])  # around the 128-row tile
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


@pytest.mark.parametrize("size", ["tiny", "large-v3-turbo"])
def test_two_block_encoder_gradient_mlp_kernel_alone(dev, monkeypatch, size):
    """The fine-tune gradient of test_two_block_encoder_gradient_against_plain_path
    with attention on its plain version on both sides, so that K3 is the one
    difference: every parameter's gradient through K3 against the plain MLP
    (cosine >= 0.99), at whisper-tiny and large-v3-turbo width."""
    from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wealy_tpu_torch.models.whisper.model import WhisperEncoder

    cfg = WHISPER_CONFIGS[size]
    enc = WhisperEncoder(cfg, dtype=torch.bfloat16, device=dev)
    enc.blocks = enc.blocks[:2]
    g = torch.Generator(device=dev).manual_seed(9)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if p.dim() > 1 and name != "positional_embedding":
                p.copy_(torch.randn(p.shape, device=dev, generator=g) * p[0].numel() ** -0.5)
    mel = torch.randn(2, cfg.n_mels, 3000, device=dev, generator=g) * 0.5
    readout = torch.randn(2, 1500, cfg.n_audio_state, device=dev, generator=g)
    monkeypatch.setattr(fa, "_kernel_route", lambda t: False)

    def grads():
        enc.zero_grad()
        (enc(mel).float() * readout).mean().backward()
        return {n: p.grad.float().clone() for n, p in enc.named_parameters()}

    before = fused_mlp.launches
    got = grads()
    assert fused_mlp.launches == before + 2
    monkeypatch.setattr(fm, "_kernel_route", lambda t: False)
    want = grads()
    assert fused_mlp.launches == before + 2
    for name in want:
        cos = torch.nn.functional.cosine_similarity(got[name].flatten(), want[name].flatten(),
                                                    dim=0).item()
        assert cos >= 0.99, (name, cos)


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


@pytest.mark.parametrize("Q,B,s1,s2,redux", [
    (1, 1, 1, 1, "bpwr"), (3, 5, 1, 128, "bpwr"), (4, 2, 128, 3, "bpwr"),
    (2, 3, 7, 9, "bpwr-1"), (2, 3, 9, 7, "bpwr-50"), (1, 40, 33, 33, "bpwr"),
    # two pairs a warp (rows <= 16), the serving blocks, and a query longer
    # than the index's songs (the block route at 18 rows)
    (4, 8, 12, 16, "bpwr"), (1, 512, 18, 18, "bpwr"), (16, 512, 18, 18, "bpwr"),
    (16, 512, 40, 18, "bpwr"),
    # tiles beyond 128 chunks: the block route, the last (410 KB of f32)
    # beyond the opt-in shared memory
    (1, 3, 150, 300, "bpwr"), (2, 2, 300, 40, "bpwr"), (1, 2, 320, 320, "bpwr"),
    # bpwr-n on each route
    (3, 4, 20, 100, "bpwr-5"), (2, 2, 300, 40, "bpwr-9"), (1, 2, 320, 320, "bpwr-3"),
])
def test_bpwr_kernel_edges(dev, Q, B, s1, s2, redux):
    """K4 against its plain version and against a repeat, bit for bit, with
    masked chunks, a fully excluded query and candidate, and ties."""
    g = torch.Generator(device=dev).manual_seed(4)
    d = torch.rand(Q, B, s1, s2, device=dev, generator=g) * 2
    d[:, :, ::3, ::2] = torch.round(d[:, :, ::3, ::2] * 4) / 4  # exact ties
    qv = torch.rand(Q, s1, device=dev, generator=g) > 0.3
    cv = torch.rand(B, s2, device=dev, generator=g) > 0.3
    qv[:, 0] = True
    if Q * B > 1:
        cv[-1] = False  # a candidate with no valid chunk
    before = bpwr_block_redux.launches
    got = bpwr_block_redux(d, qv, cv, redux)
    again = bpwr_block_redux(d, qv, cv, redux)
    want = _reference_bpwr_block(d, qv, cv, redux, 1e-7, 1e12)
    torch.cuda.synchronize()
    assert bpwr_block_redux.launches == before + 2
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    if Q * B > 1:
        assert bool((got[:, -1] == 0).all())


def test_bpwr_kernel_routes(dev):
    """The shapes above reach every route of K4."""
    assert [kernel_route(s1, s2) for s1, s2 in ((18, 18), (12, 16), (20, 100), (300, 40),
                                                 (320, 320))] == [
        ROUTES[0], ROUTES[0], ROUTES[1], ROUTES[1], ROUTES[2]]


def test_bpwr_kernel_reads_the_distance_view(dev):
    """The rank passes' (Q, N, s1, s2) view of the (Q*s1, N*s2) matrix, read
    through its strides, and a 0-row block (no launch)."""
    g = torch.Generator(device=dev).manual_seed(5)
    flat = torch.rand(6 * 4, 9 * 5, device=dev, generator=g)
    view = flat.reshape(6, 4, 9, 5).permute(0, 2, 1, 3)
    qv = torch.ones(6, 4, dtype=torch.bool, device=dev)
    cv = torch.rand(9, 5, device=dev, generator=g) > 0.5
    assert torch.equal(bpwr_block_redux(view, qv, cv), bpwr_block_redux(view.contiguous(), qv, cv))
    before = bpwr_block_redux.launches
    empty = bpwr_block_redux(view[:0], qv[:0], cv)
    assert empty.shape == (0, 9) and bpwr_block_redux.launches == before


def test_bpwr_kernel_refuses(dev):
    before = bpwr_block_redux.launches
    valid = torch.ones(1, 3, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="bpwr_block_redux"):  # masks of the wrong length
        bpwr_block_redux(torch.zeros(1, 1, 2, 2, device=dev), valid, valid)
    v2 = torch.ones(1, 2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="bpwr_block_redux"):
        bpwr_block_redux(torch.zeros(1, 1, 2, 2, dtype=torch.float64, device=dev), v2, v2)
    assert bpwr_block_redux.launches == before


def test_song_distances_card_against_cpu(dev):
    """The monolithic chunk-set scorer on the card (f32 product, K4) and on
    the CPU (plain), on the same sets."""
    rng = np.random.default_rng(6)
    sets = rng.normal(size=(20, 6, 32)).astype(np.float32)
    mask = rng.uniform(size=(20, 6)) > 0.3
    mask[:, 0] = True
    card = song_distance_matrix(sets, mask, sets, mask, device=dev)
    cpu = song_distance_matrix(sets, mask, sets, mask, device="cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-5)


def test_resident_and_streamed_ranks_bit_equal_on_card(dev):
    """Chunk-set bpwr ranks with the corpus resident on the card and with
    each block copied as it is used: the same blocks, the same bits."""
    rng = np.random.default_rng(7)
    labels = np.repeat(np.arange(15), 4)
    base = rng.normal(size=(15, 6, 32)).astype(np.float32)
    sets = base[labels] + rng.normal(size=(60, 6, 32)).astype(np.float32)
    mask = np.arange(6)[None, :] < rng.integers(1, 7, 60)[:, None]
    sets[7], mask[7] = sets[3], mask[3]  # an exact tie across cliques
    kw = dict(mode="cos", redux="bpwr", query_mask=mask, corpus_mask=mask, block_size=16,
              query_block=9, device=dev)
    before = bpwr_block_redux.launches
    resident, n1 = streaming_relevant_ranks(sets, sets, labels, labels, resident=True, **kw)
    streamed, n2 = streaming_relevant_ranks(sets, sets, labels, labels, resident=False, **kw)
    assert bpwr_block_redux.launches > before
    np.testing.assert_array_equal(resident, streamed)
    np.testing.assert_array_equal(n1, n2)


@pytest.mark.parametrize("shape,dtype", [
    ((64, 1500, 384), torch.bfloat16), ((8, 1500, 1280), torch.bfloat16),
    ((4507, 1280), torch.bfloat16), ((3, 70, 384), torch.float32),
    ((5, 100), torch.bfloat16), ((7, 2048), torch.float32), ((9, 1), torch.float32),
])
def test_layer_norm_kernel_against_plain(dev, shape, dtype):
    """K6 against _reference_ln on the same input (f32: rtol/atol 1e-5;
    bf16: 2e-2): the phase-16 shapes, a width off the 16-byte access (one
    element per access), the widest row and a one-wide row."""
    g = torch.Generator(device=dev).manual_seed(16)
    x = (torch.randn(shape, device=dev, generator=g) * 2 + 0.5).to(dtype)
    scale = torch.randn(shape[-1], device=dev, generator=g) + 1
    bias = torch.randn(shape[-1], device=dev, generator=g)
    before = tln.fused_layer_norm.launches
    got = tln.fused_layer_norm(x, scale, bias)
    assert tln.fused_layer_norm.launches == before + 1 and got.dtype == dtype
    tol = tln.F32_TOL if dtype == torch.float32 else tln.BF16_TOL
    torch.testing.assert_close(got.float(), tln._reference_ln(x, scale, bias, 1e-5).float(),
                               rtol=tol, atol=tol)


def test_layer_norm_kernel_misaligned_view_and_module_grads(dev):
    """A row view that starts off a 16-byte boundary, and LayerNormFused's
    gradients on the card against autograd of the plain version."""
    from wealy_tpu_torch.models.layers import LayerNormFused

    g = torch.Generator(device=dev).manual_seed(17)
    flat = torch.randn(6 * 384 + 1, device=dev, generator=g).bfloat16()
    x = flat[1:].view(6, 384)  # 2 bytes past the allocation's start
    scale, bias = torch.ones(384, device=dev), torch.zeros(384, device=dev)
    torch.testing.assert_close(tln.fused_layer_norm(x, scale, bias).float(),
                               tln._reference_ln(x, scale, bias, 1e-5).float(),
                               rtol=tln.BF16_TOL, atol=tln.BF16_TOL)
    mod = LayerNormFused(512).to(dev)
    with torch.no_grad():
        mod.scale.mul_(1.5)
        mod.bias.add_(0.25)
    x = torch.randn(4, 33, 512, device=dev, generator=g).requires_grad_()
    r = torch.randn(4, 33, 512, device=dev, generator=g)
    (mod(x) * r).sum().backward()
    leaves = [t.detach().requires_grad_() for t in (x, mod.scale, mod.bias)]
    (tln._reference_ln(*leaves, 1e-5) * r).sum().backward()
    for got, want in zip((x.grad, mod.scale.grad, mod.bias.grad), leaves):
        torch.testing.assert_close(got, want.grad, rtol=1e-5, atol=1e-6)


def test_resident_serving_matches_host_on_card(dev, tmp_path):
    """QueryEngine on the card: the resident corpus (f16 and int8, several
    blocks, s1 > s2 queries) gives the host path's rankings and scores, and
    the CPU engine's, through K4."""
    import json

    from wealy_tpu_torch.cli.serve import INDEX_VERSION, QueryEngine
    from wealy_tpu_torch.train.config import Config

    rng = np.random.default_rng(18)
    n, smax, zdim = 37, 5, 16
    sets = rng.normal(size=(n, smax, zdim)).astype(np.float16)
    mask = np.arange(smax)[None, :] < rng.integers(1, smax + 1, n)[:, None]
    sets[~mask] = 0
    vecs = (sets.astype(np.float32) * mask[..., None]).sum(1) / mask.sum(1, keepdims=True)
    idx = tmp_path / "idx.npz"
    np.savez(idx, version_keys=np.asarray([str(i) for i in range(n)]),
             cliques=np.asarray([f"c{i // 2}" for i in range(n)]),
             labels=(np.arange(n) // 2).astype(np.int32), ids=np.arange(n, dtype=np.int64),
             vecs=vecs.astype(np.float32), sets=sets, set_mask=mask,
             meta=np.asarray(json.dumps({
                 "index_version": INDEX_VERSION, "model": "whisper", "zdim": zdim,
                 "split": "test", "checkpoint_step": None, "embedding_file": "hs_last_seq.npz",
                 "emb_dim": 24, "chunk_size": 4, "overlap": 0.5, "has_sets": True})))
    config = Config.from_dict({"path": {"lyric_covers_data": "/n", "hidden_states": "/n",
                                        "cache": "/n"},
                               "data": {"dataset_name": "lyric-covers", "chunk_size": 4},
                               "model": {"name": "whisper", "zdim": zdim}})
    seqs = [rng.normal(size=(T, 24)).astype(np.float32) for T in (5, 30, 9)]  # s1 1-14

    def payloads(**kw):
        eng = QueryEngine(config, str(idx), None, block_size=8, **kw)
        return [eng.search_many(seqs, k=6, rerank=r) for r in (0, 10)]

    before = bpwr_block_redux.launches
    resident = payloads(device=dev)
    assert bpwr_block_redux.launches > before
    for other in (payloads(device=dev, resident=False), payloads(device="cpu"),
                  payloads(device=dev, quantize="int8")):
        for got, want in zip(other, resident):
            for g_, w in zip(got, want):
                assert [r["version_key"] for r in g_["results"]][:1] == \
                    [r["version_key"] for r in w["results"]][:1]
                np.testing.assert_allclose([r["score"] for r in g_["results"]],
                                           [r["score"] for r in w["results"]], atol=1.5e-2)
    for got, want in zip(payloads(device=dev, resident=False), resident):
        for g_, w in zip(got, want):
            assert [r["version_key"] for r in g_["results"]] == \
                [r["version_key"] for r in w["results"]]
            np.testing.assert_allclose([r["score"] for r in g_["results"]],
                                       [r["score"] for r in w["results"]], atol=1e-4)
