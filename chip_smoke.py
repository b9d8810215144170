#!/usr/bin/env python3
"""Smoke test of the PyTorch port (wealy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each against
its plain PyTorch version at the shapes its path gives it (K2's row
log-sum-exp against logsumexp of the f32 scores, phase 4; K3 at the
narrowest and widest Whisper width, timed with the bf16 cuBLAS chain,
phase 5; K4 bit-equal on every route, at the evaluate block, the serving
blocks and tiles beyond 128 chunks, phase 9; the attention
backward K5a/K5b against autograd of the plain attention, and on rows whose
softmax is nearly one-hot against f32 autograd, phase 12), drives
extract_song at whisper-tiny (card against CPU) and at large-v3-turbo full
width (random weights from a seed), times the whisper-tiny embedding
pipeline, drives ``python -m wealy_tpu_torch.cli.main evaluate`` on a
synthetic project at full width (turbo ``hs_last_seq``, 1280-dim, through
the 512-wide head; monolithic and streamed; card against CPU on a subset),
times chunk-set bpwr ranking at SHS100K-TEST scale, then trains: a
whisper-tiny encoder+head step on the card against the CPU (phase 13), the
large-v3-turbo encoder + ProjectionHead(512) fine-tuned at full width and
depth (phase 14), and ``train`` then ``evaluate --checkpoint`` through the
CLI on the synthetic project (phase 15). Then K6 (LayerNorm) against its
plain version and LayerNormFused's gradients (phase 16), and serving: the
``index``/``query`` CLI on the phase-10 project, card against CPU and every
engine mode (phase 17), an exact-scan engine over a 10,547-version index
(SHS100K-TEST scale) with its latency, batched rate, rerank, int8 and the
ranks of 16 queries against the plain redux (phase 18), the ``serve``
daemon under 8 concurrent clients with a ``/reload`` (phase 19), raw
WAV queries at large-v3-turbo and whisper-tiny (phase 20), and extraction
over a split through the CLI at large-v3-turbo (phase 21): ``extract
--batched`` of ``x_concat`` (straight into the pack) and ``hs_last_seq``
over 12 audio files of three WAV formats (and one mp3 where libmpg123 and
libmp3lame exist), ``pack``, a resume that skips every version, and
``evaluate`` on the pack, with the native host library built by the
script, the rows of two songs against ``extract_song`` and the split's
first four versions at whisper-tiny card against CPU. Phase 22 drives the
CLEWS branch and the fusion models on phase 21's audio and on a fusion
project at full width (WEALY chunks 512, ``hs_last_seq`` 1280, CLEWS (116,
2048)): ``extract --kinds hs_clews`` card against CPU, ``train`` /
``evaluate`` (monolithic, ``--streaming``, ``--test-mode`` through K4) for
one name a signature with the first losses card against CPU, a fusion
``index`` and ``query --audio`` (whisper-tiny card against CPU,
large-v3-turbo p50; K1-K3), and the BatchNorm step of the class-default
ClewsEncoder card against CPU. Phase 23 transcribes phase 21's audio at
large-v3-turbo through ``transcribe``: batched greedy with a toy tokenizer
written at run time, batched beam search (K=5), the long-form ladder (and
its beam rung with an initial prompt), ``extract --batched`` through float8
KV caches beside the bf16 route (the JAX tests' bounds, teacher-forced),
and whisper-tiny card against CPU (greedy tokens up to the CPU's first
near-tie, teacher-forced logits, ``detect_language``). Phase 24 runs
``extract --batched --quant-int8`` (the W8A8 int8 encoder: K1, K2, int8
dense layers, no K3) over phase 21's split at large-v3-turbo beside the
bf16 route, holds it against the f32 encoder with the JAX test's bounds
and at whisper-tiny card against CPU, traces an extract with ``--profile``
(the device's busy share), runs ``doctor`` and holds the mesh train step
of a one-rank NCCL group against the plain step. Phase 25 runs the
parallel paths at two ranks on the one card (two gloo processes on
``cuda:0``, ``--parallel-rank``; NCCL refuses two ranks on one device, and
gloo's point-to-point operations take no CUDA tensor, so every gloo
operation is staged through the host; the phase first probes which ones
gloo takes): ``extract --batched --tp 2 --kinds hs_last_seq`` at large-v3-turbo
over phase 21's first 16 versions, the TP decode, encoder and sequence-
parallel encoder, two TP fine-tune steps (K1, K2, K3, K5a, K5b at the shard
shapes), the GPipe encoder, ring attention, a sharded chunk-set ranking and
``query --shard`` (K4), each against the one-process route, and
``graft_entry.entry()`` card against CPU. Every kernel is
timed beside its plain version, its bound (the larger of its bytes over
3.35 TB/s and its operations over the peak rate of their type) and, where
one PyTorch call computes the same function, that call. Each main-path
phase counts the launches of every kernel it drives: the kernel summary
keeps them by phase (``launches_by_phase``) and their sum (``launches``).
Every phase prints one line. At the end come the card's name and power
limit, then the kernel summary as JSON, then the result as JSON on the last
line. Any failed check
exits nonzero without the result line. Refuses to run without CUDA.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

FAILURES: list[str] = []
REPO = os.path.dirname(os.path.abspath(__file__))
# the kernels of the extraction path (phases 6-7); K4 runs on the evaluate path (phase 10)
EXTRACT_KERNELS = ("log_mel", "flash_mha", "fused_mlp")
# K2's lse against logsumexp of the plain f32 scores: the kernel's exp2/log2
# and running max against torch's exp/log, in f32
LSE_RTOL, LSE_ATOL = 1e-4, 1e-4
# an H100 SXM's published peaks (dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def bound(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the peak rate of ``kind``,
    and which of the two it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
        print(f"FAILED: {what}", flush=True)
    return ok


def say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over ``iters`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Mean device time of fn() over ``iters`` launches, after a warm-up,
    with the launches queued behind a device-side sleep that outlasts their
    enqueueing: the events then time the device alone, also where fn's host
    side (autograd, a library's dispatch) takes longer than its kernels."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # one call's enqueueing, a bound for the rest
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(4e9, 4e9 * iters * host_s) + 2e6))  # cycles, about 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def turns_ms(fns: dict, order, reps: int, iters: dict) -> dict:
    """Median device ms of each of ``fns`` timed in turns: the names in
    ``order`` (such as plain, kernel, library, kernel, plain) run one after
    another, ``reps`` times over, each turn one :func:`queued_ms` of
    ``iters[name]`` launches; so every function sees the same card state,
    and a slow turn is one reading of several."""
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name in order:
            times[name].append(queued_ms(fns[name], iters[name]))
    return {name: float(np.median(t)) for name, t in times.items()}


def attention_backward_bounds(B: int, T: int, H: int) -> dict:
    """Bounds (ms, basis) of K5a and K5b at (B, T, H, 64) bf16, and the
    pair's 5-product floor (S, dP, dQ, dK, dV: a fused backward's work,
    with every input read once and every output written once). K5a's
    function (dq and delta from q, k, v, g and lse) needs three products,
    S, dP and dQ; the kernel runs S and dP twice."""
    size = B * T * H * 64 * 2
    rows = B * H * T * 4  # f32 lse or delta
    product = 2 * B * H * T * T * 64
    return {"dq": bound(4 * size + rows + size + rows, 3 * product, "bf16"),
            "dkv": bound(4 * size + 2 * rows + 2 * size, 4 * product, "bf16"),
            "floor": bound(4 * size + rows + 3 * size, 5 * product, "bf16")}


def min_row_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1, eps=1e-30).min().item()


def log_mel_bound(audio, out, melw) -> tuple[float, str]:
    """K1's bound on an FFT route: one read of the audio and of the
    filterbank's nonzeros, one write of the log-mel; per frame, the window
    (1 per sample), a real FFT of N_FFT points (2.5 N log2 N), the power
    spectrum (3 per bin), the mel product over the filterbank's nonzeros (2
    each: a sparse product) and the log (1 per mel bin)."""
    from wealy_tpu_torch.audio import mel as tmel

    nnz = int((melw != 0).sum())
    frames = out.shape[0] * out.shape[-1]
    per_frame = (tmel.N_FFT + 2.5 * tmel.N_FFT * math.log2(tmel.N_FFT) + 3 * tmel.N_FREQS
                 + 2 * nnz + out.shape[1])
    return bound(audio.numel() * 4 + nnz * 4 + out.numel() * 4, frames * per_frame, "f32")


def bpwr_bound(d, qvalid, cvalid) -> tuple[float, str, float]:
    """K4's bound on this data: one read of the (Q, B, s1, s2) f32 tile and
    the masks, one write of the (Q, B) result; per pair, one knockout round
    for each row and column pair it removes (min of the valid rows and
    columns, without ties), each round two compare passes over the tile.
    The third value is the compare-count floor alone (ms): every round's
    one pass of compares over the valid tile, at the f32 rate."""
    Q, B, s1, s2 = d.shape
    nq, nc = qvalid.sum(1).double(), cvalid.sum(1).double()
    rounds = torch.minimum(nq[:, None], nc[None, :]).sum().item()
    t, basis = bound(d.numel() * 4 + qvalid.numel() + cvalid.numel() + Q * B * 4,
                     rounds * 2 * s1 * s2, "f32")
    compares = (torch.minimum(nq[:, None], nc[None, :]) * nq[:, None] * nc[None, :]).sum().item()
    return t, basis, compares / PEAK_OPS_PER_S["f32"] * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from wealy_tpu_torch import _build
    from wealy_tpu_torch.audio import fused_mel
    from wealy_tpu_torch.audio import mel as tmel
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.models.whisper.extract import (
        decoder_embeddings,
        encoder_embeddings,
        extract_song,
    )
    from wealy_tpu_torch.models.whisper.model import Whisper
    from wealy_tpu_torch.ops import BF16_GRAD_COS_MIN, NOISE_ROW_FLOOR, bf16_agreement
    from wealy_tpu_torch.ops.flash_attention import (
        _reference_mha,
        _reference_mha_grads,
        flash_mha,
        flash_mha_bwd_dkv,
        flash_mha_bwd_dq,
        flash_mha_fwd,
    )
    from wealy_tpu_torch.ops.fused_mlp import _reference_mlp, fused_mlp
    from wealy_tpu_torch.ops.bpwr_redux import (
        _reference_bpwr_block,
        bpwr_block_redux,
        kernel_route,
    )
    from wealy_tpu_torch.ops import layer_norm as tln

    # plain versions and decode logits are f32 products: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi: no output"
    say(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | {smi}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log = (_build.build().parent / "build.log").read_text()
    regs = [ln.split("info    : ")[-1] for ln in log.splitlines() if "registers" in ln]
    say(f"[2 build] nvcc {'%.1f s' % built if built is not None else 'cached'}, "
        f"load {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(regs)}")

    kernels = {}

    def record(name, source, replaces, err, ms, plain_ms, shape, bnd, library_ms=None):
        """The first shape recorded is the kernel's headline (its times,
        bound and shape go into the summary); max_abs_err covers every
        shape. ``bnd`` is (bound ms, "bytes" or "operations")."""
        k = kernels.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "launches_by_phase": {}, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms, "shape": shape,
        })
        k["max_abs_err"] = max(k["max_abs_err"], err)

    def fmt_bound(bnd, library_ms, library="library") -> str:
        lib = f"{library_ms:.3f} ms" if library_ms is not None else "none"
        return f"; bound {bnd[0]:.4f} ms ({bnd[1]}), {library} {lib}"

    # 3. K1 log-mel against its plain version (f32, TF32 off); the library
    # call is a torch.stft log-mel, counted only where it holds K1's
    # tolerance. The headline B=8 first (record() keeps it), then phase 8's
    # B=64; kernel, plain version and library call timed in turns (plain,
    # kernel, library, kernel, plain) three times over, medians, launches
    # queued behind a device sleep so that the wrapper's host cost does not
    # set the reading
    window = torch.hann_window(tmel.N_FFT, device=dev)

    def stft_log_mel(a, n_mels):
        spec = torch.stft(a, tmel.N_FFT, tmel.HOP_LENGTH, window=window, return_complex=True)
        mel = tmel.bases(n_mels, dev)[2].T @ spec[..., :-1].abs().square()
        return tmel.finish_log_mel(torch.log10(torch.clamp_min(mel, 1e-10)))

    for B, n_mels in ((8, 80), (8, 128), (64, 80)):
        audio = torch.randn(B, tmel.N_SAMPLES, device=dev, generator=gen) * 0.1
        got = log_mel_spectrogram_fused(audio, n_mels)
        want = tmel.log_mel_spectrogram(audio, n_mels)
        err = (got - want).abs().max().item()
        ok = check(torch.allclose(got, want, rtol=fused_mel.RTOL, atol=fused_mel.ATOL),
                   f"K1 B={B} n_mels={n_mels} outside rtol {fused_mel.RTOL} / atol "
                   f"{fused_mel.ATOL} (max abs {err:.3g})")
        lib_out = stft_log_mel(audio, n_mels)
        lib_err = (lib_out - want).abs().max().item()
        lib_ok = torch.allclose(lib_out, want, rtol=fused_mel.RTOL, atol=fused_mel.ATOL)
        del lib_out
        med = turns_ms({"kernel": lambda: log_mel_spectrogram_fused(audio, n_mels),
                        "plain": lambda: tmel.log_mel_spectrogram(audio, n_mels),
                        "library": lambda: stft_log_mel(audio, n_mels)},
                       ("plain", "kernel", "library", "kernel", "plain"), 3,
                       {"kernel": 20, "plain": 5, "library": 10})
        lib = med["library"] if lib_ok else None
        bnd = log_mel_bound(audio, got, tmel.bases(n_mels, dev)[2])
        say(f"[3 K1 log_mel] B={B} n_mels={n_mels}: max_abs_err {err:.3g} "
            f"{'ok' if ok else 'FAIL'}; medians of 3 rounds of turns: kernel {med['kernel']:.4f} "
            f"ms, plain {med['plain']:.4f} ms" + fmt_bound(bnd, lib, "torch.stft mel")
            + f" (its max abs {lib_err:.3g}, {'within' if lib_ok else 'outside'} K1's "
            f"tolerance; ratio {med['kernel'] / med['library']:.3f})")
        record("log_mel", "wealy_tpu_torch/csrc/log_mel.cu",
               "wealy_tpu/audio/pallas_mel.py:40", err, med["kernel"], med["plain"],
               f"B={B} n_mels={n_mels}", bnd, lib)
    del audio, got, want

    # 4. K2 attention against _reference_mha (bf16), its lse against
    # logsumexp of the plain f32 scores; the headline (4, 1500, 6) first,
    # then phase 14's fine-tune shape (8, 1500, 20) and phase 8's
    # whisper-tiny batch (64, 1500, 6); timed in turns with SDPA's forward
    for B, T, H in ((4, 1500, 6), (2, 1500, 20), (2, 257, 6), (8, 1500, 20), (64, 1500, 6)):
        q, k, v = (torch.randn(B, T, H, 64, device=dev, generator=gen).bfloat16()
                   for _ in range(3))
        got, lse = flash_mha_fwd(q, k, v, 0.125, with_lse=True)
        ok, err, cos = bf16_agreement(got, _reference_mha(q, k, v, 0.125))
        check(ok, f"K2 B={B} T={T} H={H}: cos {cos:.6f} max abs {err:.3g}")
        want_lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 0.125,
                                   dim=-1)
        lse_err = (lse - want_lse).abs().max().item()
        lse_ok = check(torch.allclose(lse, want_lse, rtol=LSE_RTOL, atol=LSE_ATOL),
                       f"K2 B={B} T={T} H={H}: lse max abs {lse_err:.3g} outside rtol "
                       f"{LSE_RTOL} / atol {LSE_ATOL}")
        del want_lse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, T, Dh) views
        med = turns_ms({"kernel": lambda: flash_mha(q, k, v, 0.125),
                        "plain": lambda: _reference_mha(q, k, v, 0.125),
                        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          scale=0.125)},
                       ("plain", "kernel", "library", "kernel", "plain"), 3,
                       {"kernel": 20, "plain": 2, "library": 20})
        bnd = bound(4 * q.numel() * 2, 4 * B * H * T * T * 64, "bf16")
        say(f"[4 K2 flash_mha] B={B} T={T} H={H} Dh=64: max_abs_err {err:.3g} min_cos "
            f"{cos:.6f} {'ok' if ok else 'FAIL'}, lse max abs {lse_err:.3g} "
            f"{'ok' if lse_ok else 'FAIL'}; medians of 3 rounds of turns: kernel "
            f"{med['kernel']:.4f} ms ({4 * B * H * T * T * 64 / med['kernel'] / 1e9:.1f} "
            f"TFLOP/s), plain {med['plain']:.3f} ms"
            + fmt_bound(bnd, med["library"], "F.scaled_dot_product_attention")
            + f" (ratio {med['kernel'] / med['library']:.3f})")
        record("flash_mha", "wealy_tpu_torch/csrc/flash_attention.cu",
               "wealy_tpu/ops/flash_attention.py:56", err, med["kernel"], med["plain"],
               f"B={B} T={T} H={H} Dh=64", bnd, med["library"])
    del q, k, v, qt, kt, vt, got, lse
    torch.cuda.empty_cache()

    # 5. K3 MLP against _reference_mlp (bf16 operands, f32 biases) at the
    # narrowest and the widest Whisper width; timed in turns (plain, kernel,
    # library, kernel, plain) with the bf16 cuBLAS chain F.linear -> F.gelu
    # -> F.linear as the library call; the headline N=6000, D=384 first
    for D in (384, 1280):
        w1 = (torch.randn(4 * D, D, device=dev, generator=gen) * D**-0.5).bfloat16()
        w2 = (torch.randn(D, 4 * D, device=dev, generator=gen) * (4 * D) ** -0.5).bfloat16()
        b1 = torch.randn(4 * D, device=dev, generator=gen) * 0.1
        b2 = torch.randn(D, device=dev, generator=gen) * 0.1
        b1h, b2h = b1.bfloat16(), b2.bfloat16()
        for N in (4 * 1500, 4507):
            x = torch.randn(N, D, device=dev, generator=gen).bfloat16()
            got, want = fused_mlp(x, w1, b1, w2, b2), _reference_mlp(x, w1, b1, w2, b2)
            ok, err, cos = bf16_agreement(got, want)
            check(ok, f"K3 D={D} N={N}: cos {cos:.6f} max abs {err:.3g}")
            med = turns_ms({"kernel": lambda: fused_mlp(x, w1, b1, w2, b2),
                            "plain": lambda: _reference_mlp(x, w1, b1, w2, b2),
                            "library": lambda: F.linear(F.gelu(F.linear(x, w1, b1h)), w2, b2h)},
                           ("plain", "kernel", "library", "kernel", "plain"), 3,
                           {"kernel": 20, "plain": 5, "library": 20})
            flops = 2 * 2 * N * D * 4 * D
            bnd = bound(2 * N * D * 2 + 2 * 4 * D * D * 2 + 5 * D * 4, flops, "bf16")
            say(f"[5 K3 fused_mlp] N={N} D={D}: max_abs_err {err:.3g} min_cos {cos:.6f} "
                f"{'ok' if ok else 'FAIL'}; medians of 3 rounds of turns: kernel "
                f"{med['kernel']:.4f} ms ({flops / med['kernel'] / 1e9:.1f} TFLOP/s), plain "
                f"{med['plain']:.3f} ms" + fmt_bound(bnd, med["library"], "bf16 cuBLAS chain")
                + f" (ratio {med['kernel'] / med['library']:.3f})")
            record("fused_mlp", "wealy_tpu_torch/csrc/fused_mlp.cu",
                   "wealy_tpu/ops/fused_mlp.py:44", err, med["kernel"], med["plain"],
                   f"N={N} D={D}", bnd, med["library"])
    del x, w1, w2, b1, b2, b1h, b2h, got, want

    # 9. K4 bpwr against its plain version (bit-equal by design; bound 1e-6)
    def bpwr_case(shape, view=False, p_invalid=0.2, ties=False):
        Q, B, s1, s2 = shape
        if view:  # the rank passes' view of a (Q*s1, B*s2) cosine-distance matrix
            d = (torch.rand(Q * s1, B * s2, device=dev, generator=gen) * 2).reshape(
                Q, s1, B, s2).permute(0, 2, 1, 3)
        else:
            d = torch.rand(Q, B, s1, s2, device=dev, generator=gen) * 2
        if ties:
            d = torch.round(d * 4) / 4
        qv = torch.rand(Q, s1, device=dev, generator=gen) > p_invalid
        cv = torch.rand(B, s2, device=dev, generator=gen) > p_invalid
        qv[:, 0] = True
        cv[:, 0] = True
        if Q > 1:  # a query with no valid chunk: its pairs are fully excluded
            qv[0] = False
        cv[-1] = False
        return d, qv, cv

    # the headline first (record() keeps it); the serving blocks (Q=1 and
    # Q=16 against 512 songs, and 16 queries of 40 chunks, longer than the
    # index's songs) timed too, in turns with the plain version; tiles
    # beyond 32 chunks take the block route, the last (410 KB of f32)
    # beyond the opt-in shared memory
    timed = ("headline", "serving Q=1", "serving Q=16", "long queries")
    for label, shape, kw in (
        ("headline", (222, 222, 18, 18), dict(view=True)),
        ("serving Q=1", (1, 512, 18, 18), dict(view=True)),
        ("serving Q=16", (16, 512, 18, 18), dict(view=True)),
        ("long queries", (16, 512, 40, 18), dict(view=True)),
        ("two pairs a warp", (64, 64, 12, 16), {}),
        ("s1>s2", (64, 96, 24, 10), {}),
        ("s=1", (512, 512, 1, 1), {}),
        ("40x40", (32, 48, 40, 40), {}),
        ("128", (4, 8, 128, 128), {}),
        ("150x300", (2, 3, 150, 300), {}),
        ("320x320", (2, 2, 320, 320), {}),
        ("masked rows", (16, 32, 12, 12), dict(p_invalid=0.5)),
        ("exact ties", (8, 8, 6, 6), dict(ties=True)),
    ):
        d, qv, cv = bpwr_case(shape, **kw)
        Q = shape[0]
        got = bpwr_block_redux(d, qv, cv)
        again = bpwr_block_redux(d, qv, cv)
        want = _reference_bpwr_block(d, qv, cv, "bpwr", 1e-7, 1e12)
        err = (got - want).abs().max().item()
        same = torch.equal(got, again)
        zero_rows = (Q == 1 or bool((got[0] == 0).all())) and bool((got[:, -1] == 0).all())
        ok = check(torch.equal(got, want) and same and zero_rows and bool(torch.isfinite(got).all()),
                   f"K4 {label} {shape}: max abs {err:.3g}, repeat bit-equal {same}, "
                   f"excluded pairs zero {zero_rows}")
        ms = plain = None
        bnd = bpwr_bound(d, qv, cv)
        if label in timed:
            med = turns_ms({"kernel": lambda: bpwr_block_redux(d, qv, cv),
                            "plain": lambda: _reference_bpwr_block(d, qv, cv, "bpwr", 1e-7, 1e12)},
                           ("plain", "kernel", "kernel", "plain"), 3, {"kernel": 20, "plain": 3})
            ms, plain = med["kernel"], med["plain"]
        say(f"[9 K4 bpwr_redux] {label} Q,B,s1,s2={shape} ({kernel_route(*shape[2:])} route): "
            f"max_abs_err {err:.3g}, bit-equal {torch.equal(got, want)}, repeat bit-equal {same} "
            f"{'ok' if ok else 'FAIL'}"
            + (f"; medians of 3 rounds of turns: kernel {ms:.4f} ms, plain {plain:.3f} ms"
               + fmt_bound(bnd, None) + f", compare-count floor {bnd[2]:.4f} ms"
               if ms is not None else ""))
        record("bpwr_redux", "wealy_tpu_torch/csrc/bpwr_redux.cu",
               "wealy_tpu/ops/pallas_redux.py:67", err, ms, plain, f"Q,B,s1,s2={shape}", bnd[:2])
    del d, qv, cv

    # 12. K5a/K5b against autograd of _reference_mha (bf16): dQ, dK, dV
    def plain_backward(q, k, v, g, wrt):
        """Autograd of the plain attention with respect to ``wrt`` (indices
        into q, k, v): returns a closure that runs the backward alone."""
        leaves = [t.detach().requires_grad_(i in wrt) for i, t in enumerate((q, k, v))]
        with torch.enable_grad():
            out = _reference_mha(*leaves, 0.125)
        wanted = [leaves[i] for i in wrt]
        return lambda: torch.autograd.grad(out, wanted, g, retain_graph=True)

    # the headline (4, 1500, 6) first (record() keeps it), then phase 14's
    # fine-tune shape (8, 1500, 20); timed in turns (plain, kernel, SDPA,
    # kernel, plain) three times over, medians
    for B, T, H in ((4, 1500, 6), (2, 1500, 20), (8, 1500, 20), (2, 257, 6)):
        q, k, v, g = (torch.randn(B, T, H, 64, device=dev, generator=gen).bfloat16()
                      for _ in range(4))
        _, lse = flash_mha_fwd(q, k, v, 0.125, with_lse=True)
        dq, delta = flash_mha_bwd_dq(q, k, v, g, lse, 0.125)
        dk, dv = flash_mha_bwd_dkv(q, k, v, g, lse, delta, 0.125)
        dq2, delta2 = flash_mha_bwd_dq(q, k, v, g, lse, 0.125)
        dk2, dv2 = flash_mha_bwd_dkv(q, k, v, g, lse, delta2, 0.125)
        same = all(torch.equal(a, b) for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)))
        plain_dq, plain_dkv = plain_backward(q, k, v, g, (0,)), plain_backward(q, k, v, g, (1, 2))
        want = (*plain_dq(), *plain_dkv())
        agree = [bf16_agreement(got, w, BF16_GRAD_COS_MIN) for got, w in zip((dq, dk, dv), want)]
        del want
        ok = check(all(a[0] for a in agree) and same,
                   f"K5a/K5b B={B} T={T} H={H}: (ok, max abs, min cos) dq/dk/dv {agree}, "
                   f"repeat bit-equal {same}")
        # the library call: SDPA's backward, dq, dk and dv together (K5a + K5b)
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            sdpa = F.scaled_dot_product_attention(*leaves, scale=0.125)
        gt = g.transpose(1, 2)
        fns = {"plain_dq": plain_dq, "plain_dkv": plain_dkv,
               "dq": lambda: flash_mha_bwd_dq(q, k, v, g, lse, 0.125),
               "dkv": lambda: flash_mha_bwd_dkv(q, k, v, g, lse, delta, 0.125),
               "sdpa": lambda: torch.autograd.grad(sdpa, leaves, gt, retain_graph=True)}
        med = turns_ms(fns, ("plain_dq", "plain_dkv", "dq", "dkv", "sdpa", "dq", "dkv",
                             "plain_dq", "plain_dkv"), 3,
                       {"plain_dq": 2, "plain_dkv": 2, "dq": 10, "dkv": 10, "sdpa": 10})
        shape = f"B={B} T={T} H={H} Dh=64"
        bnd = attention_backward_bounds(B, T, H)
        pair = med["dq"] + med["dkv"]
        say(f"[12 K5a/K5b attention backward] {shape}: dq/dk/dv max_abs_err "
            f"{agree[0][1]:.3g}/{agree[1][1]:.3g}/{agree[2][1]:.3g} min_cos "
            f"{agree[0][2]:.6f}/{agree[1][2]:.6f}/{agree[2][2]:.6f}, repeat bit-equal {same} "
            f"{'ok' if ok else 'FAIL'}; medians of 3 rounds of turns: K5a {med['dq']:.4f} ms (plain dq "
            f"{med['plain_dq']:.3f} ms, bound {bnd['dq'][0]:.4f} ms {bnd['dq'][1]}), K5b "
            f"{med['dkv']:.4f} ms (plain dk+dv {med['plain_dkv']:.3f} ms, bound "
            f"{bnd['dkv'][0]:.4f} ms {bnd['dkv'][1]}); K5a+K5b {pair:.4f} ms, SDPA backward "
            f"(dq+dk+dv) {med['sdpa']:.4f} ms, ratio {pair / med['sdpa']:.2f}; the pair's "
            f"5-product floor {bnd['floor'][0]:.4f} ms")
        record("flash_mha_bwd_dq", "wealy_tpu_torch/csrc/flash_attention_bwd.cu",
               "wealy_tpu/ops/flash_attention.py:171", agree[0][1], med["dq"], med["plain_dq"],
               shape, bnd["dq"], med["sdpa"])
        record("flash_mha_bwd_dkv", "wealy_tpu_torch/csrc/flash_attention_bwd.cu",
               "wealy_tpu/ops/flash_attention.py:197", max(agree[1][1], agree[2][1]), med["dkv"],
               med["plain_dkv"], shape, bnd["dkv"], med["sdpa"])
        del fns
    del sdpa, leaves, plain_dq, plain_dkv, dk, dv, dq2, dk2, dv2

    # the nearly one-hot case: q and k scaled 3.7x at the headline shape
    # (scaled scores to about +-75). The bf16 plain route itself falls below
    # the gate against f32 autograd of the same bf16 inputs here, so the
    # kernels are held to the f32 autograd, dq's rows below NOISE_ROW_FLOOR
    # of the RMS row norm by the max-abs bound alone; repeats bit-equal
    B, T, H = 4, 1500, 6
    q, k = ((torch.randn(B, T, H, 64, device=dev, generator=gen) * 3.7).bfloat16()
            for _ in range(2))
    v, g = (torch.randn(B, T, H, 64, device=dev, generator=gen).bfloat16() for _ in range(2))
    _, lse = flash_mha_fwd(q, k, v, 0.125, with_lse=True)
    runs = []
    for _ in range(2):
        dq, delta = flash_mha_bwd_dq(q, k, v, g, lse, 0.125)
        runs.append((dq, delta, *flash_mha_bwd_dkv(q, k, v, g, lse, delta, 0.125)))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    want = _reference_mha_grads(*(t.float() for t in (q, k, v, g)), 0.125)
    agree = [bf16_agreement(got, w, BF16_GRAD_COS_MIN, NOISE_ROW_FLOOR)
             for got, w in zip((runs[0][0], *runs[0][2:]), want)]
    plain_cos = [bf16_agreement(p, w)[2]
                 for p, w in zip(_reference_mha_grads(q, k, v, g, 0.125), want)]
    rows = want[0].float().reshape(-1, 64).norm(dim=-1)
    noise_rows = int((rows < NOISE_ROW_FLOOR * rows.square().mean().sqrt()).sum())
    smax = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).amax(-1) * 0.125
    one_hot = ((smax - lse).exp() > 0.99).float().mean().item()
    del runs, want, smax
    ok = check(all(a[0] for a in agree) and same,
               f"K5a/K5b one-hot rows B={B} T={T} H={H}: (ok, max abs, min cos) dq/dk/dv "
               f"{agree} against f32 autograd, repeat bit-equal {same}")
    say(f"[12 K5a/K5b attention backward] nearly one-hot rows, q and k x3.7 at B={B} T={T} "
        f"H={H} ({100 * one_hot:.1f}% of rows with max p > 0.99): against f32 autograd of the "
        f"same bf16 inputs dq/dk/dv max_abs_err {agree[0][1]:.3g}/{agree[1][1]:.3g}/"
        f"{agree[2][1]:.3g} min_cos {agree[0][2]:.6f}/{agree[1][2]:.6f}/{agree[2][2]:.6f} "
        f"({noise_rows} dq rows below {NOISE_ROW_FLOOR:g} of the RMS row norm held by max abs "
        f"alone), repeat bit-equal {same} {'ok' if ok else 'FAIL'}; the bf16 plain route's "
        f"min_cos against the same {plain_cos[0]:.4f}/{plain_cos[1]:.4f}/{plain_cos[2]:.4f}")
    del q, k, v, g, lse, dq, delta
    torch.cuda.empty_cache()

    # 16. K6 against _reference_ln at the JAX docstring's shape, turbo width,
    # a ragged row count and f32; the library call is F.layer_norm, which
    # refuses bf16 input with f32 weights on the card, so it runs on the f32
    # upcast and casts back
    for shape, dtype in (((64, 1500, 384), torch.bfloat16), ((8, 1500, 1280), torch.bfloat16),
                         ((4507, 1280), torch.bfloat16), ((3, 70, 384), torch.float32)):
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        scale = torch.randn(shape[-1], device=dev, generator=gen) + 1
        bias = torch.randn(shape[-1], device=dev, generator=gen)
        got, want = tln.fused_layer_norm(x, scale, bias), tln._reference_ln(x, scale, bias, 1e-5)
        tol = tln.F32_TOL if dtype == torch.float32 else tln.BF16_TOL
        err = (got.float() - want.float()).abs().max().item()
        # representable bf16 steps between kernel and plain outputs, where
        # |plain| >= 1/8 (nearer 0 the affine transform cancels, and an f32
        # difference of 1e-7 spans many of bf16's fine steps there)
        big = want.float().abs() >= 0.125
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int())[big].abs().max().item() \
            if dtype == torch.bfloat16 else 0
        ok = check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                   f"K6 {tuple(shape)} {dtype}: max abs {err:.3g} outside rtol/atol {tol}")
        ms = cuda_ms(lambda: tln.fused_layer_norm(x, scale, bias), 20)
        plain = cuda_ms(lambda: tln._reference_ln(x, scale, bias, 1e-5), 20)
        D = shape[-1]
        if dtype == torch.float32:
            lib = cuda_ms(lambda: F.layer_norm(x, (D,), scale, bias, 1e-5), 20)
        else:
            lib = cuda_ms(lambda: F.layer_norm(x.float(), (D,), scale, bias, 1e-5).to(dtype), 20)
        bnd = bound(2 * x.numel() * x.element_size() + 2 * D * 4, 8 * x.numel(), "f32")
        say(f"[16 K6 layer_norm] {tuple(shape)} {str(dtype)[6:]}: max_abs_err {err:.3g}"
            + (f" (at most {ulps} bf16 ulps apart where |plain| >= 1/8)"
               if dtype == torch.bfloat16 else "")
            + f" {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain:.4f} ms"
            + fmt_bound(bnd, lib, "F.layer_norm" + (" on the f32 upcast" if dtype != torch.float32
                                                    else "")))
        record("layer_norm", "wealy_tpu_torch/csrc/layer_norm.cu",
               "wealy_tpu/ops/layer_norm.py:26", err, ms, plain, f"{tuple(shape)} {dtype}", bnd,
               lib)
    del x, got, want

    reset_counts, counts = launch_counters()

    def tally(phase: str, launched: dict) -> None:
        """Each kernel's launches in one main-path run (counts set to 0
        just before it, read just after): the kernels line keeps them by
        phase, and ``launches`` is their sum."""
        for name, n in launched.items():
            if n:
                k = kernels[name]
                k["launches_by_phase"][phase] = n
                k["launches"] = sum(k["launches_by_phase"].values())

    # 16 (main path). LayerNormFused, forward and backward, on the card
    # against autograd of the plain version (f32: rtol 1e-5, atol 1e-6)
    tally("16 LayerNormFused", layer_norm_module_phase(dev, gen, reset_counts, counts))

    # 6. whisper-tiny slice, card against CPU, the same seeded weights
    cpu_model, cfg = load_whisper_model("tiny", seed=0, device="cpu", dtype=torch.bfloat16)
    card_model = Whisper(cfg, dtype=torch.bfloat16, device=dev).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    clip = (0.1 * np.random.default_rng(0).normal(size=tmel.N_SAMPLES)).astype(np.float32)
    kinds = ("x_concat", "hs_last_seq")
    reset_counts()
    t0 = time.perf_counter()
    card = extract_song(card_model, clip, cfg, kinds=kinds, max_len=64)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    tiny_counts = counts()
    tally("6 whisper-tiny extract_song", tiny_counts)
    t0 = time.perf_counter()
    cpu = extract_song(cpu_model, clip, cfg, kinds=kinds, max_len=64)
    cpu_s = time.perf_counter() - t0
    xcos = min_row_cos(torch.from_numpy(card["x_concat"]), torch.from_numpy(cpu["x_concat"]))
    check(xcos >= 0.999, f"tiny x_concat card vs CPU cosine {xcos:.6f} < 0.999")
    with torch.no_grad():
        mel_card = log_mel_spectrogram_fused(torch.from_numpy(clip[None]).to(dev), cfg.n_mels)
        mel_cpu = tmel.log_mel_spectrogram(torch.from_numpy(clip[None]), cfg.n_mels)
        dc = decoder_embeddings(card_model, mel_card, cfg, max_len=64)
        dp = decoder_embeddings(cpu_model, mel_cpu, cfg, max_len=64)
    tc, tp = dc["tokens"][0].cpu(), dp["tokens"][0]
    diff = (tc != tp).nonzero()
    prefix = int(diff[0]) if len(diff) else tc.numel()
    P = 2  # <|sot|> <|notimestamps|>
    # states are written for positions < length (< max_len - 1 without an eot)
    limit = min(prefix, int(dc["lengths"][0]), int(dp["lengths"][0]), 63)
    hcos_prompt = min_row_cos(dc["hidden"][0, :P].cpu(), dp["hidden"][0, :P])
    hcos_prefix = min_row_cos(dc["hidden"][0, :limit].cpu(), dp["hidden"][0, :limit])
    check(hcos_prompt >= 0.999, f"tiny decoder prompt states cosine {hcos_prompt:.6f}")
    check(hcos_prefix >= 0.999, f"tiny decoder common-prefix states cosine {hcos_prefix:.6f}")
    check(all(tiny_counts[k] > 0 for k in EXTRACT_KERNELS), f"tiny slice launches {tiny_counts}")
    say(f"[6 tiny slice] x_concat {card['x_concat'].shape} cos {xcos:.6f}; hs_last_seq card "
        f"{card['hs_last_seq'].shape} cpu {cpu['hs_last_seq'].shape}; tokens agree on "
        f"{prefix}/64 positions, state cos prompt {hcos_prompt:.6f} first {limit} {hcos_prefix:.6f}; "
        f"launches {tiny_counts}; card {card_s:.2f} s, cpu {cpu_s:.2f} s")
    del cpu_model, card_model

    # 7. large-v3-turbo at full width, seeded random init on the card
    model, cfg = load_whisper_model("large-v3-turbo", seed=0, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    songs = [(0.1 * rng.normal(size=65 * 16000)).astype(np.float32) for _ in range(2)]
    # warm-up at the timed shapes (3 chunks): cuBLAS/cuDNN plans, allocator
    extract_song(model, songs[0], cfg, kinds=("x_concat", "hs_last_seq"), max_len=64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = [extract_song(model, s, cfg, kinds=("x_concat", "hs_last_seq"), max_len=64)
            for s in songs]
    torch.cuda.synchronize()
    turbo_s = time.perf_counter() - t0
    turbo_counts = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        check(out["x_concat"].shape == (3, 1280), f"turbo x_concat shape {out['x_concat'].shape}")
        check(out["hs_last_seq"].ndim == 2 and out["hs_last_seq"].shape[1] == 1280,
              f"turbo hs_last_seq shape {out['hs_last_seq'].shape}")
        check(all(np.isfinite(v).all() for v in out.values()), "turbo outputs not finite")
    check(all(turbo_counts[k] > 0 for k in EXTRACT_KERNELS), f"turbo launches {turbo_counts}")
    say(f"[7 turbo slice] 2 songs x 3 chunks: x_concat {[o['x_concat'].shape for o in outs]} "
        f"hs_last_seq {[o['hs_last_seq'].shape for o in outs]}; {6 / turbo_s:.2f} clips/s "
        f"({turbo_s:.2f} s, max_len 64); peak {peak_gb:.2f} GB; launches {turbo_counts}")
    tally("7 large-v3-turbo extract_song", turbo_counts)
    del model

    # 8. throughput: whisper-tiny mel + encoder + mean pool, B=64 (bench.py's metric)
    model, cfg = load_whisper_model("tiny", seed=0, device=dev, dtype=torch.bfloat16)
    batch = torch.randn(64, tmel.N_SAMPLES, device=dev, generator=gen) * 0.1

    def embed():
        with torch.no_grad():
            return encoder_embeddings(model, log_mel_spectrogram_fused(batch, cfg.n_mels))

    ms = cuda_ms(embed, 5)
    check(bool(torch.isfinite(embed()).all()), "tiny embeddings not finite")
    say(f"[8 throughput] whisper-tiny mel+encoder+mean-pool B=64: {ms:.2f} ms/batch, "
        f"{64e3 / ms:.1f} clips/s | {smi}")

    del model, batch
    torch.cuda.empty_cache()

    # 10. evaluate through the CLI at full width on a synthetic project;
    # 17. the serving CLI on the same project
    with tempfile.TemporaryDirectory(prefix="wealy_eval_") as tmp:
        cpath, rows, eval_counts = evaluate_phase(tmp, dev, reset_counts, counts)
        tally("10 evaluate CLI", eval_counts)
        tally("17 index + query CLI", serving_cli_phase(tmp, cpath, rows, reset_counts, counts))

    # 11. chunk-set bpwr ranking at SHS100K-TEST scale
    tally("11 SHS-scale ranking", ranking_phase(dev, smi, reset_counts, counts))

    # 13-15. training
    tally("13 whisper-tiny train step", tiny_training_phase(dev, reset_counts, counts))
    tally("14 large-v3-turbo fine-tune", turbo_finetune_phase(dev, reset_counts, counts, smi))
    with tempfile.TemporaryDirectory(prefix="wealy_train_") as tmp:
        tally("15 train + evaluate CLI", train_cli_phase(tmp, dev, reset_counts, counts, smi))

    # 18-20. serving at SHS100K-TEST scale, the daemon, raw-audio queries
    with tempfile.TemporaryDirectory(prefix="wealy_serve_") as tmp:
        tally("18 serving Q=1 scans", serving_scale_phase(tmp, dev, reset_counts, counts, smi))
        tally("19 serve daemon", daemon_phase(tmp, reset_counts, counts, smi))
        audio_launches = audio_query_phase(tmp, dev, reset_counts, counts, smi)
        tally("20 query --audio", audio_launches)

    # 21. extraction over a split through the CLI at large-v3-turbo;
    # 22. the CLEWS branch and the fusion models, on phase 21's audio
    with tempfile.TemporaryDirectory(prefix="wealy_split_") as tmp:
        tally("21 extract over a split",
              extract_split_phase(tmp, dev, reset_counts, counts, smi, 6 / turbo_s))
        fusion_launches = fusion_phase(tmp, dev, reset_counts, counts, smi)
        tally("22 fusion", fusion_launches)
        # 23. transcription on phase 21's audio
        transcribe_launches = transcription_phase(tmp, dev, reset_counts, counts, smi)
        tally("23 transcription", transcribe_launches)
        # 24. the int8 encoder over phase 21's split, --profile, doctor, NCCL
        tally("24 int8 extract", quant_int8_phase(tmp, dev, reset_counts, counts, smi))
        # 25. TP, SP, PP, the ring, the sharded ranking and serving at two ranks
        parallel_launches = parallel_phase(tmp, dev, smi)
        tally("25 parallel (2 ranks)", parallel_launches)
    for name in ("log_mel", "flash_mha", "fused_mlp"):
        check(audio_launches[name] > 0, f"phase 20 launched {name} {audio_launches[name]} times")
    for name in ("log_mel", "flash_mha", "fused_mlp", "bpwr_redux"):
        check(fusion_launches[name] > 0, f"phase 22 launched {name} {fusion_launches[name]} times")
    for name in EXTRACT_KERNELS:
        check(transcribe_launches[name] > 0,
              f"phase 23 launched {name} {transcribe_launches[name]} times")
    for name in (*EXTRACT_KERNELS, "flash_mha_bwd_dq", "flash_mha_bwd_dkv", "bpwr_redux"):
        check(parallel_launches.get(name, 0) > 0,
              f"phase 25 launched {name} {parallel_launches.get(name, 0)} times")
    for k in kernels.values():
        check(k["launches"] > 0, f"{k['name']} was launched on no main path {k['launches_by_phase']}")

    if FAILURES:
        say(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    say(smi)
    say(json.dumps({"kernels": list(kernels.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def launch_counters():
    """(reset, read) of every kernel wrapper's launch count, by kernel name."""
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.ops import layer_norm as tln
    from wealy_tpu_torch.ops.bpwr_redux import bpwr_block_redux
    from wealy_tpu_torch.ops.flash_attention import flash_mha, flash_mha_bwd_dkv, flash_mha_bwd_dq
    from wealy_tpu_torch.ops.fused_mlp import fused_mlp

    counters = {"log_mel": log_mel_spectrogram_fused, "flash_mha": flash_mha,
                "flash_mha_bwd_dq": flash_mha_bwd_dq, "flash_mha_bwd_dkv": flash_mha_bwd_dkv,
                "fused_mlp": fused_mlp, "bpwr_redux": bpwr_block_redux,
                "layer_norm": tln.fused_layer_norm}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    return reset_counts, counts


def write_project(root: str, dev, n_cliques: int = 32, per_clique: int = 4, seed: int = 0,
                  train_cliques: int = 0, val_cliques: int = 0):
    """A lyric-covers project in the layout of tests/test_cli.py::project:
    CSVs (written with the stdlib csv module), a config, and per version an
    ``hs_last_seq`` of (T, 1280) fp16 with T drawn from 1000-2700 (1-18
    chunks of 1000 frames at overlap 0.9). Clique members are noisy copies
    of one base sequence. ``n_cliques`` go to the test split, then
    ``train_cliques`` and ``val_cliques`` of their own (drawn after the test
    split's, which stays the same). Returns (config path, [(version id,
    clique)] of the test split)."""
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore

    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    lc = os.path.join(root, "lc")
    os.makedirs(lc)
    store = EmbeddingStore(os.path.join(root, "hs"), "lyric-covers")
    splits = {"test": [], "train": [], "val": []}
    for split, count in (("test", n_cliques), ("train", train_cliques), ("val", val_cliques)):
        for c in range(count):
            base = torch.randn(2700, 1280, device=dev, generator=g)
            for k in range(per_clique):
                vid = 1000 + sum(map(len, splits.values())) + k
                T = int(rng.integers(1000, 2701))
                emb = base[:T] + torch.randn(T, 1280, device=dev, generator=g)
                store.save(str(vid), "hs_last_seq.npz", embeddings=emb.half().cpu().numpy())
            first = 1000 + sum(map(len, splits.values()))
            splits[split] += [(first + k, f"{split}{c}") for k in range(per_clique)]
    write_split_csvs(lc, splits)
    cpath = write_config(os.path.join(root, "conf.json"), lc, os.path.join(root, "hs"),
                         os.path.join(root, "cache"))
    return cpath, splits["test"]


def write_split_csvs(lc: str, splits: dict) -> None:
    """``{split}_no_dup.csv`` of the lyric-covers layout (stdlib csv) from
    ``{split: [(version id, clique label)]}``: a clique's first version is
    the original, the others its covers."""
    import csv

    header = ["original_id", "id", "is_cover", "song_text_type", "label"]
    for split, rows in splits.items():
        first = {}
        with open(os.path.join(lc, f"{split}_no_dup.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            for vid, label in rows:
                w.writerow([first.setdefault(label, vid), vid, first[label] != vid, "o", label])


def write_config(path: str, lc: str, hs: str, cache: str, chunk_size: int = 1000,
                 overlap: float = 0.9, **model) -> str:
    """A project config for ``hs_last_seq`` (the 512-wide head); ``model``
    adds keys such as ``whisper_size``, ``path.data`` comes with
    ``data_root``."""
    conf = {
        "path": {"lyric_covers_data": lc, "hidden_states": hs, "cache": cache},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat", "chunk_size": chunk_size,
                 "overlap_percentage": overlap},
        "model": {"name": "whisper", "zdim": 512},
    }
    if "data_root" in model:
        conf["path"]["data"] = model.pop("data_root")
    conf["model"].update(model)
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def run_cli_lines(argv) -> tuple[list, float]:
    """``python -m wealy_tpu_torch.cli.main <argv>`` in-process: (the JSON
    lines it prints, wall seconds)."""
    from wealy_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} exit {rc}")
    return [json.loads(line) for line in out.getvalue().strip().splitlines()], wall


def run_cli(argv) -> tuple[dict, float]:
    """Like :func:`run_cli_lines`: (the last JSON line, wall seconds)."""
    lines, wall = run_cli_lines(argv)
    return lines[-1], wall


def evaluate_phase(tmp: str, dev, reset_counts, counts):
    from wealy_tpu_torch.cli.main import build_parser, embed_split, evaluate, load_head
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.train.config import Config

    t0 = time.perf_counter()
    cpath, rows = write_project(tmp, dev)
    setup_s = time.perf_counter() - t0
    n = len(rows)
    base = ["evaluate", "--config", cpath, "--split", "test", "--redux", "bpwr"]
    reset_counts()
    mono, mono_s = run_cli(base)
    streamed, streamed_s = run_cli(base + ["--streaming", "--chunk-sets"])
    eval_counts = counts()
    keys = ("MAP", "MR1", "P@10", "n_queries")
    check(all(mono[k] == streamed[k] for k in keys),
          f"evaluate monolithic {mono} != streamed {streamed}")
    check(eval_counts["bpwr_redux"] > 0, f"evaluate launched K4 {eval_counts['bpwr_redux']} times")
    check(mono["n_queries"] == n and mono["MAP"] > 0.5,
          f"evaluate metrics {mono} (chance MAP is about 0.03)")

    # card against CPU on a 16-version subset, the same seeded head
    sub = os.path.join(tmp, "subset")
    os.makedirs(os.path.join(sub, "lc"))
    for split in ("train", "val", "test"):
        with open(os.path.join(tmp, "lc", f"{split}_no_dup.csv")) as f:
            lines = f.read().splitlines()
        with open(os.path.join(sub, "lc", f"{split}_no_dup.csv"), "w") as f:
            f.write("\n".join(lines[:17] if split == "test" else lines) + "\n")
    conf = json.load(open(cpath))
    conf["path"]["lyric_covers_data"] = os.path.join(sub, "lc")
    conf["path"]["cache"] = os.path.join(sub, "cache")
    sub_conf = os.path.join(sub, "conf.json")
    with open(sub_conf, "w") as f:
        json.dump(conf, f)
    args = build_parser().parse_args(["evaluate", "--config", sub_conf, "--split", "test"])
    card_m = evaluate(args)
    t1 = time.perf_counter()
    cpu_m = evaluate(build_parser().parse_args(["evaluate", "--config", sub_conf, "--device",
                                                "cpu"]))
    cpu_s = time.perf_counter() - t1
    config = Config.from_file(sub_conf)
    ds = EmbeddingDataset(config, "test")
    z = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        head, _ = load_head(config, 1280, None, device)
        sets, masks, _, _ = embed_split(config, ds, head, device=device)
        z[where] = sets[0][masks[0]]
    zcos = min_row_cos(torch.from_numpy(z["card"]), torch.from_numpy(z["cpu"]))
    check(all(card_m[k] == cpu_m[k] for k in keys), f"subset card {card_m} != CPU {cpu_m}")
    check(zcos >= 0.99999, f"subset z cosine card vs CPU {zcos:.7f} < 0.99999")
    say(f"[10 evaluate] {n} versions, {n // 4} cliques, turbo hs_last_seq (T 1000-2700, 1280-dim) -> "
        f"ProjectionHead(512): monolithic {mono_s:.2f} s ({n / mono_s:.1f} songs/s), streamed "
        f"chunk-sets {streamed_s:.2f} s ({n / streamed_s:.1f} songs/s); MAP {mono['MAP']:.6f} "
        f"MR1 {mono['MR1']:.4f} P@10 {mono['P@10']:.4f}, streamed equal "
        f"{all(mono[k] == streamed[k] for k in keys)}; launches {eval_counts}; 16-version "
        f"subset card {card_m['MAP']:.6f} == CPU {cpu_m['MAP']:.6f} (CPU {cpu_s:.1f} s), "
        f"{z['card'].shape[0]} chunk z cos {zcos:.7f}; set-up {setup_s:.1f} s")
    return cpath, rows, eval_counts


def ranking_phase(dev, smi: str, reset_counts, counts, n_versions: int = 10547, smax: int = 18,
                  zdim: int = 512) -> dict:
    """streaming_relevant_ranks with chunk-set bpwr at the size of
    SHS100K-TEST (10,547 versions), the resident corpus, every query; the
    first 64 queries re-ranked with the plain redux in the same blocks.
    Returns the launch counts of the ranking."""
    from wealy_tpu_torch.cli.main import _set_block_size
    from wealy_tpu_torch.ops.bpwr_redux import _reference_bpwr_block
    from wealy_tpu_torch.ops.distance import pairwise_distance_matrix
    from wealy_tpu_torch.parallel.similarity import (
        map_from_ranks,
        relevant_columns,
        streaming_relevant_ranks,
    )

    rng = np.random.default_rng(11)
    sizes = []
    while sum(sizes) < n_versions:
        sizes.append(int(rng.integers(2, 13)))
    sizes[-1] -= sum(sizes) - n_versions
    if sizes[-1] < 2:
        sizes[-2] += sizes.pop()
    labels = np.repeat(np.arange(len(sizes)), sizes)
    g = torch.Generator(device=dev).manual_seed(12)
    base = torch.randn(len(sizes), smax, zdim, device=dev, generator=g)
    sets = base[torch.from_numpy(labels).to(dev)] + 2.0 * torch.randn(
        n_versions, smax, zdim, device=dev, generator=g)
    n_chunks = torch.from_numpy(rng.integers(1, smax + 1, n_versions)).to(dev)
    mask = torch.arange(smax, device=dev)[None, :] < n_chunks[:, None]
    sets = (sets * mask[..., None]).cpu().numpy()
    mask = mask.cpu().numpy()
    ids = np.arange(n_versions) + 10**6
    blk = _set_block_size(smax)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ranks, n_rel = streaming_relevant_ranks(
        sets, sets, labels, labels, mode="cos", redux="bpwr", query_mask=mask, corpus_mask=mask,
        block_size=blk, query_block=blk, query_idx=ids, corpus_idx=ids, device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    m = map_from_ranks(ranks, n_rel, topk=(10,))

    # the first 64 queries, plain redux, the same (blk, blk) blocks and padding
    nq, N = 64, n_versions
    q = torch.zeros(blk, smax, zdim, device=dev)
    q[:blk] = torch.from_numpy(sets[:blk]).to(dev)
    qm = torch.from_numpy(mask[:blk]).to(dev)
    cols = []
    with torch.no_grad():
        for s in range(0, N, blk):
            y = torch.zeros(blk, smax, zdim, device=dev)
            ym = torch.zeros(blk, smax, dtype=torch.bool, device=dev)
            e = min(s + blk, N)
            y[: e - s] = torch.from_numpy(sets[s:e]).to(dev)
            ym[: e - s] = torch.from_numpy(mask[s:e]).to(dev)
            d = pairwise_distance_matrix(q.reshape(-1, zdim), y.reshape(-1, zdim), mode="cos")
            d = d.reshape(blk, smax, blk, smax).permute(0, 2, 1, 3)
            cols.append(_reference_bpwr_block(d, qm, ym, "bpwr", 1e-7, 1e12)[:nq, : e - s])
        dist = torch.cat(cols, dim=1)  # (64, N), plain redux
        rel = torch.from_numpy(relevant_columns(labels, labels, ids, ids)[0][:nq]).to(dev)
        ref = torch.take_along_dim(dist, rel.clamp(min=0), dim=1)[:, :, None]
        pos = torch.arange(N, device=dev)[None, None, :]
        ok = torch.from_numpy(ids[None, :] != ids[:nq, None]).to(dev)[:, None, :]
        ahead = (dist[:, None, :] < ref) | ((dist[:, None, :] == ref) & (pos < rel[:, :, None]))
        plain_ranks = torch.where(rel >= 0, (ahead & ok).sum(-1) + 1, 0).cpu().numpy()
    same = np.array_equal(plain_ranks, ranks[:nq])
    check(same, "phase 11: kernel ranks of the first 64 queries differ from the plain redux's")
    check(m["n_queries"] == n_versions and np.isfinite(m["MAP"]) and m["MAP"] > 0.1,
          f"phase 11 metrics {m}")
    pairs = float(n_versions) * n_versions
    say(f"[11 ranking] {n_versions} versions (all queried), {len(sizes)} cliques of 2-12, smax "
        f"{smax}, zdim {zdim}, cos + K4 bpwr, blocks {blk}x{blk} resident: {wall:.2f} s, "
        f"{pairs / wall:.4g} pairs/s, peak {peak:.2f} GB; MAP {m['MAP']:.6f} MR1 {m['MR1']:.3f}; "
        f"first {nq} queries plain-redux ranks identical {same}; K4 launches "
        f"{launched['bpwr_redux']} | {smi}")
    return launched


TRAIN_KERNELS = ("flash_mha", "flash_mha_bwd_dq", "flash_mha_bwd_dkv", "fused_mlp")


def grad_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two gradients as flat vectors (1.0 when both are zero)."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    if na == 0 and nb == 0:
        return 1.0
    return float((a @ b).item() / max(na * nb, 1e-300))


def mel_batch(n: int, n_mels: int, generator, device) -> dict:
    """n 30 s mel clips from a seed in cliques of 2; a per-clip, per-bin
    offset keeps the clips' embeddings apart."""
    mel = (torch.randn(n, n_mels, 3000, generator=generator, device=device) * 0.5
           + torch.randn(n, n_mels, 1, generator=generator, device=device) * 0.5)
    return {"emb": mel, "labels": torch.arange(n, device=device, dtype=torch.int32) // 2,
            "ids": torch.arange(n, device=device, dtype=torch.int32)}


def tiny_training_phase(dev, reset_counts, counts) -> dict:
    """13. whisper-tiny encoder + head, one clews step, card against CPU from
    the same seeded weights and mel batch (B=4, 30 s). Returns the launch
    counts of the step."""
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.losses import clews_loss
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_
    from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
    from wealy_tpu_torch.train.state import create_train_state, make_optimizer
    from wealy_tpu_torch.train.step import loss_and_grads, make_train_step

    states, batches = {}, {}
    cpu_batch = mel_batch(4, 80, torch.Generator().manual_seed(13), "cpu")
    for where, device in (("cpu", torch.device("cpu")), ("card", dev)):
        whisper, cfg = load_whisper_model("tiny", seed=0, device="cpu", dtype=torch.bfloat16)
        head = seeded_init_(ProjectionHead(cfg.n_audio_state, zdim=128, hidden=(256,)), seed=1)
        model = EncoderHead(whisper.encoder, head).to(device)
        states[where] = create_train_state(
            model, make_optimizer(lr=1e-4, warmup_steps=1, max_steps=100), init=False)
        batches[where] = {k: v.to(device) for k, v in cpu_batch.items()}
    t0 = time.perf_counter()
    l_cpu, _, g_cpu = loss_and_grads(states["cpu"], batches["cpu"], clews_loss, encoder_head_call)
    cpu_s = time.perf_counter() - t0
    l_card, _, g_card = loss_and_grads(states["card"], batches["card"], clews_loss,
                                       encoder_head_call)
    _, _, g_acc = loss_and_grads(states["card"], batches["card"], clews_loss, encoder_head_call,
                                 grad_accum=2)
    rel = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    cos_cpu = {n: grad_cosine(g_card[n].cpu(), g_cpu[n]) for n in g_cpu}
    cos_acc = {n: grad_cosine(g_acc[n], g_card[n]) for n in g_card}
    worst_cpu = min(cos_cpu, key=cos_cpu.get)
    worst_acc = min(cos_acc, key=cos_acc.get)
    check(rel <= 1e-2, f"phase 13 loss card {l_card.item():.6f} vs CPU {l_cpu.item():.6f}")
    check(cos_cpu[worst_cpu] >= 0.99, f"phase 13 gradient cosine card vs CPU {worst_cpu} "
          f"{cos_cpu[worst_cpu]:.6f} < 0.99")
    check(cos_acc[worst_acc] >= 0.999, f"phase 13 grad_accum=2 gradient cosine {worst_acc} "
          f"{cos_acc[worst_acc]:.6f} < 0.999")
    step = make_train_step(None, clews_loss, model_call=encoder_head_call)
    reset_counts()
    state, ld = step(states["card"], batches["card"])
    torch.cuda.synchronize()
    launched = counts()
    check(all(launched[k] > 0 for k in TRAIN_KERNELS) and np.isfinite(float(ld["loss"])),
          f"phase 13 train step launches {launched}, loss {float(ld['loss'])}")
    say(f"[13 tiny training step] whisper-tiny encoder + ProjectionHead(128), B=4 30 s, clews: "
        f"loss card {l_card.item():.6f} CPU {l_cpu.item():.6f} (rel {rel:.2e}); gradient cosine "
        f"card vs CPU min {cos_cpu[worst_cpu]:.6f} ({worst_cpu}) over {len(cos_cpu)} parameters; "
        f"grad_accum=2 vs single pass min {cos_acc[worst_acc]:.6f} ({worst_acc}); step "
        f"launches {launched}; CPU loss+grads {cpu_s:.1f} s")
    return launched


def turbo_finetune_phase(dev, reset_counts, counts, smi: str) -> dict:
    """14. large-v3-turbo encoder (32 layers, 1280 wide, 20 heads; bf16
    compute, f32 masters) + ProjectionHead(zdim=512), AdamW, B=8 30 s clips
    in 4 cliques of 2: a gradient check and a warm-up step, then 5 timed
    steps. Returns the launch counts of the timed steps."""
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.losses import clews_loss
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_
    from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
    from wealy_tpu_torch.train.state import create_train_state, make_optimizer
    from wealy_tpu_torch.train.step import loss_and_grads, make_train_step

    whisper, cfg = load_whisper_model("large-v3-turbo", seed=0, device=dev, dtype=torch.bfloat16)
    head = seeded_init_(ProjectionHead(cfg.n_audio_state, zdim=512), seed=1)
    model = EncoderHead(whisper.encoder, head.to(dev))
    del whisper
    state = create_train_state(model, make_optimizer(lr=1e-5, warmup_steps=1, max_steps=1000),
                               init=False)
    n_params = sum(t.numel() for t in state.params.values())
    B = 8
    batch = mel_batch(B, cfg.n_mels, torch.Generator(device=dev).manual_seed(14), dev)
    step = make_train_step(None, clews_loss, model_call=encoder_head_call)
    # gradient check (also the warm-up of cuBLAS/cuDNN plans)
    loss0, _, grads = loss_and_grads(state, batch, clews_loss, encoder_head_call)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    nonzero = sum(bool(g.abs().max() > 0) for g in grads.values())
    g_norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
    del grads
    check(finite and np.isfinite(loss0.item()), f"phase 14 gradients finite {finite}, loss "
          f"{loss0.item()}")
    # warm-up step: step 0 runs at lr 0, the parameters stay
    name = f"encoder.blocks.{cfg.n_audio_layer // 2}.attn.query.weight"
    before = state.params[name].clone()
    state, ld = step(state, batch)
    check(torch.equal(state.params[name], before) and np.isfinite(float(ld["loss"])),
          "phase 14 warm-up step (lr 0) moved the parameters or lost the loss")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(5):
        state, ld = step(state, batch)
        losses.append(ld["loss"])
        if i == 0:
            after1 = state.params[name].clone()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    masters_finite = all(bool(torch.isfinite(t).all()) for t in state.params.values())
    check(np.isfinite(losses).all() and masters_finite,
          f"phase 14 losses {losses}, parameters finite {masters_finite}")
    check(not torch.equal(after1, before), "phase 14 parameters did not change after step 1")
    check(all(launched[k] > 0 for k in TRAIN_KERNELS), f"phase 14 launches {launched}")
    say(f"[14 turbo fine-tune] large-v3-turbo encoder ({cfg.n_audio_layer} x {cfg.n_audio_state}, "
        f"{cfg.n_audio_head} heads, bf16 compute, f32 masters, {n_params / 1e6:.1f} M parameters) + ProjectionHead(512), AdamW, clews, B={B} "
        f"30 s clips: gradients finite {finite} ({nonzero}/{len(state.params)} nonzero, global "
        f"norm {g_norm:.4g}); 5 steps {wall:.2f} s = {5 / wall:.3f} steps/s, {5 * B / wall:.2f} "
        f"clips/s; peak {peak:.2f} GB; losses {[round(x, 6) for x in losses]}; launches "
        f"{launched} | {smi}")
    del state, model, batch
    torch.cuda.empty_cache()
    return launched


def train_cli_phase(tmp: str, dev, reset_counts, counts, smi: str, max_steps: int = 20) -> dict:
    """15. ``train --max-steps 20`` on the synthetic turbo-width project (a
    train split of 16 cliques of 4, val 4 cliques, test 32 cliques), then
    ``evaluate --checkpoint`` on the head it saved. Returns the launch
    counts of both commands."""
    t0 = time.perf_counter()
    cpath, rows = write_project(tmp, dev, train_cliques=16, val_cliques=4)
    setup_s = time.perf_counter() - t0
    conf = json.load(open(cpath))
    ckdir = os.path.join(tmp, "ckpt")
    metrics = os.path.join(tmp, "metrics.jsonl")
    conf["path"]["checkpoints"] = ckdir
    conf["train"] = {"loss": "clews", "batch_size": 16, "lr": 1e-3, "warmup_steps": 2,
                     "max_steps": max_steps, "log_every": 0, "eval_every": max_steps,
                     "checkpoint_every": 1000, "metrics_jsonl": metrics}
    with open(cpath, "w") as f:
        json.dump(conf, f)
    import wealy_tpu_torch.train.step as tstep

    make_step, n_calls = tstep.make_train_step, 0

    def make_synced_step(*args, **kwargs):
        """The CLI's step, synchronised after steps 2 and ``max_steps``: the
        records' host stamps are taken when a step is enqueued, so the
        rate's window ends only once the device has finished its steps."""
        step = make_step(*args, **kwargs)

        def synced(state, batch):
            nonlocal n_calls
            out = step(state, batch)
            n_calls += 1
            if n_calls in (2, max_steps):
                torch.cuda.synchronize()
            return out

        return synced

    reset_counts()
    with mock.patch.object(tstep, "make_train_step", make_synced_step):
        out, train_s = run_cli(["train", "--config", cpath, "--max-steps", str(max_steps)])
    recs = [json.loads(line) for line in open(metrics)]
    steps = [r for r in recs if "loss" in r]
    val = [r for r in recs if "val_MAP" in r]
    # steady rate from step 2 to the last, both ends synchronised
    rate = (len(steps) - 2) / (steps[-1]["t"] - steps[1]["t"])
    check(out["final_step"] == max_steps and np.isfinite(out["final_loss"]) and len(val) == 1,
          f"phase 15 train {out}, {len(val)} val records")
    ev, ev_s = run_cli(["evaluate", "--config", cpath, "--split", "test", "--checkpoint", ckdir])
    launched = counts()
    check(ev["n_queries"] == len(rows) and np.isfinite(ev["MAP"]),
          f"phase 15 evaluate --checkpoint {ev}")
    say(f"[15 train CLI] train --max-steps {max_steps} on 64 turbo-width versions (batch 16 x 2, "
        f"chunk 1000 x 1280 fp16): {train_s:.2f} s, {rate:.2f} head-training steps/s (steps "
        f"2-{max_steps}), "
        f"final loss {out['final_loss']:.6f}, val MAP {val[0]['val_MAP']:.6f}; evaluate "
        f"--checkpoint: MAP {ev['MAP']:.6f} MR1 {ev['MR1']:.4f} over {ev['n_queries']} versions "
        f"({ev_s:.2f} s); launches {launched}; set-up {setup_s:.1f} s | {smi}")
    return launched


def layer_norm_module_phase(dev, gen, reset_counts, counts) -> dict:
    """16 (main path). LayerNormFused(1280) forward and backward on an f32
    (8, 1500, 1280) input and forward on its bf16 cast, the gradients
    against autograd of the plain version. Returns the launch counts."""
    from wealy_tpu_torch.models.layers import LayerNormFused
    from wealy_tpu_torch.ops.layer_norm import _reference_ln

    mod = LayerNormFused(1280).to(dev)
    with torch.no_grad():
        mod.scale.copy_(torch.randn(1280, device=dev, generator=gen) + 1)
        mod.bias.copy_(torch.randn(1280, device=dev, generator=gen))
    x = torch.randn(8, 1500, 1280, device=dev, generator=gen).requires_grad_()
    r = torch.randn(8, 1500, 1280, device=dev, generator=gen)
    reset_counts()
    (mod(x) * r).sum().backward()
    with torch.no_grad():
        y16 = mod(x.detach().bfloat16())
    torch.cuda.synchronize()
    launched = counts()
    leaves = [t.detach().requires_grad_() for t in (x, mod.scale, mod.bias)]
    (_reference_ln(*leaves, 1e-5) * r).sum().backward()
    errs = [(got - want.grad).abs().max().item()
            for got, want in zip((x.grad, mod.scale.grad, mod.bias.grad), leaves)]
    ok = check(all(torch.allclose(got, want.grad, rtol=1e-5, atol=1e-6)
                   for got, want in zip((x.grad, mod.scale.grad, mod.bias.grad), leaves))
               and y16.dtype == torch.bfloat16 and launched["layer_norm"] == 2,
               f"phase 16 LayerNormFused gradients max abs {errs}, launches {launched}")
    say(f"[16 LayerNormFused] (8, 1500, 1280) f32 forward + backward and bf16 forward on the "
        f"card: gradient max abs x/scale/bias {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} against "
        f"autograd of the plain version {'ok' if ok else 'FAIL'}; K6 launches "
        f"{launched['layer_norm']}")
    return launched


def same_rankings(got, want, atol: float, k: int = None) -> tuple[bool, float]:
    """Payload lists with the same version keys in the same order (the
    first ``k`` of each) and scores within ``atol``: (agree, max score
    difference)."""
    worst, agree = 0.0, len(got) == len(want)
    for g, w in zip(got, want):
        gk = [r["version_key"] for r in g["results"]][:k]
        wk = [r["version_key"] for r in w["results"]][:k]
        agree = agree and gk == wk
        diff = np.abs(np.subtract([r["score"] for r in g["results"]][:k],
                                  [r["score"] for r in w["results"]][:k])).max(initial=0.0)
        worst = max(worst, float(diff))
    return agree and worst <= atol, worst


def serving_cli_phase(tmp: str, cpath: str, rows, reset_counts, counts) -> dict:
    """17. ``index`` of the phase-10 project, then ``query
    --query-embeddings`` of 16 versions' stored sequences: card against CPU,
    resident against ``--no-resident``, ``--rerank 3``, ``--pooled``,
    ``--quantize int8``. Returns the launch counts of ``index`` and the
    resident card ``query``."""
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore

    idx = os.path.join(tmp, "serve", "test.npz")
    reset_counts()
    out, index_s = run_cli(["index", "--config", cpath, "--split", "test", "--out", idx])
    check(out["indexed"] == len(rows) and out["sets"], f"phase 17 index {out}")
    store = EmbeddingStore(os.path.join(tmp, "hs"), "lyric-covers")
    vids = [str(v) for v, _ in rows[:16]]
    files = [str(store.path(v, "hs_last_seq.npz")) for v in vids]

    def query(*flags, k=10):
        return run_cli_lines(["query", "--config", cpath, "--index", idx, "--k", str(k), *flags,
                              "--query-embeddings", *files])

    card, card_s = query()
    launched = counts()
    cpu, cpu_s = query("--device", "cpu")
    host, host_s = query("--no-resident")
    rerank, _ = query("--rerank", "3")
    pooled, _ = query("--pooled")
    f16_4, _ = query(k=4)
    int8_4, _ = query("--quantize", "int8", k=4)
    ok_cpu, d_cpu = same_rankings(card, cpu, 1e-4)
    ok_host, d_host = same_rankings(card, host, 1e-4)
    check(ok_cpu, f"phase 17 card vs CPU rankings differ (max score difference {d_cpu:.3g})")
    check(ok_host, f"phase 17 resident vs --no-resident differ ({d_host:.3g})")
    self_top = all(o["results"][0]["version_key"] == v for o, v in zip(card, vids))
    pooled_top = all(o["results"][0]["version_key"] == v and o["scoring"] == "pooled_cosine"
                     for o, v in zip(pooled, vids))
    exact = [{r["version_key"]: r["score"] for r in o["results"]} for o in card]
    rr_ok = all(o.get("rerank") == 3 and len(o["results"]) == 3
                and o["results"][0]["version_key"] == v
                and all(abs(r["score"] - e[r["version_key"]]) <= 1e-4
                        for r in o["results"] if r["version_key"] in e)
                for o, v, e in zip(rerank, vids, exact))
    d_int8, int8_ok = 0.0, True
    for a, b in zip(f16_4, int8_4):
        sa = {r["version_key"]: r["score"] for r in a["results"]}
        sb = {r["version_key"]: r["score"] for r in b["results"]}
        int8_ok = int8_ok and set(sa) == set(sb) and (
            [r["version_key"] for r in a["results"]][:2] == [r["version_key"] for r in b["results"]][:2])
        d_int8 = max([d_int8] + [abs(sa[v] - sb[v]) for v in sa if v in sb])
    check(self_top and pooled_top and rr_ok and launched["bpwr_redux"] > 0,
          f"phase 17 self-retrieval exact {self_top} pooled {pooled_top}, rerank {rr_ok}, K4 "
          f"launches {launched}")
    check(int8_ok and d_int8 < 1.5e-2, f"phase 17 int8: top 2 / top-4 set agree {int8_ok}, max "
          f"score difference {d_int8:.3g}")
    say(f"[17 serving CLI] index of {out['indexed']} turbo-width versions -> ProjectionHead(512) "
        f"{index_s:.2f} s; query of 16 versions: card {card_s:.2f} s (K4 launches "
        f"{launched['bpwr_redux']}), "
        f"CPU {cpu_s:.2f} s, --no-resident {host_s:.2f} s; card == CPU rankings {ok_cpu} (max "
        f"score difference {d_cpu:.3g}), resident == host {ok_host} ({d_host:.3g}); self at rank 1 "
        f"exact {self_top} pooled {pooled_top}; --rerank 3 {rr_ok}; int8 top 2 and top-4 set "
        f"{int8_ok}, max score difference {d_int8:.3g}")
    return launched


def write_index(path: str, sets: np.ndarray, mask: np.ndarray, labels: np.ndarray,
                emb_dim: int, chunk_size: int, overlap: float) -> None:
    """A serving index in ``cli/serve.py``'s format, written straight from
    (n, smax, zdim) f16 chunk sets: pooled vectors, keys, cliques, ids."""
    from wealy_tpu_torch.cli.serve import INDEX_VERSION

    w = mask[..., None].astype(np.float32)
    vecs = (sets.astype(np.float32) * w).sum(1) / np.maximum(w.sum(1), 1e-9)
    n = len(sets)
    np.savez(path, version_keys=np.asarray([f"v{i}" for i in range(n)]),
             cliques=np.asarray([f"c{c}" for c in labels]), labels=labels.astype(np.int32),
             ids=np.arange(n, dtype=np.int64) + 10**6, vecs=vecs, sets=sets, set_mask=mask,
             meta=np.asarray(json.dumps({
                 "index_version": INDEX_VERSION, "model": "whisper", "zdim": int(sets.shape[-1]),
                 "split": "test", "checkpoint_step": None, "embedding_file": "hs_last_seq.npz",
                 "emb_dim": emb_dim, "chunk_size": chunk_size, "overlap": overlap,
                 "has_sets": True})))


def serving_config(root: str, kind=("last_hidden_states", "concat"), chunk_size: int = 1000,
                   zdim: int = 512, whisper_size: str = "large-v3-turbo") -> str:
    conf = {"path": {"lyric_covers_data": os.path.join(root, "lc"),
                     "hidden_states": os.path.join(root, "hs"),
                     "cache": os.path.join(root, "cache")},
            "data": {"dataset_name": "lyric-covers", "embedding_type": kind[0],
                     "embedding_format": kind[1], "chunk_size": chunk_size,
                     "overlap_percentage": 0.9},
            "model": {"name": "whisper", "zdim": zdim, "whisper_size": whisper_size}}
    path = os.path.join(root, f"serve_{kind[0]}_{whisper_size}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def serving_scale_phase(tmp: str, dev, reset_counts, counts, smi: str, n: int = 10547,
                        smax: int = 18, zdim: int = 512) -> dict:
    """18. The exact-scan engine over a 10,547-version index (SHS100K-TEST's
    size; f16 sets, smax 18, zdim 512, turbo-width 1280 queries through the
    512-wide head), written straight in the index format: Q=1 latency over
    40 queries, the Q=16 batched rate, ``rerank=100``, int8, K4 launches per
    query, peak memory; and the ranks of 16 queries against the plain redux
    on the card in the same blocks. Returns the launch counts of the Q=1
    exact scans."""
    from wealy_tpu_torch.cli.serve import QueryEngine
    from wealy_tpu_torch.ops.bpwr_redux import _reference_bpwr_block
    from wealy_tpu_torch.ops.distance import pairwise_distance_matrix
    from wealy_tpu_torch.train.config import Config

    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    labels = np.repeat(np.arange(n // 2 + 1), 2)[:n]
    g = torch.Generator(device=dev).manual_seed(18)
    base = torch.randn(int(labels.max()) + 1, smax, zdim, device=dev, generator=g)
    sets = base[torch.from_numpy(labels).to(dev)] + torch.randn(n, smax, zdim, device=dev,
                                                                generator=g)
    n_chunks = torch.from_numpy(rng.integers(1, smax + 1, n)).to(dev)
    mask = torch.arange(smax, device=dev)[None, :] < n_chunks[:, None]
    sets = (sets * mask[..., None]).half().cpu().numpy()
    idx = os.path.join(tmp, "shs.npz")
    write_index(idx, sets, mask.cpu().numpy(), labels, 1280, 1000, 0.9)
    del sets, base
    cpath = serving_config(tmp)
    config = Config.from_file(cpath)
    seqs = [(rng.normal(size=(int(T), 1280)) * 0.5).astype(np.float32)
            for T in rng.integers(1000, 2701, 40)]
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = QueryEngine(config, idx, None, device=dev)
    eng.search_many(seqs[:16], k=10)  # warm-up: cuBLAS/cuDNN plans, the allocator

    def latencies(engine, **kw):
        out = []
        for seq in seqs:
            t = time.perf_counter()
            engine.search(seq, k=10, **kw)
            out.append((time.perf_counter() - t) * 1e3)
        return np.percentile(out, [50, 95])

    reset_counts()
    exact = latencies(eng)
    launched = counts()
    per_query = launched["bpwr_redux"] / len(seqs)
    head_ms, score_ms = [], []
    for seq in seqs[:10]:
        t = time.perf_counter()
        q, qm = eng.query_sets([seq])
        t1 = time.perf_counter()
        eng._score_resident(torch.from_numpy(q).to(dev), torch.from_numpy(qm).to(dev)).cpu()
        t2 = time.perf_counter()
        head_ms.append((t1 - t) * 1e3)
        score_ms.append((t2 - t1) * 1e3)
    t = time.perf_counter()
    for _ in range(4):
        eng.search_many(seqs[:16], k=10)
    qps = 64 / (time.perf_counter() - t)
    rerank = latencies(eng, rerank=100)

    # the ranks of 16 queries: K4 against the plain redux, the same blocks
    q, qm = eng.query_sets(seqs[:16])
    q, qm = torch.from_numpy(q).to(dev), torch.from_numpy(qm).to(dev)
    cols = []
    with torch.no_grad():
        for b in range(0, n, eng.block_size):
            s, m = eng._corpus_block(slice(b, b + eng.block_size))
            d = pairwise_distance_matrix(q.reshape(-1, zdim), s.reshape(-1, zdim), mode="cos")
            d = d.reshape(q.shape[0], q.shape[1], s.shape[0], smax).permute(0, 2, 1, 3)
            cols.append(_reference_bpwr_block(d, qm, m, "bpwr", 1e-7, 1e12))
        plain = torch.cat(cols, dim=1).cpu().numpy()
    payloads = eng.search_many(seqs[:16], k=n)
    ranks_same = all([r["version_key"] for r in o["results"]]
                     == [eng.keys[j] for j in np.argsort(plain[i])]
                     for i, o in enumerate(payloads))
    scores_same = all(np.allclose([r["score"] for r in o["results"]], -np.sort(plain[i]),
                                  atol=1e-6) for i, o in enumerate(payloads))
    f16_bytes = eng.resident_bytes()
    eng.release()
    del eng, payloads, plain, cols
    int8 = QueryEngine(config, idx, None, device=dev, quantize="int8")
    int8.search_many(seqs[:16], k=10)
    int8_lat = latencies(int8)
    int8_bytes = int8.resident_bytes()
    scale_bytes = int8._scale_dev.numel() * 4
    int8.release()
    del int8
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(ranks_same and scores_same,
          f"phase 18 ranks of 16 queries against the plain redux: order {ranks_same}, "
          f"scores {scores_same}")
    check(per_query > 0, f"phase 18 K4 launches per query {per_query}")
    say(f"[18 serving at SHS scale] {n} versions, smax {smax}, zdim {zdim}, f16 resident "
        f"{f16_bytes / 1e6:.1f} MB; exact scan Q=1 p50 {exact[0]:.2f} ms p95 {exact[1]:.2f} ms "
        f"over {len(seqs)} queries (head {np.median(head_ms):.2f} ms, cosine+K4 scan "
        f"{np.median(score_ms):.2f} ms, medians of 10), {per_query:.1f} K4 launches per query; "
        f"Q=16 batched {qps:.1f} queries/s; rerank 100 p50 {rerank[0]:.2f} ms p95 "
        f"{rerank[1]:.2f} ms; int8 p50 {int8_lat[0]:.2f} ms p95 {int8_lat[1]:.2f} ms, resident "
        f"{int8_bytes / 1e6:.1f} MB ({scale_bytes / 1e6:.2f} MB scales); peak "
        f"{peak:.2f} GB; 16 queries' ranks identical to the plain redux {ranks_same}, scores "
        f"{scores_same}; set-up {setup_s:.1f} s | {smi}")
    return launched


def daemon_phase(tmp: str, reset_counts, counts, smi: str, clients: int = 8,
                 rounds: int = 2) -> dict:
    """19. ``serve`` on 127.0.0.1, port 0, over the phase-18 index: 8
    concurrent clients, 2 queries each (T=1000 sequences as JSON), the
    answers against ``search_many``, then one ``/reload``. Returns the
    launch counts of the clients' burst."""
    import threading
    import urllib.request

    from wealy_tpu_torch.cli.main import build_parser
    from wealy_tpu_torch.cli.serve import serving

    rng = np.random.default_rng(19)
    seqs = [(rng.normal(size=(1000, 1280)) * 0.5).astype(np.float32)
            for _ in range(clients * rounds)]
    bodies = [json.dumps({"embeddings": s.tolist(), "k": 10}).encode() for s in seqs]

    def post(url, body):
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=300).read())

    args = build_parser().parse_args(["serve", "--config", serving_config(tmp), "--index",
                                      os.path.join(tmp, "shs.npz"), "--port", "0"])
    answers = [None] * len(seqs)
    with serving(args) as daemon:
        post(f"{daemon.url}/query", bodies[0])  # warm-up

        def client(c):
            for r in range(rounds):
                i = c * rounds + r
                answers[i] = post(f"{daemon.url}/query", bodies[i])

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        reset_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launched = counts()
        stats = json.loads(urllib.request.urlopen(f"{daemon.url}/healthz", timeout=60).read())
        want = daemon.engine.search_many(seqs, k=10)
        same, diff = same_rankings([a or {"results": []} for a in answers], want, 1e-4)
        reload = post(f"{daemon.url}/reload", b"")
        again = post(f"{daemon.url}/query", bodies[0])
        after, _ = same_rankings([again], want[:1], 1e-4)
    stats = stats["batch_stats"]
    batch = (stats["queries"] - 1) / max(stats["dispatches"] - 1, 1)  # the burst's, not the warm-up's
    check(same and after and reload.get("indexed") == reload.get("was")
          and launched["bpwr_redux"] > 0,
          f"phase 19 daemon answers equal search_many {same} ({diff:.3g}), after /reload {after}, "
          f"reload {reload}, K4 launches {launched['bpwr_redux']}")
    say(f"[19 serve daemon] {clients} concurrent clients x {rounds} queries (T=1000, 1280-dim "
        f"JSON) over {stats['queries'] - 1} queries: {(stats['queries'] - 1) / wall:.2f} "
        f"queries/s, mean batch {batch:.2f} ({stats['dispatches'] - 1} dispatches); answers == "
        f"search_many {same} (max score difference {diff:.3g}); /reload {reload}; K4 launches "
        f"{launched['bpwr_redux']} | {smi}")
    return launched


def write_wav(path: str, seconds: float, sr: int = 44100, seed: int = 0) -> None:
    """16-bit mono: two tones and noise from a seed."""
    import wave

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * (220 + 40 * seed) * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
    x = x + 0.05 * rng.normal(size=t.shape)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def audio_query_phase(tmp: str, dev, reset_counts, counts, smi: str,
                      whisper_size: str = "large-v3-turbo") -> dict:
    """20. ``query --audio`` with a 30 s and a 180 s WAV (16-bit, 44.1 kHz,
    so the resampler runs) at large-v3-turbo, ``x_concat`` kind, against a
    256-version index of random turbo-width sets, and the latency of each
    after a warm-up; then a whisper-tiny ``hs_last_seq`` audio query on the
    card against the CPU, against an index of its own noisy copies. Returns
    the K1-K3 launches of the turbo ``query`` run."""
    from wealy_tpu_torch.cli.serve import QueryEngine, make_query_embed_fn
    from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wealy_tpu_torch.train.config import Config

    width = WHISPER_CONFIGS[whisper_size].n_audio_state
    wavs = [os.path.join(tmp, f"q{s}.wav") for s in (30, 180)]
    for seed, (path, seconds) in enumerate(zip(wavs, (30, 180))):
        write_wav(path, seconds, seed=seed)
    rng = np.random.default_rng(20)
    n, smax = 256, 6
    mask = np.arange(smax)[None, :] < rng.integers(1, smax + 1, n)[:, None]
    sets = (rng.normal(size=(n, smax, 512)) * mask[..., None]).astype(np.float16)
    idx = os.path.join(tmp, "turbo_x_concat.npz")
    write_index(idx, sets, mask, np.arange(n) // 2, width, 2, 0.9)
    cpath = serving_config(tmp, kind=("encoder", "concat"), chunk_size=2,
                           whisper_size=whisper_size)
    # one call per file: a 30 s clip is one x_concat row, which the
    # overlapping collate (in both packages) cannot batch with longer songs
    reset_counts()
    outs, cli_s = [], 0.0
    for path in wavs:
        lines, wall = run_cli_lines(["query", "--config", cpath, "--index", idx, "--k", "5",
                                     "--audio", path])
        outs += lines
        cli_s += wall
    launched = counts()
    check(len(outs) == 2 and all(len(o["results"]) == 5 and o["query"] == w
                                 for o, w in zip(outs, wavs)), f"phase 20 query --audio {outs}")
    eng = QueryEngine(Config.from_file(cpath), idx, None, device=dev)
    lat = {}
    for path in wavs:
        eng.search(eng.embed_audio(path), k=5)  # warm-up at this length
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            eng.search(eng.embed_audio(path), k=5)
            runs.append(time.perf_counter() - t)
        lat[path] = np.median(runs) * 1e3
    seq180 = eng.embed_audio(wavs[1])
    finite = bool(np.isfinite(seq180).all()) and seq180.shape == (6, width)
    del eng
    torch.cuda.empty_cache()

    # whisper-tiny hs_last_seq: card against CPU, the same seeded weights
    tiny = Config.from_file(serving_config(tmp, chunk_size=64, zdim=64, whisper_size="tiny"))
    t = time.perf_counter()
    q_cpu = make_query_embed_fn(tiny, device="cpu")(wavs[0])
    cpu_s = time.perf_counter() - t
    # the index: the CPU query's own sequence under growing noise, so its
    # true order is known (windows of 64 decoder positions)
    ladder = [q_cpu + s * rng.normal(size=q_cpu.shape).astype(np.float32)
              for s in (0.0, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2)]
    tiny_idx = os.path.join(tmp, "tiny.npz")
    write_index(tiny_idx, np.zeros((1, 1, 64), np.float16), np.ones((1, 1), bool),
                np.zeros(1, int), 384, 64, 0.9)
    probe = QueryEngine(tiny, tiny_idx, None, device=dev)
    qs, qm = probe.query_sets(ladder)
    write_index(tiny_idx, qs.astype(np.float16), qm, np.arange(len(ladder)) // 2, 384, 64, 0.9)
    del probe
    results = {}
    for where in ("cuda", "cpu"):
        engine = QueryEngine(tiny, tiny_idx, None, device=where)
        t = time.perf_counter()
        results[where] = engine.search(engine.embed_audio(wavs[0]), k=5)
        results[where + "_s"] = time.perf_counter() - t
    keys = {w: [r["version_key"] for r in results[w]["results"]] for w in ("cuda", "cpu")}
    check(keys["cuda"] == keys["cpu"], f"phase 20 tiny hs_last_seq top-5 card {keys['cuda']} "
          f"vs CPU {keys['cpu']}")
    check(finite and all(launched[k] > 0 for k in EXTRACT_KERNELS),
          f"phase 20 turbo embedding finite {finite}, launches {launched}")
    say(f"[20 audio queries] large-v3-turbo x_concat: query --audio 30 s + 180 s WAVs (44.1 kHz "
        f"16-bit) {cli_s:.2f} s in two cold calls (model builds included); after warm-up 30 s "
        f"{lat[wavs[0]]:.1f} ms, 180 s {lat[wavs[1]]:.1f} ms (decode, resample, mel, encoder, "
        f"head, scan of {n} versions); launches {launched}; whisper-tiny hs_last_seq card "
        f"top-5 {keys['cuda']} == CPU {keys['cpu']} {keys['cuda'] == keys['cpu']} (card "
        f"{results['cuda_s']:.2f} s, CPU {results['cpu_s']:.2f} s, CPU embed first {cpu_s:.2f} "
        f"s) | {smi}")
    return launched


def write_audio(path: str, x: np.ndarray, sr: int, kind: str) -> None:
    """``x`` (n, channels) in [-1, 1] as a WAV: ``pcm16``, ``pcm24`` or
    ``float32`` (IEEE float, format 3, which the stdlib module cannot
    write)."""
    import struct

    channels = x.shape[1]
    x = np.clip(x, -1, 1).reshape(-1)
    if kind == "float32":
        tag, bits, payload = 3, 32, x.astype("<f4").tobytes()
    else:
        bits = int(kind[3:])
        ints = np.round(x * (2.0 ** (bits - 1) - 1)).astype(np.int64)
        if bits == 24:
            payload = ints.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        else:
            payload = ints.astype("<i2").tobytes()
        tag = 1
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)) + b"WAVE"
                + b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(payload)) + payload)


def encode_mp3(x: np.ndarray, sr: int):
    """Mono float PCM -> mp3 bytes (192 kbps) through the system
    libmp3lame, or None where that library is absent."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("mp3lame")
    if name is None:
        return None
    lame = ctypes.CDLL(name)
    lame.lame_init.restype = ctypes.c_void_p
    gfp = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(gfp, ctypes.c_int(sr))
    lame.lame_set_num_channels(gfp, ctypes.c_int(1))
    lame.lame_set_brate(gfp, ctypes.c_int(192))
    if lame.lame_init_params(gfp) < 0:
        return None
    x = np.ascontiguousarray(x, np.float32)
    buf = ctypes.create_string_buffer(int(1.25 * len(x)) + 7200)
    f32p = ctypes.POINTER(ctypes.c_float)
    m = lame.lame_encode_buffer_ieee_float(gfp, x.ctypes.data_as(f32p), x.ctypes.data_as(f32p),
                                           ctypes.c_int(len(x)), buf, ctypes.c_int(len(buf)))
    tail = ctypes.create_string_buffer(7200)
    t = lame.lame_encode_flush(gfp, tail, ctypes.c_int(len(tail)))
    lame.lame_close(gfp)
    return buf.raw[:m] + tail.raw[:t] if m >= 0 and t >= 0 else None


# phase 21's split: (seconds, rate, channels, format) per version, three a clique.
# The pattern (27 chunks of 30 s) is followed by three repeats, each with a 30 s
# 16-bit file in place of the empty one: 48 versions in 16 cliques, 108 chunks (110
# with an mp3), so that x_concat at B=32 runs three full batches and hs_last_seq at
# B=16 six, and each command's meter reads a steady rate.
_SPLIT_PATTERN = [
    (20, 16000, 1, "pcm16"), (35, 44100, 2, "pcm24"), (50, 48000, 1, "float32"),
    (65, 16000, 1, "pcm16"), (80, 44100, 2, "pcm24"), (95, 48000, 1, "float32"),
    (25, 44100, 2, "pcm24"), (45, 48000, 1, "float32"), (70, 16000, 1, "pcm16"),
    (90, 48000, 1, "float32"), (30, 16000, 1, "empty"), (60, 44100, 2, "pcm24"),
]
SPLIT_AUDIO = _SPLIT_PATTERN + 3 * [(s, sr, ch, "pcm16" if kind == "empty" else kind)
                                    for s, sr, ch, kind in _SPLIT_PATTERN]


def write_audio_project(root: str, seed: int = 21) -> tuple[str, list, str]:
    """A lyric-covers project with audio, in the layout of
    tests/test_cli.py::project: ``<root>/data/LyricCovers/audio/<vid>/
    <vid>_audio.mp3`` holding WAV bytes (the layout's name), one version an
    empty file (it must degrade to 1 s of silence), and one real mp3 where
    libmpg123 and libmp3lame are both present. Clique members share a tone
    pair under their own noise. Returns (lyric-covers CSV dir, [(version
    id, clique)], what was done about mp3)."""
    from wealy_tpu_torch import native

    rng = np.random.default_rng(seed)
    lc, audio = os.path.join(root, "lc"), os.path.join(root, "data", "LyricCovers", "audio")
    os.makedirs(lc)
    rows = []
    for i, (seconds, sr, channels, kind) in enumerate(SPLIT_AUDIO):
        vid, clique = 2100 + i, f"song{i // 3}"
        path = os.path.join(audio, str(vid), f"{vid}_audio.mp3")
        os.makedirs(os.path.dirname(path))
        rows.append((vid, clique))
        if kind == "empty":
            open(path, "wb").close()
            continue
        t = np.arange(sr) / sr  # one second: each tone has a whole number of cycles in it
        tone = np.tile(0.3 * np.sin(2 * np.pi * (220 + 55 * (i // 3)) * t) + 0.1 * np.sin(
            2 * np.pi * 660 * t), seconds).astype(np.float32)
        x = tone[:, None] + 0.05 * rng.standard_normal((len(tone), channels), np.float32)
        write_audio(path, x, sr, kind)
    import ctypes.util

    has_mpg123 = native.mp3_available()
    has_lame = ctypes.util.find_library("mp3lame") is not None
    t = np.arange(40 * 22050) / 22050
    data = encode_mp3(0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.normal(size=len(t)),
                      22050) if has_mpg123 and has_lame else None
    mp3 = f"no mp3 version (libmpg123 {has_mpg123}, libmp3lame {has_lame})"
    if data:
        vid = 2100 + len(SPLIT_AUDIO)
        path = os.path.join(audio, str(vid), f"{vid}_audio.mp3")
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as f:
            f.write(data)
        rows.append((vid, "song0"))
        mp3 = f"version {vid}: a real 40 s mp3 at 22.05 kHz ({len(data)} bytes)"
    write_split_csvs(lc, {"test": rows, "train": [], "val": []})
    return lc, rows, mp3


def token_prefix_rows(card_tokens, cpu_tokens, card_seq, cpu_seq, n_chunks, prompt: int,
                      max_len: int, eot: int):
    """Per version, the stored ``hs_last_seq`` rows of card and CPU split by
    chunk (lengths from each side's tokens), and the rows written before the
    first token where the two decodes part: (card lengths, CPU lengths,
    [(card rows, CPU rows)])."""
    def lengths(tokens):
        ends = tokens == eot
        ends[:, :prompt] = False
        return np.where(ends.any(1), ends.argmax(1), max_len)

    lc, lp = lengths(card_tokens), lengths(cpu_tokens)
    pairs, row = [], 0
    for v, n in n_chunks:
        a, b, oa, ob = card_seq[v], cpu_seq[v], 0, 0
        for c in range(row, row + n):
            diff = np.nonzero(card_tokens[c] != cpu_tokens[c])[0]
            same = min(int(diff[0]) if len(diff) else max_len, int(lc[c]), int(lp[c]),
                       max_len - 1)  # the last position is never written
            pairs.append((a[oa:oa + same], b[ob:ob + same]))
            oa, ob = oa + int(lc[c]), ob + int(lp[c])
        row += n
    return lc, lp, pairs



# phase 21's card-vs-CPU check at whisper-tiny: the split's first 4 versions, 8
# chunks, at B=6, so that the second batch is partial (2 chunks, 4 zero rows)
TINY_VERSIONS, TINY_BATCH = 4, 6


def extract_split_phase(tmp: str, dev, reset_counts, counts, smi: str,
                        per_song_rate: float) -> dict:
    """21. Extraction over a split through the CLI at large-v3-turbo: the
    audio project of :func:`write_audio_project` (test split), then a.
    ``extract --batched --kinds x_concat --pack-direct --batch-size 32``,
    b. ``extract --batched --kinds hs_last_seq --batch-size 16`` and
    ``pack``, c. the same extract again (every version skipped), d.
    ``evaluate --split test`` on the hs_last_seq pack. Checks: the native
    library built and loaded, every version done, the pack equal to the
    store, the batched x_concat rows of two songs against ``extract_song``
    on the card, and the split's first versions (every WAV format) at
    whisper-tiny, card against CPU. Returns the launches of a-d."""
    from wealy_tpu_torch import native
    from wealy_tpu_torch.audio.decode import load_audio
    from wealy_tpu_torch.cli import extract_batched
    from wealy_tpu_torch.data.audio_dataset import AudioDataset
    from wealy_tpu_torch.data.dataset import build_clean_dataset
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.data.packed_store import PackedStore
    from wealy_tpu_torch.models.whisper import extract as wextract
    from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wealy_tpu_torch.models.whisper.generate import default_prompt
    from wealy_tpu_torch.train.config import Config

    t0 = time.perf_counter()
    built = native.available()
    lib = native.library_path()
    check(built and str(lib).startswith(os.path.join(REPO, "wealy_tpu_torch", "native", "_build")),
          f"phase 21 native library: {native.build_error()} at {lib}")
    native_s = native.build_seconds
    lc, rows, mp3 = write_audio_project(tmp)
    setup_s = time.perf_counter() - t0
    n = len(rows)
    hs, data = os.path.join(tmp, "hs"), os.path.join(tmp, "data")
    cpath = write_config(os.path.join(tmp, "turbo.json"), lc, hs, os.path.join(tmp, "cache"),
                         chunk_size=224, overlap=0.5, whisper_size="large-v3-turbo",
                         data_root=data)
    base = ["extract", "--config", cpath, "--split", "test", "--batched"]

    # each command's model build from the seed, timed where the split job makes
    # it, so that the extraction's own rate is read without it; the x_concat
    # command's model is kept for the extract_song check below
    builds, kept = [], []
    real_load = extract_batched.load_whisper_model

    def timed_load(*args, **kw):
        t = time.perf_counter()
        out = real_load(*args, **kw)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t)
        if not kept:
            kept.append(out)
        return out

    reset_counts()
    with mock.patch.object(extract_batched, "load_whisper_model", timed_load):
        xc, xc_s = run_cli(base + ["--kinds", "x_concat", "--pack-direct", "--batch-size", "32"])
        hl, hl_s = run_cli(base + ["--kinds", "hs_last_seq", "--batch-size", "16"])
    check(len(builds) == 2, f"phase 21 model builds {builds} (one a command)")
    xc_build, hl_build = builds
    packed, _ = run_cli(["pack", "--config", cpath])
    again, again_s = run_cli(base + ["--kinds", "hs_last_seq", "--batch-size", "16"])
    ev, ev_s = run_cli(["evaluate", "--config", cpath, "--split", "test"])
    launched = counts()

    chunks = xc["throughput"]["total_items"]
    for name, out in (("x_concat", xc), ("hs_last_seq", hl)):
        check(out["done"] == n and out["skipped"] == 0 and out["incomplete"] == [],
              f"phase 21 {name} {out} (expected {n} done)")
    check(again["done"] == 0 and again["skipped"] == n, f"phase 21 resume {again}")
    check(packed["versions_packed"] == n, f"phase 21 pack {packed}")
    check(all(math.isfinite(ev[k]) for k in ("MAP", "MR1")) and ev["n_queries"] == n,
          f"phase 21 evaluate {ev}")
    check(all(launched[k] > 0 for k in (*EXTRACT_KERNELS, "bpwr_redux")),
          f"phase 21 launches {launched}")

    store = EmbeddingStore(hs, "lyric-covers")
    seq_pack = PackedStore(hs, "hs_last_seq", dataset_name="lyric-covers")
    xc_pack = PackedStore(hs, "x_concat", dataset_name="lyric-covers")
    same = all(np.array_equal(seq_pack.load(str(v)), store.load(str(v), "hs_last_seq.npz")[
        "embeddings"]) for v, _ in rows)
    check(same and len(xc_pack) == n, f"phase 21 packs: hs_last_seq == store {same}, "
          f"x_concat {len(xc_pack)} of {n}")
    silent = xc_pack.load("2110")
    check(silent.shape == (1, 1280) and bool(np.isfinite(silent).all()),
          f"phase 21 the empty file's x_concat {silent.shape}")
    check(all(np.isfinite(xc_pack.load(str(v))).all() and np.isfinite(
        seq_pack.load(str(v))).all() for v, _ in rows), "phase 21 stored arrays not finite")

    # the batched rows of two songs against extract_song on the card, with the
    # x_concat command's own model, decoded by the same host path
    model, cfg = kept.pop()
    song_cos = []
    for v in (2105, 2111):
        path = os.path.join(data, "LyricCovers", "audio", str(v), f"{v}_audio.mp3")
        want = wextract.extract_song(model, load_audio(path), cfg, kinds=("x_concat",))
        song_cos.append(min_row_cos(torch.from_numpy(xc_pack.load(str(v))),
                                    torch.from_numpy(want["x_concat"])))
    check(min(song_cos) >= 0.999, f"phase 21 batched x_concat vs extract_song cos {song_cos}")
    del model
    torch.cuda.empty_cache()

    # the same split at whisper-tiny, card against CPU; each decode's tokens
    # are kept to find where the two greedy transcriptions part
    tokens = {}
    real = wextract.decoder_embeddings

    def recording(where):
        def decoder_embeddings(*args, **kw):
            out = real(*args, **kw)
            tokens.setdefault(where, []).append(out["tokens"].cpu().numpy())
            return out
        return decoder_embeddings

    tiny, walls = {}, {}
    for where in ("cuda", "cpu"):
        tconf = write_config(os.path.join(tmp, f"tiny_{where}.json"), lc,
                             os.path.join(tmp, f"hs_tiny_{where}"),
                             os.path.join(tmp, f"cache_tiny_{where}"), whisper_size="tiny",
                             data_root=data)
        t = time.perf_counter()
        # the split's first TINY_VERSIONS versions (all three WAV formats): a
        # full batch, then a partial one that each side pads with zero rows
        tiny_args = ["extract", "--config", tconf, "--split", "test", "--batched", "--limit",
                     str(TINY_VERSIONS), "--batch-size", str(TINY_BATCH), "--device", where]
        run_cli(tiny_args + ["--kinds", "x_concat"])
        with mock.patch.object(wextract, "decoder_embeddings", recording(where)):
            run_cli(tiny_args + ["--kinds", "hs_last_seq"])
        walls[where] = time.perf_counter() - t
        tiny[where] = EmbeddingStore(os.path.join(tmp, f"hs_tiny_{where}"), "lyric-covers")
    # the chunk order of the split jobs: the versions as the dataset lists them
    md, _ = build_clean_dataset(Config.from_file(tconf), check_audio=True)
    order = AudioDataset(md, "test", data).versions[:TINY_VERSIONS]
    xcos = min(min_row_cos(*(torch.from_numpy(tiny[w].load(v, "x_concat.npz")["embeddings"])
                             for w in ("cuda", "cpu"))) for v in order)
    seqs = {w: {v: tiny[w].load(v, "hs_last_seq.npz")["embeddings"] for v in order}
            for w in ("cuda", "cpu")}
    n_chunks = [(v, tiny["cpu"].load(v, "x_concat.npz")["embeddings"].shape[0]) for v in order]
    total = sum(c for _, c in n_chunks)
    toks = {w: np.concatenate(tokens[w])[:total] for w in ("cuda", "cpu")}
    tcfg = WHISPER_CONFIGS["tiny"]
    lc_, lp_, pairs = token_prefix_rows(toks["cuda"], toks["cpu"], seqs["cuda"], seqs["cpu"],
                                        n_chunks, prompt=len(default_prompt(tcfg)), max_len=224,
                                        eot=tcfg.eot)
    compared = sum(len(a) for a, _ in pairs)
    scos = min(min_row_cos(torch.from_numpy(a), torch.from_numpy(b)) for a, b in pairs if len(a))
    check(xcos >= 0.999, f"phase 21 tiny x_concat card vs CPU cos {xcos:.6f}")
    check(np.array_equal(lc_, lp_), "phase 21 tiny hs_last_seq lengths differ card vs CPU")
    check(scos >= 0.999, f"phase 21 tiny hs_last_seq card vs CPU cos {scos:.6f}")

    hl_chunks = hl["throughput"]["total_items"]
    check(xc["throughput"]["total_steps"] > 3 and hl["throughput"]["total_steps"] > 6,
          f"phase 21 batches {xc['throughput']} {hl['throughput']} (want 3 and 6 full ones)")
    cliques = len({c for _, c in rows})
    say(f"[21 extract over a split] {n} versions in {cliques} cliques, {chunks} chunks (16-bit "
        f"16 kHz, 24-bit 44.1 kHz stereo, float 48 kHz, one empty file -> 1 s silence; {mp3}); "
        f"native library "
        f"{'built in %.2f s' % native_s if native_s is not None else 'loaded'}, setup "
        f"{setup_s:.2f} s | large-v3-turbo: a. x_concat --pack-direct B=32 {xc_s:.2f} s wall "
        f"= {chunks / xc_s:.2f} chunks/s; less its model build {xc_build:.2f} s: "
        f"{chunks / (xc_s - xc_build):.2f} chunks/s; meter {xc['throughput']['items_per_sec']} "
        f"chunks/s ({xc['throughput']['total_steps']} batches); b. hs_last_seq B=16 max_len 224 "
        f"{hl_s:.2f} s = {hl_chunks / hl_s:.2f} chunks/s; less its model build "
        f"{hl_build:.2f} s: {hl_chunks / (hl_s - hl_build):.2f} chunks/s; meter "
        f"{hl['throughput']['items_per_sec']} chunks/s ({hl['throughput']['total_steps']} "
        f"batches); c. resume {again_s:.2f} s, "
        f"{again['skipped']} skipped; "
        f"d. evaluate MAP {ev['MAP']:.4f} MR1 {ev['MR1']:.2f} {ev_s:.2f} s; phase 7 per song "
        f"{per_song_rate:.2f} clips/s | batched x_concat vs extract_song cos "
        f"{min(song_cos):.6f}; tiny card vs CPU: x_concat cos {xcos:.6f}, hs_last_seq lengths "
        f"equal {np.array_equal(lc_, lp_)}, {compared} rows before the tokens part cos "
        f"{scos:.6f} over the first {TINY_VERSIONS} versions (card {walls['cuda']:.2f} s, CPU "
        f"{walls['cpu']:.2f} s); launches {launched}; phase {time.perf_counter() - t0:.1f} s "
        f"| {smi}")
    return launched


# phase 22: the fusion names trained and evaluated through the CLI, one a signature
FUSION_NAMES = ("wealy-clews", "multimodal-cross-attention-residual", "whisper-clews")
# the query ladder: rung k of a query's clique is the query plus noise at SIGMAS[k] of each
# array's spread, so that its 10 rungs are its top 10 (the other query's ladder and the
# random versions below them), spaced wider than the card-vs-CPU difference of a query
LADDER_SIGMAS = tuple(0.02 * k for k in range(10))
QUERY_VERSIONS = (2101, 2103)  # phase 21's 35 s 24-bit stereo and 65 s 16-bit files


def raises(exc, fn, *args) -> bool:
    """Whether ``fn(*args)`` raises ``exc``."""
    with contextlib.suppress(exc):
        fn(*args)
        return False
    return True


def min_cos(a: np.ndarray, b: np.ndarray) -> float:
    return min_row_cos(torch.from_numpy(np.atleast_2d(a)), torch.from_numpy(np.atleast_2d(b)))


def write_fusion_project(root: str, dev, ladders: list, seed: int = 22) -> tuple[str, dict]:
    """A lyric-covers project at full width for the fusion models: 128
    versions in 32 cliques (train 16 cliques of 4, val 4 of 4, test 12:
    two query ladders of 10 rungs, eight cliques of 3 and two of 2). Per
    version ``hs_wealy_concat`` (1-8 chunks x 512), ``hs_last_seq`` (T
    1000-2700 x 1280, fp16) and the CLEWS trio ((116, 2048), trailing
    windows invalid), clique members noisy copies of one base; versions
    1002 (train) and 1100 (test) have no CLEWS files. ``ladders``: per
    query its multimodal dict, whose rungs make a test clique. Returns
    (lyric-covers CSV dir, {split: [(version id, clique)]})."""
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore

    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    lc, store = os.path.join(root, "lc"), EmbeddingStore(os.path.join(root, "hs"), "lyric-covers")
    os.makedirs(lc)
    splits = {"train": [], "val": [], "test": []}
    layout = [("train", 4)] * 16 + [("val", 4)] * 4 + [("test", 3)] * 8 + [("test", 2)] * 2
    no_clews = {1002, 1100}
    vid = 1000

    def noise(shape, scale):
        return torch.randn(shape, device=dev, generator=g) * scale

    def save(v, wealy, seq, clews, n_valid):
        store.save(str(v), "hs_wealy_concat.npz", embeddings=wealy)
        store.save(str(v), "hs_last_seq.npz", embeddings=seq)
        if v in no_clews:
            return
        mask = np.arange(clews.shape[0]) >= n_valid  # True = invalid
        store.save(str(v), "hs_clews.npz", embeddings=clews)
        store.save(str(v), "hs_clews_avg.npz", embeddings=clews[~mask].mean(0))
        store.save(str(v), "hs_clews_mask.npz", embeddings=mask)

    for c, (split, per) in enumerate(layout):
        base_w, base_s, base_c = noise((8, 512), 1.0), noise((2700, 1280), 1.0), noise(
            (116, 2048), 1.0)
        for _ in range(per):
            n, T = int(rng.integers(1, 9)), int(rng.integers(1000, 2701))
            save(vid, (base_w[:n] + noise((n, 512), 0.5)).cpu().numpy(),
                 (base_s[:T] + noise((T, 1280), 1.0)).half().cpu().numpy(),
                 (base_c + noise((116, 2048), 0.5)).cpu().numpy(), int(rng.integers(20, 117)))
            splits[split].append((vid, f"{split}{c}"))
            vid += 1
    for q, mm in enumerate(ladders):
        w, cl = mm["wealy"]["embeddings"], mm["full_clews"]
        n_valid = int((~mm["clews_mask"]).sum())
        for k, sigma in enumerate(LADDER_SIGMAS):
            T = int(rng.integers(1000, 2701))
            save(vid, w + sigma * w.std() * rng.standard_normal(w.shape, np.float32),
                 noise((T, 1280), 1.0).half().cpu().numpy(),
                 cl + sigma * cl.std() * rng.standard_normal(cl.shape, np.float32), n_valid)
            splits["test"].append((vid, f"ladder{q}"))
            vid += 1
    write_split_csvs(lc, splits)
    return lc, splits


def fusion_config(root: str, lc: str, name: str, whisper_size: str = "tiny", tag: str = "",
                  batch_size: int = 8, max_steps: int = 20) -> str:
    """A project config for fusion model ``name`` (zdim 512, chunk 1000 at
    overlap 0.9): train batch ``batch_size`` cliques x 2, lr 1e-4, warm-up 1
    step, every step's metrics in ``metrics_<name><tag>.jsonl``,
    checkpoints in ``ckpt_<name><tag>``."""
    cpath = write_config(os.path.join(root, f"{name}{tag}.json"), lc, os.path.join(root, "hs"),
                         os.path.join(root, "cache"), name=name, whisper_size=whisper_size)
    conf = json.load(open(cpath))
    conf["path"]["checkpoints"] = os.path.join(root, f"ckpt_{name}{tag}")
    conf["train"] = {"loss": "clews", "batch_size": batch_size, "lr": 1e-4, "warmup_steps": 1,
                     "max_steps": max_steps, "log_every": 0, "eval_every": 1000,
                     "checkpoint_every": 1000,
                     "metrics_jsonl": os.path.join(root, f"metrics_{name}{tag}.jsonl")}
    with open(cpath, "w") as f:
        json.dump(conf, f)
    return cpath


def fusion_phase(tmp: str, dev, reset_counts, counts, smi: str, max_steps: int = 20) -> dict:
    """22. The CLEWS branch and the fusion models on phase 21's audio
    project and a fusion project at full width: a. ``extract --kinds
    hs_clews`` over the 48 versions, card against CPU on the first 4; b.
    ``train`` / ``evaluate`` (monolithic, ``--streaming``, ``--test-mode``
    for wealy-clews, ``--checkpoint``) for one name a signature, the first
    losses and the test-mode MAP card against CPU; c. ``index`` of the
    fusion project and ``query --audio`` of two WAVs at whisper-tiny (card
    against CPU) and large-v3-turbo (p50 after a warm-up), and the refusals
    JAX makes; d. the BatchNorm step of a class-default ClewsEncoder, card
    against CPU. Returns the launches of a-c."""
    from wealy_tpu_torch.cli import serve as tserve
    from wealy_tpu_torch.cli.main import main as cli_main
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.data.multimodal import WealyClewsDataset
    from wealy_tpu_torch.models import clews_extract
    from wealy_tpu_torch.train.config import Config

    t_phase = time.perf_counter()
    lc21, data21 = os.path.join(tmp, "lc"), os.path.join(tmp, "data")
    wavs = [os.path.join(data21, "LyricCovers", "audio", str(v), f"{v}_audio.mp3")
            for v in QUERY_VERSIONS]
    reset_counts()

    # a. extract --kinds hs_clews: the card over the split, the CPU over its first 4
    builds, real_make = [], clews_extract.make_clews_extractor

    def timed_make(**kw):
        t = time.perf_counter()
        out = real_make(**kw)
        if str(kw.get("device")) != "cpu":
            torch.cuda.synchronize()
        builds.append(time.perf_counter() - t)
        return out

    stores, ex = {}, {}
    for role, where, limit in (("card", dev.type, None), ("cpu", "cpu", 4)):
        cpath = write_config(os.path.join(tmp, f"clews_{role}.json"), lc21,
                             os.path.join(tmp, f"hs_clews_{role}"),
                             os.path.join(tmp, f"cache_clews_{role}"), data_root=data21)
        argv = ["extract", "--config", cpath, "--split", "test", "--kinds", "hs_clews",
                "--device", where] + (["--limit", str(limit)] if limit else [])
        with mock.patch.object(clews_extract, "make_clews_extractor", timed_make):
            ex[role] = run_cli(argv)
        stores[role] = EmbeddingStore(os.path.join(tmp, f"hs_clews_{role}"), "lyric-covers")
    (card_ex, card_s), (cpu_ex, cpu_s) = ex["card"], ex["cpu"]
    n21 = sum(1 for _ in open(os.path.join(lc21, "test_no_dup.csv"))) - 1
    check(card_ex == {"done": n21, "skipped": 0, "failed": 0} and cpu_ex["done"] == 4,
          f"phase 22a extract hs_clews card {card_ex} CPU {cpu_ex}")
    songs_s = n21 / (card_s - builds[0])
    first4 = sorted(v for v in os.listdir(os.path.join(tmp, "hs_clews_cpu")) if v.isdigit())
    trio = {role: {v: {k: stores[role].load(v, f"{k}.npz")["embeddings"]
                       for k in ("hs_clews", "hs_clews_avg", "hs_clews_mask")} for v in first4}
            for role in ("card", "cpu")}
    card = trio["card"]
    rows_cos = min(min_cos(card[v]["hs_clews"], trio["cpu"][v]["hs_clews"]) for v in first4)
    avg_cos = min(min_cos(card[v]["hs_clews_avg"], trio["cpu"][v]["hs_clews_avg"])
                  for v in first4)
    masks_equal = all(np.array_equal(card[v]["hs_clews_mask"], trio["cpu"][v]["hs_clews_mask"])
                      for v in first4)
    check(len(first4) == 4 and rows_cos >= 0.9999 and avg_cos >= 0.9999 and masks_equal,
          f"phase 22a hs_clews card vs CPU: rows cos {rows_cos:.7f}, avg {avg_cos:.7f}, masks "
          f"equal {masks_equal} over {first4}")
    # the same 4 songs with cuDNN's TF32 convolutions (PyTorch's default; off in this
    # script), against the CPU's f32 trio: the gap a user's default run carries
    from wealy_tpu_torch.audio.decode import load_audio

    ext = real_make(device=dev)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=True):
        tf32 = {v: ext(load_audio(os.path.join(data21, "LyricCovers", "audio", v,
                                               f"{v}_audio.mp3"))) for v in first4}
    tf32_cos = min(min_cos(tf32[v]["hs_clews"], trio["cpu"][v]["hs_clews"]) for v in first4)
    del ext
    line_a = (f"a. extract --kinds hs_clews {n21} versions {card_s:.2f} s, build {builds[0]:.2f}"
              f" s, {songs_s:.2f} songs/s less it; CPU 4 versions {cpu_s:.2f} s; first 4 card vs"
              f" CPU: rows cos {rows_cos:.7f}, avg cos {avg_cos:.7f}, masks equal {masks_equal};"
              f" with TF32 convolutions rows cos {tf32_cos:.7f}")

    # the query side at whisper-tiny on the CPU first: its dicts seed the ladders
    tiny_cpu_cfg = Config.from_file(fusion_config(tmp, lc21, "wealy-clews", tag="_q"))
    meta = {"sig": "wealy", "wealy_dim": 512}
    t = time.perf_counter()
    q_cpu_fn = tserve.make_mm_query_embed_fn(tiny_cpu_cfg, meta, device="cpu")
    q_cpu = [q_cpu_fn(w) for w in wavs]
    q_cpu_s = time.perf_counter() - t

    # b. the fusion project; train / evaluate each signature
    t = time.perf_counter()
    root = os.path.join(tmp, "fusion")
    os.makedirs(root)
    lc, splits = write_fusion_project(root, dev, q_cpu)
    setup_s = time.perf_counter() - t
    n_test = len(splits["test"])
    probe = WealyClewsDataset(Config.from_file(fusion_config(root, lc, "wealy-clews",
                                                             tag="_probe")), "test")
    for i, v in enumerate(probe.sampler.versions):
        if v == "1100":
            probe.sampler.sample_item(i)
    check(any(e.startswith("1100:") for e in probe.dummy_log),
          f"phase 22b the version without CLEWS files logged no dummy: {probe.dummy_log}")
    import wealy_tpu_torch.train.step as tstep

    train_lines, evals = [], {}
    make_step = tstep.make_train_step
    for name in FUSION_NAMES:
        n_calls = 0

        def make_synced_step(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def synced(state, batch):
                nonlocal n_calls
                out = step(state, batch)
                n_calls += 1
                if n_calls in (2, max_steps) and state.device.type == "cuda":
                    torch.cuda.synchronize()
                return out

            return synced

        cpath = fusion_config(root, lc, name, max_steps=max_steps)
        cpu_path = fusion_config(root, lc, name, tag="_cpu", max_steps=3)
        with mock.patch.object(tstep, "make_train_step", make_synced_step):
            out, train_s = run_cli(["train", "--config", cpath])
        cpu_out, cpu_train_s = run_cli(["train", "--config", cpu_path, "--device", "cpu"])
        recs = [json.loads(r) for r in open(os.path.join(root, f"metrics_{name}.jsonl"))]
        cpu_recs = [json.loads(r) for r in open(os.path.join(root, f"metrics_{name}_cpu.jsonl"))]
        steps = [r for r in recs if "loss" in r]
        rate = (len(steps) - 2) / (steps[-1]["t"] - steps[1]["t"])
        card3 = np.array([r["loss"] for r in steps[:3]])
        cpu3 = np.array([r["loss"] for r in cpu_recs if "loss" in r][:3])
        check(out["final_step"] == max_steps and np.isfinite(out["final_loss"])
              and len(cpu3) == 3 and np.allclose(card3, cpu3, rtol=1e-4, atol=0),
              f"phase 22b {name} train {out}: first losses card {card3} CPU {cpu3}")
        base = ["evaluate", "--config", cpath, "--split", "test", "--checkpoint",
                os.path.join(root, f"ckpt_{name}")]
        mono, mono_s = run_cli(base)
        streamed, _ = run_cli(base + ["--streaming"])
        check(all(mono[k] == streamed[k] for k in ("MAP", "MR1"))
              and mono["n_queries"] == n_test,
              f"phase 22b {name} evaluate monolithic {mono} != --streaming {streamed}")
        evals[name] = mono
        train_lines.append(
            f"{name}: {rate:.2f} steps/s (steps 2-{max_steps}; {train_s:.2f} s), losses 1-3 "
            f"card {np.round(card3, 6).tolist()} CPU {np.round(cpu3, 6).tolist()} (CPU "
            f"{cpu_train_s:.2f} s); evaluate --checkpoint MAP {mono['MAP']:.6f} MR1 "
            f"{mono['MR1']:.3f} {n_test / mono_s:.2f} songs/s, == --streaming")
    wc = fusion_config(root, lc, "wealy-clews")
    tm = ["evaluate", "--config", wc, "--split", "test", "--test-mode", "--checkpoint",
          os.path.join(root, "ckpt_wealy-clews")]
    k4_before = counts()["bpwr_redux"]
    tmode, tmode_s = run_cli(tm)
    k4_test_mode = counts()["bpwr_redux"] - k4_before
    tmode_stream, _ = run_cli(tm + ["--streaming"])
    tmode_cpu, _ = run_cli(tm + ["--device", "cpu"])
    check(k4_test_mode > 0 and tmode["MAP"] == tmode_stream["MAP"]
          and tmode["MR1"] == tmode_stream["MR1"]
          and abs(tmode["MAP"] - tmode_cpu["MAP"]) <= 1e-6,
          f"phase 22b --test-mode {tmode} --streaming {tmode_stream} CPU {tmode_cpu}, K4 "
          f"launches {k4_test_mode}")
    line_b = (f"b. {len(splits['train']) + len(splits['val']) + n_test} versions ({setup_s:.1f} s "
              f"set-up): " + "; ".join(train_lines) + f"; wealy-clews --test-mode MAP "
              f"{tmode['MAP']:.6f} ({n_test / tmode_s:.2f} songs/s, K4 {k4_test_mode} launches)"
              f" == --streaming, CPU {tmode_cpu['MAP']:.6f}")

    # c. index the project with wealy-clews, then query two WAVs
    idx = os.path.join(root, "wealy_clews_index.npz")
    ix, ix_s = run_cli(["index", "--config", wc, "--split", "test", "--out", idx])
    check(ix["indexed"] == n_test and ix["fusion"], f"phase 22c index {ix}")
    tops = {}
    for where in (dev.type, "cpu"):
        lines, _ = run_cli_lines(["query", "--config", wc, "--index", idx, "--k", "10",
                                  "--device", where, "--audio", *wavs])
        tops[where] = [[r["version_key"] for r in line["results"]] for line in lines]
    ladder_keys = [[str(v) for v, c in splits["test"] if c == f"ladder{q}"] for q in (0, 1)]
    check(tops[dev.type] == tops["cpu"] and [t[0] for t in tops["cpu"]] == [k[0] for k in
                                                                          ladder_keys],
          f"phase 22c tiny top-10 card {tops[dev.type]} CPU {tops['cpu']} (the ladders "
          f"{ladder_keys}, rung 0 first)")
    on_ladder = sum(len(set(t) & set(k)) for t, k in zip(tops["cpu"], ladder_keys))
    check(on_ladder == 20, f"phase 22c {on_ladder} of the 20 top-10 entries on the queries' "
          f"own ladders")
    emb = os.path.join(root, "q.npz")
    np.savez(emb, embeddings=np.zeros((4, 1280), np.float32))
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        refused_emb = cli_main(["query", "--config", wc, "--index", idx, "--device", dev.type,
                                "--query-embeddings", emb]) == 2
        refused_rerank = raises(ValueError, cli_main, [
            "query", "--config", wc, "--index", idx, "--device", dev.type, "--rerank", "5",
            "--audio", wavs[0]])
    check(refused_emb and refused_rerank,
          f"phase 22c refusals: embedding query {refused_emb}, --rerank {refused_rerank}")
    turbo_cfg = Config.from_file(fusion_config(root, lc, "wealy-clews",
                                               whisper_size="large-v3-turbo", tag="_turbo"))
    t = time.perf_counter()
    eng = tserve.QueryEngine(turbo_cfg, idx, os.path.join(root, "ckpt_wealy-clews"),
                             device=dev)
    eng.search(eng.embed_audio(wavs[0]), k=10)  # the build and a warm-up
    build_s = time.perf_counter() - t
    lat = []
    for _ in range(3):
        for w in wavs:
            t = time.perf_counter()
            out = eng.search(eng.embed_audio(w), k=10)
            lat.append(time.perf_counter() - t)
    check(len(out["results"]) == 10 and all(np.isfinite(r["score"]) for r in out["results"]),
          f"phase 22c turbo query {out}")
    del eng
    torch.cuda.empty_cache()
    launched = counts()
    check(all(launched[k] > 0 for k in (*EXTRACT_KERNELS, "bpwr_redux")),
          f"phase 22 launches {launched}")
    line_c = (f"c. index {n_test} versions {ix_s:.2f} s; query --audio {len(wavs)} WAVs at "
              f"whisper-tiny: top-10 card == CPU {tops[dev.type] == tops['cpu']}, rung 0 first, "
              f"{on_ladder} of 20 on the query's own ladder; "
              f"refused: embedding query {refused_emb}, --rerank {refused_rerank}; "
              f"large-v3-turbo p50 {np.median(lat) * 1e3:.1f} ms over {len(lat)} queries "
              f"(35 s and 65 s WAVs; build + warm-up {build_s:.1f} s); CPU query dicts "
              f"{q_cpu_s:.2f} s")

    # d. the BatchNorm step (not a path with a kernel: outside the launch count)
    line_d = batch_norm_step(dev)
    say(f"[22 fusion] {line_a} | {line_b} | {line_c} | {line_d}; launches {launched}; phase "
        f"{time.perf_counter() - t_phase:.1f} s | {smi}")
    return launched


def batch_norm_step(dev, steps: int = 3, windows: int = 116) -> str:
    """22d. A ClewsEncoder at its class-default widths (stem 64, stages 64,
    128, 256, 512, embed 2048) over ``windows`` windows of (84, 32) CQT,
    trained ``steps`` steps with ``with_batch_stats`` (clews loss, AdamW
    at lr 1e-4) on the card and on the CPU from the same seeded weights
    and batches: losses at rtol 1e-4, and after every step the running
    variances at rtol 1e-4 and the running means at rtol 1e-4 of |mean| +
    std; the card's step ms after them."""
    from wealy_tpu_torch.losses import clews_loss
    from wealy_tpu_torch.models.clews_encoder import ClewsEncoder, seeded_init_
    from wealy_tpu_torch.train.state import TrainState, make_optimizer
    from wealy_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(23)
    batches = [{"emb": np.abs(rng.standard_normal((windows, 1, 84, 32), np.float32)),
                "labels": np.repeat(np.arange(windows // 2, dtype=np.int32), 2),
                "ids": np.arange(windows, dtype=np.int32)} for _ in range(steps)]
    runs = {}
    for where in (dev, torch.device("cpu")):
        model = seeded_init_(ClewsEncoder(), 0).to(where)
        state = TrainState(model, make_optimizer(lr=1e-4, warmup_steps=1, max_steps=100))
        step = make_train_step(model, clews_loss, with_batch_stats=True)
        losses, stats = [], []
        for b in batches:
            state, log = step(state, {k: torch.from_numpy(v).to(where) for k, v in b.items()})
            losses.append(float(log["loss"]))
            stats.append({k: v.clone().cpu() for k, v in state.batch_stats.items()})
        runs["card" if where == dev else "cpu"] = (np.array(losses), stats)
        if where == dev:
            feed = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                step(state, feed)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t) / steps * 1e3
    (lc, sc), (lp, sp) = runs["card"], runs["cpu"]

    def worst(i):
        """The largest element-wise relative difference of step i's running
        statistics: (value, name, card value, CPU value)."""
        rel = {k: ((sc[i][k] - sp[i][k]).abs() / sp[i][k].abs().clamp(min=1e-30)) for k in sp[i]}
        k = max(rel, key=lambda n: float(rel[n].max()))
        j = int(rel[k].argmax())
        return float(rel[k].max()), k, float(sc[i][k].flatten()[j]), float(sp[i][k].flatten()[j])

    def within(i) -> bool:
        """Step i's statistics at rtol 1e-4: each variance to itself, each
        mean to its |mean| + std, the scale BatchNorm divides it by (a
        channel's mean cancels to about 1e-5 of its terms, and its f32 sum
        order shows there element-wise, but not in the normalised output)."""
        ok = True
        for k in sp[i]:
            if k.endswith("running_var"):
                ok &= bool(((sc[i][k] - sp[i][k]).abs() <= 1e-4 * sp[i][k].abs()).all())
            else:
                std = sp[i][k.replace("running_mean", "running_var")].sqrt()
                ok &= bool(((sc[i][k] - sp[i][k]).abs() <= 1e-4 * (sp[i][k].abs() + std)).all())
        return ok

    worsts = [worst(i) for i in range(steps)]
    stats_ok = all(within(i) for i in range(steps)) and len(sp[-1]) == len(sc[-1]) > 0
    check(np.allclose(lc, lp, rtol=1e-4, atol=0) and stats_ok,
          f"phase 22d BatchNorm step losses card {lc} CPU {lp}, running statistics within "
          f"rtol 1e-4 {stats_ok} (element-wise worst by step {worsts})")
    return (f"d. BatchNorm step, class-default ClewsEncoder over {windows} windows of (84, 32): "
            f"losses card {np.round(lc, 6).tolist()} CPU {np.round(lp, 6).tolist()}, "
            f"{len(sp[-1])} running statistics, worst relative difference by step "
            f"{[f'{w[0]:.3g} ({w[1]}: {w[2]:.6g} vs {w[3]:.6g})' for w in worsts]}; "
            f"{step_ms:.2f} ms a step on the card")


# phase 23: the toy vocabulary's merges over the 256 byte tokens, and the
# long-form initial prompt
TOY_MERGES = (("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("ll", "o"), ("i", "n"),
              ("Ġ", "a"), ("e", "r"))
INITIAL_PROMPT = "la la love song"
# float8 against the same decode at the compute dtype, teacher-forced: the JAX
# tests' bounds on the largest error relative to the largest state
F8_CROSS_BOUND, F8_SELF_BOUND = 0.06, 0.08


def write_toy_vocab(path: str) -> str:
    """A byte-level BPE vocabulary in ``path``: the 256 byte tokens (id =
    byte value), one token a merge of TOY_MERGES, and Whisper's
    <|endoftext|> and <|startoftranscript|> as specials."""
    from wealy_tpu_torch.data.tokenizer import _bytes_to_unicode

    os.makedirs(path)
    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    for a, b in TOY_MERGES:
        vocab[a + b] = len(vocab)
    special = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258}
    vocab.update(special)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in TOY_MERGES) + "\n")
    with open(os.path.join(path, "special_tokens.json"), "w") as f:
        json.dump(special, f)
    return path


def transcription_phase(tmp: str, dev, reset_counts, counts, smi: str) -> dict:
    """23. Transcription on phase 21's audio project at large-v3-turbo (full
    width and depth, seeded weights) through the CLI: a. ``transcribe
    --greedy --batched --batch-size 16 --max-len 224 --tokenizer-dir`` (a
    toy vocabulary written here) over the 48 versions, the census, a resume
    that skips all; b. the same with ``--beam-size 5 --limit 8`` (B*K = 80
    rows); c. the long-form default (``--limit 4 --max-len 64``), again with
    ``--beam-size 5 --initial-prompt``: s, rungs and decodes a chunk; one
    ``transcribe_longform`` with both thresholds None (the context carries);
    d. ``extract --batched --kinds hs_last_seq`` over the first 16 versions
    at B=16 with ``--cross-kv-f8 --self-kv-f8`` beside the bf16 route:
    chunks/s, state cosine over each chunk's common token prefix, the JAX
    tests' bounds teacher-forced, the f8 cast card == CPU; e. whisper-tiny
    in bf16, card against CPU on the first 4 versions: greedy tokens equal
    up to the CPU's first top-2 log-prob margin below 1e-2, teacher-forced
    logits along the CPU's tokens at row cosine >= 0.9999, the same
    ``detect_language`` index. The commands share one model from the seed,
    built once through their loader (timed). Returns the launches of a-d."""
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.cli import extract_batched
    from wealy_tpu_torch.cli import transcribe as ttr
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.data.audio_dataset import AudioDataset
    from wealy_tpu_torch.data.dataset import build_clean_dataset
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.data.packed_store import PackedStore
    from wealy_tpu_torch.models.whisper import extract as wextract
    from wealy_tpu_torch.models.whisper import generate as wgen
    from wealy_tpu_torch.models.whisper.longform import TEMPERATURES, transcribe_longform
    from wealy_tpu_torch.train.config import Config

    t_phase = time.perf_counter()
    lc, data = os.path.join(tmp, "lc"), os.path.join(tmp, "data")
    vocab = write_toy_vocab(os.path.join(tmp, "vocab"))

    def conf(name: str) -> str:
        return write_config(os.path.join(tmp, f"{name}.json"), lc, os.path.join(tmp, f"hs_{name}"),
                            os.path.join(tmp, f"cache_{name}"), whisper_size="large-v3-turbo",
                            data_root=data)

    def tree(name: str) -> list:
        root = os.path.join(tmp, f"cache_{name}", "transcriptions", "turbo_nothing_whisper_42",
                            "test")
        return sorted(f for f in os.listdir(root) if f.endswith(".txt"))

    md, _ = build_clean_dataset(Config.from_file(conf("tr_a")), check_audio=True)
    order = AudioDataset(md, "test", data).versions
    n = len(order)
    x_pack = PackedStore(os.path.join(tmp, "hs"), "x_concat", dataset_name="lyric-covers")
    n_chunks = {v: x_pack.load(v).shape[0] for v in order}  # phase 21's rows: one a chunk

    # the commands' model: built once from the seed where their loaders make it
    built, builds = {}, []

    def shared_load(size, checkpoint=None, seed=0, device="cuda", dtype=torch.bfloat16):
        key = (size, str(device), dtype)
        if key not in built:
            t = time.perf_counter()
            built[key] = load_whisper_model(size, checkpoint, seed, device, dtype)
            torch.cuda.synchronize()
            builds.append(time.perf_counter() - t)
        return built[key]

    segments, dec_tokens = [], {}
    real_lf, real_dec = ttr.transcribe_longform, wextract.decoder_embeddings

    def recording_lf(*args, **kw):
        out = real_lf(*args, **kw)
        segments[-1].append(out["segments"])
        return out

    def recording_dec(route):
        def decoder_embeddings(*args, **kw):
            out = real_dec(*args, **kw)
            dec_tokens.setdefault(route, []).append(out["tokens"].cpu().numpy())
            return out
        return decoder_embeddings

    batched = ["--split", "test", "--greedy", "--batched", "--batch-size", "16", "--max-len",
               "224", "--tokenizer-dir", vocab]
    ext = ["--split", "test", "--batched", "--kinds", "hs_last_seq", "--limit", "16",
           "--batch-size", "16"]
    reset_counts()
    with mock.patch.object(ttr, "load_whisper_model", shared_load), \
            mock.patch.object(extract_batched, "load_whisper_model", shared_load), \
            mock.patch.object(ttr, "transcribe_longform", recording_lf):
        # a. batched greedy, then the resume
        ga, ga_s = run_cli(["transcribe", "--config", conf("tr_a")] + batched)
        build_s = builds[0]
        again, again_s = run_cli(["transcribe", "--config", conf("tr_a")] + batched)
        # b. batched beam search
        gb, gb_s = run_cli(["transcribe", "--config", conf("tr_b")] + batched
                           + ["--beam-size", "5", "--limit", "8"])
        # c. the long-form default, then its beam rung with an initial prompt
        lf_runs = []
        for name, extra in (("tr_c", []), ("tr_c_beam", ["--beam-size", "5", "--initial-prompt",
                                                         INITIAL_PROMPT, "--tokenizer-dir",
                                                         vocab])):
            segments.append([])
            out, wall = run_cli(["transcribe", "--config", conf(name), "--split", "test",
                                 "--limit", "4", "--max-len", "64"] + extra)
            lf_runs.append((name, out, wall, segments[-1]))
        # d. the decoder kind through float8 KV caches beside the bf16 route
        with mock.patch.object(wextract, "decoder_embeddings", recording_dec("bf16")):
            eb, eb_s = run_cli(["extract", "--config", conf("ex_bf16")] + ext)
        with mock.patch.object(wextract, "decoder_embeddings", recording_dec("f8")):
            ef, ef_s = run_cli(["extract", "--config", conf("ex_f8")] + ext
                               + ["--cross-kv-f8", "--self-kv-f8"])
    launched = counts()
    check(len(builds) == 1, f"phase 23 model builds {builds} (one for every command)")
    check(all(launched[k] > 0 for k in EXTRACT_KERNELS), f"phase 23 launches {launched}")

    # a. every version transcribed, the census over them, the resume
    chunks_a = ga["throughput"]["total_items"]
    check(ga["done"] == n and ga["failed"] == 0 and ga["n_total"] == n
          and len(tree("tr_a")) == n and chunks_a == sum(n_chunks.values()),
          f"phase 23a {ga} ({len(tree('tr_a'))} .txt files, {n} versions)")
    check(again["done"] == 0 and again["skipped"] == n, f"phase 23a resume {again}")
    with open(ga["cache_file"]) as f:
        census = json.load(f)
    check(len(census["texts"]) == n, f"phase 23a census of {len(census['texts'])} texts")
    line_a = (f"a. --greedy --batched B=16 max_len 224, toy tokenizer: {n} versions, {chunks_a} "
              f"chunks, {ga_s:.2f} s wall, less the model's build {build_s:.2f} s: "
              f"{chunks_a / (ga_s - build_s):.2f} chunks/s; meter "
              f"{ga['throughput']['items_per_sec']} chunks/s ({ga['throughput']['total_steps']} "
              f"batches); {len(tree('tr_a'))} .txt, census n_valid {ga['n_valid']} of "
              f"{ga['n_total']}; resume {again_s:.2f} s, {again['skipped']} skipped")

    # b. beam search, K=5
    chunks_b = gb["throughput"]["total_items"]
    check(gb["done"] == 8 and gb["failed"] == 0 and len(tree("tr_b")) == 8
          and chunks_b == sum(n_chunks[v] for v in order[:8]), f"phase 23b {gb}")
    line_b = (f"b. --beam-size 5 --limit 8: {chunks_b} chunks (B*K up to 80 rows), {gb_s:.2f} s "
              f"= {chunks_b / gb_s:.2f} chunks/s; meter {gb['throughput']['items_per_sec']}")

    # c. the long-form ladder: rungs a chunk (one batched decode each; a sampled
    # rung decodes best_of=5 rows, the t=0 rung one row or K beams)
    parts = []
    for name, out, wall, segs in lf_runs:
        chunk_segs = [s for song in segs for s in song]
        rungs = [TEMPERATURES.index(s["temperature"]) + 1 for s in chunk_segs]
        check(out["done"] == 4 and out["failed"] == 0 and len(chunk_segs) == sum(
            n_chunks[v] for v in order[:4]), f"phase 23c {name} {out}, {len(chunk_segs)} chunks")
        check(all(math.isfinite(s["avg_logprob"]) for s in chunk_segs),
              f"phase 23c {name} log-probs {chunk_segs}")
        parts.append(f"{name}: {len(chunk_segs)} chunks, {wall:.2f} s = "
                     f"{wall / len(chunk_segs):.3f} s a chunk, rungs a chunk "
                     f"{np.mean(rungs):.2f} (decodes {sum(rungs)}), temperatures "
                     f"{sorted({s['temperature'] for s in chunk_segs})}, context lengths "
                     f"{[s['context_len'] for s in chunk_segs]}")
    check(lf_runs[1][3][0][0]["context_len"] > 0,
          f"phase 23c the initial prompt gave no context {lf_runs[1][3][0][0]}")
    model, cfg = built[("large-v3-turbo", str(dev), torch.bfloat16)]
    song = max(order[:8], key=lambda v: n_chunks[v])
    ds = AudioDataset(md, "test", data)
    audio = torch.from_numpy(wextract.chunk_waveform(ds[order.index(song)].waveform)).to(dev)
    with torch.inference_mode():
        states = model.encode(log_mel_spectrogram_fused(audio, cfg.n_mels))
        t = time.perf_counter()
        carried = transcribe_longform(model, states, cfg, max_len=64,
                                      compression_ratio_threshold=None, logprob_threshold=None,
                                      no_speech_threshold=None, seed=23)
        carried_s = time.perf_counter() - t
    ctx = [s["context_len"] for s in carried["segments"]]
    check(len(ctx) >= 2 and max(ctx[1:]) > 0 and ctx[0] == 0,
          f"phase 23c thresholds None: context lengths {ctx}")
    line_c = (f"c. long-form --limit 4 --max-len 64: {'; '.join(parts)}; thresholds None over "
              f"{song} ({len(ctx)} chunks): context lengths {ctx}, {carried_s:.2f} s")

    # d. float8: rates, the states over each chunk's common token prefix, the
    # JAX bounds teacher-forced, the cast
    first16 = order[:16]
    chunks_d = eb["throughput"]["total_items"]
    check(eb["done"] == ef["done"] == len(first16) and chunks_d == ef["throughput"]["total_items"]
          == sum(n_chunks[v] for v in first16), f"phase 23d bf16 {eb} f8 {ef}")
    stores = {r: EmbeddingStore(os.path.join(tmp, f"hs_ex_{r}"), "lyric-covers")
              for r in ("bf16", "f8")}
    seqs = {r: {v: stores[r].load(v, "hs_last_seq.npz")["embeddings"] for v in first16}
            for r in stores}
    toks = {r: np.concatenate(dec_tokens[r])[:chunks_d] for r in stores}
    prompt_len = len(wgen.default_prompt(cfg))
    _, _, pairs = token_prefix_rows(toks["f8"], toks["bf16"], seqs["f8"], seqs["bf16"],
                                    [(v, n_chunks[v]) for v in first16], prompt=prompt_len,
                                    max_len=224, eot=cfg.eot)
    prefix_rows = sum(len(a) for a, _ in pairs)
    f8_cos = min(min_row_cos(torch.from_numpy(a), torch.from_numpy(b)) for a, b in pairs if len(a))
    same_tokens = float((toks["f8"] == toks["bf16"]).mean())
    f8 = torch.float8_e4m3fn
    with torch.inference_mode():
        # two chunks of the song above, along their own bf16 greedy tokens
        tf_states = states[:2]
        tf_tokens = wgen.greedy_decode(model, tf_states, cfg, wgen.default_prompt(cfg),
                                       max_len=64)["tokens"]
        B, L = tf_tokens.shape

        def teacher_forced(self_dtype, cross_dtype):
            caches = wgen.init_kv_caches(cfg, B, L, dtype=self_dtype or model.dtype, device=dev)
            xa = wgen.decode_cross_kv(model, tf_states, None, cross_dtype)
            hid, _, caches = model.decode(tf_tokens, None, kv_caches=caches, cache_index=0,
                                          xa_kv=xa)
            check(caches[0][0].dtype == (self_dtype or model.dtype),
                  f"phase 23d cache dtype {caches[0][0].dtype}")
            return hid.float()

        ref = teacher_forced(None, None)
        rel_cross = float((teacher_forced(None, f8) - ref).abs().max() / ref.abs().max())
        rel_self = float((teacher_forced(f8, None) - ref).abs().max() / ref.abs().max())
    check(rel_cross < F8_CROSS_BOUND and rel_self < F8_SELF_BOUND,
          f"phase 23d f8 teacher-forced relative error cross {rel_cross:.4f} (< {F8_CROSS_BOUND})"
          f", self {rel_self:.4f} (< {F8_SELF_BOUND})")
    grid = torch.linspace(-448, 448, 20001).bfloat16()
    grid = torch.cat([grid, grid * 2.0 ** -12, grid * 2.0 ** -8])
    cast_same = torch.equal(grid.to(dev).to(f8).view(torch.uint8).cpu(),
                            grid.to(f8).view(torch.uint8))
    check(cast_same, "phase 23d the f8 cast differs card vs CPU")
    line_d = (f"d. extract --batched hs_last_seq B=16, first 16 versions ({chunks_d} chunks): "
              f"bf16 {eb_s:.2f} s = {chunks_d / eb_s:.2f} chunks/s (meter "
              f"{eb['throughput']['items_per_sec']}), --cross-kv-f8 --self-kv-f8 {ef_s:.2f} s = "
              f"{chunks_d / ef_s:.2f} chunks/s (meter {ef['throughput']['items_per_sec']}); "
              f"tokens equal {same_tokens:.4f} of positions, {prefix_rows} rows before the "
              f"tokens part cos {f8_cos:.6f}; teacher-forced over {B} x {L}: cross f8 rel "
              f"{rel_cross:.4f}, self f8 rel {rel_self:.4f}; cast card == CPU {cast_same} "
              f"({grid.numel()} bf16 values)")
    del model, states, built
    torch.cuda.empty_cache()

    # e. whisper-tiny in bf16, card against CPU, on the first 4 versions
    t_e = time.perf_counter()
    cpu_model, tcfg = load_whisper_model("tiny", seed=0, device="cpu", dtype=torch.bfloat16)
    card_model, _ = load_whisper_model("tiny", seed=0, device=dev, dtype=torch.bfloat16)
    chunks = torch.from_numpy(np.concatenate([wextract.chunk_waveform(ds[i].waveform)
                                              for i in range(4)]))
    prompt = wgen.default_prompt(tcfg, language=0)
    suppress = wgen.default_suppress_tokens(tcfg)
    res = {}
    for where, m in (("cuda", card_model), ("cpu", cpu_model)):
        with torch.inference_mode():
            st = m.encode(log_mel_spectrogram_fused(chunks.to(m.device), tcfg.n_mels))
            out = wgen.greedy_decode(m, st, tcfg, prompt, max_len=64, suppress_tokens=suppress)
            lang, lang_logp = wgen.detect_language(m, st, tcfg)
        res[where] = (st, out, lang.cpu(), lang_logp.float().cpu())
    cpu_tokens = res["cpu"][1]["tokens"]
    logits = {}
    for where, m in (("cuda", card_model), ("cpu", cpu_model)):
        with torch.inference_mode():
            caches = wgen.init_kv_caches(tcfg, len(chunks), 64, dtype=m.dtype, device=m.device)
            _, lg, _ = m.decode(cpu_tokens.to(m.device), None, kv_caches=caches, cache_index=0,
                                xa_kv=wgen.decode_cross_kv(m, res[where][0]))
        logits[where] = lg.float().cpu()
    lengths = res["cpu"][1]["lengths"]
    logit_cos = min(min_row_cos(logits["cuda"][b, : int(n) - 1], logits["cpu"][b, : int(n) - 1])
                    for b, n in enumerate(lengths))
    masked = logits["cpu"].masked_fill(wgen.suppress_mask(tcfg, suppress, "cpu"), float("-inf"))
    top2 = torch.log_softmax(masked, -1).topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # margin[b, j]: the choice of token j + 1
    card_tokens = res["cuda"][1]["tokens"].cpu()
    held, compared = True, 0
    for b in range(len(chunks)):
        L = int(lengths[b])
        low = [j + 1 for j in range(len(prompt) - 1, min(L, 63)) if margin[b, j] < 1e-2]
        upto = min(low) if low else 64
        compared += upto - len(prompt)
        held &= torch.equal(card_tokens[b, :upto], cpu_tokens[b, :upto])
    lang_margin = res["cpu"][3].topk(2, dim=-1).values
    lang_close = (lang_margin[:, 0] - lang_margin[:, 1]) < 1e-2
    lang_same = bool(((res["cuda"][2] == res["cpu"][2]) | lang_close).all())
    check(held, "phase 23e tiny greedy tokens differ card vs CPU before the CPU's first top-2 "
          "margin below 1e-2")
    check(logit_cos >= 0.9999, f"phase 23e teacher-forced logits card vs CPU cos {logit_cos:.6f}")
    check(lang_same, f"phase 23e detect_language card {res['cuda'][2].tolist()} CPU "
          f"{res['cpu'][2].tolist()} (margins {lang_margin.tolist()})")
    line_e = (f"e. whisper-tiny bf16 card vs CPU, {len(chunks)} chunks: greedy tokens equal "
              f"{float((card_tokens == cpu_tokens).float().mean()):.4f} of positions, held up to "
              f"the first margin < 1e-2 ({compared} positions compared), teacher-forced logits "
              f"cos {logit_cos:.6f}, detect_language card {res['cuda'][2].tolist()} CPU "
              f"{res['cpu'][2].tolist()} ({int(lang_close.sum())} rows within 1e-2); "
              f"{time.perf_counter() - t_e:.1f} s")
    del cpu_model, card_model
    torch.cuda.empty_cache()
    say(f"[23 transcription] large-v3-turbo, seeded weights, one build {build_s:.2f} s | {line_a} "
        f"| {line_b} | {line_c} | {line_d} | {line_e}; launches {launched}; phase "
        f"{time.perf_counter() - t_phase:.1f} s | {smi}")
    return launched


# phase 24a: the JAX quant test's bounds against the f32 encoder
# (tests/test_quant_encoder.py:42,49)
QUANT_REL_MAX, QUANT_COS_MIN = 0.08, 0.99


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def layer_outputs(encoder, mel) -> tuple:
    """(the encoder's output, every block's output) as f32, by forward hooks."""
    outs = []
    hooks = [b.register_forward_hook(lambda m, i, o: outs.append(o.float()))
             for b in encoder.blocks]
    with torch.no_grad():
        final = encoder(mel).float()
    for h in hooks:
        h.remove()
    return final, outs


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def pooled_cos(got: torch.Tensor, want: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(got.mean(1), want.mean(1), dim=-1).min().item()


def quant_int8_phase(tmp: str, dev, reset_counts, counts, smi: str) -> dict:
    """24. On phase 21's audio project: a. ``extract --batched --kinds x_concat
    --batch-size 32 --quant-int8`` at large-v3-turbo beside the bf16 route
    (chunks/s less each command's build, the per-song cosine of the two),
    the int8 encoder's relative hidden error and pooled cosine against the
    f32 encoder on one 4-chunk batch (with each block's, and the bf16
    encoder's for scale), the CLI's int8 weights and scales on the card
    against the CPU's quantisation, and ``torch._int_mm`` on the weight's
    two layouts beside the bf16 product at fc1's shape; b. whisper-tiny
    ``--quant-int8`` card against CPU on the first 4 versions; c. ``extract
    --batched --profile`` of 8 versions (the bf16 route, with the model of
    a. so that the trace holds the extraction alone): the trace's K1/K2/K3
    and the device's busy share of the command and of its batches; d.
    ``doctor`` and a one-rank NCCL group: the mesh train step on phase 15's
    project against the plain step. Returns the launches of the int8
    command."""
    import torch.distributed as dist

    from wealy_tpu_torch.audio.decode import load_audio
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.cli import extract_batched
    from wealy_tpu_torch.data.chunking import collate_fixed_length
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.losses import get_loss
    from wealy_tpu_torch.models.registry import build_model
    from wealy_tpu_torch.models.whisper import model as wmodel
    from wealy_tpu_torch.models.whisper import quant as wquant
    from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wealy_tpu_torch.models.whisper.extract import chunk_waveform
    from wealy_tpu_torch.ops.flash_attention import _reference_mha
    from wealy_tpu_torch.parallel.mesh import make_mesh
    from wealy_tpu_torch.parallel.multihost import initialize_multihost
    from wealy_tpu_torch.train.config import Config
    from wealy_tpu_torch.train.loop import batch_to_device
    from wealy_tpu_torch.train.state import create_train_state, make_optimizer
    from wealy_tpu_torch.train.step import make_train_step
    from wealy_tpu_torch.utils.profiling import trace_device_busy, trace_files

    t_phase = time.perf_counter()
    lc, data = os.path.join(tmp, "lc"), os.path.join(tmp, "data")

    def conf(name, size="large-v3-turbo"):
        return write_config(os.path.join(tmp, f"q_{name}.json"), lc,
                            os.path.join(tmp, f"hs_q_{name}"), os.path.join(tmp, f"cache_q_{name}"),
                            whisper_size=size, data_root=data)

    # a. int8 and bf16 over the split; each command's build timed where its
    # factory makes it, and its model kept for the checks below
    builds, kept = {}, {}

    def timed(name, load):
        def wrapped(*args, **kw):
            t = time.perf_counter()
            out = load(*args, **kw)
            torch.cuda.synchronize()
            builds[name], kept[name] = time.perf_counter() - t, out
            return out
        return wrapped

    base = ["extract", "--split", "test", "--batched", "--kinds", "x_concat", "--batch-size", "32"]
    with mock.patch.object(wquant, "load_quant_encoder", timed("int8", wquant.load_quant_encoder)), \
            mock.patch.object(extract_batched, "load_whisper_model",
                              timed("bf16", extract_batched.load_whisper_model)):
        reset_counts()
        q_out, q_s = run_cli(base + ["--config", conf("int8"), "--quant-int8"])
        launched = counts()
        b_out, b_s = run_cli(base + ["--config", conf("bf16")])
    n_chunks = q_out["throughput"]["total_items"]
    rate = {"int8": n_chunks / (q_s - builds["int8"]), "bf16": n_chunks / (b_s - builds["bf16"])}
    check(q_out["done"] == b_out["done"] == len(SPLIT_AUDIO) and not q_out["incomplete"],
          f"phase 24a int8 {q_out} bf16 {b_out}")
    check(launched["log_mel"] > 0 and launched["flash_mha"] > 0 and launched["fused_mlp"] == 0,
          f"phase 24a int8 command launches {launched} (K1, K2 above 0, K3 at 0)")
    stores = {w: EmbeddingStore(os.path.join(tmp, f"hs_q_{w}"), "lyric-covers")
              for w in ("int8", "bf16")}
    versions = [str(2100 + i) for i in range(len(SPLIT_AUDIO))]
    song_cos = [min_row_cos(*(torch.from_numpy(stores[w].load(v, "x_concat.npz")["embeddings"])
                              for w in ("int8", "bf16"))) for v in versions]

    cfg = WHISPER_CONFIGS["large-v3-turbo"]
    t = time.perf_counter()
    sd = wquant.f32_encoder_state_dict("large-v3-turbo")
    qtree = wquant.quantize_encoder_state_dict(sd, cfg)
    cpu_quant_s = time.perf_counter() - t
    qenc = kept["int8"]
    same_codes = all(
        torch.equal(getattr(blk, n).weight.cpu(), torch.from_numpy(qtree["layers"][i][n]["w"]))
        and torch.equal(getattr(blk, n).scale.cpu(), torch.from_numpy(qtree["layers"][i][n]["s"]))
        for i, blk in enumerate(qenc.blocks) for n, _, _ in wquant.DENSE)
    check(same_codes, "phase 24a int8 weights or scales on the card differ from the CPU's")

    # one 4-chunk batch of the split's audio: int8 and bf16 against the f32
    # encoder (plain f32 attention, TF32 off)
    chunks = torch.cat([torch.from_numpy(chunk_waveform(load_audio(os.path.join(
        data, "LyricCovers", "audio", v, f"{v}_audio.mp3")))) for v in ("2103", "2101")])[:4]
    mel = log_mel_spectrogram_fused(chunks.float().to(dev), n_mels=cfg.n_mels)
    f32 = wmodel.WhisperEncoder(cfg, dtype=torch.float32, device=dev)
    f32.load_state_dict({k.removeprefix("encoder."): v for k, v in sd.items()})
    with mock.patch.object(wmodel, "flash_mha", _reference_mha):
        want, want_layers = layer_outputs(f32, mel)
    got, got_layers = layer_outputs(qenc, mel)
    bf16_model, _ = kept["bf16"]
    bf, bf_layers = layer_outputs(bf16_model.encoder, mel)
    del f32, sd, qtree
    q_rel, q_cos = rel_err(got, want), pooled_cos(got, want)
    b_rel, b_cos = rel_err(bf, want), pooled_cos(bf, want)
    q_layers = [rel_err(g, w) for g, w in zip(got_layers, want_layers)]
    b_layers = [rel_err(g, w) for g, w in zip(bf_layers, want_layers)]
    check(q_rel < QUANT_REL_MAX and q_cos > QUANT_COS_MIN,
          f"phase 24a int8 vs f32 relative error {q_rel:.4f} (< {QUANT_REL_MAX}), pooled cos "
          f"{q_cos:.6f} (> {QUANT_COS_MIN}); by block {[round(x, 4) for x in q_layers]}")

    # the int8 product on the weight's two layouts beside the bf16 product, at fc1's shape
    a = torch.randint(-127, 128, (32 * 1500, cfg.n_audio_state), dtype=torch.int8, device=dev)
    w = torch.randint(-127, 128, (4 * cfg.n_audio_state, cfg.n_audio_state), dtype=torch.int8,
                      device=dev)
    w_kn = w.t().contiguous()
    ab, wb = a.bfloat16(), w.bfloat16()
    mm = {"int8 (out, in).t()": cuda_ms(lambda: torch._int_mm(a, w.t()), 20),
          "int8 (in, out) contiguous": cuda_ms(lambda: torch._int_mm(a, w_kn), 20),
          "bf16": cuda_ms(lambda: ab @ wb.t(), 20)}
    del a, w, w_kn, ab, wb
    line_a = (f"a. large-v3-turbo x_concat B=32 over {len(versions)} versions ({n_chunks} "
              f"chunks): int8 {q_s:.2f} s wall, build {builds['int8']:.2f} s, "
              f"{rate['int8']:.2f} chunks/s less it (meter {q_out['throughput']['items_per_sec']})"
              f"; bf16 {b_s:.2f} s, build {builds['bf16']:.2f} s, {rate['bf16']:.2f} chunks/s "
              f"(meter {b_out['throughput']['items_per_sec']}); int8 / bf16 "
              f"{rate['int8'] / rate['bf16']:.3f}; per-song cos int8 vs bf16 min "
              f"{min(song_cos):.6f} mean {float(np.mean(song_cos)):.6f}; CPU quantisation "
              f"{cpu_quant_s:.2f} s, card == CPU codes and scales {same_codes}; 4 chunks vs f32: "
              f"int8 rel {q_rel:.4f} pooled cos {q_cos:.6f}, bf16 rel {b_rel:.4f} pooled cos "
              f"{b_cos:.6f}; by block (int8 | bf16) "
              f"{[round(x, 4) for x in q_layers[3::4]]} | {[round(x, 4) for x in b_layers[3::4]]}"
              f"; _int_mm at ({32 * 1500}, {cfg.n_audio_state}) x ({cfg.n_audio_state}, "
              f"{4 * cfg.n_audio_state}) ms {({k: round(v, 4) for k, v in mm.items()})}")
    del qenc, bf16_model, kept["int8"]
    torch.cuda.empty_cache()

    # b. whisper-tiny int8, card against CPU, the first 4 versions
    t = time.perf_counter()
    tiny = {}
    for where in ("cuda", "cpu"):
        run_cli(["extract", "--config", conf(f"tiny_{where}", "tiny"), "--split", "test",
                 "--batched", "--kinds", "x_concat", "--quant-int8", "--limit", "4",
                 "--batch-size", "6", "--device", where])
        tiny[where] = EmbeddingStore(os.path.join(tmp, f"hs_q_tiny_{where}"), "lyric-covers")
    tiny_cos = min(min_row_cos(*(torch.from_numpy(tiny[w].load(v, "x_concat.npz")["embeddings"])
                                 for w in ("cuda", "cpu"))) for v in versions[:4])
    check(tiny_cos >= 0.999, f"phase 24b tiny int8 card vs CPU cos {tiny_cos:.6f}")
    line_b = f"b. tiny int8 card vs CPU cos {tiny_cos:.6f} ({time.perf_counter() - t:.1f} s)"

    # c. --profile of the bf16 route over 8 versions, with a.'s model
    trace_dir = os.path.join(tmp, "trace")
    model = extract_batched.load_whisper_model("large-v3-turbo", device=dev)
    with mock.patch.object(extract_batched, "load_whisper_model", lambda *a, **k: model):
        p_out, p_s = run_cli(["extract", "--config", conf("profile"), "--split", "test",
                              "--batched", "--kinds", "x_concat", "--batch-size", "8",
                              "--limit", "8", "--profile", trace_dir])
    del model
    files = trace_files(trace_dir)
    check(len(files) == 1, f"phase 24c trace files {files}")
    whole = trace_device_busy(files[0], span="wealy_tpu_torch.extract")
    batches = trace_device_busy(files[0], span="extract.batch")
    names = " ".join(whole["by_name"])
    held = {k: k in names for k in ("log_mel_kernel", "flash_fwd_kernel", "mlp_gemm_kernel")}
    check(held["log_mel_kernel"] and held["flash_fwd_kernel"] and p_out["done"] == 8,
          f"phase 24c trace kernels {held}, extract {p_out}")
    top = sorted(whole["by_name"].items(), key=lambda kv: -kv[1][0])[:4]
    line_c = (f"c. --profile, 8 versions ({p_out['throughput']['total_items']} chunks, B=8) "
              f"{p_s:.2f} s: trace {files[0].stat().st_size / 1e6:.1f} MB holds {held}; device "
              f"busy {whole['busy_ms']:.2f} of {whole['window_ms']:.2f} ms of the command "
              f"({100 * whole['busy_share']:.1f}%), {batches['busy_ms']:.2f} of "
              f"{batches['window_ms']:.2f} ms from the first batch to the last "
              f"({100 * batches['busy_share']:.1f}%); top "
              f"{[(n[:40], round(v[0], 2), v[1]) for n, v in top]}")

    # d. doctor; a one-rank NCCL group: the mesh step on phase 15's project
    # against the plain step, deterministic algorithms on for both
    t = time.perf_counter()
    rep, doc_s = run_cli(["doctor", "--backend-timeout", "120"])
    check(rep["ok"] and rep["backend"]["default_device"] == "cuda:0"
          and rep["backend"]["dispatch"] == 8.0, f"phase 24d doctor {rep['backend']}")
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", timeout_s=120)
    mesh = make_mesh(device="cuda")
    with tempfile.TemporaryDirectory(prefix="wealy_dp_") as ptmp:
        cpath, _ = write_project(ptmp, dev, train_cliques=16, val_cliques=4)
        ds = EmbeddingDataset(Config.from_file(cpath), "train", seed=0)
        host_batches = []
        for _, brng, items in ds.sampler.epoch_batches(0, 16, 0):
            host_batches.append(batch_to_device(collate_fixed_length(
                items, chunk_size=1000, use_random_chunks=True, rng=brng)))
            if len(host_batches) == 2:
                break
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {}
    for name, on in (("plain", None), ("mesh", mesh)):
        model, _ = build_model("whisper", zdim=512, in_features=1280)
        state = create_train_state(model.to(dev), tx=make_optimizer(lr=1e-3, warmup_steps=1,
                                                                     max_steps=20), seed=0)
        step = make_train_step(None, get_loss("clews"), mesh=on)
        losses = []
        for hb in host_batches:
            feed = hb if on is not None else {k: v.to(dev) for k, v in hb.items()}
            state, ld = step(state, feed)
            losses.append(ld["loss"].item())
        runs[name] = (losses, {k: v.clone() for k, v in state.params.items()})
    torch.use_deterministic_algorithms(False)
    dist.destroy_process_group()
    bit_equal = runs["plain"][0] == runs["mesh"][0] and all(
        torch.equal(runs["plain"][1][k], runs["mesh"][1][k]) for k in runs["plain"][1])
    worst = max((runs["plain"][1][k] - runs["mesh"][1][k]).abs().max().item()
                for k in runs["plain"][1])
    close = np.allclose(runs["plain"][0], runs["mesh"][0], rtol=1e-5) and all(
        torch.allclose(runs["mesh"][1][k], v, rtol=1e-5, atol=1e-7)
        for k, v in runs["plain"][1].items())
    check(close, f"phase 24d one-rank NCCL mesh step vs plain: losses {runs}, max |d| {worst}")
    line_d = (f"d. doctor ok on {rep['backend']['default_device']} ({rep['backend']['names']}, "
              f"{doc_s:.1f} s); one-rank NCCL mesh step vs plain, 2 steps on phase 15's project: "
              f"{'bit-equal' if bit_equal else 'max |d| %.3g' % worst}, losses "
              f"{runs['mesh'][0]} ({time.perf_counter() - t:.1f} s)")
    say(f"[24 int8 encoder, --profile, doctor, NCCL] {line_a} | {line_b} | {line_c} | {line_d}; "
        f"launches of the int8 command {launched}; phase {time.perf_counter() - t_phase:.1f} s "
        f"| {smi}")
    return launched
# phase 25: the parallel paths at two ranks on the one card (gloo, host-staged:
# NCCL refuses two ranks on one device)
P25_RANKS = 2
P25_VERSIONS = 16  # the first versions of phase 21's split that `extract --tp 2` runs
P25_BATCH = 8  # the decode, encoder and fine-tune batch (30 s mel clips)
P25_RING = (2, 1500, 20, 64)  # ring attention's f32 q/k/v: a turbo layer's shape
P25_RANKING = (1024, 8, 64)  # the sharded ranking's chunk sets: songs, chunks, width
P25_SERVE = (4096, 8, 512)  # the `query --shard` index: songs, chunks, zdim
P25_DEADLINE_S = 900
# the ranks' device and Whisper size (a rehearsal on the CPU sets "cpu" and "dev")
P25_DEVICE, P25_SIZE = "cuda", "large-v3-turbo"
# 0. which operations gloo takes on the card's tensors directly, each in a
# pair of processes of its own (an operation it refuses can abort its process)
GLOO_OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "send_recv",
            "batch_isend_irecv")
GLOO_PROBE = r"""
import datetime, sys, torch, torch.distributed as dist
r, port, op, device = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port, world_size=2, rank=r,
                        timeout=datetime.timedelta(seconds=60))
x = torch.full((4,), float(r + 1), device=device)
if op == "all_reduce":
    dist.all_reduce(x)
elif op == "broadcast":
    dist.broadcast(x, src=0)
elif op == "all_gather":
    dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
elif op == "reduce_scatter":
    dist.reduce_scatter_tensor(torch.empty(2, device=device), x)
elif op == "send_recv":
    dist.send(x, 1) if r == 0 else dist.recv(x, 0)
else:
    for q in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - r),
                                     dist.P2POp(dist.irecv, torch.empty_like(x), 1 - r)]):
        q.wait()
torch.cuda.synchronize() if device == "cuda" else None
print("ok", flush=True)
dist.destroy_process_group()
"""


def parallel_inputs(tmp: str) -> str:
    """Phase 25's inputs in ``<tmp>/p25``: the commands' configs and
    arguments, the batches and arrays every rank and the one-process
    references read, all from seeds on the host. Returns the directory."""
    from wealy_tpu_torch.audio.mel import log_mel_spectrogram
    from wealy_tpu_torch.models.whisper.config import WHISPER_CONFIGS

    work = os.path.join(tmp, "p25")
    os.makedirs(work)
    lc, data = os.path.join(tmp, "lc"), os.path.join(tmp, "data")
    tp_conf = write_config(os.path.join(work, "turbo_tp.json"), lc, os.path.join(work, "hs_tp"),
                           os.path.join(work, "cache_tp"), chunk_size=224, overlap=0.5,
                           whisper_size=P25_SIZE, data_root=data)
    gen = torch.Generator().manual_seed(25)
    batch = mel_batch(P25_BATCH, WHISPER_CONFIGS[P25_SIZE].n_mels,
                      torch.Generator().manual_seed(14), "cpu")
    audio = 0.1 * torch.randn(4, 480000, generator=gen)
    rng = np.random.default_rng(25)
    n, smax, c = P25_RANKING
    labels = np.arange(n) // 4
    sets = (rng.normal(size=(n // 4 + 1, 1, c))[labels] + rng.normal(size=(n, smax, c))).astype(
        np.float32)
    mask = np.ones((n, smax), bool)
    mask[:, smax // 2:] = rng.random((n, smax - smax // 2)) < 0.7
    n_s, smax_s, z_s = P25_SERVE
    serve_root = os.path.join(work, "serve")
    os.makedirs(serve_root)
    index = os.path.join(serve_root, "idx.npz")
    write_index(index, rng.normal(size=(n_s, smax_s, z_s)).astype(np.float16),
                rng.random((n_s, smax_s)) < 0.8, np.arange(n_s) // 4, emb_dim=1280,
                chunk_size=1000, overlap=0.9)
    queries = []
    for i in range(4):
        q = os.path.join(serve_root, f"q{i}.npz")
        np.savez(q, embeddings=rng.normal(size=(1500, 1280)).astype(np.float32))
        queries.append(q)
    torch.save({
        "extract": ["extract", "--config", tp_conf, "--split", "test", "--batched", "--tp",
                    str(P25_RANKS), "--kinds", "hs_last_seq", "--batch-size", "16", "--limit",
                    str(P25_VERSIONS), "--device", P25_DEVICE],
        "query": ["query", "--config", serving_config(serve_root), "--index", index,
                  "--query-embeddings", *queries, "--k", "10", "--block-size", "512",
                  "--device", P25_DEVICE],
        # f32 at T 200 (below K2's 256-step gate: K2 takes bf16 only), bf16 at T 1500
        "batch": batch, "mel_tiny": log_mel_spectrogram(audio, 80),
        "ring": tuple(torch.randn(*P25_RING, generator=gen) for _ in range(3)),
        "ranking": (sets, mask, labels),
    }, os.path.join(work, "inputs.pt"))
    return work


def parallel_rank(rank: int, ports: list, work: str) -> int:
    """One of phase 25's two ranks (``python3 chip_smoke.py --parallel-rank
    RANK PORTS DIR``): a. ``extract --batched --tp 2`` through the CLI, the
    TP and SP encoder and the TP decode on phase 25's batch, and two TP
    fine-tune steps; b. the GPipe encoder, ring attention, the sharded
    ranking (K4) and ``query --shard`` (K4). Writes ``DIR/rank<r>.pt``;
    exits nonzero on a failed check."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.losses import clews_loss
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_
    from wealy_tpu_torch.models.whisper import model as wmodel
    from wealy_tpu_torch.models.whisper.generate import (
        decode_cross_kv,
        default_prompt,
        init_kv_caches,
    )
    from wealy_tpu_torch.parallel.mesh import make_mesh
    from wealy_tpu_torch.parallel.multihost import initialize_multihost
    from wealy_tpu_torch.parallel.pp import make_pp_mesh, pp_encode_fn
    from wealy_tpu_torch.parallel.ring import make_cp_mesh, ring_attention
    from wealy_tpu_torch.parallel.similarity import streaming_relevant_ranks
    from wealy_tpu_torch.parallel.tp import make_tp_mesh, tp_decode_fn, tp_encode_fn, tp_module
    from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
    from wealy_tpu_torch.train.state import TrainState, make_optimizer
    from wealy_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(P25_RANKS), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(P25_RANKS), MASTER_ADDR="127.0.0.1")
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    reset_counts, counts = launch_counters()
    shapes = {"flash_mha": set(), "fused_mlp": set()}
    real_attn, real_mlp = wmodel.flash_mha, wmodel.fused_mlp

    def attn(q, k, v, scale):
        shapes["flash_mha"].add(tuple(q.shape))
        return real_attn(q, k, v, scale)

    def mlp(x, w1, b1, w2, b2):
        shapes["fused_mlp"].add((tuple(x.shape), tuple(w1.shape), tuple(w2.shape)))
        return real_mlp(x, w1, b1, w2, b2)

    wmodel.flash_mha, wmodel.fused_mlp = attn, mlp
    res, times = {}, {}
    reset_counts()

    # a. the user's command: two ranks split one large-v3-turbo
    os.environ["MASTER_PORT"] = str(ports[0])
    t = time.perf_counter()
    res["extract"] = run_cli_lines(inp["extract"])[0]
    times["extract"] = time.perf_counter() - t

    os.environ["MASTER_PORT"] = str(ports[1])
    initialize_multihost(timeout_s=600)
    mesh = make_tp_mesh(P25_RANKS, device=P25_DEVICE)
    full, cfg = load_whisper_model(P25_SIZE, seed=0, device="cpu")
    mel = inp["batch"]["emb"]
    for name, sp in (("tp_states", False), ("sp_states", True)):
        t = time.perf_counter()
        with torch.inference_mode():
            res[name] = tp_encode_fn(full, mesh, sequence_parallel=sp)(mel).cpu()
        times[name] = time.perf_counter() - t
    t = time.perf_counter()
    decode = tp_decode_fn(full, mesh, cfg, default_prompt(cfg), max_len=224)
    out = decode(mel)
    res["decode"] = {k: out[k].cpu() for k in ("tokens", "hidden", "lengths")}
    times["decode"] = time.perf_counter() - t
    # the TP decoder teacher-forced on the one-process route's tokens: its
    # log-probabilities at every position (rank 0 writes them; every rank's are equal)
    tp_model = decode.module
    with torch.inference_mode():
        states = tp_model.encode(mel.to(mesh.device))
        caches = init_kv_caches(cfg, P25_BATCH, 224, dtype=tp_model.dtype, device=mesh.device,
                                n_head=tp_model.decoder.blocks[0].attn.n_head)
        _, logits, _ = tp_model.decode(inp["one_tokens"].to(mesh.device), None,
                                       kv_caches=caches, cache_index=0,
                                       xa_kv=decode_cross_kv(tp_model, states))
        if rank == 0:
            torch.save(torch.log_softmax(logits.float(), -1).cpu(),
                       os.path.join(work, "tp_logp.pt"))
    del decode, tp_model, states, caches, logits
    head = seeded_init_(ProjectionHead(cfg.n_audio_state, zdim=512), seed=1).to(mesh.device)
    state = TrainState(EncoderHead(tp_module(full.encoder, mesh), head),
                       make_optimizer(lr=1e-5, warmup_steps=1, max_steps=1000))
    del full
    step = make_train_step(None, clews_loss, mesh=mesh, model_call=encoder_head_call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    losses = []
    for _ in range(2):
        state, ld = step(state, inp["batch"])
        losses.append(float(ld["loss"]))
    times["finetune"] = time.perf_counter() - t
    res["finetune"] = {"losses": losses, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, step, head
    torch.cuda.empty_cache()

    # b. GPipe over 2 stages (whisper-tiny, f32), ring attention (f32), the
    # sharded chunk-set ranking
    pp_mesh = make_pp_mesh(P25_RANKS, device=P25_DEVICE)
    t = time.perf_counter()
    with torch.no_grad():
        for name, dtype, frames in (("pp", torch.float32, 400), ("pp16", torch.bfloat16, 3000)):
            tiny, _ = load_whisper_model("tiny", seed=0, device=P25_DEVICE, dtype=dtype)
            res[name] = pp_encode_fn(tiny.encoder, pp_mesh, n_micro=2)(
                inp["mel_tiny"][..., :frames]).float().cpu()
        times["pp"] = time.perf_counter() - t
        t = time.perf_counter()
        res["ring"] = ring_attention(*inp["ring"], P25_RING[3] ** -0.5,
                                     make_cp_mesh(P25_RANKS, device=P25_DEVICE)).cpu()
        times["ring"] = time.perf_counter() - t
    sets, mask, labels = inp["ranking"]
    t = time.perf_counter()
    res["ranks"] = streaming_relevant_ranks(sets, sets, labels, labels, mode="cos",
                                            redux="bpwr", query_mask=mask, corpus_mask=mask,
                                            block_size=256, query_block=256,
                                            mesh=make_mesh(device=P25_DEVICE))
    times["ranking"] = time.perf_counter() - t
    dist.barrier()
    dist.destroy_process_group()

    # `query --shard`: each rank holds half the index on the card
    os.environ["MASTER_PORT"] = str(ports[2])
    t = time.perf_counter()
    res["query"] = run_cli_lines(inp["query"] + ["--shard"])[0]
    times["query"] = time.perf_counter() - t
    res["launches"] = counts()
    res["shapes"] = {k: sorted(v) for k, v in shapes.items()}
    res["times"] = times
    res["failures"] = list(FAILURES)
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))
    return 1 if FAILURES else 0


def gloo_probe(deadline_s: float = 120.0) -> dict:
    """Operation -> "takes" when both processes of its pair ran it on
    ``P25_DEVICE`` tensors, else "refuses" with their exit codes."""
    pairs = []
    for op in GLOO_OPS:
        port = str(free_port())
        pairs.append((op, [subprocess.Popen([sys.executable, "-c", GLOO_PROBE, str(r), port, op,
                                             P25_DEVICE], stdout=subprocess.PIPE,
                                            stderr=subprocess.DEVNULL, text=True)
                           for r in range(2)]))
    t = time.perf_counter()
    procs = [p for _, pair in pairs for p in pair]
    while time.perf_counter() - t < deadline_s and any(p.poll() is None for p in procs):
        time.sleep(0.2)
    out = {}
    for op, pair in pairs:
        for p in pair:
            if p.poll() is None:
                p.kill()
            p.wait()
        said = [p.stdout.read().strip() for p in pair]
        rcs = [p.returncode for p in pair]
        out[op] = "takes" if said == ["ok", "ok"] else f"refuses (exit {rcs})"
    return out


def run_ranks(work: str, ports: str) -> float:
    """Phase 25's ranks as processes, under one deadline (a rank past it is
    killed and fails the phase); their output in ``work/rank<r>.log``.
    Returns the wall seconds."""
    t = time.perf_counter()
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(P25_RANKS)]
    # the host's cores shared by the ranks: oversubscribed OpenMP teams spin
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // P25_RANKS)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), ports, work], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(P25_RANKS)]
    while time.perf_counter() - t < P25_DEADLINE_S and any(p.poll() is None for p in procs):
        time.sleep(0.5)
    for p, f in zip(procs, logs):
        if p.poll() is None:
            p.kill()
        p.wait()
        f.close()
    for r, p in enumerate(procs):
        tail = open(os.path.join(work, f"rank{r}.log")).read()[-4000:]
        check(p.returncode == 0, f"phase 25 rank {r} exit {p.returncode}:\n{tail}")
    return time.perf_counter() - t


def parallel_phase(tmp: str, dev, smi: str) -> dict:
    """25. Tensor, sequence and pipeline parallelism, ring attention and the
    sharded ranking and serving at two ranks on the one card: after a probe
    of which operations gloo takes on the card's tensors (:func:`gloo_probe`),
    two processes over gloo (NCCL refuses two ranks on one device), every
    operation staged through the host, run :func:`parallel_rank`, each result held
    against the one-process route, computed here first on the same seeds:
    the TP decode's tokens up to the first step whose one-process top-2
    margin is below 1e-2 or below twice the two routes' teacher-forced
    log-probability gap there (a bf16 route rounded another way can flip
    only such a choice), and the hidden rows of that prefix; the
    teacher-forced log-probabilities (row cosine >= 0.999); the TP extract's
    stored prompt rows against phase 21's store; the TP and SP encoder
    states (row cosine >= 0.999); the TP fine-tune losses (bf16 tolerance
    0.05); the GPipe encoder (f32 1e-4, bf16 row cosine >= 0.999) and the
    ring (f32 1e-4); the ranks and MAP; ``query --shard``'s rankings; and
    c. ``graft_entry.entry()``'s forward on the card against its CPU run
    (row cosine >= 0.9999). Returns the ranks' summed launches and c's."""
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.losses import clews_loss
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_
    from wealy_tpu_torch.models.whisper import generate as wgen
    from wealy_tpu_torch.parallel.similarity import map_from_ranks, streaming_relevant_ranks
    from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
    from wealy_tpu_torch.train.state import create_train_state, make_optimizer
    from wealy_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    gloo = gloo_probe()
    work = parallel_inputs(tmp)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)

    # the one-process route on this card, the same seeds
    t_ref = time.perf_counter()
    model, cfg = load_whisper_model(P25_SIZE, seed=0, device=dev)
    mel = inp["batch"]["emb"].to(dev)
    prompt = wgen.default_prompt(cfg)
    with torch.inference_mode():
        states = model.encode(mel)
        one = wgen.greedy_decode(model, states, cfg, prompt, max_len=224)
        caches = wgen.init_kv_caches(cfg, P25_BATCH, 224, dtype=model.dtype, device=dev)
        _, logits, _ = model.decode(one["tokens"], None, kv_caches=caches, cache_index=0,
                                    xa_kv=wgen.decode_cross_kv(model, states))
        logp = torch.log_softmax(logits.float(), -1).cpu()
    del logits, caches
    states = states.float().cpu()
    tokens, hidden, lengths = (one[k].cpu() for k in ("tokens", "hidden", "lengths"))
    inp["one_tokens"] = tokens
    torch.save(inp, os.path.join(work, "inputs.pt"))
    head = seeded_init_(ProjectionHead(cfg.n_audio_state, zdim=512), seed=1).to(dev)
    state = create_train_state(EncoderHead(model.encoder, head),
                               make_optimizer(lr=1e-5, warmup_steps=1, max_steps=1000),
                               init=False)
    del model
    step = make_train_step(None, clews_loss, model_call=encoder_head_call)
    batch = {k: v.to(dev) for k, v in inp["batch"].items()}
    plain = []
    for _ in range(2):
        state, ld = step(state, batch)
        plain.append(float(ld["loss"]))
    del state, step, batch, head
    tiny, _ = load_whisper_model("tiny", seed=0, device=dev, dtype=torch.float32)
    tiny16, _ = load_whisper_model("tiny", seed=0, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        pp_want = tiny.encoder(inp["mel_tiny"][..., :400].to(dev)).cpu()
        pp16_want = tiny16.encoder(inp["mel_tiny"].to(dev)).float().cpu()
        q, k, v = (x.to(dev) for x in inp["ring"])
        p_ = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * P25_RING[3] ** -0.5, -1)
        ring_want = torch.einsum("bhqk,bkhd->bqhd", p_, v).cpu()
    del tiny, tiny16, q, k, v, p_
    sets, mask, labels = inp["ranking"]
    want_ranks, n_rel = streaming_relevant_ranks(sets, sets, labels, labels, mode="cos",
                                                 redux="bpwr", query_mask=mask, corpus_mask=mask,
                                                 block_size=256, query_block=256, device=dev)
    single, _ = run_cli_lines(inp["query"])
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_ref

    ranks_s = run_ranks(work, ",".join(str(free_port()) for _ in range(3)))
    if not all(os.path.exists(os.path.join(work, f"rank{r}.pt")) for r in range(P25_RANKS)):
        return {}
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(P25_RANKS)]
    launched = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}

    # a. the TP decode: tokens up to the first choice a rounding could flip
    tp_logp = torch.load(os.path.join(work, "tp_logp.pt"))
    top2 = logp.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # margin[b, j]: the choice of token j + 1
    gap = (tp_logp - logp).abs().amax(-1)  # the two routes' log-probability gap at j
    lp_cos = min(min_row_cos(tp_logp[b, : int(n) - 1], logp[b, : int(n) - 1])
                 for b, n in enumerate(lengths))
    held = strict = True
    compared, compared_strict, hcos = 0, 0, 1.0
    for r in res:
        got = r["decode"]
        for b in range(P25_BATCH):
            L = min(int(lengths[b]), 223)
            js = range(len(prompt) - 1, L)
            upto = min([j + 1 for j in js if margin[b, j] < max(1e-2, 2 * float(gap[b, j]))],
                       default=L)
            upto_strict = min([j + 1 for j in js if margin[b, j] < 1e-2], default=L)
            held &= torch.equal(got["tokens"][b, :upto], tokens[b, :upto])
            strict &= torch.equal(got["tokens"][b, :upto_strict], tokens[b, :upto_strict])
            compared += upto - len(prompt)
            compared_strict += upto_strict - len(prompt)
            hcos = min(hcos, min_row_cos(got["hidden"][b, :upto].float(),
                                         hidden[b, :upto].float()))
    flat = states.reshape(-1, states.shape[-1])
    enc = {name: (min(min_row_cos(r[name].float().reshape(flat.shape), flat) for r in res),
                  max(rel_err(r[name].float(), states) for r in res))
           for name in ("tp_states", "sp_states")}
    check(held, "phase 25a TP decode tokens differ from the one-process route before a choice "
          "whose margin is below 1e-2 or twice the routes' teacher-forced gap")
    check(hcos >= 0.999 and lp_cos >= 0.999, f"phase 25a TP decode hidden rows cos {hcos:.6f} "
          f"on the equal prefix, teacher-forced log-probabilities cos {lp_cos:.6f}")
    check(all(c >= 0.999 for c, _ in enc.values()), f"phase 25 TP / SP encoder states {enc}")
    ft = [r["finetune"]["losses"] for r in res]
    check(all(np.allclose(f, plain, rtol=0.05, atol=0.05) for f in ft),
          f"phase 25a TP fine-tune losses {ft} vs plain {plain}")

    # the extract command's stored rows against phase 21's one-process store
    tp_store = EmbeddingStore(os.path.join(work, "hs_tp"), "lyric-covers")
    one_store = EmbeddingStore(os.path.join(tmp, "hs"), "lyric-covers")
    out = res[0]["extract"][-1] if res[0]["extract"] else {}
    check(out.get("done") == P25_VERSIONS and out.get("incomplete") == []
          and res[1]["extract"] == [], f"phase 25a extract --tp {out} (rank 1 printed "
          f"{res[1]['extract']})")
    vids = sorted(os.listdir(os.path.join(work, "hs_tp")))
    head_cos, share = 1.0, []
    for vid in vids:
        a, b = (torch.from_numpy(st.load(vid, "hs_last_seq.npz")["embeddings"].astype(
            np.float32)) for st in (tp_store, one_store))
        head_cos = min(head_cos, min_row_cos(a[: len(prompt)], b[: len(prompt)]))
        n = min(len(a), len(b))
        share.append(float((F.cosine_similarity(a[:n], b[:n], dim=-1) >= 0.999).float().mean()))
    check(len(vids) == P25_VERSIONS and head_cos >= 0.999,
          f"phase 25a extract --tp: {len(vids)} versions stored, prompt rows cos {head_cos:.6f}")

    # b. PP and the ring against their plain versions, the ranking, `query --shard`
    pp_err = max(float((r["pp"] - pp_want).abs().max()) for r in res)
    pp16_cos = min(min_row_cos(r["pp16"].reshape(-1, pp16_want.shape[-1]),
                               pp16_want.reshape(-1, pp16_want.shape[-1])) for r in res)
    ring_err = max(float((r["ring"] - ring_want).abs().max()) for r in res)
    check(pp_err < 1e-4 and ring_err < 1e-4, f"phase 25b PP max err {pp_err:.3g}, ring "
          f"{ring_err:.3g} (f32 gate 1e-4)")
    check(pp16_cos >= 0.999, f"phase 25b bf16 PP (K2, K3) row cos {pp16_cos:.6f}")
    ranks_equal = all(np.array_equal(r["ranks"][0], want_ranks) for r in res)
    got_map, want_map = map_from_ranks(res[0]["ranks"][0], n_rel), map_from_ranks(want_ranks,
                                                                                  n_rel)
    check(ranks_equal and got_map == want_map, f"phase 25b sharded ranks equal {ranks_equal}, "
          f"MAP {got_map} vs {want_map}")
    sharded = res[0]["query"]
    same_q, worst_q = same_rankings(sharded, single, 1e-4)
    same_q = same_q and len(sharded) == len(single) == 4 and res[1]["query"] == []
    check(same_q, f"phase 25b query --shard rankings differ from the one-card query (max score "
          f"difference {worst_q:.3g})")

    # c. the graft entry: its whisper-tiny forward on the card against its CPU run
    from wealy_tpu_torch.graft_entry import entry

    reset_counts, counts = launch_counters()
    forward, (audio,) = entry(P25_DEVICE)
    reset_counts()
    t = time.perf_counter()
    got = forward(audio).float().cpu()
    entry_s = time.perf_counter() - t
    for name, n in counts().items():
        launched[name] += n
    cpu_forward, _ = entry("cpu")
    entry_cos = min_row_cos(got, cpu_forward(audio).float())
    check(tuple(got.shape) == (2, 512) and entry_cos >= 0.9999,
          f"phase 25c graft_entry.entry() card vs CPU {tuple(got.shape)} cos {entry_cos:.6f}")
    del forward, cpu_forward

    t0 = res[0]["times"]
    chunks = out.get("throughput", {}).get("total_items", 0)
    shp = res[0]["shapes"]
    say(f"[25 parallel, 2 ranks on one card over gloo; host-staged (NCCL refuses two ranks on "
        f"one device): times are the host-staged transport's, not TP's across cards] 0. gloo on "
        f"{P25_DEVICE} tensors: {gloo}; the port stages every gloo operation on a card's tensors "
        f"through the host | a. extract "
        f"--batched --tp 2 hs_last_seq {P25_SIZE}, {out.get('done')} versions ({chunks} "
        f"chunks, B=16, max_len 224) {t0['extract']:.2f} s wall = "
        f"{chunks / max(t0['extract'], 1e-9):.3f} chunks/s incl. the model build; stored rows: "
        f"prompt rows cos {head_cos:.6f} against phase 21's one-process store, share of rows "
        f">= 0.999 min {min(share):.3f} median {float(np.median(share)):.3f} | TP decode "
        f"B={P25_BATCH} {t0['decode']:.2f} s: tokens held up to the first margin below 1e-2 or "
        f"2x the teacher-forced gap ({compared} positions over 2 ranks; by the 1e-2 rule alone "
        f"{'held' if strict else 'not held'} over {compared_strict}), hidden cos {hcos:.6f}, "
        f"teacher-forced log-probabilities cos {lp_cos:.6f}, gap median "
        f"{float(gap.median()):.3g} max {float(gap.max()):.3g} | TP encoder states cos "
        f"{enc['tp_states'][0]:.6f} rel err {enc['tp_states'][1]:.3g} ({t0['tp_states']:.2f} "
        f"s), SP cos {enc['sp_states'][0]:.6f} rel err {enc['sp_states'][1]:.3g} "
        f"({t0['sp_states']:.2f} s) | TP fine-tune EncoderHead B={P25_BATCH} 2 steps "
        f"{t0['finetune']:.2f} s, losses {ft} vs plain {plain}, peak "
        f"{[round(r['finetune']['peak_gb'], 2) for r in res]} GB per rank | K2 shard shapes "
        f"{shp['flash_mha']}, K3 (x, w1, w2) shard shapes {shp['fused_mlp']} | b. GPipe 2 "
        f"stages whisper-tiny B=4, 2 microbatches: f32 at T 200 max err {pp_err:.3g}, bf16 at "
        f"T 1500 (K2, K3) row cos {pp16_cos:.6f} ({t0['pp']:.2f} s); ring f32 {P25_RING} max "
        f"err {ring_err:.3g} ({t0['ring']:.2f} s); sharded chunk-set ranking {P25_RANKING} "
        f"bpwr ranks equal {ranks_equal}, MAP {got_map['MAP']:.4f} ({t0['ranking']:.2f} s); "
        f"query --shard on a {P25_SERVE} index, 4 queries, rankings equal the one-card query "
        f"{same_q} (max score difference {worst_q:.3g}; {t0['query']:.2f} s) | c. "
        f"graft_entry.entry() whisper-tiny (2, 512) card vs CPU row cos {entry_cos:.6f} "
        f"({entry_s:.2f} s with its first launches) | launches (both ranks and c) {launched} | "
        f"references {ref_s:.1f} s, ranks {ranks_s:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s | {smi}")
    return launched

if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), [int(p) for p in sys.argv[3].split(",")],
                               sys.argv[4]))
    sys.exit(main())
