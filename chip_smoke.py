#!/usr/bin/env python3
"""Smoke test of the PyTorch port (wealy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each against
its plain PyTorch version at the shapes the extraction path gives it, drives
extract_song at whisper-tiny (card against CPU) and at large-v3-turbo full
width (random weights from a seed), and times the whisper-tiny embedding
pipeline. Every phase prints one line. At the end come the card's name and
power limit, then the kernel summary as JSON, then the result as JSON on the
last line. Any failed check exits nonzero without the result line. Refuses
to run without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

FAILURES: list[str] = []


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


def min_row_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1, eps=1e-30).min().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    from wealy_tpu_torch.ops import bf16_agreement
    from wealy_tpu_torch.ops.flash_attention import _reference_mha, flash_mha
    from wealy_tpu_torch.ops.fused_mlp import _reference_mlp, fused_mlp

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

    def record(name, source, replaces, err, ms, plain_ms, shape):
        """The first shape recorded is the kernel's headline (its times and
        shape go into the summary); max_abs_err covers every shape."""
        k = kernels.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "shape": shape,
        })
        k["max_abs_err"] = max(k["max_abs_err"], err)

    # 3. K1 log-mel against its plain version (f32, TF32 off)
    audio = torch.randn(8, tmel.N_SAMPLES, device=dev, generator=gen) * 0.1
    for n_mels in (80, 128):
        got = log_mel_spectrogram_fused(audio, n_mels)
        want = tmel.log_mel_spectrogram(audio, n_mels)
        err = (got - want).abs().max().item()
        ok = check(torch.allclose(got, want, rtol=fused_mel.RTOL, atol=fused_mel.ATOL),
                   f"K1 n_mels={n_mels} outside rtol {fused_mel.RTOL} / atol "
                   f"{fused_mel.ATOL} (max abs {err:.3g})")
        ms = cuda_ms(lambda: log_mel_spectrogram_fused(audio, n_mels), 20)
        plain = cuda_ms(lambda: tmel.log_mel_spectrogram(audio, n_mels), 20)
        say(f"[3 K1 log_mel] B=8 n_mels={n_mels}: max_abs_err {err:.3g} "
            f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain {plain:.3f} ms")
        record("log_mel", "wealy_tpu_torch/csrc/log_mel.cu",
               "wealy_tpu/audio/pallas_mel.py:40", err, ms, plain, f"B=8 n_mels={n_mels}")

    # 4. K2 attention against _reference_mha (bf16)
    for B, T, H in ((4, 1500, 6), (2, 1500, 20), (2, 257, 6)):
        q, k, v = (torch.randn(B, T, H, 64, device=dev, generator=gen).bfloat16()
                   for _ in range(3))
        got, want = flash_mha(q, k, v, 0.125), _reference_mha(q, k, v, 0.125)
        ok, err, cos = bf16_agreement(got, want)
        check(ok, f"K2 B={B} T={T} H={H}: cos {cos:.6f} max abs {err:.3g}")
        ms = cuda_ms(lambda: flash_mha(q, k, v, 0.125), 20)
        plain = cuda_ms(lambda: _reference_mha(q, k, v, 0.125), 20)
        say(f"[4 K2 flash_mha] B={B} T={T} H={H} Dh=64: max_abs_err {err:.3g} min_cos "
            f"{cos:.6f} {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain {plain:.3f} ms")
        record("flash_mha", "wealy_tpu_torch/csrc/flash_attention.cu",
               "wealy_tpu/ops/flash_attention.py:56", err, ms, plain, f"B={B} T={T} H={H} Dh=64")

    # 5. K3 MLP against _reference_mlp (bf16 operands, f32 biases)
    for D in (384, 1280):
        w1 = (torch.randn(4 * D, D, device=dev, generator=gen) * D**-0.5).bfloat16()
        w2 = (torch.randn(D, 4 * D, device=dev, generator=gen) * (4 * D) ** -0.5).bfloat16()
        b1 = torch.randn(4 * D, device=dev, generator=gen) * 0.1
        b2 = torch.randn(D, device=dev, generator=gen) * 0.1
        for N in (4 * 1500, 4507):
            x = torch.randn(N, D, device=dev, generator=gen).bfloat16()
            got, want = fused_mlp(x, w1, b1, w2, b2), _reference_mlp(x, w1, b1, w2, b2)
            ok, err, cos = bf16_agreement(got, want)
            check(ok, f"K3 D={D} N={N}: cos {cos:.6f} max abs {err:.3g}")
            ms = cuda_ms(lambda: fused_mlp(x, w1, b1, w2, b2), 10)
            plain = cuda_ms(lambda: _reference_mlp(x, w1, b1, w2, b2), 10)
            say(f"[5 K3 fused_mlp] N={N} D={D}: max_abs_err {err:.3g} min_cos {cos:.6f} "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain {plain:.3f} ms")
            record("fused_mlp", "wealy_tpu_torch/csrc/fused_mlp.cu",
                   "wealy_tpu/ops/fused_mlp.py:44", err, ms, plain, f"N={N} D={D}")
    counters = {"log_mel": log_mel_spectrogram_fused, "flash_mha": flash_mha,
                "fused_mlp": fused_mlp}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

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
    check(all(v > 0 for v in tiny_counts.values()), f"tiny slice launches {tiny_counts}")
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
    check(all(v > 0 for v in turbo_counts.values()), f"turbo launches {turbo_counts}")
    say(f"[7 turbo slice] 2 songs x 3 chunks: x_concat {[o['x_concat'].shape for o in outs]} "
        f"hs_last_seq {[o['hs_last_seq'].shape for o in outs]}; {6 / turbo_s:.2f} clips/s "
        f"({turbo_s:.2f} s, max_len 64); peak {peak_gb:.2f} GB; launches {turbo_counts}")
    for name, n in turbo_counts.items():
        kernels[name]["launches"] = n
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


if __name__ == "__main__":
    sys.exit(main())
