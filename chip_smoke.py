#!/usr/bin/env python3
"""Smoke test of the PyTorch port (wealy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each against
its plain PyTorch version at the shapes its path gives it (the attention
backward K5a/K5b against autograd of the plain attention, phase 12), drives
extract_song at whisper-tiny (card against CPU) and at large-v3-turbo full
width (random weights from a seed), times the whisper-tiny embedding
pipeline, drives ``python -m wealy_tpu_torch.cli.main evaluate`` on a
synthetic project at full width (turbo ``hs_last_seq``, 1280-dim, through
the 512-wide head; monolithic and streamed; card against CPU on a subset),
times chunk-set bpwr ranking at SHS100K-TEST scale, then trains: a
whisper-tiny encoder+head step on the card against the CPU (phase 13), the
large-v3-turbo encoder + ProjectionHead(512) fine-tuned at full width and
depth (phase 14), and ``train`` then ``evaluate --checkpoint`` through the
CLI on the synthetic project (phase 15). Every phase prints one line. At
the end come the card's name and power limit, then the kernel summary as
JSON, then the result as JSON on the last line. Any failed check exits
nonzero without the result line. Refuses to run without CUDA.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

FAILURES: list[str] = []
# the kernels of the extraction path (phases 6-7); K4 runs on the evaluate path (phase 10)
EXTRACT_KERNELS = ("log_mel", "flash_mha", "fused_mlp")


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
    from wealy_tpu_torch.ops import BF16_GRAD_COS_MIN, bf16_agreement
    from wealy_tpu_torch.ops.flash_attention import (
        _reference_mha,
        flash_mha,
        flash_mha_bwd_dkv,
        flash_mha_bwd_dq,
        flash_mha_fwd,
    )
    from wealy_tpu_torch.ops.fused_mlp import _reference_mlp, fused_mlp
    from wealy_tpu_torch.ops.bpwr_redux import _reference_bpwr_block, bpwr_block_redux

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
        qv[0] = False  # a query with no valid chunk: its pairs are fully excluded
        cv[-1] = False
        return d, qv, cv

    for label, shape, kw in (
        ("headline", (222, 222, 18, 18), dict(view=True)),
        ("s1>s2", (64, 96, 24, 10), {}),
        ("s=1", (512, 512, 1, 1), {}),
        ("40x40", (32, 48, 40, 40), {}),
        ("largest", (4, 8, 128, 128), {}),
        ("masked rows", (16, 32, 12, 12), dict(p_invalid=0.5)),
        ("exact ties", (8, 8, 6, 6), dict(ties=True)),
    ):
        d, qv, cv = bpwr_case(shape, **kw)
        got = bpwr_block_redux(d, qv, cv)
        again = bpwr_block_redux(d, qv, cv)
        want = _reference_bpwr_block(d, qv, cv, "bpwr", 1e-7, 1e12)
        err = (got - want).abs().max().item()
        same = torch.equal(got, again)
        zero_rows = bool((got[0] == 0).all()) and bool((got[:, -1] == 0).all())
        ok = check(err <= 1e-6 and same and zero_rows and bool(torch.isfinite(got).all()),
                   f"K4 {label} {shape}: max abs {err:.3g}, repeat bit-equal {same}, "
                   f"excluded pairs zero {zero_rows}")
        ms = plain = None  # timed at the headline shape, which record() keeps
        if label == "headline":
            ms = cuda_ms(lambda: bpwr_block_redux(d, qv, cv), 20)
            plain = cuda_ms(lambda: _reference_bpwr_block(d, qv, cv, "bpwr", 1e-7, 1e12), 5)
        say(f"[9 K4 bpwr_redux] {label} Q,B,s1,s2={shape}: max_abs_err {err:.3g}, bit-equal "
            f"{bool(err == 0)}, repeat bit-equal {same} {'ok' if ok else 'FAIL'}"
            + (f"; kernel {ms:.3f} ms, plain {plain:.3f} ms" if ms is not None else ""))
        record("bpwr_redux", "wealy_tpu_torch/csrc/bpwr_redux.cu",
               "wealy_tpu/ops/pallas_redux.py:67", err, ms, plain, f"Q,B,s1,s2={shape}")
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

    for B, T, H in ((4, 1500, 6), (2, 1500, 20), (2, 257, 6)):
        q, k, v, g = (torch.randn(B, T, H, 64, device=dev, generator=gen).bfloat16()
                      for _ in range(4))
        out, lse = flash_mha_fwd(q, k, v, 0.125, with_lse=True)
        dq, delta = flash_mha_bwd_dq(q, k, v, out, g, lse, 0.125)
        dk, dv = flash_mha_bwd_dkv(q, k, v, g, lse, delta, 0.125)
        dq2, delta2 = flash_mha_bwd_dq(q, k, v, out, g, lse, 0.125)
        dk2, dv2 = flash_mha_bwd_dkv(q, k, v, g, lse, delta2, 0.125)
        same = all(torch.equal(a, b) for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)))
        plain_dq, plain_dkv = plain_backward(q, k, v, g, (0,)), plain_backward(q, k, v, g, (1, 2))
        want = (*plain_dq(), *plain_dkv())
        agree = [bf16_agreement(got, w, BF16_GRAD_COS_MIN) for got, w in zip((dq, dk, dv), want)]
        ok = check(all(a[0] for a in agree) and same,
                   f"K5a/K5b B={B} T={T} H={H}: (ok, max abs, min cos) dq/dk/dv {agree}, "
                   f"repeat bit-equal {same}")
        ms_dq = cuda_ms(lambda: flash_mha_bwd_dq(q, k, v, out, g, lse, 0.125), 10)
        ms_dkv = cuda_ms(lambda: flash_mha_bwd_dkv(q, k, v, g, lse, delta, 0.125), 10)
        pms_dq, pms_dkv = cuda_ms(plain_dq, 5), cuda_ms(plain_dkv, 5)
        shape = f"B={B} T={T} H={H} Dh=64"
        say(f"[12 K5a/K5b attention backward] {shape}: dq/dk/dv max_abs_err "
            f"{agree[0][1]:.3g}/{agree[1][1]:.3g}/{agree[2][1]:.3g} min_cos "
            f"{agree[0][2]:.6f}/{agree[1][2]:.6f}/{agree[2][2]:.6f}, repeat bit-equal {same} "
            f"{'ok' if ok else 'FAIL'}; K5a {ms_dq:.3f} ms (plain dq {pms_dq:.3f} ms), K5b "
            f"{ms_dkv:.3f} ms (plain dk+dv {pms_dkv:.3f} ms)")
        record("flash_mha_bwd_dq", "wealy_tpu_torch/csrc/flash_attention_bwd.cu",
               "wealy_tpu/ops/flash_attention.py:171", agree[0][1], ms_dq, pms_dq, shape)
        record("flash_mha_bwd_dkv", "wealy_tpu_torch/csrc/flash_attention_bwd.cu",
               "wealy_tpu/ops/flash_attention.py:197", max(agree[1][1], agree[2][1]), ms_dkv,
               pms_dkv, shape)
    del q, k, v, g, out, lse, dq, dk, dv, dq2, dk2, dv2, want, plain_dq, plain_dkv
    torch.cuda.empty_cache()

    counters = {"log_mel": log_mel_spectrogram_fused, "flash_mha": flash_mha,
                "flash_mha_bwd_dq": flash_mha_bwd_dq, "flash_mha_bwd_dkv": flash_mha_bwd_dkv,
                "fused_mlp": fused_mlp, "bpwr_redux": bpwr_block_redux}

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
    for name in EXTRACT_KERNELS:
        kernels[name]["launches"] = turbo_counts[name]
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

    # 10. evaluate through the CLI at full width on a synthetic project
    with tempfile.TemporaryDirectory(prefix="wealy_eval_") as tmp:
        evaluate_phase(tmp, dev, reset_counts, counts, kernels)

    # 11. chunk-set bpwr ranking at SHS100K-TEST scale
    ranking_phase(dev, smi)

    # 13-15. training
    tiny_training_phase(dev, reset_counts, counts)
    turbo_launches = turbo_finetune_phase(dev, reset_counts, counts, smi)
    for name in ("flash_mha_bwd_dq", "flash_mha_bwd_dkv"):
        kernels[name]["launches"] = turbo_launches[name]
    with tempfile.TemporaryDirectory(prefix="wealy_train_") as tmp:
        train_cli_phase(tmp, dev, reset_counts, counts, smi)

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
    import csv

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
    header = ["original_id", "id", "is_cover", "song_text_type", "label"]
    for split, rows in splits.items():
        with open(os.path.join(lc, f"{split}_no_dup.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            for i, (vid, label) in enumerate(rows):
                w.writerow([rows[i - i % per_clique][0], vid, i % per_clique > 0, "o", label])
    rows = splits["test"]
    conf = {
        "path": {"lyric_covers_data": lc, "hidden_states": os.path.join(root, "hs"),
                 "cache": os.path.join(root, "cache")},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat", "chunk_size": 1000, "overlap_percentage": 0.9},
        "model": {"name": "whisper", "zdim": 512},
    }
    cpath = os.path.join(root, "conf.json")
    with open(cpath, "w") as f:
        json.dump(conf, f)
    return cpath, rows


def run_cli(argv) -> tuple[dict, float]:
    """``python -m wealy_tpu_torch.cli.main <argv>`` in-process: (the JSON
    line it prints, wall seconds)."""
    from wealy_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), wall


def evaluate_phase(tmp: str, dev, reset_counts, counts, kernels) -> None:
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
    kernels["bpwr_redux"]["launches"] = eval_counts["bpwr_redux"]
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
    card_m = evaluate(args, device=dev)
    t1 = time.perf_counter()
    cpu_m = evaluate(build_parser().parse_args(["evaluate", "--config", sub_conf]), device="cpu")
    cpu_s = time.perf_counter() - t1
    config = Config.from_file(sub_conf)
    ds = EmbeddingDataset(config, "test")
    z = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        head = load_head(config, 1280, None, device)
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


def ranking_phase(dev, smi: str, n_versions: int = 10547, smax: int = 18, zdim: int = 512):
    """streaming_relevant_ranks with chunk-set bpwr at the size of
    SHS100K-TEST (10,547 versions), the resident corpus, every query; the
    first 64 queries re-ranked with the plain redux in the same blocks."""
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
    t0 = time.perf_counter()
    ranks, n_rel = streaming_relevant_ranks(
        sets, sets, labels, labels, mode="cos", redux="bpwr", query_mask=mask, corpus_mask=mask,
        block_size=blk, query_block=blk, query_idx=ids, corpus_idx=ids, device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
        f"first {nq} queries plain-redux ranks identical {same} | {smi}")


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


def tiny_training_phase(dev, reset_counts, counts) -> None:
    """13. whisper-tiny encoder + head, one clews step, card against CPU from
    the same seeded weights and mel batch (B=4, 30 s)."""
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


def train_cli_phase(tmp: str, dev, reset_counts, counts, smi: str, max_steps: int = 20) -> None:
    """15. ``train --max-steps 20`` on the synthetic turbo-width project (a
    train split of 16 cliques of 4, val 4 cliques, test 32 cliques), then
    ``evaluate --checkpoint`` on the head it saved."""
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
    launched = counts()
    recs = [json.loads(line) for line in open(metrics)]
    steps = [r for r in recs if "loss" in r]
    val = [r for r in recs if "val_MAP" in r]
    # steady rate from step 2 to the last, both ends synchronised
    rate = (len(steps) - 2) / (steps[-1]["t"] - steps[1]["t"])
    check(out["final_step"] == max_steps and np.isfinite(out["final_loss"]) and len(val) == 1,
          f"phase 15 train {out}, {len(val)} val records")
    ev, ev_s = run_cli(["evaluate", "--config", cpath, "--split", "test", "--checkpoint", ckdir])
    check(ev["n_queries"] == len(rows) and np.isfinite(ev["MAP"]),
          f"phase 15 evaluate --checkpoint {ev}")
    say(f"[15 train CLI] train --max-steps {max_steps} on 64 turbo-width versions (batch 16 x 2, "
        f"chunk 1000 x 1280 fp16): {train_s:.2f} s, {rate:.2f} head-training steps/s (steps "
        f"2-{max_steps}), "
        f"final loss {out['final_loss']:.6f}, val MAP {val[0]['val_MAP']:.6f}; evaluate "
        f"--checkpoint: MAP {ev['MAP']:.6f} MR1 {ev['MR1']:.4f} over {ev['n_queries']} versions "
        f"({ev_s:.2f} s); launches {launched}; set-up {setup_s:.1f} s | {smi}")


if __name__ == "__main__":
    sys.exit(main())
