#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port (wealy_tpu_torch), on one
NVIDIA GPU.

    python3 chip_profile.py [--out profile_out]

Two pipelines, each traced with torch.profiler (CUPTI) after a warm-up:

- whisper-tiny mel + bf16 encoder + mean pool at B=64, three batches;
- large-v3-turbo ``extract_song`` over one 65 s song (3 chunks, x_concat and
  hs_last_seq, max_len 64), seeded random weights. Before the trace, the
  untraced host-clock times of the song's mel + encoder part, its decode
  part and the whole call are printed, three runs each.

For each trace it prints the host wall of the traced region, the device busy
time (the union of the intervals of kernels, copies and sets), the idle
share, and the kernels by device time. The profiler's own tables go to
``--out``. Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in us, as ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def report(label: str, prof, wall_ms: float, out: Path, top: int = 14) -> None:
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise SystemExit(f"{label}: the trace holds no device activity")
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in events)
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    print(f"[{label}] traced wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f}%), idle {100 * (1 - busy / wall_ms):.1f}%, "
          f"{len(events)} device events", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} {name[:110]}", flush=True)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=80)
    (out / f"{label}.txt").write_text(table)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_out", help="directory for the tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.models.whisper.extract import (
        chunk_waveform,
        decoder_embeddings,
        encoder_embeddings,
        encoder_states,
        extract_song,
    )

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # decode logits are f32 products
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    # whisper-tiny embedding pipeline, B=64
    model, cfg = load_whisper_model("tiny", seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = torch.randn(64, 480000, device=dev, generator=gen) * 0.1

    def embed():
        with torch.no_grad():
            return encoder_embeddings(model, log_mel_spectrogram_fused(batch, cfg.n_mels))

    for _ in range(2):
        embed()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            embed()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report("tiny_embed_B64_x3", prof, wall, out)
    del model

    # large-v3-turbo extract_song, one 65 s song
    model, cfg = load_whisper_model("large-v3-turbo", seed=0, device=dev)
    song = (0.1 * np.random.default_rng(1).normal(size=65 * 16000)).astype(np.float32)
    kinds = ("x_concat", "hs_last_seq")
    extract_song(model, song, cfg, kinds=kinds, max_len=64)  # warm-up at the same shapes
    for run in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = torch.from_numpy(chunk_waveform(song)).to(dev)
        mel = log_mel_spectrogram_fused(chunks, n_mels=cfg.n_mels)
        states = encoder_states(model, mel)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = decoder_embeddings(model, mel, cfg, max_len=64, states=states)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        extract_song(model, song, cfg, kinds=kinds, max_len=64)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        steps = int(dec["lengths"].max())
        print(f"[turbo untraced {run}] mel+encoder {(t1 - t0) * 1e3:.2f} ms, decode "
              f"{(t2 - t1) * 1e3:.2f} ms ({steps} positions), extract_song "
              f"{(t3 - t2) * 1e3:.2f} ms", flush=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        extract_song(model, song, cfg, kinds=kinds, max_len=64)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report("turbo_extract_song_65s", prof, wall, out)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
