#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port (wealy_tpu_torch), on one
NVIDIA GPU.

    python3 chip_profile.py [--out profile_out] [--only tiny,turbo,...]

Six pipelines, each traced with torch.profiler (CUPTI) after a warm-up
(``--only`` picks some of them by name: tiny, turbo, evaluate, ranking,
finetune, serving):

- whisper-tiny mel + bf16 encoder + mean pool at B=64, three batches;
- large-v3-turbo ``extract_song`` over one 65 s song (3 chunks, x_concat and
  hs_last_seq, max_len 64), seeded random weights. Before the trace, the
  untraced host-clock times of the song's mel + encoder part, its decode
  part and the whole call are printed, three runs each;
- ``evaluate`` (monolithic, bpwr) of chip_smoke.py's synthetic project: 128
  turbo-width versions through the 512-wide head. Before the trace, the
  untraced host-clock time of each stage (embedding load, overlapping
  collate, head, chunk-set scoring and ranks) is printed;
- chunk-set bpwr ranking (``streaming_relevant_ranks``, resident corpus) at
  SHS100K-TEST scale, 10,547 versions with smax 18, for the first 444
  queries (two query slabs);
- one large-v3-turbo fine-tuning step (chip_smoke.py phase 14): the
  encoder (bf16 compute, f32 masters) + ProjectionHead(512), clews, AdamW,
  B=8 30 s clips. Before the trace, the untraced host-clock time of the
  forward + backward and of the whole step is printed, three runs each;
- one Q=16 exact-scan ``search_many`` of the serving engine over a
  10,547-version index (chip_smoke.py phase 18: f16 sets, smax 18, zdim
  512, turbo-width queries through the 512-wide head), after two warm-up
  batches.

For each trace it prints the host wall of the traced region, the device busy
time (the union of the intervals of kernels, copies and sets), the idle
share, and the kernels by device time. The profiler's own tables go to
``--out``.

    python3 chip_profile.py --kernels [--package-root DIR]

times the redesigned kernels against the one PyTorch call that computes the
same function, in turns (chip_smoke.py's ``turns_ms``: library, kernel,
kernel, library, five times over, medians, launches queued behind a device
sleep): K1 against a ``torch.stft`` log-mel at B=8 and B=64 (80 mels), K2
against SDPA's forward at (4, 1500, 6, 64), (8, 1500, 20, 64) and (64, 1500,
6, 64), K5a + K5b against SDPA's backward (dq, dk and dv together) at
(4, 1500, 6, 64) and (8, 1500, 20, 64), K3 against the bf16 cuBLAS chain
(``F.linear`` -> ``F.gelu`` -> ``F.linear``) at N=6000 with D=384 and 1280,
and K4 alone at (222, 222, 18, 18), (1, 512, 18, 18), (16, 512, 18, 18),
(222, 222, 12, 12), (16, 512, 40, 18) and (64, 64, 40, 40), with
``wealy_tpu_torch`` imported
from DIR (default: this checkout), so that two checkouts can be compared
within one call on one card by their ratios to the library calls. It
prints one JSON line. Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import tempfile
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
    ap.add_argument("--kernels", action="store_true",
                    help="time K1, K2, K3, K4 and K5a + K5b (against their library calls, "
                         "where there is one) in turns, and nothing else")
    ap.add_argument("--package-root", default=None,
                    help="checkout whose wealy_tpu_torch --kernels times")
    ap.add_argument("--only", default="tiny,turbo,evaluate,ranking,finetune,serving",
                    help="comma-separated pipelines to trace, in this order")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.kernels:
        return time_kernels(args.package_root)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    # decode logits are f32 products, the heads' convolutions f32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name in args.only.split(","):
        if name not in PIPELINES:
            raise SystemExit(f"--only: unknown pipeline {name!r}; known: {', '.join(PIPELINES)}")
        PIPELINES[name](dev, activities, out)
    print(smi, flush=True)
    return 0


def profile_tiny(dev, activities, out: Path) -> None:
    """whisper-tiny embedding pipeline, B=64."""
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.models.whisper.extract import encoder_embeddings

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


def profile_turbo(dev, activities, out: Path) -> None:
    """large-v3-turbo extract_song, one 65 s song."""
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.models.whisper.extract import (
        chunk_waveform,
        decoder_embeddings,
        encoder_states,
        extract_song,
    )

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


def time_kernels(package_root) -> int:
    import inspect
    import json

    import torch.nn.functional as F

    from chip_smoke import attention_backward_bounds, turns_ms

    if package_root is not None:
        sys.path.insert(0, os.path.abspath(package_root))
    from wealy_tpu_torch.audio import fused_mel
    from wealy_tpu_torch.audio import mel as tmel
    from wealy_tpu_torch.ops import bpwr_redux as br
    from wealy_tpu_torch.ops import flash_attention as fa
    from wealy_tpu_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    iters = {"kernel": 20, "library": 20}
    order = ("library", "kernel", "kernel", "library")
    rows = []

    window = torch.hann_window(tmel.N_FFT, device=dev)
    melw = tmel.bases(80, dev)[2]
    for B in (8, 64):
        audio = torch.randn(B, tmel.N_SAMPLES, device=dev, generator=gen) * 0.1

        def stft_log_mel():
            spec = torch.stft(audio, tmel.N_FFT, tmel.HOP_LENGTH, window=window,
                              return_complex=True)
            mel = melw.T @ spec[..., :-1].abs().square()
            return tmel.finish_log_mel(torch.log10(torch.clamp_min(mel, 1e-10)))

        med = turns_ms({"kernel": lambda: fused_mel.log_mel_spectrogram_fused(audio, 80),
                        "library": stft_log_mel}, order, 5, iters)
        rows.append({"kernel": "K1", "shape": [B, 80], "ms": med["kernel"],
                     "library": "torch.stft mel", "library_ms": med["library"],
                     "ratio": med["kernel"] / med["library"]})
    del audio
    for B, T, H in ((4, 1500, 6), (8, 1500, 20), (64, 1500, 6)):
        q, k, v = (torch.randn(B, T, H, 64, device=dev, generator=gen).bfloat16()
                   for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        med = turns_ms({"kernel": lambda: fa.flash_mha(q, k, v, 0.125),
                        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          scale=0.125)},
                       order, 5, iters)
        rows.append({"kernel": "K2", "shape": [B, T, H, 64], "ms": med["kernel"],
                     "library": "SDPA forward", "library_ms": med["library"],
                     "ratio": med["kernel"] / med["library"]})
    # a checkout from before K5a stopped reading the forward's output takes it
    takes_out = "out" in inspect.signature(fa.flash_mha_bwd_dq).parameters
    for B, T, H in ((4, 1500, 6), (8, 1500, 20)):
        q, k, v, g = (torch.randn(B, T, H, 64, device=dev, generator=gen).bfloat16()
                      for _ in range(4))
        out, lse = fa.flash_mha_fwd(q, k, v, 0.125, with_lse=True)
        dq_args = (q, k, v, out, g, lse, 0.125) if takes_out else (q, k, v, g, lse, 0.125)
        _, delta = fa.flash_mha_bwd_dq(*dq_args)
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            sdpa = F.scaled_dot_product_attention(*leaves, scale=0.125)
        gt = g.transpose(1, 2)
        fns = {"dq": lambda: fa.flash_mha_bwd_dq(*dq_args),
               "dkv": lambda: fa.flash_mha_bwd_dkv(q, k, v, g, lse, delta, 0.125),
               "library": lambda: torch.autograd.grad(sdpa, leaves, gt, retain_graph=True)}
        med = turns_ms(fns, ("library", "dq", "dkv", "dq", "dkv", "library"), 5,
                       {"dq": 20, "dkv": 20, "library": 20})
        pair = med["dq"] + med["dkv"]
        rows.append({"kernel": "K5a+K5b", "shape": [B, T, H, 64], "k5a_ms": med["dq"],
                     "k5b_ms": med["dkv"], "ms": pair, "library": "SDPA backward",
                     "library_ms": med["library"], "ratio": pair / med["library"],
                     "floor_ms": attention_backward_bounds(B, T, H)["floor"][0]})
    # K3 against the bf16 cuBLAS chain at the narrowest and widest Whisper width
    for N, D in ((6000, 384), (6000, 1280)):
        w1 = (torch.randn(4 * D, D, device=dev, generator=gen) * D**-0.5).bfloat16()
        w2 = (torch.randn(D, 4 * D, device=dev, generator=gen) * (4 * D) ** -0.5).bfloat16()
        b1 = torch.randn(4 * D, device=dev, generator=gen) * 0.1
        b2 = torch.randn(D, device=dev, generator=gen) * 0.1
        x = torch.randn(N, D, device=dev, generator=gen).bfloat16()
        b1h, b2h = b1.bfloat16(), b2.bfloat16()
        med = turns_ms({"kernel": lambda: fm.fused_mlp(x, w1, b1, w2, b2),
                        "library": lambda: F.linear(F.gelu(F.linear(x, w1, b1h)), w2, b2h)},
                       order, 5, iters)
        rows.append({"kernel": "K3", "shape": [N, D], "ms": med["kernel"],
                     "library": "bf16 cuBLAS chain", "library_ms": med["library"],
                     "ratio": med["kernel"] / med["library"]})
    # K4 (no library call) on the rank passes' view of a (Q*s1, B*s2)
    # distance matrix: the evaluate block and the serving blocks at smax 18,
    # songs of at most 12 chunks (two pairs a warp), a 40-chunk query
    # against the serving block, and an evaluate block of 40-chunk songs
    for Q, B, s1, s2 in ((222, 222, 18, 18), (1, 512, 18, 18), (16, 512, 18, 18),
                         (222, 222, 12, 12), (16, 512, 40, 18), (64, 64, 40, 40)):
        flat = torch.rand(Q * s1, B * s2, device=dev, generator=gen) * 2
        d = flat.reshape(Q, s1, B, s2).permute(0, 2, 1, 3)
        qv = torch.rand(Q, s1, device=dev, generator=gen) > 0.2
        cv = torch.rand(B, s2, device=dev, generator=gen) > 0.2
        med = turns_ms({"kernel": lambda: br.bpwr_block_redux(d, qv, cv)}, ("kernel",), 5, iters)
        rows.append({"kernel": "K4", "shape": [Q, B, s1, s2], "ms": med["kernel"]})
    print(json.dumps({"package": os.path.abspath(fa.__file__), "card": smi, "rows": rows}),
          flush=True)
    return 0


def profile_evaluate(dev, activities, out: Path) -> None:
    with tempfile.TemporaryDirectory(prefix="wealy_profile_") as tmp:
        profile_evaluate_in(tmp, dev, activities, out)


def profile_evaluate_in(tmp: str, dev, activities, out: Path) -> None:
    from chip_smoke import write_project
    from wealy_tpu_torch.cli.main import _pad_chunk_sets, build_parser, evaluate, load_head
    from wealy_tpu_torch.data.chunking import collate_overlapping
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.eval.retrieval import evaluate_retrieval, regroup_chunks, slabbed_apply
    from wealy_tpu_torch.train.config import Config

    cpath, _ = write_project(tmp, dev)
    args = ["evaluate", "--config", cpath, "--split", "test", "--redux", "bpwr"]
    evaluate(build_parser().parse_args(args))  # warm-up: cuDNN plans, caches
    config = Config.from_file(cpath)
    ds = EmbeddingDataset(config, "test")
    versions = list(ds.sampler.versions)
    head, _ = load_head(config, 1280, None, dev)
    t = {"load": 0.0, "collate": 0.0, "head": 0.0}
    sets_all, masks_all, labels, ids = [], [], [], []
    t_all = time.perf_counter()
    for g0 in range(0, len(versions), 64):
        t0 = time.perf_counter()
        items = [(ds.sampler.labels[ds.sampler.clique_of[v]],
                  [(int(ds.metadata.info[v]["id"]), ds.load_embedding(v))])
                 for v in versions[g0 : g0 + 64]]
        t1 = time.perf_counter()
        batch = collate_overlapping(items, chunk_size=1000, overlap=0.9)
        t2 = time.perf_counter()
        z = slabbed_apply(head, batch.embeddings, batch.masks, slab_size=256, device=dev)
        t3 = time.perf_counter()
        sets, mask, bidx, _ = regroup_chunks(z, batch.chunk_info, batch.chunk_valid)
        sets_all.append(sets)
        masks_all.append(mask)
        labels.extend(items[i][0] for i in bidx)
        ids.extend(items[i][1][0][0] for i in bidx)
        t["load"] += t1 - t0
        t["collate"] += t2 - t1
        t["head"] += t3 - t2
    t0 = time.perf_counter()
    sets, mask = _pad_chunk_sets(sets_all, masks_all, len(labels))
    evaluate_retrieval(sets, mask, np.asarray(labels), version_ids=np.asarray(ids), device=dev)
    torch.cuda.synchronize()
    t["score+rank"] = time.perf_counter() - t0
    total = time.perf_counter() - t_all
    print(f"[evaluate untraced] {len(versions)} versions, {total:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s ({100 * v / total:.1f}%)" for k, v in t.items()),
          flush=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        evaluate(build_parser().parse_args(args))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report("evaluate_128_turbo", prof, wall, out)


def profile_ranking(dev, activities, out: Path, n: int = 10547, smax: int = 18,
                    zdim: int = 512, n_queries: int = 444) -> None:
    from wealy_tpu_torch.parallel.similarity import streaming_relevant_ranks

    rng = np.random.default_rng(11)
    labels = np.arange(n) // 6
    sets = rng.normal(size=(n, smax, zdim)).astype(np.float32)
    mask = np.arange(smax)[None, :] < rng.integers(1, smax + 1, n)[:, None]
    kw = dict(mode="cos", redux="bpwr", query_mask=mask[:n_queries], corpus_mask=mask,
              block_size=222, query_block=222, device=dev)
    streaming_relevant_ranks(sets[:222], sets, labels[:222], labels, **{
        **kw, "query_mask": mask[:222]})  # warm-up
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        streaming_relevant_ranks(sets[:n_queries], sets, labels[:n_queries], labels, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report(f"ranking_{n_queries}q_x_{n}", prof, wall, out)



def profile_finetune(dev, activities, out: Path, B: int = 8) -> None:
    from chip_smoke import mel_batch
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.losses import clews_loss
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_
    from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
    from wealy_tpu_torch.train.state import create_train_state, make_optimizer
    from wealy_tpu_torch.train.step import loss_and_grads, make_train_step

    whisper, cfg = load_whisper_model("large-v3-turbo", seed=0, device=dev, dtype=torch.bfloat16)
    head = seeded_init_(ProjectionHead(cfg.n_audio_state, zdim=512), seed=1).to(dev)
    state = create_train_state(EncoderHead(whisper.encoder, head),
                               make_optimizer(lr=1e-5, warmup_steps=1, max_steps=1000), init=False)
    del whisper
    batch = mel_batch(B, cfg.n_mels, torch.Generator(device=dev).manual_seed(14), dev)
    step = make_train_step(None, clews_loss, model_call=encoder_head_call)
    for _ in range(2):  # warm-up: cuBLAS/cuDNN plans, the allocator
        state, _ = step(state, batch)
    for run in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_and_grads(state, batch, clews_loss, encoder_head_call)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"[finetune untraced {run}] B={B}: forward+backward {(t1 - t0) * 1e3:.2f} ms, "
              f"train step {(t2 - t1) * 1e3:.2f} ms", flush=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report(f"turbo_finetune_step_B{B}", prof, wall, out, top=20)


def profile_serving(dev, activities, out: Path) -> None:
    with tempfile.TemporaryDirectory(prefix="wealy_profile_serve_") as tmp:
        profile_serving_in(tmp, dev, activities, out)


def profile_serving_in(tmp: str, dev, activities, out: Path, n: int = 10547, smax: int = 18,
                       zdim: int = 512, Q: int = 16) -> None:
    from chip_smoke import serving_config, write_index
    from wealy_tpu_torch.cli.serve import QueryEngine
    from wealy_tpu_torch.train.config import Config

    rng = np.random.default_rng(18)
    mask = np.arange(smax)[None, :] < rng.integers(1, smax + 1, n)[:, None]
    sets = (rng.normal(size=(n, smax, zdim)) * mask[..., None]).astype(np.float16)
    idx = os.path.join(tmp, "shs.npz")
    write_index(idx, sets, mask, np.arange(n) // 2, 1280, 1000, 0.9)
    del sets
    eng = QueryEngine(Config.from_file(serving_config(tmp)), idx, None, device=dev)
    seqs = [(rng.normal(size=(int(T), 1280)) * 0.5).astype(np.float32)
            for T in rng.integers(1000, 2701, Q)]
    for _ in range(2):
        eng.search_many(seqs, k=10)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        eng.search_many(seqs, k=10)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report(f"serving_exact_Q{Q}_x_{n}", prof, wall, out)


PIPELINES = {"tiny": profile_tiny, "turbo": profile_turbo, "evaluate": profile_evaluate,
             "ranking": profile_ranking, "finetune": profile_finetune, "serving": profile_serving}


if __name__ == "__main__":
    sys.exit(main())
