"""Entry points of the port, the counterpart of the repository's
``__graft_entry__.py``: a single-card forward and a multi-rank dry run.

- :func:`entry` returns a forward on whisper-tiny and its example args:
  K1 log-mel -> the bf16 encoder (K2, K3) -> a bf16 ``ProjectionHead(512)``
  -> one 512-d embedding per clip, on the card unless ``device="cpu"``.
- :func:`dryrun_multichip` runs the JAX dry run's stages on ``n`` ranks (a
  process each) and holds each against the one-rank result: the data-
  parallel train step (and its GradCache form), TP and SP encode, the TP
  train step, PP encode and its train step, data-parallel and TP greedy
  decode, sharded distance, top-k and streamed MAP, ring attention, and the
  sharded serving scorer. With ``n`` cards the ranks talk over NCCL; with
  fewer it raises, unless the caller passes ``device="cpu"``, which runs
  ``n`` gloo processes on the CPU. Nothing falls back on its own.

    python -m wealy_tpu_torch.graft_entry [--n 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from wealy_tpu_torch import resolve_device

REPO = Path(__file__).resolve().parents[1]


def entry(device=None):
    """(forward, (audio,)): ``forward(audio (2, 480000) f32) -> (2, 512)``
    bf16 embeddings through the fused mel (K1), the whisper-tiny encoder
    (K2, K3) and a ``ProjectionHead(512, hidden=(512,))``, seeded weights
    (``Whisper.init_weights``, the heads' ``seeded_init_``). The modules
    are ``forward.model`` and ``forward.head``."""
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.audio.mel import N_SAMPLES
    from wealy_tpu_torch.cli.extract import load_whisper_model
    from wealy_tpu_torch.cli.extract_batched import bf16_head
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_

    device = resolve_device(device)
    model, cfg = load_whisper_model("tiny", seed=0, device=device, dtype=torch.bfloat16)
    head = bf16_head(seeded_init_(ProjectionHead(cfg.n_audio_state, zdim=512, hidden=(512,)),
                                  seed=0), device).eval()

    @torch.inference_mode()
    def forward(audio: torch.Tensor) -> torch.Tensor:
        mel = log_mel_spectrogram_fused(audio.to(device), n_mels=cfg.n_mels)
        states = model.encode(mel)
        return head(states, torch.ones(states.shape[:2], dtype=torch.bool, device=device))

    forward.model, forward.head = model, head
    audio = (0.1 * np.random.default_rng(0).normal(size=(2, N_SAMPLES))).astype(np.float32)
    return forward, (torch.from_numpy(audio),)


# --- the multi-rank dry run ----------------------------------------------------------


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _tiny(n_layer: int = 1):
    from wealy_tpu_torch.models.whisper.config import WhisperConfig

    return WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=2,
                         n_audio_layer=n_layer, n_vocab=64, n_text_ctx=8, n_text_state=32,
                         n_text_head=2, n_text_layer=1)


def _encoder_head_state(cfg, device, seed: int = 0):
    """A fresh f32 EncoderHead (tiny encoder + ProjectionHead(16)) train
    state on ``device``, the same weights on every rank."""
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_
    from wealy_tpu_torch.models.whisper.model import Whisper
    from wealy_tpu_torch.train.finetune import EncoderHead
    from wealy_tpu_torch.train.state import create_train_state, make_optimizer

    enc = Whisper(cfg, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(seed)).encoder
    head = seeded_init_(ProjectionHead(cfg.n_audio_state, zdim=16, hidden=(16,)), seed=seed)
    return create_train_state(EncoderHead(enc, head).to(device),
                              make_optimizer(lr=1e-3, warmup_steps=1, max_steps=10), init=False)


def _batch(mel: np.ndarray) -> dict:
    B = mel.shape[0]
    return {"emb": mel, "labels": np.repeat(np.arange(B // 2, dtype=np.int32), 2),
            "ids": np.arange(B, dtype=np.int32)}


def _stages(n: int, device: str) -> list:
    """Every stage on this rank; returns the lines rank 0 prints."""
    from wealy_tpu_torch.eval.retrieval import rank_metrics, song_distance_matrix, \
        song_distance_matrix_torch
    from wealy_tpu_torch.losses import get_loss
    from wealy_tpu_torch.models.whisper.generate import greedy_decode
    from wealy_tpu_torch.models.whisper.model import Whisper
    from wealy_tpu_torch.ops.distance import pairwise_distance_matrix
    from wealy_tpu_torch.parallel.mesh import all_gather, local_chunk, make_mesh, shard_rows
    from wealy_tpu_torch.parallel.pp import make_pp_mesh, pp_encode_fn
    from wealy_tpu_torch.parallel.ring import make_cp_mesh, ring_attention
    from wealy_tpu_torch.parallel.similarity import (
        map_from_ranks,
        sharded_pairwise_distance,
        sharded_topk,
        streaming_relevant_ranks,
    )
    from wealy_tpu_torch.parallel.tp import make_tp_mesh, tp_decode_fn, tp_encode_fn, tp_module
    from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
    from wealy_tpu_torch.train.state import TrainState
    from wealy_tpu_torch.train.step import make_train_step

    lines = []
    say = lines.append
    clews = get_loss("clews")
    mesh = make_mesh(device=device)
    dev = mesh.device
    cfg = _tiny()
    B = 2 * n
    mel = np.random.default_rng(0).normal(size=(B, cfg.n_mels, 32)).astype(np.float32)

    def one_step(state, mesh_, batch, accum=1, call=encoder_head_call):
        if mesh_ is None:  # a mesh step places its own rows
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        return make_train_step(None, clews, mesh=mesh_, model_call=call,
                               grad_accum=accum)(state, batch)

    # data-parallel train step of encoder + head, and its GradCache form
    _, want = one_step(_encoder_head_state(cfg, dev), None, _batch(mel))
    state, got = one_step(_encoder_head_state(cfg, dev), mesh, _batch(mel))
    loss = float(got["loss"])
    _require(np.isfinite(loss) and abs(loss - float(want["loss"])) < 1e-5,
             f"dp train step loss {loss} vs one rank {float(want['loss'])}")
    _require(state.step == 1, "dp train step did not count")
    say(f"dryrun_multichip({n}): dp train step ok, loss={loss:.4f}")
    _, got_a = one_step(_encoder_head_state(cfg, dev), mesh, _batch(mel), accum=2)
    _require(abs(float(got_a["loss"]) - loss) < 1e-4, f"grad_accum=2 loss {float(got_a['loss'])}")
    say(f"dryrun_multichip({n}): dp grad_accum=2 train step ok (loss matches single-pass, "
        f"{float(got_a['loss']):.4f})")

    if n % 2 == 0:
        # tensor parallel (and sequence parallel) encode, the TP train step
        mesh2d = make_tp_mesh(2, device=device)
        enc = _encoder_head_state(cfg, dev).model.encoder
        with torch.no_grad():
            want_enc = enc(torch.from_numpy(mel).to(dev)).cpu()
            errs = [float((tp_encode_fn(enc, mesh2d, sequence_parallel=sp)(
                torch.from_numpy(mel)).cpu() - want_enc).abs().max()) for sp in (False, True)]
        _require(max(errs) < 1e-4, f"TP / SP encoder mismatch {errs}")
        say(f"dryrun_multichip({n}): tp encode ok on (data={n // 2}, model=2) mesh, "
            f"max_err={errs[0]:.2e}")
        say(f"dryrun_multichip({n}): sp encode ok (time axis sharded over model, "
            f"max_err={errs[1]:.2e})")
        plain = _encoder_head_state(cfg, dev)
        model = EncoderHead(tp_module(plain.model.encoder, mesh2d), plain.model.head)
        _, got_tp = one_step(TrainState(model, plain.tx), mesh2d, _batch(mel))
        _, want_tp = one_step(_encoder_head_state(cfg, dev), None, _batch(mel))
        _require(abs(float(got_tp["loss"]) - float(want_tp["loss"])) < 1e-5,
                 f"TP train loss {float(got_tp['loss'])} vs {float(want_tp['loss'])}")
        say(f"dryrun_multichip({n}): tp train step ok on (data={n // 2}, model=2) mesh, "
            f"loss={float(got_tp['loss']):.4f}")

        # pipeline parallel encode (GPipe over 2 stages) and its train step
        cfg_pp = _tiny(n_layer=2)
        mesh_pp = make_pp_mesh(2, n_data=n // 2, device=device)
        mel_pp = np.random.default_rng(5).normal(
            size=(4 * (n // 2), cfg_pp.n_mels, 32)).astype(np.float32)
        st_pp = _encoder_head_state(cfg_pp, dev)
        pp = pp_encode_fn(st_pp.model.encoder, mesh_pp, n_micro=2)
        with torch.no_grad():
            err_pp = float((pp(torch.from_numpy(mel_pp)).cpu()
                            - st_pp.model.encoder(torch.from_numpy(mel_pp).to(dev)).cpu()
                            ).abs().max())
        _require(err_pp < 1e-4, f"PP encoder mismatch {err_pp}")
        say(f"dryrun_multichip({n}): pp encode ok on (data={n // 2}, stage=2) mesh "
            f"(2 microbatches, max_err={err_pp:.2e})")

        def call_pp(model, batch):
            states = pp.local(batch["emb"])
            return model.head(states.float(), torch.ones(states.shape[:2], dtype=torch.bool,
                                                         device=states.device))

        _, want_pp = one_step(_encoder_head_state(cfg_pp, dev), None, _batch(mel_pp))
        _, got_pp = one_step(st_pp, mesh_pp, _batch(mel_pp), call=call_pp)
        _require(abs(float(got_pp["loss"]) - float(want_pp["loss"])) < 1e-5,
                 f"PP train loss {float(got_pp['loss'])} vs {float(want_pp['loss'])}")
        say(f"dryrun_multichip({n}): pp train step ok (grads through the send/recv "
            f"schedule, loss={float(got_pp['loss']):.4f})")

    # data-parallel and TP greedy decode
    dec = Whisper(cfg, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(2)).to(dev).eval()
    mel_d = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, cfg.n_mels, 32)).astype(np.float32))
    prompt, eot = [1, 2, 3], cfg.n_vocab - 1

    @torch.no_grad()
    def decode(m):
        out = greedy_decode(dec, dec.encode(m.to(dec.device)), cfg, prompt=prompt, max_len=6,
                            eot=eot)
        return out["hidden"], out["tokens"]

    h1, t1 = (t.cpu() for t in decode(mel_d))
    h_dp, t_dp = shard_rows(mesh, decode)(mel_d)
    err_h = float((h_dp.cpu() - h1).abs().max())
    _require(torch.equal(t_dp.cpu(), t1) and err_h < 1e-4, f"dp decode: hidden err {err_h}")
    say(f"dryrun_multichip({n}): dp greedy decode ok (B={B} sharded over data axis, hidden "
        f"max_err={err_h:.2e})")
    if n % 2 == 0:
        out = tp_decode_fn(dec, make_tp_mesh(2, device=device), cfg, prompt, max_len=6,
                           eot=eot)(mel_d)
        err_tp = float((out["hidden"].cpu() - h1).abs().max())
        _require(torch.equal(out["tokens"].cpu(), t1) and err_tp < 1e-4,
                 f"tp decode: hidden err {err_tp}")
        say(f"dryrun_multichip({n}): tp greedy decode ok on (data={n // 2}, model=2) mesh, "
            f"hidden max_err={err_tp:.2e}")

    # sharded retrieval: distance, top-k, the streamed ranks
    rng = np.random.default_rng(1)
    n_songs, dim = 6 * n + 3, 16
    labels = np.arange(n_songs) // 3
    z = rng.normal(size=(n_songs, dim)).astype(np.float32)
    z += 2.0 * rng.normal(size=(n_songs // 3 + 1, dim)).astype(np.float32)[labels]
    d_single = pairwise_distance_matrix(torch.from_numpy(z), torch.from_numpy(z), mode="cossim")
    err = float((sharded_pairwise_distance(z, z, mesh, mode="cossim").cpu()
                 - d_single).abs().max())
    vals, _ = sharded_topk(z, z, mesh, k=4, mode="cossim")
    err_k = float((vals.cpu() - d_single.sort(dim=1, descending=True).values[:, :4]).abs().max())
    ranks, n_rel = streaming_relevant_ranks(z, z, labels, labels, mesh=mesh, mode="cossim",
                                            block_size=8, query_block=2 * n)
    got_m = map_from_ranks(ranks, n_rel)
    want_m = rank_metrics(-d_single.numpy(), labels, labels)
    _require(err < 1e-5 and err_k < 1e-5, f"sharded similarity {err}, topk {err_k}")
    _require(abs(got_m["MAP"] - want_m["MAP"]) < 1e-9 and abs(got_m["MR1"] - want_m["MR1"])
             < 1e-9, f"streamed MAP {got_m} vs {want_m}")
    say(f"dryrun_multichip({n}): sharded retrieval ok (similarity max_err={err:.2e}, topk "
        f"max_err={err_k:.2e}, streaming MAP={got_m['MAP']:.4f} == single-device)")

    if n % 2 == 0:
        # ring attention on (data, cp)
        bq, tq = 2 * (n // 2), 4 * n
        rr = np.random.default_rng(7)
        q, k, v = (torch.from_numpy(rr.normal(size=(bq, tq, 2, 8)).astype(np.float32))
                   for _ in range(3))
        scale = 1.0 / np.sqrt(8)
        got_r = ring_attention(q, k, v, scale, make_cp_mesh(2, n_data=n // 2, device=device))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        want_r = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        err_r = float((got_r.cpu() - want_r).abs().max())
        _require(err_r < 1e-5, f"ring attention mismatch {err_r}")
        say(f"dryrun_multichip({n}): ring attention ok on (data={n // 2}, cp=2) mesh, "
            f"max_err={err_r:.2e}")

    # the sharded serving scorer: corpus chunk sets row-sharded, each rank
    # scoring its blocks (bpwr through K4 on a card), the distances gathered
    blk, s1, s2 = 4, 6, 5
    n_corpus = blk * n * 2
    qsets = rng.normal(size=(1, s1, dim)).astype(np.float32)
    qmask = np.ones((1, s1), bool)
    qmask[0, -1] = False
    csets = rng.normal(size=(n_corpus, s2, dim)).astype(np.float32)
    cmask = rng.random((n_corpus, s2)) < 0.9
    cmask[:, 0] = True
    dev = mesh.device
    loc_sets = local_chunk(mesh, torch.from_numpy(csets), "data", 0).to(dev)
    loc_mask = local_chunk(mesh, torch.from_numpy(cmask), "data", 0).to(dev)
    q_t, qm_t = torch.from_numpy(qsets).to(dev), torch.from_numpy(qmask).to(dev)
    d_loc = torch.cat([song_distance_matrix_torch(q_t, qm_t, loc_sets[b : b + blk],
                                                  loc_mask[b : b + blk], redux="bpwr")
                       for b in range(0, loc_sets.shape[0], blk)], dim=1)
    d_serve = all_gather(mesh, d_loc, "data", dim=1).cpu().numpy()[0]
    d_want = song_distance_matrix(qsets, qmask, csets, cmask, redux="bpwr", device=dev)[0]
    err_s = float(np.abs(d_serve - d_want).max())
    _require(err_s < 1e-5, f"sharded serving scorer mismatch {err_s}")
    say(f"dryrun_multichip({n}): sharded serving scorer ok ({n_corpus} songs row-sharded, "
        f"max_err={err_s:.2e})")
    return lines


def _dryrun_rank(rank: int, n: int, port: int, backend: str, device: str, out: str) -> None:
    """One rank of :func:`dryrun_multichip`: join the group, run the
    stages, write the printed lines to ``out``."""
    from wealy_tpu_torch.parallel.multihost import initialize_multihost

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products against f32 references
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_multihost(f"127.0.0.1:{port}", n, rank, backend=backend, timeout_s=300)
    lines = _stages(n, device)
    Path(out).write_text(json.dumps(lines))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None, deadline_s: float = 600.0) -> list:
    """Run every stage on ``n_devices`` ranks, one process each, and hold
    each against the one-rank result; prints and returns rank 0's lines.
    ``device=None`` (or "cuda"): one card per rank over NCCL, and fewer
    cards than ranks raise; ``device="cpu"``: gloo processes on the CPU. A
    rank that fails, or does not finish within ``deadline_s``, raises."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {have} card(s) for "
                               f"{n_devices} ranks; pass device='cpu' to run {n_devices} gloo "
                               "processes on the CPU")
    backend = "nccl" if kind == "cuda" else "gloo"
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory(prefix="wealy_dryrun_") as tmp:
        procs = []
        for r in range(n_devices):
            code = (f"from wealy_tpu_torch.graft_entry import _dryrun_rank; "
                    f"_dryrun_rank({r}, {n_devices}, {port}, {backend!r}, {kind!r}, "
                    f"{str(Path(tmp) / f'rank{r}.json')!r})")
            log = open(Path(tmp) / f"rank{r}.log", "w")
            procs.append((subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                           stdout=log, stderr=subprocess.STDOUT), log))
        end = time.monotonic() + deadline_s
        while time.monotonic() < end and any(p.poll() is None for p, _ in procs):
            time.sleep(0.2)
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
        failed = [(r, p.returncode) for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if failed:
            r = failed[0][0]
            tail = (Path(tmp) / f"rank{r}.log").read_text()[-3000:]
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} failed or passed "
                               f"the {deadline_s:.0f} s deadline; rank {r}:\n{tail}")
        lines = json.loads((Path(tmp) / "rank0.json").read_text())
    for line in lines:
        print(line)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=2, help="ranks of the dry run")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry forward:", tuple(out.shape), out.dtype)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
