"""Command-line entry of the port: ``validate-data``, ``extract``,
``transcribe``, ``pack``, ``train``, ``evaluate``, the serving commands
``index``, ``query`` and ``serve``, and ``doctor``.

    python -m wealy_tpu_torch.cli.main validate-data --config conf.json
    python -m wealy_tpu_torch.cli.main extract --config conf.json --split train \\
        [--kinds x_concat,hs_last_seq|hs_clews] [--batched [--batch-size N] [--pack-direct]] \\
        [--pack] [--cross-kv-f8] [--self-kv-f8] [--quant-int8] [--profile DIR]
    python -m wealy_tpu_torch.cli.main transcribe --config conf.json --split train \\
        [--tokenizer-dir DIR] [--greedy [--batched [--batch-size N]]] [--beam-size K] \\
        [--initial-prompt TEXT] [--language L] [--max-len N] [--limit N] [--overwrite]
    python -m wealy_tpu_torch.cli.main pack --config conf.json [--split test] [--kind F.npz]
    python -m wealy_tpu_torch.cli.main train --config conf.json [--max-steps N] [--fresh] \\
        [--profile DIR]
    torchrun --nproc-per-node N -m wealy_tpu_torch.cli.main train --config conf.json
    python -m wealy_tpu_torch.cli.main evaluate --config conf.json --split test \\
        [--redux bpwr] [--streaming [--chunk-sets]] [--test-mode] [--checkpoint PATH] \\
        [--profile DIR]
    python -m wealy_tpu_torch.cli.main index --config conf.json --split test --out idx.npz
    python -m wealy_tpu_torch.cli.main query --config conf.json --index idx.npz \\
        (--audio A.wav ... | --query-embeddings Q.npz ...) [--rerank R] [--quantize int8]
    python -m wealy_tpu_torch.cli.main serve --config conf.json --index idx.npz [--port P]
    python -m wealy_tpu_torch.cli doctor [--config conf.json] [--backend-timeout S]

The counterpart of ``wealy_tpu.cli.main`` for these commands, with the JAX
parser's flags plus ``--device {cuda,cpu}`` (default ``cuda``: without a
card the command exits with an error unless ``--device cpu`` is given).
``extract`` writes per-version ``{kind}.npz`` files (one song at a time, or
chunks of many songs per device batch with ``--batched``) and ``pack``
writes the packed mmap store; both write the JAX package's formats.
``extract --kinds hs_clews`` writes the CLEWS trio (``hs_clews``,
``hs_clews_avg``, ``hs_clews_mask``) of every version through the CQT and
the window encoder (``models/clews_extract.py``; seeded torch weights).
``extract --batched`` of a decoder kind takes ``--cross-kv-f8`` /
``--self-kv-f8`` (float8 storage of the decode's cross K/V and self caches;
the one-song-at-a-time path ignores them, as the JAX CLI does).
``extract --batched --quant-int8`` runs the W8A8 int8 encoder
(``models/whisper/quant.py``) for the encoder kind.

Launched with a world size above 1 (``torchrun --nproc-per-node N``, one
process per card; NCCL on the cards, gloo with ``--device cpu`` or where
ranks share a card), ``extract --batched``, ``transcribe --batched`` and
``evaluate`` run on a data mesh (``parallel/``): every rank takes the same
batches, each computes its rows and the rows are gathered, and rank 0
alone writes files and prints the JSON line. ``extract --batched --tp N``
decodes the ``hs_last*`` kinds with the tensor-parallel Whisper over a
(data, model) mesh, N ranks to a model (``parallel/tp.py``).
``query`` / ``serve --shard`` split the resident corpus over the ranks
(``cli/serve.py``).
``transcribe`` writes the reference's ``.txt`` trees and the validity
census (``cli/transcribe.py``): Whisper's long-form algorithm by default,
``--greedy`` per-chunk decoding (``--batched``: chunks of many songs per
device batch), ``--beam-size`` beam search on the deterministic rung.
``train`` trains the head of ``model.name`` on stored embeddings (all seven
names: the ``whisper`` head, and the fusion models on the multimodal
datasets and collates) with the configured loss (clews, ntxent, triplet),
AdamW, ``train.grad_accum``, the val-split MAP hook every
``train.eval_every`` steps and ``torch.save`` checkpoints in
``path.checkpoints`` (resumed unless ``--fresh``); it prints one JSON line.
Launched with a world size above 1 (``torchrun``), ``train`` runs data
parallel, one process a card (``parallel/``): the state is broadcast from
rank 0, each rank embeds its rows of every batch, the loss runs over the
gathered global batch, and only rank 0 writes checkpoints, metrics and the
JSON line.
``evaluate --checkpoint`` takes a head state-dict file, a ``train``
checkpoint payload, or a checkpoint directory (its newest step); the JAX
package's orbax directories need JAX to read. Without one the head is
initialised from ``torch.Generator`` seed 0 (``models/heads.py::
seeded_init_``), which is not the JAX package's init; the fusion models,
as in JAX, fall back to ``path.checkpoints`` first. A fusion model scores
one fused vector per song by cosine, or with ``--test-mode`` every chunk of
a song (WEALY chunks, or overlapping whisper windows) as a chunk set
through ``--redux`` (K4 for ``bpwr``); ``--test-mode`` leaves the
``whisper`` head's evaluate as it is, as in JAX. The serving commands live
in :mod:`wealy_tpu_torch.cli.serve`. ``--profile DIR`` (``extract``,
``train``, ``evaluate``) writes a ``torch.profiler`` trace of the whole
command into DIR. ``doctor`` prints one JSON report of the environment, the
card and a project (:mod:`wealy_tpu_torch.cli.doctor`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.utils.hostmem import trim_host_heap

AUTO_STREAM_THRESHOLD = 2000


TRIM_EVERY = 32


def _trim_heap(group: int) -> None:
    """After every ``TRIM_EVERY``-th song group of a streaming loop, release
    the free glibc heap (``utils/hostmem.py``: the loops' multi-MB transients
    interleaved with small long-lived rows leave heap that is never
    returned). Frees memory only; no value changes."""
    if group % TRIM_EVERY == TRIM_EVERY - 1:
        trim_host_heap()


def _load_config(path: str):
    from wealy_tpu_torch.train.config import Config

    return Config.from_file(path)  # YAML (OmegaConf-style) or JSON


def _auto_streaming(args, n_songs: int, exact_chunk_sets: bool = False) -> None:
    """Select the streaming ranking path above ``AUTO_STREAM_THRESHOLD``
    songs (the monolithic path pads every chunk set into one (S, S) redux);
    ``exact_chunk_sets`` also selects --chunk-sets, so that the streamed
    ranking is the same chunk-set --redux scoring. ``--no-streaming`` keeps
    the monolithic path."""
    if args.streaming or getattr(args, "no_streaming", False):
        return
    if n_songs <= AUTO_STREAM_THRESHOLD:
        return
    args.streaming = True
    if exact_chunk_sets:
        args.chunk_sets = True
    print(
        f"[evaluate] {n_songs} songs > {AUTO_STREAM_THRESHOLD}: auto-selected --streaming"
        + (" --chunk-sets" if exact_chunk_sets else "")
        + " (identical metrics, bounded memory; pass --no-streaming to force the "
        "monolithic path)",
        file=sys.stderr,
    )


def _set_block_size(smax: int, budget_mb: float = 64.0) -> int:
    """Block edge for chunk-set streaming: the transient (block, block,
    smax, smax) f32 redux tensor stays within ``budget_mb``."""
    b = int(math.sqrt(budget_mb * 1e6 / max(1, smax * smax) / 4))
    return max(16, min(2048, b))


def _pad_chunk_sets(all_sets, all_masks, n_rows):
    """Per-group (S_g, s_g, C) chunk sets -> one (S, smax, C) array and its
    True=valid mask, every group padded to the largest chunk count."""
    max_chunks = max(s.shape[1] for s in all_sets)
    sets = np.zeros((n_rows, max_chunks, all_sets[0].shape[-1]), np.float32)
    set_mask = np.zeros((n_rows, max_chunks), bool)
    row = 0
    for s, m in zip(all_sets, all_masks):
        sets[row : row + s.shape[0], : s.shape[1]] = s
        set_mask[row : row + s.shape[0], : s.shape[1]] = m
        row += s.shape[0]
    return sets, set_mask


def cmd_validate_data(args) -> int:
    from wealy_tpu_torch.data.dataset import build_clean_dataset, validate_data_structures

    config = _load_config(args.config)
    md, _ = build_clean_dataset(config, verbose=True, check_audio=args.check_audio)
    reports = {s: validate_data_structures(md, s) for s in ("train", "val", "test")}
    print(json.dumps(reports, indent=2))
    return 0 if all(r["ok"] for r in reports.values()) else 1


def _lazy(factory):
    """An embed function built on its first call, so that a run whose every
    version is already stored loads no model."""
    fn = None

    def call(audio):
        nonlocal fn
        if fn is None:
            fn = factory()
        return fn(audio)

    return call


def cmd_extract(args) -> int:
    """Extract embeddings of a split into the store (or, with
    ``--pack-direct``, straight into the pack); one JSON line."""
    from wealy_tpu_torch.cli.extract import extract_split
    from wealy_tpu_torch.data.dataset import build_clean_dataset

    kinds = args.kinds.split(",")
    kind = kinds[0]
    if args.pack_direct and not args.batched:
        print("[extract] --pack-direct requires --batched", file=sys.stderr)
        return 2
    if args.quant_int8 and (not args.batched or kind.startswith("hs_")):
        print("[extract] --quant-int8 requires --batched and an encoder kind (x_concat)",
              file=sys.stderr)
        return 2
    if args.pack_direct and args.pack:
        # --pack re-packs from the per-version store, which --pack-direct never
        # writes: composing them would overwrite the direct pack with stale rows
        print("[extract] --pack and --pack-direct are mutually exclusive (--pack-direct "
              "already produces the pack)", file=sys.stderr)
        return 2
    if args.pack_direct and kind == "hs_last_all":
        print("[extract] --pack-direct unsupported for hs_last_all (two-array payload); use "
              "--pack", file=sys.stderr)
        return 2
    if args.pack_direct and _world() > 1:
        print("[extract] --pack-direct is single-process only (each rank would write its own "
              "pack); extract, then `pack`", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    config = _load_config(args.config)
    md, _ = build_clean_dataset(config, check_audio=True)
    if kind == "hs_clews":
        from wealy_tpu_torch.models.clews_extract import extract_clews_split

        result = extract_clews_split(config, md, args.split, limit=args.limit,
                                     overwrite=args.overwrite, device=device)
        print(json.dumps({k: len(v) for k, v in result.items()}))
        return 0 if not result["failed"] else 1
    if not args.batched:
        result = extract_split(config, md, args.split, kinds=tuple(kinds),
                               hf_checkpoint=args.hf_checkpoint, limit=args.limit,
                               overwrite=args.overwrite, device=device)
        print(json.dumps({k: len(v) for k, v in result.items()}
                         | {"failed_keys": result["failed"][:20]}))
        if args.pack:
            for k in kinds:
                _pack_kind(config, md, k)
        return 0 if not result["failed"] else 1

    from wealy_tpu_torch.cli import extract_batched as eb

    mesh = process_mesh(args.device)
    sink = skip_fn = writer = None
    if args.pack_direct:
        # completed songs stream straight into the pack; a resume carries the
        # old pack's rows forward, and readers see the old pack until close()
        from wealy_tpu_torch.data.packed_store import PackedStore, PackWriter

        root, name = config.path.hidden_states, config.data.dataset_name
        writer = PackWriter(root, kind, dataset_name=name)
        old = PackedStore(root, kind, dataset_name=name)
        if old.available:
            carry = list(old.keys())
            if args.overwrite:
                # the pack is shared by every split: drop only this split's rows
                this_split = {v for c in md.splits[args.split].values() for v in c}
                carry = [v for v in carry if v not in this_split]
            n = writer.seed_from(old, carry)
            print(f"[extract] carried {n} packed versions forward", file=sys.stderr)

        def sink(v, **arrays):
            writer.add(v, arrays["embeddings"])

        def skip_fn(v):
            return v in writer

    common = dict(kind=kind, batch_size=args.batch_size, limit=args.limit,
                  overwrite=args.overwrite, sink=sink, skip_fn=skip_fn, mesh=mesh)
    # a failure mid-run drops the temporary pack (the writer's exit) and goes
    # on; the old pack stays
    with writer or contextlib.nullcontext():
        if kind.startswith("hs_last"):
            language = 0 if kind.endswith("_en") else None
            decode_fn = _lazy(lambda: eb.make_decoder_embed_fn(
                config, args.hf_checkpoint, language=language, cross_kv_f8=args.cross_kv_f8,
                self_kv_f8=args.self_kv_f8, mesh=None if args.tp > 1 else mesh, tp=args.tp,
                device=device))
            result = eb.extract_split_batched_decoder(config, md, args.split, decode_fn,
                                                      **common)
        else:
            if kind == "hs_wealy_concat":
                embed_fn = _lazy(lambda: eb.make_wealy_embed_fn(
                    config, args.hf_checkpoint, device=device))
            else:
                embed_fn = _lazy(lambda: eb.make_encoder_embed_fn(
                    config, args.hf_checkpoint, quant_int8=args.quant_int8, device=device))
            result = eb.extract_split_batched(config, md, args.split, embed_fn, **common)
    if writer is not None:
        packed = writer.close()
        print(f"[extract] pack closed: {len(packed)} versions in {packed.bin_path.name}",
              file=sys.stderr)
    if mesh is None or mesh.is_primary:
        print(json.dumps({"done": len(result["done"]), "skipped": result["skipped"],
                          "incomplete": result["incomplete"],
                          "throughput": result["throughput"]}))
        if args.pack:
            # packing depends only on what is on disk, not on what this run extracted
            _pack_kind(config, md, kind)
    close_mesh(mesh)
    return 0 if not result["incomplete"] else 1


def cmd_transcribe(args) -> int:
    """Transcribe a split into the .txt tree and run the census; the JAX
    CLI's refusals (exit 2) and its one JSON line."""
    from wealy_tpu_torch.cli.transcribe import transcribe_split, transcribe_split_batched
    from wealy_tpu_torch.data.dataset import build_clean_dataset

    config = _load_config(args.config)
    if args.initial_prompt and (args.greedy or args.batched):
        print("[transcribe] --initial-prompt needs the long-form path (<|startofprev|> "
              "context); drop --greedy/--batched", file=sys.stderr)
        return 2
    if args.initial_prompt and not args.tokenizer_dir:
        print("[transcribe] --initial-prompt requires --tokenizer-dir (the text must be "
              "tokenized)", file=sys.stderr)
        return 2
    md, _ = build_clean_dataset(config, check_audio=True)
    if args.batched and not args.greedy:
        print("[transcribe] --batched implies greedy per-chunk decoding (long-form context "
              "carry-over serializes each song); pass --greedy to acknowledge", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    common = dict(tokenizer_dir=args.tokenizer_dir,
                  language=None if args.language < 0 else args.language,
                  max_len=args.max_len, limit=args.limit, overwrite=args.overwrite,
                  hf_checkpoint=args.hf_checkpoint, beam_size=args.beam_size, device=device)
    mesh = None
    if args.batched:
        mesh = process_mesh(args.device)
        result = transcribe_split_batched(config, md, args.split, batch_size=args.batch_size,
                                          n_workers=args.n_workers, mesh=mesh, **common)
    else:
        result = transcribe_split(config, md, args.split, longform=not args.greedy,
                                  initial_prompt=args.initial_prompt, **common)
    summary = {k: len(result[k]) for k in ("done", "skipped", "failed")}
    summary.update({k: result[k] for k in ("n_valid", "n_total", "cache_file")})
    if "throughput" in result:
        summary["throughput"] = result["throughput"]
    if mesh is None or mesh.is_primary:
        print(json.dumps(summary))
    close_mesh(mesh)
    return 0 if not result["failed"] else 1


def _pack_kind(config, md, kind: str) -> None:
    """Pack one kind over every split (the pack is shared by the splits: a
    per-split pack would drop the others' rows)."""
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.data.packed_store import pack_from_store

    store = EmbeddingStore(config.path.hidden_states, config.data.dataset_name)
    versions = sorted(v for s in ("train", "val", "test") for c in md.splits[s].values()
                      for v in c)
    packed = pack_from_store(store, versions, f"{kind}.npz", config.path.hidden_states,
                             dataset_name=config.data.dataset_name)
    print(json.dumps({"packed": len(packed), "kind": packed.kind}))


def cmd_pack(args) -> int:
    """Pack per-version embedding files into the mmap format
    (``packed_{dataset}_{kind}.bin`` + manifest beside the per-version
    tree); one JSON line."""
    from wealy_tpu_torch.data.dataset import build_clean_dataset
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.data.packed_store import pack_from_store
    from wealy_tpu_torch.data.paths import embedding_filename

    config = _load_config(args.config)
    md, _ = build_clean_dataset(config)
    store = EmbeddingStore(config.path.hidden_states, config.data.dataset_name)
    filename = args.kind or embedding_filename(config.data.embedding_type,
                                               config.data.embedding_format)
    splits = args.split.split(",") if args.split else ("train", "val", "test")
    versions = sorted(v for s in splits for c in md.splits[s].values() for v in c)
    packed = pack_from_store(store, versions, filename, config.path.hidden_states,
                             dataset_name=config.data.dataset_name)
    print(json.dumps({"kind": packed.kind, "versions_packed": len(packed),
                      "versions_requested": len(versions), "bin": str(packed.bin_path)}))
    return 0 if len(packed) else 1


def read_head_checkpoint(checkpoint) -> tuple[dict, Optional[int]]:
    """(state dict, training step) of a head checkpoint: a state-dict file
    (step None), a ``train`` payload file, or a checkpoint directory whose
    newest payload is read."""
    from wealy_tpu_torch.train.checkpoint import CheckpointManager

    if Path(checkpoint).is_dir():
        sd = CheckpointManager(checkpoint).restore()
    else:
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if "params" in sd and "opt_state" in sd:  # a train payload
        return sd["params"], int(sd["step"])
    return sd, None


def serving_checkpoint(checkpoint, config) -> Optional[str]:
    """The head checkpoint of the serving commands: ``checkpoint``, else
    ``path.checkpoints`` when that directory holds a payload, else None (the
    seeded head), as the JAX package's ``_load_head_params``."""
    from wealy_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = checkpoint or config.path.checkpoints
    if not checkpoint and ckpt and not Path(ckpt).exists():
        return None  # a checkpoint directory not written yet
    if ckpt and Path(ckpt).is_dir() and CheckpointManager(ckpt).latest_step() is None:
        return None
    return ckpt or None


def load_head(config, in_features: int = 1280, checkpoint=None, device=None, **widths):
    """The evaluate head (or fusion model) for ``config.model`` in eval mode
    on ``device``, and its training step: weights from ``checkpoint``
    (:func:`read_head_checkpoint`) or seeded (step None). ``widths``: the
    fusion models' other input widths (``models/registry.py``)."""
    from wealy_tpu_torch.models.heads import seeded_init_
    from wealy_tpu_torch.models.registry import build_model

    device = resolve_device(device)
    model, _ = build_model(config.model.name, zdim=config.model.zdim, in_features=in_features,
                           **widths)
    step = None
    if checkpoint:
        sd, step = read_head_checkpoint(checkpoint)
        model.load_state_dict(sd)
    else:
        seeded_init_(model, seed=0)
    return model.to(device).eval(), step


def embed_split(config, ds, model, *, song_group: int = 64, encode_slab: int = 256,
                pooled: bool = False, device=None):
    """Every version of ``ds``'s split through the head, ``song_group``
    songs at a time (host memory holds one group's chunk tensor).

    Returns (sets, set_masks, labels, ids): per group, the (S_g, s_g, zdim)
    chunk sets and masks, or with ``pooled`` each song's mean chunk vector
    (S_g, zdim) and no masks.
    """
    from wealy_tpu_torch.data.chunking import collate_avg_pool, collate_overlapping
    from wealy_tpu_torch.eval.retrieval import regroup_chunks, slabbed_apply

    versions = list(ds.sampler.versions)
    L = config.data.chunk_size
    G = max(1, song_group)

    def head(items):
        # the group's collated input dies with this call, before the next
        # group is collated
        if config.data.use_avg_pooling:
            # time collapses to one vector per song before the head: a
            # length-1 sequence, one z per song (a 1-chunk set)
            ab = collate_avg_pool(items)
            x = ab.embeddings.reshape(len(items), 1, -1)
            z = slabbed_apply(model, x, np.ones(x.shape[:2], bool), slab_size=encode_slab,
                              device=device)
            return z[:, None, :], ab.masks.reshape(len(items), 1), range(len(items))
        batch = collate_overlapping(items, chunk_size=L, overlap=config.data.overlap_percentage)
        z = slabbed_apply(model, batch.embeddings, batch.masks, slab_size=encode_slab,
                          device=device)
        return regroup_chunks(z, batch.chunk_info, batch.chunk_valid)[:3]

    all_sets, all_masks, labels, ids = [], [], [], []
    for g0 in range(0, len(versions), G):
        items = [
            (ds.sampler.labels[ds.sampler.clique_of[v]],
             [(int(ds.metadata.info[v]["id"]), ds.load_embedding(v))])
            for v in versions[g0 : g0 + G]
        ]
        sets, set_mask, bidx = head(items)
        labels.extend(items[i][0] for i in bidx)
        ids.extend(items[i][1][0][0] for i in bidx)
        if pooled:
            w = set_mask[..., None].astype(np.float32)
            all_sets.append((sets * w).sum(axis=1) / np.maximum(w.sum(axis=1), 1e-9))
        else:
            all_sets.append(sets)
            all_masks.append(set_mask)
        _trim_heap(g0 // G)
    return all_sets, all_masks, np.asarray(labels), np.asarray(ids)


def make_val_eval_fn(config, model, val_ds, val_group: int = 256, device=None):
    """Train-time validation hook: ``eval_fn(state) -> {MAP, MR1}`` over the
    val split with the current head. Versions go through in fixed
    ``val_group`` groups (first window of each, the last group padded by
    repetition and the pad rows dropped), and the ranks stream
    (``streaming_relevant_ranks``); host state is one group plus the
    (S, zdim) matrix."""
    from wealy_tpu_torch.data.chunking import collate_fixed_length
    from wealy_tpu_torch.parallel.similarity import map_from_ranks, streaming_relevant_ranks

    v_versions = list(val_ds.sampler.versions)
    val_group = max(1, min(val_group, len(v_versions)))
    device = resolve_device(device)

    def embed_group(group):
        """(z, labels, ids) of one group; its collated input dies with the call."""
        items = [
            (val_ds.sampler.labels[val_ds.sampler.clique_of[v]],
             [(int(val_ds.metadata.info[v]["id"]), val_ds.load_embedding(v))])
            for v in group
        ]
        keep = len(items)
        items = items + [items[0]] * (val_group - keep)
        vb = collate_fixed_length(items, chunk_size=config.data.chunk_size,
                                  use_random_chunks=False)
        labels, ids, emb, mask = vb.flatten_versions()
        with torch.no_grad():
            z = model(torch.from_numpy(emb).to(device).float(), torch.from_numpy(mask).to(device))
        return z.cpu().numpy()[:keep], labels[:keep], ids[:keep]

    def eval_fn(state):
        zs, lbls, vids = [], [], []
        for g0 in range(0, len(v_versions), val_group):
            z, labels, ids = embed_group(v_versions[g0 : g0 + val_group])
            zs.append(z)
            lbls.append(labels)
            vids.append(ids)
            _trim_heap(g0 // val_group)
        z = np.concatenate(zs, axis=0)
        labels = np.concatenate(lbls)
        ids = np.concatenate(vids)
        ranks, n_rel = streaming_relevant_ranks(z, z, labels, labels, mode="cos",
                                                query_idx=ids, corpus_idx=ids, device=device)
        m = map_from_ranks(ranks, n_rel)
        return {"MAP": m["MAP"], "MR1": m["MR1"]}

    return eval_fn


def _mm_dataset(config, split: str, sig: str, **kwargs):
    """The multimodal dataset of a fusion signature."""
    from wealy_tpu_torch.data.multimodal import WealyClewsDataset, WhisperClewsDataset

    return (WealyClewsDataset if sig == "wealy" else WhisperClewsDataset)(config, split, **kwargs)


def _mm_embed(model, model_call, flat: dict, device) -> np.ndarray:
    """Fused embeddings (f32, host) of a flat multimodal batch."""
    feed = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in flat.items()
            if k not in ("labels", "ids")}
    with torch.no_grad():
        return model_call(model, feed).float().cpu().numpy()


def _mm_embed_group(ds, collate, model, model_call, start: int, stop: int, device):
    """(z, labels, ids) of items ``start:stop`` of a multimodal dataset; the
    group's collated batch dies with the call, before the next is built."""
    from wealy_tpu_torch.train.multimodal import flatten_multimodal_batch

    flat = flatten_multimodal_batch(collate([ds[i] for i in range(start, stop)]))
    return _mm_embed(model, model_call, flat, device), flat["labels"], flat["ids"]


def _mm_embed_all(ds, collate, model, model_call, group: int, device):
    """(z, labels, ids) of every item of a multimodal dataset, ``group``
    items collated and embedded at a time."""
    zs, labels, ids = [], [], []
    for g0 in range(0, len(ds), group):
        z, lbl, vid = _mm_embed_group(ds, collate, model, model_call, g0,
                                      min(g0 + group, len(ds)), device)
        zs.append(z)
        labels.append(lbl)
        ids.append(vid)
        _trim_heap(g0 // group)
    return np.concatenate(zs), np.concatenate(labels), np.concatenate(ids)


def _mm_songs(config, split: str, sig: str, args, device):
    """The split's multimodal dataset (one version per item) and the fusion
    model of ``config`` at the widths of its first item, its weights from
    ``--checkpoint``, else ``path.checkpoints``, else the seeded init:
    (dataset, model, model_call)."""
    from wealy_tpu_torch.cli.serve import _mm_collate_fn, _mm_init_params
    from wealy_tpu_torch.train.multimodal import flatten_multimodal_batch

    ds = _mm_dataset(config, split, sig, n_per_class=1, seed=0)
    probe = flatten_multimodal_batch(_mm_collate_fn(config, sig)([ds[0]]))
    model, model_call, _ = _mm_init_params(config, sig, probe, args.checkpoint, device)
    return ds, model, model_call


def make_val_eval_fn_mm(config, model, model_call, val_ds, sig: str, val_group: int = 256,
                        device=None):
    """Fusion-model train-time validation hook: ``eval_fn(state) -> {MAP,
    MR1}`` over the val split with the current weights, ``val_group``
    versions at a time through the deterministic multimodal collate, the
    ranks streamed (``streaming_relevant_ranks``)."""
    from wealy_tpu_torch.cli.serve import _mm_collate_fn
    from wealy_tpu_torch.parallel.similarity import map_from_ranks, streaming_relevant_ranks

    collate = _mm_collate_fn(config, sig)
    G = max(1, min(val_group, len(val_ds)))
    device = resolve_device(device)

    def eval_fn(state):
        z, labels, ids = _mm_embed_all(val_ds, collate, model, model_call, G, device)
        ranks, n_rel = streaming_relevant_ranks(z, z, labels, labels, mode="cos", query_idx=ids,
                                                corpus_idx=ids, device=device)
        m = map_from_ranks(ranks, n_rel)
        return {"MAP": m["MAP"], "MR1": m["MR1"]}

    return eval_fn


def cmd_train(args) -> int:
    """Train the head on stored embeddings; one JSON line
    ``{"final_step", "final_loss"}``. Launched with a world size above 1
    (``torchrun``), every process trains one replica on its card (gloo
    with ``--device cpu``) over a data-parallel mesh, as the JAX command
    builds a mesh over several devices."""
    from wealy_tpu_torch.data.collate_factory import create_collate_fn
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.losses import get_loss
    from wealy_tpu_torch.models.registry import build_model, model_signature
    from wealy_tpu_torch.train.checkpoint import CheckpointManager
    from wealy_tpu_torch.train.multimodal import (
        build_trainable,
        flatten_multimodal_batch,
        input_widths,
    )
    from wealy_tpu_torch.train.loop import MetricsWriter, fit
    from wealy_tpu_torch.train.state import create_train_state, make_optimizer
    from wealy_tpu_torch.train.step import make_train_step

    mesh = process_mesh(args.device)
    device = resolve_device(args.device) if mesh is None else mesh.device
    config = _load_config(args.config)
    sig = model_signature(config.model.name)
    torch.autograd.set_detect_anomaly(bool(config.train.debug_nans))
    loss_fn = get_loss(config.train.loss, **(config.train.loss_params or {}))
    model_call = make_batch = None
    if sig == "single":
        ds = EmbeddingDataset(config, "train", seed=config.train.seed)
        _, versions = ds[0]
        emb_dim = versions[0][1].shape[-1]
        model, _ = build_model(config.model.name, zdim=config.model.zdim, in_features=emb_dim)
    else:
        ds = _mm_dataset(config, "train", sig, seed=config.train.seed)
        probe = flatten_multimodal_batch(create_collate_fn(config)([ds[0], ds[1]]))
        model, _, model_call = build_trainable(config.model.name, zdim=config.model.zdim,
                                               **input_widths(probe, sig))

        def make_batch(items, brng):
            # this batch's chunk draws come from its (seed, epoch, batch) stream
            return flatten_multimodal_batch(create_collate_fn(config, rng=brng)(items))
    state = create_train_state(
        model.to(device),
        tx=make_optimizer(lr=config.train.lr, weight_decay=config.train.weight_decay,
                          warmup_steps=config.train.warmup_steps,
                          max_steps=config.train.max_steps),
        seed=config.train.seed,
    )
    step = make_train_step(model, loss_fn, mesh=mesh, model_call=model_call,
                           grad_accum=config.train.grad_accum)
    ckpt = CheckpointManager(config.path.checkpoints) if config.path.checkpoints else None
    start_epoch = start_batch = 0
    if ckpt is not None and ckpt.latest_step() is not None and not args.fresh:
        state = ckpt.restore_state(state)
        dstate = ckpt.restore_data_state(state.step) or {}
        if (dstate.get("data_seed") == config.train.seed
                and int(dstate.get("batch_size", -1)) == int(config.train.batch_size)):
            start_epoch = int(dstate.get("epoch", 0))
            start_batch = int(dstate.get("next_batch", 0))
        print(f"resumed full state from step {state.step} (epoch {start_epoch}, batch "
              f"{start_batch})", file=sys.stderr)
    if mesh is not None:
        from wealy_tpu_torch.parallel.mesh import replicate_state

        replicate_state(mesh, state)  # every replica starts from rank 0's state
    primary = mesh is None or mesh.is_primary
    eval_fn = None
    val_group = int(config.train.val_group) or max(4, int(config.train.batch_size))
    if sig == "single":
        val_ds = EmbeddingDataset(config, "val", seed=0)
        if len(val_ds) >= 4:
            eval_fn = make_val_eval_fn(config, model, val_ds, val_group=val_group, device=device)
    else:
        val_ds = _mm_dataset(config, "val", sig, n_per_class=1, seed=0)
        if len(val_ds) >= 4:
            eval_fn = make_val_eval_fn_mm(config, model, model_call, val_ds, sig,
                                          val_group=val_group, device=device)
    writer = MetricsWriter(log_every=config.train.log_every if primary else 0,
                           jsonl_path=(config.train.metrics_jsonl or None) if primary else None)
    state, writer = fit(
        state, step, ds.sampler,
        batch_size=config.train.batch_size,
        chunk_size=config.data.chunk_size,
        max_steps=args.max_steps or config.train.max_steps,
        writer=writer,
        checkpoint_manager=ckpt,
        checkpoint_every=config.train.checkpoint_every,
        eval_fn=eval_fn,
        eval_every=config.train.eval_every,
        data_seed=config.train.seed,
        start_epoch=start_epoch,
        start_batch=start_batch,
        make_batch=make_batch,
        mesh=mesh,
    )
    writer.close()
    # the last record may be a val_* entry: report the last train loss
    last = next((h for h in reversed(writer.history) if "loss" in h), {})
    if primary:
        print(json.dumps({"final_step": int(state.step), "final_loss": last.get("loss")}))
    close_mesh(mesh)
    return 0


def _world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def process_mesh(device: str):
    """The data mesh of a command launched with a world size above 1
    (``torchrun``: NCCL where each process has a card of its own, gloo with
    ``--device cpu`` or where processes share a card), else None: one
    process, no mesh."""
    if _world() <= 1:
        return None
    from wealy_tpu_torch.parallel.mesh import make_mesh
    from wealy_tpu_torch.parallel.multihost import initialize_multihost

    resolve_device(device)  # the no-card refusal comes first
    initialize_multihost(backend="gloo" if device == "cpu" else None)
    return make_mesh(device=device)


def close_mesh(mesh) -> None:
    """Every rank meets, then the process group ends (no-op without a mesh)."""
    if mesh is not None:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


def evaluate(args, mesh=None) -> dict:
    """The ``evaluate`` command's metrics (MAP, MR1, P@10, n_queries).
    ``mesh``: the data mesh the head's slabs and the streamed ranks shard
    over (single-modal models; every rank returns the metrics)."""
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.models.registry import model_signature
    from wealy_tpu_torch.parallel.mesh import shard_rows
    from wealy_tpu_torch.parallel.similarity import map_from_ranks, streaming_relevant_ranks

    device = resolve_device(args.device) if mesh is None else mesh.device
    config = _load_config(args.config)
    sig = model_signature(config.model.name)
    if sig != "single":
        if args.test_mode:
            return _evaluate_mm_test_mode(args, config, sig, device)
        return _evaluate_multimodal(args, config, sig, device)
    ds = EmbeddingDataset(config, args.split, seed=0)
    versions = list(ds.sampler.versions)
    _auto_streaming(args, len(versions), exact_chunk_sets=True)
    emb_dim = ds.load_embedding(versions[0]).shape[-1]
    model, _ = load_head(config, emb_dim, args.checkpoint, device)
    pooled = args.streaming and not args.chunk_sets
    # on a mesh a slab's rows shard over the ranks and the streamed ranks
    # shard their queries (the slab size is the same either way)
    all_sets, all_masks, labels, ids = embed_split(
        config, ds, shard_rows(mesh, model), song_group=args.song_group,
        encode_slab=args.encode_slab, pooled=pooled, device=device,
    )
    if pooled:
        # corpus-scale ranks over pooled song vectors
        vecs = np.concatenate(all_sets, axis=0)
        ranks, n_rel = streaming_relevant_ranks(
            vecs, vecs, labels, labels, mode="cos", query_idx=ids, corpus_idx=ids, device=device,
            mesh=mesh,
        )
        return map_from_ranks(ranks, n_rel, topk=(10,))
    # exact chunk-set ranking; streamed, the transient device tensor is one
    # (block, block, s, s) distance block
    sets, set_mask = _pad_chunk_sets(all_sets, all_masks, len(labels))
    return _chunk_set_metrics(args, sets, set_mask, labels, ids, device, mesh)


def _chunk_set_metrics(args, sets, set_mask, labels, ids, device, mesh=None) -> dict:
    """MAP/MR1/P@10 of chunk sets through ``--redux``: one (S, S) redux, or
    with ``--streaming`` block-streamed ranks (no (S, S) matrix)."""
    from wealy_tpu_torch.eval.retrieval import evaluate_retrieval
    from wealy_tpu_torch.parallel.similarity import map_from_ranks, streaming_relevant_ranks

    if args.streaming:
        blk = _set_block_size(sets.shape[1])
        ranks, n_rel = streaming_relevant_ranks(
            sets, sets, labels, labels, mode="cos", redux=args.redux, query_mask=set_mask,
            corpus_mask=set_mask, block_size=blk, query_block=blk, query_idx=ids,
            corpus_idx=ids, device=device, mesh=mesh,
        )
        return map_from_ranks(ranks, n_rel, topk=(10,))
    metrics = evaluate_retrieval(sets, set_mask, labels, version_ids=ids, redux=args.redux,
                                 device=device)
    metrics.pop("_dist")
    return metrics


def _evaluate_multimodal(args, config, sig: str, device) -> dict:
    """Fusion-model evaluation: one fused embedding per song (deterministic
    collate, one version per item, fp16 round trip as in training), all
    pairs by cosine; ``--song-group`` songs are collated and embedded at a
    time, and ``--streaming`` streams the ranks."""
    from wealy_tpu_torch.cli.serve import _mm_collate_fn
    from wealy_tpu_torch.eval.wealy import evaluate_song_embeddings
    from wealy_tpu_torch.parallel.similarity import map_from_ranks, streaming_relevant_ranks

    ds, model, model_call = _mm_songs(config, args.split, sig, args, device)
    _auto_streaming(args, len(ds), exact_chunk_sets=False)
    collate = _mm_collate_fn(config, sig)
    G = max(1, min(args.song_group, len(ds)))
    z, labels, ids = _mm_embed_all(ds, collate, model, model_call, G, device)
    if args.streaming:
        ranks, n_rel = streaming_relevant_ranks(z, z, labels, labels, mode="cos", query_idx=ids,
                                                corpus_idx=ids, device=device)
        return map_from_ranks(ranks, n_rel, topk=(10,))
    return evaluate_song_embeddings(z, labels, version_ids=ids, device=device)


def _song_chunks(sig: str, mm: dict, L: int, stride: int):
    """A song's test-mode chunks and their (n, L) or (n, 1) valid masks:
    every WEALY chunk, or the overlapping whisper windows (windows fully
    inside the sequence, zero-copy views; a sequence shorter than one
    window gives one zero-padded chunk)."""
    if sig == "wealy":
        chunks = np.atleast_2d(np.asarray(mm["wealy"]["embeddings"], np.float32))
        return chunks, np.ones((chunks.shape[0], 1), bool)
    seq = np.asarray(mm["whisper_seq"], np.float32)
    T, C = seq.shape
    if T <= L:
        w, v = np.zeros((1, L, C), np.float32), np.zeros((1, L), bool)
        w[0, :T], v[0, :T] = seq, True
        return w, v
    chunks = np.lib.stride_tricks.sliding_window_view(seq, L, axis=0)[::stride].transpose(0, 2, 1)
    return chunks, np.ones((chunks.shape[0], L), bool)


def _mm_embed_chunks(sig: str, songs: list, refs: list, model, model_call, device) -> np.ndarray:
    """Fused embeddings of the test-mode chunks ``refs`` ([(song, chunk)])
    of ``songs`` ([(chunks, valid, full_clews, clews_mask)]), each with its
    song's CLEWS context; the stacked slab dies with the call."""
    w = np.stack([songs[si][0][ci] for si, ci in refs])
    feed = {"full_clews": np.stack([songs[si][2] for si, _ in refs]),
            "clews_mask": np.stack([songs[si][3] for si, _ in refs])}
    if sig == "wealy":
        feed["wealy"] = w
    else:
        feed["whisper_seq"] = w
        feed["whisper_mask"] = ~np.stack([songs[si][1][ci] for si, ci in refs])
    return _mm_embed(model, model_call, feed, device)


def _evaluate_mm_test_mode(args, config, sig: str, device) -> dict:
    """Fusion-model test mode: ALL chunks of every song (the precomputed
    WEALY chunks, or overlapping whisper windows), each embedded with the
    song's CLEWS context in f32 (no fp16 round trip, as in JAX), and the
    per-song z chunk sets scored through ``--redux`` (K4 for ``bpwr``).
    Songs go in ``--song-group`` groups and chunks in ``--encode-slab``
    slabs, so host memory holds one group's sequences plus the z sets."""
    ds, model, model_call = _mm_songs(config, args.split, sig, args, device)
    _auto_streaming(args, len(ds), exact_chunk_sets=False)
    L = config.data.chunk_size
    stride = max(1, L - int(L * config.data.overlap_percentage))
    slab, song_group = max(1, args.encode_slab), max(1, args.song_group)
    z_sets, labels, ids = [], [], []
    for g0 in range(0, len(ds), song_group):
        songs = []
        for i in range(g0, min(g0 + song_group, len(ds))):
            label, [(vid, mm)] = ds[i]
            chunks, valid = _song_chunks(sig, mm, L, stride)
            songs.append((chunks, valid, np.asarray(mm["full_clews"], np.float32),
                          np.asarray(mm["clews_mask"], bool)))
            labels.append(label)
            ids.append(vid)
        refs = [(si, ci) for si, s in enumerate(songs) for ci in range(s[0].shape[0])]
        z = np.concatenate([_mm_embed_chunks(sig, songs, refs[s0 : s0 + slab], model, model_call,
                                             device) for s0 in range(0, len(refs), slab)])
        row = 0
        for chunks, *_ in songs:
            z_sets.append(z[row : row + chunks.shape[0]])
            row += chunks.shape[0]
        _trim_heap(g0 // song_group)
    max_chunks = max(zc.shape[0] for zc in z_sets)
    sets = np.zeros((len(z_sets), max_chunks, z_sets[0].shape[1]), np.float32)
    mask = np.zeros((len(z_sets), max_chunks), bool)
    for i, zc in enumerate(z_sets):
        sets[i, : zc.shape[0]] = zc
        mask[i, : zc.shape[0]] = True
    return _chunk_set_metrics(args, sets, mask, np.asarray(labels), np.asarray(ids), device)


def cmd_evaluate(args) -> int:
    mesh = process_mesh(args.device)
    metrics = evaluate(args, mesh)
    if mesh is None or mesh.is_primary:
        print(json.dumps(metrics))
    close_mesh(mesh)
    return 0


def _add_device(parser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: the card; without one the command "
                        "fails unless --device cpu is given)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="wealy_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    v = sub.add_parser("validate-data", help="build + validate dataset metadata")
    v.add_argument("--config", required=True)
    v.add_argument("--check-audio", action="store_true")
    v.set_defaults(fn=cmd_validate_data)

    e = sub.add_parser("extract", help="extract Whisper embeddings to the store")
    e.add_argument("--config", required=True)
    _add_profile(e)
    e.add_argument("--split", default="train")
    e.add_argument("--kinds", default="x_concat,hs_last_seq")
    e.add_argument("--hf-checkpoint", default=None,
                   help="openai-whisper or HF state-dict file (default: seeded random init)")
    e.add_argument("--limit", type=int, default=None)
    e.add_argument("--overwrite", action="store_true")
    e.add_argument("--batched", action="store_true",
                   help="cross-song chunk batching: chunks of many songs per device batch "
                   "(the first kind of --kinds)")
    e.add_argument("--batch-size", type=int, default=32)
    e.add_argument("--pack", action="store_true",
                   help="after extraction, pack the kind into the mmap format (as the pack "
                   "command)")
    e.add_argument("--pack-direct", action="store_true",
                   help="batched extraction writes straight to the mmap pack (no per-version "
                   "npz); a resume carries the old pack forward. Not for hs_last_all")
    e.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree of the hs_last* kinds under --batched: the "
                   "world's ranks form (data, model) groups of this many (torchrun)")
    e.add_argument("--self-kv-f8", action="store_true",
                   help="store the decode's self-attention KV caches in float8 (--batched "
                   "decoder kinds)")
    e.add_argument("--cross-kv-f8", action="store_true",
                   help="store the decode's cross-attention K/V in float8 (--batched decoder "
                   "kinds)")
    e.add_argument("--quant-int8", action="store_true",
                   help="W8A8 int8 encoder: int8 dense layers with per-token activation "
                   "scales (--batched, x_concat only)")
    _add_device(e)
    e.set_defaults(fn=cmd_extract)

    _add_transcribe_parser(sub)

    pk = sub.add_parser("pack", help="pack per-version embeddings into the mmap format")
    pk.add_argument("--config", required=True)
    pk.add_argument("--split", default=None, help="comma list; default all splits")
    pk.add_argument("--kind", default=None, help="embedding filename override")
    pk.set_defaults(fn=cmd_pack)

    tr = sub.add_parser("train", help="train the head on stored embeddings")
    tr.add_argument("--config", required=True)
    tr.add_argument("--max-steps", type=int, default=None)
    tr.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints in path.checkpoints")
    _add_profile(tr)
    _add_device(tr)
    tr.set_defaults(fn=cmd_train)

    ev = sub.add_parser("evaluate", help="MAP/MR1 retrieval evaluation")
    ev.add_argument("--config", required=True)
    ev.add_argument("--split", default="test")
    ev.add_argument("--checkpoint", default=None,
                    help="head state-dict file, train payload, or checkpoint directory "
                    "(default: seeded init)")
    ev.add_argument("--redux", default="bpwr")
    ev.add_argument(
        "--no-streaming", action="store_true",
        help="force the monolithic ranking path even above the "
        f"{AUTO_STREAM_THRESHOLD}-song auto-streaming threshold",
    )
    ev.add_argument("--streaming", action="store_true",
                    help="corpus-scale ranks via column-block streaming (no full NxN matrix)")
    ev.add_argument("--song-group", type=int, default=64,
                    help="songs collated+encoded per group (bounds host chunk memory)")
    ev.add_argument("--encode-slab", type=int, default=256,
                    help="chunks per head call (fixed shape)")
    ev.add_argument("--test-mode", action="store_true",
                    help="fusion models: embed ALL chunks per song, scored as chunk sets")
    ev.add_argument(
        "--chunk-sets", action="store_true",
        help="with --streaming: exact chunk-set --redux ranking streamed in blocks instead "
        "of chunk-pooled song vectors",
    )
    _add_profile(ev)
    _add_device(ev)
    ev.set_defaults(fn=cmd_evaluate)
    _add_serving_parsers(sub)

    from wealy_tpu_torch.cli.doctor import cmd_doctor

    dr = sub.add_parser("doctor", help="environment + card + project diagnostics (one JSON "
                        "report; the card's probe runs in a child process under a deadline)")
    dr.add_argument("--config", default=None,
                    help="also check the project this config points at")
    dr.add_argument("--backend-timeout", type=float, default=30.0,
                    help="seconds to wait for the card's probe (discovery + one dispatch)")
    dr.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device to probe (default: the card; cpu probes the host)")
    dr.set_defaults(fn=cmd_doctor)
    return p


def _add_profile(parser) -> None:
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the whole command (host and "
                        "card) into DIR")


def _add_transcribe_parser(sub) -> None:
    """``transcribe`` with the JAX parser's flags."""
    tr = sub.add_parser("transcribe", help="transcribe a split to .txt + census")
    tr.add_argument("--config", required=True)
    tr.add_argument("--split", default="train")
    tr.add_argument("--tokenizer-dir", default=None,
                    help="directory of vocab.json + merges.txt (default: token-id lines)")
    tr.add_argument("--hf-checkpoint", default=None,
                    help="openai-whisper or HF state-dict file (default: seeded random init)")
    tr.add_argument("--language", type=int, default=0, help="language index (0=en); -1 = auto")
    tr.add_argument("--max-len", type=int, default=224)
    tr.add_argument("--limit", type=int, default=None)
    tr.add_argument("--overwrite", action="store_true")
    tr.add_argument("--greedy", action="store_true",
                    help="independent greedy per-chunk decode instead of the default "
                    "sequential long-form algorithm (context carry-over + fallback)")
    tr.add_argument("--batched", action="store_true",
                    help="cross-song batched driver (requires --greedy): chunks from many "
                    "songs share device batches")
    tr.add_argument("--batch-size", type=int, default=16)
    tr.add_argument("--n-workers", type=int, default=4,
                    help="host audio-decode threads for --batched")
    tr.add_argument("--initial-prompt", default=None,
                    help="text pre-seeded into the first chunk's <|startofprev|> context "
                    "(openai-whisper initial_prompt; long-form path only, requires "
                    "--tokenizer-dir)")
    tr.add_argument("--beam-size", type=int, default=None,
                    help="beam search width for the deterministic rung (openai-whisper "
                    "DecodingOptions.beam_size; default greedy); with the long-form ladder "
                    "(t=0 rung) and with --greedy [--batched]")
    _add_device(tr)
    tr.set_defaults(fn=cmd_transcribe)


def _add_serving_parsers(sub) -> None:
    """``index``, ``query`` and ``serve`` with the JAX parser's flags."""
    from wealy_tpu_torch.cli.serve import cmd_index, cmd_query, cmd_serve

    ix = sub.add_parser("index", help="embed a split into a serving index (.npz)")
    ix.add_argument("--config", required=True)
    ix.add_argument("--split", default="test")
    ix.add_argument("--out", required=True)
    ix.add_argument("--checkpoint", default=None,
                    help="head state-dict file, train payload, or checkpoint directory "
                    "(default: path.checkpoints, else seeded init)")
    ix.add_argument("--no-sets", action="store_true",
                    help="pooled song vectors only (smaller index; query falls back to "
                    "cosine ranking instead of exact chunk-set redux scoring)")
    ix.add_argument("--song-group", type=int, default=64)
    ix.add_argument("--encode-slab", type=int, default=256)
    ix.add_argument("--update", action="store_true",
                    help="incremental rebuild: carry forward already-indexed versions, embed "
                    "only new ones, drop versions no longer in the split (refused if the "
                    "checkpoint/model/schema changed)")
    _add_device(ix)
    ix.set_defaults(fn=cmd_index)

    def engine_flags(parser) -> None:
        parser.add_argument("--config", required=True)
        parser.add_argument("--index", required=True)
        parser.add_argument("--checkpoint", default=None)
        parser.add_argument("--k", type=int, default=10)
        parser.add_argument("--pooled", action="store_true",
                            help="pooled-cosine scoring even when the index carries chunk sets")
        parser.add_argument("--redux", default="bpwr")
        parser.add_argument("--block-size", type=int, default=512,
                            help="corpus songs scored per redux block (bounds the transient "
                            "(Q, block, s1, s2) tensor)")
        parser.add_argument("--rerank", type=int, default=0,
                            help="two-stage retrieval: pooled-cosine shortlist of this many "
                            "songs, exact chunk-set redux only on the shortlist (0 = exact "
                            "scan of the whole corpus)")
        parser.add_argument("--no-resident", action="store_true",
                            help="keep the corpus chunk sets in host memory and upload per "
                            "block per query instead of the device-resident corpus")
        parser.add_argument("--shard", action="store_true",
                            help="shard the resident corpus over the ranks of a world of "
                            "several processes (torchrun, one per card)")
        parser.add_argument("--wealy-head-checkpoint", default=None,
                            help="fusion indexes of the wealy signature: the WEALY head that "
                            "embeds an audio query's chunks (default: the seeded head)")
        parser.add_argument("--quantize", choices=["int8"], default=None,
                            help="int8 resident corpus (per-chunk absmax scales, dequantized "
                            "per block): half the device bytes")
        _add_device(parser)

    q = sub.add_parser("query", help="top-k cover-song search against an index")
    engine_flags(q)
    q.add_argument("--audio", nargs="*", default=None,
                   help="audio files to embed and search (WAV, mp3; other formats through "
                   "ffmpeg)")
    q.add_argument("--query-embeddings", nargs="*", default=None,
                   help="precomputed (T, C) .npz sequences")
    q.set_defaults(fn=cmd_query)

    sv = sub.add_parser("serve", help="persistent local search daemon (JSON over HTTP)")
    engine_flags(sv)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (printed on startup)")
    sv.add_argument("--warmup", action="store_true",
                    help="run the audio-query path once on a synthetic clip before "
                    "accepting requests")
    sv.add_argument("--batch-window-ms", type=float, default=10.0,
                    help="micro-batching window: queries arriving within it share one "
                    "search_many call (0 = immediate dispatch)")
    sv.add_argument("--max-batch", type=int, default=32,
                    help="cap on queries per micro-batched dispatch")
    sv.set_defaults(fn=cmd_serve)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fn in (cmd_evaluate, cmd_train):
        # the host-streaming commands churn multi-MB transients per song
        # group; glibc's dynamic mmap threshold turns that into heap growth
        from wealy_tpu_torch.utils.hostmem import pin_malloc_thresholds

        pin_malloc_thresholds()
    if getattr(args, "profile", None):
        # a Chrome / TensorBoard trace of the whole command, written on an
        # error too
        from wealy_tpu_torch.utils.profiling import profiled

        with profiled(args.profile, f"wealy_tpu_torch.{args.command}"):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
