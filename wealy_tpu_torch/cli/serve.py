"""Serving surface, the counterpart of ``wealy_tpu.cli.serve``: build a
retrieval index of a split, then answer cover-song queries against it, for
all seven ``conf.model.name`` values.

- ``index``: every song of a split through the head (collate_overlapping
  -> slabbed head -> chunk-set regroup, as ``evaluate``) into a
  self-contained ``.npz``: pooled song vectors for cosine ranking and,
  unless ``--no-sets``, the f16 chunk sets for exact redux scoring. The
  format and ``INDEX_VERSION`` are the JAX package's, so either package
  reads the other's index.
- ``query``: raw audio (decode, resample, 30 s chunks, the Whisper embed of
  the config's kind) or a precomputed (T, C) sequence -> head -> scores
  against the index -> top-k JSON lines.
- ``serve``: a JSON-over-HTTP daemon on the same engine with micro-batching
  (``GET /healthz``, ``POST /query``, ``POST /reload``).

:class:`QueryEngine` keeps the chunk sets resident on the device (f16, or
int8 with per-(song, chunk) scales) and scores a query batch against them
in ``block_size`` slices, each through ``song_distance_matrix_torch``
(cosine product, then K4 for ``bpwr``), with one host sync per
``search_many``. The JAX engine pads the query chunk count to a multiple of
8, the batch to a multiple of 4 and the head's window count to a multiple
of 64 only to keep its jit shapes few; torch does not recompile, so the
port scores the batch as it comes (padded rows are mask-excluded there, so
the rankings are the same).

Fusion models (wealy-clews, whisper-clews, multimodal-*) index one fused
vector per song through the deterministic multimodal collate (the fp16
round trip included, as ``evaluate``) and score by cosine. A fusion query
is raw audio only, both modalities computed cold: the CLEWS trio through
the CQT and window-encoder extractor that ``extract --kinds hs_clews`` runs
(``models/clews_extract.py``), and the Whisper side through the WEALY head
(``--wealy-head-checkpoint``, else the seeded head) for the ``wealy``
signature or the greedy decode's ``hs_last_seq`` for the two-stream one. As
in JAX, a fusion engine refuses ``--rerank``, ``--quantize`` and
embedding queries.

``--shard`` under a world size above 1 (``torchrun``, one process per
card) splits the resident corpus rows over the ranks: each rank holds
``n / W`` songs (padded to whole blocks) on its card and scores its own
blocks with K4, and the (Q, n) distances are gathered, so every rank ranks
the whole corpus. ``query --shard`` runs the same queries on every rank and
rank 0 prints; the ``serve`` daemon's HTTP server lives on rank 0, which
broadcasts each search (and ``/reload``, and its shutdown) to the other
ranks, which wait for them. A two-stage search (``--rerank``) scores its
shortlist through the host path, as the JAX mesh engine does.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from wealy_tpu_torch import resolve_device

INDEX_VERSION = 1
# the meta fields the raw-audio embed fn of an engine depends on
_EMBED_META = ("fusion", "sig", "wealy_dim", "emb_dim", "chunk_size")


def _load_head_params(config, checkpoint: Optional[str], emb_dim: int, device):
    """The head and its checkpoint step: ``checkpoint``, else
    ``path.checkpoints``, else the seeded init (step None)."""
    from wealy_tpu_torch.cli.main import load_head, serving_checkpoint

    return load_head(config, emb_dim, serving_checkpoint(checkpoint, config), device)


def _mm_collate_fn(config, sig: str):
    """The deterministic multimodal collate of a fusion signature (first
    WEALY chunk / first whisper window), as the fusion evaluate."""
    from wealy_tpu_torch.data.collate_factory import collate_wealy_clews, collate_whisper_clews

    def collate(items):
        if sig == "wealy":
            return collate_wealy_clews(items, wealy_mode="deterministic")
        return collate_whisper_clews(items, chunk_size=config.data.chunk_size,
                                     use_random_chunks=False)

    return collate


def _mm_init_params(config, sig: str, flat: dict, checkpoint, device):
    """The fusion model at the widths of the flat probe batch ``flat``, in
    eval mode on ``device``, its weights restored from ``checkpoint``, else
    ``path.checkpoints`` when that holds a payload, else the seeded init
    (the JAX package's ``_mm_restore_params`` then ``_mm_init_params``):
    (model, model_call, checkpoint step)."""
    from wealy_tpu_torch.cli.main import load_head, serving_checkpoint
    from wealy_tpu_torch.train.multimodal import input_widths, make_model_call

    model, step = load_head(config, checkpoint=serving_checkpoint(checkpoint, config),
                            device=device, **input_widths(flat, sig))
    return model, make_model_call(config.model.name, model, sig), step


def _index_fusion(args, config, sig: str, device) -> int:
    """Fusion-family index: one fused vector per song through the
    deterministic multimodal collate, scored by cosine (the fusion evaluate
    semantics). ``--update`` carries forward the vectors of versions still
    in the split and embeds only the new ones."""
    from wealy_tpu_torch.cli.main import _mm_dataset, _mm_embed
    from wealy_tpu_torch.train.multimodal import flatten_multimodal_batch
    from wealy_tpu_torch.utils.hostmem import trim_host_heap

    ds = _mm_dataset(config, args.split, sig, n_per_class=1, seed=0, refresh_cache=args.update)
    collate = _mm_collate_fn(config, sig)
    n = len(ds)
    if n == 0:
        print(f"[index] split {args.split!r} is empty", file=sys.stderr)
        return 2
    probe = flatten_multimodal_batch(collate([ds[0], ds[min(1, n - 1)]]))
    model, model_call, step = _mm_init_params(config, sig, probe, args.checkpoint, device)
    versions = list(ds.sampler.versions)
    out = Path(args.out)
    carry_keys, carry_vecs = [], None
    new_versions = versions
    if args.update and out.exists():
        with np.load(out, allow_pickle=False) as old:
            old_meta = json.loads(str(old["meta"]))
            want = {
                "model": config.model.name, "zdim": int(config.model.zdim), "split": args.split,
                "sig": sig, "fusion": True, "checkpoint_step": step,
                "index_version": INDEX_VERSION,
            }
            stale = [k for k, v in want.items() if old_meta.get(k) != v]
            if stale:
                print(f"[index] --update refused: existing index differs on {stale}; rebuild "
                      "without --update", file=sys.stderr)
                return 2
            in_split = set(versions)
            keep = np.asarray([str(k) in in_split for k in old["version_keys"]], bool)
            carry_keys = [str(k) for k, m in zip(old["version_keys"], keep) if m]
            carry_vecs = old["vecs"][keep]
        carried = set(carry_keys)
        new_versions = [v for v in versions if v not in carried]
        print(f"[index] --update: {len(carry_keys)} carried, {int((~keep).sum())} dropped, "
              f"{len(new_versions)} new", file=sys.stderr)

    # no larger groups than the work: an --update of two songs collates two
    G = max(1, min(args.song_group, max(1, len(new_versions))))
    index_of = {v: i for i, v in enumerate(versions)}
    zs = [carry_vecs] if carry_vecs is not None and len(carry_vecs) else []
    for g0 in range(0, len(new_versions), G):
        flat = flatten_multimodal_batch(collate([ds[index_of[v]]
                                                 for v in new_versions[g0 : g0 + G]]))
        zs.append(_mm_embed(model, model_call, flat, device))
        if (g0 // G) % 32 == 31:
            trim_host_heap()
    versions = carry_keys + new_versions
    meta = {
        "index_version": INDEX_VERSION, "model": config.model.name,
        "zdim": int(config.model.zdim), "split": args.split, "checkpoint_step": step,
        "chunk_size": config.data.chunk_size, "overlap": float(config.data.overlap_percentage),
        "has_sets": False, "fusion": True, "sig": sig,
        "wealy_dim": int(probe["wealy"].shape[-1]) if sig == "wealy" else None,
        "emb_dim": int(probe["whisper_seq"].shape[-1]) if sig != "wealy" else None,
        "clews_shape": [int(d) for d in probe["full_clews"].shape[1:]],
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        out,
        version_keys=np.asarray(versions),
        cliques=np.asarray([ds.sampler.clique_of[v] for v in versions]),
        labels=np.asarray([ds.sampler.labels[ds.sampler.clique_of[v]] for v in versions],
                          np.int32),
        ids=np.asarray([int(ds.metadata.info[v]["id"]) for v in versions], np.int64),
        vecs=np.concatenate(zs, axis=0),
        meta=np.asarray(json.dumps(meta)),
    )
    print(json.dumps({"indexed": n, "new": len(new_versions), "out": str(out),
                      "zdim": int(config.model.zdim), "sets": False, "fusion": True,
                      "checkpoint_step": step}))
    return 0


def cmd_index(args) -> int:
    """Embed a split into a serving index file."""
    from wealy_tpu_torch.cli.main import _load_config
    from wealy_tpu_torch.data.chunking import collate_overlapping
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.eval.retrieval import regroup_chunks, slabbed_apply
    from wealy_tpu_torch.models.registry import model_signature
    from wealy_tpu_torch.utils.hostmem import trim_host_heap

    device = resolve_device(args.device)
    config = _load_config(args.config)
    sig = model_signature(config.model.name)
    if sig != "single":
        return _index_fusion(args, config, sig, device)
    # --update must see source-CSV changes: bypass the processed-metadata cache
    ds = EmbeddingDataset(config, args.split, seed=0, refresh_cache=args.update)
    versions = list(ds.sampler.versions)
    if not versions:
        print(f"[index] split {args.split!r} is empty", file=sys.stderr)
        return 2
    emb_dim = ds.load_embedding(versions[0]).shape[-1]
    L = config.data.chunk_size
    head, step = _load_head_params(config, args.checkpoint, emb_dim, device)

    out = Path(args.out)
    carry = None
    if args.update and out.exists():
        # carry forward every indexed version still in the split, embed only
        # the new ones; rows of versions gone from the split are dropped
        with np.load(out, allow_pickle=False) as old:
            old_meta = json.loads(str(old["meta"]))
            want = {
                "model": config.model.name, "zdim": int(config.model.zdim),
                "split": args.split, "emb_dim": int(emb_dim),
                "embedding_file": ds.filename, "chunk_size": L,
                "overlap": float(config.data.overlap_percentage),
                "has_sets": not args.no_sets, "checkpoint_step": step,
                "index_version": INDEX_VERSION,
            }
            stale = [k for k, v in want.items() if old_meta.get(k) != v]
            if stale:
                # a changed head or schema invalidates every carried vector
                print(
                    f"[index] --update refused: existing index differs on {stale} (old "
                    f"{ {k: old_meta.get(k) for k in stale} }); rebuild without --update",
                    file=sys.stderr,
                )
                return 2
            carry = {k: old[k] for k in old.files if k != "meta"}
        in_split = set(versions)
        keep = np.asarray([str(k) in in_split for k in carry["version_keys"]], bool)
        carried_keys = {str(k) for k, m in zip(carry["version_keys"], keep) if m}
        carry = {k: v[keep] for k, v in carry.items()}
        versions = [v for v in versions if v not in carried_keys]
        print(f"[index] --update: {len(carried_keys)} carried, {int((~keep).sum())} dropped, "
              f"{len(versions)} new", file=sys.stderr)

    keys, cliques, labels, ids = [], [], [], []
    vec_groups, set_groups, mask_groups = [], [], []
    group = max(1, args.song_group)
    for g0 in range(0, len(versions), group):
        gv = versions[g0 : g0 + group]
        items = [
            (ds.sampler.labels[ds.sampler.clique_of[v]],
             [(int(ds.metadata.info[v]["id"]), ds.load_embedding(v))])
            for v in gv
        ]
        batch = collate_overlapping(items, chunk_size=L, overlap=config.data.overlap_percentage)
        z = slabbed_apply(head, batch.embeddings, batch.masks, slab_size=args.encode_slab,
                          device=device)
        sets, set_mask, bidx, _ = regroup_chunks(z, batch.chunk_info, batch.chunk_valid)
        keys.extend(gv[i] for i in bidx)
        cliques.extend(ds.sampler.clique_of[gv[i]] for i in bidx)
        labels.extend(items[i][0] for i in bidx)
        ids.extend(items[i][1][0][0] for i in bidx)
        w = set_mask[..., None].astype(np.float32)
        vec_groups.append((sets * w).sum(axis=1) / np.maximum(w.sum(axis=1), 1e-9))
        if not args.no_sets:
            set_groups.append(sets.astype(np.float16))
            mask_groups.append(set_mask)
        if (g0 // group) % 32 == 31:
            trim_host_heap()

    zdim = int(config.model.zdim)
    if carry is not None:
        # carried rows first (a stable order for unchanged corpora), then new
        keys = [str(k) for k in carry["version_keys"]] + keys
        cliques = [str(c) for c in carry["cliques"]] + cliques
        labels = carry["labels"].tolist() + labels
        ids = carry["ids"].tolist() + ids
        vec_groups.insert(0, carry["vecs"].reshape(-1, zdim))
        if not args.no_sets:
            set_groups.insert(0, carry["sets"])
            mask_groups.insert(0, carry["set_mask"])
    n = len(keys)
    payload = {
        "version_keys": np.asarray(keys),
        "cliques": np.asarray(cliques),
        "labels": np.asarray(labels, np.int32),
        "ids": np.asarray(ids, np.int64),
        "vecs": (np.concatenate(vec_groups, axis=0).astype(np.float32)
                 if vec_groups else np.zeros((0, zdim), np.float32)),
        "meta": np.asarray(json.dumps({
            "index_version": INDEX_VERSION, "model": config.model.name, "zdim": zdim,
            "split": args.split, "checkpoint_step": step, "embedding_file": ds.filename,
            "emb_dim": int(emb_dim), "chunk_size": L,
            "overlap": float(config.data.overlap_percentage), "has_sets": not args.no_sets,
        })),
    }
    if not args.no_sets:
        smax = max((s.shape[1] for s in set_groups), default=0)
        sets = np.zeros((n, smax, zdim), np.float16)
        mask = np.zeros((n, smax), bool)
        row = 0
        for s, m in zip(set_groups, mask_groups):
            sets[row : row + s.shape[0], : s.shape[1]] = s
            mask[row : row + s.shape[0], : s.shape[1]] = m
            row += s.shape[0]
        payload["sets"] = sets
        payload["set_mask"] = mask

    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **payload)
    print(json.dumps({
        "indexed": n, "new": n - (len(carry["version_keys"]) if carry else 0), "out": str(out),
        "zdim": int(payload["vecs"].shape[-1]), "sets": not args.no_sets,
        "checkpoint_step": step,
    }))
    return 0


def make_query_embed_fn(config, device=None):
    """Build once: audio path -> the (T, C) sequence the config's embedding
    kind stores per version, so a query enters the head as an indexed
    song's file does. Kinds: ``x_concat`` (mean-pooled encoder per 30 s
    chunk), ``hs_wealy_concat`` (the 512-d WEALY projection) and the
    decoder kinds ``hs_last_seq``/``hs_last_seq_en`` (greedy transcription
    per chunk, the valid positions flattened). Other kinds need
    ``--query-embeddings``."""
    from wealy_tpu_torch.audio.decode import load_audio
    from wealy_tpu_torch.data.paths import embedding_filename
    from wealy_tpu_torch.models.whisper.extract import chunk_waveform, flatten_decoder_sequence

    kind = embedding_filename(config.data.embedding_type,
                              config.data.embedding_format).removesuffix(".npz")
    device = resolve_device(device)
    if kind == "x_concat":
        from wealy_tpu_torch.cli.extract_batched import make_encoder_embed_fn

        embed_fn = make_encoder_embed_fn(config, device=device)
    elif kind == "hs_wealy_concat":
        from wealy_tpu_torch.cli.extract_batched import make_wealy_embed_fn

        embed_fn = make_wealy_embed_fn(config, device=device)
    elif kind in ("hs_last_seq", "hs_last_seq_en"):
        from wealy_tpu_torch.cli.extract_batched import make_decoder_embed_fn

        decode_fn = make_decoder_embed_fn(config, language=0 if kind.endswith("_en") else None,
                                          device=device)

        def embed_fn(chunks):
            hidden, lengths = decode_fn(chunks)
            return flatten_decoder_sequence(hidden.float().cpu().numpy(), lengths.cpu().numpy())
    else:
        raise ValueError(f"query-time embedding is not supported for kind {kind!r}; pass "
                         "--query-embeddings with a precomputed (T, C) .npz")

    def run(audio_path: str) -> np.ndarray:
        out = embed_fn(chunk_waveform(load_audio(audio_path)))
        if isinstance(out, torch.Tensor):  # bf16 on the device -> the store's f32
            out = out.float().cpu().numpy()
        return np.asarray(out, np.float32)

    return run


def embed_query_audio(config, audio_path: str, device=None) -> np.ndarray:
    """One-shot convenience wrapper over :func:`make_query_embed_fn`."""
    return make_query_embed_fn(config, device)(audio_path)


def make_mm_query_embed_fn(config, meta: dict, wealy_head_checkpoint=None, device=None):
    """Build once: audio path -> the multimodal per-song dict the fusion
    collates take (``data/multimodal.py``'s item), both modalities computed
    cold on ``device``:

    - the CLEWS trio through the default extractor of ``extract --kinds
      hs_clews`` (``models/clews_extract.py``), so the query lands in the
      indexed hs_clews space;
    - ``wealy`` signature: mel -> encoder -> the WEALY ProjectionHead at the
      index's ``wealy_dim`` (K1-K3; head weights from
      ``wealy_head_checkpoint``, else the seeded head, as ``extract --kinds
      hs_wealy_concat``; never the fusion checkpoint); ``two_stream``: the
      greedy decode's flattened ``hs_last_seq``.
    """
    from wealy_tpu_torch.audio.decode import load_audio
    from wealy_tpu_torch.cli import extract_batched as eb
    from wealy_tpu_torch.models.clews_extract import make_clews_extractor
    from wealy_tpu_torch.models.whisper.extract import chunk_waveform, flatten_decoder_sequence
    from wealy_tpu_torch.train.config import Config

    device = resolve_device(device)
    sig = meta["sig"]
    clews = make_clews_extractor(device=device)
    if sig == "wealy":
        cfg_w = Config.from_dict(config.to_dict())
        cfg_w.model.zdim = int(meta["wealy_dim"])
        cfg_w.path.checkpoints = ""  # the fusion checkpoint is not a WEALY head
        embed_fn = eb.make_wealy_embed_fn(cfg_w, head_checkpoint=wealy_head_checkpoint,
                                          device=device)
    else:
        decode_fn = eb.make_decoder_embed_fn(config, language=None, device=device)

    def run(audio_path: str) -> dict:
        audio = load_audio(audio_path)
        trio = clews(audio)
        chunks = chunk_waveform(audio)
        if sig == "wealy":
            whisper = {"wealy": {"embeddings": embed_fn(chunks).float().cpu().numpy()}}
        else:
            hidden, lengths = decode_fn(chunks)
            seq = flatten_decoder_sequence(hidden.float().cpu().numpy(), lengths.cpu().numpy())
            whisper = {"whisper_seq": np.asarray(seq, np.float32)}
        return {**whisper, "full_clews": trio["hs_clews"], "avg_clews": trio["hs_clews_avg"],
                "clews_mask": trio["hs_clews_mask"]}

    return run


def read_index_meta(index_path: str, config) -> dict:
    """The index file's meta, checked against ``config``: the index version,
    the model and zdim, and a fusion index for a fusion model only."""
    from wealy_tpu_torch.models.registry import model_signature

    with np.load(index_path, allow_pickle=False) as idx:
        meta = json.loads(str(idx["meta"]))
    if meta.get("index_version") != INDEX_VERSION:
        raise ValueError(f"unsupported index version {meta.get('index_version')}")
    if meta["model"] != config.model.name or meta["zdim"] != int(config.model.zdim):
        raise ValueError(
            f"index was built for model={meta['model']} zdim={meta['zdim']}; "
            f"config says {config.model.name}/{config.model.zdim}"
        )
    sig = model_signature(config.model.name)
    if (sig != "single") != bool(meta.get("fusion")):
        raise ValueError(
            f"index sig mismatch: index fusion={bool(meta.get('fusion'))} but model "
            f"{config.model.name!r} is {'fusion' if sig != 'single' else 'single-modal'}")
    if meta.get("fusion") and meta["sig"] != sig:
        raise ValueError(f"index built for sig={meta['sig']!r}; model resolves to {sig!r}")
    return meta


class QueryEngine:
    """Loaded-once search state: the index, the head, and (by default) the
    chunk sets resident on the device. Shared by ``query`` and ``serve``."""

    def __init__(self, config, index_path: str, checkpoint: Optional[str],
                 redux: str = "bpwr", block_size: int = 512, resident: bool = True,
                 quantize: Optional[str] = None, wealy_head_checkpoint: Optional[str] = None,
                 device=None, mesh=None):
        self.config = config
        self.redux = redux
        self.block_size = max(1, block_size)
        # a mesh of one rank (or none) keeps the corpus whole on this card
        self.mesh = mesh if mesh is not None and mesh.active("data") else None
        self.device = resolve_device(device) if self.mesh is None else self.mesh.device
        self._wealy_head_checkpoint = wealy_head_checkpoint
        self.meta = read_index_meta(index_path, config)
        with np.load(index_path, allow_pickle=False) as idx:
            self.keys = [str(k) for k in idx["version_keys"]]
            self.cliques = [str(c) for c in idx["cliques"]]
            self.vecs = idx["vecs"]
            self.sets = idx["sets"] if "sets" in idx.files else None
            self.set_mask = idx["set_mask"] if "sets" in idx.files else None
        # survives the int8 resident path dropping the host f16 copy
        self._has_sets = self.sets is not None
        self.L = self.meta["chunk_size"]
        self._vn = self.vecs / np.maximum(np.linalg.norm(self.vecs, axis=-1, keepdims=True), 1e-9)
        self._audio_fn = None  # built on the first audio query, then reused
        self._audio_lock = threading.Lock()  # request threads race to build it
        self._sets_dev = self._mask_dev = self._scale_dev = None
        self.fusion = bool(self.meta.get("fusion"))
        if self.fusion:
            if quantize:
                raise ValueError("quantize applies to chunk-set indexes; fusion indexes hold one "
                                 "vector per song")
            sig = self.meta["sig"]
            self._collate_mm = _mm_collate_fn(config, sig)
            self._mm_model, self._mm_call, self.checkpoint_step = _mm_init_params(
                config, sig, self._mm_probe_flat(), checkpoint, self.device)
            self._resident = self._quantized = False
            return
        self._head, self.checkpoint_step = _load_head_params(
            config, checkpoint, int(self.meta["emb_dim"]), self.device)
        self._resident = bool(resident) and self._has_sets
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize={quantize!r}")
        if quantize and not self._resident:
            # serving the unquantized host path would hide what was asked for
            raise ValueError("quantize=int8 requires the device-resident corpus (drop "
                             "--no-resident; pooled-only indexes have no chunk sets)")
        self._quantized = self._resident and quantize == "int8"
        if self._resident:
            sets, mask, scale = self.sets, self.set_mask, None
            if self._quantized:
                sets, scale = _quantize_int8(self.sets)
                if self.mesh is None:
                    # the host f16 copy would serve only the host fallbacks,
                    # which the quantized engine does not take on one card
                    self.sets = None
            if self.mesh is not None:
                sets, mask, scale = self._rank_rows(sets, mask, scale)
            self._sets_dev = torch.from_numpy(sets).to(self.device)
            self._mask_dev = torch.from_numpy(mask).to(self.device)
            if scale is not None:
                self._scale_dev = torch.from_numpy(scale).to(self.device)

    def _rank_rows(self, sets, mask, scale):
        """This rank's rows of the corpus: padded with empty songs to whole
        ``block_size`` blocks on every rank, then the rank's contiguous
        share."""
        n, W = sets.shape[0], self.mesh.size("data")
        per = -(-n // (self.block_size * W)) * self.block_size
        lo = self.mesh.index("data") * per

        def rows(a):
            out = np.zeros((per, *a.shape[1:]), a.dtype)
            part = a[lo : lo + per]
            out[: part.shape[0]] = part
            return out

        return rows(sets), rows(mask), None if scale is None else rows(scale)

    def release(self) -> None:
        """Drop the resident device tensors (before a replacement engine
        uploads its own)."""
        self._sets_dev = self._mask_dev = self._scale_dev = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def resident_bytes(self) -> int:
        """Device bytes of the resident corpus (sets, mask, scales)."""
        return sum(t.numel() * t.element_size()
                   for t in (self._sets_dev, self._mask_dev, self._scale_dev) if t is not None)

    def _corpus_block(self, rows):
        """Resident chunk sets of ``rows`` (a slice or an index tensor) in f32
        (int8 dequantized with their scales), and their mask."""
        s = self._sets_dev[rows].float()
        if self._scale_dev is not None:
            s = s * self._scale_dev[rows][..., None]
        return s, self._mask_dev[rows]

    def _score_resident(self, q, qm) -> torch.Tensor:
        """(Q, s1, C) query sets vs the resident corpus -> (Q, n) distances
        on the device, ``block_size`` songs per product and K4 call."""
        from wealy_tpu_torch.eval.retrieval import song_distance_matrix_torch

        n = self._sets_dev.shape[0]
        d = torch.cat([
            song_distance_matrix_torch(q, qm, *self._corpus_block(slice(b, b + self.block_size)),
                                       redux=self.redux)
            for b in range(0, n, self.block_size)
        ], dim=1)
        if self.mesh is None:
            return d
        from wealy_tpu_torch.parallel.mesh import all_gather

        # every rank's (Q, n / W) distances, the padding rows dropped
        return all_gather(self.mesh, d, "data", dim=1)[:, : len(self.keys)]

    def _rerank_resident(self, q, qm, cand) -> torch.Tensor:
        """Each query against its own shortlist ``cand`` (Q, R), gathered from
        the resident corpus on the device -> (Q, R) distances."""
        from wealy_tpu_torch.eval.retrieval import song_distance_matrix_torch

        return torch.stack([
            song_distance_matrix_torch(q[i : i + 1], qm[i : i + 1], *self._corpus_block(cand[i]),
                                       redux=self.redux)[0]
            for i in range(q.shape[0])
        ])

    def _mm_probe_flat(self) -> dict:
        """A synthetic flat batch at the index's recorded widths (the fusion
        model's widths when no checkpoint gives them)."""
        Lc, Cc = self.meta["clews_shape"]
        flat = {"full_clews": np.zeros((1, Lc, Cc), np.float32)}
        if self.meta["sig"] == "wealy":
            flat["wealy"] = np.zeros((1, self.meta["wealy_dim"]), np.float32)
        else:
            flat["whisper_seq"] = np.zeros((1, self.L, self.meta["emb_dim"]), np.float32)
        return flat

    @torch.inference_mode()
    def embed_audio(self, audio_path: str):
        """Audio file -> the query payload through a cached embed fn: a (T, C)
        sequence, or for a fusion index the multimodal per-song dict."""
        with self._audio_lock:
            if self._audio_fn is None:
                self._audio_fn = (
                    make_mm_query_embed_fn(self.config, self.meta, self._wealy_head_checkpoint,
                                           self.device)
                    if self.fusion else make_query_embed_fn(self.config, self.device))
        return self._audio_fn(audio_path)

    def search(self, seq: np.ndarray, k: int = 10, pooled: bool = False, rerank: int = 0):
        """(T, C) sequence -> ranked results payload. ``rerank > 0``: a
        pooled-cosine pass shortlists ``rerank`` songs and only those are
        scored exactly; ``rerank >= corpus`` is the full scan."""
        return self.search_many([seq], k=k, pooled=pooled, rerank=rerank)[0]

    @torch.inference_mode()
    def query_sets(self, seqs):
        """(T, C) sequences -> their chunk sets (Q, s1, zdim) f32 and masks
        (Q, s1), in input order: the collate and head of ``index``."""
        from wealy_tpu_torch.data.chunking import collate_overlapping
        from wealy_tpu_torch.eval.retrieval import regroup_chunks, slabbed_apply

        # chunk_bucket=1: no padded windows (the JAX engine pads the window
        # count to a multiple of 64 for its jit shapes; here they would only
        # be copied to the card and run through the head)
        batch = collate_overlapping(
            [(i, [(i, np.asarray(s, np.float32))]) for i, s in enumerate(seqs)],
            chunk_size=self.L, overlap=self.meta["overlap"], chunk_bucket=1,
        )
        z = slabbed_apply(self._head, batch.embeddings, batch.masks, slab_size=64,
                          device=self.device)
        qsets, qmask, bidx, _ = regroup_chunks(z, batch.chunk_info, batch.chunk_valid)
        order_in = np.argsort(bidx)  # restore input order explicitly
        return qsets[order_in].astype(np.float32), qmask[order_in]

    @torch.inference_mode()
    def search_many(self, seqs, k: int = 10, pooled: bool = False, rerank: int = 0):
        """Batch of (T, C) sequences -> one ranked-results payload per query,
        the whole batch scored together (one host sync for the scores)."""
        from wealy_tpu_torch.eval.retrieval import song_distance_matrix

        if self.fusion:
            if rerank:
                # a chunk-set option: an error, not a silently ignored flag
                raise ValueError("rerank applies to chunk-set indexes; fusion scoring is already "
                                 "one cosine pass over fused song vectors")
            return self._search_many_mm(seqs, k=k)
        exact = self._has_sets and not pooled
        Q = len(seqs)
        if Q == 0:
            return []
        qsets, qmask = self.query_sets(seqs)
        # pooled query vectors: the ranking itself in pooled mode, the
        # shortlist signal in two-stage mode
        w = qmask[..., None].astype(np.float32)
        qv = (qsets * w).sum(axis=1) / np.maximum(w.sum(axis=1), 1e-9)
        qv = qv / np.maximum(np.linalg.norm(qv, axis=-1, keepdims=True), 1e-9)
        cos = qv @ self._vn.T  # (Q, n)
        n = len(self.keys)
        two_stage = exact and 0 < rerank < n
        if exact:
            blk = self.block_size
            if two_stage:
                cand = np.argpartition(-cos, rerank - 1, axis=1)[:, :rerank]
                cand.sort(axis=1)  # ascending: contiguous gather reads
            if self._resident and not (two_stage and self.mesh is not None):
                q = torch.from_numpy(qsets).to(self.device)
                qm = torch.from_numpy(qmask).to(self.device)
                d = (self._rerank_resident(q, qm, torch.from_numpy(cand).to(self.device))
                     if two_stage else self._score_resident(q, qm)).cpu().numpy()
            elif two_stage:
                # host corpus: upload each query's shortlist
                d = np.stack([
                    song_distance_matrix(qsets[i : i + 1], qmask[i : i + 1],
                                         self.sets[cand[i]].astype(np.float32),
                                         self.set_mask[cand[i]], redux=self.redux,
                                         device=self.device)[0]
                    for i in range(Q)
                ])
            else:
                # host corpus streamed in blocks: the (Q, blk, s1, s2) tensor
                # stays bounded
                d = np.concatenate([
                    song_distance_matrix(qsets, qmask, self.sets[b : b + blk].astype(np.float32),
                                         self.set_mask[b : b + blk], redux=self.redux,
                                         device=self.device)
                    for b in range(0, n, blk)
                ], axis=1)
        outs = []
        for i in range(Q):
            if exact:
                cand_i = cand[i] if two_stage else np.arange(n)
                cand_scores = -d[i]
                top = np.argsort(-cand_scores)[: min(k, len(cand_i))]
                order = cand_i[top]
                scores = np.empty(n, np.float32)
                scores[cand_i] = cand_scores
            else:
                scores = cos[i]
                order = np.argsort(-scores)[: min(k, n)]
            out = {
                "scoring": ("chunk_set_" + self.redux) if exact else "pooled_cosine",
                "results": [
                    {"rank": r + 1, "version_key": self.keys[j], "clique": self.cliques[j],
                     "score": round(float(scores[j]), 6)}
                    for r, j in enumerate(order)
                ],
            }
            if two_stage:
                out["rerank"] = int(rerank)
            outs.append(out)
        return outs

    @torch.inference_mode()
    def _search_many_mm(self, mms, k: int = 10):
        """Fusion search: multimodal query dicts (:func:`make_mm_query_embed_fn`)
        -> deterministic collate -> fused z -> cosine against the indexed song
        vectors, the whole batch in one model call."""
        from wealy_tpu_torch.cli.main import _mm_embed
        from wealy_tpu_torch.train.multimodal import flatten_multimodal_batch

        if not mms:
            return []
        items = [(i, [(i, mm)]) for i, mm in enumerate(mms)]
        flat = flatten_multimodal_batch(self._collate_mm(items))
        z = _mm_embed(self._mm_model, self._mm_call, flat, self.device)
        zn = z / np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1e-9)
        cos = zn @ self._vn.T  # (Q, n)
        return [{
            "scoring": "fusion_cosine",
            "results": [{"rank": r + 1, "version_key": self.keys[j], "clique": self.cliques[j],
                         "score": round(float(cos[i, j]), 6)}
                        for r, j in enumerate(np.argsort(-cos[i])[: min(k, len(self.keys))])],
        } for i in range(len(mms))]


def _quantize_int8(sets: np.ndarray, rows: int = 65536):
    """f16 (n, s, C) chunk sets -> (int8 sets, f32 (n, s) scales): per
    (song, chunk) absmax / 127, quantised ``rows`` songs at a time, so no
    f32 copy of the whole corpus exists (the JAX engine's blockwise build)."""
    n, smax, C = sets.shape
    qscale = np.zeros((n, smax), np.float32)
    qsets = np.zeros((n, smax, C), np.int8)
    for b in range(0, n, rows):
        blk32 = sets[b : b + rows].astype(np.float32)
        sc = np.maximum(np.abs(blk32).max(axis=-1), 1e-12) / 127.0
        qscale[b : b + rows] = sc
        qsets[b : b + rows] = np.clip(np.round(blk32 / sc[..., None]), -127, 127).astype(np.int8)
    return qsets, qscale


def _serving_mesh(args):
    """The data mesh the corpus shards over with ``--shard`` in a world of
    several processes (``torchrun``: NCCL on the cards, gloo with
    ``--device cpu``); None otherwise: the corpus lives on one card. Making
    a data mesh runs no collective, so each engine build asks again."""
    if not getattr(args, "shard", False):
        return None
    from wealy_tpu_torch.cli.main import process_mesh

    return process_mesh(args.device)


def _load_seq(path: str) -> np.ndarray:
    with np.load(path) as d:
        seq = d["embeddings"] if "embeddings" in d.files else d[d.files[0]]
    return np.asarray(seq, np.float32)


def _build_engine(args, config) -> QueryEngine:
    return QueryEngine(
        config, args.index, args.checkpoint, redux=args.redux, block_size=args.block_size,
        resident=not args.no_resident, quantize=args.quantize,
        wealy_head_checkpoint=args.wealy_head_checkpoint, device=args.device,
        mesh=_serving_mesh(args),
    )


def cmd_query(args) -> int:
    """Answer queries against an index file (one-shot CLI)."""
    from wealy_tpu_torch.cli.main import _load_config, close_mesh

    resolve_device(args.device)
    config = _load_config(args.config)
    if not (args.audio or args.query_embeddings):
        print("[query] no --audio or --query-embeddings given", file=sys.stderr)
        return 2
    mesh = _serving_mesh(args)
    try:  # an error answer, never a fallback
        engine = _build_engine(args, config)
        if engine.fusion and args.query_embeddings:
            raise ValueError("fusion indexes answer raw-audio queries only (a query needs both "
                             "modalities computed cold); pass --audio")
    except ValueError as e:
        print(f"[query] {e}", file=sys.stderr)
        return 2
    queries = [(p, _load_seq(p)) for p in args.query_embeddings or []]
    queries.extend((p, engine.embed_audio(p)) for p in args.audio or [])
    outs = engine.search_many([s for _, s in queries], k=args.k, pooled=args.pooled,
                              rerank=args.rerank)
    if mesh is None or mesh.is_primary:  # every rank scored its share; one prints
        for (name, _), out in zip(queries, outs):
            print(json.dumps({"query": name, **out}))
    close_mesh(mesh)
    return 0


class MicroBatcher:
    """Bounded-delay query collector: concurrent queries coalesce into one
    ``search_many`` call.

    The first arriving query opens a ``window_s`` collection window (new
    arrivals wake the collector; ``max_batch`` caps a burst), then all that
    is pending is dispatched as one batch, grouped by their (k, pooled,
    rerank) options. An isolated query waits up to ``window_s``;
    ``window_s=0`` dispatches each arrival at once.
    """

    def __init__(self, dispatch, window_s: float = 0.010, max_batch: int = 32):
        self._dispatch = dispatch  # (seqs, opts) -> list[result]
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._cv = threading.Condition()
        self._pending: list = []
        self._closed = False
        # dispatches and queries -> mean batch size, in /healthz "batch_stats"
        self.n_dispatches = 0
        self.n_queries = 0
        self._thread = threading.Thread(target=self._run, name="microbatch-collector",
                                        daemon=True)
        self._thread.start()

    class _Item:
        __slots__ = ("seq", "opts", "done", "result", "error")

        def __init__(self, seq, opts):
            self.seq = seq
            self.opts = opts
            self.done = threading.Event()
            self.result = None
            self.error = None

    def submit_many(self, seqs, opts) -> list:
        """Enqueue ``seqs`` (one client request) and block until all are
        answered; re-raises the dispatch error if their batch failed."""
        items = [self._Item(s, opts) for s in seqs]
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._pending.extend(items)
            self._cv.notify_all()
        outs = []
        for it in items:
            it.done.wait()
            if it.error is not None:
                raise it.error
            outs.append(it.result)
        return outs

    def close(self, timeout: float = 30.0) -> None:
        """Stop the collector once what is pending has been answered."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def _run(self) -> None:
        import time

        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                deadline = time.monotonic() + self.window_s
                while len(self._pending) < self.max_batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._pending[: self.max_batch]
                del self._pending[: len(batch)]
            # dispatch outside the condition so that new arrivals keep queueing
            groups: dict = {}
            for it in batch:
                groups.setdefault(it.opts, []).append(it)
            for opts, items in groups.items():
                self.n_dispatches += 1
                self.n_queries += len(items)
                try:  # an error answer, never a fallback
                    outs = self._dispatch([it.seq for it in items], opts)
                    for it, o in zip(items, outs):
                        it.result = o
                except Exception as e:  # noqa: BLE001 - the daemon must not die
                    for it in items:
                        it.error = e
                finally:
                    for it in items:
                        it.done.set()


class SearchDaemon:
    """The ``serve`` daemon: a :class:`QueryEngine` built once, a
    :class:`MicroBatcher` in front of its ``search_many``, and a threaded
    JSON-over-HTTP server on ``args.host:args.port`` (0 = ephemeral).

    - ``GET /healthz`` -> {"ok", "indexed", "model", "split",
      "checkpoint_step", "exact_sets", "batch_stats"}
    - ``POST /query`` {"embeddings": [[...]]} or {"audio_path": ...} (+ "k",
      "pooled", "rerank") -> the payload ``query`` prints; {"batch":
      [entry, ...]} -> {"batch": [payload, ...]}
    - ``POST /reload`` -> re-read the index: its meta is checked first (a
      bad file is refused and the old corpus keeps serving), then the old
      engine's device tensors are released, under the search lock, so two
      corpora never sit on the card together. If the new engine then fails
      to build, the daemon has no corpus: ``/healthz`` and ``/query``
      answer 503 until a ``/reload`` succeeds.

    Searches run on the collector thread and audio embeds on the request
    threads; each enters ``torch.inference_mode`` itself (grad mode is
    per thread).

    On a ``--shard`` mesh this is rank 0's daemon: each search, reload and
    the shutdown are broadcast first to the other ranks, which run them on
    their shares of the corpus (:func:`_follow`).
    """

    def __init__(self, args, mesh=None):
        from http.server import ThreadingHTTPServer

        from wealy_tpu_torch.cli.main import _load_config

        self.args = args
        self.mesh = mesh
        self.config = _load_config(args.config)
        self.engine = _build_engine(args, self.config)
        self.search_lock = threading.Lock()
        self.failed: Optional[str] = None  # set when a reload lost the corpus
        self.batcher = MicroBatcher(self._dispatch,
                                    window_s=max(0.0, args.batch_window_ms / 1000.0),
                                    max_batch=max(1, args.max_batch))
        self.server = ThreadingHTTPServer((args.host, args.port), _handler(self))
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.args.host}:{self.server.server_address[1]}"

    def _lead(self, *msg) -> None:
        """Send ``msg`` to the other ranks of the mesh (nothing without one)."""
        if self.mesh is not None:
            import torch.distributed as dist

            dist.broadcast_object_list([msg], src=0)

    def _dispatch(self, seqs, opts):
        with self.search_lock:
            if self.failed:
                raise RuntimeError(self.failed)
            self._lead("search", seqs, opts)
            k, pooled, rerank = opts
            return self.engine.search_many(seqs, k=k, pooled=pooled, rerank=rerank)

    def warmup(self) -> float:
        """One synthetic 30 s clip through decode -> embed -> score; seconds."""
        import tempfile
        import time
        import wave

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "warmup.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(b"\x00\x00" * (16000 * 30))
            self._dispatch([self.engine.embed_audio(path)], (1, False, 0))
        return time.perf_counter() - t0

    def reload(self) -> dict:
        """Swap in a new engine on the same index path; the old corpus
        leaves the device first. An index whose meta does not fit the
        config raises before anything is released."""
        with self.search_lock:
            read_index_meta(self.args.index, self.config)
            old = self.engine
            old_n, old_fn, old_step = len(old.keys), old._audio_fn, old.checkpoint_step
            old_meta = dict(old.meta)
            old.release()  # the engine object stays for its keys and meta, its tensors go
            self._lead("reload")
            try:  # an error answer, never a fallback
                new = _build_engine(self.args, self.config)
            except Exception as e:  # noqa: BLE001 - the daemon must not die
                self.failed = (f"reload failed after the previous corpus was released ({e}); "
                               "fix the index and POST /reload, or restart the daemon")
                raise RuntimeError(self.failed) from e
            # the audio embed fn depends on the head and these fields only
            if new.checkpoint_step == old_step and all(
                    old_meta.get(k) == new.meta.get(k) for k in _EMBED_META):
                new._audio_fn = old_fn
            self.engine, self.failed = new, None
        return {"ok": True, "indexed": len(new.keys), "was": old_n,
                "checkpoint_step": new.checkpoint_step}

    def start(self) -> "SearchDaemon":
        """Serve on a background thread."""
        self._thread = threading.Thread(target=self.server.serve_forever, name="serve",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self.server.shutdown()
            self._thread.join(30)
        self.server.server_close()
        self.batcher.close()
        with self.search_lock:
            self._lead("stop")


def _follow(args, mesh) -> None:
    """A rank other than 0 of a ``--shard`` daemon: its share of the corpus
    on its card, running each search and reload rank 0 broadcasts, until
    rank 0 stops. A search that raises here raised on rank 0 too (the same
    queries), which answered it with an error; the loop goes on."""
    import torch.distributed as dist

    from wealy_tpu_torch.cli.main import _load_config

    config = _load_config(args.config)
    engine = _build_engine(args, config)
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        op, *rest = box[0]
        if op == "stop":
            return
        if op == "reload":
            engine.release()
            engine = _build_engine(args, config)
            continue
        seqs, (k, pooled, rerank) = rest
        try:  # an error answer, never a fallback
            engine.search_many(seqs, k=k, pooled=pooled, rerank=rerank)
        except Exception as e:  # noqa: BLE001 - rank 0 answered this search with an error
            print(f"[serve rank {mesh.rank}] search failed: {e}", file=sys.stderr)


def _handler(daemon: SearchDaemon):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # one line per request
            print(f"[serve] {fmt % a}", file=sys.stderr)

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            if daemon.failed:
                return self._send(503, {"ok": False, "error": daemon.failed})
            eng = daemon.engine
            self._send(200, {
                "ok": True, "indexed": len(eng.keys), "model": eng.meta["model"],
                "split": eng.meta["split"], "checkpoint_step": eng.checkpoint_step,
                "exact_sets": eng._has_sets,
                "batch_stats": {"dispatches": daemon.batcher.n_dispatches,
                                "queries": daemon.batcher.n_queries},
            })

        def do_POST(self):
            if self.path == "/reload":
                try:  # an error answer, never a fallback
                    return self._send(200, daemon.reload())
                except Exception as e:  # noqa: BLE001 - the daemon must not die
                    return self._send(400, {"error": str(e)})
            if self.path != "/query":
                return self._send(404, {"error": "unknown path"})
            if daemon.failed:
                return self._send(503, {"error": daemon.failed})
            try:  # an error answer, never a fallback
                out = self._answer()
            except Exception as e:  # noqa: BLE001 - the daemon must not die
                return self._send(400, {"error": str(e)})
            self._send(200, out)

        def _answer(self):
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"] or 0)))
            entries = req.get("batch")
            single = entries is None
            if single:
                entries = [req]
            if not entries:
                raise ValueError("'batch' must be a non-empty list")
            seqs = []
            for e in entries:
                if "embeddings" in e:
                    if daemon.engine.fusion:
                        raise ValueError("fusion indexes answer audio_path queries only (both "
                                         "modalities are computed cold)")
                    seq = np.asarray(e["embeddings"], np.float32)
                    if seq.ndim != 2:
                        raise ValueError("embeddings must be (T, C)")
                elif "audio_path" in e:
                    seq = daemon.engine.embed_audio(e["audio_path"])
                else:
                    raise ValueError("need 'audio_path' or 'embeddings'")
                seqs.append(seq)
            opts = (int(req.get("k", daemon.args.k)), bool(req.get("pooled", daemon.args.pooled)),
                    int(req.get("rerank", daemon.args.rerank)))
            outs = daemon.batcher.submit_many(seqs, opts)
            return outs[0] if single else {"batch": outs}

    return Handler


@contextlib.contextmanager
def serving(args):
    """A :class:`SearchDaemon` serving on a background thread for the
    ``with`` block, shut down when it ends. On a ``--shard`` mesh, rank 0
    serves; another rank follows its searches until it stops, then enters
    the block with None."""
    mesh = _serving_mesh(args)
    if mesh is not None and not mesh.is_primary:
        _follow(args, mesh)
        yield None
        return
    with contextlib.closing(SearchDaemon(args, mesh).start()) as daemon:
        yield daemon


def cmd_serve(args) -> int:
    """Persistent local search daemon (see :class:`SearchDaemon`): the head
    and the index load once. Prints ``{"serving": url, "indexed": n}`` when
    it accepts requests (after ``{"warmup_s": s}`` with ``--warmup``)."""
    resolve_device(args.device)
    mesh = _serving_mesh(args)
    if mesh is not None and not mesh.is_primary:
        _follow(args, mesh)
        return 0
    try:  # an error answer, never a fallback
        daemon = SearchDaemon(args, mesh)
    except ValueError as e:
        print(f"[serve] {e}", file=sys.stderr)
        return 2
    if args.warmup:
        print(json.dumps({"warmup_s": round(daemon.warmup(), 1)}), flush=True)
    print(json.dumps({"serving": daemon.url, "indexed": len(daemon.engine.keys)}), flush=True)
    with contextlib.closing(daemon), contextlib.suppress(KeyboardInterrupt):
        daemon.server.serve_forever()
    return 0
