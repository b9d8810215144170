"""Batched extraction over a split, the counterpart of
``wealy_tpu.cli.extract_batched``.

The split jobs pack 30 s chunks from many songs into fixed-size device
batches, keep the host decode running ahead (a thread pool with a bounded,
ordered window, behind :func:`wealy_tpu_torch.utils.prefetch.prefetch`),
and scatter each batch's rows back into per-song accumulators that flush to
the store (or a ``sink``) as soon as a song is complete:

- :func:`extract_split_batched`: ``embed_fn(audio (B, 480000)) -> (B, D)``,
  one row per chunk (``x_concat``, ``hs_wealy_concat``);
- :func:`extract_split_batched_decoder`: ``decode_fn(audio) -> (hidden (B,
  max_len, D), lengths (B,))``; ``hs_last_seq`` keeps each chunk's valid
  positions end to end, ``hs_last_all`` stores (n_chunks, max_len, D) with
  ``lengths``.

The decode threads stay on the host (numpy and the native library, which
releases the GIL); every CUDA call is made on the calling thread, and each
batch costs one device-to-host copy. The last batch is padded with zero
rows to ``batch_size``, so the embed function sees one shape.

The embed functions of the split jobs and of the query path:

- :func:`make_encoder_embed_fn`: mel (K1) -> encoder (K2/K3) -> mean pool,
  one ``x_concat`` row per 30 s chunk (``quant_int8``: the W8A8 encoder of
  ``models/whisper/quant.py``, K1 and K2 with int8 dense layers);
- :func:`make_decoder_embed_fn`: mel -> encoder -> greedy decode ->
  (decoder last hidden states, lengths), the ``hs_last_*`` kinds;
- :func:`make_wealy_embed_fn`: mel -> encoder -> bf16 ``ProjectionHead``.

Each builds the Whisper model once (``model.whisper_size``, weights from an
openai-whisper/HF checkpoint or the seeded init of ``load_whisper_model``)
and returns ``fn(audio)`` for a (B, 480000) batch of 16 kHz chunks. The
decoder factory takes the float8 KV modes (``cross_kv_f8``,
``self_kv_f8``).

On a mesh (``parallel/mesh.py``, one process per card, every rank running
the same loop over the same songs) each batch's rows shard over the
``data`` axis and the outputs are gathered (``shard_rows``): the encoder
job shards its ``embed_fn``, the decoder factory its ``decode_fn``
(``mesh``), and ``tp`` > 1 decodes with the tensor-parallel Whisper of a
(data, model) mesh (``parallel/tp.py``). Only the primary rank writes, so
the files are those one process writes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
from wealy_tpu_torch.audio.mel import N_SAMPLES
from wealy_tpu_torch.cli.extract import load_whisper_model
from wealy_tpu_torch.models.whisper.extract import chunk_waveform
from wealy_tpu_torch.parallel.mesh import barrier, shard_rows
from wealy_tpu_torch.utils.prefetch import prefetch
from wealy_tpu_torch.utils.profiling import ThroughputMeter, trace_span


@dataclasses.dataclass
class _SongAcc:
    version_key: str
    n_chunks: int
    received: int = 0
    embeddings: Optional[np.ndarray] = None  # (n_chunks, D)


def _chunk_stream(ds, limit: Optional[int], n_workers: int = 1
                  ) -> Iterator[Tuple[str, int, int, np.ndarray]]:
    """Yield (version_key, chunk_idx, n_chunks, chunk_audio) on the host.

    ``n_workers > 1`` decodes files on a thread pool with a bounded
    in-flight window of ``2 * n_workers`` songs, in order. Decode is the
    native library and numpy, which release the GIL, so threads decode in
    parallel.
    """
    versions = ds.versions[:limit] if limit else ds.versions
    index_of = {v: i for i, v in enumerate(ds.versions)}

    def chunks_of(version_key, item):
        chunks = chunk_waveform(item.waveform)
        for i in range(chunks.shape[0]):
            yield version_key, i, chunks.shape[0], chunks[i]

    if n_workers <= 1:
        for version_key in versions:
            yield from chunks_of(version_key, ds[index_of[version_key]])
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_workers, thread_name_prefix="decode") as pool:
        pending = deque()
        it = iter(versions)

        def submit_next() -> bool:
            v = next(it, None)
            if v is None:
                return False
            pending.append((v, pool.submit(ds.__getitem__, index_of[v])))
            return True

        for _ in range(2 * n_workers):
            if not submit_next():
                break
        while pending:
            version_key, fut = pending.popleft()
            item = fut.result()
            submit_next()
            yield from chunks_of(version_key, item)


def _host(x) -> np.ndarray:
    """A batch output as f32 numpy (a bf16 tensor through ``float()``: numpy
    has no bf16). For a card tensor this is the batch's one sync."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _schedule(config, metadata, split: str, filename: str, limit, overwrite, skip_fn, mesh):
    """(store, dataset with the versions to run, number skipped): the first
    ``limit`` versions of the split, less those already stored (or in the
    ``skip_fn`` sink) unless ``overwrite``. Every rank of a mesh runs every
    version (its batches shard over the ranks) and takes the same
    schedule: the ranks meet after it, before the primary writes."""
    from wealy_tpu_torch.data.audio_dataset import AudioDataset
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore

    store = EmbeddingStore(config.path.hidden_states, config.data.dataset_name)
    ds = AudioDataset(metadata, split, config.path.data)
    if limit:
        ds.versions = ds.versions[:limit]
    skipped = 0
    if not overwrite:
        exists = skip_fn or (lambda v: store.exists(v, filename))
        versions = [v for v in ds.versions if not exists(v)]
        skipped = len(ds.versions) - len(versions)
        ds.versions = versions
    barrier(mesh)
    return store, ds, skipped


def _writer(mesh, save):
    """``save`` on the primary rank, nothing elsewhere."""
    return save if mesh is None or mesh.is_primary else (lambda v, **arrays: None)


def _batches(ds, batch_size: int, n_workers: int):
    """Lists of up to ``batch_size`` stream entries, the last one partial."""
    pending: List[Tuple[str, int, int, np.ndarray]] = []
    for entry in prefetch(_chunk_stream(ds, None, n_workers=n_workers), depth=2 * batch_size):
        pending.append(entry)
        if len(pending) == batch_size:
            yield pending
            pending = []
    if pending:
        yield pending


def _padded(batch, buf: np.ndarray) -> torch.Tensor:
    """The batch's chunks in the rows of ``buf``, zero rows after them."""
    for i, (_, _, _, chunk) in enumerate(batch):
        buf[i] = chunk
    buf[len(batch):] = 0.0
    return torch.from_numpy(buf)


def _audit(config, store, metadata, filename: str, sink, mesh) -> None:
    """The store's missing-work lists into ``path.cache`` (by the primary
    rank); a custom sink keeps its own account (the npz census would list
    every version)."""
    audit_dir = config.path.cache or config.path.working_dir
    if audit_dir and sink is None and (mesh is None or mesh.is_primary):
        store.verify(metadata, filename, out_dir=audit_dir)


def extract_split_batched(
    config,
    metadata,
    split: str,
    embed_fn: Callable,
    *,
    kind: str = "x_concat",
    batch_size: int = 32,
    mesh=None,
    limit: Optional[int] = None,
    overwrite: bool = False,
    n_workers: int = 4,
    log: Callable[[str], None] = print,
    sink: Optional[Callable] = None,
    skip_fn: Optional[Callable[[str], bool]] = None,
) -> dict:
    """Run one embedding kind over a split with cross-song chunk batching.

    ``embed_fn(audio (batch_size, N_SAMPLES) f32 CPU tensor) -> (B, D)``
    is the device path (mel + encoder [+ head]); it sees one batch shape.
    ``sink(version_key, **arrays)`` replaces the per-version npz write (the
    direct-to-pack path of ``extract --pack-direct``) and
    ``skip_fn(version_key)`` the npz-existence resume check to match it.
    ``mesh``: each batch's rows shard over its ``data`` axis (the outputs
    gathered), and only the primary rank writes.

    Returns {"done": [...], "skipped": n, "incomplete": [...],
    "throughput": ThroughputMeter.report()}.
    """
    filename = f"{kind}.npz"
    store, ds, skipped = _schedule(config, metadata, split, filename, limit, overwrite, skip_fn,
                                   mesh)
    save = _writer(mesh, sink or (lambda v, **arrays: store.save(v, filename, **arrays)))
    embed_fn = shard_rows(mesh, embed_fn)
    meter = ThroughputMeter(window=20, n_chips=1 if mesh is None else mesh.world_size)
    accs: Dict[str, _SongAcc] = {}
    done: List[str] = []
    buf = np.zeros((batch_size, N_SAMPLES), np.float32)

    for batch in _batches(ds, batch_size, n_workers):
        with trace_span("extract.batch"):
            z = _host(embed_fn(_padded(batch, buf)))[: len(batch)]
        meter.tick(len(batch))
        for (version_key, chunk_idx, n_chunks, _), emb in zip(batch, z):
            acc = accs.get(version_key)
            if acc is None:
                acc = accs[version_key] = _SongAcc(version_key, n_chunks)
            if acc.embeddings is None:
                acc.embeddings = np.zeros((n_chunks, emb.shape[-1]), np.float32)
            acc.embeddings[chunk_idx] = emb
            acc.received += 1
            if acc.received == acc.n_chunks:
                save(version_key, embeddings=acc.embeddings)
                done.append(version_key)
                del accs[version_key]
        if done and len(done) % 200 == 0:
            log(f"[extract-batched] {len(done)} songs, {meter.items_per_sec:.0f} chunks/s")

    _audit(config, store, metadata, filename, sink, mesh)
    # a partly filled accumulator is a fault of this job: reported, not stored
    return {"done": done, "skipped": skipped, "incomplete": sorted(accs),
            "throughput": meter.report()}


def extract_split_batched_decoder(
    config,
    metadata,
    split: str,
    decode_fn: Callable,
    *,
    kind: str = "hs_last_seq",
    batch_size: int = 16,
    mesh=None,
    limit: Optional[int] = None,
    overwrite: bool = False,
    n_workers: int = 4,
    log: Callable[[str], None] = print,
    sink: Optional[Callable] = None,
    skip_fn: Optional[Callable[[str], bool]] = None,
) -> dict:
    """Batched decoder-embedding extraction (the ``hs_last_all`` /
    ``hs_last_seq`` kinds and their ``_en`` variants).

    ``decode_fn(audio (batch_size, N_SAMPLES)) -> (hidden (B, max_len, D),
    lengths (B,))``, see :func:`make_decoder_embed_fn`. Chunks of many songs
    share device batches as in :func:`extract_split_batched`; a song stores
    ``hidden (n_chunks, max_len, D)`` + ``lengths`` (``hs_last_all``), or
    its chunks' valid positions end to end (``hs_last_seq``). ``mesh``: the
    mesh ``decode_fn`` runs on (see :func:`make_decoder_embed_fn`); only
    its primary rank writes.
    """
    from wealy_tpu_torch.models.whisper.extract import flatten_decoder_sequence

    filename = f"{kind}.npz"
    flatten = kind.startswith("hs_last_seq")
    store, ds, skipped = _schedule(config, metadata, split, filename, limit, overwrite, skip_fn,
                                   mesh)
    save = _writer(mesh, sink or (lambda v, **arrays: store.save(v, filename, **arrays)))
    meter = ThroughputMeter(window=20, n_chips=1 if mesh is None else mesh.world_size)
    hidden_acc: Dict[str, list] = {}
    length_acc: Dict[str, list] = {}
    done: List[str] = []
    buf = np.zeros((batch_size, N_SAMPLES), np.float32)

    for batch in _batches(ds, batch_size, n_workers):
        with trace_span("extract.batch"):
            hidden, lengths = decode_fn(_padded(batch, buf))
            hidden = _host(hidden)[: len(batch)]
        lengths = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths)
        meter.tick(len(batch))
        for (version_key, chunk_idx, n_chunks, _), hid, L in zip(batch, hidden, lengths):
            hidden_acc.setdefault(version_key, [None] * n_chunks)[chunk_idx] = hid
            length_acc.setdefault(version_key, [0] * n_chunks)[chunk_idx] = int(L)
            if all(h is not None for h in hidden_acc[version_key]):
                hid_all = np.stack(hidden_acc[version_key])  # (n_chunks, max_len, D)
                lens = np.array(length_acc[version_key], np.int32)
                if flatten:
                    save(version_key, embeddings=flatten_decoder_sequence(hid_all, lens))
                else:
                    save(version_key, embeddings=hid_all, lengths=lens)
                done.append(version_key)
                del hidden_acc[version_key], length_acc[version_key]
        if done and len(done) % 200 == 0:
            log(f"[extract-batched] {len(done)} songs, {meter.items_per_sec:.0f} chunks/s")

    _audit(config, store, metadata, filename, sink, mesh)
    return {"done": done, "skipped": skipped, "incomplete": sorted(hidden_acc),
            "throughput": meter.report()}


def _chunks(audio, device) -> torch.Tensor:
    return torch.as_tensor(audio, dtype=torch.float32).to(device)


def make_encoder_embed_fn(config, hf_checkpoint: Optional[str] = None, quant_int8: bool = False,
                          device=None, dtype=torch.bfloat16):
    """``fn(audio (B, 480000)) -> (B, D)``: the mean over time of the
    encoder states, in the model's dtype, on ``device``. ``quant_int8``:
    the W8A8 int8 encoder (``models/whisper/quant.py``), quantised from the
    f32 weights of the checkpoint or the seeded draw."""
    device = resolve_device(device)
    if quant_int8:
        from wealy_tpu_torch.models.whisper.quant import load_quant_encoder

        qenc = load_quant_encoder(config.model.whisper_size, checkpoint=hf_checkpoint,
                                  device=device, dtype=dtype)

        @torch.inference_mode()
        def embed_q(audio):
            mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=qenc.config.n_mels)
            return qenc(mel).mean(dim=1)

        return embed_q
    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device, dtype=dtype)

    @torch.inference_mode()
    def embed(audio):
        mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=wcfg.n_mels)
        return model.encode(mel).mean(dim=1)

    return embed


def make_decoder_embed_fn(config, hf_checkpoint: Optional[str] = None,
                          language: Optional[int] = 0, max_len: int = 224,
                          cross_kv_f8: bool = False, self_kv_f8: bool = False, mesh=None,
                          tp: int = 1, device=None, dtype=torch.bfloat16):
    """``fn(audio (B, 480000)) -> (hidden (B, max_len, D), lengths (B,))``:
    greedy transcription of every chunk with the decoder's last hidden
    state per position (``language=0`` forces English, None omits the
    language and task tokens). ``cross_kv_f8`` / ``self_kv_f8`` store the
    decode's cross-attention K/V / self-attention caches in
    ``torch.float8_e4m3fn`` (cast from the compute dtype, upcast at every
    read), the JAX factory's opt-in bandwidth modes.

    ``mesh``: the batch's rows shard over its ``data`` axis, each rank
    decodes its rows and the outputs are gathered (data-parallel greedy
    decode; the KV caches stay on each rank). ``tp`` > 1: the
    tensor-parallel Whisper (``parallel/tp.py``) on a (data, model) mesh of
    the process group's ranks, ``tp`` ranks to a model, the rows sharded
    over ``data``; not with ``mesh``."""
    from wealy_tpu_torch.models.whisper.extract import decoder_embeddings

    f8 = {"cross_kv_dtype": torch.float8_e4m3fn if cross_kv_f8 else None,
          "self_kv_dtype": torch.float8_e4m3fn if self_kv_f8 else None}
    device = resolve_device(device)
    if tp > 1:
        from wealy_tpu_torch.parallel.tp import make_tp_mesh, tp_module

        if mesh is not None:
            raise ValueError("pass either mesh (data parallel) or tp (> 1), not both")
        mesh = make_tp_mesh(tp, device=device)
        # the whole model on the host, then each rank's shard on its card
        model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                         device="cpu", dtype=dtype)
        model = tp_module(model, mesh)
    else:
        model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                         device=device if mesh is None else mesh.device,
                                         dtype=dtype)
    if mesh is not None:
        device = mesh.device

    @torch.inference_mode()
    def decode_fn(audio):
        mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=wcfg.n_mels)
        out = decoder_embeddings(model, mel, wcfg, language=language, max_len=max_len, **f8)
        return out["hidden"], out["lengths"]

    return shard_rows(mesh, decode_fn)


def bf16_head(head, device):
    """``head`` computing in bf16 on ``device``, its LayerNorms in f32 (the
    JAX head's ``dtype=jnp.bfloat16``)."""
    head = head.to(device=device, dtype=torch.bfloat16)
    for name, module in head.named_modules():
        if name.endswith("norm"):
            module.float()
    return head


def make_wealy_embed_fn(config, hf_checkpoint: Optional[str] = None,
                        head_checkpoint: Optional[str] = None, device=None):
    """``fn(audio (B, 480000)) -> (B, zdim)``: the encoder states through a
    ``ProjectionHead(zdim, hidden=(zdim,))`` computed in bf16 (LayerNorm in
    f32), as the JAX factory's ``dtype=jnp.bfloat16`` head. Head weights
    from ``head_checkpoint`` or ``path.checkpoints`` (a state-dict file, a
    ``train`` payload or a checkpoint directory), else the seeded init."""
    from wealy_tpu_torch.cli.main import read_head_checkpoint, serving_checkpoint
    from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_

    device = resolve_device(device)
    model, wcfg = load_whisper_model(config.model.whisper_size, checkpoint=hf_checkpoint,
                                     device=device)
    zdim = int(config.model.zdim)
    head = ProjectionHead(wcfg.n_audio_state, zdim=zdim, hidden=(zdim,))
    ckpt = serving_checkpoint(head_checkpoint, config)
    if ckpt:
        head.load_state_dict(read_head_checkpoint(ckpt)[0])
    else:
        seeded_init_(head, seed=0)
    head = bf16_head(head, device)

    @torch.inference_mode()
    def embed(audio):
        mel = log_mel_spectrogram_fused(_chunks(audio, device), n_mels=wcfg.n_mels)
        states = model.encode(mel)
        return head(states, torch.ones(states.shape[:2], dtype=torch.bool, device=device))

    return embed
