"""CLEWS acoustic-embedding extraction: audio -> CQT -> window encoder -> the
``hs_clews`` file trio, the counterpart of ``wealy_tpu.models.clews_extract``.

The on-disk layout the multimodal datasets read:
  hs_clews      (N_WINDOWS, embed_dim)   per-window acoustic embeddings
  hs_clews_avg  (embed_dim,)             mean over the valid windows
  hs_clews_mask (N_WINDOWS,) bool        True = INVALID window (ops convention)

The song's CQT frames are laid out into N_WINDOWS (116) windows of
``frames_per_window`` frames; songs shorter than the full span leave
trailing windows invalid, longer songs are cropped. The CQT and the encoder
run on ``device`` (the card unless the caller asks for the CPU).

The default weights are a seeded torch init
(:func:`wealy_tpu_torch.models.clews_encoder.seeded_init_`), drawn on the
CPU so that the card and the CPU get the same encoder; they are not the
JAX package's flax init (``jax.random.PRNGKey``), which torch cannot
reproduce. Carry those with ``models/convert.py`` and pass the state dict
as ``params``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from wealy_tpu_torch import resolve_device
from wealy_tpu_torch.audio.cqt import cqt_multirate, cqt_spectrogram
from wealy_tpu_torch.data.multimodal import CLEWS_SEQ_LEN
from wealy_tpu_torch.models.clews_encoder import ClewsWindowEncoder, seeded_init_

DEFAULT_ENCODER = dict(stem=16, stages=((16, 2), (32, 2)))


def make_clews_extractor(
    n_windows: int = CLEWS_SEQ_LEN,
    frames_per_window: int = 32,
    embed_dim: int = 2048,
    n_bins: int = 84,
    hop: int = 512,
    encoder_kwargs: Optional[dict] = None,
    params: Optional[dict] = None,
    seed: int = 0,
    cqt_method: str = "pseudo",
    device=None,
):
    """Build ``extract(audio (T,)) -> dict`` with the hs_clews trio.

    ``params``: a state dict of the window encoder (weights and running
    statistics); the seeded init of ``seed`` otherwise. ``cqt_method``:
    "pseudo" (triangular filterbank on the STFT, default) or "multirate"
    (the exact constant-Q transform)."""
    if cqt_method not in ("pseudo", "multirate"):
        raise ValueError(f"unknown cqt_method {cqt_method!r}")
    device = resolve_device(device)
    enc = ClewsWindowEncoder(n_windows=n_windows, embed_dim=embed_dim,
                             encoder_kwargs=encoder_kwargs or DEFAULT_ENCODER)
    if params is None:
        seeded_init_(enc, seed)
    else:
        enc.load_state_dict(params)
    enc = enc.to(device).eval()
    total_frames = n_windows * frames_per_window
    samples_per_window = frames_per_window * hop
    cqt_fn = cqt_multirate if cqt_method == "multirate" else cqt_spectrogram

    @torch.inference_mode()
    def extract(audio: np.ndarray) -> dict:
        audio = np.asarray(audio, np.float32)
        n_valid = min(n_windows, max(1, int(np.ceil(len(audio) / samples_per_window))))
        need = total_frames * hop
        audio = np.pad(audio, (0, need - len(audio))) if len(audio) < need else audio[:need]
        cqt = cqt_fn(audio, n_bins=n_bins, hop=hop, device=device)[:, :total_frames]
        if cqt.shape[1] < total_frames:
            cqt = torch.nn.functional.pad(cqt, (0, total_frames - cqt.shape[1]))
        z = enc(cqt[None, None]).float().cpu().numpy()[0]  # (n_windows, D)
        mask = np.ones((n_windows,), bool)  # True = invalid
        mask[:n_valid] = False
        valid = ~mask
        avg = z[valid].mean(axis=0) if valid.any() else np.zeros((embed_dim,), np.float32)
        return {"hs_clews": z, "hs_clews_avg": avg, "hs_clews_mask": mask}

    return extract


def extract_clews_split(
    config,
    metadata,
    split: str,
    *,
    extractor: Optional[Callable] = None,
    limit: Optional[int] = None,
    overwrite: bool = False,
    log: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Write the hs_clews trio of every version of a split (resumable:
    versions with an ``hs_clews.npz`` are skipped unless ``overwrite``). A
    song's own failure (out of device memory, a store write) is recorded in
    ``failed`` and the split goes on; any other error raises. Returns
    {"done": [...], "skipped": [...], "failed": [...]}."""
    from wealy_tpu_torch.cli.extract import _SongFailure
    from wealy_tpu_torch.data.audio_dataset import AudioDataset
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore

    store = EmbeddingStore(config.path.hidden_states, config.data.dataset_name)
    ds = AudioDataset(metadata, split, config.path.data)
    done, skipped, failed = [], [], []
    versions = ds.versions[:limit] if limit else ds.versions
    for i, version_key in enumerate(versions):
        if not overwrite and store.exists(version_key, "hs_clews.npz"):
            skipped.append(version_key)
            continue
        if extractor is None:  # built on the first song to extract
            extractor = make_clews_extractor(
                cqt_method=getattr(config.model, "cqt_method", "pseudo"), device=device)
        item = ds[i]
        with _SongFailure(version_key, failed, log):
            out = extractor(item.waveform)
            for kind in ("hs_clews", "hs_clews_avg", "hs_clews_mask"):
                store.save(version_key, f"{kind}.npz", embeddings=out[kind])
            done.append(version_key)
    return {"done": done, "skipped": skipped, "failed": failed}
