"""The inputs of tests/test_torch_parallel.py's data-parallel checks, made
from seeds, shared by the ranks (tests/_torch_parallel_worker.py) and the
single-process references. Imports the port only (no JAX)."""

from pathlib import Path

import numpy as np
import torch

from wealy_tpu_torch.models.heads import ProjectionHead, seeded_init_
from wealy_tpu_torch.train.state import create_train_state, make_optimizer

LOSSES = ("clews", "ntxent", "triplet")
B, T, C = 8, 12, 24
STEPS = 3  # step 0 runs at lr 0 (warm-up): two updates that move the parameters
QUANT_SIZES = dict(n_mels=8, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
                   n_audio_layer=3, n_vocab=64, n_text_ctx=8, n_text_state=64, n_text_head=4,
                   n_text_layer=1)


def loss_inputs():
    rng = np.random.default_rng(5)
    labels = torch.from_numpy(np.repeat(np.arange(B // 2, dtype=np.int32), 2))
    ids = torch.arange(B, dtype=torch.int32)
    return labels, ids, torch.from_numpy(rng.normal(size=(B, 16)).astype(np.float32))


def head_state():
    head = seeded_init_(ProjectionHead(C, zdim=16, hidden=(16,)), seed=0)
    return create_train_state(head, make_optimizer(lr=1e-2, warmup_steps=1, max_steps=100),
                              init=False)


def head_batch(n: int = B) -> dict:
    rng = np.random.default_rng(0)
    return {
        "labels": np.repeat(np.arange(n // 2, dtype=np.int32), 2),
        "ids": np.arange(n, dtype=np.int32),
        "emb": rng.normal(size=(n, T, C)).astype(np.float32),
        "mask": np.ones((n, T), bool),
    }


def run_fit(root: Path, mesh) -> dict:
    """3 steps of ``fit`` on a written head-training project, checkpoints
    into ``root / ckpt``: the losses, the checkpoint steps written there and
    the final f32 parameters."""
    from _torch_parity import write_embedding_project
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.losses import get_loss
    from wealy_tpu_torch.train.checkpoint import CheckpointManager
    from wealy_tpu_torch.train.config import Config
    from wealy_tpu_torch.train.loop import MetricsWriter, fit
    from wealy_tpu_torch.train.step import make_train_step

    root.mkdir(parents=True, exist_ok=True)
    config = Config.from_file(write_embedding_project(root))
    ds = EmbeddingDataset(config, "train", seed=config.train.seed)
    head = seeded_init_(ProjectionHead(C, zdim=8, hidden=(8,)), seed=0)
    state = create_train_state(head, make_optimizer(lr=1e-2, warmup_steps=1, max_steps=10),
                               init=False)
    manager = CheckpointManager(root / "ckpt")
    state, writer = fit(state, make_train_step(None, get_loss("clews"), mesh=mesh), ds.sampler,
                        batch_size=4, chunk_size=16, max_steps=STEPS,
                        writer=MetricsWriter(log_every=0), checkpoint_manager=manager,
                        data_seed=config.train.seed, mesh=mesh)
    return {"losses": [h["loss"] for h in writer.history], "ckpt_steps": manager.all_steps(),
            "params": {k: v.clone() for k, v in state.params.items()}}


def quant_encoder_and_mel():
    """The f32 int8 encoder at the JAX quant test's config, quantised from a
    seeded f32 Whisper, and a (4, 8, 64) mel."""
    from wealy_tpu_torch.models.whisper.config import WhisperConfig
    from wealy_tpu_torch.models.whisper.model import Whisper
    from wealy_tpu_torch.models.whisper.quant import (
        QuantWhisperEncoder,
        quantize_encoder_state_dict,
    )

    cfg = WhisperConfig(**QUANT_SIZES)
    model = Whisper(cfg, dtype=torch.float32).init_weights(torch.Generator().manual_seed(0))
    enc = QuantWhisperEncoder(cfg, quantize_encoder_state_dict(model.state_dict(), cfg),
                              dtype=torch.float32, device="cpu").eval()
    mel = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8, 64)).astype(np.float32))
    return enc, mel
