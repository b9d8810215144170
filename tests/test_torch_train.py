"""CPU parity of the port's training path (wealy_tpu_torch.train, the
training collate, the seekable sampler stream, prefetch, checkpoints and
the ``train`` CLI) with the JAX package, from the same numpy inputs and the
same weights (carried across by the weight bridges).

Tolerances: the optimizer against optax rtol 1e-5 / atol 1e-7; train-step
losses rtol 1e-5; ``grad_accum`` against single-pass params atol 2e-6 (as
tests/test_train.py); params against the JAX step, and every parameter of
the encoder+head step, rtol 1e-4 / atol 1e-5 (as tests/test_pp.py)."""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from wealy_tpu.data.metadata import Metadata as JMetadata
from wealy_tpu.data.sampler import CliqueSampler as JCliqueSampler
from wealy_tpu.losses import clews_loss as jclews_loss
from wealy_tpu.models.heads import ProjectionHead as JProjectionHead
from wealy_tpu.models.whisper.config import WhisperConfig as JWhisperConfig
from wealy_tpu.models.whisper.model import WhisperEncoder as JWhisperEncoder
from wealy_tpu.train.loop import MetricsWriter as JMetricsWriter
from wealy_tpu.train.loop import fit as jfit
from wealy_tpu.train.state import TrainState as JTrainState
from wealy_tpu.train.state import create_train_state as jcreate_train_state
from wealy_tpu.train.state import make_optimizer as jmake_optimizer
from wealy_tpu.train.step import make_train_step as jmake_train_step
from wealy_tpu_torch.cli import main as tcli
from wealy_tpu_torch.data.dataset import EmbeddingDataset
from wealy_tpu_torch.data.metadata import Metadata
from wealy_tpu_torch.data.sampler import CliqueSampler
from wealy_tpu_torch.losses import clews_loss
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.models.heads import ProjectionHead
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.convert import encoder_state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.model import WhisperEncoder
from wealy_tpu_torch.train.checkpoint import CheckpointManager
from wealy_tpu_torch.train.config import Config
from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
from wealy_tpu_torch.train.loop import MetricsWriter, batch_to_device, fit
from wealy_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from wealy_tpu_torch.train.step import (
    loss_and_grads,
    make_eval_embed_step,
    make_train_step,
    upcast_batch,
)
from wealy_tpu_torch.utils.prefetch import prefetch

from test_cli import project  # noqa: F401  (the shared fixture)

REPO = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).copy(), tree)


def _assert_params(got: dict, want: dict, rtol: float, atol: float):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().float().cpu().numpy(),
                                   want[name].numpy(), rtol=rtol, atol=atol, err_msg=name)


# --- optimizer ---------------------------------------------------------------


@pytest.mark.parametrize("warmup,max_steps", [(2, 10), (3, 8), (1, 1), (5, 100)])
def test_schedule_matches_optax(warmup, max_steps):
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, max(max_steps, warmup + 1),
                                              end_value=3e-5)
    tx = make_optimizer(lr=3e-3, warmup_steps=warmup, max_steps=max_steps)
    for count in range(0, 2 * max_steps + 3):
        # optax evaluates the schedule in f32
        np.testing.assert_allclose(tx.learning_rate(count), float(want(count)), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_optimizer_matches_optax(grad_scale):
    """Three updates with warmup 2: step 0 runs at lr 0 (params unchanged),
    steps 1-2 match optax; grad_scale 10 puts the global norm above 1 (the
    clip scales), 0.01 below it (the clip keeps)."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(5, 3), nn.LayerNorm(3))
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    kw = dict(lr=0.1, weight_decay=1e-2, warmup_steps=2, max_steps=10)
    tx = jmake_optimizer(**kw)
    jp = {n: jnp.asarray(v) for n, v in start.items()}
    opt = tx.init(jp)
    state = TrainState(model, make_optimizer(**kw))
    rng = np.random.default_rng(1)
    for i in range(3):
        grads = {n: (grad_scale * rng.normal(size=v.shape)).astype(np.float32)
                 for n, v in start.items()}
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values()))
        assert (norm > 1) == (grad_scale > 1)
        updates, opt = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, opt, jp)
        jp = optax.apply_updates(jp, updates)
        state.apply_gradients({n: torch.from_numpy(g) for n, g in grads.items()})
        if i == 0:
            for n, p in model.named_parameters():
                np.testing.assert_array_equal(p.detach().numpy(), start[n])
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {n}")
    assert state.step == 3 and state.opt_state["count"] == 3


def test_clip_is_optax_not_clip_grad_norm():
    """At global norm 1.5 the clipped gradient is g / norm * 1 = 1.0
    exactly (torch's clip_grad_norm_ would divide by norm + 1e-6)."""
    model = nn.Linear(1, 1, bias=False)
    state = TrainState(model, make_optimizer(lr=1.0, weight_decay=0.0, warmup_steps=0))
    state.apply_gradients({"weight": torch.full((1, 1), 1.5)})
    want = torch.zeros(1, 1).mul_(0.9).add_(torch.ones(1, 1), alpha=0.1)
    assert torch.equal(state.opt_state["mu"]["weight"], want)


def test_bf16_weights_keep_f32_masters():
    """bf16 compute with f32 params: an update below one bf16 ulp of the
    weight accumulates in the master instead of rounding away."""
    model = nn.Linear(4, 4, bias=False, dtype=torch.bfloat16)
    with torch.no_grad():
        model.weight.fill_(1.0)
    state = TrainState(model, make_optimizer(lr=1e-4, weight_decay=0.0, warmup_steps=1,
                                             max_steps=1000))
    assert state.params["weight"].dtype == torch.float32
    one_ulp = 2.0**-7  # bf16 spacing just below 1.0 is 2**-8; above, 2**-7
    assert torch.tensor(1.0 - 1e-4).bfloat16().item() == 1.0  # a bare bf16 update is lost
    for _ in range(101):
        state.apply_gradients({"weight": torch.full((4, 4), 0.25)})
    master = state.params["weight"]
    # a constant gradient moves each step by the learning rate (step 0 at lr 0)
    travelled = sum(state.tx.learning_rate(c) for c in range(101))
    np.testing.assert_allclose(master.numpy(), 1.0 - travelled, rtol=1e-5)
    assert model.weight.dtype == torch.bfloat16
    assert torch.equal(model.weight.data, master.bfloat16())
    assert model.weight[0, 0].item() < 1.0 - one_ulp / 2


# --- head train step against JAX ------------------------------------------------

B, T, C = 8, 12, 16


def _head_batch():
    rng = np.random.default_rng(0)
    return {
        "labels": np.repeat(np.arange(B // 2, dtype=np.int32), 2),
        "ids": np.arange(B, dtype=np.int32),
        "emb": rng.normal(size=(B, T, C)).astype(np.float32),
        "mask": np.ones((B, T), bool),
    }


@pytest.fixture(scope="module")
def jax_head_runs():
    """The JAX head step (ProjectionHead(zdim=16, hidden=(16,)), lr 1e-2,
    warmup 1) for 2 steps at grad_accum 1, 2, 4: the initial params and
    each run's losses and final params."""
    model = JProjectionHead(zdim=16, hidden=(16,))
    tx = jmake_optimizer(lr=1e-2, warmup_steps=1, max_steps=100)
    init = jcreate_train_state(model, (jnp.zeros((B, T, C)), jnp.ones((B, T), bool)), tx=tx)
    p0 = _np(init.params)
    runs = {}
    for n in (1, 2, 4):
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=p0, opt_state=tx.init(p0),
                            tx=tx)
        step = jmake_train_step(model, jclews_loss, grad_accum=n)
        losses = []
        for _ in range(2):
            state, ld = step(state, dict(_head_batch()))
            losses.append(float(ld["loss"]))
        runs[n] = (losses, head_state_dict_from_jax_params(_np(state.params)))
    return head_state_dict_from_jax_params(p0), runs


def _port_head_state(sd):
    head = ProjectionHead(C, zdim=16, hidden=(16,))
    head.load_state_dict(sd)
    return create_train_state(head, make_optimizer(lr=1e-2, warmup_steps=1, max_steps=100),
                              init=False)


@pytest.mark.parametrize("grad_accum", [1, 2, 4])
def test_head_step_matches_jax_and_single_pass(jax_head_runs, grad_accum):
    sd0, runs = jax_head_runs
    state = _port_head_state(sd0)
    step = make_train_step(None, clews_loss, grad_accum=grad_accum)
    losses = []
    for i in range(2):
        state, ld = step(state, dict(_head_batch()))
        losses.append(float(ld["loss"]))
        if i == 0:  # step 0 runs at lr 0
            _assert_params(state.params, sd0, rtol=0, atol=0)
            np.testing.assert_allclose(float(ld["uniformity_weight"]), 0.5 / 1000, rtol=1e-6)
    jl, jparams = runs[grad_accum]
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    _assert_params(state.params, jparams, rtol=1e-4, atol=1e-5)
    if grad_accum > 1:  # against the port's own single pass
        single = _port_head_state(sd0)
        step1 = make_train_step(None, clews_loss)
        for _ in range(2):
            single, ld1 = step1(single, dict(_head_batch()))
        np.testing.assert_allclose(losses[-1], float(ld1["loss"]), rtol=1e-5)
        _assert_params(state.params, {k: v.detach() for k, v in single.params.items()},
                       rtol=0, atol=2e-6)


def test_step_refusals_are_the_jax_refusals_and_a_one_rank_mesh_is_plain():
    state = _port_head_state(ProjectionHead(C, zdim=16, hidden=(16,)).state_dict())
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(None, clews_loss, grad_accum=3)(state, dict(_head_batch()))
    # the mesh step came with the parallel/ slice (two ranks:
    # tests/test_torch_parallel.py); on a one-rank mesh it is the plain step
    from wealy_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    plain = _port_head_state(ProjectionHead(C, zdim=16, hidden=(16,)).state_dict())
    sd = {k: v.clone() for k, v in plain.model.state_dict().items()}
    on_mesh = _port_head_state(sd)
    for _ in range(2):
        plain, lp = make_train_step(None, clews_loss)(plain, dict(_head_batch()))
        on_mesh, lm = make_train_step(None, clews_loss, mesh=mesh)(on_mesh, dict(_head_batch()))
        assert float(lm["loss"]) == float(lp["loss"])
    _assert_params(on_mesh.params, {k: v.detach() for k, v in plain.params.items()}, 0, 0)
    # the BatchNorm step is ported (tests/test_torch_clews.py); what it
    # refuses is what JAX refuses: grad_accum with BatchNorm
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(None, clews_loss, with_batch_stats=True, grad_accum=2)
    batch = upcast_batch(_head_batch())
    embed = make_eval_embed_step(plain.model, mesh=mesh)
    assert torch.equal(embed(batch["emb"], batch["mask"]),
                       make_eval_embed_step(plain.model)(batch["emb"], batch["mask"]))


def test_upcast_batch_and_eval_embed_step():
    b = upcast_batch({"emb": np.ones((2, 3), np.float16), "ids": np.arange(2, dtype=np.int32),
                      "x": torch.ones(2, dtype=torch.bfloat16)})
    assert b["emb"].dtype == torch.float32 and b["x"].dtype == torch.float32
    assert b["ids"].dtype == torch.int32
    head = ProjectionHead(C, zdim=16, hidden=(16,))
    batch = _head_batch()
    emb, mask = torch.from_numpy(batch["emb"]), torch.from_numpy(batch["mask"])
    z = make_eval_embed_step(head)(emb, mask)
    assert z.grad_fn is None
    torch.testing.assert_close(z, head(emb, mask).detach())


# --- the slice: encoder + head, against JAX ---------------------------------------

CFG = dict(n_mels=8, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
           n_vocab=64, n_text_ctx=8, n_text_state=128, n_text_head=2, n_text_layer=1)


def _slice_batch():
    """A per-clip, per-bin offset keeps the clips' embeddings apart: with
    near-identical z, the loss's 1 - cos cancels and magnifies f32 rounding."""
    rng = np.random.default_rng(4)
    mel = rng.normal(size=(4, 8, 512)) + rng.normal(size=(4, 8, 1))
    return {"emb": mel.astype(np.float32),
            "labels": np.repeat(np.arange(2, dtype=np.int32), 2),
            "ids": np.arange(4, dtype=np.int32)}


@pytest.fixture(scope="module")
def jax_slice_run():
    """The JAX encoder (f32; Dh 64 and T 256, so flash_mha's custom_vjp)
    plus ProjectionHead through make_train_step with tests/test_pp.py's
    single-device model_call, lr 1e-3, warmup 1, 2 steps."""
    cfg = JWhisperConfig(**CFG)
    enc = JWhisperEncoder(cfg, dtype=jnp.float32, scan_layers=False)
    head = JProjectionHead(zdim=16, hidden=(16,), dtype=jnp.float32)
    mel = jnp.asarray(_slice_batch()["emb"])
    enc_p = enc.init(jax.random.PRNGKey(0), mel)["params"]
    states0 = jnp.zeros((4, cfg.n_audio_ctx, cfg.n_audio_state))
    head_p = head.init(jax.random.PRNGKey(1), states0, jnp.ones((4, cfg.n_audio_ctx), bool))
    p0 = _np({"encoder": enc_p, "head": head_p["params"]})

    def call_sd(p, b):
        states = enc.apply({"params": p["encoder"]}, b["emb"])
        return head.apply({"params": p["head"]}, states, jnp.ones(states.shape[:2], bool))

    tx = jmake_optimizer(lr=1e-3, warmup_steps=1, max_steps=10)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=jax.tree_util.tree_map(
        jnp.asarray, p0), opt_state=tx.init(p0), tx=tx)
    step = jmake_train_step(head, jclews_loss, mesh=None, model_call=call_sd)
    losses = []
    for _ in range(2):
        state, ld = step(state, dict(_slice_batch()))
        losses.append(float(ld["loss"]))
    return p0, losses, _np(state.params)


def _port_sd(p):
    sd = encoder_state_dict_from_jax_params(p["encoder"], "encoder.")
    sd.update({f"head.{k}": v for k, v in head_state_dict_from_jax_params(p["head"]).items()})
    return sd


def test_encoder_head_step_matches_jax(jax_slice_run):
    p0, jlosses, jparams = jax_slice_run
    model = EncoderHead(WhisperEncoder(WhisperConfig(**CFG), dtype=torch.float32),
                        ProjectionHead(128, zdim=16, hidden=(16,)))
    model.load_state_dict(_port_sd(p0))
    state = create_train_state(model, make_optimizer(lr=1e-3, warmup_steps=1, max_steps=10),
                               init=False)
    step = make_train_step(None, clews_loss, model_call=encoder_head_call)
    losses = []
    for _ in range(2):
        state, ld = step(state, dict(_slice_batch()))
        losses.append(float(ld["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = _port_sd(jparams)
    assert "encoder.positional_embedding" in state.params  # a parameter, as in JAX
    _assert_params(state.params, want, rtol=1e-4, atol=1e-5)


def test_bf16_encoder_head_step_keeps_f32_params():
    """The production dtype on the CPU: bf16 encoder weights, f32 masters;
    the step trains every parameter and the loss is finite."""
    cfg = WhisperConfig(**CFG)
    torch.manual_seed(0)
    model = EncoderHead(WhisperEncoder(cfg, dtype=torch.bfloat16),
                        ProjectionHead(128, zdim=16, hidden=(16,)))
    for name, p in model.named_parameters():
        if p.dim() > 1 and name != "encoder.positional_embedding":
            nn.init.normal_(p, std=p[0].numel() ** -0.5)
    state = create_train_state(model, make_optimizer(lr=1e-3, warmup_steps=1, max_steps=10),
                               init=False)
    assert model.encoder.blocks[0].attn.query.weight.dtype == torch.bfloat16
    assert {t.dtype for t in state.params.values()} == {torch.float32}
    before = {k: v.clone() for k, v in state.params.items()}
    step = make_train_step(None, clews_loss, model_call=encoder_head_call)
    for _ in range(2):
        state, ld = step(state, dict(_slice_batch()))
        assert np.isfinite(float(ld["loss"]))
    moved = [k for k in before if not torch.equal(before[k], state.params[k])]
    assert len(moved) == len(before)
    w = model.encoder.blocks[0].mlp[0].weight
    assert torch.equal(w.data, state.params["encoder.blocks.0.mlp.0.weight"].bfloat16())


def test_grad_accum_through_the_encoder():
    """GradCache on the encoder+head: the f32 gradients of two chunks equal
    the single pass's."""
    model = EncoderHead(WhisperEncoder(WhisperConfig(**CFG), dtype=torch.float32),
                        ProjectionHead(128, zdim=16, hidden=(16,)))
    state = create_train_state(model, seed=3)
    l1, _, g1 = loss_and_grads(state, _slice_batch(), clews_loss, encoder_head_call)
    l2, _, g2 = loss_and_grads(state, _slice_batch(), clews_loss, encoder_head_call, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for name in g1:
        torch.testing.assert_close(g2[name], g1[name], rtol=1e-4, atol=1e-7, msg=name)


# --- data, loop, checkpoints ------------------------------------------------------


def _toy_mds(n_cliques=4, n_versions=4):
    """The same toy metadata for the port and for the JAX package."""
    info, splits = {}, {"train": {}, "val": {}, "test": {}}
    for ci in range(n_cliques):
        clique = f"c{ci}"
        splits["train"][clique] = []
        for v in range(n_versions):
            key = f"{clique}-{v}"
            info[key] = {"id": ci * 100 + v, "clique": clique, "clique_idx": ci,
                         "version_idx": len(info), "filename": key, "version_key": key}
            splits["train"][clique].append(key)
    return (Metadata("lyric-covers", info, splits),
            JMetadata("lyric-covers", json.loads(json.dumps(info)), json.loads(json.dumps(splits))))


def _det_loader(key, T=12, C=16):
    """Each version's embedding is a pure function of its key."""
    clique = key.split("-")[0]
    center = np.random.default_rng(zlib.crc32(clique.encode())).normal(size=(C,))
    noise = np.random.default_rng(zlib.crc32(key.encode())).normal(size=(T, C)) * 0.3
    return (center[None, :] + noise).astype(np.float32)


def test_epoch_batches_and_collate_match_jax():
    md, jmd = _toy_mds()
    tsam = CliqueSampler(md, "train", _det_loader, n_per_class=2, seed=3, augment=True)
    jsam = JCliqueSampler(jmd, "train", _det_loader, n_per_class=2, seed=3, augment=True)
    from wealy_tpu.data.chunking import collate_fixed_length as jcollate
    from wealy_tpu.data.chunking import select_wealy_chunk as jselect
    from wealy_tpu_torch.data.chunking import collate_fixed_length, select_wealy_chunk

    for epoch, start in ((0, 0), (1, 2), (5, 1)):
        for (tb, trng, titems), (jb, jrng, jitems) in zip(
                tsam.epoch_batches(epoch, 4, start), jsam.epoch_batches(epoch, 4, start)):
            assert tb == jb
            a = collate_fixed_length(titems, chunk_size=8, use_random_chunks=True, rng=trng)
            b = jcollate(jitems, chunk_size=8, use_random_chunks=True, rng=jrng)
            for x, y in zip(a.flatten_versions(), b.flatten_versions()):
                np.testing.assert_array_equal(x, y)
    assert tsam.n_batches(4) == 4
    wealy = np.arange(12.0).reshape(3, 4)
    for mode in ("random", "deterministic", "all"):
        np.testing.assert_array_equal(
            select_wealy_chunk(wealy, mode, np.random.default_rng(0)),
            jselect(wealy, mode, np.random.default_rng(0)))


def _toy_fit(tmp_path, max_steps, ckpt=None, start=None, state=None):
    md, _ = _toy_mds()
    sampler = CliqueSampler(md, "train", _det_loader, n_per_class=2, seed=3)
    if state is None:
        state = create_train_state(ProjectionHead(16, zdim=8, hidden=(16,)),
                                   make_optimizer(lr=3e-3, warmup_steps=2, max_steps=50), seed=0)
    kw = dict(batch_size=4, chunk_size=12, data_seed=3)
    if start:
        kw.update(start_epoch=start["epoch"], start_batch=start["next_batch"])
    _, w = fit(state, make_train_step(None, clews_loss), sampler, max_steps=max_steps,
               writer=MetricsWriter(log_every=0), checkpoint_manager=ckpt,
               checkpoint_every=5, **kw)
    return state, [h["loss"] for h in w.history]


def test_fit_matches_jax_trajectory():
    """fit with the seekable stream: 12 steps (3 epochs of 4 batches) from
    the same head weights give the JAX package's losses."""
    _, jmd = _toy_mds()
    jsam = JCliqueSampler(jmd, "train", _det_loader, n_per_class=2, seed=3)
    jmodel = JProjectionHead(zdim=8, hidden=(16,))
    jstate = jcreate_train_state(jmodel, (jnp.zeros((4, 12, 16)), jnp.ones((4, 12), bool)),
                                 tx=jmake_optimizer(lr=3e-3, warmup_steps=2, max_steps=50))
    head = ProjectionHead(16, zdim=8, hidden=(16,))
    head.load_state_dict(head_state_dict_from_jax_params(_np(jstate.params)))
    state = create_train_state(head, make_optimizer(lr=3e-3, warmup_steps=2, max_steps=50),
                               init=False)
    _, jw = jfit(jstate, jmake_train_step(jmodel, jclews_loss), jsam, batch_size=4,
                 chunk_size=12, data_seed=3, max_steps=12, writer=JMetricsWriter(log_every=0))
    md, _ = _toy_mds()
    sampler = CliqueSampler(md, "train", _det_loader, n_per_class=2, seed=3)
    _, w = fit(state, make_train_step(None, clews_loss), sampler, batch_size=4, chunk_size=12,
               data_seed=3, max_steps=12, writer=MetricsWriter(log_every=0))
    np.testing.assert_allclose([h["loss"] for h in w.history],
                               [h["loss"] for h in jw.history], rtol=1e-4)


@pytest.mark.parametrize("epochs,max_steps", [(1, 1000), (2, 1000), (2, 5)])
def test_fit_epochs_stop_where_jax_stops(epochs, max_steps):
    """``fit(epochs=N)`` stops after N whole epochs (4 batches each here)
    unless ``max_steps`` comes first, at the JAX loop's step and with its
    losses; ``prefetch_depth`` changes no value."""
    _, jmd = _toy_mds()
    jsam = JCliqueSampler(jmd, "train", _det_loader, n_per_class=2, seed=3)
    jmodel = JProjectionHead(zdim=8, hidden=(16,))
    jstate = jcreate_train_state(jmodel, (jnp.zeros((4, 12, 16)), jnp.ones((4, 12), bool)),
                                 tx=jmake_optimizer(lr=3e-3, warmup_steps=2, max_steps=50))
    jstate, jw = jfit(jstate, jmake_train_step(jmodel, jclews_loss), jsam, batch_size=4,
                      chunk_size=12, data_seed=3, max_steps=max_steps, epochs=epochs,
                      prefetch_depth=1, writer=JMetricsWriter(log_every=0))
    steps = []
    for depth in (1, 3):
        head = ProjectionHead(16, zdim=8, hidden=(16,))
        head.load_state_dict(head_state_dict_from_jax_params(_np(jcreate_train_state(
            jmodel, (jnp.zeros((4, 12, 16)), jnp.ones((4, 12), bool))).params)))
        state = create_train_state(head, make_optimizer(lr=3e-3, warmup_steps=2, max_steps=50),
                                   init=False)
        md, _ = _toy_mds()
        sampler = CliqueSampler(md, "train", _det_loader, n_per_class=2, seed=3)
        state, w = fit(state, make_train_step(None, clews_loss), sampler, batch_size=4,
                       chunk_size=12, data_seed=3, max_steps=max_steps, epochs=epochs,
                       prefetch_depth=depth, writer=MetricsWriter(log_every=0))
        steps.append(int(state.step))
        np.testing.assert_allclose([h["loss"] for h in w.history],
                                   [h["loss"] for h in jw.history], rtol=1e-4)
    assert steps == [int(jstate.step)] * 2 == [min(4 * epochs, max_steps)] * 2


def test_seeded_resume_matches_uninterrupted(tmp_path):
    _, full = _toy_fit(tmp_path, 12)
    ck = CheckpointManager(tmp_path / "ck")
    _toy_fit(tmp_path, 5, ckpt=ck)
    ds = ck.restore_data_state()
    assert ds == {"epoch": 1, "next_batch": 1, "data_seed": 3, "batch_size": 4}
    state = create_train_state(ProjectionHead(16, zdim=8, hidden=(16,)),
                               make_optimizer(lr=3e-3, warmup_steps=2, max_steps=50), seed=7)
    state = ck.restore_state(state)
    assert state.step == 5 and state.opt_state["count"] == 5
    _, resumed = _toy_fit(tmp_path, 12, start=ds, state=state)
    np.testing.assert_allclose(resumed, full[5:], rtol=1e-6)


def test_checkpoint_round_trip_and_pruning(tmp_path):
    state, _ = _toy_fit(tmp_path, 3)
    ck = CheckpointManager(tmp_path / "ck", keep_n=2)
    for _ in range(3):
        ck.save_state(state, data_state={"epoch": 0, "next_batch": state.step})
        state.step += 1
    assert ck.all_steps() == [4, 5] and ck.latest_step() == 5
    assert not (tmp_path / "ck" / "data_state_3.json").exists()
    payload = ck.restore()
    assert set(payload) == {"step", "params", "opt_state"}
    fresh = create_train_state(ProjectionHead(16, zdim=8, hidden=(16,)), seed=9)
    fresh = ck.restore_state(fresh)
    assert fresh.step == 5 and fresh.opt_state["count"] == state.opt_state["count"]
    for name, p in state.params.items():
        assert torch.equal(fresh.params[name], p)
        assert torch.equal(fresh.opt_state["nu"][name], state.opt_state["nu"][name])
    head = ProjectionHead(16, zdim=8, hidden=(16,))
    head.load_state_dict(payload["params"])  # the payload's params are a state dict
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


def test_fit_on_the_cli_project(project):  # noqa: F811
    _, cpath, _ = project
    config = Config.from_file(cpath)
    ds = EmbeddingDataset(config, "train", seed=0)
    state = create_train_state(ProjectionHead(24, zdim=16, hidden=(16,)),
                               make_optimizer(lr=3e-3, warmup_steps=1, max_steps=6))
    step = make_train_step(None, clews_loss)
    state, w = fit(state, step, ds.sampler, batch_size=4, chunk_size=8, max_steps=6,
                   writer=MetricsWriter(log_every=0), data_seed=config.train.seed)
    losses = [h["loss"] for h in w.history]
    assert len(losses) == 6 and np.isfinite(losses).all() and state.step == 6
    with pytest.raises(ValueError, match="no batches"):
        fit(state, step, ds.sampler, batch_size=10 * len(ds.sampler.versions), chunk_size=8,
            max_steps=8)
    # fit on a one-rank mesh takes the same steps (two ranks:
    # tests/test_torch_parallel.py)
    from wealy_tpu_torch.parallel.mesh import make_mesh

    runs = []
    for mesh in (None, make_mesh(device="cpu")):
        s0 = create_train_state(ProjectionHead(24, zdim=16, hidden=(16,)),
                                make_optimizer(lr=3e-3, warmup_steps=1, max_steps=6))
        _, wm = fit(s0, make_train_step(None, clews_loss, mesh=mesh), ds.sampler, batch_size=4,
                    chunk_size=8, max_steps=3, writer=MetricsWriter(log_every=0),
                    data_seed=config.train.seed, mesh=mesh)
        runs.append([h["loss"] for h in wm.history])
    assert runs[0] == runs[1] and len(runs[0]) == 3


def test_batch_to_device_layout():
    from wealy_tpu_torch.data.chunking import collate_fixed_length

    items = [(i, [(10 * i + k, _det_loader(f"c{i}-{k}")) for k in range(2)]) for i in range(3)]
    b = batch_to_device(collate_fixed_length(items, chunk_size=8))
    assert b["labels"].tolist() == [0, 0, 1, 1, 2, 2] and b["ids"].dtype == torch.int32
    assert b["emb"].shape == (6, 8, 16) and b["emb"].dtype == torch.float16
    assert b["mask"].dtype == torch.bool


def test_metrics_writer_defers_and_persists(tmp_path):
    lines = []
    w = MetricsWriter(log_every=2, printer=lines.append, jsonl_path=str(tmp_path / "m.jsonl"))
    w.write(1, {"loss": torch.tensor(0.5), "vec": torch.ones(3)})
    assert w._pending and not lines
    w.write(2, {"loss": torch.tensor(0.25)})
    assert lines == ["[step 2] loss=0.25"]
    w.close()
    recs = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2] and recs[0]["loss"] == 0.5
    assert "vec" not in recs[0] and "t" in recs[0]


def test_prefetch_order_errors_and_early_exit():
    import time

    assert list(prefetch(range(10), depth=3)) == list(range(10))
    assert list(prefetch([1, 2, 3], transform=lambda x: x * 2)) == [2, 4, 6]

    def bad():
        yield 1
        raise ValueError("boom")

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)

    def slow():
        for i in range(5):
            time.sleep(0.02)
            yield i

    t0 = time.perf_counter()
    for _ in prefetch(slow(), depth=4):
        time.sleep(0.02)
    assert time.perf_counter() - t0 < 0.18  # serial would be about 0.2 s
    pulled = []
    for x in prefetch(map(lambda i: pulled.append(i) or i, range(1000)), depth=2):
        if x == 3:
            break
    time.sleep(0.05)
    assert len(pulled) < 10


# --- the train CLI ---------------------------------------------------------------


def test_train_cli_then_evaluate_reads_its_head(project, capsys):  # noqa: F811
    """``python -m wealy_tpu_torch.cli.main train --max-steps 4`` prints its
    JSON line and saves a payload; ``evaluate --checkpoint`` reads the head
    from the payload file and from the directory, and a resumed run
    continues from step 4."""
    tmp, cpath, _ = project
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "wealy_tpu_torch.cli.main", "train", "--config", str(cpath),
         "--max-steps", "4", "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["final_step"] == 4 and np.isfinite(out["final_loss"])
    ckdir = tmp / "ckpt"
    assert CheckpointManager(ckdir).latest_step() == 4
    metrics = []
    for ck in (str(ckdir), str(ckdir / "ckpt_4.pt")):
        assert tcli.main(["evaluate", "--config", str(cpath), "--split", "test",
                          "--checkpoint", ck, "--device", "cpu"]) == 0
        metrics.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert metrics[0] == metrics[1] and metrics[0]["n_queries"] == 4
    seeded = tcli.main(["evaluate", "--config", str(cpath), "--split", "test", "--device",
                        "cpu"])
    assert seeded == 0
    capsys.readouterr()
    assert tcli.main(["train", "--config", str(cpath), "--max-steps", "6", "--device",
                      "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_step"] == 6


@pytest.mark.parametrize("name", ["wealy-clews", "multimodal-concatenation"])
def test_train_cli_fusion_models_train_and_checkpoint(project, name, capsys):  # noqa: F811
    """The fusion names train through the CLI now (the slice is ported): the
    configured max_steps, a finite loss and a checkpoint
    (tests/test_torch_fusion_cli.py holds them against JAX)."""
    tmp, cpath, _ = project
    conf = json.loads(Path(cpath).read_text())
    conf["model"]["name"] = name
    conf["path"]["checkpoints"] = str(tmp / f"ckpt_{name}")
    p = tmp / f"{name}.json"
    p.write_text(json.dumps(conf))
    assert tcli.main(["train", "--config", str(p), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == conf["train"]["max_steps"] and np.isfinite(out["final_loss"])
    assert (tmp / f"ckpt_{name}" / f"ckpt_{out['final_step']}.pt").exists()
