"""The port's CLEWS acoustic branch against the JAX package on the CPU: every
CLEWS block of models/layers.py, ClewsEncoder and ClewsWindowEncoder, the
extractor's trio and ``extract_clews_split``, and the BatchNorm
(``with_batch_stats``) train step.

Every flax parameter is perturbed before it is carried across
(``models/convert.py``), MyIBNResBlock's zero-init ``gain`` included, so
that no branch hides behind a constant init; the batch statistics too.
The JAX blocks are channel-last and the port's 2-D blocks channel-first:
inputs go in transposed and outputs come back transposed. Tolerances: f32
rtol/atol 1e-4 (the blocks, the encoders, the trio, the BatchNorm step's
losses, parameters and running statistics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.losses import clews_loss as jclews_loss
from wealy_tpu.models import clews_encoder as jce
from wealy_tpu.models import clews_extract as jextract
from wealy_tpu.models import layers as jl
from wealy_tpu.train.state import TrainState as JTrainState
from wealy_tpu.train.state import make_optimizer as jmake_optimizer
from wealy_tpu.train.step import make_train_step as jmake_train_step
from wealy_tpu_torch.losses import clews_loss
from wealy_tpu_torch.models import clews_encoder as tce
from wealy_tpu_torch.models import clews_extract as textract
from wealy_tpu_torch.models import layers as tl
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.train.checkpoint import CheckpointManager
from wealy_tpu_torch.train.state import TrainState, make_optimizer
from wealy_tpu_torch.train.step import make_train_step

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, seed, scale=0.2, positive=False):
    rng = np.random.default_rng(seed)

    def f(a):
        # by the leaf's own spread (a deep stack keeps its scale), absolute
        # for constant leaves (zero gains, unit norm scales, zero biases)
        a = np.asarray(a)
        spread = float(a.std()) if a.size > 1 and a.std() > 0 else 1.0
        a = a + scale * spread * rng.normal(size=np.shape(a))
        return (np.abs(a) + 0.05 if positive else a).astype(np.float32)

    return jax.tree_util.tree_map(f, tree)


def _variables(jmod, args, seed=0, init_kw=None):
    """A perturbed flax init of ``jmod``: (params, batch_stats or None)."""
    v = jmod.init(jax.random.PRNGKey(seed), *args, **(init_kw or {}))
    stats = v.get("batch_stats")
    return _perturb(v["params"], seed + 1), (
        _perturb(stats, seed + 2, positive=True) if stats else None)


def _carry(tmod, params, stats):
    tmod.load_state_dict(head_state_dict_from_jax_params(params, stats))
    return tmod


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _x(shape, seed=0, positive=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.abs(x) if positive else x


def _run_block(jmod, tmod, x, train, call_kw=None, spatial_out=True, rngs=None):
    """Apply the perturbed JAX block and its carried port block to ``x``
    (channel-last), in eval or train mode: (want, got, JAX stats after,
    the port's state dict after)."""
    call_kw = dict(call_kw or {})
    takes_train = "train" in call_kw
    if takes_train:
        call_kw["train"] = train
    params, stats = _variables(jmod, (x,), init_kw=call_kw)
    _carry(tmod, params, stats)
    tmod.train(train)
    variables = {"params": params} | ({"batch_stats": stats} if stats else {})
    if train and stats:
        want, upd = jmod.apply(variables, x, mutable=["batch_stats"], rngs=rngs, **call_kw)
        new_stats = upd["batch_stats"]
    else:
        want, new_stats = jmod.apply(variables, x, rngs=rngs, **call_kw), stats
    t_kw = {k: v for k, v in call_kw.items() if k != "train"}
    got = tmod(nchw(x), **t_kw)
    got = nhwc(got) if spatial_out else got.detach().numpy()
    return np.asarray(want), got, new_stats, tmod.state_dict()


def _assert_stats(new_stats, sd):
    if new_stats is None:
        return
    want = head_state_dict_from_jax_params({}, _np(new_stats))
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), **TOL, err_msg=k)


BLOCKS = {
    "InstanceNorm": lambda: (jl.InstanceNorm(6), tl.InstanceNorm(6), {}, True),
    "InstanceBatchNorm": lambda: (jl.InstanceBatchNorm(6), tl.InstanceBatchNorm(6),
                                  {"train": False}, True),
    "PadConv2d": lambda: (jl.PadConv2d(5, 3, stride=2), tl.PadConv2d(6, 5, 3, stride=2), {},
                          True),
    "GeMPool": lambda: (jl.GeMPool(features=6), tl.GeMPool(features=6), {}, False),
    "GeMPool-1": lambda: (jl.GeMPool(), tl.GeMPool(), {}, False),
    "AutoPool": lambda: (jl.AutoPool(features=6), tl.AutoPool(features=6), {}, False),
    "SoftPool": lambda: (jl.SoftPool(4), tl.SoftPool(6, 4), {}, False),
    "SqueezeExcitation2d": lambda: (jl.SqueezeExcitation2d(6), tl.SqueezeExcitation2d(6), {},
                                    True),
    "ResNet50BottBlock": lambda: (jl.ResNet50BottBlock(6, 8, stride=2),
                                  tl.ResNet50BottBlock(6, 8, stride=2), {"train": False}, True),
    "ResNet50BottBlock-ibn-se": lambda: (jl.ResNet50BottBlock(6, 6, ibn=True, se=True),
                                         tl.ResNet50BottBlock(6, 6, ibn=True, se=True),
                                         {"train": False}, True),
    "MyIBNResBlock": lambda: (jl.MyIBNResBlock(6, 8, stride=2), tl.MyIBNResBlock(6, 8, stride=2),
                              {"train": False}, True),
    "MyIBNResBlock-post-se": lambda: (jl.MyIBNResBlock(6, 6, ibn="post", se="pre"),
                                      tl.MyIBNResBlock(6, 6, ibn="post", se="pre"),
                                      {"train": False}, True),
    "MyIBNResBlock-bn-se": lambda: (jl.MyIBNResBlock(6, 4, ibn="none", se="post"),
                                    tl.MyIBNResBlock(6, 4, ibn="none", se="post"),
                                    {"train": False}, True),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, train):
    jmod, tmod, call_kw, spatial_out = BLOCKS[name]()
    x = _x((3, 7, 5, 6), seed=1)
    want, got, new_stats, sd = _run_block(jmod, tmod, x, train, call_kw, spatial_out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if train:
        _assert_stats(new_stats, sd)


@pytest.mark.parametrize("norm", ["max2d", "max1d", "mean2d"])
@pytest.mark.parametrize("noise", [False, True])
def test_cqt_prepare_matches_jax(norm, noise):
    """The eps-noise (uniform * 1e-6) is drawn by each package's own
    generator; it moves the output by about 1e-6, under the tolerance."""
    x = _x((2, 9, 7, 1), seed=2)
    want, got, _, _ = _run_block(jl.CQTPrepare(norm=norm), tl.CQTPrepare(norm=norm), x,
                                 train=noise, call_kw={"add_noise": noise},
                                 rngs={"noise": jax.random.PRNGKey(4)} if noise else None)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        tl.CQTPrepare(norm="max3d")


@pytest.mark.parametrize("axis", [-1, 1])
def test_axis_linear_matches_jax(axis):
    x = _x((2, 5, 6), seed=3)
    jmod = jl.AxisLinear(4, axis=axis)
    params, _ = _variables(jmod, (x,))
    tmod = _carry(tl.AxisLinear(6 if axis == -1 else 5, 4, axis=axis), params, None)
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmod.apply({"params": params}, x)), **TOL)


def test_batch_norm_running_statistics_are_flax_not_torch():
    """After two training forwards the running variance is flax's (biased
    batch variance, momentum 0.9), which nn.BatchNorm2d's unbiased update
    would miss by n / (n - 1)."""
    x1, x2 = _x((2, 3, 2, 4), seed=5), _x((2, 3, 2, 4), seed=6) * 2 + 1
    from flax import linen as nn

    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = flax_bn.init(jax.random.PRNGKey(0), x1)
    stats = v["batch_stats"]
    for x in (x1, x2):
        _, upd = flax_bn.apply({"params": v["params"], "batch_stats": stats}, x,
                               mutable=["batch_stats"])
        stats = upd["batch_stats"]
    bn = tl.BatchNorm(4).train()
    for x in (x1, x2):
        bn(nchw(x))
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
    stock = torch.nn.BatchNorm2d(4, momentum=0.1)
    for x in (x1, x2):
        stock(nchw(x))
    assert not np.allclose(stock.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-3)


ENC = dict(embed_dim=16, stem=8, stages=((8, 1), (12, 2)), blocks_per_stage=2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_clews_encoder_matches_jax(train):
    x = _x((4, 24, 16, 1), seed=7, positive=True)
    want, got, new_stats, sd = _run_block(
        jce.ClewsEncoder(**ENC), tce.ClewsEncoder(**ENC), x, train, {"train": False},
        spatial_out=False, rngs={"noise": jax.random.PRNGKey(1)})
    assert got.shape == (4, 16)
    np.testing.assert_allclose(got, want, **TOL)
    if train:
        _assert_stats(new_stats, sd)


def test_clews_encoder_class_defaults():
    """The class-default widths (64 -> 512, 2048-d), which no CLI path
    runs, at a small CQT."""
    x = _x((2, 16, 16, 1), seed=8, positive=True)
    want, got, _, _ = _run_block(jce.ClewsEncoder(), tce.ClewsEncoder(), x, False,
                                 {"train": False}, spatial_out=False)
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, **TOL)


def test_clews_window_encoder_matches_jax():
    """Each window holds the same frames in both layouts."""
    kw = dict(n_windows=4, embed_dim=16, encoder_kwargs=dict(stem=8, stages=((8, 2),)))
    x = _x((2, 24, 32, 1), seed=9, positive=True)
    jmod = jce.ClewsWindowEncoder(**kw)
    params, stats = _variables(jmod, (x,))
    tmod = _carry(tce.ClewsWindowEncoder(**kw), params, stats).eval()
    want = np.asarray(jmod.apply({"params": params, "batch_stats": stats}, x))
    got = tmod(nchw(x)).detach().numpy()
    assert got.shape == (2, 4, 16)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="windows"):
        tmod(nchw(x[:, :, :30]))


def test_seeded_init_is_reproducible_and_flax_shaped():
    a = tce.seeded_init_(tce.ClewsWindowEncoder(4, 16, dict(stem=8, stages=((8, 2),))), 0)
    b = tce.seeded_init_(tce.ClewsWindowEncoder(4, 16, dict(stem=8, stages=((8, 2),))), 0)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert float(sd["encoder.stage0_block0.gain"]) == 0.0
    assert float(sd["encoder.prepare.gain"]) == 1.0
    assert torch.all(sd["encoder.stage0_block0.norm2.running_var"] == 1)
    p = 1 + torch.nn.functional.softplus(sd["encoder.gem.p"])
    assert torch.allclose(p, torch.tensor(3.0))


SMALL = dict(n_windows=4, frames_per_window=8, embed_dim=16,
             encoder_kwargs=dict(stem=8, stages=((8, 2),), blocks_per_stage=1))


def _extractor_pair(cqt_method="pseudo"):
    enc = jce.ClewsWindowEncoder(n_windows=4, embed_dim=16, encoder_kwargs=SMALL["encoder_kwargs"])
    params, stats = _variables(enc, (jnp.zeros((1, 84, 32, 1)),), seed=11)
    jext = jextract.make_clews_extractor(**SMALL, params={"params": params, "batch_stats": stats},
                                         cqt_method=cqt_method)
    text = textract.make_clews_extractor(**SMALL, params=head_state_dict_from_jax_params(
        params, stats), cqt_method=cqt_method, device="cpu")
    return jext, text


@pytest.mark.parametrize("cqt_method", ["pseudo", "multirate"])
@pytest.mark.parametrize("seconds", [0.3, 0.7, 2.0])
def test_extractor_trio_matches_jax(cqt_method, seconds):
    """Given the JAX params: a song shorter than one window (one valid
    window), one of some windows, and one longer than the span (cropped)."""
    jext, text = _extractor_pair(cqt_method)
    audio = _x((int(seconds * 16000),), seed=12) * 0.3
    want, got = jext(audio), text(audio)
    assert got["hs_clews"].shape == (4, 16) and got["hs_clews_avg"].shape == (16,)
    np.testing.assert_array_equal(got["hs_clews_mask"], want["hs_clews_mask"])
    np.testing.assert_allclose(got["hs_clews"], want["hs_clews"], **TOL)
    np.testing.assert_allclose(got["hs_clews_avg"], want["hs_clews_avg"], **TOL)


def test_extractor_defaults_and_arguments():
    """The defaults of the JAX CLI's extractor (116 windows of 32 frames,
    84 bins, 2048-d, stem 16, stages ((16, 2), (32, 2))); an unknown CQT
    method raises."""
    ext = textract.make_clews_extractor(device="cpu")
    out = ext(_x((16000 * 3,), seed=13) * 0.3)
    assert out["hs_clews"].shape == (116, 2048) and out["hs_clews_avg"].shape == (2048,)
    # a window is 32 frames of 512 samples (1.024 s): 3 s fill three of them
    assert out["hs_clews_mask"].tolist() == [False] * 3 + [True] * 113
    assert np.isfinite(out["hs_clews"]).all()
    np.testing.assert_allclose(out["hs_clews_avg"], out["hs_clews"][:3].mean(0), rtol=1e-6)
    with pytest.raises(ValueError, match="cqt_method"):
        textract.make_clews_extractor(cqt_method="fft", device="cpu")


def test_extract_clews_split_resumes_and_records_failures(tmp_path):
    """Every version written, a rerun skips them, ``overwrite`` redoes them;
    a song whose store write fails is recorded and the split goes on."""
    from types import SimpleNamespace

    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.data.metadata import Metadata

    data = tmp_path / "data" / "LyricCovers" / "audio"
    info, versions = {}, []
    import wave

    for i, vid in enumerate((11, 12, 13)):
        path = data / str(vid) / f"{vid}_audio.mp3"
        path.parent.mkdir(parents=True)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((_x((8000 + 3000 * i,), seed=i) * 3000).astype("<i2").tobytes())
        info[str(vid)] = {"id": vid, "clique": "c1", "clique_idx": 0, "version_idx": i,
                          "version_key": str(vid)}
        versions.append(str(vid))
    md = Metadata("lyric-covers", info, {"train": {}, "val": {}, "test": {"c1": versions}})
    config = SimpleNamespace(
        path=SimpleNamespace(hidden_states=str(tmp_path / "hs"), data=str(tmp_path / "data")),
        data=SimpleNamespace(dataset_name="lyric-covers"), model=SimpleNamespace())
    ext = textract.make_clews_extractor(**SMALL, device="cpu")
    r = textract.extract_clews_split(config, md, "test", extractor=ext, log=lambda m: None)
    assert r == {"done": versions, "skipped": [], "failed": []}
    store = EmbeddingStore(tmp_path / "hs", "lyric-covers")
    for v in versions:
        assert store.load(v, "hs_clews.npz")["embeddings"].shape == (4, 16)
        assert store.load(v, "hs_clews_mask.npz")["embeddings"].dtype == bool
    r = textract.extract_clews_split(config, md, "test", extractor=ext, limit=2)
    assert r == {"done": [], "skipped": versions[:2], "failed": []}
    real_save = EmbeddingStore.save
    logs = []

    def failing_save(self, version_key, filename, **arrays):
        if version_key == "12":
            raise OSError("disk full")
        return real_save(self, version_key, filename, **arrays)

    EmbeddingStore.save = failing_save
    try:
        r = textract.extract_clews_split(config, md, "test", extractor=ext, overwrite=True,
                                         log=logs.append)
    finally:
        EmbeddingStore.save = real_save
    assert r == {"done": ["11", "13"], "skipped": [], "failed": ["12"]}
    assert "disk full" in logs[0]

    def broken(audio):
        raise RuntimeError("a fault that is not the song's")

    with pytest.raises(RuntimeError, match="not the song"):
        textract.extract_clews_split(config, md, "test", extractor=broken, overwrite=True)


# -- the BatchNorm train step ------------------------------------------------

BN_ENC = dict(embed_dim=16, stem=8, stages=((8, 2),), blocks_per_stage=1)


def _bn_batches():
    rng = np.random.default_rng(21)
    return [{"emb": np.abs(rng.normal(size=(8, 24, 16, 1))).astype(np.float32),
             "labels": np.repeat(np.arange(4, dtype=np.int32), 2),
             "ids": np.arange(8, dtype=np.int32)} for _ in range(3)]


def test_batch_stats_step_matches_jax(tmp_path):
    """Three ``with_batch_stats`` steps of a small ClewsEncoder (the recipe of
    tests/test_train.py::TestBatchStatsTraining) from the same perturbed
    weights and statistics: losses, parameters and running statistics after
    every step; then a checkpoint saves and restores the statistics."""
    batches = _bn_batches()
    enc = jce.ClewsEncoder(**BN_ENC)
    params, stats = _variables(enc, (batches[0]["emb"],), seed=30, init_kw={"train": False})
    tx = jmake_optimizer(lr=1e-3, warmup_steps=1, max_steps=50)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params), batch_stats=stats, tx=tx)

    def jcall(p, bs, batch):
        z, upd = enc.apply({"params": p, "batch_stats": bs}, batch["emb"], train=True,
                           mutable=["batch_stats"], rngs={"noise": jax.random.PRNGKey(0)})
        return z, upd["batch_stats"]

    jstep = jmake_train_step(enc, jclews_loss, model_call=jcall, with_batch_stats=True)
    model = _carry(tce.ClewsEncoder(**BN_ENC), params, stats)
    state = TrainState(model, make_optimizer(lr=1e-3, warmup_steps=1, max_steps=50))
    step = make_train_step(model, clews_loss, with_batch_stats=True)
    for b in batches:
        jstate, jlog = jstep(jstate, b)
        batch = {k: torch.from_numpy(np.moveaxis(v, -1, 1).copy() if k == "emb" else v)
                 for k, v in b.items()}
        state, log = step(state, batch)
        np.testing.assert_allclose(float(log["loss"]), float(jlog["loss"]), rtol=1e-4)
        want = head_state_dict_from_jax_params(_np(jstate.params), _np(jstate.batch_stats))
        got = {**state.params, **state.batch_stats}
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL, err_msg=k)
    assert state.step == 3 and len(state.batch_stats) == 6
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save_state(state)
    fresh = TrainState(tce.seeded_init_(tce.ClewsEncoder(**BN_ENC), 1), state.tx)
    mgr.restore_state(fresh)
    for k, v in state.batch_stats.items():
        assert torch.equal(fresh.batch_stats[k], v), k
    with pytest.raises(ValueError, match="batch_stats"):
        fresh.load(state.params, state.opt_state, 3, batch_stats={})


def test_batch_stats_with_grad_accum_raises():
    model = tce.ClewsEncoder(**BN_ENC)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(model, clews_loss, with_batch_stats=True, grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum"):
        jmake_train_step(jce.ClewsEncoder(**BN_ENC), jclews_loss, with_batch_stats=True,
                         grad_accum=2)
