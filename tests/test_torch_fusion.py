"""The port's fusion models and their data path against the JAX package on
the CPU, from the same numpy inputs and weights: the five fusion modules
and all seven registry names (f32, rtol 1e-5 / atol 1e-6, with an
all-invalid CLEWS mask among the rows), the converter on flax
``MultiHeadDotProductAttention``, the multimodal datasets (npz and packed
stores, dummies logged), every collate (random mode from the same numpy
Generator), ``flatten_multimodal_batch`` bit-equal, ``make_model_call`` and
two train steps per signature (losses rtol 1e-5, parameters rtol 1e-4 /
atol 1e-5, as tests/test_torch_train.py), and ``eval/wealy.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli import project  # noqa: F401  (the shared fixture)
from wealy_tpu.data import chunking as jchunking
from wealy_tpu.data import collate_factory as jcf
from wealy_tpu.data import multimodal as jmm
from wealy_tpu.eval import wealy as jwealy
from wealy_tpu.losses import clews_loss as jclews_loss
from wealy_tpu.models import fusion as jfusion
from wealy_tpu.models import registry as jregistry
from wealy_tpu.train import multimodal as jtm
from wealy_tpu.train.config import Config as JConfig
from wealy_tpu.train.state import TrainState as JTrainState
from wealy_tpu.train.state import make_optimizer as jmake_optimizer
from wealy_tpu.train.step import make_train_step as jmake_train_step
from wealy_tpu_torch.data import chunking as tchunking
from wealy_tpu_torch.data import collate_factory as tcf
from wealy_tpu_torch.data import multimodal as tmm
from wealy_tpu_torch.data.packed_store import PackedStore
from wealy_tpu_torch.eval import wealy as twealy
from wealy_tpu_torch.losses import clews_loss
from wealy_tpu_torch.models import fusion as tfusion
from wealy_tpu_torch.models import registry as tregistry
from wealy_tpu_torch.models.convert import _leaf, head_state_dict_from_jax_params
from wealy_tpu_torch.train import multimodal as ttm
from wealy_tpu_torch.train.config import Config
from wealy_tpu_torch.train.state import TrainState, make_optimizer
from wealy_tpu_torch.train.step import make_train_step

TOL = dict(rtol=1e-5, atol=1e-6)
B, TW, CW, L, CC, WD, ZD = 4, 5, 24, 6, 12, 16, 8


def _inputs(seed=0):
    """Whisper sequences (B, TW, CW), WEALY vectors (B, WD), CLEWS sequences
    (B, L, CC) and layer-convention masks: row 1 partly invalid, row 3 the
    all-invalid dummy of a version without CLEWS files."""
    rng = np.random.default_rng(seed)
    wm = np.ones((B, TW), bool)
    wm[0, 3:] = False
    cm = np.ones((B, L), bool)
    cm[1, 4:] = False
    cm[3] = False
    return {
        "whisper_seq": rng.normal(size=(B, TW, CW)).astype(np.float32), "whisper_mask": wm,
        "wealy": rng.normal(size=(B, WD)).astype(np.float32),
        "clews": rng.normal(size=(B, L, CC)).astype(np.float32), "clews_mask": cm,
    }


def _perturbed(jmod, args, seed=1):
    """A flax init of ``jmod`` with every leaf moved by 0.2 of its own spread
    (absolute 0.2 for constant leaves: biases, LayerNorm scales)."""
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        spread = float(a.std()) if a.size > 1 and a.std() > 0 else 1.0
        return (a + 0.2 * spread * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(f, params)


def _compare(jmod, tmod, args):
    params = _perturbed(jmod, args)
    tmod.load_state_dict(head_state_dict_from_jax_params(params))
    want = jmod.apply({"params": params}, *args)
    got = tmod(*[torch.from_numpy(a) for a in args])
    if isinstance(want, tuple):
        assert len(got) == len(want) == 3
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
        got = got[0]
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()
    return got


DUAL = lambda x: (x["whisper_seq"], x["whisper_mask"], x["clews"], x["clews_mask"])  # noqa: E731
WEALY = lambda x: (x["wealy"], x["clews"], x["clews_mask"])  # noqa: E731


@pytest.mark.parametrize("residual", [False, True])
def test_cross_attention_fusion(residual):
    x = _inputs()
    _compare(jfusion.CrossAttentionFusion(zdim=ZD, width=16, n_heads=4, residual=residual),
             tfusion.CrossAttentionFusion(CW, CC, zdim=ZD, width=16, n_heads=4,
                                          residual=residual), DUAL(x))


def test_all_invalid_clews_mask_attends_uniformly():
    """A query whose keys are all masked attends to every key with equal
    weight (flax fills masked logits with the f32 minimum), as JAX: finite,
    and equal to unmasked attention over constant logits."""
    x = _inputs()
    mha = tfusion.MultiHeadDotProductAttention(4, 16, 16)
    q, kv = torch.randn(1, 2, 16), torch.randn(1, 5, 16)
    dead = mha(q, kv, kv, mask=torch.zeros(1, 1, 1, 5, dtype=torch.bool))
    v = mha.value(kv).reshape(1, 5, 4, 4).mean(dim=1).reshape(1, 1, 16)
    np.testing.assert_allclose(dead.detach().numpy(), mha.out(v).expand(1, 2, 16).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    got = _compare(jfusion.CrossAttentionFusion(zdim=ZD, width=16, n_heads=4),
                   tfusion.CrossAttentionFusion(CW, CC, zdim=ZD, width=16, n_heads=4), DUAL(x))
    assert torch.isfinite(got[3]).all()


def test_concat_and_two_stream_and_wealy_clews():
    x = _inputs(2)
    _compare(jfusion.ConcatFusion(zdim=ZD, hidden=20), tfusion.ConcatFusion(CW, CC, zdim=ZD,
                                                                             hidden=20), DUAL(x))
    _compare(jfusion.TwoStreamModel(zdim=ZD), tfusion.TwoStreamModel(CW, CC, zdim=ZD), DUAL(x))
    _compare(jfusion.WealyClewsModel(zdim=ZD), tfusion.WealyClewsModel(WD, CC, zdim=ZD), WEALY(x))
    _compare(jfusion.WealyQueryFusion(jfusion.ConcatFusion(zdim=ZD)),
             tfusion.WealyQueryFusion(tfusion.ConcatFusion(WD, CC, zdim=ZD)), WEALY(x))


@pytest.mark.parametrize("name", tregistry.MODEL_NAMES)
def test_registry_names_match_jax(name):
    """Every ``conf.model.name`` at the JAX defaults (fusion width 512 with 8
    heads, concat hidden 1024), the same signature and outputs."""
    assert tregistry.MODEL_NAMES == jregistry.MODEL_NAMES
    x = _inputs(3)
    jmod, jsig = jregistry.build_model(name, zdim=ZD)
    tmod, tsig = tregistry.build_model(name, zdim=ZD, in_features=CW, wealy_features=WD,
                                       clews_features=CC)
    assert tsig == jsig == tregistry.model_signature(name)
    args = WEALY(x) if tsig == "wealy" else (
        (x["whisper_seq"], x["whisper_mask"]) if tsig == "single" else DUAL(x))
    _compare(jmod, tmod, args)
    with pytest.raises(KeyError):
        tregistry.build_model("nope")


def test_converter_reads_attention_kernels_by_path():
    """flax MultiHeadDotProductAttention's rank-3 query/key/value (in, heads,
    head_dim) and out (heads, head_dim, out) kernels become Linear weights;
    read by rank alone a query kernel would be permuted as a Conv1d's."""
    rng = np.random.default_rng(4)
    qk = rng.normal(size=(16, 4, 3)).astype(np.float32)
    name, w = _leaf(("cross_attn", "query", "kernel"), qk)
    assert name == "weight" and w.shape == (12, 16)
    np.testing.assert_array_equal(w.numpy(), qk.reshape(16, 12).T)
    conv_name, conv = _leaf(("conv_0", "conv", "kernel"), qk)
    assert conv.shape == (3, 4, 16) and not np.array_equal(conv.numpy().ravel(), w.numpy().ravel())
    ok = rng.normal(size=(4, 3, 10)).astype(np.float32)
    _, wo = _leaf(("cross_attn", "out", "kernel"), ok)
    np.testing.assert_array_equal(wo.numpy(), ok.reshape(12, 10).T)
    _, b = _leaf(("cross_attn", "key", "bias"), rng.normal(size=(4, 3)))
    assert b.shape == (12,)
    hwio = rng.normal(size=(3, 5, 2, 7)).astype(np.float32)
    _, c2 = _leaf(("stem", "conv", "kernel"), hwio)
    np.testing.assert_array_equal(c2.numpy(), hwio.transpose(3, 2, 0, 1))
    sd = head_state_dict_from_jax_params({"bn": {"scale": np.ones(2), "bias": np.zeros(2)}},
                                         {"bn": {"mean": np.ones(2), "var": np.full(2, 2.0)}})
    assert sorted(sd) == ["bn.bias", "bn.running_mean", "bn.running_var", "bn.weight"]
    with pytest.raises(ValueError):
        head_state_dict_from_jax_params({}, {"bn": {"count": np.ones(1)}})
    with pytest.raises(ValueError):
        _leaf(("x", "kernel"), np.zeros((1, 1, 1, 1, 1)))


# -- data ---------------------------------------------------------------------


def _configs(cpath, tmp, name, **data):
    conf = json.loads(cpath.read_text())
    conf["model"]["name"] = name
    conf["data"].update(data)
    p = tmp / f"{name}.json"
    p.write_text(json.dumps(conf))
    return JConfig.from_file(str(p)), Config.from_file(str(p))


def _assert_same(a, b):
    """Equal nested items / batches: dicts, lists, tuples and arrays."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize("name,jcls,tcls", [
    ("wealy-clews", jmm.WealyClewsDataset, tmm.WealyClewsDataset),
    ("whisper-clews", jmm.WhisperClewsDataset, tmm.WhisperClewsDataset),
])
def test_multimodal_datasets_match_jax(project, name, jcls, tcls):  # noqa: F811
    """Items equal (aligned order, sampled positives), dummies logged the
    same for a version without CLEWS files and a version without its
    modality file, then the same through packed stores."""
    root, cpath, rows = project
    for f in ("hs_clews.npz", "hs_clews_avg.npz", "hs_clews_mask.npz"):
        (root / "hs" / "101" / f).unlink()
    modality = "hs_wealy_concat.npz" if name == "wealy-clews" else "hs_last_seq.npz"
    (root / "hs" / "200" / modality).unlink()
    jconf, tconf = _configs(cpath, root, name)
    for packed in (False, True):
        if packed:
            from wealy_tpu_torch.data.embedding_store import EmbeddingStore

            store = EmbeddingStore(root / "hs", "lyric-covers")
            for kind in ("hs_clews", modality.removesuffix(".npz")):
                keys = [str(r[1]) for rs in rows.values() for r in rs]
                arrays = [(k, store.load(k, f"{kind}.npz")["embeddings"]) for k in keys
                          if store.exists(k, f"{kind}.npz")]
                PackedStore.pack(root / "hs", kind, arrays, dataset_name="lyric-covers")
        jds, tds = jcls(jconf, "train", seed=3), tcls(tconf, "train", seed=3)
        assert tds.sampler.versions == jds.sampler.versions
        for i in range(len(jds)):
            _assert_same(tds[i], jds[i])
        assert tds.dummy_log == jds.dummy_log and "101:full_clews" in tds.dummy_log
        assert tds.verify_embeddings_exist() == jds.verify_embeddings_exist()
    assert tmm.aligned_versions(tds.metadata, "train") == jmm.aligned_versions(jds.metadata,
                                                                               "train")


def _mm_items(seed, whisper: bool, n_per=2, n_items=3):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_items):
        versions = []
        for j in range(n_per):
            mask = np.zeros(L, bool)
            mask[rng.integers(1, L + 1):] = True
            mm = {"full_clews": rng.normal(size=(L, CC)).astype(np.float32),
                  "avg_clews": rng.normal(size=(CC,)).astype(np.float32), "clews_mask": mask}
            if whisper:
                T = int(rng.integers(4, 15))
                mm["whisper_seq"] = rng.normal(size=(T, CW)).astype(np.float32)
                mm["whisper_mask"] = np.zeros(T, bool)
            else:
                mm["wealy"] = {"embeddings": rng.normal(size=(int(rng.integers(1, 4)), WD)).astype(
                    np.float32)}
            versions.append((100 * i + j, mm))
        items.append((i, versions))
    return items


@pytest.mark.parametrize("masks_padding", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("name", tregistry.MODEL_NAMES)
def test_collates_match_jax(project, name, deterministic, masks_padding):  # noqa: F811
    """``create_collate_fn`` for every name: the same batch from the same
    items and the same numpy Generator (random chunks and WEALY chunks
    drawn alike); then the test-mode items."""
    root, cpath, _ = project
    jconf, tconf = _configs(cpath, root, name, chunk_size=8,
                            apply_masks_with_padding=masks_padding)
    sig = tregistry.model_signature(name)
    if sig == "single":
        rng = np.random.default_rng(9)
        items = [(i, [(10 * i + j, rng.normal(size=(int(rng.integers(3, 20)), 5)).astype(
            np.float32)) for j in range(2)]) for i in range(3)]
    else:
        items = _mm_items(9, whisper=sig == "two_stream")
    for overlap in (False, True):
        want = jcf.create_collate_fn(jconf, deterministic=deterministic,
                                     use_overlapping_chunks=overlap,
                                     rng=np.random.default_rng(1))(items)
        got = tcf.create_collate_fn(tconf, deterministic=deterministic,
                                    use_overlapping_chunks=overlap,
                                    rng=np.random.default_rng(1))(items)
        _assert_same(got if isinstance(got, (dict, list)) else vars(got),
                     want if isinstance(want, (dict, list)) else vars(want))


def test_full_songs_and_avg_pool_collates(project):  # noqa: F811
    root, cpath, _ = project
    rng = np.random.default_rng(2)
    items = [(i, [(i, rng.normal(size=(int(rng.integers(3, 300)), 4)).astype(np.float32)),
                  (i + 9, None)]) for i in range(3)]
    for kw in ({}, {"length_bucket": 64, "max_length": 100}):
        _assert_same(vars(tchunking.collate_full_songs(items, **kw)),
                     vars(jchunking.collate_full_songs(items, **kw)))
    for data in ({"fullsongs": True}, {"use_avg_pooling": True}):
        jconf, tconf = _configs(cpath, root, "whisper", **data)
        _assert_same(vars(tcf.create_collate_fn(tconf)(items[:2])),
                     vars(jcf.create_collate_fn(jconf)(items[:2])))


@pytest.mark.parametrize("whisper", [False, True])
def test_flatten_multimodal_batch_bit_equal(whisper):
    batch = (jcf.collate_whisper_clews(_mm_items(5, True), chunk_size=8) if whisper
             else jcf.collate_wealy_clews(_mm_items(5, False), wealy_mode="deterministic"))
    want, got = jtm.flatten_multimodal_batch(batch), ttm.flatten_multimodal_batch(batch)
    _assert_same(got, want)
    assert got["full_clews"].dtype == np.float16 and got["labels"].dtype == np.int32


@pytest.mark.parametrize("name", ["wealy-clews", "multimodal-cross-attention",
                                  "multimodal-concatenation",
                                  "multimodal-cross-attention-residual",
                                  "whisper-clews", "multimodal-two-stream"])
def test_model_call_and_train_steps_match_jax(name):
    """``make_model_call`` of each signature on a flat fp16 batch, then two
    train steps (clews loss, AdamW) from the same weights."""
    sig = tregistry.model_signature(name)
    mk = (lambda s: jcf.collate_whisper_clews(_mm_items(s, True, n_items=4), chunk_size=8,
                                              use_random_chunks=True,
                                              rng=np.random.default_rng(s))) \
        if sig == "two_stream" else \
        (lambda s: jcf.collate_wealy_clews(_mm_items(s, False, n_items=4),
                                           rng=np.random.default_rng(s)))
    batches = [ttm.flatten_multimodal_batch(mk(s)) for s in (11, 12)]
    jmodel, jsig, jcall = jtm.build_trainable(name, zdim=ZD)
    tmodel, tsig, tcall = ttm.build_trainable(name, zdim=ZD,
                                              **ttm.input_widths(batches[0], sig))
    assert jsig == tsig == sig
    feed = {k: v for k, v in batches[0].items() if k not in ("labels", "ids")}
    ex = (feed["wealy"], feed["full_clews"], ~feed["clews_mask"]) if sig == "wealy" else (
        feed["whisper_seq"], ~feed["whisper_mask"], feed["full_clews"], ~feed["clews_mask"])
    params = _perturbed(jmodel, [jnp.asarray(a, jnp.float32) if a.dtype == np.float16 else a
                                 for a in ex])
    tmodel.load_state_dict(head_state_dict_from_jax_params(params))
    np.testing.assert_allclose(tcall(tmodel, feed).detach().numpy(),
                               np.asarray(jcall(params, feed)), **TOL)
    tx = jmake_optimizer(lr=3e-3, warmup_steps=1, max_steps=10)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params), tx=tx)
    jstep = jmake_train_step(jmodel, jclews_loss, model_call=jcall)
    state = TrainState(tmodel, make_optimizer(lr=3e-3, warmup_steps=1, max_steps=10))
    step = make_train_step(tmodel, clews_loss, model_call=tcall)
    for b in batches:
        jstate, jlog = jstep(jstate, b)
        state, log = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(log["loss"]), float(jlog["loss"]), rtol=1e-5)
    want = head_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, v in want.items():
        if k.endswith("cross_attn.key.bias"):
            # the key bias shifts every logit of a query alike, so softmax
            # cancels it: its gradient is zero up to rounding, and AdamW
            # normalises that rounding into a full-size step on each side
            continue
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    with pytest.raises(ValueError):
        ttm.make_model_call(name, tmodel, "nope")


def test_eval_wealy_metrics_match_jax():
    rng = np.random.default_rng(6)
    songs = []
    for i in range(12):
        base = rng.normal(size=(1, 6))
        songs.append({"clique_id": i // 3, "version_id": 50 + i,
                      "wealy_all_chunks": (base + 0.5 * rng.normal(size=(int(rng.integers(1, 5)),
                                                                           6))).astype(np.float32)})
    for a, b in zip(twealy.wealy_song_sets(songs), jwealy.wealy_song_sets(songs)):
        np.testing.assert_array_equal(a, b)
    for redux in ("bpwr", "smean"):
        want = jwealy.evaluate_wealy_songs(songs, redux=redux)
        got = twealy.evaluate_wealy_songs(songs, redux=redux, device="cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)
    z = rng.normal(size=(12, 5)).astype(np.float32)
    labels, ids = np.arange(12) // 3, np.arange(12) + 7
    want = jwealy.evaluate_song_embeddings(z, labels, ids)
    got = twealy.evaluate_song_embeddings(z, labels, ids, device="cpu")
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)
