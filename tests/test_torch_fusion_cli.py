"""The port's fusion commands against the JAX CLI on the CPU, on the project
of tests/test_cli.py::project (WEALY chunks 16-d, CLEWS (6, 12), whisper
(T, 24), zdim 16): ``train`` then ``evaluate --checkpoint`` for one model
name per signature, ``evaluate`` (monolithic, ``--streaming``,
``--test-mode``) from the same weights (a perturbed flax init saved with
orbax for JAX, its conversion for the port): MAP, MR1 and P@10 within
1e-6; ``extract --kinds hs_clews`` (resume and skip); and fusion ``index``
/ ``query --audio`` with the JAX engine's ranks."""

import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli import project  # noqa: F401  (the shared fixture)
from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.data.collate_factory import create_collate_fn as jcreate_collate_fn
from wealy_tpu.data.multimodal import WealyClewsDataset as JWealyClewsDataset
from wealy_tpu.data.multimodal import WhisperClewsDataset as JWhisperClewsDataset
from wealy_tpu.models.registry import build_model as jbuild_model
from wealy_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from wealy_tpu.train.config import Config as JConfig
from wealy_tpu.train.multimodal import flatten_multimodal_batch as jflatten
from wealy_tpu_torch.cli import main as tcli
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params

SIGNATURES = ["wealy-clews", "multimodal-cross-attention-residual", "whisper-clews"]
TOL = 1e-6


def _config(cpath, tmp, name, **data):
    conf = json.loads(cpath.read_text())
    conf["model"]["name"] = name
    conf["data"].update(data)
    conf["path"]["checkpoints"] = str(tmp / f"ckpt_{name}")
    conf["train"]["batch_size"] = 2
    p = tmp / f"{name}.json"
    p.write_text(json.dumps(conf))
    return p


def _weights(cpath, root, name):
    """A flax init of ``name`` on the project's widths, perturbed (so that
    no parameter sits at a constant init), saved as an orbax checkpoint
    for JAX and as its torch state dict for the port."""
    config = JConfig.from_file(str(cpath))
    model, sig = jbuild_model(name, zdim=config.model.zdim)
    ds = (JWealyClewsDataset if sig == "wealy" else JWhisperClewsDataset)(config, "test",
                                                                          n_per_class=1)
    flat = jflatten(jcreate_collate_fn(config, deterministic=True)([ds[0], ds[1]]))
    if sig == "wealy":
        args = (flat["wealy"], flat["full_clews"], ~flat["clews_mask"])
    else:
        args = (flat["whisper_seq"], ~flat["whisper_mask"], flat["full_clews"],
                ~flat["clews_mask"])
    params = model.init(jax.random.PRNGKey(5), *map(jnp.asarray, args))["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), params)
    JCheckpointManager(root / f"orbax_{name}").save(0, {"params": params})
    torch.save(head_state_dict_from_jax_params(params), root / f"{name}.pt")
    return str(root / f"orbax_{name}"), str(root / f"{name}.pt")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _close(got, want):
    for k in ("MAP", "MR1", "P@10"):
        assert abs(got[k] - want[k]) <= TOL, (k, got, want)


@pytest.mark.parametrize("name", SIGNATURES)
def test_evaluate_matches_jax(project, capsys, name):  # noqa: F811
    root, cpath, _ = project
    conf = _config(cpath, root, name)
    orbax_dir, torch_file = _weights(conf, root, name)
    base = ["evaluate", "--config", str(conf), "--split", "test"]
    runs = {}
    for flags in ([], ["--streaming"], ["--test-mode"], ["--test-mode", "--streaming"]):
        assert jax_main(base + ["--checkpoint", orbax_dir] + flags) == 0
        want = _last_json(capsys)
        assert tcli.main(base + ["--checkpoint", torch_file, "--device", "cpu"] + flags) == 0
        got = _last_json(capsys)
        _close(got, want)
        runs[" ".join(flags)] = got
    for a, b in (("", "--streaming"), ("--test-mode", "--test-mode --streaming")):
        assert runs[a]["MAP"] == runs[b]["MAP"] and runs[a]["MR1"] == runs[b]["MR1"]


@pytest.mark.parametrize("name", SIGNATURES)
def test_train_then_evaluate_checkpoint(project, capsys, name):  # noqa: F811
    root, cpath, _ = project
    conf = _config(cpath, root, name)
    assert tcli.main(["train", "--config", str(conf), "--max-steps", "3", "--device",
                      "cpu"]) == 0
    out = _last_json(capsys)
    assert out["final_step"] == 3 and np.isfinite(out["final_loss"])
    ckpt = root / f"ckpt_{name}"
    payload = torch.load(ckpt / "ckpt_3.pt", weights_only=True)
    assert payload["step"] == 3 and "batch_stats" not in payload  # no BatchNorm here
    metrics = {}
    for flags in ([], ["--checkpoint", str(ckpt)], ["--checkpoint", str(ckpt / "ckpt_3.pt")]):
        assert tcli.main(["evaluate", "--config", str(conf), "--device", "cpu"] + flags) == 0
        metrics[len(flags) and flags[1]] = _last_json(capsys)
    # path.checkpoints is the fallback, as in JAX: all three read step 3
    assert len({json.dumps(m, sort_keys=True) for m in metrics.values()}) == 1
    # resume: three more steps from the saved state
    assert tcli.main(["train", "--config", str(conf), "--max-steps", "6", "--device",
                      "cpu"]) == 0
    assert _last_json(capsys)["final_step"] == 6


def _write_wav(path, seconds, freq, sr=16000):
    path.parent.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * freq * t) + 0.05 * np.random.default_rng(int(freq)).normal(
        size=t.shape)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _audio_project(project):  # noqa: F811
    """The project with a short WAV per test version under path.data."""
    root, cpath, rows = project
    data = root / "data" / "LyricCovers" / "audio"
    for i, (_, vid, *_rest) in enumerate(rows["test"]):
        _write_wav(data / str(vid) / f"{vid}_audio.mp3", 1.5 + 0.5 * i, 180.0 + 40 * (i // 2))
    return root, cpath, rows


def test_extract_hs_clews(project, capsys, monkeypatch):  # noqa: F811
    """``extract --kinds hs_clews`` writes the trio of every test version
    (the extractor's defaults, at a small window count), a second run skips
    them all, and the trio equals the JAX CLI's from the same encoder
    weights."""
    import wealy_tpu.models.clews_extract as jce
    import wealy_tpu_torch.models.clews_extract as tce
    from wealy_tpu.data.embedding_store import EmbeddingStore
    from wealy_tpu.models.clews_encoder import ClewsWindowEncoder

    root, cpath, rows = _audio_project(project)
    small = dict(n_windows=4, frames_per_window=4, embed_dim=8,
                 encoder_kwargs=dict(stem=4, stages=((4, 2),), blocks_per_stage=1))
    enc = ClewsWindowEncoder(n_windows=4, embed_dim=8, encoder_kwargs=small["encoder_kwargs"])
    variables = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 84, 16, 1)))
    rng = np.random.default_rng(3)
    variables = {
        "params": jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.2 * rng.normal(size=a.shape).astype(np.float32),
            variables["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda a: np.abs(np.asarray(a) + 0.2 * rng.normal(size=a.shape)).astype(np.float32),
            variables["batch_stats"]),
    }
    sd = head_state_dict_from_jax_params(variables["params"], variables["batch_stats"])
    jext = jce.make_clews_extractor(**small, params=variables)
    real = tce.make_clews_extractor
    monkeypatch.setattr(tce, "make_clews_extractor",
                        lambda **kw: real(**{**small, "params": sd, **kw}))
    monkeypatch.setattr(jce, "make_clews_extractor", lambda **kw: jext)
    conf = json.loads(cpath.read_text())
    conf["path"]["hidden_states"] = str(root / "hs_clews_torch")
    tpath = root / "clews_torch.json"
    tpath.write_text(json.dumps(conf))
    conf["path"]["hidden_states"] = str(root / "hs_clews_jax")
    jpath = root / "clews_jax.json"
    jpath.write_text(json.dumps(conf))
    base = ["extract", "--split", "test", "--kinds", "hs_clews"]
    assert tcli.main(base + ["--config", str(tpath), "--device", "cpu"]) == 0
    assert _last_json(capsys) == {"done": 4, "skipped": 0, "failed": 0}
    assert tcli.main(base + ["--config", str(tpath), "--device", "cpu"]) == 0
    assert _last_json(capsys) == {"done": 0, "skipped": 4, "failed": 0}
    assert jax_main(base + ["--config", str(jpath)]) == 0
    assert _last_json(capsys) == {"done": 4, "skipped": 0, "failed": 0}
    got = EmbeddingStore(root / "hs_clews_torch", "lyric-covers")
    want = EmbeddingStore(root / "hs_clews_jax", "lyric-covers")
    for _, vid, *_rest in rows["test"]:
        for kind in ("hs_clews", "hs_clews_avg", "hs_clews_mask"):
            g = got.load(str(vid), f"{kind}.npz")["embeddings"]
            w = want.load(str(vid), f"{kind}.npz")["embeddings"]
            if kind == "hs_clews_mask":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["wealy-clews", "whisper-clews"])
def test_index_and_audio_query_match_jax(project, capsys, monkeypatch, name):  # noqa: F811
    """Fusion ``index`` (and ``--update``) from the same weights as JAX, and
    ``query --audio`` whose query side (the CLEWS extractor, the WEALY head
    or the greedy decode at ``whisper_size: dev``) is given each package's
    own output for the same audio: the fused vectors within 1e-5 and the
    ranks equal to the JAX engine's. Embedding queries and ``--rerank`` are
    refused, as in JAX."""
    from wealy_tpu.cli import serve as jserve
    from wealy_tpu_torch.cli import serve as tserve

    root, cpath, rows = _audio_project(project)
    conf = _config(cpath, root, name)
    orbax_dir, torch_file = _weights(conf, root, name)
    jidx, tidx = root / f"j_{name}.npz", root / f"t_{name}.npz"
    assert jax_main(["index", "--config", str(conf), "--split", "test", "--out", str(jidx),
                     "--checkpoint", orbax_dir]) == 0
    jout = _last_json(capsys)
    assert tcli.main(["index", "--config", str(conf), "--split", "test", "--out", str(tidx),
                      "--checkpoint", torch_file, "--device", "cpu"]) == 0
    tout = _last_json(capsys)
    # a state-dict file carries no training step; the orbax one is step 0
    assert tout == {**jout, "out": str(tidx), "checkpoint_step": None}
    with np.load(jidx) as j, np.load(tidx) as t:
        assert json.loads(str(t["meta"])) == {**json.loads(str(j["meta"])),
                                              "checkpoint_step": None}
        np.testing.assert_array_equal(t["version_keys"], j["version_keys"])
        np.testing.assert_allclose(t["vecs"], j["vecs"], rtol=1e-5, atol=1e-5)
    assert tcli.main(["index", "--config", str(conf), "--split", "test", "--out", str(tidx),
                      "--checkpoint", torch_file, "--update", "--device", "cpu"]) == 0
    assert _last_json(capsys)["new"] == 0

    # the query side: each package's own multimodal dict for the same audio,
    # made the same (the port's) so that what is compared is the fusion scan
    wavs = [str(root / "data" / "LyricCovers" / "audio" / str(vid) / f"{vid}_audio.mp3")
            for _, vid, *_rest in rows["test"][:2]]
    rng = np.random.default_rng(7)
    with np.load(tidx) as t:
        meta = json.loads(str(t["meta"]))
    Lc, Cc = meta["clews_shape"]

    def fake_mm(*args, **kw):
        def run(path):
            i = wavs.index(path)
            r = np.random.default_rng(i)
            mm = {"full_clews": r.normal(size=(Lc, Cc)).astype(np.float32),
                  "avg_clews": r.normal(size=(Cc,)).astype(np.float32),
                  "clews_mask": np.arange(Lc) >= Lc - i}
            if meta["sig"] == "wealy":
                mm["wealy"] = {"embeddings": r.normal(size=(2, meta["wealy_dim"])).astype(
                    np.float32)}
            else:
                mm["whisper_seq"] = r.normal(size=(10 + i, meta["emb_dim"])).astype(np.float32)
            return mm
        return run

    del rng
    monkeypatch.setattr(jserve, "make_mm_query_embed_fn", fake_mm)
    monkeypatch.setattr(tserve, "make_mm_query_embed_fn", fake_mm)
    q = ["query", "--config", str(conf), "--k", "4", "--audio", *wavs]
    assert jax_main(q + ["--index", str(jidx), "--checkpoint", orbax_dir]) == 0
    want = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()][-2:]
    assert tcli.main(q + ["--index", str(tidx), "--checkpoint", torch_file, "--device",
                          "cpu"]) == 0
    got = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()][-2:]
    for g, w in zip(got, want):
        assert g["scoring"] == w["scoring"] == "fusion_cosine"
        assert [r["version_key"] for r in g["results"]] == [r["version_key"] for r in
                                                              w["results"]]
        np.testing.assert_allclose([r["score"] for r in g["results"]],
                                   [r["score"] for r in w["results"]], atol=2e-5)
    # refused as in JAX: an embedding query, --rerank, --quantize
    emb = root / "q.npz"
    np.savez(emb, embeddings=np.zeros((4, 24), np.float32))
    qe = ["query", "--config", str(conf), "--index", str(tidx), "--checkpoint", torch_file,
          "--device", "cpu"]
    assert tcli.main(qe + ["--query-embeddings", str(emb)]) == 2
    assert "raw-audio" in capsys.readouterr().err
    assert tcli.main(qe + ["--quantize", "int8", "--audio", wavs[0]]) == 2
    assert "quantize" in capsys.readouterr().err
    with pytest.raises(ValueError, match="rerank"):
        tcli.main(qe + ["--rerank", "2", "--audio", wavs[0]])
