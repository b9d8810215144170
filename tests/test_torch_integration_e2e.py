"""The port's full pipeline on the CPU, the counterpart of
tests/test_integration_e2e.py, through the port's own entry points:

- synthetic audio cliques (WAV bytes under the layout's ``.mp3`` names) ->
  the dev Whisper (seeded weights: a deterministic featuriser, so versions
  that sound alike land close) -> ``extract_split`` -> the store ->
  ``EmbeddingDataset`` -> all-pairs retrieval at near-perfect MAP, and the
  same through the int8 W8A8 encoder (``extract_split_batched``), with the
  JAX test's bounds;
- training the projection head with ``fit`` improves retrieval, with the
  JAX test's bounds;
- the same seeded project through both command lines, ``extract --batched``
  then ``evaluate --checkpoint`` (one dev Whisper checkpoint and one head
  for both, ``--device cpu`` for the port): MAP, MR1 and P@10 equal within
  1e-6, the gate of tests/test_torch_eval.py."""

import csv
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_and_port_whisper
from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.models.heads import ProjectionHead as JProjectionHead
from wealy_tpu.models.whisper import WHISPER_CONFIGS
from wealy_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from wealy_tpu_torch.cli.main import main as port_main
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.train.config import Config

TOL = 1e-6
CLIQUES = {"A": [330.0, 440.0, 550.0], "B": [660.0, 880.0, 770.0], "C": [220.0, 275.0, 247.5]}


def _write_wav(path, x, sr=16000):
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _melody(freqs, seconds=2.0, sr=16000, detune=1.0, noise=0.0, rng=None):
    """A little tone sequence; versions of a clique share freqs (detuned)."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    seg = n // len(freqs)
    x = np.zeros(n, np.float32)
    for i, f in enumerate(freqs):
        sl = slice(i * seg, (i + 1) * seg)
        x[sl] = 0.4 * np.sin(2 * np.pi * f * detune * t[sl])
    if noise and rng is not None:
        x += noise * rng.normal(size=n).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Nine versions in three cliques (three detunings of one melody each),
    in the train split; val and test empty. (config dict, root)."""
    root = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(7)
    rows, vid = [], 100
    audio = root / "data" / "LyricCovers" / "audio"
    for label, freqs in CLIQUES.items():
        for detune in (1.0, 1.01, 0.99):
            _write_wav(audio / str(vid) / f"{vid}_audio.mp3",
                       _melody(freqs, detune=detune, noise=0.01, rng=rng))
            rows.append((1, vid, detune != 1.0, "o", label))
            vid += 1
    lc = root / "lc"
    lc.mkdir()
    for split in ("train", "val", "test"):
        with open(lc / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            w.writerows(rows if split == "train" else [])
    conf = {
        "path": {"lyric_covers_data": str(lc), "hidden_states": str(root / "hs"),
                 "cache": str(root / "cache"), "data": str(root / "data")},
        "data": {"dataset_name": "lyric-covers"},
        "model": {"whisper_size": "dev"},
    }
    return conf, root


def _song_vectors(ds):
    z, labels, ids = [], [], []
    for v in ds.sampler.versions:
        z.append(ds.load_embedding(v).mean(axis=0))  # (n_chunks=1, D) -> (D,)
        labels.append(ds.sampler.labels[ds.sampler.clique_of[v]])
        ids.append(int(ds.metadata.info[v]["id"]))
    return np.stack(z), np.array(labels), np.array(ids)


def test_extract_then_retrieve(project):
    from wealy_tpu_torch.cli.extract import extract_split
    from wealy_tpu_torch.cli.extract_batched import extract_split_batched, make_encoder_embed_fn
    from wealy_tpu_torch.data.dataset import EmbeddingDataset, build_clean_dataset
    from wealy_tpu_torch.eval.wealy import evaluate_song_embeddings

    conf, root = project
    config = Config.from_dict(conf)
    # 1) metadata, then x_concat of every version through the dev Whisper
    md, _ = build_clean_dataset(config, check_audio=True)
    assert sum(len(v) for v in md.splits["train"].values()) == 9
    result = extract_split(config, md, "train", kinds=("x_concat",), device="cpu",
                           log=lambda s: None)
    assert len(result["done"]) == 9 and not result["failed"]
    # 2) the dataset over the extracted store
    config.data.embedding_type = "encoder"
    config.data.embedding_format = "concat"
    ds = EmbeddingDataset(config, "train", seed=0)
    assert len(ds) == 9
    # 3) all-pairs retrieval on the song vectors
    z, labels, ids = _song_vectors(ds)
    m = evaluate_song_embeddings(z, labels, ids, device="cpu")
    assert m["n_queries"] == 9
    assert m["MAP"] > 0.95, m  # versions of one melody retrieve each other
    assert m["MR1"] < 1.5, m
    # 4) the int8 W8A8 encoder keeps the retrieval quality
    conf8 = json.loads(json.dumps(conf))
    conf8["path"].update(hidden_states=str(root / "hs_int8"), cache=str(root / "cache_int8"))
    conf8["data"].update(embedding_type="encoder", embedding_format="concat")
    config8 = Config.from_dict(conf8)
    r8 = extract_split_batched(config8, md, "train",
                               make_encoder_embed_fn(config8, quant_int8=True, device="cpu"),
                               kind="x_concat", batch_size=4)
    assert len(r8["done"]) == 9 and not r8["incomplete"]
    z8, labels8, ids8 = _song_vectors(EmbeddingDataset(config8, "train", seed=0))
    m8 = evaluate_song_embeddings(z8, labels8, ids8, device="cpu")
    assert m8["MAP"] > 0.95, (m8, m)
    assert abs(m8["MAP"] - m["MAP"]) < 0.02, (m8, m)


def test_training_improves_retrieval():
    """Metric learning end to end: the projection head trained with fit on
    clustered embeddings ranks better than the untrained head."""
    from wealy_tpu_torch.data.metadata import Metadata
    from wealy_tpu_torch.data.sampler import CliqueSampler
    from wealy_tpu_torch.eval.wealy import evaluate_song_embeddings
    from wealy_tpu_torch.losses import clews_loss
    from wealy_tpu_torch.models.heads import ProjectionHead
    from wealy_tpu_torch.train import create_train_state, make_train_step
    from wealy_tpu_torch.train.loop import MetricsWriter, fit
    from wealy_tpu_torch.train.state import make_optimizer

    rng = np.random.default_rng(0)
    # 8 cliques x 4 versions, a weak clique structure buried in noise
    info, splits, data = {}, {"train": {}, "val": {}, "test": {}}, {}
    T, C = 10, 24
    for ci in range(8):
        clique = f"c{ci}"
        center = rng.normal(size=(C,)).astype(np.float32)
        splits["train"][clique] = []
        for v in range(4):
            key = f"{clique}-{v}"
            info[key] = {"id": ci * 100 + v, "clique": clique, "clique_idx": ci,
                         "version_idx": len(info), "filename": key, "version_key": key}
            splits["train"][clique].append(key)
            data[key] = 0.6 * center[None] + rng.normal(size=(T, C)).astype(np.float32)
    md = Metadata("lyric-covers", info, splits)
    sampler = CliqueSampler(md, "train", lambda k: data[k], n_per_class=2, seed=0)
    model = ProjectionHead(C, zdim=16, hidden=(32,), l2_normalize=True)
    state = create_train_state(model, make_optimizer(lr=5e-3, warmup_steps=1, max_steps=400))

    def song_map():
        model.eval()
        with torch.no_grad():
            z = np.stack([model(torch.from_numpy(data[k][None]).float(),
                                torch.ones(1, T, dtype=torch.bool))[0].numpy()
                          for k in sampler.versions])
        labels = np.array([sampler.labels[sampler.clique_of[k]] for k in sampler.versions])
        ids = np.array([info[k]["id"] for k in sampler.versions])
        return evaluate_song_embeddings(z, labels, ids, device="cpu")["MAP"]

    map_before = song_map()
    model.train()
    state, _ = fit(state, make_train_step(None, clews_loss), sampler, batch_size=16,
                   chunk_size=T, max_steps=120, writer=MetricsWriter(log_every=0))
    map_after = song_map()
    assert map_after > map_before + 0.05, (map_before, map_after)
    assert map_after > 0.8, (map_before, map_after)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_both_command_lines_agree_on_the_project(project, capsys):
    """``extract --batched`` then ``evaluate --checkpoint`` through the JAX
    command line and the port's, each into its own store, from one dev
    Whisper checkpoint and one head: the same metrics within 1e-6."""
    conf, root = project
    ckpt = root / "dev_whisper.pt"
    _, _, port = jax_and_port_whisper(WHISPER_CONFIGS["dev"], "float32", seed=0)
    torch.save(port.state_dict(), ckpt)
    head = JProjectionHead(zdim=16)
    D = WHISPER_CONFIGS["dev"].n_audio_state
    params = head.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, D)), jnp.ones((1, 8), bool))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    JCheckpointManager(root / "head_orbax").save(0, {"params": params})
    torch.save(head_state_dict_from_jax_params(params), root / "head.pt")
    metrics = {}
    for side, run, head_ckpt, extra in (("jax", jax_main, root / "head_orbax", []),
                                        ("port", port_main, root / "head.pt", ["--device", "cpu"])):
        c = json.loads(json.dumps(conf))
        c["path"].update(hidden_states=str(root / f"hs_cli_{side}"),
                         cache=str(root / f"cache_cli_{side}"))
        c["data"].update(embedding_type="encoder", embedding_format="concat", chunk_size=8)
        c["model"].update(name="whisper", zdim=16)
        cpath = root / f"cli_{side}.json"
        cpath.write_text(json.dumps(c))
        assert run(["extract", "--config", str(cpath), "--split", "train", "--kinds", "x_concat",
                    "--batched", "--batch-size", "8", "--hf-checkpoint", str(ckpt), *extra]) == 0
        assert _last_json(capsys)["done"] == 9
        assert run(["evaluate", "--config", str(cpath), "--split", "train", "--checkpoint",
                    str(head_ckpt), *extra]) == 0
        metrics[side] = _last_json(capsys)
    got, want = metrics["port"], metrics["jax"]
    assert got["n_queries"] == want["n_queries"] == 9
    for k in ("MAP", "MR1", "P@10"):
        assert abs(got[k] - want[k]) <= TOL, (k, got, want)
    assert got["MAP"] > 0.95, got
