"""Extraction over a split in the port (wealy_tpu_torch.cli.extract_batched,
.cli.extract, the ``extract`` and ``pack`` commands) against the JAX
package on the CPU:

- the batched split jobs with one embed function given to both
  packages' jobs store the same arrays, skip, resume and sink the same way;
- with the dev Whisper in f32 (one JAX init carried into the port by
  ``state_dict_from_jax_params``), the jobs' x_concat,
  hs_last_seq and hs_last_all agree within rtol/atol 1e-4 (the port's f32
  tolerance) with identical lengths;
- the CLI: the same JSON keys, the same exit-2 refusals, npz files and
  packs the JAX package reads back, and bf16 rows of the same checkpoint
  within the port's bf16 gate (row cosine >= 0.999)."""

import csv
import json
import wave

import numpy as np
import pytest
import torch

import wealy_tpu.cli.extract_batched as JEB
import wealy_tpu.data.audio_dataset as JAD
import wealy_tpu_torch.cli.extract_batched as TEB
import wealy_tpu_torch.data.audio_dataset as TAD
from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.data.embedding_store import EmbeddingStore as JStore
from wealy_tpu.data.metadata import load_lyric_covers as j_load_lyric_covers
from wealy_tpu.data.packed_store import PackedStore as JPacked
from wealy_tpu.train.config import Config as JConfig
from wealy_tpu_torch.cli.main import main as port_main
from wealy_tpu_torch.data.embedding_store import EmbeddingStore
from wealy_tpu_torch.data.metadata import load_lyric_covers
from wealy_tpu_torch.data.packed_store import PackedStore, PackWriter
from wealy_tpu_torch.train.config import Config

from _torch_parity import jax_and_port_whisper, min_row_cosine

RTOL = ATOL = 1e-4  # f32 activation parity
COS_MIN = 0.999  # bf16 per-row cosine gate
SR = 16000
# train: 100 (20 s), 101 (35 s), 200 (65 s), 201 (no file: 1 s of silence)
SECONDS = {"100": 20, "101": 35, "200": 65}
ROWS = {
    "train": [(1, 100, False, "o", "A"), (1, 101, True, "c", "A"),
              (2, 200, False, "o", "B"), (2, 201, True, "c", "B")],
    "val": [(3, 300, False, "o", "C"), (3, 301, True, "c", "C")],
    "test": [(4, 400, False, "o", "D"), (4, 401, True, "c", "D")],
}


def _write_wav(path, x):
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _conf(root, hs="hs"):
    return {
        "path": {"lyric_covers_data": str(root / "lc"), "hidden_states": str(root / hs),
                 "cache": str(root / f"cache_{hs}"), "data": str(root / "data")},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat"},
        "model": {"name": "whisper", "zdim": 16, "whisper_size": "dev"},
    }


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A lyric-covers project in the layout of tests/test_cli.py::project:
    CSVs, 16 kHz WAV bytes under the layout's .mp3 names for the train
    versions (one without a file) and the test split, and a config."""
    root = tmp_path_factory.mktemp("split")
    lc = root / "lc"
    lc.mkdir()
    for split, data in ROWS.items():
        with open(lc / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            w.writerows(data)
    rng = np.random.default_rng(0)
    base = root / "data" / "LyricCovers" / "audio"
    for key, seconds in {**SECONDS, "400": 12, "401": 31}.items():
        _write_wav(base / key / f"{key}_audio.mp3", 0.1 * rng.normal(size=seconds * SR))
    return root


def _both(root, hs_port="hs_port", hs_jax="hs_jax"):
    """(port config, port metadata), (JAX config, JAX metadata) of one
    project, each writing its own store."""
    port = (Config.from_dict(_conf(root, hs_port)), load_lyric_covers(root / "lc"))
    jax = (JConfig.from_dict(_conf(root, hs_jax)), j_load_lyric_covers(root / "lc"))
    return port, jax


# --- the split jobs with one embed function on both sides ----------------------------------------

@pytest.fixture
def short_chunks(monkeypatch):
    """Chunks of 1000 samples (the JAX test's patch of its split job), so that
    the host-only embed functions below see many chunks per song."""
    for mod, chunk in ((TEB, TEB.chunk_waveform), (JEB, JEB.chunk_waveform)):
        monkeypatch.setattr(mod, "N_SAMPLES", 1000)
        monkeypatch.setattr(mod, "chunk_waveform", lambda a, chunk=chunk: chunk(a, 1000))


def shared_embed(audio):
    """(B, 1000) -> (B, 3): a host function of the chunk (either package's
    batch type goes through ``np.asarray``)."""
    a = np.asarray(audio, np.float32)
    return np.stack([a.mean(1), a.std(1), a[:, :10].sum(1)], 1)


def shared_decode(audio):
    """(B, 1000) -> (hidden (B, 6, 3), lengths (B,)): lengths from the
    chunk's energy, a position ramp in the states."""
    z = shared_embed(audio)
    lengths = (2 + (np.abs(np.asarray(audio)).sum(1) * 97).astype(np.int64) % 5).astype(np.int32)
    return z[:, None, :] * np.arange(1, 7, dtype=np.float32)[None, :, None], lengths


def _run_both(project, kind, **kw):
    (pc, pmd), (jc, jmd) = _both(project)
    if kind.startswith("hs_last"):
        port = TEB.extract_split_batched_decoder(pc, pmd, "train", shared_decode, kind=kind, **kw)
        jax = JEB.extract_split_batched_decoder(jc, jmd, "train", shared_decode, kind=kind, **kw)
    else:
        port = TEB.extract_split_batched(pc, pmd, "train", shared_embed, kind=kind, **kw)
        jax = JEB.extract_split_batched(jc, jmd, "train", shared_embed, kind=kind, **kw)
    return port, jax, EmbeddingStore(pc.path.hidden_states, "lyric-covers"), JStore(
        jc.path.hidden_states, "lyric-covers")


@pytest.mark.parametrize("kind,batch_size,n_workers", [
    ("x_concat", 4, 4), ("x_concat", 1, 1), ("hs_wealy_concat", 7, 2),
    ("hs_last_seq", 4, 4), ("hs_last_seq_en", 3, 1), ("hs_last_all", 16, 4),
])
def test_split_jobs_store_what_the_jax_jobs_store(project, short_chunks, kind, batch_size,
                                                  n_workers):
    port, jax, store, jstore = _run_both(project, kind, batch_size=batch_size,
                                         n_workers=n_workers, overwrite=True)
    assert sorted(port["done"]) == sorted(jax["done"]) == ["100", "101", "200", "201"]
    assert port["incomplete"] == jax["incomplete"] == [] and port["skipped"] == 0
    assert set(port["throughput"]) == set(jax["throughput"])
    assert port["throughput"]["total_items"] == jax["throughput"]["total_items"]
    for v in port["done"]:
        got, want = store.load(v, f"{kind}.npz"), jstore.load(v, f"{kind}.npz")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # 201 has no file: 1 s of silence, 16 chunks of 1000 samples (2 positions each)
    rows = 32 if kind.startswith("hs_last_seq") else 16
    assert store.load("201", f"{kind}.npz")["embeddings"].shape[0] == rows


def test_resume_skips_and_limit_caps(project, short_chunks):
    (pc, pmd), _ = _both(project, hs_port="hs_resume")
    first = TEB.extract_split_batched(pc, pmd, "train", shared_embed, limit=2, batch_size=8)
    assert first["done"] == ["100", "101"] and first["skipped"] == 0
    again = TEB.extract_split_batched(pc, pmd, "train", shared_embed, batch_size=8)
    assert sorted(again["done"]) == ["200", "201"] and again["skipped"] == 2
    calls = []
    last = TEB.extract_split_batched(pc, pmd, "train", lambda a: calls.append(1), batch_size=8)
    assert last["done"] == [] and last["skipped"] == 4 and not calls
    assert last["throughput"]["total_items"] == 0
    missing = (project / "cache_hs_resume" / "missing_embeddings_x_concat.txt").read_text()
    assert missing.split() == ["300", "301", "400", "401"]  # the other splits' work list


def test_pack_direct_sink_writes_the_jax_pack(project, short_chunks):
    """The --pack-direct sink: no npz, and the pack's bytes are the JAX
    sink's."""
    (pc, pmd), (jc, jmd) = _both(project, "hs_sink_p", "hs_sink_j")
    packs = []
    for job, c, md, writer_cls in ((TEB, pc, pmd, PackWriter),
                                      (JEB, jc, jmd, __import__(
                                          "wealy_tpu.data.packed_store",
                                          fromlist=["PackWriter"]).PackWriter)):
        writer = writer_cls(c.path.hidden_states, "x_concat", dataset_name="lyric-covers")
        result = job.extract_split_batched(
            c, md, "train", shared_embed, kind="x_concat", batch_size=4,
            sink=lambda v, writer=writer, **a: writer.add(v, a["embeddings"]),
            skip_fn=lambda v, writer=writer: v in writer)
        assert sorted(result["done"]) == ["100", "101", "200", "201"]
        packs.append(writer.close())
        assert not EmbeddingStore(c.path.hidden_states, "lyric-covers").exists("100",
                                                                              "x_concat.npz")
    assert sorted(packs[0].keys()) == sorted(packs[1]._index)
    for v in packs[0].keys():
        np.testing.assert_array_equal(packs[0].load(v), packs[1].load(v))


def test_a_mesh_waits_for_item_6(project, short_chunks):
    """Ported with item 6d: the job on a mesh (here the one-rank mesh of a
    process without a group; two ranks in tests/test_torch_mesh_commands.py)
    stores what the job without one stores."""
    from wealy_tpu_torch.parallel.mesh import make_mesh

    stores = []
    for name, mesh in (("mesh_none", None), ("mesh_one", make_mesh(device="cpu"))):
        c, md = _both(project, hs_port=name)[0]
        result = TEB.extract_split_batched(c, md, "train", shared_embed, batch_size=4, mesh=mesh)
        assert sorted(result["done"]) == ["100", "101", "200", "201"]
        stores.append(EmbeddingStore(c.path.hidden_states, "lyric-covers"))
    for v in ("100", "101", "200", "201"):
        np.testing.assert_array_equal(stores[0].load(v, "x_concat.npz")["embeddings"],
                                      stores[1].load(v, "x_concat.npz")["embeddings"])


# --- the dev Whisper in f32, one init on both sides --------------------------------------------

@pytest.fixture(scope="module")
def dev_fns():
    """(port embed, port decode, JAX embed, JAX decode) of the dev Whisper
    in f32 with the JAX init carried into the port; decode at max_len 12."""
    import jax
    import jax.numpy as jnp

    from wealy_tpu.audio.mel import log_mel_spectrogram as j_mel
    from wealy_tpu.models.whisper import WHISPER_CONFIGS
    from wealy_tpu.models.whisper.generate import default_prompt as j_prompt
    from wealy_tpu.models.whisper.generate import greedy_decode as j_greedy
    from wealy_tpu.models.whisper.model import Whisper as JWhisper
    from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
    from wealy_tpu_torch.models.whisper.extract import decoder_embeddings

    cfg = WHISPER_CONFIGS["dev"]
    jmodel, params, port = jax_and_port_whisper(cfg, "float32", seed=0)
    max_len = 12

    @jax.jit
    def j_embed(audio):
        states = jmodel.apply({"params": params}, j_mel(audio, cfg.n_mels),
                              method=JWhisper.encode)
        return jnp.mean(states, axis=1)

    @jax.jit
    def j_decode(audio):
        states = jmodel.apply({"params": params}, j_mel(audio, cfg.n_mels),
                              method=JWhisper.encode)
        out = j_greedy(jmodel, params, states, cfg, prompt=j_prompt(cfg), max_len=max_len)
        return out["hidden"], out["lengths"]

    @torch.no_grad()
    def t_embed(audio):
        return port.encode(log_mel_spectrogram_fused(audio, cfg.n_mels)).mean(1)

    @torch.no_grad()
    def t_decode(audio):
        out = decoder_embeddings(port, log_mel_spectrogram_fused(audio, cfg.n_mels), cfg,
                                 max_len=max_len)
        return out["hidden"], out["lengths"]

    return t_embed, t_decode, j_embed, j_decode


@pytest.mark.parametrize("kind", ["x_concat", "hs_last_seq", "hs_last_all"])
def test_dev_whisper_f32_matches_the_jax_job(project, dev_fns, kind):
    """Real 30 s chunks (100: 1, 101: 2, 200: 3, 201: 1 of silence) in
    batches of 3, the last one padded: the f32 arrays each job hands its
    sink, the port's against the JAX job's (the store rounds them to
    f16, the same cast in both packages)."""
    t_embed, t_decode, j_embed, j_decode = dev_fns
    (pc, pmd), (jc, jmd) = _both(project)
    got, want = {}, {}

    def sink(into):
        return lambda v, **arrays: into.setdefault(v, arrays)

    kw = dict(kind=kind, batch_size=3, overwrite=True)
    if kind.startswith("hs_last"):
        port = TEB.extract_split_batched_decoder(pc, pmd, "train", t_decode, sink=sink(got), **kw)
        jax = JEB.extract_split_batched_decoder(jc, jmd, "train", j_decode, sink=sink(want), **kw)
    else:
        port = TEB.extract_split_batched(pc, pmd, "train", t_embed, sink=sink(got), **kw)
        jax = JEB.extract_split_batched(jc, jmd, "train", j_embed, sink=sink(want), **kw)
    assert sorted(port["done"]) == sorted(jax["done"]) == ["100", "101", "200", "201"]
    assert port["throughput"]["total_items"] == 7 and port["incomplete"] == []
    for v, n_chunks in (("100", 1), ("101", 2), ("200", 3), ("201", 1)):
        assert set(got[v]) == set(want[v])
        a, b = got[v]["embeddings"], np.asarray(want[v]["embeddings"], np.float32)
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        if kind == "hs_last_all":
            np.testing.assert_array_equal(got[v]["lengths"], want[v]["lengths"])
            assert a.shape[:2] == (n_chunks, 12)
        if kind == "x_concat":
            assert a.shape == (n_chunks, 64)


# --- the CLI ----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(project):
    """The dev Whisper's JAX init as an openai-whisper state-dict file, so
    that both CLIs load the same weights (--hf-checkpoint)."""
    from wealy_tpu.models.whisper import WHISPER_CONFIGS

    _, _, port = jax_and_port_whisper(WHISPER_CONFIGS["dev"], "float32", seed=0)
    path = project / "dev_whisper.pt"
    torch.save(port.state_dict(), path)
    return str(path)


def _cli_conf(project, name):
    path = project / f"{name}.json"
    path.write_text(json.dumps(_conf(project, name)))
    return str(path)


@pytest.fixture(scope="module")
def tp_ranks(project, checkpoint, tmp_path_factory):
    """Two gloo ranks (tests/_torch_extract_tp_cases.py): the decoder factory
    with tp=2 on one batch, then ``extract --batched --tp 2`` as torchrun
    launches it, on the dev checkpoint with a confident decoder (final
    LayerNorm scale x128: bf16 rounding moves no argmax)."""
    from _torch_parity import spawn_ranks

    work = tmp_path_factory.mktemp("extract_tp")
    sd = torch.load(checkpoint, weights_only=True)
    sd["decoder.ln.weight"] = sd["decoder.ln.weight"] * 128.0
    ckpt = str(work / "confident.pt")
    torch.save(sd, ckpt)
    audio = (0.1 * np.random.default_rng(0).normal(size=(2, 480000))).astype(np.float32)
    argv = ["extract", "--config", _cli_conf(project, "tp_mesh"), "--batched", "--tp", "2",
            "--limit", "1", "--kinds", "hs_last_seq", "--hf-checkpoint", ckpt, "--overwrite",
            "--device", "cpu"]
    torch.save({"conf": _conf(project, "tp_factory"), "ckpt": ckpt,
                "audio": torch.from_numpy(audio), "argv": argv}, work / "inputs.pt")
    return ckpt, audio, spawn_ranks("_torch_extract_tp_cases", 2, work, n_ports=2)


def _same_live_rows(a, b):
    """bf16 decoder states of two routes: the same zero rows (past a
    chunk's end), row cosine >= COS_MIN elsewhere."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    live = np.abs(b).sum(axis=-1) > 0
    np.testing.assert_array_equal(np.abs(a).sum(axis=-1) > 0, live)
    assert min_row_cosine(a[live], b[live]) >= COS_MIN


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--pack-direct"],
    ["--quant-int8"],
    ["--batched", "--quant-int8", "--kinds", "hs_last_seq"],
    ["--batched", "--pack", "--pack-direct"],
    ["--batched", "--pack-direct", "--kinds", "hs_last_all"],
])
def test_the_jax_refusals_exit_2(project, capsys, flags):
    conf = _cli_conf(project, "refuse")
    argv = ["extract", "--config", conf, *flags]
    assert jax_main(argv) == 2
    jax_err = capsys.readouterr().err
    assert port_main(argv) == 2  # before any device or model work
    assert capsys.readouterr().err == jax_err


@pytest.mark.parametrize("flags,item", [
    (["--batched", "--quant-int8"], 6), (["--batched", "--tp", "2"], 6),
    (["--profile", "trace_dir"], 6), (["--batched", "--cross-kv-f8"], 5),
    (["--self-kv-f8"], 5), (["--kinds", "hs_clews"], 4),
])
def test_what_is_not_ported_names_its_item(project, flags, item, capsys, request):
    conf = _cli_conf(project, "unported")
    argv = ["extract", "--config", conf, *flags, "--device", "cpu"]
    if "--tp" in flags:
        # ported with item 6d: two ranks split one model and store what one
        # process stores (rank 0 alone writes and prints)
        ckpt, _, results = request.getfixturevalue("tp_ranks")
        (rc0, out0), (rc1, out1) = (res["cli"] for res in results)
        assert rc0 == rc1 == 0 and out1 == []
        assert port_main(["extract", "--config", _cli_conf(project, "tp_one"), "--batched",
                          "--limit", "1", "--kinds", "hs_last_seq", "--hf-checkpoint", ckpt,
                          "--overwrite", "--device", "cpu"]) == 0
        want = _json_line(capsys)
        got = json.loads(out0[-1])
        assert got["done"] == want["done"] == 1 and got["incomplete"] == []
        a, b = (EmbeddingStore(project / name, "lyric-covers").load(
            "100", "hs_last_seq.npz")["embeddings"] for name in ("tp_mesh", "tp_one"))
        # 224 greedy steps in bf16: the two routes' rounding may fork the
        # tokens at a near-tie late in the chunk (the f32 TP decode holds
        # every token: tests/test_torch_tp.py); the states agree before it
        assert a.shape[1] == b.shape[1] and min(len(a), len(b)) >= 32
        _same_live_rows(a[:32], b[:32])
        return
    if item == 4:
        # ported with the CLEWS/fusion slice (item 4): the trio is written, as
        # by the JAX CLI (held against it in tests/test_torch_fusion_cli.py)
        assert port_main(argv + ["--limit", "1"]) == 0
        assert _json_line(capsys) == {"done": 1, "skipped": 0, "failed": 0}
        return
    if item == 5:
        # ported with transcription (item 5): the batched decoder kind stores
        # through float8 KV caches; the one-song path ignores the flags, as
        # the JAX CLI's does
        assert port_main(argv + ["--limit", "1", "--kinds", "hs_last_seq", "--overwrite"]) == 0
        out = _json_line(capsys)
        assert out["done"] == 1 and out["skipped"] == 0
        assert out.get("incomplete", []) == [] and out.get("failed", 0) == 0
        seq = EmbeddingStore(project / "unported", "lyric-covers").load("100", "hs_last_seq.npz")
        emb = seq["embeddings"]
        assert emb.ndim == 2 and emb.shape[1] == 64 and np.isfinite(emb).all()
        return
    if "--quant-int8" in flags:
        # ported with item 6a: the int8 encoder stores x_concat (held against
        # the JAX CLI in tests/test_torch_quant.py)
        assert port_main(argv + ["--limit", "1", "--kinds", "x_concat", "--overwrite"]) == 0
        out = _json_line(capsys)
        assert out["done"] == 1 and out["incomplete"] == []
        emb = EmbeddingStore(project / "unported", "lyric-covers").load("100", "x_concat.npz")
        assert emb["embeddings"].shape == (1, 64) and np.isfinite(emb["embeddings"]).all()
        return
    if "--profile" in flags:
        # ported with item 6b: a torch.profiler trace of the whole command
        # (tests/test_torch_profiling.py)
        trace_dir = project / "unported_trace"
        argv[argv.index("trace_dir")] = str(trace_dir)
        assert port_main(argv + ["--limit", "1", "--kinds", "x_concat", "--overwrite"]) == 0
        assert _json_line(capsys)["done"] == 1
        assert list(trace_dir.glob("*.pt.trace.json"))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        port_main(argv)


def test_embed_factories_name_their_items(project, request):
    # the int8 encoder came with item 6a: the factory builds and embeds
    config = Config.from_dict(_conf(project, "int8_factory"))
    embed = TEB.make_encoder_embed_fn(config, quant_int8=True, device="cpu")
    z = embed(np.zeros((2, 480000), np.float32))
    assert z.shape == (2, 64) and z.dtype == torch.bfloat16 and bool(torch.isfinite(z).all())
    # the tensor-parallel decoder came with item 6d: two ranks decode as one
    ckpt, audio, results = request.getfixturevalue("tp_ranks")
    one = TEB.make_decoder_embed_fn(config, ckpt, max_len=8, device="cpu")
    hidden, lengths = one(audio)
    for res in results:
        h, n = res["factory"]
        np.testing.assert_array_equal(n.numpy(), lengths.numpy())
        _same_live_rows(h.numpy(), hidden.float().numpy())
    # the float8 KV modes came with item 5: the factory builds and decodes
    config = Config.from_dict(_conf(project, "f8_factory"))
    fn = TEB.make_decoder_embed_fn(config, cross_kv_f8=True, self_kv_f8=True, max_len=6,
                                   device="cpu")
    hidden, lengths = fn(np.zeros((1, 480000), np.float32))
    assert hidden.shape == (1, 6, 64) and bool(torch.isfinite(hidden).all())
    assert 2 <= int(lengths[0]) <= 6


def test_cli_extract_batched_pack_and_resume(project, checkpoint, capsys):
    """``extract --batched`` then ``pack`` through both CLIs on the same
    checkpoint: the same JSON keys, x_concat rows within the bf16 gate, the
    port's pack read back equal to its store by both packages, and a second
    run that skips every version."""
    pconf, jconf = _cli_conf(project, "cli_p"), _cli_conf(project, "cli_j")
    common = ["--split", "train", "--kinds", "x_concat", "--batched", "--batch-size", "8",
              "--hf-checkpoint", checkpoint]
    assert port_main(["extract", "--config", pconf, *common, "--device", "cpu"]) == 0
    got = _json_line(capsys)
    assert jax_main(["extract", "--config", jconf, *common]) == 0
    want = _json_line(capsys)
    assert set(got) == set(want) == {"done", "skipped", "incomplete", "throughput"}
    assert set(got["throughput"]) == set(want["throughput"])
    # 201 has no file, and the audio filter then drops 200's clique of one
    assert got["done"] == want["done"] == 2 and got["incomplete"] == []
    store = EmbeddingStore(project / "cli_p", "lyric-covers")
    jstore = JStore(project / "cli_j", "lyric-covers")
    for v in ("100", "101"):
        a = store.load(v, "x_concat.npz")["embeddings"]
        b = jstore.load(v, "x_concat.npz")["embeddings"]
        assert a.shape == b.shape and min_row_cosine(a, b) >= COS_MIN
    # the JAX store reads the port's files, and both read the port's pack
    for v in ("100", "101"):
        np.testing.assert_array_equal(JStore(project / "cli_p", "lyric-covers").load(
            v, "x_concat.npz")["embeddings"], store.load(v, "x_concat.npz")["embeddings"])
    assert port_main(["pack", "--config", pconf, "--kind", "x_concat.npz"]) == 0
    packed = _json_line(capsys)
    assert set(packed) == {"kind", "versions_packed", "versions_requested", "bin"}
    assert packed["versions_packed"] == 2 and packed["versions_requested"] == 8
    for reader in (PackedStore, JPacked):
        pk = reader(project / "cli_p", "x_concat", dataset_name="lyric-covers")
        for v in ("100", "101"):
            np.testing.assert_array_equal(pk.load(v), store.load(v, "x_concat.npz")["embeddings"])
    assert port_main(["extract", "--config", pconf, *common, "--device", "cpu"]) == 0
    again = _json_line(capsys)
    assert again["done"] == 0 and again["skipped"] == 2


def test_cli_pack_direct_and_overwrite_keep_other_splits(project, checkpoint, capsys):
    """``--pack-direct`` writes the pack and no npz; re-extracting one split
    with ``--overwrite`` carries the other split's rows forward."""
    conf = _cli_conf(project, "direct")
    base = ["extract", "--config", conf, "--kinds", "x_concat", "--batched", "--pack-direct",
            "--hf-checkpoint", checkpoint, "--device", "cpu"]
    assert port_main([*base, "--split", "test"]) == 0
    assert _json_line(capsys)["done"] == 2
    first = PackedStore(project / "direct", "x_concat", dataset_name="lyric-covers")
    test_rows = {v: first.load(v) for v in ("400", "401")}
    assert port_main([*base, "--split", "train", "--overwrite"]) == 0
    assert _json_line(capsys)["done"] == 2
    assert port_main([*base, "--split", "test", "--overwrite"]) == 0
    assert _json_line(capsys)["done"] == 2
    pack = PackedStore(project / "direct", "x_concat", dataset_name="lyric-covers")
    assert sorted(pack.keys()) == ["100", "101", "400", "401"]
    for v, rows in test_rows.items():
        np.testing.assert_array_equal(pack.load(v), rows)  # the same weights, the same rows
    assert not EmbeddingStore(project / "direct", "lyric-covers").exists("100", "x_concat.npz")
    assert port_main([*base, "--split", "train"]) == 0
    resumed = _json_line(capsys)
    assert resumed["done"] == 0 and resumed["skipped"] == 2


def test_cli_extract_one_song_at_a_time(project, checkpoint, capsys):
    """Without --batched: ``extract_split`` through ``extract_song``, the JAX
    command's JSON keys, both kinds stored, and ``--pack`` packing each."""
    conf = _cli_conf(project, "single")
    assert port_main(["extract", "--config", conf, "--split", "test", "--limit", "1",
                      "--hf-checkpoint", checkpoint, "--pack", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0] == {"done": 1, "skipped": 0, "failed": 0, "failed_keys": []}
    assert [ln["kind"] for ln in lines[1:]] == ["x_concat", "hs_last_seq"]
    store = EmbeddingStore(project / "single", "lyric-covers")
    assert store.load("400", "x_concat.npz")["embeddings"].shape == (1, 64)
    seq = store.load("400", "hs_last_seq.npz")["embeddings"]
    assert seq.ndim == 2 and seq.shape[1] == 64
    np.testing.assert_array_equal(
        JPacked(project / "single", "hs_last_seq", dataset_name="lyric-covers").load("400"), seq)
    missing = (project / "cache_single" / "missing_embeddings_x_concat.txt").read_text().split()
    assert "400" not in missing and "401" in missing


@pytest.mark.parametrize("fault", ["refused_launch", "store_write", "out_of_memory"])
def test_extract_split_records_only_a_songs_own_failures(project, checkpoint, capsys,
                                                         monkeypatch, fault):
    """A song's own failure (a store write, the card's memory) is recorded
    for a re-run and the split goes on (exit 1); a kernel wrapper's refused
    launch (K1's, given a tensor on a device it does not take) reaches the
    caller."""
    import wealy_tpu_torch.models.whisper.extract as TEX

    argv = ["extract", "--config", _cli_conf(project, f"fault_{fault}"), "--split", "test",
            "--kinds", "x_concat", "--hf-checkpoint", checkpoint, "--device", "cpu"]
    if fault == "refused_launch":
        real = TEX.log_mel_spectrogram_fused
        monkeypatch.setattr(TEX, "log_mel_spectrogram_fused",
                            lambda chunks, n_mels: real(chunks.to("meta"), n_mels=n_mels))
        with pytest.raises(ValueError, match="unsupported device meta"):
            port_main(argv)
        return

    def fail(*args, **kwargs):
        if fault == "store_write":
            raise OSError("no space left on device")
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(EmbeddingStore if fault == "store_write" else TEX,
                        "save" if fault == "store_write" else "extract_song", fail)
    assert port_main(argv) == 1
    assert _json_line(capsys) == {"done": 0, "skipped": 0, "failed": 2,
                                  "failed_keys": ["400", "401"]}


@pytest.mark.parametrize("ticks", [[], [4], [32, 32, 7], [16] * 25])
def test_throughput_meter_reports_as_jax(monkeypatch, ticks):
    """The split jobs' meter: the JAX meter's report for the same ticks at the
    same clock (one card)."""
    import time as _time

    from wealy_tpu.utils.profiling import ThroughputMeter as JMeter
    from wealy_tpu_torch.utils.profiling import ThroughputMeter

    clock = iter(np.arange(0.0, 100.0, 0.37))
    monkeypatch.setattr(_time, "perf_counter", lambda: float(next(clock)))
    port, jax = ThroughputMeter(window=20), JMeter(window=20, n_chips=1)
    for n in ticks:
        port.tick(n)
        jax.tick(n)
    assert port.report() == jax.report()
    assert port.n_chips == 1
