"""The port's serving path (wealy_tpu_torch.cli.serve) against the JAX
package's on the CPU: the same project and head weights give the same index
and the same rankings (scores within atol 1e-4; int8 within the JAX int8
bounds), plus the engine's own cases, the micro-batcher and the daemon."""

import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from test_serve_cli import ROWS, _write_csvs, _write_wav, serve_project  # noqa: F401
from wealy_tpu.cli import serve as jserve
from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.train.config import Config as JConfig
from wealy_tpu_torch.cli import main as tcli
from wealy_tpu_torch.cli import serve as tserve
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.train.config import Config

EMB_DIM = 24  # serve_project's embedding width
TIMEOUT = 60  # seconds for any socket or thread wait


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_head_file(cpath, root) -> str:
    """The head the JAX serving commands use without a checkpoint (flax
    init, PRNGKey(0)), carried into a torch state-dict file."""
    from wealy_tpu.models.registry import build_model

    config = JConfig.from_dict(json.loads(cpath.read_text()))
    model, _ = build_model(config.model.name, zdim=config.model.zdim)
    params, _ = jserve._load_head_params(config, model, None, config.data.chunk_size, EMB_DIM)
    path = root / "head.pt"
    torch.save(head_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)), path)
    return str(path)


@pytest.fixture
def indexed(serve_project, capsys):  # noqa: F811
    """(root, config path, store, head file, JAX index, port index): both
    packages' ``index`` on the same project and head."""
    root, cpath, store = serve_project
    head = _jax_head_file(cpath, root)
    jidx, tidx = root / "serve" / "jax.npz", root / "serve" / "torch.npz"
    assert jax_main(["index", "--config", str(cpath), "--split", "test", "--out", str(jidx)]) == 0
    assert tcli.main(["index", "--config", str(cpath), "--split", "test", "--out", str(tidx),
                      "--checkpoint", head, "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert out["indexed"] == 4 and out["sets"] is True and out["checkpoint_step"] is None
    return root, cpath, store, head, jidx, tidx


def _seq(store, vid):
    with np.load(store.path(vid, "hs_last_seq.npz")) as d:
        return d["embeddings"]


def _engines(cpath, jidx, head, **kw):
    jconfig = JConfig.from_dict(json.loads(cpath.read_text()))
    config = Config.from_dict(json.loads(cpath.read_text()))
    jax_kw = {k: v for k, v in kw.items() if k != "device"}
    return (jserve.QueryEngine(jconfig, str(jidx), None, **jax_kw),
            tserve.QueryEngine(config, str(jidx), head, device="cpu", **kw))


def _assert_same_payloads(got, want, atol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "results"} == \
            {k: v for k, v in w.items() if k != "results"}
        assert [r["version_key"] for r in g["results"]] == [r["version_key"] for r in w["results"]]
        assert [r["rank"] for r in g["results"]] == [r["rank"] for r in w["results"]]
        np.testing.assert_allclose([r["score"] for r in g["results"]],
                                   [r["score"] for r in w["results"]], atol=atol)


def test_index_matches_jax(indexed):
    _, _, _, _, jidx, tidx = indexed
    with np.load(jidx) as j, np.load(tidx) as t:
        assert set(j.files) == set(t.files)
        for key in ("version_keys", "cliques", "labels", "ids", "set_mask"):
            np.testing.assert_array_equal(t[key], j[key])
        np.testing.assert_allclose(t["vecs"], j["vecs"], rtol=1e-4, atol=1e-5)
        assert t["sets"].dtype == np.float16
        np.testing.assert_allclose(t["sets"].astype(np.float32), j["sets"].astype(np.float32),
                                   atol=2e-3)
        assert json.loads(str(t["meta"])) == json.loads(str(j["meta"]))


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("kw", [{}, {"rerank": 3}, {"pooled": True}],
                         ids=["exact", "rerank", "pooled"])
def test_engine_matches_jax(indexed, kw, resident):
    """The same index file, head and queries through both engines (block 2
    < corpus 4: the block seams of both)."""
    _, cpath, store, head, jidx, _ = indexed
    jeng, teng = _engines(cpath, jidx, head, block_size=2, resident=resident)
    assert teng._resident == resident and jeng._resident == resident
    seqs = [_seq(store, vid) for vid in ("400", "501", "401")]
    for k in (4, 2):
        _assert_same_payloads(teng.search_many(seqs, k=k, **kw), jeng.search_many(seqs, k=k, **kw))
    assert teng.search(seqs[0], k=4, **kw)["results"][0]["version_key"] == "400"


def test_int8_engine_matches_jax(indexed):
    """quantize="int8": the port's int8 engine gives the JAX int8 engine's
    rankings, and holds the JAX test's bounds against the f16 engine (top 2
    equal, the same top-k set, scores within 1.5e-2)."""
    _, cpath, store, head, jidx, _ = indexed
    jint8, tint8 = _engines(cpath, jidx, head, block_size=2, quantize="int8")
    _, tf16 = _engines(cpath, jidx, head, block_size=2)
    assert tint8._quantized and tint8._sets_dev.dtype == torch.int8 and tint8.sets is None
    assert tint8.resident_bytes() < tf16.resident_bytes()
    seq = _seq(store, "400")
    for kw in ({}, {"rerank": 3}):
        got = tint8.search(seq, k=4, **kw)
        _assert_same_payloads([got], [jint8.search(seq, k=4, **kw)])
        ref = {r["version_key"]: r["score"] for r in tf16.search(seq, k=4, **kw)["results"]}
        mine = {r["version_key"]: r["score"] for r in got["results"]}
        assert [r["version_key"] for r in got["results"]][:2] == ["400", "401"]
        assert set(mine) == set(ref)
        assert all(abs(mine[v] - ref[v]) < 1.5e-2 for v in ref), (mine, ref)
    config = Config.from_dict(json.loads(cpath.read_text()))
    with pytest.raises(ValueError, match="quantize"):
        tserve.QueryEngine(config, str(jidx), head, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="resident"):
        tserve.QueryEngine(config, str(jidx), head, quantize="int8", resident=False, device="cpu")


def test_int8_quantization_is_blockwise():
    """The int8 build quantises a block of songs at a time: any block size
    gives the whole-array result, and the peak host memory of a block-wise
    build stays under one f32 copy of the corpus."""
    import tracemalloc

    rng = np.random.default_rng(3)
    sets = rng.standard_normal((20000, 10, 64), dtype=np.float32).astype(np.float16)
    sets[5, 3] = 0  # an all-zero chunk: scale at its floor, values 0
    whole_q, whole_s = tserve._quantize_int8(sets, rows=len(sets))
    tracemalloc.start()
    q, s = tserve._quantize_int8(sets, rows=1024)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    np.testing.assert_array_equal(q, whole_q)
    np.testing.assert_array_equal(s, whole_s)
    assert not q[5, 3].any()
    assert peak < sets.size * 4, (peak, sets.size * 4)


def test_search_many_matches_search(indexed):
    _, cpath, store, head, jidx, _ = indexed
    config = Config.from_dict(json.loads(cpath.read_text()))
    engine = tserve.QueryEngine(config, str(jidx), head, block_size=2, device="cpu")
    seqs = [_seq(store, vid) for vid in ("400", "501", "401")]
    for kw in ({}, {"rerank": 2}, {"pooled": True}):
        _assert_same_payloads(engine.search_many(seqs, k=4, **kw),
                              [engine.search(s, k=4, **kw) for s in seqs], atol=1e-6)
    assert [o["results"][0]["version_key"] for o in engine.search_many(seqs, k=1)] == \
        ["400", "501", "401"]
    assert engine.search_many([]) == []


def test_query_cli(indexed, capsys):
    """``query`` prints one JSON line per query; ``--rerank`` and ``--pooled``
    reach the engine; a mismatched index exits 2."""
    root, cpath, store, head, jidx, tidx = indexed
    qpath = str(store.path("400", "hs_last_seq.npz"))
    base = ["query", "--config", str(cpath), "--index", str(tidx), "--checkpoint", head,
            "--device", "cpu", "--query-embeddings", qpath]
    for extra, scoring in (([], "chunk_set_bpwr"), (["--pooled"], "pooled_cosine"),
                           (["--rerank", "2"], "chunk_set_bpwr")):
        assert tcli.main(base + extra) == 0
        res = _last_json(capsys)
        assert res["query"] == qpath and res["scoring"] == scoring
        assert [r["version_key"] for r in res["results"]][:2] == ["400", "401"]
        assert ("rerank" in res) == ("--rerank" in extra)
    conf = json.loads(cpath.read_text())
    conf["model"]["zdim"] = 32
    other = root / "conf32.json"
    other.write_text(json.dumps(conf))
    capsys.readouterr()
    assert tcli.main(["query", "--config", str(other), "--index", str(tidx), "--device", "cpu",
                      "--query-embeddings", qpath]) == 2
    assert "zdim" in capsys.readouterr().err
    assert tcli.main(["query", "--config", str(cpath), "--index", str(tidx), "--device",
                      "cpu"]) == 2


def test_pooled_only_index(serve_project, capsys):  # noqa: F811
    root, cpath, store = serve_project
    idx = root / "serve" / "pooled.npz"
    assert tcli.main(["index", "--config", str(cpath), "--split", "test", "--out", str(idx),
                      "--no-sets", "--device", "cpu"]) == 0
    capsys.readouterr()
    with np.load(idx) as d:
        assert "sets" not in d.files
    assert tcli.main(["query", "--config", str(cpath), "--index", str(idx), "--device", "cpu",
                      "--query-embeddings", str(store.path("500", "hs_last_seq.npz")),
                      "--k", "2"]) == 0
    res = _last_json(capsys)
    assert res["scoring"] == "pooled_cosine" and len(res["results"]) == 2
    assert res["results"][0]["version_key"] == "500"
    config = Config.from_dict(json.loads(cpath.read_text()))
    assert not tserve.QueryEngine(config, str(idx), None, device="cpu")._resident


def test_index_update(serve_project, capsys):  # noqa: F811
    """``index --update`` embeds only new versions, carries the rest
    byte-identically, drops versions gone from the split, and refuses when
    the head changed."""
    root, cpath, store = serve_project
    idx = root / "serve" / "test.npz"
    base = ["index", "--config", str(cpath), "--split", "test", "--out", str(idx), "--device",
            "cpu"]
    assert tcli.main(base) == 0
    capsys.readouterr()
    with np.load(idx) as d:
        before = {str(k): v.copy() for k, v in zip(d["version_keys"], d["vecs"])}
        sets_before = {str(k): v.copy() for k, v in zip(d["version_keys"], d["sets"])}
    rows = dict(ROWS)
    rows["test"] = rows["test"] + [(6, 600, False, "o", "F"), (6, 601, True, "c", "F")]
    _write_csvs(root / "lc", rows)
    rng = np.random.default_rng(7)
    for vid in ("600", "601"):
        store.save(vid, "hs_last_seq.npz", embeddings=rng.normal(size=(14, 24)).astype(np.float32))
    assert tcli.main(base + ["--update"]) == 0
    out = _last_json(capsys)
    assert out["indexed"] == 6 and out["new"] == 2
    with np.load(idx) as d:
        keys = [str(k) for k in d["version_keys"]]
        assert keys[:4] == list(before) and set(keys) == set(before) | {"600", "601"}
        for k, v in before.items():
            np.testing.assert_array_equal(d["vecs"][keys.index(k)], v)
            np.testing.assert_array_equal(d["sets"][keys.index(k)][: sets_before[k].shape[0]],
                                          sets_before[k])
    rows["test"] = [r for r in rows["test"] if r[0] != 5]
    _write_csvs(root / "lc", rows)
    assert tcli.main(base + ["--update"]) == 0
    out = _last_json(capsys)
    assert out["indexed"] == 4 and out["new"] == 0
    with np.load(idx) as d:
        assert "500" not in {str(k) for k in d["version_keys"]}
    conf = json.loads(cpath.read_text())
    conf["model"]["zdim"] = 32
    c2 = root / "conf2.json"
    c2.write_text(json.dumps(conf))
    assert tcli.main(["index", "--config", str(c2), "--split", "test", "--out", str(idx),
                      "--update", "--device", "cpu"]) == 2
    assert "refused" in capsys.readouterr().err


def test_fusion_and_shard_wait_for_their_items(indexed, monkeypatch, capsys):
    """Fusion serving is ported (ROADMAP item 4; held against JAX in
    tests/test_torch_fusion_cli.py): a fusion name indexes, and an index
    whose meta says fusion is refused for a single-modal model, as JAX
    refuses it. ``--shard`` came with item 6d: in one process the corpus
    stays on one card."""
    root, cpath, store, head, jidx, _ = indexed
    conf = json.loads(cpath.read_text())
    conf["model"]["name"] = "whisper-clews"
    other = root / "fusion.json"
    other.write_text(json.dumps(conf))
    assert tcli.main(["index", "--config", str(other), "--split", "test", "--out",
                      str(root / "f.npz"), "--device", "cpu"]) == 0
    out = _last_json(capsys)
    assert out["fusion"] is True and out["sets"] is False and out["indexed"] == 4
    with np.load(jidx) as d:
        payload = {k: d[k] for k in d.files}
    meta = json.loads(str(payload["meta"]))
    meta["fusion"] = True
    payload["meta"] = np.asarray(json.dumps(meta))
    fidx = root / "fusion.npz"
    np.savez(fidx, **payload)
    config = Config.from_dict(json.loads(cpath.read_text()))
    with pytest.raises(ValueError, match="sig mismatch"):
        tserve.QueryEngine(config, str(fidx), head, device="cpu")
    with pytest.raises(ValueError, match="sig mismatch"):
        jserve.QueryEngine(JConfig.from_dict(json.loads(cpath.read_text())), str(fidx), None)
    # --shard (ported with item 6d) in one process: the corpus stays on one
    # card, whatever the card count, and an engine on a one-rank mesh answers
    # as the plain engine (two ranks: tests/test_torch_mesh_commands.py)
    from wealy_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = tcli.build_parser().parse_args(["query", "--config", str(cpath), "--index", str(jidx),
                                           "--shard", "--device", "cpu"])
    assert tserve._serving_mesh(args) is None
    meshed = tserve.QueryEngine(config, str(jidx), head, block_size=2, device="cpu",
                                mesh=make_mesh(device="cpu"))
    plain = tserve.QueryEngine(config, str(jidx), head, block_size=2, device="cpu")
    seq = _seq(store, "500")
    for kw in ({}, {"rerank": 3}, {"pooled": True}):
        assert meshed.search(seq, k=4, **kw) == plain.search(seq, k=4, **kw)


def test_serving_without_card_raises_unless_cpu_is_asked(indexed):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cpath, _, head, jidx, _ = indexed
    config = Config.from_dict(json.loads(cpath.read_text()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.QueryEngine(config, str(jidx), head)


# --- the micro-batcher ------------------------------------------------------------


def _batcher(calls, window_s=0.02, max_batch=32, fail=False):
    def dispatch(seqs, opts):
        calls.append((list(seqs), opts))
        if fail:
            raise RuntimeError("boom")
        return [f"r{s}" for s in seqs]

    return tserve.MicroBatcher(dispatch, window_s=window_s, max_batch=max_batch)


def _run_threads(targets):
    ts = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts)


def _submit(b, seqs, opts):
    """``b.submit_many`` on a thread of its own, waited for at most
    TIMEOUT; its result, or its exception re-raised here."""
    box = {}

    def run():
        try:
            box["out"] = b.submit_many(seqs, opts)
        except Exception as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    _run_threads([run])
    if "err" in box:
        raise box["err"]
    return box["out"]


def test_batcher_coalesces_concurrent_submits():
    calls = []
    b = _batcher(calls, window_s=0.05)
    outs = [None] * 6
    _run_threads([lambda i=i: outs.__setitem__(i, b.submit_many([i], ("k",))[0])
                  for i in range(6)])
    assert outs == [f"r{i}" for i in range(6)]
    assert len(calls) <= 2 and sum(len(c[0]) for c in calls) == 6
    assert (b.n_dispatches, b.n_queries) == (len(calls), 6)
    b.close()


def test_batcher_groups_by_opts():
    calls = []
    b = _batcher(calls, window_s=0.05)
    outs = {}
    _run_threads([lambda i=i: outs.__setitem__(i, b.submit_many([i], ("a",) if i % 2 else ("b",))[0])
                  for i in range(4)])
    assert outs == {i: f"r{i}" for i in range(4)}
    assert all(opts in (("a",), ("b",)) for _, opts in calls)
    b.close()


def test_batcher_error_reaches_every_waiter():
    calls = []
    b = _batcher(calls, fail=True, window_s=0.01)
    with pytest.raises(RuntimeError, match="boom"):
        _submit(b, [1, 2], ("k",))
    b._dispatch = lambda seqs, opts: [f"ok{s}" for s in seqs]
    assert _submit(b, [3], ("k",)) == ["ok3"]
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        _submit(b, [4], ("k",))


def test_batcher_max_batch_splits():
    calls = []
    b = _batcher(calls, window_s=0.02, max_batch=3)
    assert _submit(b, list(range(7)), ("k",)) == [f"r{i}" for i in range(7)]
    assert all(len(c[0]) <= 3 for c in calls) and len(calls) >= 3
    b.close()


# --- the daemon -------------------------------------------------------------------


def _post(url, payload, expect=200):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    if expect == 200:
        return json.loads(urllib.request.urlopen(req, timeout=TIMEOUT).read())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert e.value.code == expect
    return json.loads(e.value.read())


def _get(url):
    return json.loads(urllib.request.urlopen(url, timeout=TIMEOUT).read())


def _daemon_args(cpath, idx, head, *extra):
    return tcli.build_parser().parse_args(
        ["serve", "--config", str(cpath), "--index", str(idx), "--checkpoint", head, "--port", "0",
         "--device", "cpu", *extra])


def test_daemon_answers_and_reloads(indexed, capsys):
    """/healthz, /query (single, batch, malformed), /reload after ``index
    --update``: the answers are ``search_many``'s."""
    root, cpath, store, head, jidx, tidx = indexed
    with tserve.serving(_daemon_args(cpath, tidx, head, "--batch-window-ms", "5")) as daemon:
        url = daemon.url
        h = _get(f"{url}/healthz")
        assert h["ok"] and h["indexed"] == 4 and h["exact_sets"] is True
        assert h["model"] == "whisper" and h["checkpoint_step"] is None
        seq, seq2 = _seq(store, "400"), _seq(store, "501")
        res = _post(f"{url}/query", {"embeddings": seq.tolist(), "k": 2})
        assert res == daemon.engine.search(seq, k=2)
        assert res["results"][0]["version_key"] == "400"
        b = _post(f"{url}/query", {"batch": [{"embeddings": seq.tolist()},
                                             {"embeddings": seq2.tolist()}], "k": 1,
                                   "rerank": 3})
        assert b["batch"] == daemon.engine.search_many([seq, seq2], k=1, rerank=3)
        assert "error" in _post(f"{url}/query", {}, expect=400)
        assert "error" in _post(f"{url}/query", {"batch": []}, expect=400)
        assert _get(f"{url}/healthz")["batch_stats"]["queries"] == 3

        # live corpus growth: two new versions, index --update, /reload
        df = pd.read_csv(root / "lc" / "test_no_dup.csv")
        df.loc[len(df)] = (6, 600, False, "o", "F")
        df.loc[len(df)] = (6, 601, True, "c", "F")
        df.to_csv(root / "lc" / "test_no_dup.csv", index=False)
        rng = np.random.default_rng(600)
        new_emb = rng.normal(size=(14, 24)).astype(np.float32)
        store.save("600", "hs_last_seq.npz", embeddings=new_emb)
        store.save("601", "hs_last_seq.npz",
                   embeddings=new_emb + 0.05 * rng.normal(size=(14, 24)).astype(np.float32))
        assert tcli.main(["index", "--config", str(cpath), "--split", "test", "--out", str(tidx),
                          "--update", "--checkpoint", head, "--device", "cpu"]) == 0
        old = daemon.engine
        r = _post(f"{url}/reload", {})
        assert r["ok"] and r["was"] == 4 and r["indexed"] == 6, r
        assert old._sets_dev is None and daemon.engine is not old
        got = _post(f"{url}/query", {"embeddings": new_emb.tolist(), "k": 1})
        assert got["results"][0]["version_key"] == "600"
    capsys.readouterr()


def test_daemon_concurrent_clients(indexed):
    """8 clients at once: every answer right, fewer dispatches than queries
    once they coalesce."""
    _, cpath, store, head, _, tidx = indexed
    keys = ["400", "401", "500", "501"] * 2
    results = [None] * len(keys)
    with tserve.serving(_daemon_args(cpath, tidx, head, "--batch-window-ms", "25")) as daemon:
        def client(i, key):
            results[i] = _post(f"{daemon.url}/query", {"embeddings": _seq(store, key).tolist(),
                                                       "k": 1})

        client(0, keys[0])
        _run_threads([functools.partial(client, i, k) for i, k in enumerate(keys)])
        stats = _get(f"{daemon.url}/healthz")["batch_stats"]
    for key, res in zip(keys, results):
        assert res is not None and res["results"][0]["version_key"] == key, (key, res)
    assert stats["queries"] == 9 and stats["dispatches"] < 9


def test_daemon_reload_failures(indexed, monkeypatch):
    """A reload onto an index that does not fit the config is refused before
    the corpus is released, and the daemon keeps answering from it; a build
    that fails after the release leaves /healthz and /query at 503 until a
    later /reload succeeds."""
    root, cpath, store, head, _, tidx = indexed
    live = root / "serve" / "live.npz"
    live.write_bytes(tidx.read_bytes())
    seq = _seq(store, "400")
    with tserve.serving(_daemon_args(cpath, live, head, "--batch-window-ms", "5")) as daemon:
        url, engine = daemon.url, daemon.engine
        with np.load(tidx) as d:
            payload = {k: d[k] for k in d.files}
        meta = json.loads(str(payload["meta"]))
        np.savez(live, **{**payload, "meta": np.asarray(json.dumps({**meta, "zdim": 3}))})
        assert "zdim=3" in _post(f"{url}/reload", {}, expect=400)["error"]
        assert daemon.engine is engine and engine._sets_dev is not None
        assert _post(f"{url}/query", {"embeddings": seq.tolist(), "k": 1}) == engine.search(seq, k=1)

        live.write_bytes(tidx.read_bytes())
        build = tserve._build_engine
        monkeypatch.setattr(tserve, "_build_engine", lambda args, config: 1 / 0)
        assert "division by zero" in _post(f"{url}/reload", {}, expect=400)["error"]
        assert engine._sets_dev is None
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/healthz", timeout=TIMEOUT)
        assert e.value.code == 503 and json.loads(e.value.read())["ok"] is False
        assert "restart" in _post(f"{url}/query", {"embeddings": seq.tolist()}, expect=503)["error"]

        monkeypatch.setattr(tserve, "_build_engine", build)
        assert _post(f"{url}/reload", {})["indexed"] == 4
        assert _get(f"{url}/healthz")["ok"] and daemon.failed is None
        got = _post(f"{url}/query", {"embeddings": seq.tolist(), "k": 1})
        assert got["results"][0]["version_key"] == "400"


def test_audio_embed_fn_built_once_across_threads(indexed, monkeypatch):
    """Concurrent first audio queries build the embed function once."""
    _, cpath, _, head, jidx, _ = indexed
    eng = tserve.QueryEngine(Config.from_dict(json.loads(cpath.read_text())), str(jidx), head,
                             device="cpu")
    built = []

    def factory(config, device):
        built.append(device)
        threading.Event().wait(0.05)  # a slow build: the other threads arrive meanwhile
        return lambda path: np.full((1, EMB_DIM), len(path), np.float32)

    monkeypatch.setattr(tserve, "make_query_embed_fn", factory)
    outs = [None] * 4
    _run_threads([lambda i=i: outs.__setitem__(i, eng.embed_audio("x" * i)) for i in range(4)])
    assert len(built) == 1
    assert [float(o[0, 0]) for o in outs] == [0.0, 1.0, 2.0, 3.0]


# --- an audio query at whisper-tiny -------------------------------------------------


def test_audio_query_matches_jax(tmp_path, capsys, monkeypatch):
    """Raw WAVs (22.05 kHz, so the resampler runs) -> whisper-tiny x_concat
    -> head -> index: the port's query embedding agrees with the JAX
    package's (the same Whisper weights, carried by
    state_dict_from_jax_params) at row cosine >= 0.999 in bf16, and both
    engines return the same top-k."""
    import wealy_tpu_torch.cli.extract_batched as EB
    from wealy_tpu.cli.extract import load_whisper_model as jload
    from wealy_tpu.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params
    from _torch_parity import min_row_cosine

    rows = {"train": [(1, 100, False, "o", "A"), (1, 101, True, "c", "A")],
            "val": [(3, 300, False, "o", "C"), (3, 301, True, "c", "C")],
            "test": [(4, 400, False, "o", "D"), (4, 401, True, "c", "D"),
                     (5, 500, False, "o", "E"), (5, 501, True, "c", "E")]}
    _write_csvs(tmp_path / "lc", rows)
    conf = {"path": {"lyric_covers_data": str(tmp_path / "lc"),
                     "hidden_states": str(tmp_path / "hs"), "cache": str(tmp_path / "cache")},
            "data": {"dataset_name": "lyric-covers", "embedding_type": "encoder",
                     "embedding_format": "concat", "chunk_size": 2},
            "model": {"name": "whisper", "zdim": 8, "whisper_size": "tiny"}}
    cpath = tmp_path / "conf.json"
    cpath.write_text(json.dumps(conf))
    jconfig = JConfig.from_dict(conf)
    _, params, _ = jload(jconfig)  # the JAX factory's weights (PRNGKey(0))
    wpath = tmp_path / "whisper.pt"
    torch.save(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)), wpath)
    load = EB.load_whisper_model
    monkeypatch.setattr(EB, "load_whisper_model",
                        lambda size, checkpoint=None, **kw: load(size, checkpoint=str(wpath), **kw))

    jembed = jserve.make_query_embed_fn(jconfig)
    tembed = tserve.make_query_embed_fn(Config.from_dict(conf), device="cpu")
    store = EmbeddingStore(tmp_path / "hs", "lyric-covers")
    wavs = {}
    for vid, freq in zip(("400", "401", "500", "501"), (220.0, 233.0, 440.0, 466.0)):
        wavs[vid] = tmp_path / "audio" / f"{vid}.wav"
        _write_wav(wavs[vid], seconds=31.0, sr=22050, freq=freq)
        want = jembed(str(wavs[vid]))
        got = tembed(str(wavs[vid]))
        assert got.shape == want.shape == (2, 384) and got.dtype == np.float32
        assert min_row_cosine(got, want) >= 0.999, vid
        store.save(vid, "x_concat.npz", embeddings=want)
    idx = tmp_path / "serve" / "test.npz"
    assert jax_main(["index", "--config", str(cpath), "--split", "test", "--out", str(idx)]) == 0
    capsys.readouterr()
    from wealy_tpu.models.registry import build_model

    model, _ = build_model("whisper", zdim=8)
    hparams, _ = jserve._load_head_params(jconfig, model, None, 2, 384)
    head = tmp_path / "head.pt"
    torch.save(head_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, hparams)), head)
    jeng = jserve.QueryEngine(jconfig, str(idx), None)
    teng = tserve.QueryEngine(Config.from_dict(conf), str(idx), str(head), device="cpu")
    teng._audio_fn = tembed
    for vid in ("401", "500"):
        got = teng.search(teng.embed_audio(str(wavs[vid])), k=4)
        want = jeng.search(jembed(str(wavs[vid])), k=4)
        assert [r["version_key"] for r in got["results"]] == \
            [r["version_key"] for r in want["results"]]
        assert got["results"][0]["version_key"] == vid


def test_audio_embed_f32_matches_jax(tmp_path):
    """The x_concat embed of the query path in f32: the port's factory
    against the JAX Whisper encoder in f32 with the same weights on the
    same decoded, resampled chunk, rtol/atol 1e-4 (the decode and resample
    against the JAX package's within 2e-4)."""
    import jax.numpy as jnp

    import wealy_tpu_torch.cli.extract_batched as EB
    from wealy_tpu.audio.decode import load_audio as j_load_audio
    from wealy_tpu.audio.mel import log_mel_spectrogram as j_log_mel
    from wealy_tpu.cli.extract import load_whisper_model as jload
    from wealy_tpu.models.whisper.extract import chunk_waveform as j_chunk
    from wealy_tpu.models.whisper.model import Whisper as JWhisper
    from wealy_tpu_torch.audio.decode import load_audio
    from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params
    from wealy_tpu_torch.models.whisper.extract import chunk_waveform

    conf = {"data": {"embedding_type": "encoder", "embedding_format": "concat"},
            "model": {"name": "whisper", "zdim": 8, "whisper_size": "tiny"}}
    jconfig = JConfig.from_dict(conf)
    _, params, cfg = jload(jconfig)
    wpath = tmp_path / "whisper.pt"
    torch.save(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)), wpath)
    wav = tmp_path / "q.wav"
    _write_wav(wav, seconds=12.0, sr=22050, freq=330.0)
    chunks = chunk_waveform(load_audio(wav))
    # the JAX package resamples with its native resampler when built: 2e-4
    np.testing.assert_allclose(chunks, j_chunk(np.asarray(j_load_audio(str(wav)))), atol=2e-4)
    jmodel = JWhisper(cfg, dtype=jnp.float32, scan_layers=True)
    want = np.asarray(jnp.mean(jmodel.apply({"params": params}, j_log_mel(chunks, cfg.n_mels),
                                            method=JWhisper.encode), axis=1))
    embed = EB.make_encoder_embed_fn(Config.from_dict(conf), hf_checkpoint=str(wpath),
                                     device="cpu", dtype=torch.float32)
    got = embed(chunks).numpy()
    assert got.shape == want.shape == (1, cfg.n_audio_state)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
