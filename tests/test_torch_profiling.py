"""``--profile DIR`` and the trace helpers of the port
(wealy_tpu_torch/utils/profiling.py), the counterpart of the JAX package's
``jax.profiler`` wiring (wealy_tpu/utils/profiling.py:21-31,
wealy_tpu/cli/main.py:1506-1517): a small ``extract``, ``train`` and
``evaluate`` each write a Chrome trace that holds the command's span and
exit as the command does; a trace is written on an error too; the device
busy share of a trace is the union of its kernel, copy and set intervals.

The span ring: a span costs no ``record_function`` while no profiler runs,
is kept (bounded) with its thread on the host clock, lands once in a
captured trace with the ring's duration, and a batched ``extract`` records
every span of its stages, one ``whisper.decode_step`` a step of the decode
loop."""

import json
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from wealy_tpu_torch.cli.main import main as port_main
from wealy_tpu_torch.utils import profiling as P

from _torch_parity import write_audio_project, write_embedding_project


@pytest.fixture(scope="module")
def audio_conf(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile")
    return root, write_audio_project(root)


def _names(trace_dir) -> set:
    files = P.trace_files(trace_dir)
    assert len(files) == 1, files
    return {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}


def test_profile_extract_writes_a_trace_with_its_spans(audio_conf, capsys):
    root, conf = audio_conf
    trace = root / "trace_extract"
    argv = ["extract", "--config", conf("p_extract"), "--split", "train", "--kinds", "x_concat",
            "--batched", "--batch-size", "2", "--device", "cpu"]
    assert port_main(argv + ["--profile", str(trace)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["done"] == 2 and out["incomplete"] == []
    names = _names(trace)
    assert {"wealy_tpu_torch.extract", "extract.batch"} <= names
    # every batch of the split in the trace: 20 s + 35 s = 1 + 2 chunks at B=2
    events = json.loads(P.trace_files(trace)[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "extract.batch" for e in events) == 2
    busy = P.trace_device_busy(P.trace_files(trace)[0], span="wealy_tpu_torch.extract")
    assert busy["window_ms"] > 0 and busy["busy_ms"] == 0.0  # no card here


@pytest.mark.parametrize("command", ["train", "evaluate"])
def test_profile_train_and_evaluate(tmp_path, command, capsys):
    """``train`` and ``evaluate`` take ``--profile`` as the JAX parser's do,
    on a small embedding project."""
    cpath = write_embedding_project(tmp_path)
    trace = tmp_path / f"trace_{command}"
    if command == "train":
        argv = ["train", "--config", cpath, "--max-steps", "2", "--fresh"]
    else:
        argv = ["evaluate", "--config", cpath, "--split", "test"]
    assert port_main(argv + ["--device", "cpu", "--profile", str(trace)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ("final_step" in line) if command == "train" else ("MAP" in line)
    assert f"wealy_tpu_torch.{command}" in _names(trace)


def test_the_trace_is_written_on_an_error(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with P.profiled(str(tmp_path / "t"), "failing"):
            torch.ones(4).sum()
            raise RuntimeError("boom")
    assert "failing" in _names(tmp_path / "t")
    # the capture ended: a new one starts
    with P.profiled(str(tmp_path / "t2"), "again"):
        pass
    assert "again" in _names(tmp_path / "t2")


def test_start_and_stop_trace_pair(tmp_path):
    P.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already"):
        P.start_trace(str(tmp_path))
    with P.trace_span("span_a"):
        torch.ones(3) * 2
    P.stop_trace()
    with pytest.raises(RuntimeError, match="no trace"):
        P.stop_trace()
    assert "span_a" in _names(tmp_path)


def test_trace_device_busy_is_the_union_of_device_intervals(tmp_path):
    events = [
        {"ph": "X", "name": "cmd", "cat": "user_annotation", "ts": 0, "dur": 1000},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 100, "dur": 200},
        {"ph": "X", "name": "k2", "cat": "kernel", "ts": 250, "dur": 100},  # overlaps k1
        {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 500, "dur": 50},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 950, "dur": 100},  # cut at 1000
        {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "ts": 0, "dur": 900},
    ]
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = P.trace_device_busy(path, span="cmd")
    assert got["window_ms"] == 1.0
    assert got["busy_ms"] == pytest.approx((250 + 50 + 50) / 1e3)
    assert got["busy_share"] == pytest.approx(0.35)
    assert got["by_name"]["k1"] == [pytest.approx(0.3), 2]
    with pytest.raises(ValueError, match="no span"):
        P.trace_device_busy(path, span="missing")


def _mine(t0, name=None) -> list:
    return [e for e in P.spans(since=t0) if name is None or e.name == name]


def test_a_span_without_a_profiler_calls_no_record_function():
    t0 = time.perf_counter()
    with mock.patch.object(torch.profiler, "record_function", side_effect=AssertionError):
        with P.trace_span("ring.main") as span:
            span.n = 7
        worker = threading.Thread(target=lambda: P.trace_span("ring.thread").__enter__()
                                  .__exit__(None, None, None))
        worker.start()
        worker.join()
    (main,) = _mine(t0, "ring.main")
    (other,) = _mine(t0, "ring.thread")
    assert main.thread == threading.get_ident() and main.n == 7
    assert other.thread == worker.ident != main.thread
    assert t0 <= main.t0 <= main.t1 and main.device_ms is None  # no card here


def test_the_ring_is_bounded():
    t0 = time.perf_counter()
    for i in range(P.RING_SIZE + 5):
        with P.trace_span("ring.bound") as span:
            span.n = i
    kept = _mine(t0, "ring.bound")
    assert len(P.spans()) == len(kept) == P.RING_SIZE
    assert [e.n for e in kept[:2]] == [5, 6] and kept[-1].n == P.RING_SIZE + 4


def test_spans_fall_inside_their_window():
    """A span belongs to the window its end falls in."""
    def span(n):
        with P.trace_span("ring.window") as s:
            s.n = n

    t0 = time.perf_counter()
    span(3)
    t1 = time.perf_counter()
    with P.trace_span("ring.window") as straddling:  # opened in the window, closed after it
        straddling.n = 4
        t2 = time.perf_counter()
    span(5)

    def ns(since=None, until=None):
        return [e.n for e in P.spans(since, until) if e.name == "ring.window"]

    assert ns(t0, t1) == [3]
    assert ns(t1, t2) == [] and straddling.t0 < t2 < straddling.t1
    assert ns(since=t1) == [4, 5]
    assert ns(until=t1)[-1:] == [3]
    assert ns(since=t0) == [3, 4, 5]


def test_a_profiled_span_is_in_the_trace_once_with_the_rings_duration(tmp_path):
    names = [f"ring.profiled{i}" for i in range(3)]
    t0 = time.perf_counter()
    P.start_trace(str(tmp_path))
    for i, name in enumerate(names):
        with P.trace_span(name):
            time.sleep(0.002 * (i + 1))
            torch.ones(64).sum()
    P.stop_trace()
    events = json.loads(P.trace_files(tmp_path)[0].read_text())["traceEvents"]
    for name in names:
        hits = [e for e in events if e.get("name") == name]
        assert len(hits) == 1 and hits[0]["cat"] == "user_annotation", hits
        (entry,) = _mine(t0, name)
        ring_us = 1e6 * (entry.t1 - entry.t0)
        assert abs(hits[0]["dur"] - ring_us) <= max(0.1 * ring_us, 50.0), (hits[0], ring_us)


EXPECTED = {"audio.load", "extract.next_batch", "extract.pad", "extract.h2d", "whisper.encode",
            "extract.batch", "extract.d2h", "extract.scatter", "whisper.load"}
DECODE = {"whisper.decode_step"}


@pytest.mark.parametrize("kind", ["x_concat", "hs_last_seq"])
def test_a_batched_extract_records_every_span(audio_conf, kind, capsys, monkeypatch):
    """A tiny ``extract --batched`` on the CPU: every span of its stages,
    one ``audio.load`` a song carrying its chunks, as many
    ``whisper.decode_step`` spans a ``greedy_decode`` call as the steps it
    took; the same outputs with a profiler on (the spans' ``record_function``)."""
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore
    from wealy_tpu_torch.models.whisper import extract as wextract

    root, conf = audio_conf
    real, steps = wextract.greedy_decode, []

    def recording(*args, **kwargs):
        t = time.perf_counter()
        out = real(*args, **kwargs)
        last = min(int(out["lengths"].max()), kwargs["max_len"] - 1)
        mine = [e for e in P.spans(since=t) if e.thread == threading.get_ident()]
        spans = sum(e.name == "whisper.decode_step" for e in mine)
        steps.append((last - len(kwargs["prompt"]), spans))
        return out

    monkeypatch.setattr(wextract, "greedy_decode", recording)
    rows = {}
    for run in ("plain", "profiled"):
        name = f"spans_{kind}_{run}"
        argv = ["extract", "--config", conf(name), "--split", "train", "--kinds", kind,
                "--batched", "--batch-size", "2", "--device", "cpu"]
        if run == "profiled":
            argv += ["--profile", str(root / f"trace_{name}")]
        t0 = time.perf_counter()
        assert port_main(argv) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["done"] == 2
        seen = _mine(t0)
        want = EXPECTED | (DECODE if kind.startswith("hs_") else set())
        if run == "profiled":
            want |= {"wealy_tpu_torch.extract"}  # the command's own span
        assert {e.name for e in seen} == want
        loads = [e for e in seen if e.name == "audio.load"]
        assert sorted(e.n for e in loads) == [1, 2]  # the 20 s and the 35 s song
        assert sum(e.name == "extract.next_batch" for e in seen) == 3  # two batches, the end
        assert all(e.device_ms is None for e in seen)  # no card here
        store = EmbeddingStore(str(root / name), "lyric-covers")
        rows[run] = {v: store.load(v, f"{kind}.npz")["embeddings"] for v in ("100", "101")}
    for v in rows["plain"]:
        np.testing.assert_array_equal(rows["plain"][v], rows["profiled"][v])
    if kind.startswith("hs_"):
        assert len(steps) == 4  # two batches a run
        assert all(spans == n > 0 for n, spans in steps), steps
