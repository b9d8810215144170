"""``--profile DIR`` and the trace helpers of the port
(wealy_tpu_torch/utils/profiling.py), the counterpart of the JAX package's
``jax.profiler`` wiring (wealy_tpu/utils/profiling.py:21-31,
wealy_tpu/cli/main.py:1506-1517): a small ``extract``, ``train`` and
``evaluate`` each write a Chrome trace that holds the command's span and
exit as the command does; a trace is written on an error too; the device
busy share of a trace is the union of its kernel, copy and set intervals."""

import json

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
