"""A configuration, a cell and a metric dropped into a copy of the
benchmark are found by name, and no file that was there changes."""

import json
import shutil
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    conf = json.loads((tmp_path / "portbench/configs/wealy-medium.json").read_text())
    conf["source"] = "https://huggingface.co/openai/whisper-small"
    (tmp_path / "portbench/configs/wealy-small.json").write_text(json.dumps(conf))
    cell = json.loads((tmp_path / "portbench/workloads/medium-x-extract.json").read_text())
    (tmp_path / "portbench/workloads/small-x-extract.json").write_text(json.dumps(cell))
    (tmp_path / "portbench/metrics/answer.extract.py").write_text(
        "def read(record):\n    return 42.0\n")
    bench["configs"].append({"name": "wealy-small", "source": conf["source"],
                             "file": "portbench/configs/wealy-small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "small-x-extract", "config": "wealy-small",
                               "traffic": "audio_split_x", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("small-x-extract")
    bench["per_layer"].append({"name": "answer.extract", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "extract_chunks_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b, found_cell, found_conf = harness.load_spec("small-x-extract", root=tmp_path)
    assert found_conf["source"] == conf["source"] and found_cell["driver"] == "extract"
    assert "answer.extract" in {m["name"] for m in harness.per_layer_entries(b, "small-x-extract")}
    assert harness.metric_reader("answer.extract", root=tmp_path)({}) == 42.0
    assert all(p.read_bytes() == data for p, data in before.items())
