"""``doctor`` of the port (wealy_tpu_torch/cli/doctor.py), mirroring
tests/test_doctor_cli.py: one JSON report of the environment, the backend
(the card, or the host with ``--device cpu``) and a project, held against
the JAX ``doctor``'s report on the same project; its probes run in child
processes, so a probe that raises or hangs is reported, never inherited."""

import csv
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from wealy_tpu.cli.main import main as jax_main
from wealy_tpu_torch.cli import doctor
from wealy_tpu_torch.cli.main import main

REPO = Path(__file__).resolve().parents[1]


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_doctor_no_config(capsys):
    assert main(["doctor", "--backend-timeout", "60", "--device", "cpu"]) == 0
    rep = _report(capsys)
    assert rep["ok"] and rep["backend"]["ok"]
    assert rep["backend"]["default_device"] == "cpu" and rep["backend"]["dispatch"] == 8.0
    assert rep["native"]["host_lib"] in (True, False)
    assert rep["python"] == sys.version.split()[0] and rep["torch"] == torch.__version__


def test_doctor_reports_no_card_as_not_ok(capsys):
    """Without ``--device cpu`` the backend is the card: on a machine
    without one it is not ok (exit 1), never the CPU in its place."""
    rc = main(["doctor", "--backend-timeout", "60"])
    rep = _report(capsys)
    if torch.cuda.is_available():
        assert rc == 0 and rep["backend"]["default_device"].startswith("cuda:")
        return
    assert rc == 1 and not rep["ok"] and not rep["backend"]["ok"]
    assert "no CUDA device" in rep["backend"]["error"] and "devices" not in rep["backend"]


def _project(tmp_path, rows):
    lc = tmp_path / "lc"
    lc.mkdir()
    for split, data in rows.items():
        with open(lc / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            w.writerows(data)
    from wealy_tpu_torch.data.embedding_store import EmbeddingStore

    store = EmbeddingStore(tmp_path / "hs", "lyric-covers")
    for vid in ("100", "101"):
        store.save(vid, "hs_last_seq.npz", embeddings=np.zeros((4, 8), np.float32))
    return store


def _conf(tmp_path, **path) -> str:
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({
        "path": {"lyric_covers_data": str(tmp_path / "lc"), "hidden_states": str(tmp_path / "hs"),
                 "cache": str(tmp_path / "cache"), "data": str(tmp_path / "nonexistent_audio"),
                 **path},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat"},
        "model": {"name": "whisper", "zdim": 8},
    }))
    return str(conf)


ROWS = {"train": [(1, 100, False, "o", "A"), (1, 101, True, "c", "A")], "val": [], "test": []}


def test_doctor_with_project(tmp_path, capsys):
    _project(tmp_path, ROWS)
    conf = _conf(tmp_path)
    assert main(["doctor", "--config", conf, "--backend-timeout", "60", "--device", "cpu"]) == 0
    proj = _report(capsys)["project"]
    assert proj["paths"]["lyric_covers_data"] == "ok"
    assert proj["paths"]["data"] == "missing"
    assert proj["paths"]["checkpoints"] == "unset"
    assert proj["splits"]["train"] == 2
    assert proj["pack"] == {"kind": "hs_last_seq", "available": False, "versions": 0}
    assert "checkpoint_step" not in proj
    assert jax_main(["doctor", "--config", conf, "--backend-timeout", "60"]) == 0
    want = _report(capsys)["project"]
    assert {k: proj[k] for k in ("paths", "splits", "pack")} == \
        {k: want[k] for k in ("paths", "splits", "pack")}


def test_doctor_reads_the_pack_and_the_checkpoint(tmp_path, capsys):
    from wealy_tpu_torch.data.packed_store import pack_from_store
    from wealy_tpu_torch.train.checkpoint import CheckpointManager

    store = _project(tmp_path, ROWS)
    pack_from_store(store, ["100", "101"], "hs_last_seq.npz", tmp_path / "hs",
                    dataset_name="lyric-covers")
    CheckpointManager(tmp_path / "ckpt").save(7, {"step": 7})
    conf = _conf(tmp_path, checkpoints=str(tmp_path / "ckpt"))
    assert main(["doctor", "--config", conf, "--device", "cpu"]) == 0
    proj = _report(capsys)["project"]
    assert proj["pack"] == {"kind": "hs_last_seq", "available": True, "versions": 2}
    assert proj["checkpoint_step"] == 7 and proj["paths"]["checkpoints"] == "ok"
    assert jax_main(["doctor", "--config", conf]) == 0
    assert _report(capsys)["project"]["pack"] == proj["pack"]  # the JAX reader of the pack


def test_a_probe_that_raises_or_hangs_is_reported(monkeypatch, capsys):
    monkeypatch.setitem(doctor.PROBES, "backend", "import time\ntime.sleep(60)\n")
    monkeypatch.setitem(doctor.PROBES, "native", "raise RuntimeError('native probe broke')\n")
    t0 = time.monotonic()
    assert main(["doctor", "--backend-timeout", "2", "--device", "cpu"]) == 1
    assert time.monotonic() - t0 < 30
    rep = _report(capsys)
    assert not rep["ok"] and "killed" in rep["backend"]["error"]
    assert rep["native"]["exit_code"] == 1 and "native probe broke" in rep["native"]["error"]


def test_python_dash_m_cli_runs_doctor():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-m", "wealy_tpu_torch.cli", "doctor", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["backend"]["ok"]
