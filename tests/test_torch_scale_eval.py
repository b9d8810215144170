"""Corpus-scale memory discipline of the port on the CPU, the counterpart of
tests/test_scale_eval.py: the port's fusion ``evaluate --streaming``, the
train-time val hooks (whisper and whisper-clews) and the auto-selected
streaming ``evaluate`` run a pack-backed corpus of
``WEALY_SCALE_CLIQUES`` cliques x 2 versions (default 15000: 30K versions)
with bounded peak RSS, each ``python -m wealy_tpu_torch.cli.main ...
--device cpu`` in its own subprocess, its peak read from ``VmHWM`` at exit.

The corpus is the JAX test's: one mmap pack per embedding kind, written
through the port's ``PackedStore`` (no pandas), a stored whisper sequence of
(12, 256) that the collate zero-pads to chunk_size 250, and clique-clustered
rows (same-label versions share a base vector, 0.1 noise), so a seeded
random model still ranks covers beside their originals. A monolithic path
would collate the split's whole whisper input, (30000, 250, 256) f32 =
7.7 GB, in one host array; the streamed paths hold one group at a time.

The four corpus-scale cases are marked ``slow``, as the JAX class is: each
builds a 30K-version corpus and runs minutes. One auto-streaming case runs
in tier 1 at 1,100 cliques (2,200 versions, just above
``AUTO_STREAM_THRESHOLD``): its RSS above that of a subprocess that only
imports the port stays under half of the monolithic input (2,200, 250, 256)
f32, and its metrics equal ``wealy_tpu.cli.main``'s on the same corpus and
weights within 1e-6."""

import csv
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.models.registry import build_model as jbuild_model
from wealy_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from wealy_tpu_torch.cli.main import AUTO_STREAM_THRESHOLD
from wealy_tpu_torch.data.packed_store import PackedStore
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params

REPO = Path(__file__).resolve().parents[1]
N_CLIQUES = int(os.environ.get("WEALY_SCALE_CLIQUES", "15000"))  # x2 = 30K
TIER1_CLIQUES = 1100  # 2,200 versions
CHUNK = 250
C_WHISPER = 256
CLEWS_SEQ, CLEWS_DIM = 4, 8
RSS_BOUND_MB = 3000  # the monolithic whisper input alone would be ~7700 MB
TOL = 1e-6


def build_corpus(root: Path, n_cliques: int, seed: int = 0):
    """CSVs (stdlib csv) and packs of ``n_cliques`` test/val cliques of two
    versions plus 16 distinct train cliques; (root, config path)."""
    lc = root / "lc"
    lc.mkdir(parents=True)
    rng = np.random.default_rng(seed)

    def split_rows(cliques):
        return [(int(c), int(c) * 10 + k, bool(k), "oc"[k], f"L{c}")
                for c in cliques for k in (0, 1)]

    big = split_rows(np.arange(1, n_cliques + 1))
    # a small train split of distinct cliques (the overlap filter drops
    # cliques shared across splits), so that `train` has batches
    small = split_rows(np.arange(n_cliques + 1, n_cliques + 17))
    for name, rows in (("test", big), ("val", big), ("train", small)):
        with open(lc / f"{name}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            w.writerows(rows)
    labels = {str(vid): label for _, vid, _, _, label in big + small}

    def rows(shape):
        """Clique-clustered rows: a version is its clique's base vector
        (seeded by the label) plus 0.1 noise."""
        for v, label in labels.items():
            base = np.random.default_rng(zlib.crc32(label.encode())).normal(size=shape[-1])
            yield v, (base + 0.1 * rng.normal(size=shape)).astype(np.float16)

    hs = root / "hs"
    ds = "lyric-covers"
    PackedStore.pack(hs, "hs_last_seq", rows((12, C_WHISPER)), dataset_name=ds)
    PackedStore.pack(hs, "hs_clews", rows((CLEWS_SEQ, CLEWS_DIM)), dataset_name=ds)
    PackedStore.pack(hs, "hs_clews_avg", rows((CLEWS_DIM,)), dataset_name=ds)
    PackedStore.pack(hs, "hs_clews_mask", ((v, np.zeros(CLEWS_SEQ, np.float16)) for v in labels),
                     dataset_name=ds)  # all valid
    conf = {
        "path": {"lyric_covers_data": str(lc), "hidden_states": str(hs),
                 "cache": str(root / "cache")},
        "data": {"dataset_name": ds, "embedding_type": "last_hidden_states",
                 "embedding_format": "concat", "chunk_size": CHUNK},
        "model": {"name": "whisper-clews", "zdim": 16},
        "train": {"loss": "clews", "batch_size": 8, "lr": 1e-3, "warmup_steps": 1,
                  "log_every": 0, "eval_every": 1},
    }
    cpath = root / "conf.json"
    cpath.write_text(json.dumps(conf))
    return root, cpath


PROBE = (
    "import json, re, sys\n"
    "{body}\n"
    "with open('/proc/self/status') as f:\n"
    "    rss = int(re.search(r'VmHWM:\\s+(\\d+) kB', f.read()).group(1)) / 1024.0\n"
    "print(json.dumps({{'rc': rc, 'maxrss_mb': rss}}))\n"
)


def _subprocess(body: str, timeout: float) -> tuple:
    """Run ``body`` in a fresh interpreter; (its JSON lines before the
    probe's, its peak RSS in MB). ``VmHWM`` belongs to the process's own
    address space, which exec replaces; ``ru_maxrss`` would report a parent's
    peak inherited through fork."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], capture_output=True,
                         text=True, timeout=timeout, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert lines[-1]["rc"] == 0, out.stderr[-3000:]
    return lines[:-1], lines[-1]["maxrss_mb"]


def run_bounded(cli_args, timeout: float = 1500) -> tuple:
    """``python -m wealy_tpu_torch.cli.main <cli_args> --device cpu`` in a
    fresh subprocess: (its last JSON line, peak RSS in MB)."""
    body = ("from wealy_tpu_torch.cli.main import main\n"
            f"rc = main({[*cli_args, '--device', 'cpu']!r})")
    lines, rss = _subprocess(body, timeout)
    print(f"[scale] {' '.join(cli_args[:1] + cli_args[3:])}: peak RSS {rss:.1f} MB")
    return (lines[-1] if lines else {}), rss


def baseline_rss() -> float:
    """Peak RSS of a subprocess that only imports the port's command line."""
    return _subprocess("import wealy_tpu_torch.cli.main\nrc = 0", 300)[1]


def _val_records(path: Path) -> list:
    return [r for r in map(json.loads, path.read_text().splitlines()) if "val_MAP" in r]


def _weights(root: Path):
    """One whisper-clews init at the corpus's widths: an orbax checkpoint
    for the JAX command line, its torch state dict for the port's."""
    model, _ = jbuild_model("whisper-clews", zdim=16)
    params = model.init(jax.random.PRNGKey(5), jnp.zeros((1, CHUNK, C_WHISPER)),
                        jnp.zeros((1, CHUNK), bool), jnp.zeros((1, CLEWS_SEQ, CLEWS_DIM)),
                        jnp.zeros((1, CLEWS_SEQ), bool))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    JCheckpointManager(root / "orbax").save(0, {"params": params})
    torch.save(head_state_dict_from_jax_params(params), root / "whisper_clews.pt")
    return str(root / "orbax"), str(root / "whisper_clews.pt")


def test_auto_streaming_evaluate_is_bounded_and_equals_jax(tmp_path, capsys):
    """``evaluate`` with no --streaming flag over 2,200 versions selects the
    streaming path by itself: RSS above the import-only baseline under half
    the monolithic whisper input, and JAX's metrics on the same corpus."""
    n = 2 * TIER1_CLIQUES
    assert n > AUTO_STREAM_THRESHOLD
    _, cpath = build_corpus(tmp_path, TIER1_CLIQUES)
    orbax_dir, torch_file = _weights(tmp_path)
    base = ["evaluate", "--config", str(cpath), "--split", "test", "--song-group", "64"]
    got, rss = run_bounded(base + ["--checkpoint", torch_file])
    above = rss - baseline_rss()
    monolithic_mb = n * CHUNK * C_WHISPER * 4 / 2**20  # 536.9 MiB
    assert got["n_queries"] == n and got["MAP"] > 0.5, got
    assert above < monolithic_mb / 2, (rss, above, monolithic_mb)
    assert jax_main(base + ["--checkpoint", orbax_dir]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("MAP", "MR1", "P@10"):
        assert abs(got[k] - want[k]) <= TOL, (k, got, want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(tmp_path_factory.mktemp("scale30k"), N_CLIQUES)


@pytest.mark.slow
class TestScale30K:
    def test_fusion_evaluate_streaming_bounded(self, corpus):
        _, cpath = corpus
        metrics, rss = run_bounded(["evaluate", "--config", str(cpath), "--split", "test",
                                    "--streaming", "--song-group", "64"])
        assert metrics["n_queries"] == 2 * N_CLIQUES
        assert metrics["MAP"] > 0.5  # covers rank beside their originals
        assert rss < RSS_BOUND_MB, f"fusion evaluate peaked at {rss:.0f} MB"

    def test_train_val_hook_bounded(self, corpus):
        root, cpath = corpus
        conf = json.loads(cpath.read_text())
        conf["train"]["metrics_jsonl"] = str(root / "m.jsonl")
        conf["model"] = {"name": "whisper", "zdim": 16}  # the single-modal hook
        cpath2 = root / "conf_train.json"
        cpath2.write_text(json.dumps(conf))
        _, rss = run_bounded(["train", "--config", str(cpath2), "--max-steps", "1", "--fresh"])
        val = _val_records(root / "m.jsonl")
        assert val and val[0]["val_MAP"] > 0.5
        assert rss < RSS_BOUND_MB, f"train val hook peaked at {rss:.0f} MB"

    def test_auto_streaming_default_bounded(self, tmp_path_factory):
        root = tmp_path_factory.mktemp("scale5k")
        _, cpath = build_corpus(root, 2500)  # 5K versions
        metrics, rss = run_bounded(["evaluate", "--config", str(cpath), "--split", "test",
                                    "--song-group", "64"])  # no --streaming flag
        assert metrics["n_queries"] == 5000
        assert metrics["MAP"] > 0.5
        assert rss < RSS_BOUND_MB, f"auto-streaming evaluate peaked at {rss:.0f} MB"

    def test_train_val_hook_multimodal_bounded(self, corpus):
        root, cpath = corpus
        conf = json.loads(cpath.read_text())
        conf["train"]["metrics_jsonl"] = str(root / "m_mm.jsonl")
        conf["train"]["val_group"] = 256
        cpath2 = root / "conf_train_mm.json"
        cpath2.write_text(json.dumps(conf))
        _, rss = run_bounded(["train", "--config", str(cpath2), "--max-steps", "1", "--fresh"])
        val = _val_records(root / "m_mm.jsonl")
        assert val and val[0]["val_MAP"] > 0.5
        assert rss < RSS_BOUND_MB, f"fusion train val hook peaked at {rss:.0f} MB"
