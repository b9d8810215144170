"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the card check, row cosine, and one seeded weight set carried from the JAX
model into the port through ``state_dict_from_jax_params``."""

from __future__ import annotations

import numpy as np
import pytest
import torch


def cuda_device() -> torch.device:
    """The card, or skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    return torch.device("cuda")


def min_row_cosine(a, b) -> float:
    """Smallest cosine similarity between matching rows (last axis)."""
    a = np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, np.float64).reshape(-1, np.shape(b)[-1])
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return float(np.min(num / np.maximum(den, 1e-30)))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def jax_and_port_whisper(cfg, dtype: str, seed: int = 0, scan_layers: bool = False):
    """(jax_model, jax_params, port_model) with identical weights: the JAX
    model's seeded init, converted by state_dict_from_jax_params.
    ``dtype`` is "float32" or "bfloat16" for both sides."""
    import jax
    import jax.numpy as jnp

    from wealy_tpu.models.whisper.model import Whisper as JWhisper
    from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params
    from wealy_tpu_torch.models.whisper.model import Whisper

    jmodel = JWhisper(cfg, dtype=getattr(jnp, dtype), scan_layers=scan_layers)
    mel0 = jnp.zeros((1, cfg.n_mels, 2 * cfg.n_audio_ctx), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), mel0, jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = Whisper(cfg, dtype=getattr(torch, dtype))
    port.load_state_dict(state_dict_from_jax_params(params))
    return jmodel, params, port.eval()


# the toy vocabulary's merges: a few English pairs over the 256 byte tokens
TOY_MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("ll", "o"), ("Ġ", "a"),
              ("i", "n"), ("Ġ", "s"), ("e", "r"), ("o", "u")]


def write_toy_vocab(path, special: dict = None, words: int = 0):
    """A byte-level BPE vocabulary in ``path`` (vocab.json, merges.txt,
    special_tokens.json): the 256 byte tokens (id = byte value), then one
    token per merge of :data:`TOY_MERGES`, then (up to id ``words``) one
    word "Ġw<id>" per id, and ``special`` ({token: id})."""
    import json
    from pathlib import Path

    from wealy_tpu_torch.data.tokenizer import _bytes_to_unicode

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    for a, b in TOY_MERGES:
        vocab[a + b] = len(vocab)
    for i in range(len(vocab), words):
        vocab[f"Ġw{i}"] = i
    special = dict(special or {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258})
    vocab.update(special)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in TOY_MERGES) + "\n")
    (path / "special_tokens.json").write_text(json.dumps(special))
    return path


def write_audio_project(root, songs: dict = None, sr: int = 16000):
    """A lyric-covers project under ``root`` (the layout of
    tests/test_torch_extract_split.py: stdlib CSVs, 16 kHz 16-bit WAV bytes
    under the layout's .mp3 names): ``songs`` {version id: seconds} in one
    train clique (default a 20 s and a 35 s song), one clique of two
    versions without audio in val and test. Returns ``conf(name)``, which
    writes a dev-size Whisper config whose store is ``root / name`` and
    returns its path."""
    import csv
    import json
    import wave

    songs = songs or {"100": 20, "101": 35}
    (root / "lc").mkdir(parents=True, exist_ok=True)
    keys = list(songs)
    rows = {"train": [(int(keys[0]), int(k), i > 0, "c" if i else "o", "A")
                      for i, k in enumerate(keys)],
            "val": [(300, 300, False, "o", "C"), (300, 301, True, "c", "C")],
            "test": [(400, 400, False, "o", "D"), (400, 401, True, "c", "D")]}
    for split, data in rows.items():
        with open(root / "lc" / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            w.writerows(data)
    rng = np.random.default_rng(0)
    for key, seconds in songs.items():
        path = root / "data" / "LyricCovers" / "audio" / key / f"{key}_audio.mp3"
        path.parent.mkdir(parents=True, exist_ok=True)
        x = 0.1 * rng.normal(size=int(seconds * sr))
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())

    def conf(name):
        path = root / f"{name}.json"
        path.write_text(json.dumps({
            "path": {"lyric_covers_data": str(root / "lc"), "hidden_states": str(root / name),
                     "cache": str(root / f"cache_{name}"), "data": str(root / "data")},
            "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                     "embedding_format": "concat"},
            "model": {"name": "whisper", "zdim": 16, "whisper_size": "dev"},
        }))
        return str(path)

    return conf


def write_embedding_project(root, train: dict = None) -> str:
    """A head-training project under ``root``: eight versions in four
    cliques per split, each a (40, 24) fp16 ``hs_last_seq``, chunks of 16
    frames, a ``whisper`` head of zdim 8 and checkpoints in ``root /
    ckpt``; ``train`` updates the config's ``train`` keys. Returns the
    config's path."""
    import csv
    import json

    from wealy_tpu_torch.data.embedding_store import EmbeddingStore

    (root / "lc").mkdir()
    store = EmbeddingStore(root / "hs", "lyric-covers")
    rng = np.random.default_rng(0)
    vid = 100
    for split in ("train", "val", "test"):
        with open(root / "lc" / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            for c in range(4):
                first = vid
                for k in range(2):
                    w.writerow([first, vid, k > 0, "o", f"{split}{c}"])
                    store.save(str(vid), "hs_last_seq.npz",
                               embeddings=rng.normal(size=(40, 24)).astype(np.float16))
                    vid += 1
    cpath = root / "conf.json"
    cpath.write_text(json.dumps({
        "path": {"lyric_covers_data": str(root / "lc"), "hidden_states": str(root / "hs"),
                 "cache": str(root / "cache"), "checkpoints": str(root / "ckpt")},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat", "chunk_size": 16, "overlap_percentage": 0.5},
        "model": {"name": "whisper", "zdim": 8},
        "train": {"loss": "clews", "batch_size": 4, "lr": 1e-3, "warmup_steps": 1,
                  "max_steps": 2, "log_every": 0, "eval_every": 1000,
                  "checkpoint_every": 1000, **(train or {})},
    }))
    return str(cpath)


def free_ports(n: int = 1) -> list:
    """``n`` distinct free TCP ports on the loopback interface."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def rank_env() -> dict:
    """The environment of a spawned rank: the repo on the path, no
    inherited torchrun variables, one OpenMP thread."""
    import os
    from pathlib import Path

    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def spawn_ranks(cases: str, world: int, workdir, n_ports: int = 1, deadline_s: float = 240.0):
    """Run ``tests/<cases>.py::run`` in ``world`` gloo CPU processes
    (tests/_torch_mesh_worker.py), all under one deadline (a hung rank
    fails the test, it does not hang the suite); returns each rank's result
    dict, in rank order. ``workdir`` holds the inputs the cases read and
    their outputs; ``n_ports`` free ports are handed to the cases (the
    first carries the process group)."""
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    ports = ",".join(str(p) for p in free_ports(n_ports))
    argv = [[sys.executable, str(tests / "_torch_mesh_worker.py"), cases, str(r), str(world),
             ports, str(workdir)] for r in range(world)]
    procs = [subprocess.Popen(a, cwd=workdir, env=rank_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in argv]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=deadline_s)
            results.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{cases}: a rank did not finish within {deadline_s:.0f} s")
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{out[-2000:]}\n{err[-4000:]}"
    return [torch.load(Path(workdir) / f"{cases}_rank{r}.pt", weights_only=False)
            for r in range(world)]
