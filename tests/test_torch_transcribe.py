"""The port's ``transcribe`` command (wealy_tpu_torch.cli.transcribe and
cli.main) against the JAX CLI on the CPU: one lyric-covers project with
audio (a 0.5 s and a 35 s song: three 30 s chunks), the dev Whisper in f32
with one JAX init in both packages (each CLI's model loader replaced by
the same weights, as tests/test_transcribe_cli.py replaces the JAX one),
its decoder made confident (the final LayerNorm's scale x128) so that the
long-form ladder accepts its t = 0 rung and carries the context: the
sampled rungs cannot reproduce ``jax.random``'s draws.

Held exactly: every ``.txt`` file, the JSON summary (less the cache file's
path) and the census's texts, for the long-form default (with a toy
tokenizer whose every id below the specials is a word), ``--greedy``,
``--greedy --batched`` and ``--greedy --beam-size 3``; the exit-2
refusals and their messages; the resume. A wrapper's ``ValueError`` inside
a song propagates; an ``OSError`` is a song's failure."""

import csv
import json
import wave

import numpy as np
import pytest
import torch

import wealy_tpu.cli.extract as JEX
import wealy_tpu_torch.cli.transcribe as TT
from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.models.whisper import WHISPER_CONFIGS as J_CONFIGS
from wealy_tpu_torch.cli.main import main as port_main
from wealy_tpu_torch.models.whisper import WHISPER_CONFIGS
from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params

from _torch_parity import jax_and_port_whisper, write_toy_vocab

SR = 16000
SECONDS = {"100": 0.5, "101": 35}
CONFIDENT = 128.0  # the decoder's final LayerNorm scale factor


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("transcribe")
    lc = root / "lc"
    lc.mkdir()
    rows = {"train": [(1, 100, False, "o", "A"), (1, 101, True, "c", "A")], "val": [],
            "test": []}
    for split, data in rows.items():
        with open(lc / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            w.writerows(data)
    rng = np.random.default_rng(0)
    for key, seconds in SECONDS.items():
        t = np.arange(int(seconds * SR)) / SR
        x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.normal(size=len(t))
        path = root / "data" / "LyricCovers" / "audio" / key / f"{key}_audio.mp3"
        path.parent.mkdir(parents=True)
        with wave.open(str(path), "wb") as f:  # WAV bytes under the layout's name
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    write_toy_vocab(root / "vocab", words=50257)
    return root


@pytest.fixture(scope="module")
def models():
    jmodel, params, port = jax_and_port_whisper(J_CONFIGS["dev"], "float32", seed=0)
    params["decoder"]["ln"]["scale"] = params["decoder"]["ln"]["scale"] * CONFIDENT
    port.load_state_dict(state_dict_from_jax_params(params))
    return jmodel, params, port


@pytest.fixture
def loaders(models, monkeypatch):
    """Both CLIs' model loaders answer with the same f32 weights."""
    jmodel, params, port = models
    monkeypatch.setattr(JEX, "load_whisper_model",
                        lambda config, hf_checkpoint=None: (jmodel, params, J_CONFIGS["dev"]))
    monkeypatch.setattr(TT, "load_whisper_model",
                        lambda size, checkpoint=None, device=None, **kw: (
                            port.to(device), WHISPER_CONFIGS[size]))


def _conf(project, name):
    path = project / f"{name}.json"
    path.write_text(json.dumps({
        "path": {"lyric_covers_data": str(project / "lc"), "cache": str(project / name),
                 "data": str(project / "data"), "hidden_states": str(project / "hs")},
        "data": {"dataset_name": "lyric-covers", "whisper_set": "test_set"},
        "model": {"whisper_size": "dev"},
    }))
    return str(path)


def _tree(project, name):
    tree = project / name / "transcriptions" / "test_set" / "train"
    return {p.name: p.read_text() for p in sorted(tree.glob("*.txt"))}


def _run(project, name, flags, capsys, main, extra=()):
    argv = ["transcribe", "--config", _conf(project, name), "--split", "train", "--max-len",
            "8", *flags, *extra]
    rc = main(argv)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, summary


MODES = {
    "longform": ["--tokenizer-dir", "VOCAB"],
    "greedy": ["--greedy"],
    "greedy-batched": ["--greedy", "--batched", "--batch-size", "2", "--n-workers", "1"],
    "greedy-beam": ["--greedy", "--beam-size", "3"],
}


@pytest.mark.parametrize("mode", MODES)
def test_txt_trees_equal_the_jax_cli(project, loaders, capsys, mode):
    flags = [str(project / "vocab") if f == "VOCAB" else f for f in MODES[mode]]
    rc, got = _run(project, f"p_{mode}", flags, capsys, port_main, ("--device", "cpu"))
    jrc, want = _run(project, f"j_{mode}", flags, capsys, jax_main)
    assert rc == jrc == 0
    texts = _tree(project, f"p_{mode}")
    assert texts == _tree(project, f"j_{mode}")
    assert sorted(texts) == ["100.txt", "101.txt"]
    assert all(t.endswith("\n") for t in texts.values())
    if mode == "longform":  # words from the toy vocabulary
        assert all(t.strip() and not t.strip().split()[0].isdigit() for t in texts.values())
    else:  # token-id lines: 4 ids a chunk (max_len 8 less the 4-token prompt)
        assert [len(t.split()) for t in texts.values()] == [4, 8]
    got_cache, want_cache = got.pop("cache_file"), want.pop("cache_file")
    if mode == "greedy-batched":
        assert set(got["throughput"]) == set(want["throughput"])
        assert got["throughput"]["total_items"] == want["throughput"]["total_items"] == 3
        got.pop("throughput"), want.pop("throughput")
    assert got == want and got["done"] == 2 and got["failed"] == 0
    census = json.loads(open(got_cache).read())
    assert census["texts"] == json.loads(open(want_cache).read())["texts"]
    if mode == "longform":  # a second run skips every song
        rc, again = _run(project, f"p_{mode}", flags, capsys, port_main, ("--device", "cpu"))
        assert rc == 0 and again["skipped"] == 2 and again["done"] == 0


@pytest.mark.parametrize("flags", [
    ["--batched"],
    ["--initial-prompt", "la la", "--greedy"],
    ["--initial-prompt", "la la", "--batched", "--greedy"],
    ["--initial-prompt", "la la"],
])
def test_refusals_exit_2_as_the_jax_cli(project, capsys, flags):
    argv = ["transcribe", "--config", _conf(project, "refuse"), *flags]
    assert jax_main(argv) == 2
    want = capsys.readouterr().err
    assert port_main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == want and "[transcribe]" in want


def test_a_wrapper_fault_raises_and_a_file_fault_is_recorded(project, loaders, capsys,
                                                             monkeypatch):
    """A ValueError inside a song (a kernel wrapper's refused launch)
    propagates out of the command; an OSError is that song's failure, the
    split goes on, and the command exits 1."""
    def refused(*a, **kw):
        raise ValueError("16-byte aligned")

    monkeypatch.setattr(TT, "log_mel_spectrogram_fused", refused)
    argv = ["transcribe", "--config", _conf(project, "faults"), "--split", "train",
            "--greedy", "--max-len", "8", "--device", "cpu"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_main(argv)

    def unreadable(*a, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(TT, "chunk_waveform", unreadable)
    assert port_main(argv) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["failed"] == 2 and out["done"] == 0


def test_the_transcribe_fn_batches_a_partial_batch_unpadded(project, loaders):
    """make_transcribe_fn decodes what it is given: a batch of 3 chunks is
    3 rows (the port does not pad to batch_size), each row the row of a
    one-chunk batch."""
    from wealy_tpu_torch.train.config import Config

    config = Config.from_file(_conf(project, "fn"))
    fn = TT.make_transcribe_fn(config, max_len=8, device="cpu")
    audio = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 480000)).astype(
        np.float32) * 0.1)
    tokens, lengths = fn(audio)
    assert tokens.shape == (3, 8) and fn.prompt_len == 4
    one, one_len = fn(audio[1:2])
    assert torch.equal(one[0], tokens[1]) and int(one_len[0]) == int(lengths[1])
