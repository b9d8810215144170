"""The port's long-form transcription (wealy_tpu_torch.models.whisper.
longform) against the JAX package's on the CPU: the tiny decode model of
tests/conftest.py::tiny_decode_model carried into the port, three chunks'
encoder states from a numpy seed through both.

At temperature 0 the two are held equal: chunk tokens identical, each
segment's temperature, context length and skip flag identical, its
compression ratio exact (it is a function of the tokens) and its
log-prob and no-speech probability within rtol/atol 1e-4. Sampled rungs
cannot reproduce ``jax.random``'s draws, so the ladder's logic (which rung
is kept, the no-speech veto and skip, the context reset) is held with
``greedy_decode`` replaced in BOTH modules by one scripted function."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wealy_tpu.data.tokenizer import ByteLevelBPE as JBPE
from wealy_tpu.models.whisper import longform as jlong
from wealy_tpu_torch.models.whisper import longform as tlong
from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.model import Whisper

from _torch_parity import write_toy_vocab

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def pair(tiny_decode_model):
    jmodel, params, cfg = tiny_decode_model
    port = Whisper(cfg, dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    states = np.random.default_rng(0).normal(
        size=(3, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32)
    return jmodel, params, cfg, port.eval(), states


def _same(got, want):
    assert got["chunk_tokens"] == want["chunk_tokens"]
    assert got["text"] == want["text"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert set(g) == set(w)
        for key in ("temperature", "context_len", "skipped", "compression_ratio"):
            assert g[key] == w[key], (key, g, w)
        for key in ("avg_logprob", "no_speech_prob"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL, err_msg=key)


def _both(pair, n_chunks=3, **kw):
    jmodel, params, cfg, port, states = pair
    want = jlong.transcribe_longform(jmodel, params, jnp.asarray(states[:n_chunks]), cfg, **kw)
    got = tlong.transcribe_longform(port, torch.from_numpy(states[:n_chunks]), cfg, **kw)
    return got, want


def test_t0_with_the_gates_and_text_equals_jax(pair, tmp_path):
    """The default gates (compression over the decoded text's bytes) with a
    single t = 0 rung: the context carries from chunk to chunk."""
    bpe = JBPE.from_dir(write_toy_vocab(tmp_path))
    got, want = _both(pair, language=0, max_len=12, temperatures=(0.0,),
                      decode_text=lambda ids: bpe.decode(list(ids)))
    _same(got, want)
    assert [s["context_len"] for s in got["segments"]][1:] != [0, 0]


def test_context_carries_and_buckets_as_jax(pair):
    got, want = _both(pair, language=0, max_len=12, temperatures=(0.0,),
                      compression_ratio_threshold=None, logprob_threshold=None,
                      no_speech_threshold=None)
    _same(got, want)
    ctx = [s["context_len"] for s in got["segments"]]
    assert ctx[0] == 0 and ctx[1] > 0 and ctx[2] >= ctx[1]
    assert all(c in tlong.CTX_BUCKETS for c in ctx)


def test_beam_rung_and_initial_prompt_equal_jax(pair):
    """beam_size=5 on the t = 0 rung and a short initial prompt (cyclic-
    padded to the smallest bucket)."""
    got, want = _both(pair, n_chunks=2, language=0, max_len=8, temperatures=(0.0,),
                      beam_size=5, initial_prompt_tokens=[300, 301, 302],
                      compression_ratio_threshold=None, logprob_threshold=None,
                      no_speech_threshold=None)
    _same(got, want)
    assert got["segments"][0]["context_len"] == 8


def test_helpers_equal_jax():
    rep = b"la la la la la la " * 20
    for data in (rep, bytes(range(256)), b""):
        assert tlong.compression_ratio(data) == jlong.compression_ratio(data)
    assert tlong.CTX_BUCKETS == jlong.CTX_BUCKETS
    for n in (0, 7, 8, 31, 64, 127, 128, 500):
        assert tlong._ctx_bucket(n) == jlong._ctx_bucket(n)
    # the token-id payload: int32 little-endian, whatever the port's int64
    ids = torch.tensor([50257, 7, 1, 2 ** 20]).tolist()
    assert np.asarray(ids, "<i4").tobytes() == np.asarray(ids, np.int32).tobytes()


# --- the ladder's logic, with one scripted decode in both modules ---------------------------------

# per chunk and rung: (the generated ids of each candidate, summed log-prob of
# each candidate, p(nospeech)); a rung absent from a chunk's script repeats
# its last entry
LOOP = [5, 6] * 12  # compresses past 2.4
SCRIPT = {
    0: {0.0: ([[11, 12, 13, 14]], [-9.0], 0.01),  # low log-prob: climb
        0.2: ([[21, 22, 23], [24, 25, 26, 27], [28]], [-3.0, -1.5, -0.5], 0.01)},
    1: {0.0: ([LOOP], [-1.0], 0.02),  # loops: climb to 0.8, then reset the context
        0.8: ([[31, 32], [33, 34, 35], [36], [37, 38], [39]], [-2.0, -1.0, -0.3, -3.0, -0.2],
              0.02)},
    2: {0.0: ([[41, 42]], [-8.0], 0.9)},  # silence: no climb, skipped
    3: {0.0: ([list(range(51, 59))], [-0.1], 0.9)},  # confident: the log-prob vetoes the skip
    4: {0.0: ([[61, 62, 63]], [-1.0], 0.1),  # confident: carries the context on
        0.2: ([[64]], [-0.5], 0.1)},
    5: {0.0: ([LOOP], [-9.0], 0.1)},  # nothing passes: the last rung is kept
}


def _script(calls, eot, to_output):
    def greedy_decode(model, *args, **kw):
        # the JAX call passes (params, states, config), the port's (states, config)
        states = next(a for a in args if len(getattr(a, "shape", ())) == 3)
        prompt, total = kw["prompt"], kw["max_len"]
        chunk = int(round(float(np.asarray(states)[0, 0, 0])))
        t = float(kw.get("temperature", 0.0))
        rungs = SCRIPT[chunk]
        ids, sums, nospeech = rungs.get(t, rungs[max(r for r in rungs if r <= t)])
        n = np.asarray(states).shape[0]
        calls.append((chunk, t, n, list(prompt)))
        tokens = np.full((n, total), eot, np.int32)
        lengths = np.zeros(n, np.int32)
        for r in range(n):
            gen = ids[r % len(ids)][: total - len(prompt)]
            tokens[r, : len(prompt)] = prompt
            tokens[r, len(prompt) : len(prompt) + len(gen)] = gen
            lengths[r] = len(prompt) + len(gen)
        sums = np.resize(np.asarray(sums, np.float32), n)
        return to_output({"tokens": tokens, "lengths": lengths, "sum_logprob": sums,
                          "nospeech_prob": np.full(n, nospeech, np.float32)})
    return greedy_decode


def test_ladder_logic_equals_jax(pair, monkeypatch):
    jmodel, params, cfg, port, states = pair
    marked = np.array(states[:1].repeat(6, 0))
    marked[:, 0, 0] = np.arange(6)  # the script reads the chunk from here
    j_calls, t_calls = [], []
    monkeypatch.setattr(jlong, "greedy_decode", _script(
        j_calls, cfg.eot, lambda d: {k: jnp.asarray(v) for k, v in d.items()}))
    monkeypatch.setattr(tlong, "greedy_decode", _script(
        t_calls, cfg.eot, lambda d: {k: torch.from_numpy(v) for k, v in d.items()}))
    kw = dict(language=0, max_len=40, best_of=5)
    want = jlong.transcribe_longform(jmodel, params, jnp.asarray(marked), cfg, **kw)
    got = tlong.transcribe_longform(port, torch.from_numpy(marked), cfg, **kw)
    assert t_calls == j_calls  # the same rungs, candidates and prompts
    _same(got, want)
    seg = got["segments"]
    assert [s["temperature"] for s in seg] == [0.2, 0.8, 0.0, 0.0, 0.0, 1.0]
    assert [s["skipped"] for s in seg] == [False, False, True, False, False, False]
    # the best of the sampled candidates by summed log-prob over its length
    assert got["chunk_tokens"][:3] == [[24, 25, 26, 27], [39], []]
    # chunk 1 sees chunk 0's 4 tokens (below the smallest bucket: none); the
    # 0.8 rescue resets; the skip carries nothing; chunk 3's 8 tokens and
    # then 11 are carried (bucket 8)
    assert [s["context_len"] for s in seg] == [0, 0, 0, 0, 8, 8]
    assert [len(c[3]) for c in t_calls if c[1] == 0.0] == [4, 4, 4, 4, 13, 13]
    assert [c[2] for c in t_calls if c[0] == 5] == [1, 5, 5, 5, 5, 5]  # best_of rows
