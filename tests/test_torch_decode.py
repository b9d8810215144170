"""The port's decoding (wealy_tpu_torch.models.whisper.generate and the
float8 KV storage of model.py) against the JAX package on the CPU: the JAX
package's tiny decode model (tests/conftest.py::tiny_decode_model: width
32, 1 encoder and 2 decoder layers, the full 51865-token vocabulary, f32),
carried into the port by ``state_dict_from_jax_params``, and encoder states
from a numpy seed through both.

Tolerances: tokens and lengths identical; hidden states, sum_logprob and
nospeech_prob rtol/atol 1e-4 (the port's f32 parity); language log-probs
rtol 1e-5; float8 against the port's own f32 route within the JAX tests'
bounds (relative error < 0.06 cross, < 0.08 self). Sampling cannot
reproduce ``jax.random``'s draws, so t > 0 is held by properties: a seed
repeats, seeds differ, suppressed ids are never drawn, and 10^4 draws at
V=8 pass a chi-square test against softmax(logits / T).

The static-shape step (every step after the prompt's prefill, its position
on the device, self-attention over the whole cache under a mask) is held
to the JAX decode at prompt lengths 1, 3 and 4, with eot ending some rows
or every row early, with suppressed tokens and with float8 caches; its
steps are ``whisper.decode_step`` spans with ``n`` 0 (eager) on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from wealy_tpu.data.tokenizer import ByteLevelBPE as JBPE
from wealy_tpu.models.whisper import generate as jgen
from wealy_tpu.models.whisper.config import WhisperConfig as JConfig
from wealy_tpu.models.whisper.model import Whisper as JWhisper
from wealy_tpu_torch.data.tokenizer import ByteLevelBPE
from wealy_tpu_torch.models.whisper import generate as tgen
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.model import Whisper
from wealy_tpu_torch.utils import profiling

from _torch_parity import write_toy_vocab

RTOL = ATOL = 1e-4
F8 = torch.float8_e4m3fn


@pytest.fixture(scope="module")
def pair(tiny_decode_model):
    """(JAX model, params, config, port model, encoder states (2, 16, 32))."""
    import jax

    jmodel, params, cfg = tiny_decode_model
    port = Whisper(cfg, dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    states = np.random.default_rng(0).normal(
        size=(2, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32)
    return jmodel, params, cfg, port.eval(), states


def _same_decode(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(want["hidden"]), rtol=rtol,
                               atol=atol)
    for key in ("sum_logprob", "nospeech_prob"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=rtol, atol=atol)


# --- suppression and language identification ------------------------------------------------

@pytest.mark.parametrize("n_vocab", [51865, 51866, 51864, 64])
def test_default_suppress_tokens_equal_jax(tmp_path, n_vocab):
    path = write_toy_vocab(tmp_path)
    cfg, jcfg = WhisperConfig(n_vocab=n_vocab), JConfig(n_vocab=n_vocab)
    assert tgen.default_suppress_tokens(cfg) == jgen.default_suppress_tokens(jcfg)
    got = tgen.default_suppress_tokens(cfg, ByteLevelBPE.from_dir(path))
    assert got == jgen.default_suppress_tokens(jcfg, JBPE.from_dir(path))
    if n_vocab > 64:
        assert cfg.eot not in got and cfg.sot in got
        assert len(got) > 6  # the toy vocabulary names the symbol bytes


def test_detect_language_equal_jax(pair):
    jmodel, params, cfg, port, states = pair
    want_idx, want_logp = jgen.detect_language(jmodel, params, jnp.asarray(states), cfg)
    got_idx, got_logp = tgen.detect_language(port, torch.from_numpy(states), cfg)
    assert got_logp.shape == (2, cfg.n_languages)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp), rtol=1e-5, atol=1e-6)


# --- greedy at t = 0, the xa_kv reuse, float8 -------------------------------------------------

def test_greedy_with_xa_kv_matches_jax(pair):
    """Precomputed cross K/V passed in: the JAX result within the f32
    gates, and bit-equal to the port's decode that makes its own."""
    jmodel, params, cfg, port, states = pair
    prompt = jgen.default_prompt(cfg, language=0)
    j_xa = jmodel.apply({"params": params}, jnp.asarray(states),
                        method=JWhisper.precompute_cross_kv)
    want = jgen.greedy_decode(jmodel, params, jnp.asarray(states), cfg, prompt=prompt,
                              max_len=16, xa_kv=j_xa)
    ts = torch.from_numpy(states)
    got = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=16,
                             xa_kv=port.precompute_cross_kv(ts))
    _same_decode(got, want)
    own = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=16)
    for key in got:
        assert torch.equal(got[key], own[key]), key


def test_greedy_float8_matches_jax(pair):
    """float8 cross K/V and self caches on both sides: the same roundings
    (an f32 model: values cast from f32), so the JAX result within the f32
    gates."""
    jmodel, params, cfg, port, states = pair
    prompt = jgen.default_prompt(cfg, language=0)
    want = jgen.greedy_decode(jmodel, params, jnp.asarray(states), cfg, prompt=prompt,
                              max_len=16, cross_kv_dtype=jnp.float8_e4m3fn,
                              self_kv_dtype=jnp.float8_e4m3fn)
    got = tgen.greedy_decode(port, torch.from_numpy(states), cfg, prompt=prompt, max_len=16,
                             cross_kv_dtype=F8, self_kv_dtype=F8)
    _same_decode(got, want)


def _first_at(row, token, P):
    """The first position >= P of ``token`` in ``row`` (None if absent)."""
    hits = np.flatnonzero(row[P:] == token)
    return int(hits[0]) + P if hits.size else None


def _early_eot(tokens, P, rows):
    """An eot that ends ``rows`` ("some": the first row alone; "all":
    every row) before ``max_len``: a token the plain decode emits there,
    the one that ends them soonest."""
    tokens = np.asarray(tokens)
    gen = [set(r[P:].tolist()) for r in tokens]
    if rows == "some":
        cands = gen[0] - set().union(*gen[1:])
    else:
        cands = set.intersection(*gen)
    assert cands, (rows, tokens)
    return min(sorted(cands), key=lambda t: max(_first_at(r, t, P) or 0 for r in tokens))


# {case: (prompt (sot [+ English, transcribe [+ notimestamps]]), eot rows, suppressed
# tokens beyond the default set, float8 storage, temperature)}
STATIC_CASES = {
    "prompt1": (1, None, False, None, 0.0),
    "prompt3": (3, None, False, None, 0.0),
    "prompt4": (4, None, False, None, 0.0),
    "eot_some_rows": (4, "some", False, None, 0.0),
    "eot_every_row": (3, "all", False, None, 0.0),
    "suppress": (4, None, True, None, 0.0),
    "f8_self": (4, None, False, "self", 0.0),
    "f8_cross": (4, None, False, "cross", 0.0),
    "sampled_seed": (4, None, False, None, 1.0),
}


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_step_decode(pair, case):
    """The static-shape step's decode against the JAX one (tokens, lengths
    and nospeech_prob equal, hidden and sum_logprob within the f32 gates);
    sampled, the same seed gives the same draws twice. Every step after the
    prefill is one span, eager (n = 0) on the CPU."""
    jmodel, params, cfg, port, states = pair
    n_prompt, eot_rows, more_suppressed, f8, temperature = STATIC_CASES[case]
    prompt = ([cfg.sot, cfg.language_token(0), cfg.token_transcribe, cfg.token_no_timestamps]
              [:n_prompt])
    max_len = 16
    js, ts = jnp.asarray(states), torch.from_numpy(states)
    kw, jkw = {}, {}
    if f8 is not None:
        kw = {f"{f8}_kv_dtype": F8}
        jkw = {f"{f8}_kv_dtype": jnp.float8_e4m3fn}
    if eot_rows is not None:
        plain = jgen.greedy_decode(jmodel, params, js, cfg, prompt=prompt, max_len=max_len)
        kw["eot"] = jkw["eot"] = _early_eot(plain["tokens"], n_prompt, eot_rows)
    if more_suppressed:
        plain = jgen.greedy_decode(jmodel, params, js, cfg, prompt=prompt, max_len=max_len)
        drawn = sorted({int(t) for t in np.asarray(plain["tokens"])[:, n_prompt:].flat})
        kw["suppress_tokens"] = jkw["suppress_tokens"] = (
            tgen.default_suppress_tokens(cfg) + drawn[:3])
    t0 = time.perf_counter()
    if temperature:
        got = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=max_len,
                                 temperature=temperature,
                                 generator=torch.Generator().manual_seed(7), **kw)
        again = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=max_len,
                                   temperature=temperature,
                                   generator=torch.Generator().manual_seed(7), **kw)
        for key in got:
            assert torch.equal(got[key], again[key]), key
        greedy = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=max_len, **kw)
        assert not torch.equal(got["tokens"], greedy["tokens"])
        assert torch.isfinite(got["sum_logprob"]).all()
        outs = [got, again, greedy]
    else:
        want = jgen.greedy_decode(jmodel, params, js, cfg, prompt=prompt, max_len=max_len, **jkw)
        got = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=max_len, **kw)
        _same_decode(got, want)
        outs = [got]
    lengths = got["lengths"].numpy()
    if eot_rows == "some":
        assert lengths[0] < max_len and (lengths[1:] == max_len).all(), lengths
    if eot_rows == "all":
        assert (lengths < max_len - 1).all(), lengths
    if more_suppressed:
        assert not np.isin(got["tokens"][:, n_prompt:].numpy(), drawn[:3]).any()
    steps = [e for e in profiling.spans(since=t0)
             if e.name == "whisper.decode_step" and e.thread == threading.get_ident()]
    # the loop stops after the step that ends the last row (or at max_len - 1)
    want_steps = sum(min(int(o["lengths"].max()), max_len - 1) - n_prompt for o in outs)
    assert len(steps) == want_steps, (len(steps), lengths)
    assert steps and all(e.n == 0 for e in steps)


class _StandInGraph:
    """A CUDA graph's stand-in on the CPU: ``_capture``'s two warm-up steps
    (which dirty the buffers), then ``replay`` runs the step eagerly."""

    def __init__(self, model, s, eot):
        self.model, self.s, self.eot = model, s, eot
        for _ in range(2):
            s.pos.zero_()
            tgen._step(model, s, eot)

    def replay(self):
        tgen._step(self.model, self.s, self.eot)


def _own_port(shared, cfg):
    """A model of its own, the shared one's weights: the graph is kept on the model."""
    port = Whisper(cfg, dtype=torch.float32)
    port.load_state_dict(shared.state_dict())
    return port.eval()


def test_the_held_graph_path_on_the_cpu(pair, monkeypatch):
    """The replay path's bookkeeping with a stand-in graph: a call after the
    capture refills the held buffers (the same result as a fresh eager
    decode, bit for bit), its outputs do not alias the next call's, and a
    new batch, new parameter storage or a suppress mask captures again, as
    does a call after ``release_step_graph``. Given the caller's own f32
    cross K/V (made under ``torch.inference_mode()``, as the long-form
    ladder may), the held buffers are the graph's: decoding A, B, then A
    again gives A's result, and the caller's tensors are left as they were."""
    _, _, cfg, shared, states = pair
    port = _own_port(shared, cfg)
    prompt = jgen.default_prompt(cfg, language=0)
    a = torch.from_numpy(states)
    b = torch.from_numpy(np.random.default_rng(9).normal(size=states.shape).astype(np.float32))
    eager = {k: tgen.greedy_decode(port, x, cfg, prompt=prompt, max_len=16)
             for k, x in (("a", a), ("b", b), ("a1", a[:1]))}
    monkeypatch.setattr(tgen, "_graphable", lambda *args: True)
    monkeypatch.setattr(tgen, "_capture", _StandInGraph)

    def run(x, **kw):
        t0 = time.perf_counter()
        out = tgen.greedy_decode(port, x, cfg, prompt=prompt, max_len=16, **kw)
        ns = {e.n for e in profiling.spans(since=t0) if e.name == "whisper.decode_step"
              and e.thread == threading.get_ident()}
        return out, ns, port._greedy_graph.graph

    got_a, ns, g = run(a)
    kept = {k: v.clone() for k, v in got_a.items()}
    got_b, ns_b, g_b = run(b)
    assert ns == ns_b == {1} and g_b is g
    for key in got_a:
        assert torch.equal(got_a[key], eager["a"][key]), key
        assert torch.equal(got_b[key], eager["b"][key]), key
        assert torch.equal(got_a[key], kept[key]), key  # not overwritten by the second call
    got, _, g1 = run(a[:1])
    assert g1 is not g and all(torch.equal(got[k], eager["a1"][k]) for k in got)
    with torch.no_grad():
        for p in port.decoder.parameters():
            p.data = p.data.clone()
    got, _, g2 = run(a[:1])
    assert g2 is not g1 and all(torch.equal(got[k], eager["a1"][k]) for k in got)
    got, _, g3 = run(a[:1], suppress_tokens=[cfg.sot])
    assert g3 is not g2
    tgen.release_step_graph(port)
    assert port._greedy_graph.graph is None and port._greedy_graph.buffers is None
    got, _, g4 = run(a[:1])
    assert g4 is not None and g4 is not g3
    assert all(torch.equal(got[k], eager["a1"][k]) for k in got)

    # the caller's f32 cross K/V: A (made and decoded in inference mode), B, A again
    with torch.inference_mode():
        kv_a = [(k.float(), v.float()) for k, v in port.precompute_cross_kv(a)]
        got_a, _, g5 = run(a, xa_kv=kv_a)
    kv_b = [(k.float(), v.float()) for k, v in port.precompute_cross_kv(b)]
    kept_kv = [(k.clone(), v.clone()) for k, v in kv_a + kv_b]
    got_b, _, g6 = run(b, xa_kv=kv_b)
    got_a2, _, g7 = run(a, xa_kv=kv_a)
    assert g5 is g6 is g7
    for key in got_a:
        assert torch.equal(got_a[key], eager["a"][key]), key
        assert torch.equal(got_b[key], eager["b"][key]), key
        assert torch.equal(got_a2[key], eager["a"][key]), key
    assert all(torch.equal(t, k) for pair_ in zip(kv_a + kv_b, kept_kv)
               for t, k in zip(*pair_))
    held = {t.data_ptr() for kv in port._greedy_graph.buffers.xa_kv for t in kv}
    assert not held & {t.data_ptr() for kv in kv_a + kv_b for t in kv}


def test_threads_share_the_held_graph(pair, monkeypatch):
    """Two threads decode different states at one signature through one
    model's held (stand-in) graph, each several times at once: every result
    equals its eager decode (a graphed decode holds the model's lock from
    its refill to its copies)."""
    _, _, cfg, shared, states = pair
    port = _own_port(shared, cfg)
    prompt = jgen.default_prompt(cfg, language=0)
    xs = [torch.from_numpy(states),
          torch.from_numpy(np.random.default_rng(9).normal(size=states.shape)
                           .astype(np.float32))]
    eager = [tgen.greedy_decode(port, x, cfg, prompt=prompt, max_len=16) for x in xs]
    monkeypatch.setattr(tgen, "_graphable", lambda *args: True)
    monkeypatch.setattr(tgen, "_capture", _StandInGraph)
    start, results = threading.Barrier(2), [[], []]

    def work(i):
        start.wait()
        for _ in range(4):
            results[i].append(tgen.greedy_decode(port, xs[i], cfg, prompt=prompt, max_len=16))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        assert len(results[i]) == 4
        for got in results[i]:
            for key in got:
                assert torch.equal(got[key], eager[i][key]), (i, key)


SMALL = WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=2,
                      n_audio_layer=1, n_vocab=64, n_text_ctx=16, n_text_state=32,
                      n_text_head=2, n_text_layer=2)


@pytest.fixture(scope="module")
def small():
    """The JAX f8 tests' model shape (tests/test_whisper_model.py), seeded
    in the port, with encoder states of two clips."""
    model = Whisper(SMALL, dtype=torch.float32).init_weights(torch.Generator().manual_seed(2))
    mel = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 8, 32)).astype(np.float32))
    with torch.no_grad():
        return model.eval(), model.encode(mel)


def _teacher_forced_steps(model, states, tokens, self_dtype, xa_kv):
    caches = tgen.init_kv_caches(SMALL, 2, SMALL.n_text_ctx, dtype=self_dtype)
    hs = []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            h, _, caches = model.decode(tokens[:, i : i + 1], None, kv_caches=caches,
                                        cache_index=torch.tensor([i]), xa_kv=xa_kv)
            assert caches[0][0].dtype == caches[1][1].dtype == self_dtype  # storage kept
            hs.append(h)
    return torch.cat(hs, 1)


@pytest.mark.parametrize("which,bound", [("cross", 0.06), ("self", 0.08)])
def test_float8_within_the_jax_bounds(small, which, bound):
    """Teacher-forced incremental decode with float8 cross K/V or self
    caches against the same decode at f32 (the JAX tests' bounds on the
    max error relative to the largest state)."""
    model, states = small
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 64, size=(2, 6)))
    xa = model.precompute_cross_kv(states)
    ref = _teacher_forced_steps(model, states, tokens, torch.float32, xa)
    if which == "cross":
        got = _teacher_forced_steps(model, states, tokens, torch.float32,
                                    [(k.to(F8), v.to(F8)) for k, v in xa])
    else:
        got = _teacher_forced_steps(model, states, tokens, F8, xa)
    rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert 0 < rel < bound, rel


def test_float8_cast_pinned_against_ml_dtypes():
    """The f8 cast of torch against ml_dtypes (XLA's): bit-equal through
    the subnormals and the finite range up to 464 (448 plus half its ulp,
    a tie to even); beyond it XLA gives NaN and this torch saturates to
    +-448. K/V values of a Whisper are far inside the range."""
    grid = np.concatenate([
        np.float32(2.0) ** np.arange(-12, 9, 0.25, dtype=np.float32),
        np.float32(2.0) ** -9 * np.arange(0, 16, 0.5, dtype=np.float32),  # subnormals, ties
        np.array([447, 448, 449, 455.99, 456, 456.01, 463.9, 464], np.float32),
    ])
    grid = np.concatenate([grid, -grid])
    got = torch.from_numpy(grid).to(F8).view(torch.uint8).numpy()
    want = grid.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(got, want)
    # bf16 values (the card's compute dtype) cast the same way from f32
    bf = torch.from_numpy(grid).bfloat16()
    np.testing.assert_array_equal(bf.to(F8).view(torch.uint8).numpy(),
                                  bf.float().numpy().astype(ml_dtypes.float8_e4m3fn).view(np.uint8))
    beyond = np.array([465, 480, 1e4, np.inf], np.float32)
    beyond = np.concatenate([beyond, -beyond])
    assert np.isnan(beyond.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)).all()
    np.testing.assert_array_equal(torch.from_numpy(beyond).to(F8).float().numpy(),
                                  np.sign(beyond) * 448)


# --- sampling (t > 0) ------------------------------------------------------------------------

def test_sampler_follows_softmax_of_logits_over_t():
    """10^4 draws of one (V=8) row at T=0.7 against softmax(logits / T):
    chi-square with 7 degrees of freedom below 24.32 (p = 1e-3); the
    log-probability returned is the untempered one."""
    logits = torch.from_numpy(np.random.default_rng(3).normal(size=8).astype(np.float32) * 2)
    rows = logits.expand(10_000, 8)
    gen = torch.Generator().manual_seed(11)
    nxt, logp = tgen.choose_tokens(rows, 0.7, gen)
    counts = np.bincount(nxt.numpy(), minlength=8)
    expected = 10_000 * torch.softmax(logits.double() / 0.7, -1).numpy()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts, expected)
    np.testing.assert_allclose(logp.numpy(), torch.log_softmax(logits, -1)[nxt].numpy(),
                               rtol=1e-6)
    greedy, _ = tgen.choose_tokens(rows[:3], 0.0)
    assert (greedy == logits.argmax()).all()


def test_sampling_seeds_and_suppression(pair):
    jmodel, params, cfg, port, states = pair
    prompt = jgen.default_prompt(cfg, language=0)
    ts = torch.from_numpy(states)
    free = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=16, temperature=1.0,
                              generator=torch.Generator().manual_seed(1))
    again = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=16, temperature=1.0,
                               generator=torch.Generator().manual_seed(1))
    other = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=16, temperature=1.0,
                               generator=torch.Generator().manual_seed(2))
    for key in free:
        assert torch.equal(free[key], again[key]), key
    assert not torch.equal(free["tokens"], other["tokens"])
    greedy = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=16)
    assert not torch.equal(free["tokens"], greedy["tokens"])
    # suppress every id the free run drew (eot aside): none is drawn again
    P = len(prompt)
    drawn = sorted({int(t) for t in free["tokens"][:, P:].flatten()} - {cfg.eot})
    banned = tgen.greedy_decode(port, ts, cfg, prompt=prompt, max_len=16, temperature=1.0,
                                generator=torch.Generator().manual_seed(1),
                                suppress_tokens=drawn)
    assert not np.isin(banned["tokens"][:, P:].numpy(), drawn).any()
    assert torch.isfinite(banned["sum_logprob"]).all()
