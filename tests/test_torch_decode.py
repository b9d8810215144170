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
V=8 pass a chi-square test against softmax(logits / T)."""

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
                                        cache_index=i, xa_kv=xa_kv)
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
