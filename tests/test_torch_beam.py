"""The port's beam search (wealy_tpu_torch.models.whisper.beam) against the
JAX package's on the CPU: the tiny decode model of
tests/conftest.py::tiny_decode_model carried into the port, two clips'
encoder states from a numpy seed through both.

Tolerances: best tokens, lengths and every returned beam's tokens and
lengths identical; hidden states and summed log-probs rtol/atol 1e-4 (the
port's f32 parity). Ties resolve as ``lax.top_k`` resolves them (the lower
flat index first): the port's top K over an int64 (value, index) key is
held against ``lax.top_k`` on constructed ties, and a model whose token
embedding is zero (every candidate ties at every step) decodes the JAX
package's beams."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wealy_tpu.models.whisper import beam as jbeam
from wealy_tpu.models.whisper.generate import default_prompt
from wealy_tpu_torch.models.whisper import beam as tbeam
from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.generate import greedy_decode
from wealy_tpu_torch.models.whisper.model import Whisper

RTOL = ATOL = 1e-4
F8 = torch.float8_e4m3fn


def _port(cfg, params):
    port = Whisper(cfg, dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return port.eval()


@pytest.fixture(scope="module")
def pair(tiny_decode_model):
    jmodel, params, cfg = tiny_decode_model
    states = np.random.default_rng(0).normal(
        size=(2, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32)
    return jmodel, params, cfg, _port(cfg, params), states


def _zero_embedding(params):
    """The params with a zero token embedding: every logit 0, every
    candidate of every step tied."""
    params = jax.tree_util.tree_map(np.asarray, params)
    dec = dict(params["decoder"])
    dec["token_embedding"] = np.zeros_like(dec["token_embedding"])
    return {**params, "decoder": dec}


CASES = {
    "K1": dict(beam_size=1),
    "K2": dict(beam_size=2),
    "K5": dict(beam_size=5),
    "K2-suppress": dict(beam_size=2, suppress_tokens=[220, 262, 264, 286, 290, 293]),
    "K3-length-penalty": dict(beam_size=3, length_penalty=0.6),
    "K3-float8": dict(beam_size=3, f8=True),
    "K4-all-tied": dict(beam_size=4, tied=True),
}


@pytest.mark.parametrize("case", CASES)
def test_beam_decode_matches_jax(pair, case):
    jmodel, params, cfg, port, states = pair
    kw = dict(CASES[case])
    f8, tied = kw.pop("f8", False), kw.pop("tied", False)
    if tied:
        params = _zero_embedding(params)
        port = _port(cfg, params)
    prompt = default_prompt(cfg, language=0)
    max_len = len(prompt) + 9
    want = jbeam.beam_decode(
        jmodel, params, jnp.asarray(states), cfg, prompt=prompt, max_len=max_len,
        return_beams=True, cross_kv_dtype=jnp.float8_e4m3fn if f8 else None,
        self_kv_dtype=jnp.float8_e4m3fn if f8 else None, **kw)
    got = tbeam.beam_decode(
        port, torch.from_numpy(states), cfg, prompt=prompt, max_len=max_len, return_beams=True,
        cross_kv_dtype=F8 if f8 else None, self_kv_dtype=F8 if f8 else None, **kw)
    for key in ("tokens", "lengths", "beam_tokens", "beam_lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("hidden", "sum_logprob", "nospeech_prob", "beam_sum_logprob"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    P = len(prompt)
    if "suppress_tokens" in kw:
        assert not np.isin(got["beam_tokens"][..., P:].numpy(), kw["suppress_tokens"]).any()
    if tied:  # the lowest ids first: beam k seeds with token k
        assert got["beam_tokens"][0, :, P].tolist() == sorted(got["beam_tokens"][0, :, P].tolist())


def test_beam_of_one_is_greedy(pair):
    _, _, cfg, port, states = pair
    prompt = default_prompt(cfg, language=0)
    ts = torch.from_numpy(states)
    g = greedy_decode(port, ts, cfg, prompt=prompt, max_len=16)
    b = tbeam.beam_decode(port, ts, cfg, prompt=prompt, beam_size=1, max_len=16)
    for key in ("tokens", "lengths", "hidden", "nospeech_prob"):
        assert torch.equal(g[key], b[key]), key
    np.testing.assert_allclose(b["sum_logprob"].numpy(), g["sum_logprob"].numpy(), rtol=1e-6)


def test_precomputed_cross_kv_at_b(pair):
    """Cross K/V made at batch B (the long-form hand-off) are repeated K
    times inside: the same beams as a decode that makes its own."""
    _, _, cfg, port, states = pair
    prompt = default_prompt(cfg, language=0)
    ts = torch.from_numpy(states)
    a = tbeam.beam_decode(port, ts, cfg, prompt=prompt, beam_size=3, max_len=14)
    b = tbeam.beam_decode(port, ts, cfg, prompt=prompt, beam_size=3, max_len=14,
                          xa_kv=port.precompute_cross_kv(ts))
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("k", [1, 3, 8])
def test_top_k_ties_resolve_as_lax_top_k(k):
    """Rows of many equal values, -inf, +-0.0 and repeated maxima: the same
    values and indices as ``lax.top_k`` (equal values: lower index first;
    -0.0 below +0.0, its total order)."""
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 3, size=(6, 40)).astype(np.float32) / 2
    x[1] = 0.0
    x[1, ::3] = -0.0
    x[2, :] = -np.inf
    x[2, 7] = -5.0
    x[3, 30:] = 2.5
    x[4] = rng.normal(size=40).astype(np.float32)
    x[4, [3, 9, 27]] = x[4].max()
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = tbeam.top_k_first_index(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_rank_beams_equal_jax():
    slp, n = np.array([[-4.0, -5.0, -7.5]], np.float32), np.array([[4, 10, 0]])
    for lp in (None, 0.0, 0.6, 1.0):
        np.testing.assert_allclose(
            tbeam.rank_beams(torch.from_numpy(slp), torch.from_numpy(n), lp).numpy(),
            np.asarray(jbeam.rank_beams(jnp.asarray(slp), jnp.asarray(n), lp)), rtol=1e-6)
