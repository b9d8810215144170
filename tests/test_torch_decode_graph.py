"""Card-only tests of the greedy decode's CUDA graph
(``wealy_tpu_torch/models/whisper/generate.py``): at large-v3-turbo's
decoder width (4 layers, 1280 wide, 20 heads, the full vocabulary) and the
extraction's shapes (B=16, ``max_len`` 224), the replayed step against the
same step run eagerly on the card (``_graphable`` patched to refuse), with
bf16 and float8 K/V and a suppress mask: tokens equal, hidden within a
relative L2 of 1e-3, the same number of steps, the step spans' ``n`` 1 for
a replay and 0 eagerly. An eot forced at one position stops both loops
after the same step; two calls in a row return tensors that do not alias;
a new batch size and new parameter storage each capture again; the path
runs under ``torch.inference_mode()`` and after it; two threads decoding
through one model each get their own result; a caller's cross K/V is
copied in, never held, and ``release_step_graph`` frees the graph. Marked
``cuda``; each skips without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py
"""

import threading
import time

import pytest
import torch

from wealy_tpu_torch.models.whisper import generate as tgen
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.model import Whisper
from wealy_tpu_torch.utils import profiling

from _torch_parity import cuda_device

pytestmark = pytest.mark.cuda

# large-v3-turbo's decoder; a one-layer encoder, never run (the states are drawn)
TURBO_DECODER = WhisperConfig(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                              n_audio_layer=1, n_vocab=51866, n_text_ctx=448,
                              n_text_state=1280, n_text_head=20, n_text_layer=4)
MAX_LEN = 224
HIDDEN_REL_L2 = 1e-3


@pytest.fixture
def dev():
    device = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the decode's products are f32
    return device


def _model(dev, seed: int = 0) -> Whisper:
    """Seeded weights with eot's embedding row zero (as the benchmark's
    configurations): no row ends by chance, every decode runs to max_len."""
    model = Whisper(TURBO_DECODER, dtype=torch.bfloat16, device=dev)
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.decoder.token_embedding.weight[TURBO_DECODER.eot] = 0
    return model.eval()


def _states(dev, B: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, TURBO_DECODER.n_audio_ctx, TURBO_DECODER.n_audio_state),
                       generator=g).to(dev, torch.bfloat16)


def _decode(model, states, eager: bool = False, monkeypatch=None, **kw):
    """(the greedy dict, its step spans' numbers)."""
    prompt = tgen.default_prompt(TURBO_DECODER, language=0)
    t0 = time.perf_counter()
    if eager:
        with monkeypatch.context() as m:
            m.setattr(tgen, "_graphable", lambda *a: False)
            out = tgen.greedy_decode(model, states, TURBO_DECODER, prompt=prompt,
                                     max_len=MAX_LEN, **kw)
    else:
        out = tgen.greedy_decode(model, states, TURBO_DECODER, prompt=prompt, max_len=MAX_LEN,
                                 **kw)
    torch.cuda.synchronize()
    ns = [e.n for e in profiling.spans(since=t0)
          if e.name == "whisper.decode_step" and e.thread == threading.get_ident()]
    return out, ns


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _same(graphed, eager):
    """Replay against eager: tokens and lengths equal, hidden and sum_logprob close."""
    assert torch.equal(graphed["tokens"], eager["tokens"])
    assert torch.equal(graphed["lengths"], eager["lengths"])
    assert _rel_l2(graphed["hidden"], eager["hidden"]) <= HIDDEN_REL_L2
    torch.testing.assert_close(graphed["sum_logprob"], eager["sum_logprob"], rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(graphed["nospeech_prob"], eager["nospeech_prob"])


@pytest.mark.parametrize("kv", ["bf16", "f8", "suppress"])
def test_replay_equals_the_eager_step(dev, monkeypatch, kv):
    model, states = _model(dev), _states(dev, 16)
    kw = {}
    if kv == "f8":
        kw = {"cross_kv_dtype": torch.float8_e4m3fn, "self_kv_dtype": torch.float8_e4m3fn}
    if kv == "suppress":
        kw = {"suppress_tokens": tgen.default_suppress_tokens(TURBO_DECODER)}
    graphed, n_graphed = _decode(model, states, **kw)
    eager, n_eager = _decode(model, states, eager=True, monkeypatch=monkeypatch, **kw)
    _same(graphed, eager)
    assert len(n_graphed) == len(n_eager) == MAX_LEN - 1 - 4  # no row ends: every step runs
    assert set(n_graphed) == {1} and set(n_eager) == {0}
    assert model._greedy_graph.graph is not None


def test_a_forced_eot_stops_both_loops_after_the_same_step(dev, monkeypatch):
    """eot given an embedding row and the decoder's position row 40 pushed
    along it: every row emits eot there, so both loops stop after the step
    at position 40."""
    model, states = _model(dev), _states(dev, 16)
    dec = model.decoder
    r = torch.randn(TURBO_DECODER.n_text_state, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        dec.token_embedding.weight[TURBO_DECODER.eot] = 0.02 * r.to(dev)
        dec.positional_embedding[40] = 1e4 * r.to(dev) / r.norm()
    graphed, n_graphed = _decode(model, states)
    eager, n_eager = _decode(model, states, eager=True, monkeypatch=monkeypatch)
    _same(graphed, eager)
    assert (graphed["lengths"] == 41).all(), graphed["lengths"]
    assert len(n_graphed) == len(n_eager) == 40 - 4 + 1


def test_two_calls_do_not_alias(dev):
    model = _model(dev)
    first, _ = _decode(model, _states(dev, 16, seed=1))
    kept = {k: v.clone() for k, v in first.items()}
    second, ns = _decode(model, _states(dev, 16, seed=2))
    assert set(ns) == {1}  # the same signature: a replay of the first call's graph
    for key in first:
        assert torch.equal(first[key], kept[key]), key
        assert first[key].data_ptr() != second[key].data_ptr(), key
    assert not torch.equal(first["hidden"], second["hidden"])


def test_a_new_batch_and_new_parameter_storage_capture_again(dev, monkeypatch):
    model = _model(dev)
    _decode(model, _states(dev, 16))
    g16 = model._greedy_graph.graph
    small = _states(dev, 8)
    got, ns = _decode(model, small)
    g8 = model._greedy_graph.graph
    assert g8 is not g16 and set(ns) == {1}
    _same(got, _decode(model, small, eager=True, monkeypatch=monkeypatch)[0])
    # new storage, new values: the old graph would read freed memory
    with torch.no_grad():
        for p in model.decoder.parameters():
            p.data = p.data * 1.5
    got, ns = _decode(model, small)
    assert model._greedy_graph.graph is not g8 and set(ns) == {1}
    _same(got, _decode(model, small, eager=True, monkeypatch=monkeypatch)[0])


def test_inference_mode_capture_then_plain_calls(dev, monkeypatch):
    """Captured under ``torch.inference_mode()`` (as the extraction's
    ``decode_fn`` runs it), then replayed outside it."""
    model, states = _model(dev), _states(dev, 16)
    with torch.inference_mode():
        inside, ns = _decode(model, states)
    assert set(ns) == {1}
    outside, ns = _decode(model, states)
    assert set(ns) == {1}
    eager, _ = _decode(model, states, eager=True, monkeypatch=monkeypatch)
    _same(inside, eager)
    _same(outside, eager)


def test_threads_decode_one_model_at_once(dev, monkeypatch):
    """Two request threads decode different states at one signature
    through one model (the serve daemon's audio queries): each result
    equals its eager decode."""
    model = _model(dev)
    xs = [_states(dev, 4, seed=1), _states(dev, 4, seed=2)]
    eager = [_decode(model, x, eager=True, monkeypatch=monkeypatch)[0] for x in xs]
    start, results = threading.Barrier(2), [[], []]

    def work(i):
        start.wait()
        for _ in range(3):
            results[i].append(_decode(model, xs[i])[0])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        assert len(results[i]) == 3
        for got in results[i]:
            _same(got, eager[i])


def test_the_callers_cross_kv_is_not_held(dev, monkeypatch):
    """The caller's own f32 cross K/V (the long-form ladder's ``xa_kv``),
    made under ``torch.inference_mode()``: decoding A, B, then A again
    outside it gives A's result, the caller's tensors stay as they were,
    and ``release_step_graph`` frees the graph (the next call captures)."""
    model = _model(dev)
    xs = [_states(dev, 16, seed=1), _states(dev, 16, seed=2)]
    with torch.inference_mode():
        kvs = [[(k.float(), v.float()) for k, v in model.precompute_cross_kv(x)] for x in xs]
    kept = [[(k.clone(), v.clone()) for k, v in kv] for kv in kvs]
    with torch.inference_mode():
        first, _ = _decode(model, xs[0], xa_kv=kvs[0])
    second, _ = _decode(model, xs[1], xa_kv=kvs[1])
    third, ns = _decode(model, xs[0], xa_kv=kvs[0])
    assert set(ns) == {1}
    _same(first, _decode(model, xs[0], eager=True, monkeypatch=monkeypatch)[0])
    _same(second, _decode(model, xs[1], eager=True, monkeypatch=monkeypatch)[0])
    for key in first:
        assert torch.equal(third[key], first[key]), key
    for kv, kv_kept in zip(kvs, kept):
        assert all(torch.equal(t, k) for pair in zip(kv, kv_kept) for t, k in zip(*pair))
    graph = model._greedy_graph.graph
    tgen.release_step_graph(model)
    assert model._greedy_graph.graph is None
    again, ns = _decode(model, xs[0], xa_kv=kvs[0])
    assert set(ns) == {1} and model._greedy_graph.graph is not graph
    for key in first:
        assert torch.equal(again[key], first[key]), key
