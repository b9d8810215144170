"""The decode attention kernel (``ops/decode_attention.py``,
``csrc/decode_attention.cu``) and the decode step's storage around it.

On the card (marked ``cuda``; each skips without one): the kernel against
``_reference_decode_attention`` at the extraction cells' shapes (turbo's 20
heads and medium's 16, Tk 1500, B 16 and 32) and at odd ones (Tk around the
256-position chunk and at the largest cluster, 2048; 6 heads; cache
positions 0, 1 and ``max_len`` - 1 with caches of 224 and 448 positions, and
the 448 cache on both sides of its chunk edge), bf16 and float8 e4m3
storage; a K/V past ``MAX_TK`` raises; a repeat is bit-equal; a call
captured in a CUDA graph is one launch, counted by its cluster size; the
step's route is chosen by dtype (bf16 and float8 e4m3 to the kernel, float8
e5m2 and f32 to the plain path) and a layout the kernel cannot read raises
instead of falling back; a teacher-forced greedy decode at turbo's decoder
width through the kernel route against the plain route along the same
tokens (hidden states and logits); the graphed greedy decode against the
eager one, both through the kernel, each counting its launches and their
clusters.

On the CPU: the wrapper's plain route, the cluster size of a row, the
step's route by length, the held storage of the cross K/V and the logit
table, and the logits of the bf16 table against its f32 upcast.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py
"""

import threading
import time
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from wealy_tpu_torch.models.whisper import generate as tgen
from wealy_tpu_torch.models.whisper import model as tmodel
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.model import Whisper, step_logits
from wealy_tpu_torch.ops import BF16_REL_ABS, bf16_agreement
from wealy_tpu_torch.ops import decode_attention as da
from wealy_tpu_torch.utils import profiling

from _torch_parity import cuda_device

F8 = torch.float8_e4m3fn
SCALE = 64 ** -0.25
TURBO_DECODER = WhisperConfig(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                              n_audio_layer=1, n_vocab=51866, n_text_ctx=448,
                              n_text_state=1280, n_text_head=20, n_text_layer=4)
TINY = WhisperConfig(n_mels=8, n_audio_ctx=16, n_audio_state=128, n_audio_head=2,
                     n_audio_layer=1, n_vocab=64, n_text_ctx=32, n_text_state=128,
                     n_text_head=2, n_text_layer=2)
# a kernel call against the plain version on the same operands inside a
# decode: bf16 outputs that differ where a probability on a bf16 rounding
# boundary rounds the other way after sums in another order (on an H100 the
# widest of 480 calls read 1.8e-4 to 3.6e-4 at gains 1 and 3, bf16 and float8)
CALL_REL_L2 = 1e-3
# one teacher-forced step, kernel route against plain route from the same
# caches, by attention gain. The decoder turns a call's 1e-4 into far more
# within one step: each layer's output rounds to bf16, and at gain 3 the
# attention logits spread by 9, so a flipped rounding moves the next
# layer's softmax. The plain path's own maths in f64 (the probabilities
# still rounded to bf16) moves a step as far: at most 0.0058 / 0.0088
# (hidden, bf16 / float8) and 0.0093 (logits) at gain 1, 0.043 / 0.031 and
# 0.067 at gain 3; the kernel read 0.0046-0.0071 and 0.0094 at gain 1,
# 0.035-0.053 and 0.089 at gain 3 (the widest of 60 steps, two seeds)
TF_REL_L2 = {1.0: 1.5e-2, 3.0: 0.1}
TF_LOGIT_REL = {1.0: 2e-2, 3.0: 0.15}


@pytest.fixture
def dev():
    device = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain path's products are f32
    return device


def _operands(dev, B, H, tk, dtype=torch.bfloat16, seed=0, gain=3.0):
    """q (B, 1, H, 64) bf16 and k, v (B, H, tk, 64) in ``dtype``: values of
    a decoder whose attention logits spread as trained heads' do (``gain``
    on q and k, the benchmark's ``attention_gain``)."""
    g = torch.Generator().manual_seed(seed)
    q = (gain * torch.randn((B, 1, H, 64), generator=g)).to(dev, torch.bfloat16)
    k = (gain * SCALE * torch.randn((B, H, tk, 64), generator=g)).to(dev, torch.bfloat16)
    v = torch.randn((B, H, tk, 64), generator=g).to(dev, torch.bfloat16)
    return q, k.to(dtype), v.to(dtype)


def _assert_close(got, want):
    """Within the port's bf16 bounds (``ops.bf16_agreement``): bf16 outputs
    whose f32 sums run in another order, which can move a probability
    across a bf16 rounding boundary."""
    ok, err, cos = bf16_agreement(got, want)
    assert ok, (err, cos)


def _kernel_and_plain(q, k, v, pos=None):
    mask = None if pos is None else da.position_mask(pos, k.shape[2])
    before, clusters = da.decode_attention.launches, Counter(da.decode_attention.clusters)
    got = da.decode_attention(q, k, v, SCALE, pos)
    assert da.decode_attention.launches == before + 1
    assert da.decode_attention.clusters - clusters == {da.cluster_size(k.shape[2]): 1}
    return got, da._reference_decode_attention(q, k, v, SCALE, mask)


# --- the kernel on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, F8], ids=["bf16", "f8"])
@pytest.mark.parametrize("B", [16, 32])
@pytest.mark.parametrize("H", [20, 16], ids=["turbo", "medium"])
def test_kernel_at_the_cells_cross_shapes(dev, H, B, dtype):
    q, k, v = _operands(dev, B, H, 1500, dtype)
    got, want = _kernel_and_plain(q, k, v)
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, F8], ids=["bf16", "f8"])
@pytest.mark.parametrize("B,H,tk", [(1, 6, 1), (2, 6, 7), (3, 6, 255), (2, 6, 256), (2, 6, 257),
                                    (1, 20, 300), (2, 6, 513), (1, 6, 1499), (2, 6, 2048)])
def test_kernel_at_odd_cross_shapes(dev, B, H, tk, dtype):
    q, k, v = _operands(dev, B, H, tk, dtype, seed=tk)
    got, want = _kernel_and_plain(q, k, v)
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, F8], ids=["bf16", "f8"])
@pytest.mark.parametrize("max_len", [224, 448])
@pytest.mark.parametrize("at", [0, 1, -1], ids=["pos0", "pos1", "last"])
def test_kernel_at_cache_positions(dev, at, max_len, dtype):
    """A self-attention cache of ``max_len`` positions read up to a device
    position: one kernel (224) or two (448); the rows past the position hold
    values that would change the answer if read."""
    pos = torch.tensor([at % max_len], device=dev)
    q, k, v = _operands(dev, 4, 6, max_len, dtype, seed=max_len + at)
    got, want = _kernel_and_plain(q, k, v, pos)
    _assert_close(got, want)
    if at == 0:  # one valid row: the output is that row of v, rounded
        assert torch.equal(got[:, 0], v[:, :, 0].float().to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, F8], ids=["bf16", "f8"])
@pytest.mark.parametrize("at", [0, 255, 256, 447])
def test_kernel_at_a_448_cache_across_its_chunk_edge(dev, at, dtype):
    """A 448-position cache is a cluster of two blocks: up to position 255
    the second block holds no valid row (its statistics are empty), from 256
    on both do."""
    pos = torch.tensor([at], device=dev)
    q, k, v = _operands(dev, 4, 6, 448, dtype, seed=1000 + at)
    got, want = _kernel_and_plain(q, k, v, pos)
    _assert_close(got, want)
    if at == 0:
        assert torch.equal(got[:, 0], v[:, :, 0].float().to(torch.bfloat16))


@pytest.mark.cuda
def test_a_kv_past_max_tk_raises(dev):
    """Tk 2049 needs a cluster of 9 blocks, past the portable 8: the step
    sends it to the plain path and the wrapper refuses it."""
    q, k, v = _operands(dev, 1, 6, da.MAX_TK + 1)
    assert da.MAX_TK == 2048 and not da.takes(q, k)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, SCALE)


@pytest.mark.cuda
def test_a_captured_call_is_one_clustered_launch(dev):
    """Calls captured in a CUDA graph (the cross K/V, a cluster of 6; the
    224 cache, 1; the 448 cache, 2) are one kernel launch each, eager and
    replayed, and no scores pass; the wrapper counts each at its cluster
    size; a replay gives the eager outputs bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for i, (tk, at) in enumerate(((1500, None), (224, 112), (448, 300))):
        q, k, v = _operands(dev, 16, 20, tk, seed=i)
        calls.append((q, k, v, None if at is None else torch.tensor([at], device=dev)))
    with profile(activities=[ProfilerActivity.CUDA]) as eager_trace:
        eager = [da.decode_attention(q, k, v, SCALE, pos) for q, k, v, pos in calls]
        torch.cuda.synchronize()
    launches, clusters = da.decode_attention.launches, Counter(da.decode_attention.clusters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [da.decode_attention(q, k, v, SCALE, pos) for q, k, v, pos in calls]
    assert da.decode_attention.launches - launches == 3
    assert da.decode_attention.clusters - clusters == {6: 1, 1: 1, 2: 1}
    with profile(activities=[ProfilerActivity.CUDA]) as replay_trace:
        graph.replay()
        torch.cuda.synchronize()
    for trace in (eager_trace, replay_trace):
        names = [e.name for e in trace.events() if "decode_attn" in e.name]
        assert len(names) == 3 and not any("scores" in n for n in names), names
    assert all(torch.equal(o, e) for o, e in zip(outs, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("tk", [224, 1500])
def test_kernel_repeats_bit_equal(dev, tk):
    q, k, v = _operands(dev, 16, 20, tk)
    pos = torch.tensor([tk // 2], device=dev)
    for p in (None, pos):
        first = da.decode_attention(q, k, v, SCALE, p)
        assert torch.equal(first, da.decode_attention(q, k, v, SCALE, p))


@pytest.mark.cuda
def test_the_step_routes_by_dtype(dev):
    """A one-token step against a held cross K/V goes to the kernel for bf16
    and float8 e4m3 storage, and to the plain path for float8 e5m2 and for
    an f32 model, whose answer the plain version gives."""
    q, k, v = _operands(dev, 2, 6, 300)
    x = torch.randn((2, 1, 384), device=dev)
    for dtype, kv_dtype, kernel in ((torch.bfloat16, torch.bfloat16, True),
                                    (torch.bfloat16, F8, True),
                                    (torch.bfloat16, torch.float8_e5m2, False),
                                    (torch.float32, torch.float32, False)):
        attn = tmodel.MultiHeadAttention(384, 6, dtype=dtype, device=dev).eval()
        kk, vv = k.to(kv_dtype), v.to(kv_dtype)
        assert da.takes(q.to(dtype), kk) == kernel
        before = da.decode_attention.launches
        with torch.no_grad():
            got = attn(x.to(dtype), xa_kv=(kk, vv))
            qq = attn.query(x.to(dtype)).view(2, 1, 6, 64)
            plain = attn.out(da._reference_decode_attention(qq, kk, vv, SCALE).reshape(2, 1, 384))
        assert da.decode_attention.launches - before == int(kernel), kv_dtype
        if not kernel:
            assert torch.equal(got, plain)


@pytest.mark.cuda
def test_a_layout_the_kernel_cannot_read_raises_in_the_step(dev):
    """bf16 K/V that the kernel cannot read (8 bytes off a 16-byte boundary,
    or a strided view) raise from the wrapper and from the model's step:
    the step never falls back to the plain path for them."""
    q, k, v = _operands(dev, 2, 6, 300)
    flat = torch.empty(k.numel() + 4, dtype=k.dtype, device=dev)
    misaligned = flat[4:].view(k.shape)
    misaligned.copy_(k)
    strided = torch.empty((2, 6, 64, 300), dtype=k.dtype, device=dev).transpose(2, 3)
    strided.copy_(k)
    attn = tmodel.MultiHeadAttention(384, 6, device=dev).eval()
    x = torch.randn((2, 1, 384), device=dev).to(torch.bfloat16)
    for kk in (misaligned, strided):
        assert da.takes(q, kk)
        with pytest.raises(ValueError):
            da.decode_attention(q, kk, v, SCALE)
        with pytest.raises(ValueError), torch.no_grad():
            attn(x, xa_kv=(kk, v))


def _turbo(dev, seed=0, gain=3.0) -> Whisper:
    """Turbo's decoder, seeded; ``gain`` on the query and key weights (the
    benchmark's ``attention_gain``: 3 attends to a few positions, as trained
    heads do); eot's embedding row zero, so no row ends by chance."""
    model = Whisper(TURBO_DECODER, dtype=torch.bfloat16, device=dev)
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for block in model.decoder.blocks:
            for attn in (block.attn, block.cross_attn):
                attn.query.weight.mul_(gain)
                attn.key.weight.mul_(gain)
        model.decoder.token_embedding.weight[TURBO_DECODER.eot] = 0
    return model.eval()


def _states(dev, B, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, TURBO_DECODER.n_audio_ctx, TURBO_DECODER.n_audio_state),
                       generator=g).to(dev, torch.bfloat16)


def teacher_forced_routes(model, states, kv_dtype, monkeypatch, n_pos=60, max_len=224):
    """Along the tokens of one greedy decode of ``n_pos`` positions, each
    position's static-shape step through the kernel route (K/V and cache
    in ``kv_dtype``, the bf16 logit table) and through the plain route
    (``takes`` refusing, the f32 upcast of the table), both from the plain
    route's caches: a step's difference, not its growth through the later
    positions' self-attention. Each kernel call is also held against the
    plain version on its own operands. Returns the widest (per-call relative
    L2, per-call max error over the largest value, per-step hidden relative
    L2, per-step logit error over the logits' spread)."""
    prompt = tgen.default_prompt(TURBO_DECODER, language=0)
    tokens = tgen.greedy_decode(model, states, TURBO_DECODER, prompt=prompt,
                                max_len=n_pos)["tokens"]
    f8 = kv_dtype == F8
    xa_kv = tgen.decode_cross_kv(model, states, cross_kv_dtype=kv_dtype if f8 else None)
    B, T = tokens.shape
    caches = tgen.init_kv_caches(TURBO_DECODER, B, max_len, dtype=kv_dtype, device=tokens.device)
    calls, steps = [], []

    def held_to_plain(q, k, v, scale, pos=None):
        got = da.decode_attention(q, k, v, scale, pos)
        mask = None if pos is None else da.position_mask(pos, k.shape[2])
        want = da._reference_decode_attention(q, k, v, scale, mask).float()
        calls.append((float((got.float() - want).norm() / want.norm()),
                      float((got.float() - want).abs().max() / want.abs().max())))
        return got

    with torch.no_grad():
        for i in range(T):
            tok, at = tokens[:, i : i + 1], torch.tensor([i], device=tokens.device)
            trial = [(k.clone(), v.clone()) for k, v in caches]
            with monkeypatch.context() as m:
                m.setattr(tmodel, "decode_attention", held_to_plain)
                got_h, got_l, _ = model.decode(tok, None, kv_caches=trial, cache_index=at,
                                               xa_kv=xa_kv,
                                               logit_weight=model.decoder.logit_table())
            with monkeypatch.context() as m:
                m.setattr(tmodel, "takes", lambda *a: False)
                want_h, want_l, caches = model.decode(
                    tok, None, kv_caches=caches, cache_index=at, xa_kv=xa_kv,
                    logit_weight=model.decoder.logit_table().float())
            got_h, want_h = got_h.float(), want_h.float()
            steps.append((float((got_h - want_h).norm() / want_h.norm()),
                          float((got_l - want_l).abs().max() / (want_l.max() - want_l.min()))))
    assert len(calls) == 2 * TURBO_DECODER.n_text_layer * T
    return (max(c[0] for c in calls), max(c[1] for c in calls), max(s[0] for s in steps),
            max(s[1] for s in steps))


@pytest.mark.cuda
@pytest.mark.parametrize("gain", [1.0, 3.0])
@pytest.mark.parametrize("kv", ["bf16", "f8"])
def test_teacher_forced_decode_kernel_route_against_plain(dev, monkeypatch, kv, gain):
    """A teacher-forced greedy decode at turbo's decoder width (B=16, 60
    positions of a 224 cache, bf16 or float8 K/V, attention gain 1 and the
    benchmark's 3) through the kernel route against the plain route along
    the same tokens: each kernel call within its bounds, each step's hidden
    states and logits within the bounds above."""
    call_l2, call_abs, hidden, logits = teacher_forced_routes(
        _turbo(dev, gain=gain), _states(dev, 16), torch.bfloat16 if kv == "bf16" else F8,
        monkeypatch)
    assert call_l2 <= CALL_REL_L2, call_l2
    assert call_abs <= BF16_REL_ABS, call_abs
    assert hidden <= TF_REL_L2[gain], hidden
    assert logits <= TF_LOGIT_REL[gain], logits


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "f8"])
def test_graph_and_eager_decode_both_through_the_kernel(dev, monkeypatch, kv):
    """The graphed greedy decode against the eager one at the extraction's
    shapes: both run the kernel, so the tokens are equal and the states
    bit-equal; the held cross K/V is bf16 (or float8) and the held logit
    table bf16. Both count the kernel's launches: the graphed decode its
    two warm-up steps and each replay's calls (and their clusters by size),
    the eager one each call."""
    model, states = _turbo(dev), _states(dev, 16)
    kw = {} if kv == "bf16" else {"cross_kv_dtype": F8, "self_kv_dtype": F8}
    prompt = tgen.default_prompt(TURBO_DECODER, language=0)
    per_step, steps = 2 * TURBO_DECODER.n_text_layer, 224 - 1 - len(prompt)
    t0 = time.perf_counter()
    start, clusters = da.decode_attention.launches, Counter(da.decode_attention.clusters)
    graphed = tgen.greedy_decode(model, states, TURBO_DECODER, prompt=prompt, max_len=224, **kw)
    torch.cuda.synchronize()
    assert da.decode_attention.launches - start == per_step * (2 + steps)
    # every cross call a cluster of 6 (1500 frames), every cache call of 1 (224)
    layers = TURBO_DECODER.n_text_layer * (2 + steps)
    assert da.decode_attention.clusters - clusters == {6: layers, 1: layers}
    ns = {e.n for e in profiling.spans(since=t0)
          if e.name == "whisper.decode_step" and e.thread == threading.get_ident()}
    assert ns == {1}
    held = model._greedy_graph.buffers
    assert {t.dtype for kv_ in held.xa_kv for t in kv_} == {kw.get("cross_kv_dtype",
                                                                   torch.bfloat16)}
    assert held.logit_weight.dtype == torch.bfloat16
    before = da.decode_attention.launches
    with monkeypatch.context() as m:
        m.setattr(tgen, "_graphable", lambda *a: False)
        eager = tgen.greedy_decode(model, states, TURBO_DECODER, prompt=prompt, max_len=224,
                                   **kw)
    assert da.decode_attention.launches - before == per_step * steps
    assert torch.equal(graphed["tokens"], eager["tokens"])
    assert torch.equal(graphed["hidden"], eager["hidden"])


# --- on the CPU -----------------------------------------------------------------------------

@pytest.mark.parametrize("tk,blocks", [(1, 1), (256, 1), (257, 2), (1500, 6), (2048, 8)])
def test_cluster_size(tk, blocks):
    """One block a 256-position chunk of the row, at most the portable
    cluster size of 8: the audio frames' 1500 a cluster of 6."""
    assert da.cluster_size(tk) == blocks
    assert blocks <= da.MAX_TK // da.CHUNK == 8


@pytest.mark.parametrize("tk,kernel", [(224, True), (1500, True), (2048, True), (2049, False),
                                       (32768, False)])
def test_takes_sends_a_kv_past_max_tk_to_the_plain_path(tk, kernel):
    """The step's route by length: K/V of at most ``MAX_TK`` positions go
    to the kernel, longer ones to the plain path (card operands, stood in
    for by their dtype and shape)."""
    q = SimpleNamespace(is_cuda=True, dtype=torch.bfloat16, shape=(16, 1, 20, 64))
    k = SimpleNamespace(dtype=torch.bfloat16, shape=(16, 20, tk, 64))
    assert da.takes(q, k) == kernel


@pytest.mark.parametrize("at", [0, 3, 9])
def test_cpu_route_is_the_plain_path_under_the_position_mask(at):
    """On the CPU the wrapper is the plain version, positions past ``pos``
    masked: the answer ignores what the cache holds there."""
    g = torch.Generator().manual_seed(at)
    q = torch.randn((2, 1, 3, 64), generator=g).bfloat16()
    k = torch.randn((2, 3, 10, 64), generator=g).bfloat16()
    v = torch.randn((2, 3, 10, 64), generator=g).bfloat16()
    pos = torch.tensor([at])
    got = da.decode_attention(q, k, v, SCALE, pos)
    assert not da.takes(q, k)
    trimmed = da._reference_decode_attention(q, k[:, :, : at + 1], v[:, :, : at + 1], SCALE)
    torch.testing.assert_close(got, trimmed, rtol=0, atol=0)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, at + 1 :] = 7.0
    v2[:, :, at + 1 :] = -7.0
    assert torch.equal(da.decode_attention(q, k2, v2, SCALE, pos), got)


def test_the_plain_path_is_the_attention_modules():
    """``_reference_decode_attention`` is what ``MultiHeadAttention`` runs on
    the CPU for a token against a held cross K/V."""
    attn = tmodel.MultiHeadAttention(128, 2).eval()
    x = torch.randn((3, 1, 128)).bfloat16()
    k = torch.randn((3, 2, 5, 64)).bfloat16()
    v = torch.randn((3, 2, 5, 64)).bfloat16()
    with torch.no_grad():
        got = attn(x, xa_kv=(k, v))
        q = attn.query(x).view(3, 1, 2, 64)
        want = attn.out(da._reference_decode_attention(q, k, v, SCALE).reshape(3, 1, 128))
    assert torch.equal(got, want)


def _tiny(dtype=torch.bfloat16):
    return Whisper(TINY, dtype=dtype).init_weights(torch.Generator().manual_seed(4)).eval()


def test_held_storage_is_the_compute_dtype():
    """The decode holds the cross K/V in the compute dtype: the model's own,
    and a caller's f32 K/V cast into it (an f32 copy of the model's own
    exactly); float8 when asked; the logit table is the embedding in the
    compute dtype."""
    model = _tiny()
    states = torch.randn((2, TINY.n_audio_ctx, TINY.n_audio_state)).bfloat16()
    own = model.precompute_cross_kv(states)
    assert {t.dtype for kv in tgen.decode_cross_kv(model, states) for t in kv} == {torch.bfloat16}
    upcast = [(k.float(), v.float()) for k, v in own]
    held = tgen.decode_cross_kv(model, states, upcast)
    assert all(torch.equal(h, o) for hk, ok in zip(held, own) for h, o in zip(hk, ok))
    off = [(k.float() + 1e-4, v.float()) for k, v in own]
    held = tgen.decode_cross_kv(model, states, off)
    assert all(torch.equal(h, o.bfloat16()) for hk, ok in zip(held, off) for h, o in zip(hk, ok))
    assert {t.dtype for kv in tgen.decode_cross_kv(model, states, own, F8) for t in kv} == {F8}
    assert model.decoder.logit_table().dtype == torch.bfloat16
    f32 = _tiny(torch.float32)
    assert {t.dtype for kv in tgen.decode_cross_kv(f32, states.float()) for t in kv} == {
        torch.float32}
    assert f32.decoder.logit_table().dtype == torch.float32


def test_step_logits_of_the_bf16_table_equal_its_f32_upcast():
    """On the CPU the bf16 table is upcast: the same operands, the same
    f32 product, bit-equal logits."""
    model = _tiny()
    x = torch.randn((3, 1, TINY.n_text_state)).bfloat16()
    got = step_logits(x, model.decoder.logit_table())
    want = x.float() @ model.decoder.logit_table().float().T
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_greedy_decode_with_an_f32_copy_of_the_cross_kv_is_unchanged():
    """A bf16 model's greedy decode given an f32 copy of its own cross K/V
    (cast into the held bf16, where it is exact) equals the decode that makes
    its own, bit for bit."""
    model = _tiny()
    states = torch.randn((2, TINY.n_audio_ctx, TINY.n_audio_state)).bfloat16()
    prompt = [1, 2]
    own = tgen.greedy_decode(model, states, TINY, prompt=prompt, max_len=12, eot=63)
    upcast = [(k.float(), v.float()) for k, v in model.precompute_cross_kv(states)]
    got = tgen.greedy_decode(model, states, TINY, prompt=prompt, max_len=12, eot=63,
                             xa_kv=upcast)
    for key in own:
        assert torch.equal(got[key], own[key]), key
