"""Port of the Whisper model and greedy decode (wealy_tpu_torch.models.whisper)
against the JAX package: one seeded JAX init, carried into the port by
state_dict_from_jax_params, the same numpy inputs through both."""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.models.whisper import WHISPER_CONFIGS as J_CONFIGS
from wealy_tpu.models.whisper import Whisper as JWhisper
from wealy_tpu.models.whisper import WhisperConfig
from wealy_tpu.models.whisper.generate import greedy_decode as j_greedy_decode
from wealy_tpu.models.whisper.generate import init_kv_caches as j_init_kv_caches
from wealy_tpu_torch.cli.extract import load_whisper_model
from wealy_tpu_torch.models.whisper import WHISPER_CONFIGS, load_openai_state_dict
from wealy_tpu_torch.models.whisper import state_dict_from_hf, state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.generate import decode_cross_kv, greedy_decode, init_kv_caches
from wealy_tpu_torch.models.whisper.model import Whisper

from _torch_parity import jax_and_port_whisper, min_row_cosine, to_numpy

# f32 activation parity (the JAX model meets these against transformers)
RTOL = ATOL = 1e-4
# bf16: roundings happen at other places in the two frameworks
COS_MIN = 0.999

CFG = WhisperConfig(
    n_mels=80, n_audio_ctx=96, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=100, n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=2,
)
TOKENS = np.array([[5, 17, 3, 99, 42], [1, 2, 3, 4, 5]], np.int32)


@pytest.fixture(scope="module")
def f32_pair():
    return jax_and_port_whisper(CFG, "float32", seed=0)


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(1)
    return rng.normal(size=(2, 80, 2 * CFG.n_audio_ctx)).astype(np.float32) * 0.5


def _jax_enc(jmodel, params, mel):
    return jmodel.apply({"params": params}, jnp.asarray(mel), method=JWhisper.encode)


def test_encoder_f32_matches_jax(f32_pair, mel):
    jmodel, params, port = f32_pair
    want = np.asarray(_jax_enc(jmodel, params, mel))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, CFG.n_audio_ctx, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_decoder_teacher_forced_f32_matches_jax(f32_pair, mel):
    jmodel, params, port = f32_pair
    want_h, want_l, want_all = jmodel.apply(
        {"params": params}, TOKENS, _jax_enc(jmodel, params, mel),
        return_all_hiddens=True, method=JWhisper.decode,
    )
    with torch.no_grad():
        states = port.encode(torch.from_numpy(mel))
        got_h, got_l, got_all = port.decode(
            torch.from_numpy(TOKENS).long(), states, return_all_hiddens=True
        )
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-3, atol=1e-3)
    assert got_all.shape == (CFG.n_text_layer + 1, 2, 5, 64)
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), rtol=RTOL, atol=ATOL)


def test_incremental_decode_f32_matches_jax(f32_pair, mel):
    """Prefill 3 tokens, then 2 single steps, against the JAX KV cache."""
    jmodel, params, port = f32_pair
    jstates = _jax_enc(jmodel, params, mel)
    caches = j_init_kv_caches(CFG, 2, 8, dtype=jnp.float32)
    want = []
    for start, stop in ((0, 3), (3, 4), (4, 5)):
        h, _, caches = jmodel.apply(
            {"params": params}, TOKENS[:, start:stop], jstates,
            kv_caches=caches, cache_index=start, method=JWhisper.decode,
        )
        want.append(np.asarray(h))
    tcaches = init_kv_caches(CFG, 2, 8, dtype=torch.float32)
    got = []
    with torch.no_grad():
        states = port.encode(torch.from_numpy(mel))
        xa_kv = port.precompute_cross_kv(states)
        for start, stop in ((0, 3), (3, 4), (4, 5)):
            # the prefill at 0, then one-token steps at a device index
            h, _, tcaches = port.decode(
                torch.from_numpy(TOKENS[:, start:stop]).long(), None,
                kv_caches=tcaches, cache_index=torch.tensor([start]) if start else 0,
                xa_kv=xa_kv,
            )
            got.append(h.numpy())
    np.testing.assert_allclose(
        np.concatenate(got, 1), np.concatenate(want, 1), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("suppress", [None, (5, 17, 42)])
def test_greedy_decode_f32_matches_jax(f32_pair, mel, suppress):
    jmodel, params, port = f32_pair
    want = j_greedy_decode(
        jmodel, params, _jax_enc(jmodel, params, mel), CFG, prompt=[7, 8], max_len=12,
        eot=99, suppress_tokens=suppress,
    )
    with torch.no_grad():
        got = greedy_decode(
            port, port.encode(torch.from_numpy(mel)), CFG, prompt=[7, 8], max_len=12,
            eot=99, suppress_tokens=suppress,
        )
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(want["hidden"]),
                               rtol=RTOL, atol=ATOL)
    for key in ("sum_logprob", "nospeech_prob"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5)


def test_hoisted_decode_operands_change_nothing(mel):
    """greedy_decode makes the cross K/V (held in the compute dtype) and the
    logit table (the embedding in the compute dtype) once per call; a bf16
    step given them, or their f32 upcasts, equals one that makes its own."""
    port = Whisper(CFG, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(5))
    outs = []
    with torch.no_grad():
        states = port.eval().encode(torch.from_numpy(mel))
        xa_kv = port.precompute_cross_kv(states)
        hoisted = dict(xa_kv=decode_cross_kv(port, states),
                       logit_weight=port.decoder.logit_table())
        upcast = dict(xa_kv=[(k.float(), v.float()) for k, v in xa_kv],
                      logit_weight=port.decoder.logit_table().float())
        assert {t.dtype for kv in hoisted["xa_kv"] for t in kv} == {torch.bfloat16}
        assert hoisted["logit_weight"].dtype == torch.bfloat16
        for kw in (dict(xa_kv=xa_kv), hoisted, upcast):
            caches = init_kv_caches(CFG, 2, 8, dtype=torch.bfloat16)
            for start, stop in ((0, 3), (3, 4)):
                h, logits, caches = port.decode(
                    torch.from_numpy(TOKENS[:, start:stop]).long(), None,
                    kv_caches=caches, cache_index=torch.tensor([start]) if start else 0, **kw,
                )
            outs.append((h, logits))
    for h, logits in outs[1:]:
        assert torch.equal(outs[0][0], h)
        assert torch.equal(outs[0][1], logits)


def test_scanned_jax_layout_converts():
    """The CLI's default scanned (blocks/block) JAX params load identically."""
    jmodel, params, port = jax_and_port_whisper(CFG, "float32", seed=3, scan_layers=True)
    assert "blocks" in params["encoder"]
    rng = np.random.default_rng(2)
    mel = rng.normal(size=(1, 80, 2 * CFG.n_audio_ctx)).astype(np.float32)
    want = np.asarray(_jax_enc(jmodel, params, mel))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_encoder_through_both_kernel_gates():
    """n_audio_ctx 256: self-attention takes flash_mha and the MLP fused_mlp
    (model.py:139,243) on both sides; on the CPU both wrappers run their
    plain versions."""
    cfg = dataclasses.replace(CFG, n_audio_ctx=256, n_audio_layer=1, n_text_layer=1)
    jmodel, params, port = jax_and_port_whisper(cfg, "bfloat16", seed=1)
    rng = np.random.default_rng(3)
    mel = rng.normal(size=(2, 80, 512)).astype(np.float32) * 0.5
    want = np.asarray(_jax_enc(jmodel, params, mel), np.float32)
    with torch.no_grad():
        got = to_numpy(port.encode(torch.from_numpy(mel)))
    assert got.shape == (2, 256, 64)
    assert min_row_cosine(got, want) >= COS_MIN


def test_bf16_decoder_matches_jax():
    cfg = dataclasses.replace(CFG, n_audio_layer=1)
    jmodel, params, port = jax_and_port_whisper(cfg, "bfloat16", seed=2)
    rng = np.random.default_rng(4)
    mel = rng.normal(size=(2, 80, 2 * cfg.n_audio_ctx)).astype(np.float32) * 0.5
    want_h, _ = jmodel.apply({"params": params}, jnp.asarray(mel), TOKENS)
    with torch.no_grad():
        got_h, _ = port(torch.from_numpy(mel), torch.from_numpy(TOKENS).long())
    assert min_row_cosine(to_numpy(got_h), np.asarray(want_h, np.float32)) >= COS_MIN


def test_param_dtypes():
    model = Whisper(CFG, dtype=torch.bfloat16)
    sd = model.state_dict()
    assert sd["encoder.blocks.0.attn.query.weight"].dtype == torch.bfloat16
    assert sd["encoder.conv1.weight"].dtype == torch.bfloat16
    for name in ("encoder.blocks.0.mlp.0.bias", "encoder.blocks.0.attn_ln.weight",
                 "encoder.positional_embedding", "decoder.token_embedding.weight",
                 "decoder.positional_embedding"):
        assert sd[name].dtype == torch.float32, name


def test_state_dict_names_cover_the_model(f32_pair):
    _, params, port = f32_pair
    sd = state_dict_from_jax_params(params)
    assert set(sd) == set(port.state_dict())
    assert sd["encoder.blocks.1.mlp.0.weight"].shape == (256, 64)
    assert "decoder.blocks.0.cross_attn.key.weight" in sd
    assert "decoder.blocks.0.cross_attn.key.bias" not in sd


def test_openai_checkpoint_roundtrip(f32_pair, tmp_path):
    _, _, port = f32_pair
    path = tmp_path / "ckpt.pt"
    torch.save({"dims": {}, "model_state_dict": port.state_dict()}, path)
    loaded = load_openai_state_dict(str(path))
    for k, v in port.state_dict().items():
        assert torch.equal(loaded[k], v.float()), k


def test_hf_names_map_to_openai():
    from transformers import WhisperConfig as HFConfig, WhisperModel

    torch.manual_seed(0)
    hf = WhisperModel(HFConfig(
        vocab_size=100, num_mel_bins=80, d_model=64, encoder_layers=1,
        encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=96,
        max_target_positions=32, pad_token_id=0, bos_token_id=0, eos_token_id=99,
        decoder_start_token_id=98,
    ))
    port = Whisper(dataclasses.replace(CFG, n_audio_layer=1, n_text_layer=1),
                   dtype=torch.float32)
    port.load_state_dict(load_openai_state_dict(hf.state_dict()))
    assert torch.equal(
        port.state_dict()["decoder.blocks.0.cross_attn.query.weight"],
        hf.state_dict()["decoder.layers.0.encoder_attn.q_proj.weight"],
    )
    assert set(state_dict_from_hf(hf.state_dict())) == set(port.state_dict())


def test_load_whisper_model_seeded():
    a, cfg = load_whisper_model("dev", seed=5, device="cpu")
    b, _ = load_whisper_model("dev", seed=5, device="cpu")
    c, _ = load_whisper_model("dev", seed=6, device="cpu")
    key = "encoder.blocks.0.attn.query.weight"
    assert cfg == WHISPER_CONFIGS["dev"]
    assert torch.equal(a.state_dict()[key], b.state_dict()[key])
    assert not torch.equal(a.state_dict()[key], c.state_dict()[key])
    assert torch.equal(a.state_dict()["encoder.ln_post.weight"], torch.ones(64))


def test_configs_identical_to_jax():
    assert WHISPER_CONFIGS.keys() == J_CONFIGS.keys()
    for name, cfg in WHISPER_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_CONFIGS[name]), name
        assert (cfg.sot, cfg.eot, cfg.token_no_timestamps, cfg.token_nospeech) == (
            J_CONFIGS[name].sot, J_CONFIGS[name].eot,
            J_CONFIGS[name].token_no_timestamps, J_CONFIGS[name].token_nospeech,
        )


def test_encoder_stream_is_row_major(mel):
    """The stem writes the (B, T, D) stream row-major (not the transposed
    view of the conv's (B, D, T) output), and each block keeps it so."""
    from wealy_tpu_torch.models.whisper.model import _ln

    for dtype in (torch.float32, torch.bfloat16):
        enc = Whisper(CFG, dtype=dtype).init_weights(torch.Generator().manual_seed(4)).encoder
        with torch.no_grad():
            x = enc.stem(torch.from_numpy(mel))
            assert x.shape == (2, CFG.n_audio_ctx, 64) and x.is_contiguous(), x.stride()
            for block in enc.blocks:
                x, h = block(x, h=_ln(block.attn_ln, x), next_ln=enc.ln_post)
                assert x.is_contiguous() and h.is_contiguous(), (x.stride(), h.stride())


def _k6_route_on_cpu(monkeypatch, launches: list):
    """The Whisper blocks' K6 route taken on the CPU: ``takes`` says yes and
    each of K6's two launches runs the model's route off K6 (tensors
    without a graph, as the kernel returns) and counts, as the kernel
    does."""
    from wealy_tpu_torch.models.whisper import model as tmodel
    from wealy_tpu_torch.ops import layer_norm as tln

    def launch_ln(x, scale, bias, eps):
        launches.append("ln")
        tln.fused_layer_norm.launches += 1
        return tln._aten_ln(x, scale, bias, eps).detach()

    def launch_add_ln(x, y, scale, bias, eps):
        launches.append("add_ln")
        tln.fused_layer_norm.launches += 1
        return tuple(t.detach() for t in tln._aten_add_ln(x, y, scale, bias, eps))

    monkeypatch.setattr(tmodel, "k6_takes", lambda x: True)
    monkeypatch.setattr(tln, "_kernel_route", lambda t: True)
    monkeypatch.setattr(tln, "_launch_ln", launch_ln)
    monkeypatch.setattr(tln, "_launch_add_ln", launch_add_ln)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k6_route_gives_the_plain_numbers(monkeypatch, mel, dtype):
    """Through the K6 route (its launches run the route off K6 here) the
    encoder states, the teacher-forced hidden states and logits and the
    cached prefill and step equal the route off K6 exactly: each LayerNorm
    reads the same sum; the encoder makes 2 * n_layer + 1 K6 passes (the
    first attn_ln alone, every residual add fused) and its
    ``whisper.encoder_ln`` span reads 1 (0 off K6); the decoder 3 * n_layer
    + 1."""
    from wealy_tpu_torch.utils import profiling

    port = Whisper(CFG, dtype=dtype).init_weights(torch.Generator().manual_seed(6)).eval()
    tokens = torch.from_numpy(TOKENS).long()

    def run():
        t0 = time.perf_counter()
        with torch.no_grad():
            states = port.encode(torch.from_numpy(mel))
            spans = [e.n for e in profiling.spans(since=t0) if e.name == "whisper.encoder_ln"]
            taught = port.decode(tokens, states, return_all_hiddens=True)
            caches = init_kv_caches(CFG, 2, 8, dtype=dtype)
            xa_kv = port.precompute_cross_kv(states)
            cached = []
            for start, stop in ((0, 3), (3, 4)):
                h, logits, caches = port.decode(
                    tokens[:, start:stop], None, kv_caches=caches,
                    cache_index=torch.tensor([start]) if start else 0, xa_kv=xa_kv)
                cached += [h, logits]
        return [states, *taught, *cached], spans

    want, plain_spans = run()
    launches = []
    _k6_route_on_cpu(monkeypatch, launches)
    got, k6_spans = run()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    L = CFG.n_audio_layer
    assert plain_spans == [0] and k6_spans == [1]
    encoder = launches[: 2 * L + 1]
    assert encoder == ["ln"] + ["add_ln"] * 2 * L
    # teacher forcing: the final LayerNorm alone, in f32; prefill and step:
    # fused with the last residual add
    M = CFG.n_text_layer
    assert launches[2 * L + 1:] == (["ln"] + ["add_ln"] * (3 * M - 1) + ["ln"]
                                    + (["ln"] + ["add_ln"] * 3 * M) * 2)
