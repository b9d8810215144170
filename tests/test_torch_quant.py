"""CPU parity of the port's int8 W8A8 encoder (wealy_tpu_torch/models/whisper/
quant.py) with the JAX package's (wealy_tpu/models/whisper/quant.py), at the
JAX test's config (64 wide, 3 layers, 8 mels), from the same seeded weights
carried across by the weight bridge and the same numpy mel.

Tolerances: int8 weights and scales EQUAL to ``quantize_encoder_params``'s;
the port's f32 int8 forward within 1e-3 relative of ``quant_encode_fn`` (it
measured 2.1e-7 for the scanned layout's weights and 6.0e-5 for the
``block_i`` layout's on the CPU: the sums run in another order, and the
tolerance absorbs an activation code flipped at a .5 tie); the
JAX test's bounds against the port's own f32 encoder (relative hidden error
< 0.08, pooled cosine > 0.99); the CLI's ``x_concat`` rows cosine >= 0.999
against the JAX CLI's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.cli.main import main as jax_main
from wealy_tpu.data.embedding_store import EmbeddingStore as JStore
from wealy_tpu.models.whisper.config import WhisperConfig as JWhisperConfig
from wealy_tpu.models.whisper.model import WhisperEncoder as JWhisperEncoder
from wealy_tpu.models.whisper.quant import quant_encode_fn, quantize_encoder_params
from wealy_tpu_torch.cli.main import main as port_main
from wealy_tpu_torch.data.embedding_store import EmbeddingStore
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.convert import encoder_state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.model import Whisper, WhisperEncoder
from wealy_tpu_torch.models.whisper.quant import (
    DENSE,
    QuantWhisperEncoder,
    f32_encoder_state_dict,
    load_quant_encoder,
    qdense,
    quantize_encoder_state_dict,
)

SIZES = dict(n_mels=8, n_audio_ctx=32, n_audio_state=64, n_audio_head=4, n_audio_layer=3,
             n_vocab=64, n_text_ctx=8, n_text_state=64, n_text_head=4, n_text_layer=1)
JCFG, CFG = JWhisperConfig(**SIZES), WhisperConfig(**SIZES)
PARITY_RTOL = 1e-3
REL_MAX, COS_MIN = 0.08, 0.99  # tests/test_quant_encoder.py:42,49
CLI_COS_MIN = 0.999


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _pooled_cos(got, want) -> float:
    pg, pw = np.asarray(got).mean(axis=1), np.asarray(want).mean(axis=1)
    cos = (pw * pg).sum(-1) / (np.linalg.norm(pw, axis=-1) * np.linalg.norm(pg, axis=-1))
    return float(cos.min())


@pytest.fixture(scope="module", params=[True, False], ids=["scanned", "block_i"])
def ref(request):
    """(JAX params of one layout as numpy, the port's f32 state dict of the
    same weights, the mel (4, 8, 64))."""
    enc = JWhisperEncoder(JCFG, dtype=jnp.float32, scan_layers=request.param)
    mel = np.random.default_rng(0).normal(size=(4, CFG.n_mels, 64)).astype(np.float32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, encoder_state_dict_from_jax_params(params), mel


def _port_quant(sd, dtype=torch.float32):
    return QuantWhisperEncoder(CFG, quantize_encoder_state_dict(sd, CFG), dtype=dtype,
                               device="cpu").eval()


def test_weights_and_scales_equal_the_jax_quantisation(ref):
    params, sd, _ = ref
    want = quantize_encoder_params(params, JCFG)["layers"]
    got = quantize_encoder_state_dict(sd, CFG)["layers"]
    for name, _, has_bias in DENSE:
        w = np.stack([layer[name]["w"].T for layer in got])  # (L, in, out) as JAX
        np.testing.assert_array_equal(w, want[name]["w"])
        np.testing.assert_array_equal(np.stack([layer[name]["s"] for layer in got]),
                                      want[name]["s"])
        if has_bias:
            np.testing.assert_array_equal(np.stack([layer[name]["b"] for layer in got]),
                                          want[name]["b"])
        else:
            assert "b" not in want[name] and all("b" not in layer[name] for layer in got)


def test_the_encoder_subtree_of_a_full_tree(ref):
    """A full model's state dict (``encoder.`` names beside the decoder's)
    quantises as the encoder alone, as the JAX function takes the encoder
    subtree of a full tree."""
    params, sd, _ = ref
    full = {f"encoder.{k}": v for k, v in sd.items()}
    full["decoder.ln.weight"] = torch.ones(64)
    want = quantize_encoder_params({"encoder": params, "decoder": {}}, JCFG)["layers"]
    got = quantize_encoder_state_dict(full, CFG)["layers"]
    for name, _, _ in DENSE:
        np.testing.assert_array_equal(np.stack([layer[name]["w"].T for layer in got]),
                                      want[name]["w"])


def test_int8_forward_matches_quant_encode_fn(ref):
    params, sd, mel = ref
    want = np.asarray(quant_encode_fn(JCFG, dtype=jnp.float32)(
        quantize_encoder_params(params, JCFG), jnp.asarray(mel)))
    with torch.no_grad():
        got = _port_quant(sd)(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (4, 32, 64)
    assert _rel(got, want) <= PARITY_RTOL


def test_int8_within_the_jax_bounds_of_the_f32_encoder(ref):
    _, sd, mel = ref
    f32 = WhisperEncoder(CFG, dtype=torch.float32)
    f32.load_state_dict(sd)
    with torch.no_grad():
        want = f32(torch.from_numpy(mel)).numpy()
        got = _port_quant(sd)(torch.from_numpy(mel)).numpy()
    assert _rel(got, want) < REL_MAX
    assert _pooled_cos(got, want) > COS_MIN


def test_quantised_dtypes_and_shapes(ref):
    """int8 weights (out, in), f32 scales, and Whisper's ``k`` has no bias
    (tests/test_quant_encoder.py:80-90)."""
    _, sd, _ = ref
    q = _port_quant(sd, dtype=torch.bfloat16)
    for block in q.blocks:
        for name, _, has_bias in DENSE:
            lin = getattr(block, name)
            assert lin.weight.dtype == torch.int8 and lin.scale.dtype == torch.float32
            assert (lin.bias is not None) == has_bias
        assert block.fc1.weight.shape == (4 * 64, 64) and block.k.bias is None
    assert q.conv1.weight.dtype == torch.bfloat16 and q.blocks[0].attn_ln.weight.dtype == \
        torch.float32


@pytest.mark.parametrize("shape", [(3, 5, 64), (130, 256)])
def test_qdense_is_the_jax_arithmetic(shape):
    """``qdense`` against the JAX ``_qdense`` on the same arrays: the int8
    codes and the int32 product agree exactly, so the f32 result is equal
    up to the rescale's rounding."""
    from wealy_tpu.models.whisper.quant import _qdense, _quant_kernel

    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    # ties: rows whose values sit exactly on .5 codes
    x[..., 0, :8] = np.float32(127.0) * np.arange(-4, 4, dtype=np.float32) / 7.0 + 0.5
    k = rng.normal(size=(shape[-1], 48)).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    wq, s = _quant_kernel(k)
    want = np.asarray(_qdense(jnp.asarray(x), {"w": jnp.asarray(wq), "s": jnp.asarray(s),
                                               "b": jnp.asarray(b)}))
    got = qdense(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(wq.T)),
                 torch.from_numpy(s), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_seeded_route_quantises_the_f32_draw():
    """Without a checkpoint the int8 encoder is quantised from the f32 draw
    of ``load_whisper_model``'s seed (not from its bf16-rounded weights):
    the encoder weights of an f32 model from that seed, equal."""
    model = Whisper(CFG, dtype=torch.float32).init_weights(torch.Generator().manual_seed(0))
    want = {k: v for k, v in model.state_dict().items() if k.startswith("encoder.")}
    from wealy_tpu_torch.models.whisper import quant

    sizes = dict(quant.WHISPER_CONFIGS)
    quant.WHISPER_CONFIGS["_quant_test"] = CFG
    got = f32_encoder_state_dict("_quant_test", seed=0)
    quant.WHISPER_CONFIGS.clear()
    quant.WHISPER_CONFIGS.update(sizes)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    bf16 = {k: v.to(torch.bfloat16).float() for k, v in want.items()}
    q32 = quantize_encoder_state_dict(want, CFG)["layers"][0]["fc1"]["s"]
    q16 = quantize_encoder_state_dict(bf16, CFG)["layers"][0]["fc1"]["s"]
    assert not np.array_equal(q32, q16)  # the cast would change the scales


def test_load_quant_encoder_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_quant_encoder("dev")
    enc = load_quant_encoder("dev", device="cpu")
    assert enc.blocks[0].q.weight.device.type == "cpu"


# --- the CLI ----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_project(tmp_path_factory):
    """A two-song audio project and the dev Whisper's JAX init as a
    state-dict file, so that both CLIs quantise the same f32 weights
    (--hf-checkpoint). Returns (root, checkpoint, config writer)."""
    from wealy_tpu.models.whisper import WHISPER_CONFIGS

    from _torch_parity import jax_and_port_whisper, write_audio_project

    root = tmp_path_factory.mktemp("quant_cli")
    conf = write_audio_project(root)
    _, _, port = jax_and_port_whisper(WHISPER_CONFIGS["dev"], "float32", seed=0)
    ckpt = root / "dev_whisper.pt"
    torch.save(port.state_dict(), ckpt)
    return root, str(ckpt), conf


def test_cli_extract_quant_int8_matches_the_jax_cli(cli_project, capsys):
    root, ckpt, conf = cli_project
    confs = {name: conf(name) for name in ("q_port", "q_jax")}
    # batch 8: the JAX CLI shards each batch over the 8 virtual devices of the tests
    common = ["--split", "train", "--kinds", "x_concat", "--batched", "--batch-size", "8",
              "--quant-int8", "--hf-checkpoint", ckpt]
    assert port_main(["extract", "--config", confs["q_port"], *common, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(["extract", "--config", confs["q_jax"], *common]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["done"] == want["done"] == 2 and got["incomplete"] == []
    store, jstore = EmbeddingStore(root / "q_port", "lyric-covers"), JStore(root / "q_jax",
                                                                             "lyric-covers")
    from _torch_parity import min_row_cosine

    for v in ("100", "101"):
        a = store.load(v, "x_concat.npz")["embeddings"]
        b = jstore.load(v, "x_concat.npz")["embeddings"]
        assert a.shape == b.shape and min_row_cosine(a, b) >= CLI_COS_MIN


@pytest.mark.parametrize("flags", [
    ["--quant-int8"],
    ["--batched", "--quant-int8", "--kinds", "hs_last_seq"],
    ["--batched", "--quant-int8", "--kinds", "hs_last_seq_en"],
])
def test_cli_quant_int8_refusals_exit_2_as_jax(cli_project, capsys, flags):
    _, _, conf = cli_project
    argv = ["extract", "--config", conf("q_refuse"), *flags]
    assert jax_main(argv) == 2
    jax_err = capsys.readouterr().err
    assert port_main(argv) == 2
    assert capsys.readouterr().err == jax_err
