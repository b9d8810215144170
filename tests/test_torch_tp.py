"""Tensor parallelism of the port (wealy_tpu_torch/parallel/tp.py) on 2 and
4 gloo CPU ranks, held against the JAX package's tensor-parallel paths on
the 8 virtual devices (tests/test_tp.py), on weights carried across by
``state_dict_from_jax_params``:

- the split rules name the same parameters as the JAX ``_RULES`` (torch's
  ``(out, in)`` weights transposed), ``attn.key`` has no bias, and each
  rank holds its contiguous shard;
- the TP encoder, plain and sequence parallel (the residual stream between
  blocks holds ``T / n`` steps), from an unrolled and from a scanned JAX
  checkpoint, equals the JAX TP encoder (rtol 1e-4, atol 1e-5);
- the TP greedy decode gives the JAX tokens, hidden states within 1e-4;
- two TP train steps give the JAX losses (1e-5) and parameters (rtol
  1e-4, atol 1e-5), the AdamW moments in the shard layout;
- the bf16 encoder at T 256 equals the JAX bf16 TP encoder within 0.05, and
  it enters K2 and K3 at the shard's heads and columns with a zero b2 (the
  JAX package keeps its Pallas kernels off under TP instead).

One spawn per world size runs every case (tests/_torch_tp_cases.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.losses import clews_loss
from wealy_tpu.models.heads import ProjectionHead as JHead
from wealy_tpu.models.whisper import WhisperConfig as JConfig
from wealy_tpu.models.whisper.convert import stack_block_params
from wealy_tpu.models.whisper.generate import greedy_decode as j_greedy
from wealy_tpu.models.whisper.model import Whisper as JWhisper
from wealy_tpu.models.whisper.model import WhisperEncoder as JEncoder
from wealy_tpu.parallel.tp import make_tp_mesh as j_tp_mesh
from wealy_tpu.parallel.tp import shard_params as j_shard
from wealy_tpu.parallel.tp import tp_decode_fn as j_tp_decode
from wealy_tpu.parallel.tp import tp_encode_fn as j_tp_encode
from wealy_tpu.parallel.tp import whisper_param_shardings as j_shardings
from wealy_tpu.train import make_train_step as j_train_step
from wealy_tpu.train.state import TrainState as JState
from wealy_tpu.train.state import make_optimizer as j_optimizer
from wealy_tpu.train.step import shard_batch as j_shard_batch
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.convert import (
    encoder_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from wealy_tpu_torch.models.whisper.model import Whisper
from wealy_tpu_torch.parallel.tp import param_shard_dim, whisper_param_shardings

import _torch_tp_cases as cases
from _torch_parity import spawn_ranks

RTOL, ATOL = 1e-4, 1e-5


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX references (TP paths on the virtual mesh) and the inputs
    file of the ranks."""
    cfg, dcfg, bcfg = JConfig(**cases.ENC), JConfig(**cases.DEC), JConfig(**cases.BF16)
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(4, 8, 32)).astype(np.float32)
    enc = JEncoder(cfg, dtype=jnp.float32)
    params = jax.device_get(enc.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"])
    mesh = j_tp_mesh(n_model=2, n_data=4)
    ref = {"enc": _np(enc.apply({"params": params}, mel)),
           "tp_enc": _np(j_tp_encode(enc, mesh)(j_shard(params, mesh), mel)),
           "sp_enc": _np(j_tp_encode(enc, mesh, sequence_parallel=True)(
               j_shard(params, mesh), mel))}
    scanned = stack_block_params(jax.tree_util.tree_map(np.asarray, dict(params)),
                                 cfg.n_audio_layer)
    ref["shardings"] = j_shardings(params, mesh)

    # decode (tests/test_tp.py::TestTPDecode)
    dmodel = JWhisper(dcfg, dtype=jnp.float32)
    mel_d = np.random.default_rng(3).normal(size=(8, 8, 32)).astype(np.float32)
    dparams = jax.device_get(dmodel.init(jax.random.PRNGKey(0), jnp.asarray(mel_d),
                                         jnp.zeros((8, 2), jnp.int32))["params"])
    ref["dec"] = j_tp_decode(dmodel, j_tp_mesh(n_model=2, n_data=4), dcfg, cases.PROMPT,
                             max_len=cases.MAX_LEN, eot=cases.EOT)(
        j_shard(dparams, j_tp_mesh(n_model=2, n_data=4)), mel_d)
    states = dmodel.apply({"params": dparams}, mel_d, method=JWhisper.encode)
    ref["dec1"] = j_greedy(dmodel, dparams, states, dcfg, prompt=cases.PROMPT,
                           max_len=cases.MAX_LEN, eot=cases.EOT)

    # train (tests/test_tp.py::TestTPTraining), STEPS steps on the TP mesh
    head = JHead(zdim=16, hidden=(16,), dtype=jnp.float32)
    B = 8
    mel_t = np.random.default_rng(0).normal(size=(B, 8, 32)).astype(np.float32)
    h0 = jnp.zeros((B, cfg.n_audio_ctx, cfg.n_audio_state), jnp.float32)
    head_p = jax.device_get(head.init(jax.random.PRNGKey(1), h0,
                                      jnp.ones((B, cfg.n_audio_ctx), bool))["params"])
    batch = {"emb": mel_t, "labels": np.repeat(np.arange(B // 2), 2).astype(np.int32),
             "ids": np.arange(B, dtype=np.int32)}

    def model_call(p, b):
        s = enc.apply({"params": p["encoder"]}, b["emb"])
        return head.apply({"params": p["head"]}, s, jnp.ones(s.shape[:2], bool))

    tx = j_optimizer(lr=1e-3, warmup_steps=1, max_steps=10)
    sp = j_shard({"encoder": params, "head": head_p}, mesh)
    state = JState(step=jnp.zeros((), jnp.int32), params=sp, opt_state=tx.init(sp), tx=tx)
    step = j_train_step(head, clews_loss, mesh=mesh, model_call=model_call)
    losses = []
    for _ in range(cases.STEPS):
        state, logs = step(state, j_shard_batch(dict(batch), mesh))
        losses.append(float(logs["loss"]))
    new = jax.device_get(state.params)
    ref["train"] = {"losses": losses,
                    "params": {**encoder_state_dict_from_jax_params(new["encoder"], "encoder."),
                               **{f"head.{k}": v for k, v in
                                  head_state_dict_from_jax_params(new["head"]).items()}}}

    # bf16 at T 256 (tests/test_tp.py::TestTPBf16)
    enc16 = JEncoder(bcfg, dtype=jnp.bfloat16, use_flash=False)
    mel16 = np.random.default_rng(7).normal(size=(4, 8, 512)).astype(np.float32)
    p16 = jax.device_get(enc16.init(jax.random.PRNGKey(0), jnp.asarray(mel16))["params"])
    mesh42 = j_tp_mesh(n_model=4, n_data=2)
    ref["bf16"] = _np(j_tp_encode(enc16, mesh42)(j_shard(p16, mesh42), mel16))

    work = tmp_path_factory.mktemp("tp")
    torch.save({
        "mel": torch.from_numpy(mel), "enc": encoder_state_dict_from_jax_params(params),
        "enc_scanned": encoder_state_dict_from_jax_params(scanned),
        "dec": state_dict_from_jax_params(dparams), "mel_d": torch.from_numpy(mel_d),
        "head": head_state_dict_from_jax_params(head_p), "batch": batch,
        "enc16": encoder_state_dict_from_jax_params(p16), "mel16": torch.from_numpy(mel16),
    }, work / "inputs.pt")
    return ref, work


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, jax_side):
    ref, work = jax_side
    out = work / f"world{request.param}"
    out.mkdir()
    (out / "inputs.pt").symlink_to(work / "inputs.pt")
    return ref, spawn_ranks("_torch_tp_cases", request.param, out)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


class TestShardingRules:
    def test_rule_assignment(self, jax_side):
        ref, _ = jax_side
        j = ref["shardings"]["block_0"]
        sd = Whisper(WhisperConfig(**cases.ENC), dtype=torch.float32).state_dict()
        dims = whisper_param_shardings(sd)
        # flax P(None, "model") on an (in, out) kernel = torch dim 0 of (out, in)
        for jname, tname in (("q", "query"), ("k", "key"), ("v", "value")):
            assert j["attn"][jname]["kernel"].spec == jax.sharding.PartitionSpec(None, "model")
            assert dims[f"encoder.blocks.0.attn.{tname}.weight"] == 0
        assert dims["encoder.blocks.0.attn.query.bias"] == 0 == dims[
            "encoder.blocks.0.attn.value.bias"]
        assert j["attn"]["out"]["kernel"].spec == jax.sharding.PartitionSpec("model", None)
        assert dims["encoder.blocks.0.attn.out.weight"] == 1
        assert dims["encoder.blocks.0.mlp.0.weight"] == 0 == dims["encoder.blocks.0.mlp.0.bias"]
        assert dims["encoder.blocks.0.mlp.2.weight"] == 1
        assert dims["decoder.blocks.0.cross_attn.query.weight"] == 0
        assert dims["decoder.blocks.0.cross_attn.out.weight"] == 1
        for name in ("encoder.blocks.0.attn_ln.weight", "encoder.conv1.weight",
                     "encoder.blocks.0.attn.out.bias", "encoder.blocks.0.mlp.2.bias",
                     "decoder.token_embedding.weight", "encoder.positional_embedding"):
            assert dims[name] is None, name
        # a head's own "mlp.0" outside the Whisper blocks stays whole
        assert param_shard_dim("head.mlp.0.weight") is None
        assert param_shard_dim("encoder.encoder.blocks.3.mlp.0.weight") == 0

    def test_k_has_no_bias_rule_needed(self, jax_side):
        ref, _ = jax_side
        assert "bias" not in ref["shardings"]["block_0"]["attn"]["k"]
        sd = Whisper(WhisperConfig(**cases.ENC), dtype=torch.float32).state_dict()
        assert "encoder.blocks.0.attn.key.bias" not in sd


class TestTPEncoder:
    def test_matches_unsharded(self, ranks):
        ref, results = ranks
        for res in results:
            for nm, _ in cases.meshes(res["world"]):
                _close(res[("enc", nm)], ref["tp_enc"])
                _close(res[("enc", nm)], ref["enc"])

    def test_params_actually_sharded(self, ranks):
        _, results = ranks
        for res in results:
            for nm, _ in cases.meshes(res["world"]):
                # (4D / n, D): the rank's mlp.0 columns, JAX's (D, 4D / n) kernel shard
                assert res[("shard", nm)] == (4 * 64 // nm, 64)

    def test_scanned_checkpoint_matches_unsharded(self, ranks):
        ref, results = ranks
        for res in results:
            for nm, _ in cases.meshes(res["world"]):
                _close(res[("scan", nm)], ref["enc"])


class TestSequenceParallel:
    def test_sp_matches_unsharded(self, ranks):
        ref, results = ranks
        for res in results:
            for nm, _ in cases.meshes(res["world"]):
                _close(res[("sp", nm)], ref["sp_enc"])

    def test_sp_constraint_actually_applied(self, ranks):
        """Between blocks the residual stream holds the rank's T / n steps
        (JAX: the ("data", "model", None) activation sharding)."""
        _, results = ranks
        for res in results:
            for nm, nd in cases.meshes(res["world"]):
                T = cases.ENC["n_audio_ctx"]
                assert res[("sp_shapes", nm)] == [(4 // nd, T // nm, 64)] * 2


class TestTPDecode:
    def test_greedy_decode_matches_unsharded(self, ranks):
        ref, results = ranks
        for res in results:
            for nm, _ in cases.meshes(res["world"]):
                got = res[("dec", nm)]
                for want in (ref["dec"], ref["dec1"]):
                    np.testing.assert_array_equal(got["tokens"].numpy(),
                                                  np.asarray(want["tokens"]))
                    err = float(np.abs(got["hidden"].numpy() - _np(want["hidden"])).max())
                    assert err < 1e-4, err
                    np.testing.assert_array_equal(got["lengths"].numpy(),
                                                  np.asarray(want["lengths"]))


class TestTPTraining:
    def test_tp_train_step_matches_single_device(self, ranks):
        ref, results = ranks
        want = ref["train"]
        for res in results:
            got = res["train"]
            assert np.abs(np.asarray(got["losses"]) - np.asarray(want["losses"])).max() < 1e-5
            assert set(got["params"]) == set(want["params"])
            for k, v in want["params"].items():
                np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=k)
            # the AdamW moments of the split mlp.0 weight keep the shard layout
            assert got["moment_shape"] == (4 * 64 // 2, 64)


class TestTPBf16:
    def test_bf16_encoder_seq256_tp_matches_unsharded(self, ranks):
        ref, results = ranks
        for res in results:
            for nm, _ in cases.meshes(res["world"]):
                _close(res[("bf16", nm)], ref["bf16"], rtol=0.05, atol=0.05)

    def test_kernels_run_on_the_shard(self, ranks):
        """K2 at the rank's H / n heads and K3 with its 4D / n columns and a
        zero b2 (the bias added once after the reduce)."""
        _, results = ranks
        for res in results:
            for nm, nd in cases.meshes(res["world"]):
                calls = res[("bf16_calls", nm)]
                mlp = [c for c in calls if c[0] == "fused_mlp"]
                attn = [c for c in calls if c[0] == "flash_mha"]
                assert len(mlp) == len(attn) == cases.BF16["n_audio_layer"]
                assert all(c[1] == (4 * 64 // nm, 64) and c[2] == 0.0 for c in mlp)
                assert all(c[1] == (4 // nd, 256, 4 // nm, 16) for c in attn)
