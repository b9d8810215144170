"""Pipeline parallelism of the port (wealy_tpu_torch/parallel/pp.py) on
four gloo CPU ranks, held against the JAX package's GPipe encoder on the
virtual devices (tests/test_pp.py), on weights carried across by
``encoder_state_dict_from_jax_params``:

- every (stage, microbatch) layout, and (data 2, stage 2), equals the
  single-device JAX encoder (max error 1e-5); bf16 within 0.05;
- the gradients through the send/recv schedule equal the JAX gradients
  (rtol 1e-4, atol 1e-6), and a train step on (data 2, stage 2) gives
  the JAX pipelined train step's loss (1e-5) and parameters (rtol 1e-4,
  atol 1e-5), each data rank pipelining its own rows;
- the layer count must divide the stages and the batch the microbatches
  (the JAX ``ValueError``s); the port has no scan layout, so an unrolled
  JAX checkpoint pipelines as it is and a stacked one converts the same.

One spawn of four ranks runs every case (tests/_torch_pp_cases.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.losses import clews_loss
from wealy_tpu.models.heads import ProjectionHead as JHead
from wealy_tpu.models.whisper.config import WhisperConfig as JConfig
from wealy_tpu.models.whisper.convert import stack_block_params
from wealy_tpu.models.whisper.model import WhisperEncoder as JEncoder
from wealy_tpu.parallel.pp import make_pp_mesh as j_pp_mesh
from wealy_tpu.parallel.pp import pp_encode_fn as j_pp
from wealy_tpu.train import make_train_step as j_train_step
from wealy_tpu.train.state import TrainState as JState
from wealy_tpu.train.state import make_optimizer as j_optimizer
from wealy_tpu.train.step import shard_batch as j_shard_batch
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.convert import encoder_state_dict_from_jax_params
from wealy_tpu_torch.parallel.mesh import Mesh
from wealy_tpu_torch.parallel.pp import pp_encode_fn

import _torch_pp_cases as cases
from _torch_parity import spawn_ranks

CFG = JConfig(**cases.CFG)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    enc = JEncoder(CFG, dtype=jnp.float32, scan_layers=True)
    mel = np.random.default_rng(0).normal(size=(8, CFG.n_mels, 32)).astype(np.float32)
    params = jax.device_get(enc.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"])
    ref = {"want": np.asarray(jax.jit(lambda p, m: enc.apply({"params": p}, m))(params, mel))}
    enc16 = JEncoder(CFG, dtype=jnp.bfloat16, scan_layers=True)
    ref["bf16"] = np.asarray(enc16.apply({"params": params}, mel), np.float32)
    mesh4 = j_pp_mesh(4, devices=jax.devices()[:4])
    ref["pp_bf16"] = np.asarray(j_pp(enc16, mesh4, n_micro=2)(params, mel), np.float32)
    g = jax.grad(lambda p: (enc.apply({"params": p}, mel) ** 2).mean())(params)
    ref["grads"] = encoder_state_dict_from_jax_params(jax.device_get(g))

    # the pipelined train step (tests/test_pp.py::test_pp_train_step_matches_single_device)
    B = mel.shape[0]
    head = JHead(zdim=16, hidden=(16,), dtype=jnp.float32)
    head_p = jax.device_get(head.init(
        jax.random.PRNGKey(1), jnp.zeros((B, CFG.n_audio_ctx, CFG.n_audio_state)),
        jnp.ones((B, CFG.n_audio_ctx), bool))["params"])
    batch = {"emb": mel, "labels": np.repeat(np.arange(B // 2), 2).astype(np.int32),
             "ids": np.arange(B, dtype=np.int32)}
    mesh = j_pp_mesh(4, n_data=2, devices=jax.devices()[:8])
    pp = j_pp(enc, mesh, n_micro=2)

    def call_pp(p, b):
        s = pp(p, b["emb"])
        return head.apply({"params": p["head"]}, s, jnp.ones(s.shape[:2], bool))

    tx = j_optimizer(lr=1e-3, warmup_steps=1, max_steps=10)
    p0 = jax.tree_util.tree_map(jnp.asarray, {"encoder": params, "head": head_p})
    state = JState(step=jnp.zeros((), jnp.int32), params=p0, opt_state=tx.init(p0), tx=tx)
    step = j_train_step(head, clews_loss, mesh=mesh, model_call=call_pp)
    state, logs = step(state, j_shard_batch(dict(batch), mesh))
    losses = [float(logs["loss"])]
    new = jax.device_get(state.params)
    ref["train"] = {"losses": losses, "params": {
        **encoder_state_dict_from_jax_params(new["encoder"], "encoder."),
        **{f"head.{k}": v for k, v in head_state_dict_from_jax_params(new["head"]).items()}}}

    # an unrolled JAX checkpoint, and the same stacked
    enc_u = JEncoder(CFG, dtype=jnp.float32, scan_layers=False)
    mel_u = np.random.default_rng(1).normal(size=(4, CFG.n_mels, 32)).astype(np.float32)
    params_u = jax.device_get(enc_u.init(jax.random.PRNGKey(1), jnp.asarray(mel_u))["params"])
    ref["unrolled"] = np.asarray(enc_u.apply({"params": params_u}, mel_u))
    stacked = stack_block_params(jax.tree_util.tree_map(np.asarray, dict(params_u)),
                                 CFG.n_audio_layer)

    work = tmp_path_factory.mktemp("pp")
    torch.save({"mel": torch.from_numpy(mel), "enc": encoder_state_dict_from_jax_params(params),
                "head": head_state_dict_from_jax_params(head_p), "batch": batch,
                "enc_unrolled": encoder_state_dict_from_jax_params(params_u),
                "enc_stacked": encoder_state_dict_from_jax_params(stacked),
                "mel_u": torch.from_numpy(mel_u)}, work / "inputs.pt")
    return ref, spawn_ranks("_torch_pp_cases", 4, work)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_pp_matches_single_device(ranks, layout):
    ref, results = ranks
    for res in results:
        err = _err(res[layout], ref["want"])
        assert err < 1e-5, f"{layout}: max_err={err}"


def test_pp_bf16_production_dtype(ranks):
    ref, results = ranks
    for res in results:
        np.testing.assert_allclose(res["bf16"].numpy(), ref["bf16"], rtol=0.05, atol=0.05)
        np.testing.assert_allclose(res["bf16"].numpy(), ref["pp_bf16"], rtol=0.05, atol=0.05)


def test_pp_composes_with_dp(ranks):
    ref, results = ranks
    for res in results:
        assert _err(res["dp"], ref["want"]) < 1e-5


def test_pp_is_trainable(ranks):
    ref, results = ranks
    for res in results:
        assert set(res["grads"]) == set(ref["grads"])
        for k, v in ref["grads"].items():
            np.testing.assert_allclose(res["grads"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_pp_train_step_matches_single_device(ranks):
    ref, results = ranks
    want = ref["train"]
    for res in results:
        got = res["train"]
        assert np.abs(np.asarray(got["losses"]) - np.asarray(want["losses"])).max() < 1e-5
        assert got["rows"] == [4]  # each data rank pipelines its half of the batch
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def _mesh(n_stage: int) -> Mesh:
    """A one-process view of a (data 1, stage n) mesh: the shape checks
    run before any collective."""
    return Mesh(n_stage, 0, torch.device("cpu"), False, ("data", "stage"), (1, n_stage))


def test_pp_rejects_bad_shapes():
    from wealy_tpu_torch.models.whisper.config import WhisperConfig
    from wealy_tpu_torch.models.whisper.model import WhisperEncoder

    enc = WhisperEncoder(WhisperConfig(**cases.CFG), dtype=torch.float32)
    with pytest.raises(ValueError, match="not divisible"):
        pp_encode_fn(enc, _mesh(3))
    with pytest.raises(ValueError, match="n_micro"):
        pp_encode_fn(enc, _mesh(2), n_micro=3)(torch.zeros((8, CFG.n_mels, 32)))


def test_pp_takes_an_unrolled_checkpoint(ranks):
    """The JAX pipeline refuses an unrolled layout; the port has no scan
    layout and pipelines ``encoder.blocks`` of either checkpoint."""
    ref, results = ranks
    for res in results:
        assert _err(res["unrolled"], ref["unrolled"]) < 1e-5


def test_pp_from_stacked_unrolled_checkpoint(ranks):
    ref, results = ranks
    for res in results:
        assert _err(res["stacked"], ref["unrolled"]) < 1e-5
