"""The port's graft entry (wealy_tpu_torch/graft_entry.py), the
counterpart of the repository's ``__graft_entry__.py``:

- ``entry()``'s forward (K1 mel, the bf16 whisper-tiny encoder, a bf16
  ``ProjectionHead(512)``) on the JAX entry's weights (flax init,
  PRNGKey(0), carried across) equals the JAX entry's forward on the CPU
  (row cosine >= 0.999, the port's bf16 gate); without a card it refuses
  to run unless asked for the CPU;
- ``dryrun_multichip(n, device="cpu")`` runs every stage of the JAX dry run
  on n gloo processes (2 and 4), each held against its one-rank result
  inside the ranks, and without n cards ``dryrun_multichip(n)`` raises
  rather than fall back to the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wealy_tpu.audio.mel import log_mel_spectrogram as j_mel
from wealy_tpu.models.heads import ProjectionHead as JHead
from wealy_tpu.models.whisper import WHISPER_CONFIGS as J_CONFIGS
from wealy_tpu.models.whisper import Whisper as JWhisper
from wealy_tpu_torch.graft_entry import dryrun_multichip, entry
from wealy_tpu_torch.models.convert import head_state_dict_from_jax_params
from wealy_tpu_torch.models.whisper.convert import state_dict_from_jax_params

from _torch_parity import min_row_cosine

# the stages of __graft_entry__.dryrun_multichip, each one line
STAGES = ("dp train step ok", "dp grad_accum=2 train step ok", "tp encode ok", "sp encode ok",
          "tp train step ok", "pp encode ok", "pp train step ok", "dp greedy decode ok",
          "tp greedy decode ok", "sharded retrieval ok", "ring attention ok",
          "sharded serving scorer ok")


def test_entry_forward_matches_jax():
    forward, (audio,) = entry(device="cpu")
    cfg = J_CONFIGS["tiny"]
    model = JWhisper(cfg, dtype=jnp.bfloat16)
    head = JHead(zdim=512, hidden=(512,), dtype=jnp.bfloat16)
    B = audio.shape[0]
    key = jax.random.PRNGKey(0)
    params = jax.device_get(model.init(key, jnp.zeros((B, cfg.n_mels, 3000), jnp.float32),
                                       jnp.zeros((B, 4), jnp.int32))["params"])
    enc0 = jnp.zeros((B, cfg.n_audio_ctx, cfg.n_audio_state), jnp.bfloat16)
    head_params = jax.device_get(head.init(key, enc0, jnp.ones((B, cfg.n_audio_ctx),
                                                               bool))["params"])
    forward.model.load_state_dict(state_dict_from_jax_params(params))
    forward.head.load_state_dict(head_state_dict_from_jax_params(head_params))

    x = jnp.asarray(audio.numpy())
    states = model.apply({"params": params}, j_mel(x, n_mels=cfg.n_mels), method=JWhisper.encode)
    want = np.asarray(head.apply({"params": head_params}, states,
                                 jnp.ones(states.shape[:2], bool)), np.float32)
    got = forward(audio)
    assert tuple(got.shape) == (B, 512) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert min_row_cosine(got.float().numpy(), want) >= 0.999


def test_entry_and_dryrun_refuse_without_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(n, capsys):
    lines = dryrun_multichip(n, device="cpu")
    assert len(lines) == len(STAGES)
    for line, stage in zip(lines, STAGES):
        assert line.startswith(f"dryrun_multichip({n}): {stage}"), (line, stage)
    assert capsys.readouterr().out.strip().splitlines() == lines
