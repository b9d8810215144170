"""The ranks' side of tests/test_torch_tp.py: the tensor-parallel encoder
(plain and sequence parallel), the TP greedy decode, the TP train step and
the bf16 encoder on every (model, data) mesh the world holds, on the
weights and inputs the test carried from the JAX package
(``<workdir>/inputs.pt``). Imports the port only."""

import torch
import torch.distributed as dist

from wealy_tpu_torch.losses import get_loss
from wealy_tpu_torch.models.heads import ProjectionHead
from wealy_tpu_torch.models.whisper import model as wmodel
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.model import Whisper, WhisperEncoder
from wealy_tpu_torch.parallel.mesh import all_gather
from wealy_tpu_torch.parallel.tp import (
    make_tp_mesh,
    param_shard_dim,
    tp_decode_fn,
    tp_encode_fn,
    tp_module,
)
from wealy_tpu_torch.train.finetune import EncoderHead, encoder_head_call
from wealy_tpu_torch.train.state import TrainState, make_optimizer
from wealy_tpu_torch.train.step import make_train_step

ENC = dict(n_mels=8, n_audio_ctx=16, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
           n_vocab=64, n_text_ctx=8, n_text_state=64, n_text_head=4, n_text_layer=1)
DEC = dict(ENC, n_audio_layer=1, n_text_layer=2)
BF16 = dict(ENC, n_audio_ctx=256)
PROMPT, EOT, MAX_LEN = [1, 2], 63, 6
STEPS = 2


def meshes(world: int) -> list:
    """(n_model, n_data) of every mesh of the world with a model axis of 2
    or 4."""
    return [(m, world // m) for m in (2, 4) if m <= world and world % m == 0]


def _encoder(cfg: dict, sd: dict, dtype=torch.float32):
    enc = WhisperEncoder(WhisperConfig(**cfg), dtype=dtype)
    enc.load_state_dict(sd)
    return enc.eval()


def _train(inp: dict, mesh) -> dict:
    """STEPS steps of the TP encoder + head; the losses and every f32
    master, the split ones gathered whole."""
    enc = tp_module(_encoder(ENC, inp["enc"]), mesh)
    head = ProjectionHead(ENC["n_audio_state"], zdim=16, hidden=(16,))
    head.load_state_dict(inp["head"])
    state = TrainState(EncoderHead(enc, head),
                       make_optimizer(lr=1e-3, warmup_steps=1, max_steps=10))
    step = make_train_step(None, get_loss("clews"), mesh=mesh, model_call=encoder_head_call)
    losses = []
    for _ in range(STEPS):
        state, ld = step(state, inp["batch"])
        losses.append(float(ld["loss"]))
    params = {n: (m if param_shard_dim(n) is None
                  else all_gather(mesh, m.contiguous(), "model", param_shard_dim(n)))
              for n, m in state.params.items()}
    return {"losses": losses, "params": params,
            "moment_shape": tuple(state.opt_state["mu"]["encoder.blocks.0.mlp.0.weight"].shape)}


def run(ports, workdir) -> dict:
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    res = {"world": dist.get_world_size()}
    for nm, nd in meshes(dist.get_world_size()):
        mesh = make_tp_mesh(nm, nd, device="cpu")
        enc = _encoder(ENC, inp["enc"])
        shapes = []
        with torch.no_grad():
            res[("enc", nm)] = tp_encode_fn(enc, mesh)(inp["mel"])
            sp = tp_encode_fn(enc, mesh, sequence_parallel=True)
            hooks = [b.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape)))
                     for b in sp.module.blocks]
            res[("sp", nm)] = sp(inp["mel"])
            for h in hooks:
                h.remove()
            res[("scan", nm)] = tp_encode_fn(_encoder(ENC, inp["enc_scanned"]), mesh)(inp["mel"])
        res[("sp_shapes", nm)] = shapes
        res[("shard", nm)] = tuple(tp_module(enc, mesh).blocks[0].mlp[0].weight.shape)
        dec = Whisper(WhisperConfig(**DEC), dtype=torch.float32)
        dec.load_state_dict(inp["dec"])
        res[("dec", nm)] = tp_decode_fn(dec.eval(), mesh, WhisperConfig(**DEC), PROMPT,
                                        max_len=MAX_LEN, eot=EOT)(inp["mel_d"])
        if nm == 2:
            res["train"] = _train(inp, mesh)
        # bf16 at T 256: K2 and K3 entered on the rank's shard (their plain
        # versions on the CPU)
        calls = []
        fused, flash = wmodel.fused_mlp, wmodel.flash_mha

        def rec_mlp(h, w1, b1, w2, b2):
            calls.append(("fused_mlp", tuple(w1.shape), float(b2.abs().max())))
            return fused(h, w1, b1, w2, b2)

        def rec_attn(q, k, v, scale):
            calls.append(("flash_mha", tuple(q.shape)))
            return flash(q, k, v, scale)

        wmodel.fused_mlp, wmodel.flash_mha = rec_mlp, rec_attn
        with torch.no_grad():
            res[("bf16", nm)] = tp_encode_fn(_encoder(BF16, inp["enc16"], torch.bfloat16),
                                             mesh)(inp["mel16"]).float()
        wmodel.fused_mlp, wmodel.flash_mha = fused, flash
        res[("bf16_calls", nm)] = calls
    return res
