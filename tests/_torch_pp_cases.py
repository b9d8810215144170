"""The ranks' side of tests/test_torch_pp.py: the GPipe encoder on every
(stage, microbatch) layout of four ranks, composed with data parallelism,
in bf16, its gradients and its train step, on the weights and inputs the
test carried from the JAX package (``<workdir>/inputs.pt``). Imports the
port only."""

import torch

from wealy_tpu_torch.losses import get_loss
from wealy_tpu_torch.models.heads import ProjectionHead
from wealy_tpu_torch.models.whisper.config import WhisperConfig
from wealy_tpu_torch.models.whisper.model import WhisperEncoder
from wealy_tpu_torch.parallel.pp import make_pp_mesh, pp_encode_fn
from wealy_tpu_torch.train.finetune import EncoderHead
from wealy_tpu_torch.train.state import TrainState, make_optimizer
from wealy_tpu_torch.train.step import make_train_step

CFG = dict(n_mels=8, n_audio_ctx=16, n_audio_state=32, n_audio_head=2, n_audio_layer=4,
           n_vocab=64, n_text_ctx=8, n_text_state=32, n_text_head=2, n_text_layer=1)
# (n_stage, n_data, n_micro) on four ranks: tests/test_pp.py's (2, 4), (4, 2), (4, 8)
LAYOUTS = ((2, 2, 4), (4, 1, 2), (4, 1, 8))


def encoder(sd: dict, dtype=torch.float32):
    enc = WhisperEncoder(WhisperConfig(**CFG), dtype=dtype)
    enc.load_state_dict(sd)
    return enc


def run(ports, workdir) -> dict:
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    mel = inp["mel"]
    res = {}
    with torch.no_grad():
        for S, nd, M in LAYOUTS:
            res[(S, nd, M)] = pp_encode_fn(encoder(inp["enc"]), make_pp_mesh(S, nd, "cpu"),
                                           n_micro=M)(mel)
        res["dp"] = pp_encode_fn(encoder(inp["enc"]), make_pp_mesh(2, 2, "cpu"), 2)(mel)
        res["bf16"] = pp_encode_fn(encoder(inp["enc"], torch.bfloat16),
                                   make_pp_mesh(4, 1, "cpu"), 2)(mel).float()
        res["unrolled"] = pp_encode_fn(encoder(inp["enc_unrolled"]), make_pp_mesh(4, 1, "cpu"),
                                       2)(inp["mel_u"])
        res["stacked"] = pp_encode_fn(encoder(inp["enc_stacked"]), make_pp_mesh(4, 1, "cpu"),
                                      2)(inp["mel_u"])
    enc = encoder(inp["enc"])
    pp = pp_encode_fn(enc, make_pp_mesh(4, 1, "cpu"), n_micro=2)
    names, params = zip(*enc.named_parameters())
    grads = torch.autograd.grad((pp(mel) ** 2).mean(), params)
    res["grads"] = dict(zip(names, grads))

    # one train step on (data 2, stage 2): encoder + head through pp.local
    enc = encoder(inp["enc"])
    head = ProjectionHead(CFG["n_audio_state"], zdim=16, hidden=(16,))
    head.load_state_dict(inp["head"])
    mesh = make_pp_mesh(2, 2, "cpu")
    pp = pp_encode_fn(enc, mesh, n_micro=2)
    rows = []

    def call_pp(model, batch):
        rows.append(batch["emb"].shape[0])
        states = pp.local(batch["emb"])
        return model.head(states, torch.ones(states.shape[:2], dtype=torch.bool))

    state = TrainState(EncoderHead(enc, head), make_optimizer(lr=1e-3, warmup_steps=1,
                                                              max_steps=10))
    step = make_train_step(None, get_loss("clews"), mesh=mesh, model_call=call_pp)
    state, ld = step(state, inp["batch"])
    losses = [float(ld["loss"])]
    res["train"] = {"losses": losses, "rows": rows,
                    "params": {k: v.clone() for k, v in state.params.items()}}
    return res
