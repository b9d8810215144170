"""The ranks' side of tests/test_torch_mesh_commands.py on two gloo CPU
ranks: the sharded similarity paths, the ``--shard`` query engine and
daemon, a train step's sharded rows, then ``extract --batched``,
``transcribe --batched`` and ``evaluate`` launched as ``torchrun``
launches them (one process group per command), on the inputs the test
wrote (``<workdir>/inputs.pt``). Imports the port only."""

import contextlib
import io
import json
import os
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from wealy_tpu_torch.cli import main as tcli
from wealy_tpu_torch.cli import serve as tserve
from wealy_tpu_torch.losses import get_loss
from wealy_tpu_torch.parallel.mesh import make_mesh
from wealy_tpu_torch.parallel.similarity import (
    sharded_pairwise_distance,
    sharded_topk,
    streaming_relevant_ranks,
)
from wealy_tpu_torch.train.config import Config
from wealy_tpu_torch.train.step import make_train_step

import _torch_dp_cases as dp_cases


def _similarity(inp: dict, mesh) -> dict:
    s = inp["sim"]
    out = {
        "dist": sharded_pairwise_distance(*s["dist"], mesh, mode="cossim"),
        "dist_blocked": sharded_pairwise_distance(*s["blocked"], mesh, mode="cos",
                                                  block_size=16),
        "topk": sharded_topk(*s["topk"], mesh, k=5, mode="cossim"),
        "topk_euc": sharded_topk(*s["topk_euc"], mesh, k=3, mode="euc"),
        "tie": sharded_topk(*s["tie"], mesh, k=6, mode="dotsim"),
        "tie_blocked": sharded_topk(*s["tie"], mesh, k=6, mode="dotsim", block_size=10),
    }
    for mode in ("cossim", "euc"):
        out[f"bu_{mode}"] = sharded_topk(*s["bu"], mesh, k=7, mode=mode)
        out[f"bb_{mode}"] = sharded_topk(*s["bu"], mesh, k=7, mode=mode, block_size=16)
    sets, labels, mask = s["sets"]
    out["sets"] = streaming_relevant_ranks(sets, sets, labels, labels, mesh=mesh, mode="cos",
                                           redux="smean", block_size=4, query_block=4,
                                           query_mask=mask, corpus_mask=mask, device="cpu")
    z, labels = s["host"]
    out["host"] = streaming_relevant_ranks(z, z, labels, labels, mesh=mesh, mode="cossim",
                                           block_size=10, query_block=16, device="cpu")
    return out


def _serve(inp: dict, mesh, world: int) -> dict:
    sv = inp["serve"]
    config = Config.from_dict(json.loads(Path(sv["cpath"]).read_text()))
    eng = tserve.QueryEngine(config, sv["index"], sv["head"], block_size=2, device="cpu",
                             mesh=mesh)
    out = {"n_local": eng._sets_dev.shape[0],
           "search": [eng.search(sv["seq"], k=4, **kw) for kw in sv["options"]]}
    # the daemon: rank 0 serves and broadcasts, rank 1 follows until it stops
    os.environ["WORLD_SIZE"] = str(world)
    args = tcli.build_parser().parse_args(
        ["serve", "--config", sv["cpath"], "--index", sv["index"], "--checkpoint", sv["head"],
         "--shard", "--block-size", "2", "--port", "0", "--device", "cpu"])
    answers = []
    with tserve.serving(args) as daemon:
        if daemon is not None:
            for path, body in (("/query", {"embeddings": sv["seq"].tolist(), "k": 4}),
                               ("/reload", {}),
                               ("/query", {"embeddings": sv["seq"].tolist(), "k": 4})):
                req = urllib.request.Request(daemon.url + path, json.dumps(body).encode(),
                                             {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    answers.append(json.loads(r.read()))
    out["daemon"] = answers
    return out


def _cli(argv: list, port: int, rank: int, world: int) -> list:
    """One command of the port's CLI as torchrun launches it; its stdout
    lines."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(argv)
    return [rc, buf.getvalue().strip().splitlines()]


def run(ports, workdir) -> dict:
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(device="cpu")
    res = {"sim": _similarity(inp, mesh), "serve": _serve(inp, mesh, world)}

    # the train step's batch arrives sharded: each rank embeds its rows
    rows = []

    def call(model, batch):
        rows.append(batch["emb"].shape[0])
        return model(batch["emb"], batch["mask"])

    _, ld = make_train_step(None, get_loss("clews"), mesh=mesh, model_call=call)(
        dp_cases.head_state(), dp_cases.head_batch())
    res["train"] = {"rows": rows, "loss": float(ld["loss"])}
    dist.barrier()
    dist.destroy_process_group()

    res["cli"] = [_cli(argv, port, rank, world) for argv, port in zip(inp["cli"], ports[1:])]
    return res
