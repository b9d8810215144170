"""One rank of tests/test_torch_parallel.py's data-parallel checks: joins a
gloo group of ``world`` CPU processes, runs every mesh check on the same
seeded inputs as the single-process references of the test, and saves what
it computed to ``<out>/rank<r>.pt``. Imports the port only (no JAX)."""

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from wealy_tpu_torch.losses import get_loss  # noqa: E402
from wealy_tpu_torch.parallel.collectives import global_batch_loss  # noqa: E402
from wealy_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather_rows,
    all_reduce,
    data_sharding,
    make_mesh,
)
from wealy_tpu_torch.parallel.multihost import (  # noqa: E402
    host_shard,
    initialize_multihost,
    is_primary_host,
)
from wealy_tpu_torch.train.step import loss_and_grads, make_eval_embed_step, make_train_step  # noqa: E402,E501
from wealy_tpu_torch.train.step import shard_batch  # noqa: E402

import _torch_dp_cases as cases  # noqa: E402


def main(rank: int, world: int, port: int, out: str) -> None:
    report = initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  timeout_s=120)
    mesh = make_mesh(device="cpu")
    res = {"report": report, "rank": mesh.rank, "world": mesh.world_size,
           "host_shard": host_shard(range(11)), "primary": is_primary_host()}
    tp = make_mesh(("data", "model"), (1, world), device="cpu")
    res["model_mesh"] = {"shape": tp.shape, "index": tp.index("model"),
                         "next": tp.peer("model", tp.index("model") + 1),
                         "sum": float(all_reduce(tp, torch.tensor([float(rank)]), "model"))}

    # global_batch_loss: the loss of the gathered batch, the gradient of this rank's rows
    labels, ids, z = cases.loss_inputs()
    for name in cases.LOSSES:
        zl = data_sharding(mesh, z).clone().requires_grad_(True)
        loss, _ = global_batch_loss(get_loss(name), mesh)(
            data_sharding(mesh, labels), data_sharding(mesh, ids), zl, {"global_step": 3})
        loss.backward()
        res[f"loss_{name}"] = loss.detach()
        res[f"zgrad_{name}"] = all_gather_rows(mesh, zl.grad)

    # the mesh train step: gradients of one step, then two steps of AdamW
    for accum in (1, 2):
        state = cases.head_state()
        _, _, grads = loss_and_grads(state, shard_batch(cases.head_batch(), mesh),
                                     get_loss("clews"), grad_accum=accum, mesh=mesh)
        res[f"grads_{accum}"] = grads
        step = make_train_step(None, get_loss("clews"), mesh=mesh, grad_accum=accum)
        losses = []
        for _ in range(cases.STEPS):
            state, ld = step(state, cases.head_batch())
            losses.append(float(ld["loss"]))
        res[f"losses_{accum}"] = losses
        res[f"params_{accum}"] = {k: v.clone() for k, v in state.params.items()}
    # a batch that does not divide the world size runs whole on every rank
    state = cases.head_state()
    state, ld = make_train_step(None, get_loss("clews"), mesh=mesh)(state, cases.head_batch(6))
    res["odd_loss"] = float(ld["loss"])
    res["odd_params"] = {k: v.clone() for k, v in state.params.items()}

    # the mesh eval step gathers every rank's rows
    batch = cases.head_batch()
    res["eval_z"] = make_eval_embed_step(state.model, mesh=mesh)(
        torch.from_numpy(batch["emb"]), torch.from_numpy(batch["mask"]))

    # fit on the mesh: 3 steps, checkpoints from rank 0 only
    res["fit"] = cases.run_fit(Path(out) / f"fit_rank{rank}", mesh)

    # the int8 encoder on a data-sharded mel batch, gathered
    enc, mel = cases.quant_encoder_and_mel()
    with torch.no_grad():
        res["int8"] = all_gather_rows(mesh, enc(data_sharding(mesh, mel)))

    torch.save(res, Path(out) / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, p, o = sys.argv[1:5]
    main(int(r), int(w), int(p), o)
