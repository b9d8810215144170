"""Data parallelism of the port (wealy_tpu_torch/parallel/, the mesh paths of
train/step.py and train/loop.py, ``train`` under a world size above 1) on
two gloo CPU processes, held against the single-process run on the same
global batch, as tests/test_parallel.py holds the JAX mesh step against the
single-device step:

- ``global_batch_loss`` equals the loss of the whole batch, and its
  gradient the whole batch's (clews, ntxent, triplet; rtol 1e-5);
- one mesh step's gradients, and the losses and parameters after AdamW,
  equal the plain step's with and without ``grad_accum`` (rtol 1e-5, atol
  1e-7); a batch that does not divide the world size runs whole;
- ``fit(mesh=)`` takes the plain run's steps, and only rank 0 writes;
- ``host_shard`` and ``is_primary_host`` behave as the JAX ones;
- the int8 encoder on a data-sharded mel equals the unsharded run
  (tests/test_quant_encoder.py:92-107: rtol 1e-5, atol 1e-6);
- ``train`` launched as ``torchrun`` launches it (RANK, WORLD_SIZE, ...)
  writes one checkpoint and one metrics stream, from rank 0, equal to a
  single-process ``train``.

Every spawn has its own deadline: a hung rank fails the test, it does not
hang the suite."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wealy_tpu.parallel.multihost import host_shard as j_host_shard
from wealy_tpu_torch.losses import get_loss
from wealy_tpu_torch.parallel.mesh import make_mesh
from wealy_tpu_torch.parallel.multihost import host_shard, initialize_multihost, is_primary_host
from wealy_tpu_torch.train.checkpoint import CheckpointManager
from wealy_tpu_torch.train.step import loss_and_grads, make_eval_embed_step, make_train_step

import _torch_dp_cases as cases
from _torch_parity import write_embedding_project

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
DEADLINE_S = 180
RTOL, ATOL = 1e-5, 1e-7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argvs, envs, cwd) -> list:
    """Start one process per argv, wait for all under one deadline, kill
    them all past it; returns the CompletedProcess-like (rc, out, err)."""
    procs = [subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in zip(argvs, envs)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DEADLINE_S)
            results.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not finish within {DEADLINE_S} s")
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    return results


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of tests/_torch_parallel_worker.py (one spawn)."""
    out = tmp_path_factory.mktemp("dp")
    port = _free_port()
    worker = str(REPO / "tests" / "_torch_parallel_worker.py")
    _spawn([[sys.executable, worker, str(r), str(WORLD), str(port), str(out)]
            for r in range(WORLD)], [_env()] * WORLD, REPO)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", cases.LOSSES)
def test_global_batch_loss_is_the_whole_batch_loss(ranks, name):
    labels, ids, z = cases.loss_inputs()
    z = z.clone().requires_grad_(True)
    loss, _ = get_loss(name)(labels, ids, z, {"global_step": 3})
    loss.backward()
    for res in ranks[0]:
        _close(res[f"loss_{name}"], loss.detach())
        _close(res[f"zgrad_{name}"], z.grad)


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_step_equals_the_plain_step(ranks, accum):
    state = cases.head_state()
    _, _, grads = loss_and_grads(state, cases.head_batch(), get_loss("clews"),
                                 grad_accum=accum)
    step = make_train_step(None, get_loss("clews"), grad_accum=accum)
    losses = []
    for _ in range(cases.STEPS):
        state, ld = step(state, cases.head_batch())
        losses.append(float(ld["loss"]))
    for res in ranks[0]:
        assert set(res[f"grads_{accum}"]) == set(grads)
        for k in grads:
            _close(res[f"grads_{accum}"][k], grads[k])
        _close(res[f"losses_{accum}"], losses)
        for k, v in state.params.items():
            _close(res[f"params_{accum}"][k], v)
    # the replicas stay equal to one another
    a, b = (r[f"params_{accum}"] for r in ranks[0])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_batch_that_does_not_divide_the_world_runs_whole(ranks):
    state = cases.head_state()
    state, ld = make_train_step(None, get_loss("clews"))(state, cases.head_batch(6))
    for res in ranks[0]:
        assert res["odd_loss"] == float(ld["loss"])
        for k, v in state.params.items():
            assert torch.equal(res["odd_params"][k], v), k


def test_mesh_eval_step_gathers_every_rank(ranks):
    state = cases.head_state()
    state, _ = make_train_step(None, get_loss("clews"))(state, cases.head_batch(6))
    batch = cases.head_batch()
    want = make_eval_embed_step(state.model)(torch.from_numpy(batch["emb"]),
                                             torch.from_numpy(batch["mask"]))
    for res in ranks[0]:
        assert res["eval_z"].shape == want.shape
        _close(res["eval_z"], want)


def test_fit_on_the_mesh_takes_the_plain_steps(ranks, tmp_path):
    results, out = ranks
    plain = cases.run_fit(tmp_path / "plain", None)
    assert plain["ckpt_steps"] == [cases.STEPS]
    r0, r1 = (r["fit"] for r in results)
    _close(r0["losses"], plain["losses"])
    assert r0["ckpt_steps"] == [cases.STEPS] and r1["ckpt_steps"] == []  # rank 0 writes
    saved = CheckpointManager(out / "fit_rank0" / "ckpt").restore()
    for k, v in plain["params"].items():
        _close(saved["params"][k], v)
        _close(r1["params"][k], v)


def test_host_shard_and_primary_as_jax(ranks):
    for r, res in enumerate(ranks[0]):
        assert res["rank"] == r and res["world"] == WORLD
        assert res["primary"] == (r == 0)
        assert res["host_shard"] == j_host_shard(range(11), r, WORLD)
        assert res["report"]["process_index"] == r and res["report"]["process_count"] == WORLD
    for pi, pc in ((0, 1), (2, 3), (4, 5)):
        assert host_shard(range(13), pi, pc) == j_host_shard(range(13), pi, pc)
    # one process: no group, a report, the identity shard, primary
    assert initialize_multihost()["process_count"] == 1
    assert is_primary_host() and host_shard([3, 1, 2]) == [3, 1, 2]
    assert make_mesh(device="cpu").world_size == 1
    # a (data, model) mesh (ported with item 6d): one rank here; over two
    # ranks the model axis sums what each rank holds, as one process sums
    one = make_mesh(("data", "model"), device="cpu")
    assert (one.size("data"), one.size("model"), one.index("model")) == (1, 1, 0)
    for r, res in enumerate(ranks[0]):
        assert res["model_mesh"] == {"shape": (1, WORLD), "index": r, "next": (r + 1) % WORLD,
                                     "sum": float(sum(range(WORLD)))}


def test_int8_encoder_on_a_sharded_mel_equals_unsharded(ranks):
    enc, mel = cases.quant_encoder_and_mel()
    with torch.no_grad():
        want = enc(mel)
    for res in ranks[0]:
        np.testing.assert_allclose(res["int8"].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_torchrun_style_train_writes_once_from_rank_0(tmp_path):
    """``train`` in two processes with the torchrun environment (gloo,
    ``--device cpu``): one JSON line and one checkpoint, from rank 0, equal
    to a single-process ``train`` of the same config."""
    runs = {}
    for name, world in (("single", 1), ("dp", WORLD)):
        root = tmp_path / name
        root.mkdir()
        cpath = write_embedding_project(root, train={"metrics_jsonl": str(root / "m.jsonl")})
        port = _free_port()
        envs = []
        for r in range(world):
            env = _env()
            if world > 1:
                env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            envs.append(env)
        argv = [sys.executable, "-m", "wealy_tpu_torch.cli.main", "train", "--config", cpath,
                "--max-steps", "3", "--fresh", "--device", "cpu"]
        results = _spawn([argv] * world, envs, root)
        lines = [json.loads(ln) for _, out, _ in results for ln in out.strip().splitlines()]
        runs[name] = (root, lines)
    (sroot, slines), (droot, dlines) = runs["single"], runs["dp"]
    assert len(dlines) == 1 == len(slines) and dlines[0]["final_step"] == 3
    _close(dlines[0]["final_loss"], slines[0]["final_loss"])
    assert CheckpointManager(droot / "ckpt").all_steps() == [3]
    assert len((droot / "m.jsonl").read_text().splitlines()) == 3  # one writer
    got = CheckpointManager(droot / "ckpt").restore()["params"]
    want = CheckpointManager(sroot / "ckpt").restore()["params"]
    for k in want:
        _close(got[k], want[k])
