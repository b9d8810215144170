"""Does ``train`` or ``evaluate --checkpoint`` vary between runs of one tree
on the card? (``chip_smoke.py`` phase 15's project.)

    python3 chip_determinism.py            # on the card; about 4 min

1. ``train --max-steps 20`` twice on phase 15's project (``chip_smoke.
   write_project(train_cliques=16, val_cliques=4)``, the same config), and
   ``evaluate --checkpoint`` of each checkpoint three times: the losses, a
   digest of each checkpoint, each MAP (``repr``), the parameters that
   differ between the two runs.
2. One step's gradients three times on one state and batch: the parameters
   whose gradient varies; then each op of the head alone, run twice on the
   same input and cotangent (each ConvBlock's Conv1d backward-data and
   backward-filter, its LayerNorm backward): the ops whose result varies.
3. The same as 1 in a child process under
   ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
   set before CUDA starts).

Prints one ``DETERMINISM {json}`` line per process; TF32 off, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import warnings

import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def run_cli(argv) -> dict:
    from wealy_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"{argv} exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def checkpoint(ckdir) -> tuple:
    from wealy_tpu_torch.train.checkpoint import CheckpointManager

    params = CheckpointManager(ckdir).restore()["params"]
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].numpy().tobytes())
    return h.hexdigest()[:16], params


def train_twice(tmp: str, cpath: str, res: dict) -> None:
    conf = json.load(open(cpath))
    conf["train"] = {"loss": "clews", "batch_size": 16, "lr": 1e-3, "warmup_steps": 2,
                     "max_steps": 20, "log_every": 0, "eval_every": 20,
                     "checkpoint_every": 1000}
    params = {}
    for run in ("A", "B"):
        conf["path"]["checkpoints"] = os.path.join(tmp, "ck" + run)
        conf["train"]["metrics_jsonl"] = os.path.join(tmp, f"m{run}.jsonl")
        with open(cpath, "w") as f:
            json.dump(conf, f)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_cli(["train", "--config", cpath, "--max-steps", "20", "--fresh"])
        res[f"warnings_{run}"] = sorted({str(w.message)[:160] for w in caught})
        losses = [json.loads(line).get("loss") for line in open(conf["train"]["metrics_jsonl"])]
        res[f"losses_{run}"] = [repr(x) for x in losses if x is not None]
        res[f"digest_{run}"], params[run] = checkpoint(conf["path"]["checkpoints"])
        res[f"evaluate_MAP_{run}"] = [repr(run_cli(["evaluate", "--config", cpath, "--split",
                                                    "test", "--checkpoint",
                                                    conf["path"]["checkpoints"]])["MAP"])
                                      for _ in range(3)]
    res["params_differing_A_B"] = {k: float((params["A"][k] - params["B"][k]).abs().max())
                                   for k in params["A"]
                                   if not torch.equal(params["A"][k], params["B"][k])}


def ops_that_vary(cpath: str, dev, res: dict) -> None:
    from wealy_tpu_torch.data.chunking import collate_fixed_length
    from wealy_tpu_torch.data.dataset import EmbeddingDataset
    from wealy_tpu_torch.losses import get_loss
    from wealy_tpu_torch.models.registry import build_model
    from wealy_tpu_torch.train.config import Config
    from wealy_tpu_torch.train.loop import batch_to_device
    from wealy_tpu_torch.train.state import create_train_state
    from wealy_tpu_torch.train.step import loss_and_grads

    ds = EmbeddingDataset(Config.from_file(cpath), "train", seed=0)
    model, _ = build_model("whisper", zdim=512, in_features=1280)
    state = create_train_state(model.to(dev), seed=0)
    _, brng, items = next(iter(ds.sampler.epoch_batches(0, 16, 0)))
    batch = batch_to_device(collate_fixed_length(items, chunk_size=1000, use_random_chunks=True,
                                                 rng=brng), dev)
    g = [loss_and_grads(state, batch, get_loss("clews"))[2] for _ in range(3)]
    res["step_gradients_varying"] = {
        n: float(max((g[0][n] - g[i][n]).abs().max() for i in (1, 2)))
        for n in g[0] if not all(torch.equal(g[0][n], g[i][n]) for i in (1, 2))}
    # each op of the head alone, on its input in this batch and a fixed cotangent
    inputs = {}

    def keep(name):
        def hook(module, args, out):
            inputs[name] = (args[0].detach(), out.detach())
        return hook

    hooks = [m.register_forward_hook(keep(name)) for name, m in state.model.named_modules()
             if name.endswith((".conv", ".norm"))]
    with torch.no_grad():
        state.model(batch["emb"].float(), batch["mask"])
    for h in hooks:
        h.remove()
    gen = torch.Generator(device=dev).manual_seed(1)
    varying = {}
    for name, (x, y) in inputs.items():
        module = state.model.get_submodule(name)
        cot = torch.randn(y.shape, device=dev, generator=gen)
        outs = []
        for _ in range(3):
            xi = x.clone().requires_grad_(True)
            grads = torch.autograd.grad(module(xi), [xi, *module.parameters()], cot)
            outs.append(grads)
        labels = ["input"] + [n for n, _ in module.named_parameters()]
        for j, label in enumerate(labels):
            diff = max(float((outs[0][j] - outs[i][j]).abs().max()) for i in (1, 2))
            if diff:
                varying[f"{name} grad of {label}"] = diff
    res["ops_varying"] = varying


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_determinism: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    deterministic = "--deterministic" in sys.argv
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"deterministic_algorithms": deterministic}
    with tempfile.TemporaryDirectory(prefix="wealy_det_") as tmp:
        cpath, _ = chip_smoke.write_project(tmp, dev, train_cliques=16, val_cliques=4)
        train_twice(tmp, cpath, res)
        if not deterministic:
            ops_that_vary(cpath, dev, res)
    print("DETERMINISM " + json.dumps(res), flush=True)
    if deterministic:
        return 0
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    return subprocess.run([sys.executable, os.path.abspath(__file__), "--deterministic"],
                          env=env, timeout=1200).returncode


if __name__ == "__main__":
    sys.exit(main())
