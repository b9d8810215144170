"""One rank of a multi-rank test of the port (tests/_torch_parity.py::
spawn_ranks): joins a gloo group of ``world`` CPU processes, runs
``tests/<cases>.py::run(mesh_ports, workdir)`` and saves the dict it
returns to ``<workdir>/<cases>_rank<r>.pt``. Imports the port only (no
JAX): the JAX side of each check runs in the test process."""

import importlib
import os
import sys
from pathlib import Path

import torch

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS.parent))
sys.path.insert(0, str(TESTS))

from wealy_tpu_torch.parallel.multihost import initialize_multihost  # noqa: E402


def main(cases: str, rank: int, world: int, ports: list, workdir: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_multihost(f"127.0.0.1:{ports[0]}", world, rank, backend="gloo", timeout_s=180)
    res = importlib.import_module(cases).run(ports, Path(workdir))
    torch.save(res, Path(workdir) / f"{cases}_rank{rank}.pt")
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    c, r, w, p, d = sys.argv[1:6]
    main(c, int(r), int(w), [int(x) for x in p.split(",")], d)
