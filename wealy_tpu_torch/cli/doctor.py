"""``doctor``: one-shot environment, card and project diagnostics, the
counterpart of ``wealy_tpu.cli.doctor``.

Prints one JSON report:

- ``python``, ``torch``, ``cuda_visible_devices_env``;
- ``native``: whether the native host library builds and loads, and mp3;
- ``backend``: the CUDA devices, the default device and one real dispatch
  (an 8 x 8 product read back), under ``--backend-timeout``; ``--device
  cpu`` probes the host instead. On a machine without a card the backend
  is reported as not ok: the CPU is never reported as the card;
- ``project`` (with ``--config``): the configured paths, the split counts,
  the pack of the configured kind and the newest checkpoint step.

Each probe runs in a child process of its own, all started together and
polled against the deadline: a probe that raises is reported with its exit
code and the tail of its error output, and one that hangs is killed and
reported, so that ``doctor`` itself neither raises nor hangs. Exit 0 only
if the backend check passed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parents[2])

# each probe: code run as ``python -c`` with argv [root, device, config];
# it prints one JSON object as its last line
_PRELUDE = "import json, sys\nsys.path.insert(0, sys.argv[1])\n"
PROBES = {
    "backend": """
import torch
if sys.argv[2] == "cuda":
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible to torch (CUDA build: %s)" % torch.version.cuda)
    n = torch.cuda.device_count()
    devices = ["cuda:%d" % i for i in range(n)]
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    target = torch.device("cuda", torch.cuda.current_device())
else:
    devices, names, target = ["cpu"], ["cpu"], torch.device("cpu")
x = torch.ones(8, 8, device=target)
value = float((x @ x)[0, 0])
print(json.dumps({"devices": devices, "names": names, "default_device": str(target),
                  "dispatch": value, "cuda": torch.version.cuda}))
""",
    "native": """
from wealy_tpu_torch import native
ok = native.available()
print(json.dumps({"host_lib": ok, "mp3": native.mp3_available() if ok else False,
                  "build_error": native.build_error()}))
""",
    "splits": """
from wealy_tpu_torch.cli.main import _load_config
from wealy_tpu_torch.data.dataset import build_clean_dataset
md, _ = build_clean_dataset(_load_config(sys.argv[3]), check_audio=False)
print(json.dumps({s: sum(len(v) for v in md.splits.get(s, {}).values())
                  for s in ("train", "val", "test")}))
""",
    "pack": """
from wealy_tpu_torch.cli.main import _load_config
from wealy_tpu_torch.data.packed_store import PackedStore
from wealy_tpu_torch.data.paths import embedding_filename
c = _load_config(sys.argv[3])
kind = embedding_filename(c.data.embedding_type, c.data.embedding_format).removesuffix(".npz")
pack = PackedStore(c.path.hidden_states, kind, dataset_name=c.data.dataset_name)
print(json.dumps({"kind": kind, "available": bool(pack.available),
                  "versions": len(pack) if pack.available else 0}))
""",
    "checkpoint_step": """
from wealy_tpu_torch.cli.main import _load_config
from wealy_tpu_torch.train.checkpoint import CheckpointManager
print(json.dumps(CheckpointManager(_load_config(sys.argv[3]).path.checkpoints).latest_step()))
""",
}


def run_probes(names, device: str, config, timeouts: dict) -> dict:
    """Start every probe of ``names`` in a child process, poll them against
    their deadlines and return {name: the probe's JSON, or {"ok": False,
    "error": ...}} (a nonzero exit with its stderr tail, or a kill past the
    deadline)."""
    args = [_ROOT, device, config or ""]
    procs = {n: subprocess.Popen([sys.executable, "-c", _PRELUDE + PROBES[n], *args],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for n in names}
    t0 = time.monotonic()
    out = {}
    while len(out) < len(procs):
        for name, proc in procs.items():
            if name in out:
                continue
            if proc.poll() is not None:
                stdout, stderr = proc.communicate()
                lines = stdout.strip().splitlines()
                if proc.returncode == 0 and lines:
                    out[name] = json.loads(lines[-1])
                else:
                    out[name] = {"ok": False, "exit_code": proc.returncode,
                                 "error": stderr.strip()[-300:]}
            elif time.monotonic() - t0 > timeouts[name]:
                proc.kill()
                proc.communicate()
                out[name] = {"ok": False, "error": f"still running after {timeouts[name]:.0f} "
                             "s: killed (a driver or device that does not answer?)"}
        time.sleep(0.02)
    return out


def _paths(config) -> dict:
    paths = {
        "lyric_covers_data": config.path.lyric_covers_data,
        "shs_data": getattr(config.path, "shs_data", None),
        "discogs_vi_data": getattr(config.path, "discogs_vi_data", None),
        "hidden_states": config.path.hidden_states,
        "data": config.path.data,
        "cache": config.path.cache,
        "checkpoints": config.path.checkpoints,
    }
    return {k: ("ok" if v and Path(v).exists() else ("missing" if v else "unset"))
            for k, v in paths.items()}


def cmd_doctor(args) -> int:
    import torch

    from wealy_tpu_torch.cli.main import _load_config

    report: dict = {"python": sys.version.split()[0], "torch": torch.__version__,
                    "cuda_visible_devices_env": os.environ.get("CUDA_VISIBLE_DEVICES")}
    names = ["native", "backend"]
    config = None
    if args.config:
        config = _load_config(args.config)
        names += ["splits", "pack"] + (["checkpoint_step"] if config.path.checkpoints else [])
    # the host probes build the native library (g++, seconds) or read a split
    timeouts = {n: max(args.backend_timeout, 120.0) for n in names}
    timeouts["backend"] = args.backend_timeout
    probes = run_probes(names, args.device, args.config, timeouts)
    report["native"] = probes["native"]
    backend = probes["backend"]
    backend.setdefault("ok", True)
    report["backend"] = backend
    if config is not None:
        project = {"paths": _paths(config)}
        for name in ("splits", "pack", "checkpoint_step"):
            if name in probes:
                project[name] = probes[name]
        report["project"] = project
    report["ok"] = bool(backend["ok"])
    print(json.dumps(report))
    return 0 if report["ok"] else 1
