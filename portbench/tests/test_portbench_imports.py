"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from portbench import harness
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
for p in sorted(Path({metrics!r}).glob("*.py")):
    harness.metric_reader(p.stem)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(sub: str = "") -> list:
    out = []
    for p in sorted((HERE / sub).rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "metrics" in rel.parts or ".cache" in rel.parts:
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


def _loaded(mods, extra: str = "") -> set:
    code = PROBE.format(root=str(ROOT), mods=mods, metrics=str(HERE / "metrics"), extra=extra)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_no_jax_in_what_the_benchmark_runs():
    # every module of the benchmark, every metric reader, and the port's
    # modules that the drivers call
    extra = ("import wealy_tpu_torch.cli.extract_batched, wealy_tpu_torch.data.dataset, "
             "wealy_tpu_torch.train.config")
    loaded = _loaded(_modules(), extra)
    from portbench.harness import FORBIDDEN

    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "wealy_tpu_torch" in loaded  # compared whole: the port's name starts with wealy_tpu


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(_modules("reference"), "import torch")
    assert not {m for m in loaded if m.startswith(("wealy_tpu", "jax", "flax"))}
    for p in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not n.split(".")[0].startswith(("wealy_tpu", "jax", "flax")), (p, n)


def test_nothing_reads_the_old_benchmarks():
    for p in HERE.rglob("*.py"):
        if "tests" in p.parts:
            continue
        text = p.read_text()
        for old in ("bench.py", "benchmarks/", "BENCH_r", "MULTICHIP_", "BASELINE"):
            assert old not in text, (p, old)
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["paths"] == ["portbench"]
