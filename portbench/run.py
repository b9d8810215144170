"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout. It needs
the cards the cell asks for and exits with 3, printing no result, without
them; it exits with 4 if JAX or the JAX package is loaded once the window
has closed. The last line of standard output is the result's JSON object;
the numbers the check compared, each beside its limit, are the last lines
of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", choices=("program", "control"), default="program",
                   help="control: the cell's lower-precision path in the program's place "
                        "(for setting limits; the benchmark's runs never use it)")
    args = p.parse_args(argv)
    harness.set_cache_env()
    bench, cell, config = harness.load_spec(args.workload)
    device = harness.require_cards(cell["chips"])
    if device is None:
        return 3
    ctx = harness.Context(name=args.workload, cell=cell, config=config, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), t0=T0, device=device,
                          variant=args.variant)
    out = harness.driver(cell["driver"]).run(ctx)
    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 4
    line = harness.result(bench, ctx, out)
    if "host" in line:
        print(f"host {json.dumps(line['host'])}", file=sys.stderr)
    for key, c in line["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
