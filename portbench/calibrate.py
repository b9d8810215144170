"""The readings that a cell's limits are set from: the numbers its check
compares, for many seeds in one process (set-up is long), with the program
or with the cell's control in its place:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 8 --variant control

One JSON line a seed: {"seed", "variant", "correct", "numbers", "rate"},
and for a decoder cell "lengths", each batch's decoded lengths (prompt
included). The benchmark's own runs never call it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--variant", choices=("program", "control"), default="program")
    args = p.parse_args(argv)
    harness.set_cache_env()
    bench, cell, config = harness.load_spec(args.workload)
    device = harness.require_cards(cell["chips"])
    if device is None:
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        lengths: list = []

        def record(fn):
            def call(audio):
                out = fn(audio)
                if isinstance(out, tuple):
                    lengths.append(out[1].tolist())
                return out
            return call

        ctx = harness.Context(name=args.workload, cell=cell, config=config, seed=seed,
                              seconds=args.seconds, trace=False, t0=time.perf_counter(),
                              device=device, variant=args.variant, fault=record)
        out = harness.driver(cell["driver"]).run(ctx)
        ok = harness.judge(out["checks"], cell["check"]["limits"])[0]
        print(json.dumps({"seed": seed, "variant": args.variant, "correct": ok,
                          "numbers": out["checks"], "rate": out["end_to_end"],
                          "lengths": lengths}), flush=True)
        del out
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
