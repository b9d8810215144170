"""Percent of greedy decode steps replayed as one CUDA graph: the port's
``whisper.decode_step`` spans whose ``n`` is 1 (a replay; 0 is a step run
eagerly) over those that carry a number, in the traced run's synchronised
batches before the profiler starts. A program whose step spans carry no
number gives None."""

from portbench import program_spans as ps


def read(record):
    got = ps.synced(record)
    if got is None:
        return None
    steps = [e for e in ps.named(got[2], "whisper.decode_step") if e.n is not None]
    if not steps:
        return None
    return 100.0 * sum(e.n == 1 for e in steps) / len(steps)
