"""Milliseconds of one greedy decode step on the host clock: the mean of
the port's ``whisper.decode_step`` spans (``greedy_decode``: each closes
after its step's host sync) over the traced run's synchronised batches
before the profiler starts."""

from portbench import program_spans as ps


def read(record):
    got = ps.synced(record)
    if got is None:
        return None
    steps = ps.named(got[2], "whisper.decode_step")
    if not steps:
        return None
    return 1e3 * sum(e.t1 - e.t0 for e in steps) / len(steps)
