"""Percent of encoder forwards whose every LayerNorm pass ran on kernel K6:
the port's ``whisper.encoder_ln`` spans (one an encoder forward) whose
``n`` is 1 (0: some pass took another route) over those that carry a
number, in the traced run's synchronised batches before the profiler
starts. A program that records no such span gives None."""

from portbench import program_spans as ps


def read(record):
    got = ps.synced(record)
    if got is None:
        return None
    forwards = [e for e in ps.named(got[2], "whisper.encoder_ln") if e.n is not None]
    if not forwards:
        return None
    return 100.0 * sum(e.n == 1 for e in forwards) / len(forwards)
