"""Milliseconds of mel (K1) and the encoder a real 30 s chunk, timed with
CUDA events on the card: the port's ``whisper.encode`` spans (opened
around the mel and the encoder in each embed factory) summed over the
traced run's synchronised batches before the profiler starts, over those
calls' real chunks."""

from portbench import program_spans as ps


def read(record):
    got = ps.synced(record)
    rows = ps.synced_rows(record)
    if got is None or not rows:
        return None
    ms = [e.device_ms for e in ps.named(got[2], "whisper.encode")]
    if not ms or None in ms:
        return None
    return sum(ms) / rows
