"""Milliseconds a decode thread spends on a 30 s chunk: the port's
``audio.load`` spans (a song's WAV decode and resample to 16 kHz, each
tagged with the song's chunks) that ended in the traced run's synchronised
window before the profiler starts, over their songs' chunks. Divided by the
decode threads (4), it is the feed's ceiling a chunk."""

from portbench import program_spans as ps


def read(record):
    got = ps.synced(record)
    if got is None:
        return None
    loads = ps.named(got[2], "audio.load")
    chunks = sum(e.n or 0 for e in loads)
    if not chunks:
        return None
    return 1e3 * sum(e.t1 - e.t0 for e in loads) / chunks
