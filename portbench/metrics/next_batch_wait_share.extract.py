"""The share of the window that the split loop spent waiting for its next
batch from the decode threads (the port's ``extract.next_batch`` spans),
over the traced run's synchronised batches before the profiler starts, in
%; the rest of ``feed_wait_share.extract`` is the loop's own serial work
(the batch buffer, the copy back, the song accumulators)."""

from portbench import program_spans as ps


def read(record):
    got = ps.synced(record)
    if got is None:
        return None
    since, until, entries = got
    waits = ps.named(entries, "extract.next_batch")
    if not waits or until <= since:
        return None
    inside = sum(e.t1 - max(e.t0, since) for e in waits)
    return 100.0 * inside / (until - since)
