"""Milliseconds of the batch's upload to the card a real 30 s chunk on the
host clock: the port's ``extract.h2d`` spans (the f32 batch from pageable
host memory, padding rows included) over the traced run's synchronised
batches before the profiler starts, over those calls' real chunks."""

from portbench import program_spans as ps


def read(record):
    got = ps.synced(record)
    rows = ps.synced_rows(record)
    if got is None or not rows:
        return None
    uploads = ps.named(got[2], "extract.h2d")
    if not uploads:
        return None
    return 1e3 * sum(e.t1 - e.t0 for e in uploads) / rows
