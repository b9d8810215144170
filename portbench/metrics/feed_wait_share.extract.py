"""The share of the window that the host spent outside the device call of
a batch (the embed or decode function, timed by the benchmark's wrapper,
which synchronises before it returns in a traced run), over the traced
run's synchronised batches before the profiler starts: the host feed of
the split job (decode and resample, chunking, batching, the host copy of
the result and the song accumulators), in %."""


def read(record):
    span, calls = record.get("synced_window"), record.get("synced")
    if not span or span[1] is None or not calls:
        return None
    inside = sum(t_out - t_in for t_in, t_out, _, _ in calls)
    return 100.0 * (1.0 - inside / (span[1] - span[0]))
