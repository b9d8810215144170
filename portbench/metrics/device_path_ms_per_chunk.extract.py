"""Milliseconds of the device call a real 30 s chunk (the wrapper's
synchronised time in the call, divided by the real chunks), over the traced
run's synchronised batches before the profiler starts: mel (K1), the
encoder and, for the ``hs_*`` kinds, the greedy decode loop."""


def read(record):
    calls = record.get("synced")
    if not calls:
        return None
    rows = sum(r for _, _, r, _ in calls)
    return 1e3 * sum(t_out - t_in for t_in, t_out, _, _ in calls) / rows if rows else None
