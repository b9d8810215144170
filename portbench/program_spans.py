"""The port's own spans, for the per-layer readers: the ring of
``wealy_tpu_torch.utils.profiling`` (each span's name, start and end on
``time.perf_counter``, the clock of ``drivers/extract.py::Window``, its number
``n`` and, where the card timed it, ``device_ms``). A program without the
ring gives None, so its metrics are left out of the line."""


def ring(since=None, until=None):
    """The program's spans that ended in [since, until], or None
    when the program keeps none."""
    try:
        from wealy_tpu_torch.utils.profiling import spans
    except (ImportError, AttributeError):
        return None
    return spans(since, until)


def synced(record):
    """(since, until, entries): the spans of the traced run's
    synchronised batches before the profiler (``synced_window``), or None."""
    window = record.get("synced_window")
    if not window or window[1] is None:
        return None
    entries = ring(*window)
    return None if entries is None else (window[0], window[1], entries)


def named(entries, name: str) -> list:
    return [e for e in entries if e.name == name]


def synced_rows(record) -> int:
    """The real chunks of the synchronised calls."""
    return sum(rows for _, _, rows, _ in record.get("synced") or [])
