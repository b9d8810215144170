"""The share of the traced window in which no kernel, copy or set ran on
the card (1 - the union of their intervals over the window), in %."""


def read(record):
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
