"""Seconds of the port's Whisper build and weight load (its last
``whisper.load`` span before the window opens: the model built on the card
and the state dict loaded through ``load_openai_state_dict``), a part of
``setup_s``."""

from portbench import program_spans as ps


def read(record):
    window = record.get("synced_window")
    if not window:
        return None
    entries = ps.ring(until=window[0])
    loads = ps.named(entries, "whisper.load") if entries is not None else []
    if not loads:
        return None
    return loads[-1].t1 - loads[-1].t0
