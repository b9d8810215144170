"""The readers of the port's own spans (``portbench/metrics``
over ``portbench/program_spans.py``): each gives its number from a record
and a ring made up here, and None when its span is missing or the program
keeps no ring (as the port did before it had one). A traced run of
``drivers/extract.py`` on the CPU at a small Whisper gives every host-clock reader a
number; on the card (marked ``cuda``) the encoder's share of a batch's
device call lies inside it."""

import math
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import DEV
from portbench.tests.test_portbench_faults import _cell

WINDOW = (100.0, 110.0)
# {metric: (its spans: (name, t0, t1, n, device_ms), expected value)}
CASES = {
    "decode_step_ms.extract": (
        [("whisper.decode_step", 101.0, 101.002, None, None),
         ("whisper.decode_step", 101.002, 101.006, None, None),
         ("whisper.decode_step", 90.0, 90.5, None, None)], 3.0),  # the last before the window
    "encoder_ms_per_chunk.extract": (
        [("whisper.encode", 101.0, 101.1, None, 10.0),
         ("whisper.encode", 104.0, 104.1, None, 14.0)], 2.0),
    "next_batch_wait_share.extract": (
        [("extract.next_batch", 99.5, 100.5, None, None),  # only its part in the window
         ("extract.next_batch", 101.0, 102.0, None, None),
         ("extract.next_batch", 104.0, 106.5, None, None)], 40.0),
    "audio_load_ms_per_chunk.extract": (
        [("audio.load", 100.0, 100.3, 3, None), ("audio.load", 101.0, 101.1, 1, None),
         ("audio.load", 90.0, 91.0, 9, None)], 100.0),  # the last ended before the window
    "h2d_ms_per_chunk.extract": (
        [("extract.h2d", 101.0, 101.003, None, None),
         ("extract.h2d", 104.0, 104.003, None, None)], 0.5),
    "weight_load_s.extract": (
        [("whisper.load", 80.0, 81.0, None, None), ("whisper.load", 95.0, 98.0, None, None),
         ("whisper.load", 105.0, 109.0, None, None)], 3.0),  # the last before the window
}


def _record() -> dict:
    # two synchronised calls of six real chunks each
    return {"synced_window": WINDOW, "synced": [(101.0, 103.0, 6, []), (104.0, 106.0, 6, [])],
            "calls": [], "trace": None}


def _ring(monkeypatch, entries) -> None:
    from wealy_tpu_torch.utils import profiling

    ring = [SimpleNamespace(name=n, t0=t0, t1=t1, n=k, device_ms=ms)
            for n, t0, t1, k, ms in entries]

    def spans(since=None, until=None):
        return [e for e in ring
                if (since is None or e.t1 >= since) and (until is None or e.t1 <= until)]

    monkeypatch.setattr(profiling, "spans", spans)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_reader_gives_its_number(monkeypatch, name):
    entries, want = CASES[name]
    _ring(monkeypatch, entries + [("other.span", 101.0, 102.0, 5, 1.0)])
    assert harness.metric_reader(name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_reader_without_its_span_gives_none(monkeypatch, name):
    _ring(monkeypatch, [("other.span", 101.0, 102.0, 5, 1.0)])
    assert harness.metric_reader(name)(_record()) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_program_without_the_ring_gives_none(monkeypatch, name):
    from wealy_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert harness.metric_reader(name)(_record()) is None


def _traced(name: str, device, cell: dict, config: dict, seconds: float) -> dict:
    bench = harness.load_spec(name)[0]
    ctx = harness.Context(name=name, cell=cell, config=config, seed=2**31 + 29, seconds=seconds,
                          trace=True, t0=time.perf_counter(), device=device)
    out = harness.driver("extract").run(ctx)
    return {m["name"]: harness.metric_reader(m["name"])(out["record"])
            for m in harness.per_layer_entries(bench, name)}


@pytest.mark.parametrize("name", ["turbo-x-extract", "turbo-hs-extract"])
def test_a_traced_run_on_the_cpu_reads_the_programs_spans(cache, name):
    cell = dict(_cell(name), trace_skip=2)
    got = _traced(name, torch.device("cpu"), cell, DEV, 1.5)
    host = {m: v for m, v in got.items() if m in CASES and m != "encoder_ms_per_chunk.extract"}
    assert len(host) == (5 if name == "turbo-hs-extract" else 4)
    assert all(v is not None and math.isfinite(v) and v > 0 for v in host.values()), host
    assert got["encoder_ms_per_chunk.extract"] is None  # no card: no events


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["turbo-x-extract", "turbo-hs-extract"])
def test_the_encoder_lies_inside_the_device_call_on_the_card(card, name):
    _, cell, config = harness.load_spec(name)
    got = _traced(name, card, cell, config, 5.0)
    print(name, got)
    new = {m: got[m] for m in CASES if m in got}
    assert all(v is not None and math.isfinite(v) and v > 0 for v in new.values()), new
    assert 0 < got["encoder_ms_per_chunk.extract"] < got["device_path_ms_per_chunk.extract"]
