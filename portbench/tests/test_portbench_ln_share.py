"""The reader of ``ln_kernel_share.extract`` over a record and a ring made
up here (``test_portbench_spans.py``'s helpers): the share of
``whisper.encoder_ln`` spans in the window whose ``n`` is 1, and None where
no such span in the window carries a number, where there are none (the
program before the span) and where the program keeps no ring."""

import pytest

from portbench import harness
from portbench.tests.test_portbench_spans import _record, _ring

NAME = "ln_kernel_share.extract"


@pytest.mark.parametrize("entries,want", [
    ([("whisper.encoder_ln", 101.0, 101.2, 1, None),
      ("whisper.encoder_ln", 104.0, 104.2, 1, None)], 100.0),
    ([("whisper.encoder_ln", 101.0, 101.2, 0, None)], 0.0),
    # mixed: one forward of four off K6; the forward before the window not counted
    ([("whisper.encoder_ln", 101.0, 101.2, 1, None),
      ("whisper.encoder_ln", 101.5, 101.7, 0, None),
      ("whisper.encoder_ln", 104.0, 104.2, 1, None),
      ("whisper.encoder_ln", 105.0, 105.2, 1, None),
      ("whisper.encoder_ln", 90.0, 90.2, 0, None)], 75.0),
    # none in the window: only a forward before it
    ([("whisper.encoder_ln", 90.0, 90.2, 1, None)], None),
    # spans that carry no number
    ([("whisper.encoder_ln", 101.0, 101.2, None, None)], None),
    # no encoder spans at all (the parent)
    ([], None),
], ids=["all_on_k6", "none_on_k6", "mixed", "none_in_window", "no_numbers", "no_spans"])
def test_the_share_of_forwards_on_k6(monkeypatch, entries, want):
    _ring(monkeypatch, entries + [("whisper.encode", 101.0, 102.0, None, 3.0)])
    got = harness.metric_reader(NAME)(_record())
    assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_the_ring_gives_none(monkeypatch):
    from wealy_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert harness.metric_reader(NAME)(_record()) is None
