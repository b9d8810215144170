"""The reader of ``decode_graph_step_share.extract`` over a record and a
ring made up here (``test_portbench_spans.py``'s helpers): the share of
``whisper.decode_step`` spans in the window whose ``n`` is 1, and None
where no step span in the window carries a number (the program before
the graph), where there are no step spans, and where the program keeps
no ring."""

import pytest

from portbench import harness
from portbench.tests.test_portbench_spans import _record, _ring

NAME = "decode_graph_step_share.extract"


@pytest.mark.parametrize("entries,want", [
    # mixed: three replays and one eager step in the window; the step before it not counted
    ([("whisper.decode_step", 101.0, 101.002, 1, None),
      ("whisper.decode_step", 101.002, 101.004, 1, None),
      ("whisper.decode_step", 102.0, 102.004, 0, None),
      ("whisper.decode_step", 104.0, 104.002, 1, None),
      ("whisper.decode_step", 90.0, 90.004, 0, None)], 75.0),
    ([("whisper.decode_step", 101.0, 101.002, 1, None)], 100.0),
    ([("whisper.decode_step", 101.0, 101.004, 0, None)], 0.0),
    # none in the window: only a step before it
    ([("whisper.decode_step", 90.0, 90.004, 1, None)], None),
    # steps that carry no number (the parent's spans)
    ([("whisper.decode_step", 101.0, 101.004, None, None)], None),
    # no step spans at all
    ([], None),
], ids=["mixed", "all_replayed", "all_eager", "none_in_window", "no_numbers", "no_spans"])
def test_the_share_of_replayed_steps(monkeypatch, entries, want):
    _ring(monkeypatch, entries + [("other.span", 101.0, 102.0, 1, None)])
    got = harness.metric_reader(NAME)(_record())
    assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_the_ring_gives_none(monkeypatch):
    from wealy_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert harness.metric_reader(NAME)(_record()) is None
