"""The decode attention kernel's count (``portbench/counts/decode_attn.py``)
equals hand-worked numbers at large-v3-turbo's sizes, and its reader
(``decode_attn_roofline_share.extract``) gives the bound of the traced
batches' steps over the kernel's launches in a trace made up here, and None
where the trace holds no launch of it (a program without the kernel) or the
batches decoded nothing."""

import json
from pathlib import Path

import pytest

from portbench import harness, peaks, traces
from portbench.counts import decode_attn

NAME = "decode_attn_roofline_share.extract"
TURBO = json.loads((Path(__file__).resolve().parents[1] / "configs" /
                    "wealy-large-v3-turbo.json").read_text())
QO = 2 * 16 * 20 * 64 * 2  # q read and the output written, bf16: 81,920 bytes


def test_counts_at_turbo():
    # cross-attention: K and V (16, 20, 1500, 64) bf16 read once, q and the output
    assert decode_attn.bytes_moved(16, 20, 1500, 64) == 122_880_000 + QO
    assert decode_attn.ops(16, 20, 1500, 64) == 122_880_000  # 4 * 16 * 20 * 1500 * 64
    # the float8 cross K/V: half the K/V bytes
    assert decode_attn.bytes_moved(16, 20, 1500, 64, kv_bytes=1) == 61_440_000 + QO
    s, basis = peaks.bound_s(decode_attn.bytes_moved(16, 20, 1500, 64),
                             decode_attn.ops(16, 20, 1500, 64), "f32")
    assert basis == "bytes" and s == pytest.approx(122_961_920 / 3.35e12)
    # a step at position 4: per layer the cache's 5 positions and the 1500 frames
    calls = decode_attn.step_calls(TURBO, 16, 4)
    assert len(calls) == 8
    assert calls[0] == (5 * 81_920 + QO, 4.0 * 16 * 20 * 5 * 64)
    assert calls[1] == (122_880_000 + QO, 122_880_000.0)
    assert sum(b for b, _ in calls) == 4 * (491_520 + 122_961_920)


def _record(calls, device):
    cell = {"batch_size": 16, "max_len": 8, "language": 0, "kind": "hs_last_seq"}
    return {"cell": cell, "config": TURBO, "calls": calls,
            "trace": traces.Trace(0.0, 1e6, device, [])}


DEVICE = [("void (anonymous namespace)::decode_attn_scores_kernel<__nv_bfloat16>(...)", 0.0, 400.0),
          ("void (anonymous namespace)::decode_attn_kernel<__nv_bfloat16, false>(...)", 500.0, 900.0),
          ("void (anonymous namespace)::decode_attn_kernel<__nv_bfloat16, true>(...)", 1000.0, 1200.0),
          ("nvjet_tst_64x8_64x16_4x2_h_bz_bias_TNT", 1200.0, 9000.0)]


def test_the_reader_over_a_made_up_trace():
    # one batch whose rows run to max_len 8: steps at positions 4, 5 and 6 (prompt of 4)
    got = harness.metric_reader(NAME)(_record([(0.0, 1.0, 16, [8] * 16)], DEVICE))
    bound = sum(peaks.bound_s(b, o, "f32")[0]
                for t in (4, 5, 6) for b, o in decode_attn.step_calls(TURBO, 16, t))
    assert got == pytest.approx(100.0 * bound / 1000e-6)
    # rows that end at position 6: steps at 4 and 5 only
    short = harness.metric_reader(NAME)(_record([(0.0, 1.0, 16, [6, 5] * 8)], DEVICE))
    assert short == pytest.approx(got * (bound - sum(
        peaks.bound_s(b, o, "f32")[0] for b, o in decode_attn.step_calls(TURBO, 16, 6))) / bound)


@pytest.mark.parametrize("calls,device", [
    ([(0.0, 1.0, 16, [8] * 16)], DEVICE[3:]),  # no launch of the kernel: the parent
    ([(0.0, 1.0, 16, [])], DEVICE),  # an x_concat batch: no decode
    ([], DEVICE),
], ids=["no_kernel", "no_decode", "no_calls"])
def test_the_reader_gives_none(calls, device):
    assert harness.metric_reader(NAME)(_record(calls, device)) is None
