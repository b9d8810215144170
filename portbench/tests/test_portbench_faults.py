"""A run whose timed path is broken underneath comes out not correct, and
one that is not comes out correct: the extraction driver on the CPU at a
small Whisper (the look for a card skipped), held to the cells' own limits.
The control (the cell's lower-precision path in the program's place) and
the batching faults are also run on the card at the cell's own size
(marked ``cuda``)."""

import contextlib
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import DEV

HERE = Path(__file__).resolve().parents[1]
# songs of three chunks (30 + 30 + 5 s) in batches of two: a batch holds two
# chunks of one song or the ends of two
BLOCK = {"kind": "audio_split", "pool_files": 3, "median_s": 65, "sigma": 0.0, "min_s": 30,
         "max_s": 600, "sample_rate": 44100, "n_versions": 80, "clique_size": 2}


def _cell(name: str) -> dict:
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cell.update(batch_size=2, warmup_batches=1, trace_skip=0, trace_batches=2, traffic=BLOCK,
                chips=1)
    if "max_len" in cell:
        cell["max_len"] = 12
    cell["check"] = dict(cell["check"], songs=2)
    return cell


def _run(name: str, fault=None, seed: int = 2**31 + 9) -> bool:
    ctx = harness.Context(name=name, cell=_cell(name), config=DEV, seed=seed, seconds=1.5,
                          trace=False, t0=time.perf_counter(), device=torch.device("cpu"),
                          fault=fault)
    out = harness.driver("extract").run(ctx)
    return harness.judge(out["checks"], ctx.cell["check"]["limits"])[0]


def _swap_audio(batch, i, j):
    (vi, ci, ni, ai), (vj, cj, nj, aj) = batch[i], batch[j]
    batch[i], batch[j] = (vi, ci, ni, aj), (vj, cj, nj, ai)


def reorder_within_songs(batch):
    """Each song's chunks in the batch in reverse order: a chunk's row lands
    in another chunk's place of the same song."""
    runs, start = [], 0
    for k in range(1, len(batch) + 1):
        if k == len(batch) or batch[k][0] != batch[start][0]:
            runs.append((start, k))
            start = k
    for a, b in runs:
        for k in range((b - a) // 2):
            _swap_audio(batch, a + k, b - 1 - k)


def swap_between_songs(batch):
    """At every boundary between two songs in the batch, the last chunk of
    the one and the first of the next trade rows."""
    for k in range(1, len(batch)):
        if batch[k][0] != batch[k - 1][0]:
            _swap_audio(batch, k - 1, k)


@contextlib.contextmanager
def batches_faulted(fault):
    """The port's cross-song batching with ``fault`` applied to every batch
    it forms (the rows then reach the accumulators in the wrong places)."""
    from wealy_tpu_torch.cli import extract_batched as eb

    plain = eb._batches

    def faulted(*args, **kwargs):
        for batch in plain(*args, **kwargs):
            batch = list(batch)
            fault(batch)
            yield batch

    eb._batches = faulted
    try:
        yield
    finally:
        eb._batches = plain


def _alter_row(fn):
    def altered(audio):
        out = fn(audio)
        if isinstance(out, tuple):  # (hidden, lengths): one chunk's states
            hidden = out[0].clone()
            hidden[0] *= 1.05
            return hidden, out[1]
        out = out.clone()
        out[0] *= 1.05
        return out
    return altered


@pytest.mark.parametrize("name", ["turbo-x-extract", "turbo-hs-extract"])
def test_sound_run_is_correct(cache, name):
    assert _run(name)


@pytest.mark.parametrize("name", ["turbo-x-extract", "turbo-hs-extract"])
def test_an_altered_answer_is_caught(cache, name):
    assert not _run(name, fault=_alter_row)


@pytest.mark.parametrize("fault", [reorder_within_songs, swap_between_songs])
@pytest.mark.parametrize("name", ["turbo-x-extract", "turbo-hs-extract"])
def test_misplaced_rows_are_caught(cache, name, fault):
    with batches_faulted(fault):
        assert not _run(name)


def test_an_altered_token_is_caught(cache, monkeypatch):
    from wealy_tpu_torch.models.whisper import generate

    choose, calls = generate.choose_tokens, []

    def altered(logits, *args, **kwargs):
        nxt, logp = choose(logits, *args, **kwargs)
        calls.append(1)
        if len(calls) % 7 == 3:  # one step of some batches: row 0 takes another token
            nxt = nxt.clone()
            nxt[0] = (nxt[0] + 1) % logits.shape[-1]
        return nxt, logp

    monkeypatch.setattr(generate, "choose_tokens", altered)
    assert not _run("turbo-hs-extract")


def _run_on_card(card, name: str, variant: str = "program", seed: int = 2**31 + 21) -> bool:
    bench, cell, config = harness.load_spec(name)
    ctx = harness.Context(name=name, cell=cell, config=config, seed=seed, seconds=5.0,
                          trace=False, t0=time.perf_counter(), device=card, variant=variant)
    out = harness.driver(cell["driver"]).run(ctx)
    print(name, variant, out["checks"])
    return harness.judge(out["checks"], cell["check"]["limits"])[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["turbo-x-extract", "turbo-hs-extract", "medium-x-extract"])
def test_control_is_not_correct(card, name):
    assert not _run_on_card(card, name, "control")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [reorder_within_songs, swap_between_songs])
@pytest.mark.parametrize("name", ["turbo-x-extract", "turbo-hs-extract", "medium-x-extract"])
def test_misplaced_rows_are_caught_at_the_cells_size(card, name, fault):
    with batches_faulted(fault):
        assert not _run_on_card(card, name, seed=2**31 + 23)
