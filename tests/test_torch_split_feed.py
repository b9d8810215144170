"""The split loop's threads and buffers (wealy_tpu_torch.cli.extract_batched):
the feed pads batches into a pool of host buffers on its own thread, and the
calling thread runs the embed function, brings its outputs home and saves
the songs they complete.

- both jobs store, in the same order, the bits of a plain sequential loop
  written here (pad, call, copy back, accumulate, finish, save), with a
  partial last batch; on the card too, where the buffers are page-locked;
- an exception of the embed function, of the feed or of the sink leaves
  the split with the songs of the batches before it saved, reaches the
  caller, and leaves no thread of the split alive;
- a buffer is never refilled while the batch that used it is in flight.

No JAX here: the card cases run where JAX is not installed,

    python -m pytest --noconftest -m cuda tests/test_torch_split_feed.py
"""

import csv
import sys
import threading
import time
import wave

import numpy as np
import pytest
import torch

import wealy_tpu_torch.cli.extract_batched as TEB
from wealy_tpu_torch.audio.mel import N_SAMPLES
from wealy_tpu_torch.data.audio_dataset import AudioDataset
from wealy_tpu_torch.data.metadata import load_lyric_covers
from wealy_tpu_torch.models.whisper.extract import chunk_waveform
from wealy_tpu_torch.train.config import Config
from wealy_tpu_torch.utils.prefetch import prefetch

SR = 16000
# the train split in order, seconds of audio: chunks 1, 2, 3, 2, 1, 4 (13 in all);
# in batches of 3 the songs cross batch edges and the last batch holds one chunk
SONGS = {"100": 20, "101": 35, "200": 65, "201": 31, "300": 12, "301": 95}
SPLIT_THREADS = ("decode", "prefetch")


def _write_wav(path, x):
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A lyric-covers project (CSVs, 16 kHz WAV bytes under the layout's
    .mp3 names) whose train split is ``SONGS``: (config, metadata)."""
    root = tmp_path_factory.mktemp("feed")
    (root / "lc").mkdir()
    keys = list(SONGS)
    for split in ("train", "val", "test"):
        with open(root / "lc" / f"{split}_no_dup.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["original_id", "id", "is_cover", "song_text_type", "label"])
            if split == "train":  # cliques of two
                w.writerows((keys[i - i % 2], k, i % 2 == 1, "o", f"c{i // 2}")
                            for i, k in enumerate(keys))
            else:  # no audio: never extracted here
                w.writerows([(f"{split}0", f"{split}0", False, "o", split),
                             (f"{split}0", f"{split}1", True, "o", split)])
    rng = np.random.default_rng(0)
    base = root / "data" / "LyricCovers" / "audio"
    for key, seconds in SONGS.items():
        _write_wav(base / key / f"{key}_audio.mp3", 0.1 * rng.normal(size=seconds * SR))
    config = Config.from_dict({
        "path": {"lyric_covers_data": str(root / "lc"), "hidden_states": str(root / "hs"),
                 "cache": str(root / "cache"), "data": str(root / "data")},
        "data": {"dataset_name": "lyric-covers", "embedding_type": "last_hidden_states",
                 "embedding_format": "concat"},
        "model": {"name": "whisper", "zdim": 16, "whisper_size": "dev"},
    })
    return config, load_lyric_covers(root / "lc")


def _versions(config, metadata):
    return list(AudioDataset(metadata, "train", config.path.data).versions)


def _entries(config, metadata):
    """The split's (version, chunk index, chunks, chunk) in stream order."""
    ds = AudioDataset(metadata, "train", config.path.data)
    out = []
    for i, v in enumerate(ds.versions):
        chunks = chunk_waveform(ds[i].waveform)
        out += [(v, j, len(chunks), chunks[j]) for j in range(len(chunks))]
    return out


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = (x.detach().float() if x.is_floating_point() else x.detach()).cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" else x


FINISH = {
    "x_concat": lambda rows: {"embeddings": np.stack(rows)},
    "hs_last_seq": lambda hidden, lengths: {"embeddings": np.concatenate(
        [h[:int(n)] for h, n in zip(hidden, lengths)])},
    "hs_last_all": lambda hidden, lengths: {"embeddings": np.stack(hidden),
                                            "lengths": np.array(lengths, np.int32)},
}


def plain_split(config, metadata, fn, kind, batch_size):
    """The split as one sequential loop: each batch padded with zero rows
    into a fresh buffer, ``fn`` called, its outputs copied home, and each
    song finished and saved once its last chunk is in: [(version, arrays)]
    in the order saved."""
    entries, accs, saved = _entries(config, metadata), {}, []
    for start in range(0, len(entries), batch_size):
        batch = entries[start:start + batch_size]
        buf = np.zeros((batch_size, N_SAMPLES), np.float32)
        for r, (_, _, _, chunk) in enumerate(batch):
            buf[r] = chunk
        out = fn(torch.from_numpy(buf))
        outs = [_numpy(o) for o in (out if isinstance(out, (tuple, list)) else (out,))]
        for (v, j, n, _), *row in zip(batch, *outs):
            acc = accs.setdefault(v, [None] * n)
            acc[j] = row
            if all(r is not None for r in acc):
                saved.append((v, FINISH[kind](*zip(*acc))))
                del accs[v]
    assert not accs
    return saved


def run_split(config, metadata, fn, kind, batch_size, sink=None, **kw):
    """The port's job of ``kind``: (result, [(version, arrays)] in the order saved)."""
    saved = []
    job = TEB.extract_split_batched if kind == "x_concat" else TEB.extract_split_batched_decoder
    result = job(config, metadata, "train", fn, kind=kind, batch_size=batch_size,
                 overwrite=True, log=lambda s: None,
                 sink=sink or (lambda v, **arrays: saved.append((v, arrays))), **kw)
    return result, saved


def assert_same_saves(got, want):
    assert [v for v, _ in got] == [v for v, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def split_threads():
    return {t for t in threading.enumerate() if t.name.startswith(SPLIT_THREADS)}


def bounded(call, seconds=120.0):
    """``call()`` on a thread of its own, which has to end within
    ``seconds``: its value, or its exception raised here."""
    box = {}

    def run():
        try:
            box["value"] = call()
        except BaseException as exc:  # handed to the test's thread below
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "the split did not end"
    if "error" in box:
        raise box["error"]
    return box["value"]


def host_embed(audio):
    """(B, N) -> (B, 3): a host function of the chunk."""
    a = np.asarray(audio, np.float32)
    return np.stack([a.mean(1), a.std(1), a[:, :10].sum(1)], 1)


# --- the stored bits: both jobs against the plain loop -------------------------------------------

@pytest.fixture(scope="module")
def dev_fns(project):
    """The embed and decode functions of the dev Whisper in f32 on the CPU."""
    config = project[0]
    return {"x_concat": TEB.make_encoder_embed_fn(config, device="cpu", dtype=torch.float32),
            "hs": TEB.make_decoder_embed_fn(config, max_len=12, device="cpu",
                                            dtype=torch.float32)}


@pytest.mark.parametrize("kind,batch_size,n_workers", [
    ("x_concat", 3, 4), ("x_concat", 4, 1), ("hs_last_seq", 3, 4), ("hs_last_all", 3, 2),
])
def test_both_jobs_store_the_bits_of_a_sequential_loop(project, dev_fns, kind, batch_size,
                                                       n_workers):
    config, md = project
    fn = dev_fns["x_concat" if kind == "x_concat" else "hs"]
    result, got = bounded(lambda: run_split(config, md, fn, kind, batch_size,
                                            n_workers=n_workers))
    want = plain_split(config, md, fn, kind, batch_size)
    assert_same_saves(got, want)
    assert result["done"] == _versions(config, md) and result["incomplete"] == []
    assert result["throughput"]["total_items"] == 13


# --- exceptions: what is saved, what reaches the caller, no thread left --------------------------

@pytest.mark.parametrize("where,k", [("fn", 0), ("fn", 1), ("fn", 3), ("feed", 1), ("feed", 3)])
def test_an_exception_at_batch_k_keeps_the_songs_before_it(project, monkeypatch, where, k):
    """Batches of 3: the embed function raises at its call ``k``, or the
    feed at the song whose first chunk opens batch ``k`` (its decode and
    chunking on the feed's thread); the songs whose chunks all lie in the
    batches before ``k`` are saved, in order, and no decode or prefetch
    thread outlives the split."""
    config, md = project
    entries = _entries(config, md)
    last = {v: pos for pos, (v, _, _, _) in enumerate(entries)}  # each song's last chunk
    want = [v for v in _versions(config, md) if last[v] < 3 * k]
    calls = []

    def fn(audio):
        if where == "fn" and len(calls) == k:
            raise RuntimeError("embed failed")
        calls.append(1)
        return host_embed(audio)

    if where == "feed":
        starts = [v for pos, (v, j, _, _) in enumerate(entries) if j == 0 and pos == 3 * k]
        bad = _versions(config, md).index(starts[0])
        seen = []

        def chunks(audio, *a, **kw):
            seen.append(1)
            if len(seen) == bad + 1:
                raise RuntimeError("decode failed")
            return chunk_waveform(audio, *a, **kw)

        monkeypatch.setattr(TEB, "chunk_waveform", chunks)
    before = split_threads()
    saved = []
    with pytest.raises(RuntimeError, match="failed"):
        bounded(lambda: run_split(config, md, fn, "x_concat", 3, n_workers=4,
                                  sink=lambda v, **arrays: saved.append(v)))
    assert saved == want and len(calls) == k
    assert not split_threads() - before


@pytest.mark.parametrize("song", ["100", "301"])
def test_an_exception_in_save_reaches_the_caller(project, song):
    """The sink raises at the first song saved or at the last: the split
    stops at that batch, nothing hangs and no thread of the split is left."""
    config, md = project
    calls = []

    def fn(audio):
        calls.append(1)
        return host_embed(audio)

    def sink(v, **arrays):
        if v == song:
            raise OSError(f"store full at {v}")

    before = split_threads()
    with pytest.raises(OSError, match=f"store full at {song}"):
        bounded(lambda: run_split(config, md, fn, "x_concat", 1, n_workers=2, sink=sink))
    # batches of one chunk: the song's last chunk is the last call
    assert len(calls) == 1 + max(pos for pos, e in enumerate(_entries(config, md))
                                 if e[0] == song)
    assert not split_threads() - before


# --- buffers: never refilled in flight --------------------------------------------------------

@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_no_buffer_is_refilled_while_its_batch_is_in_flight(project, monkeypatch, batch_size):
    """A recording embed function: each call's input stays as the call saw
    it until the batch's outputs are home (``_host``), and the feed fills no
    buffer in between, with the feed running ahead and threads switched
    often."""
    config, md = project
    log, inflight = [], []
    padded, host = TEB._padded, TEB._host

    def fill(batch, buf):
        log.append(("fill", buf.data_ptr()))
        return padded(batch, buf)

    def home(out):
        audio, seen = inflight.pop()
        time.sleep(0.002)
        assert torch.equal(audio, seen), "the buffer changed while its batch was in flight"
        got = host(out)
        log.append(("home", audio.data_ptr()))
        return got

    def fn(audio):
        log.append(("call", audio.data_ptr()))
        inflight.append((audio, audio.clone()))
        time.sleep(0.005)
        return host_embed(audio)

    monkeypatch.setattr(TEB, "_padded", fill)
    monkeypatch.setattr(TEB, "_host", home)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        result, saved = bounded(lambda: run_split(config, md, fn, "x_concat", batch_size,
                                                  n_workers=4))
    finally:
        sys.setswitchinterval(interval)
    assert result["done"] == _versions(config, md)
    busy = set()
    for event, ptr in log:
        if event == "fill":
            assert ptr not in busy, "a buffer was refilled while its batch was in flight"
        elif event == "call":
            busy.add(ptr)
        else:
            busy.discard(ptr)
    assert sum(e == "call" for e, _ in log) == -(-13 // batch_size)


# --- the pieces ---------------------------------------------------------------------------------

def test_padded_zeroes_the_rows_after_the_batch(project):
    config, md = project
    entries = _entries(config, md)[:2]
    buf = torch.full((3, N_SAMPLES), 7.0)
    out = TEB._padded(entries, buf)
    assert out is buf
    np.testing.assert_array_equal(out[0].numpy(), entries[0][3])
    np.testing.assert_array_equal(out[1].numpy(), entries[1][3])
    assert not out[2].any()


def test_host_copies_host_outputs_as_f32_numpy():
    """Host outputs take the plain route: bf16 widened exactly, integers
    kept, numpy passed through."""
    x = torch.randn(4, 5, 6).to(torch.bfloat16)
    n = torch.arange(4)
    a = np.ones((4, 2), np.float64)
    got = TEB._host((x, n, a))
    assert got[0].dtype == np.float32 and np.array_equal(got[0], x.float().numpy())
    assert got[1].dtype == np.int64 and np.array_equal(got[1], n.numpy())
    assert got[2].dtype == np.float32 and np.array_equal(got[2], a)
    assert len(TEB._host(x)) == 1


def test_prefetch_close_stops_its_thread_and_closes_the_source():
    closed = []

    def source():
        try:
            yield from range(100)
        finally:
            closed.append(1)

    before = split_threads()
    it = prefetch(source(), depth=2, transform=lambda i: i * 2)
    assert [next(it) for _ in range(3)] == [0, 2, 4]
    it.close()
    assert closed == [1] and not split_threads() - before


# --- on the card ----------------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fn_gets_a_page_locked_host_batch(project, card):
    config, md = project
    seen = []

    def fn(audio):
        seen.append((audio.device.type, audio.is_pinned(), audio.dtype, tuple(audio.shape)))
        return TEB._chunks(audio, card)[:, :3]

    result, saved = run_split(config, md, fn, "x_concat", 4)
    assert result["done"] == _versions(config, md) and len(seen) == 4
    assert set(seen) == {("cpu", True, torch.float32, (4, N_SAMPLES))}
    want = plain_split(config, md, lambda a: a[:, :3], "x_concat", 4)
    assert_same_saves(saved, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [((16, 224, 1280), (16,)), ((32, 1280),)])
def test_outputs_come_home_with_the_bits_of_float_cpu(card, shapes):
    """The decoder's hidden states and lengths, and the encoder's pooled
    rows, bf16 on the card: ``_host`` gives the bits of ``.float().cpu()``."""
    g = torch.Generator(device=card).manual_seed(0)
    outs = [torch.randn(shapes[0], generator=g, device=card).to(torch.bfloat16) * 30]
    if len(shapes) > 1:
        outs.append(torch.randint(4, 224, shapes[1], generator=g, device=card))
    got = TEB._host(tuple(outs))
    for a, x in zip(got, outs):
        want = (x.float() if x.is_floating_point() else x).cpu().numpy()
        assert a.dtype == want.dtype and a.shape == want.shape
        assert np.array_equal(a.view(np.uint8), want.view(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["x_concat", "hs_last_seq"])
def test_card_jobs_store_the_bits_of_a_sequential_loop(project, card, kind):
    """The tiny Whisper in bf16 on the card: both jobs against the plain
    loop's pageable upload and ``.float().cpu()``."""
    config, md = project
    conf = config.to_dict()
    config = Config.from_dict({**conf, "model": {**conf["model"], "whisper_size": "tiny"}})
    if kind == "x_concat":
        fn = TEB.make_encoder_embed_fn(config, device=card)
    else:
        fn = TEB.make_decoder_embed_fn(config, max_len=24, device=card)
    result, got = run_split(config, md, fn, kind, 4)
    assert_same_saves(got, plain_split(config, md, fn, kind, 4))
    assert result["done"] == _versions(config, md)
