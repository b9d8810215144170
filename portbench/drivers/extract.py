"""The extraction driver: the port's split jobs over an audio project.

It builds the project of the cell's traffic block, draws the seeded weights,
makes the port's embed function (``make_encoder_embed_fn`` for ``x_concat``,
``make_decoder_embed_fn`` for the ``hs_last_*`` kinds) and runs the port's
split function (``extract_split_batched`` / ``extract_split_batched_decoder``)
with a ``sink`` that keeps what the check needs, so nothing is stored. The
function handed to the split function is wrapped (:class:`Window`):

- the first ``warmup_batches`` calls are set-up (they build the kernels and
  warm every shape: the embed function sees one batch shape);
- the window opens at the entry of the next call, a batch boundary, and
  closes at the entry of the first call ``seconds`` or more after it; the
  split function copies each batch's result to the host before it makes the
  next call, so the batches called inside the window are the ones whose
  results came back inside it;
- with ``--trace 1`` the wrapper synchronises before it returns; the first
  ``trace_skip`` batches of the window are timed so, unprofiled (the host
  clock's per-layer metrics read them: the profiler's cost on a host-bound
  loop would distort them), and a profiler then covers ``trace_batches``
  whole batches (markers at the entries of the first and of the one after
  the last; the device's metrics read these); that window does not close
  before the traced batches have run.

Once the window has closed, the check samples songs that completed inside it
(the one with most chunks among them) and holds the port's answers against
the plain reference (``portbench/reference``), which works them out again
from the WAV files and the seeded state dict:

- ``x_concat``: each chunk's mean-pooled encoder state: the widest relative
  error over the sampled chunks (``emb_rel_err``, which a row out of place
  fails) and the median chunk's (``emb_rel_err_median``, steady from seed to
  seed, which the lower-precision control fails: the widest swings with a
  quiet chunk);
- ``hs_last_seq``: the song's rows are split into chunks along the port's
  own greedy tokens (each token is the argmax of the row before it against
  the bf16-rounded embedding, as the port's decode step computes it); the
  reference decodes teacher-forced along those tokens, and the check reads
  the relative error of the decoder's final states (``hs_rel_err``) and the
  widest gap by which a served token's logit lies below the reference's best
  (``token_gap``). The row after the last written one of a chunk that never
  emitted end-of-text is left out: the decode loop never writes position
  ``max_len - 1`` (the JAX package's buffer does the same).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import hostload, traces, traffic, weights

# top-2 logit gaps below this are ties to the recovery of the port's tokens:
# the port's f32 logits and ours differ by their order of summation only
TIE = 1e-4


class Closed(Exception):
    """The window has closed: raised out of the split function."""


class Window:
    """The embed function the split function calls, timed (see the module
    docstring)."""

    def __init__(self, fn, *, seconds: float, warmup: int, trace: bool, trace_skip: int,
                 trace_batches: int, batch_size: int, decoder: bool):
        self.fn, self.seconds, self.warmup = fn, seconds, warmup
        self.trace, self.batch_size, self.decoder = trace, batch_size, decoder
        self.trace_from = warmup + trace_skip
        self.trace_to = self.trace_from + trace_batches
        self.calls = 0
        self.t_open = self.t_close = None
        self.chunks = 0  # real chunks called inside the window
        self.synced: list = []  # (t_in, t_out, rows, [lengths]) before the profiler
        self.traced: list = []  # the same of the profiled calls
        self.synced_end = None  # host clock at the entry of the first profiled call
        self.prof = None
        self.stopped = False
        self.host_open = self.host = None

    def _mark(self, name: str) -> None:
        import torch

        with torch.profiler.record_function(name):
            pass

    def _sync(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def __call__(self, audio):
        now = time.perf_counter()
        i = self.calls
        if i == self.warmup:
            self.host_open = hostload.snapshot()  # before the opening: its probe is not timed
            self.t_open = now = time.perf_counter()
        elif (i > self.warmup and now - self.t_open >= self.seconds
              and (not self.trace or self.stopped)):
            self.t_close = now
            self.host = hostload.between(self.host_open, hostload.snapshot())
            raise Closed
        if self.trace and i == self.trace_from:
            self.synced_end = now
            self._sync()
            self.prof = traces.capture()
            self._mark(traces.WINDOW_START)
        if self.trace and i == self.trace_to and self.prof is not None:
            self._mark(traces.WINDOW_END)
            self._sync()
            self.prof.stop()
            self.stopped = True
        rows = self.batch_size
        if not bool(audio[-1].any()):  # a partial batch is padded with zero rows at its end
            rows = int(audio.reshape(audio.shape[0], -1).any(dim=1).sum())
        t_in = time.perf_counter()
        out = self.fn(audio)
        if self.trace:
            self._sync()
        t_out = time.perf_counter()
        if self.t_open is not None:
            self.chunks += rows
            if self.trace and i < self.trace_to:
                lengths = out[1][:rows].tolist() if self.decoder else []
                calls = self.traced if i >= self.trace_from else self.synced
                calls.append((t_in, t_out, rows, lengths))
        self.calls += 1
        return out


def _factory(eb, config, sd, cell: dict, variant: str, device):
    """The port's embed function; with the ``control`` variant, the
    program's own lower-precision path where the cell names one
    (``"control": {"program": {keyword: value}}``)."""
    control = cell["control"].get("program", {}) if variant == "control" else {}
    if cell["kind"] == "x_concat":
        return eb.make_encoder_embed_fn(config, sd, device=device, **control)
    return eb.make_decoder_embed_fn(config, sd, language=cell["language"],
                                    max_len=cell["max_len"], device=device, **control)


def run(ctx) -> dict:
    """One run of an extraction cell (``ctx``: see ``portbench/harness.py``)."""
    import torch

    cell, cfg = ctx.cell, ctx.config
    decoder = cell["kind"].startswith("hs_last")
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        project = traffic.audio_project(tmp, cell["traffic"], ctx.seed, cfg["port_model"])
        from wealy_tpu_torch.cli import extract_batched as eb
        from wealy_tpu_torch.data.dataset import build_clean_dataset
        from wealy_tpu_torch.train.config import Config

        config = Config.from_file(project["config"])
        md, _ = build_clean_dataset(config, check_audio=True, log=lambda s: None)
        sd = weights.whisper_state_dict(cfg, ctx.seed, ctx.device)
        fn = _factory(eb, config, sd, cell, ctx.variant, ctx.device)
        del sd
        if ctx.fault is not None:
            fn = ctx.fault(fn)
        window = Window(fn, seconds=ctx.seconds, warmup=cell["warmup_batches"],
                        trace=ctx.trace, trace_skip=cell["trace_skip"],
                        trace_batches=cell["trace_batches"], batch_size=cell["batch_size"],
                        decoder=decoder)
        done: dict = {}

        def sink(version_key, **arrays):
            done[version_key] = (time.perf_counter(), arrays["embeddings"])

        split = eb.extract_split_batched_decoder if decoder else eb.extract_split_batched
        try:
            split(config, md, project["split"], window, kind=cell["kind"],
                  batch_size=cell["batch_size"], overwrite=True, sink=sink, log=lambda s: None)
        except Closed:
            pass
        else:
            raise RuntimeError("the split ended before the window closed: give the traffic "
                               "more versions")
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
        out = {
            "end_to_end": {"extract_chunks_per_s": window.chunks / (window.t_close - window.t_open),
                           "setup_s": window.t_open - ctx.t0},
            "attempted": window.chunks, "failed": 0, "memory_peak_bytes": peak,
            "host": window.host,
        }
        if window.prof is not None and not window.stopped:  # closed first: no trace
            window.prof.stop()
        window.fn = fn = None
        gc.collect()
        if ctx.trace:
            out["record"] = {"cell": cell, "config": cfg, "calls": window.traced,
                             "synced": window.synced,
                             "synced_window": (window.t_open, window.synced_end),
                             "trace": traces.read(window.prof) if window.stopped else None}
        in_window = {v: arr for v, (t, arr) in done.items()
                     if window.t_open <= t <= window.t_close}
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        out["checks"] = check(ctx, cell, cfg, project["versions"], in_window)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sample(in_window: dict, n: int, seed: int) -> list:
    """The song with most chunks (rows) that completed in the window and
    ``n - 1`` others drawn from the seed."""
    keys = sorted(in_window, key=lambda v: (-len(in_window[v]), v))
    if not keys:
        return []
    rest = keys[1:]
    rng = np.random.default_rng(seed + 7)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [keys[0]] + [rest[int(i)] for i in pick]


def check(ctx, cell: dict, cfg: dict, versions: dict, in_window: dict) -> dict:
    """{number: value} of the comparison with the reference."""
    import torch

    from portbench.reference import audio as ref_audio
    from portbench.reference import whisper as ref

    dev = ctx.device
    picked = sample(in_window, cell["check"]["songs"], ctx.seed)
    decoder = cell["kind"].startswith("hs_last")
    numbers = {"songs_checked": float(len(picked))}
    worst = {"emb_rel_err": 0.0} if not decoder else {"hs_rel_err": 0.0, "token_gap": 0.0}
    unmatched, chunk_errs = 0, []
    sd = weights.whisper_state_dict(cfg, ctx.seed, dev)
    with torch.no_grad(), ref.exact():
        for v in picked:
            x, sr = ref_audio.read_wav(versions[v])
            chunks = ref_audio.chunks(ref_audio.resample(x, sr, dev))
            states = _states(sd, cfg, chunks)
            port = torch.as_tensor(np.asarray(in_window[v], np.float32), device=dev)
            if not decoder:
                if port.shape[0] != len(chunks):
                    unmatched += 1
                    continue
                ref_emb = states.mean(dim=1)
                chunk_errs += ((port - ref_emb).norm(dim=1) / ref_emb.norm(dim=1)).tolist()
                continue
            got = _check_decoder(sd, cfg, cell, port, states)
            if got is None:
                unmatched += 1
                continue
            worst["hs_rel_err"] = max(worst["hs_rel_err"], got[0])
            worst["token_gap"] = max(worst["token_gap"], got[1])
    del sd
    if not decoder and chunk_errs:
        worst["emb_rel_err"] = max(chunk_errs)
        numbers["emb_rel_err_median"] = float(np.median(chunk_errs))
    numbers.update(worst)
    numbers["songs_unmatched"] = float(unmatched)
    return numbers


def _states(sd, cfg, chunks):
    """The reference's encoder states of a song's chunks, four at a time."""
    import torch

    from portbench.reference import mel as ref_mel
    from portbench.reference import whisper as ref

    return torch.cat([ref.encode(sd, cfg, ref_mel.log_mel(chunks[i:i + 4],
                                                          cfg["num_mel_bins"]).float())
                      for i in range(0, len(chunks), 4)])


def _prompt(cfg: dict, language) -> list:
    """<|startoftranscript|> [<|lang|> <|transcribe|>] <|notimestamps|> of
    the multilingual vocabulary's layout (openai-whisper's tokenizer)."""
    sot = 50258
    n_lang = 99 + max(0, cfg["vocab_size"] - 51865)
    translate = sot + 1 + n_lang
    toks = [sot] if language is None else [sot, sot + 1 + language, translate + 1]
    return toks + [translate + 5]


def _recover(port, e_round, n_chunks: int, prompt: list, max_len: int, eot: int):
    """The port's rows of one song split into chunks along its own greedy
    tokens: [(first row, length, tokens, [(position, runner-up)])], or None
    when the rows do not split into ``n_chunks`` chunks."""
    import torch

    logits = port @ e_round.T
    top2 = torch.topk(logits, 2, dim=1)
    arg = top2.indices[:, 0].tolist()
    gap = (top2.values[:, 0] - top2.values[:, 1]).tolist()
    second = top2.indices[:, 1].tolist()
    P, R, o, out = len(prompt), port.shape[0], 0, []
    for _ in range(n_chunks):
        L = max_len
        for j in range(o + P - 1, o + max_len - 1):
            if j >= R:
                return None
            if arg[j] == eot:
                L = j + 1 - o
                break
        if o + L > R:
            return None
        toks = prompt + [arg[j] for j in range(o + P - 1, o + L - 1)]
        ties = [(j - o, second[j]) for j in range(o + P - 1, o + L - 1)
                if gap[j] < TIE and eot not in (arg[j], second[j])]
        out.append((o, L, toks, ties))
        o += L
    return out if o == R else None


def _check_decoder(sd, cfg, cell, port, states):
    """(hidden relative error, widest token gap) of one song, or None."""
    import torch

    from portbench.reference import whisper as ref

    prompt = _prompt(cfg, cell["language"])
    eot, max_len = weights.EOT, cell["max_len"]
    e_round = sd["decoder.token_embedding.weight"].to(torch.bfloat16).float()
    chunks = _recover(port, e_round, states.shape[0], prompt, max_len, eot)
    if chunks is None:
        return None
    worst_err = worst_gap = 0.0
    for c, (o, L, toks, ties) in enumerate(chunks):
        n = min(L, max_len - 1)
        rows = port[o:o + n]

        def forward(tokens):
            t = torch.tensor([tokens], device=port.device)
            h, lg = ref.decode(sd, cfg, t, states[c:c + 1])
            return h[0], lg[0]

        h, lg = forward(toks)
        for j, alt in ties:  # a tie: keep the token whose next row the port's matches
            if j + 2 > n:
                continue
            toks2 = list(toks)
            toks2[j + 1] = alt
            h2, lg2 = forward(toks2)
            if (rows[j + 1] - h2[j + 1]).norm() < (rows[j + 1] - h[j + 1]).norm():
                toks, h, lg = toks2, h2, lg2
        pos = torch.arange(len(prompt) - 1, n, device=port.device)
        err = float((rows - h[:n]).norm() / h[:n].norm())
        served = [toks[j + 1] if j + 1 < L else eot for j in range(len(prompt) - 1, n)]
        sl = lg[pos]
        gaps = sl.max(dim=1).values - sl[torch.arange(len(pos), device=port.device),
                                          torch.tensor(served, device=port.device)]
        worst_err = max(worst_err, err)
        worst_gap = max(worst_gap, float(gaps.max()) if len(pos) else 0.0)
    return worst_err, worst_gap
