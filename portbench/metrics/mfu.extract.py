"""The whole step's share of the card's bf16 peak in the traced window, in
%: the model FLOPs of the real chunks whose batches ran in it (the encoder's,
plus the decoder's over each chunk's decoded positions for the ``hs_*``
kinds; ``portbench/counts/whisper.py``) over (window x 989 TFLOP/s)."""

from portbench import peaks
from portbench.counts import whisper


def read(record):
    trace, calls = record.get("trace"), record.get("calls")
    if trace is None or not calls or trace.window_s <= 0:
        return None
    cfg = record["config"]
    flops = 0.0
    for _, _, rows, lengths in calls:
        flops += rows * whisper.encoder_flops(cfg)
        flops += sum(whisper.decoder_flops(cfg, int(n)) for n in lengths)
    return 100.0 * flops / (trace.window_s * peaks.PEAK_OPS_PER_S["bf16"])
