"""The decode attention kernel's share of its roofline in the traced window,
in %: the bound of the greedy steps of the traced batches (each batch steps
from the prompt's length up to its longest row's, at most ``max_len`` - 1;
each step, in each decoder layer, a self-attention call over the positions
up to the step's and a cross-attention call over the audio frames, at the
cell's batch and the configuration's bf16; counts in
``portbench/counts/decode_attn.py``, bound in ``portbench/peaks.py``, the
products in f32 on the CUDA cores) over the summed durations of the
kernel's launches (``decode_attn``: its scores pass and its main pass) in
the trace. None where the trace holds no such launch (a program without the
kernel) or the batches decoded nothing."""

from portbench import peaks
from portbench.counts import decode_attn
from portbench.drivers.extract import _prompt

KERNEL = "decode_attn"


def read(record):
    trace, calls = record.get("trace"), record.get("calls")
    if trace is None or not calls:
        return None
    seconds, launches = trace.kernel_s(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    cell, cfg = record["cell"], record["config"]
    B, max_len = cell["batch_size"], cell["max_len"]
    P = len(_prompt(cfg, cell["language"]))
    bound = 0.0
    for _, _, _, lengths in calls:
        if not lengths:
            continue
        for t in range(P, min(max(lengths), max_len - 1)):
            for n_bytes, n_ops in decode_attn.step_calls(cfg, B, t):
                bound += peaks.bound_s(n_bytes, n_ops, "f32")[0]
    return 100.0 * bound / seconds if bound > 0 else None
