"""K2's share of its roofline in the traced window, in %: the bound of the
encoder's attention calls (each batch runs one a block at (B, 1500, H, Dh)
of the configuration; counts in ``portbench/counts/k2.py``, bound in
``portbench/peaks.py``) over the summed durations of K2's launches
(``flash_fwd_kernel``) in the trace."""

from portbench import peaks
from portbench.counts import k2

KERNEL = "flash_fwd_kernel"


def read(record):
    trace, calls = record.get("trace"), record.get("calls")
    if trace is None or not calls:
        return None
    seconds, launches = trace.kernel_s(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    cfg, B = record["config"], record["cell"]["batch_size"]
    H, D, T = cfg["encoder_attention_heads"], cfg["d_model"], cfg["max_source_positions"]
    shape = (B, T, H, D // H)
    one, _ = peaks.bound_s(k2.bytes_moved(*shape), k2.ops(*shape))
    return 100.0 * len(calls) * cfg["encoder_layers"] * one / seconds
