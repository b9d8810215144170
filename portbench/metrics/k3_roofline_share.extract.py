"""K3's share of its roofline in the traced window, in %: the bound of the
encoder's MLP calls (each batch runs one a block over B * 1500 rows of the
configuration's width; counts in ``portbench/counts/k3.py``, bound in
``portbench/peaks.py``) over the summed durations of K3's launches
(``mlp_gemm_kernel``, both products of a call) in the trace."""

from portbench import peaks
from portbench.counts import k3

KERNEL = "mlp_gemm_kernel"


def read(record):
    trace, calls = record.get("trace"), record.get("calls")
    if trace is None or not calls:
        return None
    seconds, launches = trace.kernel_s(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    cfg, B = record["config"], record["cell"]["batch_size"]
    shape = (B * cfg["max_source_positions"], cfg["d_model"], cfg["encoder_ffn_dim"])
    one, _ = peaks.bound_s(k3.bytes_moved(*shape), k3.ops(*shape))
    return 100.0 * len(calls) * cfg["encoder_layers"] * one / seconds
