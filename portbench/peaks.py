"""The card's published peaks and the roofline bound.

NVIDIA's data sheet for the H100 SXM (dense rates, no sparsity). The bound is
the least time the card could take for a piece of work: the larger of its
bytes over the memory rate and its operations over the peak rate of the
type it computes in (a copy of ``bound`` in the repository's ``chip_smoke.py``,
kept here so that the yardstick does not move with the program).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def bound_s(n_bytes: float, n_ops: float, kind: str = "bf16") -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move ``n_bytes`` and do ``n_ops`` operations of ``kind``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
