"""Host-side utilities of the port; the mask-convention converters load on
first access, as ``wealy_tpu.utils`` exports them."""

from wealy_tpu_torch._lazy import lazy_getattr

_LAZY = {"wealy_tpu_torch.utils.masks": ("valid_to_excluded", "excluded_to_valid")}
__getattr__ = lazy_getattr(__name__, _LAZY)

__all__ = [
    "valid_to_excluded", "excluded_to_valid",
]
