"""Metric-learning losses with the contract
``loss_fn(z_label, z_idx, z, extra) -> (loss, logdict)``: the counterpart of
``wealy_tpu.losses`` (the same formulas and the same logdict keys; every
logdict value is a 0-d tensor)."""

from wealy_tpu_torch.losses.clews import CLEWSLoss, clews_loss
from wealy_tpu_torch.losses.ntxent import NTXentLoss, ntxent_loss
from wealy_tpu_torch.losses.triplet import TripletLoss, triplet_loss

__all__ = [
    "ntxent_loss",
    "NTXentLoss",
    "triplet_loss",
    "TripletLoss",
    "clews_loss",
    "CLEWSLoss",
    "get_loss",
]

_REGISTRY = {
    "ntxent": NTXentLoss,
    "triplet": TripletLoss,
    "clews": CLEWSLoss,
}


def get_loss(name: str, **kwargs):
    """Build a loss callable by name (``ntxent`` | ``triplet`` | ``clews``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
