"""Length forcing and overlapped framing, the counterpart of
``wealy_tpu.ops.framing`` (the reference's ``force_length``, ``frames``
and ``get_frames``, lib/tensor_ops.py:35-107).

The pad and cut decisions depend on static sizes only. The random choices
(``pad_mode="crazy"``, ``cut_mode="random"``) draw from an explicit
``torch.Generator`` where the JAX module takes a PRNG key: the draws are
not ``jax.random``'s, so a random cut or pad agrees with the JAX one in its
properties (a contiguous window, blocks of the input or zeros), not in its
values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _random_cut(x: torch.Tensor, length: int, axis: int,
                generator: torch.Generator) -> torch.Tensor:
    max_start = x.shape[axis] - length
    start = int(torch.randint(0, max_start + 1, (), generator=generator))
    return x.narrow(axis, start, length)


def force_length(
    x: torch.Tensor,
    length: int,
    axis: int = -1,
    pad_mode: str = "repeat",
    cut_mode: str = "start",
    allow_longer: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Pad (by tiling / zeros / random side) or cut ``axis`` to exactly ``length``.

    - ``pad_mode``: "repeat" (tile x), "zeros" (append zero blocks), "crazy"
      (each doubling step appends or prepends x or zeros at random; needs
      ``generator``).
    - ``cut_mode``: "start" (keep the head), "end" (keep the tail), "random"
      (a random window; needs ``generator``).
    """
    assert pad_mode in ("repeat", "zeros", "crazy")
    assert cut_mode in ("start", "end", "random")
    x = torch.as_tensor(x)
    axis = axis % x.ndim
    size = x.shape[axis]
    if size == length or (size > length and allow_longer):
        return x

    aux = x
    if pad_mode == "crazy" and size < length:
        if generator is None:
            raise ValueError("pad_mode='crazy' requires an explicit torch.Generator")
        zeros = torch.zeros_like(x)
        while aux.shape[axis] < length:
            r = int(torch.randint(0, 4, (), generator=generator))
            block = x if r < 2 else zeros
            aux = torch.cat([aux, block] if r % 2 == 0 else [block, aux], dim=axis)
    else:
        while aux.shape[axis] < length:
            block = x if pad_mode == "repeat" else torch.zeros_like(x)
            aux = torch.cat([aux, block], dim=axis)

    if not allow_longer and aux.shape[axis] > length:
        if cut_mode == "start":
            aux = aux.narrow(axis, 0, length)
        elif cut_mode == "end":
            aux = aux.narrow(axis, aux.shape[axis] - length, length)
        else:
            if generator is None:
                raise ValueError("cut_mode='random' requires an explicit torch.Generator")
            aux = _random_cut(aux, length, axis, generator)
    return aux


def frames(
    signal: torch.Tensor,
    frame_length: int,
    frame_step: int,
    pad_end: bool = False,
    pad_value: float = 0.0,
    axis: int = -1,
) -> torch.Tensor:
    """Overlapped framing (``torch.Tensor.unfold``): ``axis`` becomes the
    frame axis and the ``frame_length`` samples a new last axis. With
    ``pad_end``, the end is padded so that the tail samples are covered
    (lib/tensor_ops.py:78-89)."""
    signal = torch.as_tensor(signal)
    axis = axis % signal.ndim
    if pad_end:
        frames_overlap = frame_length - frame_step
        rest = abs(signal.shape[axis] - frames_overlap) % abs(frame_step)
        if rest != 0:
            pad = [0, 0] * (signal.ndim - 1 - axis) + [0, int(frame_length - rest)]
            signal = torch.nn.functional.pad(signal, pad, value=pad_value)
    return signal.unfold(axis, frame_length, frame_step)


def get_frames(
    x: torch.Tensor,
    length: int,
    step: int,
    axis: int = -1,
    pad_end: bool = True,
    pad_mode: str = "zeros",
    cut_mode: str = "start",
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Frame ``axis`` into overlapping windows, first force-padding so that
    the last window is complete (lib/tensor_ops.py:92-107)."""
    x = torch.as_tensor(x)
    axis = axis % x.ndim
    if pad_end:
        newlength = max(int(math.ceil((x.shape[axis] - length) / step)), 0) * step + length
        x = force_length(x, newlength, axis=axis, pad_mode=pad_mode, cut_mode=cut_mode,
                         allow_longer=False, generator=generator)
    return x.unfold(axis, length, step)
