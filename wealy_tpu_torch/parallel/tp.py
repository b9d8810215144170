"""Tensor parallelism for the Whisper family on a (``data``, ``model``)
mesh, the counterpart of ``wealy_tpu.parallel.tp``.

The split is Megatron's, written over openai-whisper state-dict names
(torch's ``(out, in)`` weight is flax's ``(in, out)`` kernel transposed):

  attn / cross_attn query, key, value weight  (D, D)  -> dim 0   heads split over ranks
  their query / value biases                  (D,)    -> dim 0
  attn / cross_attn out weight                (D, D)  -> dim 1   row-parallel, reduced after
  mlp.0 weight (4D, D) and bias (4D,)                 -> dim 0   column-parallel
  mlp.2 weight (D, 4D)                                -> dim 1   row-parallel, reduced after

``attn.key`` has no bias; everything else (convs, LayerNorms, embeddings,
the row-parallel biases) is replicated. The JAX package states the split as
parameter shardings and lets GSPMD place the collectives; torch shards
explicitly. :func:`shard_params` gives each rank its own contiguous shard
(K2 and K3 take TMA tiles from contiguous, 16-byte aligned bases), and
:func:`tp_module` builds the rank's modules (``models/whisper/model.py``
with a :class:`TensorParallel` context): an attention module holds
``n_head / n`` heads and an MLP ``4D / n`` columns, and each rank calls the
same kernels (K2, K3, in training K5a/K5b) on its shard. The JAX package
turns its Pallas kernels off under TP only because ``pallas_call`` has no
GSPMD partitioning rule; the function computed is the same.

Two autograd operators carry the split (``parallel/mesh.py::collective``):
identity forward / all-reduce backward at a column-parallel input, and
all-reduce forward / identity backward at a row-parallel output, whose bias
is added once, after the reduction (in f32, then rounded to the compute
dtype). Sequence parallelism (``sequence_parallel=True``, the encoder only)
shards the residual stream between blocks on time over the ``model`` axis:
an all-gather going into each Megatron region and a reduce-scatter coming
out replace the identity and the all-reduce, so LayerNorms and residual
adds run on ``T / n`` time steps per rank.

The decode (:func:`tp_decode_fn`) keeps per-rank KV caches of ``H / n``
heads (bf16 or float8, self and cross); the only cross-rank traffic is the
row-parallel all-reduce of each layer at every step. Training
(:func:`tp_grad_norm`, ``train/step.py``): sharded parameters' gradients
are never reduced over ``model``; the global norm that clipping takes sums
their squares over ``model`` and counts each replicated parameter once.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from wealy_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    collective,
    local_chunk,
    make_mesh,
    shard_rows,
)

# state-dict name suffixes of the split parameters -> the dimension split
_RULES = (
    ("attn.query.weight", 0), ("attn.query.bias", 0), ("attn.key.weight", 0),
    ("attn.value.weight", 0), ("attn.value.bias", 0), ("attn.out.weight", 1),
    ("cross_attn.query.weight", 0), ("cross_attn.query.bias", 0),
    ("cross_attn.key.weight", 0), ("cross_attn.value.weight", 0),
    ("cross_attn.value.bias", 0), ("cross_attn.out.weight", 1),
    ("mlp.0.weight", 0), ("mlp.0.bias", 0), ("mlp.2.weight", 1),
)
_BLOCK = re.compile(r"(^|\.)blocks\.\d+\.(.+)$")


def param_shard_dim(name: str) -> Optional[int]:
    """The dimension a Whisper block parameter splits on over ``model``
    (None: replicated). ``name`` may sit under any prefix
    (``encoder.blocks.3.mlp.0.weight``, ``encoder.encoder.blocks...`` of an
    ``EncoderHead``)."""
    m = _BLOCK.search(name)
    if m is None:
        return None
    for suffix, dim in _RULES:
        if m.group(2) == suffix:
            return dim
    return None


def whisper_param_shardings(params: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """Name -> the dimension each parameter splits on over the ``model``
    axis (None: replicated), for a Whisper state dict or any module's
    parameters that hold Whisper blocks."""
    return {name: param_shard_dim(name) for name in params}


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of every parameter (its ``model`` coordinate's
    contiguous chunk of each split one, each replicated one whole)."""
    return {name: t if param_shard_dim(name) is None
            else local_chunk(mesh, t, "model", param_shard_dim(name))
            for name, t in state_dict.items()}


def make_tp_mesh(n_model: int, n_data: Optional[int] = None, device=None) -> Mesh:
    """(data, model) mesh of the process group, ``model`` innermost
    (neighbouring ranks split one model); ``n_data`` defaults to the world
    size over ``n_model``."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"(data={n_data}, model={n_model}) does not hold {world} rank(s)")
    return make_mesh(("data", "model"), (n_data, n_model), device=device)


class TensorParallel:
    """The tensor-parallel context of a model's modules: the mesh's
    ``model`` axis and whether the encoder runs sequence parallel."""

    axis = "model"

    def __init__(self, mesh: Mesh, sequence_parallel: bool = False):
        self.mesh = mesh
        self.size = mesh.size(self.axis)
        self.sequence_parallel = sequence_parallel

    def plain(self) -> "TensorParallel":
        """The same split without sequence parallelism (the decoder's)."""
        return TensorParallel(self.mesh) if self.sequence_parallel else self

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated input of a column-parallel layer."""
        return collective(x, self.mesh, self.axis, "identity", "all_reduce")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a Megatron region: the replicated input, or under sequence
        parallelism the whole sequence gathered from the ranks' slices."""
        if self.sequence_parallel:
            return collective(x, self.mesh, self.axis, "all_gather", "reduce_scatter", dim=1)
        return self.copy(x)

    def exit(self, partial: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """Out of a Megatron region: the row-parallel partial sums reduced
        in f32 (reduce-scattered along time under sequence parallelism),
        ``bias`` added once, rounded to the partial's dtype."""
        fwd, bwd = (("reduce_scatter", "all_gather") if self.sequence_parallel
                    else ("all_reduce", "identity"))
        total = collective(partial.float(), self.mesh, self.axis, fwd, bwd, dim=1)
        if bias is not None:
            total = total + bias.float()
        return total.to(partial.dtype)

    def split_time(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's ``T / n`` time steps of a replicated (B, T, D) stream."""
        return collective(x, self.mesh, self.axis, "split", "all_gather", dim=1)

    def gather_time(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (B, T, D) stream from the ranks' slices, replicated."""
        return collective(x, self.mesh, self.axis, "all_gather", "split", dim=1)


def tp_module(module: nn.Module, mesh: Mesh, sequence_parallel: bool = False) -> nn.Module:
    """This rank's tensor-parallel copy of a ``Whisper``, ``WhisperEncoder``
    or ``WhisperDecoder`` (full weights, on any device): the same class
    built with a :class:`TensorParallel` context on the mesh's device,
    holding the rank's shard of every split parameter."""
    tp = TensorParallel(mesh, sequence_parallel)
    out = type(module)(module.config, dtype=module.dtype, device=mesh.device, tp=tp)
    out.load_state_dict(shard_params(module.state_dict(), mesh))
    return out.train(module.training)


def tp_encode_fn(model: nn.Module, mesh: Mesh, sequence_parallel: bool = False):
    """``encode(mel) -> (B, T, D)`` states on every rank: the mel batch
    sharded over ``data``, each data slice through the tensor-parallel
    encoder of ``model`` (a ``Whisper`` or ``WhisperEncoder`` with full
    weights), the rows gathered back. ``sequence_parallel``: Megatron
    sequence parallelism between blocks (see the module doc)."""
    encoder = getattr(model, "encoder", model)
    tp_encoder = tp_module(encoder, mesh, sequence_parallel)
    encode = shard_rows(mesh, lambda mel: tp_encoder(mel.to(mesh.device)))
    encode.module = tp_encoder
    return encode


def tp_decode_fn(model: nn.Module, mesh: Mesh, config, prompt, max_len: int = 224, eot=None,
                 cross_kv_dtype=None, self_kv_dtype=None):
    """``decode(mel) -> {tokens, lengths, hidden, sum_logprob,
    nospeech_prob}`` (``models/whisper/generate.py::greedy_decode``'s dict,
    every row of the batch on every rank): the mel batch sharded over
    ``data``, each slice encoded and greedily decoded by the
    tensor-parallel copy of ``model`` (a full ``Whisper``), with per-rank
    KV caches of the rank's heads."""
    from wealy_tpu_torch.models.whisper.generate import greedy_decode

    tp_model = tp_module(model, mesh)

    @torch.no_grad()
    def run(mel):
        states = tp_model.encode(mel.to(mesh.device))
        return greedy_decode(tp_model, states, config, prompt=prompt, max_len=max_len, eot=eot,
                             cross_kv_dtype=cross_kv_dtype, self_kv_dtype=self_kv_dtype)

    decode = shard_rows(mesh, run)
    decode.module = tp_model
    return decode


def tp_grad_norm(grads: Mapping[str, torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The global L2 norm of a tensor-parallel model's gradients (name ->
    this rank's gradient): the split parameters' squares summed over the
    ``model`` axis, each replicated parameter counted once, as JAX clips
    the global arrays."""
    split = [g.float().pow(2).sum() for n, g in grads.items() if param_shard_dim(n) is not None]
    whole = [g.float().pow(2).sum() for n, g in grads.items() if param_shard_dim(n) is None]
    dev = next(iter(grads.values())).device
    sq_split = torch.stack(split).sum() if split else torch.zeros((), device=dev)
    sq_whole = torch.stack(whole).sum() if whole else torch.zeros((), device=dev)
    return torch.sqrt(all_reduce(mesh, sq_split, "model") + sq_whole)
