"""Parallelism of the port, the counterpart of ``wealy_tpu.parallel``: the
mesh of ``torch.distributed`` ranks and its collectives (``mesh.py``), the
global-batch loss (``collectives.py``), process-group set-up
(``multihost.py``), sharded similarity and corpus-scale ranking
(``similarity.py``), tensor and sequence parallelism (``tp.py``), pipeline
parallelism (``pp.py``) and ring attention (``ring.py``)."""

from wealy_tpu_torch.parallel.collectives import global_batch_loss
from wealy_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated
from wealy_tpu_torch.parallel.pp import make_pp_mesh, pp_encode_fn
from wealy_tpu_torch.parallel.ring import make_cp_mesh, ring_attention
from wealy_tpu_torch.parallel.similarity import sharded_pairwise_distance, sharded_topk
from wealy_tpu_torch.parallel.tp import make_tp_mesh, shard_params, tp_encode_fn

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "sharded_pairwise_distance",
    "sharded_topk",
    "global_batch_loss",
    "make_pp_mesh",
    "pp_encode_fn",
    "make_tp_mesh",
    "shard_params",
    "tp_encode_fn",
    "make_cp_mesh",
    "ring_attention",
]
