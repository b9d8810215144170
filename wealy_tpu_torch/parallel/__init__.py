"""Parallelism of the port, the counterpart of ``wealy_tpu.parallel``: the
data-parallel mesh on ``torch.distributed`` (``mesh.py``), the global-batch
loss (``collectives.py``), process-group set-up (``multihost.py``), and the
corpus-scale ranking (``similarity.py``, one device). Tensor, pipeline and
ring parallelism and the mesh paths of extract / evaluate / serve /
transcribe are ROADMAP item 6d."""
