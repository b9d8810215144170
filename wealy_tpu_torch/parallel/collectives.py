"""The global-batch loss, the counterpart of
``wealy_tpu.parallel.collectives``.

CLEWS, NT-Xent and triplet need the **global** batch for their B x B
distance matrices (in-batch negatives). Under data parallelism each rank
holds a shard of the batch; :func:`global_batch_loss` wraps a loss so that
the labels, ids and embeddings of every rank are gathered before it runs,
the reference's single-device loss over the whole batch
(lib/losses.py:40-45, :225-234). The gradient reaches each rank's own rows
(:func:`wealy_tpu_torch.parallel.mesh.gather_with_local_grad`); the train
step sums the parameter gradients over the ranks.
"""

from __future__ import annotations

import functools
from typing import Callable

from wealy_tpu_torch.parallel.mesh import Mesh, all_gather_rows, gather_with_local_grad


def global_batch_loss(loss_fn: Callable, mesh: Mesh, axis: str = "data"):
    """Wrap ``loss_fn(z_label, z_idx, z, extra) -> (loss, logdict)`` so that
    it computes over the batch gathered along the mesh's ``axis``: the
    wrapped function takes this rank's rows and returns the global loss
    (the same on every rank)."""

    @functools.wraps(loss_fn)
    def wrapped(z_label, z_idx, z, extra=None):
        return loss_fn(all_gather_rows(mesh, z_label, axis), all_gather_rows(mesh, z_idx, axis),
                       gather_with_local_grad(mesh, z, axis), extra)

    return wrapped
