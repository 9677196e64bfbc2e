"""Data and tensor parallelism over ranks (the `data` and `model` axes of
the JAX package's mesh, coot_videotext_tpu/parallel/)."""

from coot_videotext_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather_rows, all_reduce_grads, all_reduce_metrics,
    batch_rows, broadcast_params, get_mesh, single)
