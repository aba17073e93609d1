"""The batch solver and scale-out (PyTorch port): many independent solves
as one lane-batched solve (:mod:`zfista_tpu_torch.parallel.batch`), split
over the ranks of a ``("batch", "model")`` mesh
(:mod:`zfista_tpu_torch.parallel.sharding`), with the multi-process
runtime on ``torch.distributed``
(:mod:`zfista_tpu_torch.parallel.distributed`).

Counterpart of :mod:`zfista_tpu.parallel`.
"""

from zfista_tpu_torch.parallel import distributed
from zfista_tpu_torch.parallel.batch import BatchResult, minimize_proximal_gradient_batch
from zfista_tpu_torch.parallel.sharding import (
    batch_sharding,
    feature_sharding,
    make_mesh,
    operator_sharding,
    shard_batch,
)

__all__ = [
    "BatchResult",
    "distributed",
    "minimize_proximal_gradient_batch",
    "make_mesh",
    "shard_batch",
    "batch_sharding",
    "feature_sharding",
    "operator_sharding",
]
