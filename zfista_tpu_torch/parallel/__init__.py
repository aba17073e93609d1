"""The batch solver (PyTorch port): many independent solves as one
lane-batched solve on one device (:mod:`zfista_tpu_torch.parallel.batch`).

Counterpart of :mod:`zfista_tpu.parallel`; the mesh sharding and the
multi-process runtime are not ported yet (ROADMAP.md, item 9).
"""

from zfista_tpu_torch.parallel.batch import BatchResult, minimize_proximal_gradient_batch

__all__ = ["BatchResult", "minimize_proximal_gradient_batch"]
