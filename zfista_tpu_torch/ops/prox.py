r"""Proximal operators as plain functions on tensors.

PyTorch-port counterpart of :mod:`zfista_tpu.ops.prox`.  This slice ports
the soft-threshold (the LASSO prox); the shifted-L1, box, simplex and
group-lasso operators are ROADMAP.md Queue 1 item 1's remaining work.
"""

from __future__ import annotations

import torch

from zfista_tpu_torch._typing import Array, ArrayLike


def soft_threshold(x: Array, thresh: ArrayLike) -> Array:
    r"""Soft-thresholding: :math:`\mathrm{prox}_{t\|\cdot\|_1}(x)`.

    Elementwise ``sign(x) * max(|x| - thresh, 0)``.  ``thresh`` broadcasts.
    """
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thresh, 0)


# Alias with the jaxopt naming (``prox_lasso(x, l1reg)``), as in the JAX
# package, so problem definitions read like the literature.
def prox_l1(x: Array, scale: ArrayLike) -> Array:
    r"""Prox of ``scale * ||x||_1`` (a.k.a. ``prox_lasso``)."""
    return soft_threshold(x, scale)
