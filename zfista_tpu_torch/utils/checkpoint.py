"""Solver-state checkpoint/resume.

PyTorch-port counterpart of :mod:`zfista_tpu.utils.checkpoint`, with the
same file layout: one ``.npz`` key per :class:`State` field and the
``_meta_`` prefix for string metadata.  The whole solve state is one
:class:`~zfista_tpu_torch.core.solver.State`, so a checkpoint is a flat
npz dump, and a solve resumes where it stopped through
``minimize_proximal_gradient(..., initial_state=...)`` (batches through
``initial_states=``), bitwise equal to the uninterrupted run.

The two packages read each other's files: a State saved by the JAX
package loads here (through :func:`zfista_tpu_torch.interop.
state_from_numpy`), and one saved here loads in the JAX package.  Batched
states (a leading lane axis on every field) round-trip the same way.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from zfista_tpu_torch.core.solver import State
from zfista_tpu_torch.interop import state_from_numpy

__all__ = ["load_meta", "load_state", "save_state"]

#: npz key prefix for user metadata entries (kept disjoint from
#: ``State._fields`` so :func:`load_state` can ignore them unchanged).
_META_PREFIX = "_meta_"


def _normalize(path) -> Path:
    # np.savez appends ".npz" to suffix-less paths; normalize both ends so
    # save_state(p) / load_state(p) round-trip for any spelling.
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def _host(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(state: State, path, meta: dict[str, str] | None = None) -> None:
    """Serialize a solver :class:`State` (single or batched; tensors on any
    device, or numpy, e.g. ``res.state``) to ``.npz``.

    The write is atomic (temp file + rename), so a crash mid-write never
    leaves a truncated checkpoint.  ``meta`` stores string key/value pairs
    beside the state (read back with :func:`load_meta`; :func:`load_state`
    ignores them), e.g. ``TVDeblur.checkpoint_meta()``, which records the
    FGP kernel the TV prox resolved to.  A meta key equal to a State field
    raises ``ValueError``.
    """
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {k: _host(v) for k, v in state._asdict().items()}
    for k, v in (meta or {}).items():
        if k in State._fields:
            raise ValueError(f"meta key {k!r} collides with a State field")
        payload[_META_PREFIX + str(k)] = np.asarray(str(v))
    tmp = path.with_suffix(f".tmp{os.getpid()}.npz")
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def load_state(path, device: Any = "cuda") -> State:
    """Load a :class:`State` saved by :func:`save_state` (of either
    package) as tensors on ``device`` (default ``"cuda"``; a machine with
    no card raises, ``device="cpu"`` asks for the CPU).

    Every field keeps the dtype it was saved with.  The JAX loader refuses
    a float64 file while its x64 switch is off, because it would downcast
    the fields; torch has no such switch and never changes a dtype here,
    so that refusal has no counterpart.
    """
    with np.load(_normalize(path)) as data:
        host = State(*(data[k] for k in State._fields))
    return state_from_numpy(host, device=device)


def load_meta(path) -> dict[str, str]:
    """Read the string metadata stored by ``save_state(..., meta=...)``.

    Returns an empty dict for checkpoints written without metadata.
    """
    with np.load(_normalize(path)) as data:
        return {
            k[len(_META_PREFIX):]: str(data[k])
            for k in data.files
            if k.startswith(_META_PREFIX)
        }
