r"""Mesh placement for scenario batches and sharded operators (PyTorch port).

Counterpart of :mod:`zfista_tpu.parallel.sharding`, with the same mesh
axes and placements:

* ``"batch"`` — independent scenario lanes (starts, λ values, momentum
  pairs).  Each rank solves its own lanes; lanes share nothing, so the
  only communication is the gather of the result.
* ``"model"`` — the feature axis of a large problem: a dense LASSO
  operator ``A (m, n)`` is laid out by columns (:func:`operator_sharding`)
  and the iterate by features (:func:`feature_sharding`), so ``A @ x`` is
  a local partial matvec plus an all-reduce over the ``"model"`` ranks and
  ``Aᵀ r`` is local.

JAX annotates placements and lets XLA insert the collectives.  Eager
PyTorch has no such compiler, so here a placement is a plain local tensor
(this rank's block of the global array) tagged with its
:class:`NamedSharding`, and the collectives are explicit calls on the
mesh's process groups, made by the code that needs them (the LASSO
callables, the solver's convergence test, the result's gather).  The
kernels take the local tensors as they are.

Every collective here is an ``all_reduce`` (sum or max): it is what NCCL
and Gloo both take on CUDA tensors, so two ranks can share one card over
Gloo.  A gather is an all-reduce of a buffer that holds this rank's block
and ``-0.0`` (integers: 0) elsewhere, which sums exactly: ``-0.0 + v`` is
``v`` for every ``v``, signed zeros included.

With no process group initialized the world is one rank: every mesh is
1×1, every block is the whole array, and no collective runs.  A solve on
one card then runs exactly as without a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from zfista_tpu_torch.core.solver import data_device

AXIS_NAMES = ("batch", "model")
#: The attribute that tags a local block with its placement.
_TAG = "_zfista_sharding"


def _world() -> tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` with no process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _line_group(grid: np.ndarray, axis: int):
    """This rank's process group along ``axis`` of the rank grid (None
    with no process group).  Every rank creates every line's group, in
    one order, as ``torch.distributed.new_group`` requires; a line that
    is the whole world is its default group."""
    if not dist.is_initialized():
        return None
    rank, world = _world()
    mine = None
    for line in np.moveaxis(grid, axis, -1).reshape(-1, grid.shape[axis]).tolist():
        group = dist.group.WORLD if line == list(range(world)) else dist.new_group(line)
        if rank in line:
            mine = group
    return mine


class Mesh:
    """A ``("batch", "model")`` grid of ranks, with this rank's process
    group along each axis.  ``devices`` is the grid of global ranks (one
    device per rank); ``shape`` maps each axis name to its size."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: np.ndarray) -> None:
        self.devices = np.asarray(devices, dtype=np.int64)
        if self.devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of ranks; got shape {self.devices.shape}")
        self.shape = dict(zip(AXIS_NAMES, (int(s) for s in self.devices.shape)))
        rank, _ = _world()
        at = np.argwhere(self.devices == rank)
        self._coords = dict(zip(AXIS_NAMES, (int(v) for v in at[0]))) if len(at) else None
        self._groups = {name: _line_group(self.devices, ax) for ax, name in enumerate(AXIS_NAMES)}

    def size(self, dim: str) -> int:
        return self.shape[dim]

    def index(self, dim: str) -> int:
        """This rank's coordinate along ``dim``; raises on a rank outside
        the mesh."""
        if self._coords is None:
            raise ValueError(f"rank {_world()[0]} is not in the mesh {self.devices.tolist()}")
        return self._coords[dim]

    def group(self, dim: str):
        """This rank's process group along ``dim``, or None with no process
        group initialized (then every collective is the identity)."""
        return self._groups[dim]

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()}, axis_names={AXIS_NAMES})"


class PartitionSpec(tuple):
    """Which mesh axis splits each tensor axis (None: not split), as
    ``jax.sharding.PartitionSpec``: ``P(None, "model")`` splits columns."""

    def __new__(cls, *names: str | None) -> "PartitionSpec":
        return super().__new__(cls, names)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A placement: ``mesh``, and ``spec`` naming the one mesh axis
    (``dim``) that splits one tensor axis (``axis``) into equal blocks; a
    spec with no axis named is a replicated placement."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self) -> None:
        named = [(i, d) for i, d in enumerate(self.spec) if d is not None]
        if len(named) > 1 or any(d not in AXIS_NAMES for _, d in named):
            raise ValueError(
                f"a spec names at most one of the mesh axes {AXIS_NAMES}; got {self.spec!r}"
            )
        object.__setattr__(self, "spec", PartitionSpec(*self.spec))

    @property
    def dim(self) -> str | None:
        """The mesh axis that splits the tensor (None: replicated)."""
        return next((d for d in self.spec if d is not None), None)

    @property
    def axis(self) -> int | None:
        """The tensor axis it splits (None: replicated)."""
        return next((i for i, d in enumerate(self.spec) if d is not None), None)

    @property
    def group(self):
        """This rank's process group along :attr:`dim`."""
        return None if self.dim is None else self.mesh.group(self.dim)


def make_mesh(
    batch: int | None = None,
    model: int = 1,
    *,
    devices: Sequence[int] | None = None,
) -> Mesh:
    """Build a ``("batch", "model")`` mesh over ``devices`` (global ranks;
    default: every rank of the world).  Every rank calls it, with the same
    arguments.

    ``batch=None`` uses every rank not consumed by ``model``.
    """
    devs = list(devices if devices is not None else range(_world()[1]))
    n = len(devs)
    if batch is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        batch = n // model
    if batch * model > n:
        raise ValueError(f"mesh {batch}x{model} needs more than {n} devices")
    if batch * model < n and devices is None:
        # An under-sized mesh over the default ranks is almost always a
        # typo that idles hardware; a subset is named explicitly.
        raise ValueError(
            f"mesh {batch}x{model} uses only {batch * model} of {n} "
            "devices; pass devices=... explicitly to use a subset"
        )
    return Mesh(np.array(devs[: batch * model]).reshape(batch, model))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Placement of ``(B, ...)`` scenario arrays: lanes over "batch"."""
    return NamedSharding(mesh, P("batch"))


def feature_sharding(mesh: Mesh) -> NamedSharding:
    """Placement of ``(n,)`` iterates: features over "model"."""
    return NamedSharding(mesh, P("model"))


def operator_sharding(mesh: Mesh) -> NamedSharding:
    """Placement of dense ``(m, n)`` operators: columns over "model"."""
    return NamedSharding(mesh, P(None, "model"))


def sharding_of(t: Any) -> NamedSharding | None:
    """The placement a local block was tagged with (None: not a block)."""
    return getattr(t, _TAG, None) if isinstance(t, torch.Tensor) else None


def tag(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """Tag ``t`` as this rank's block of a global array laid out by
    ``sharding``; returns ``t``."""
    setattr(t, _TAG, sharding)
    return t


def rank_device(device: Any = None) -> torch.device:
    """The device this rank's blocks live on: ``device`` if given, else the
    rank's card (the current CUDA device, which
    :func:`zfista_tpu_torch.parallel.distributed.initialize` sets for a
    CUDA rank).  Without a card it raises, as every entry point of the port
    does: only an explicit ``device="cpu"`` gives CPU blocks."""
    dev = data_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def block(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of ``full`` (a view) along the placement's axis."""
    if sharding.dim is None:
        return full
    k, i, ax = sharding.mesh.size(sharding.dim), sharding.mesh.index(sharding.dim), sharding.axis
    n = full.shape[ax]
    if n % k:
        raise ValueError(
            f"axis {ax} of length {n} does not divide into {k} blocks along {sharding.dim!r}"
        )
    return full.narrow(ax, i * (n // k), n // k)


def distribute(arr: Any, sharding: NamedSharding, device: Any = None) -> torch.Tensor:
    """This rank's block of the host array ``arr`` (every rank passes the
    same one), copied to the rank's device (:func:`rank_device`) and
    tagged with ``sharding``.  Only the block is copied."""
    host = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
    local = block(host, sharding)
    out = torch.empty(local.shape, dtype=local.dtype, device=rank_device(device))
    return tag(out.copy_(local), sharding)


def shard_batch(x0s: Any, mesh: Mesh | None = None, device: Any = None) -> torch.Tensor:
    """This rank's lanes of a ``(B, n)`` batch along the mesh's batch axis
    (:func:`distribute` with :func:`batch_sharding`).  ``B`` must divide by
    the axis size (pad upstream if needed)."""
    return distribute(x0s, batch_sharding(mesh if mesh is not None else make_mesh()), device)


# -- collectives ---------------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (a fresh tensor); ``t``
    itself with no group."""
    if group is None:
        return t
    out = t.reshape(-1).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.reshape(t.shape)


def feature_sum(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` summed over the ranks that hold ``A``'s column blocks (``v``
    itself when ``A`` is whole): the reduce of a feature-sharded operator's
    partial products."""
    sh = sharding_of(A)
    return v if sh is None else all_reduce_sum(v, sh.group)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks of ``group``, NaN where
    any rank's is NaN (as ``torch.amax`` carries NaN: the backends' MAX
    need not).  One all-reduce of the values beside their NaN flags."""
    if group is None:
        return t
    flat = t.reshape(-1)
    nan = torch.isnan(flat)
    packed = torch.cat([torch.where(nan, -torch.inf, flat), nan.to(flat.dtype)])
    dist.all_reduce(packed, op=dist.ReduceOp.MAX, group=group)
    k = flat.numel()
    return torch.where(packed[k:] > 0, torch.nan, packed[:k]).reshape(t.shape)


def gather_along(local: torch.Tensor, axis: int, group, size: int, index: int) -> torch.Tensor:
    """Concatenate the ``size`` ranks' blocks of ``group`` along ``axis``
    (this rank's is block ``index``), on every rank: one exact all-reduce
    sum (see the module note)."""
    if group is None or size == 1:
        return local
    dtype = local.dtype
    buf_dtype = torch.int32 if dtype == torch.bool else dtype
    shape = list(local.shape)
    n = shape[axis]
    shape[axis] = n * size
    fill = -0.0 if buf_dtype.is_floating_point else 0
    full = torch.full(shape, fill, dtype=buf_dtype, device=local.device)
    full.narrow(axis, index * n, n).copy_(local)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full.to(dtype)


def gather(local: torch.Tensor, sharding: NamedSharding, axis: int | None = None) -> torch.Tensor:
    """The global array from every rank's block of ``sharding`` (on every
    rank).  ``axis`` overrides the placement's tensor axis (a stack of
    blocks, such as recorded iterates)."""
    if sharding.dim is None:
        return local
    mesh, dim = sharding.mesh, sharding.dim
    ax = sharding.axis if axis is None else axis
    return gather_along(local, ax, mesh.group(dim), mesh.size(dim), mesh.index(dim))


def gather_numpy(a: np.ndarray, sharding: NamedSharding, device: torch.device, axis: int = 0) -> np.ndarray:
    """:func:`gather` of a host array, through ``device`` (the backend's:
    NCCL takes only CUDA tensors)."""
    t = torch.as_tensor(np.ascontiguousarray(a)).to(device)
    return gather(t, sharding, axis).cpu().numpy()
