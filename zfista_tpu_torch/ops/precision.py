"""Full-precision product helpers — the precision policy, in one place.

PyTorch-port counterpart of :mod:`zfista_tpu.ops.precision`.  The JAX
package runs every product that feeds an iterate, a gradient or a
convergence decision at ``lax.Precision.HIGHEST``: reduced-precision
products floor the solver's ``||x - y||_inf`` criterion at ~1e-3, so
nothing converges and nothing reports an error.  On a CUDA card the same
trap is TF32: a float32 ``torch.matmul`` keeps ~3 decimal digits when
``torch.backends.cuda.matmul.allow_tf32`` is on or the float32 matmul
precision is not ``"highest"``.

These helpers run ``torch.matmul`` / ``torch.dot`` / ``conv2d`` in full
precision and RAISE when a global flag asks for less.  They never flip the flags
themselves: the flags are process-wide, and a library that changes them
changes every other caller's numbers too.
"""

from __future__ import annotations

import torch


def _require_full_fp32() -> None:
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "zfista_tpu_torch needs full-fp32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') (TF32 products "
            "floor the solver's convergence test at ~1e-3)"
        )


def _over_lanes(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a lane dimension of ``torch.func.vmap`` (the
    batch solver's), under any other ``torch.func`` wrappers."""
    functorch = torch._C._functorch
    while functorch.is_functorch_wrapped_tensor(t):
        if functorch.is_batchedtensor(t):
            return True
        t = functorch.get_unwrapped(t)
    return False


def matmul_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in full precision (matrix-vector / matrix-matrix).

    Under ``torch.func.vmap`` a lane's product must not depend on how many
    lanes run beside it, nor on where it sits among them.  A matrix shared
    by every lane (one operator, many lanes) that nothing differentiates
    stays a GEMM, run over fixed blocks of lanes (:class:`_SharedOperator`):
    vmap would make it one GEMM as wide as the lane count, and the BLAS
    picks its kernel, and so its rounding, by that width.  Any other
    product under ``vmap`` is a sum of elementwise products
    (:func:`lane_sum`)."""
    _require_full_fp32()
    la, lb = _over_lanes(a), _over_lanes(b)
    if (la or lb) and a.dim() <= 2 and b.dim() <= 2:
        if a.dim() == 2 and not la and _constant(a):
            return _shared(b, _SharedMatrix(a, left=True))
        if b.dim() == 2 and not lb and _constant(b):
            return _shared(a, _SharedMatrix(b, left=False))
        if a.dim() == 1:
            return lane_sum(a * b) if b.dim() == 1 else lane_sum(a[:, None] * b, dim=0)
        if b.dim() == 1:
            return lane_sum(a * b)
        return lane_sum(a[:, :, None] * b[None, :, :], dim=1)
    return torch.matmul(a, b)


def _shared(v: torch.Tensor, op: "_SharedMatrix") -> torch.Tensor:
    """``op.apply(v)`` under ``vmap``.  A lane operand that is the lanes of
    a plain tensor runs ``op.lanes`` on them at once; one that a transform
    inside the ``vmap`` differentiates goes through :class:`_SharedOperator`,
    whose batching rule runs the same ``op.lanes`` behind a slower
    dispatch."""
    functorch = torch._C._functorch
    if functorch.is_batchedtensor(v):
        lanes = functorch.get_unwrapped(v)
        if not functorch.is_functorch_wrapped_tensor(lanes) and not lanes.requires_grad:
            out = op.lanes(lanes.movedim(functorch.maybe_get_bdim(v), 0))
            return functorch._add_batch_dim(out, 0, functorch.maybe_get_level(v))
    return _SharedOperator.apply(v, op)


def _constant(t: torch.Tensor) -> bool:
    """Whether ``t`` is a plain tensor that nothing differentiates."""
    return not torch._C._functorch.is_functorch_wrapped_tensor(t) and not t.requires_grad


#: Multiply-adds per GEMM of a shared operator's lane blocks under
#: ``vmap``: a ``(p, k)`` operator takes ``LANE_WORK / (p * k)`` rows of lane
#: data per GEMM, as a power of two between 16 and 512, and a block holds as
#: many whole lanes as fit (at least one).  The rows follow the operator's
#: shape alone, so every GEMM of it has one shape whatever the lane count.
#: Set on the H100 by the 1k-lambda sweep (A 500 x 2000): 64, 128, 256 and
#: 512 rows a GEMM gave 1.8, 1.35, 1.16 and 1.04 times the wall of one GEMM
#: over all 1,000 lanes.
LANE_WORK = 1 << 29

#: Row stride of a block's lane data, in elements (rows that start on
#: 64-byte boundaries), and the multiple of a GEMM's row count.  The CPU's
#: BLAS rounds a row by its alignment, and by its place in a GEMM of 15
#: rows (not of 16).
_ROW_ALIGN = 16

# Row-contiguous copies of shared operators, one per view of a base tensor
# (``A.T`` of the LASSO's ``A``, the deblurring band matrices), kept while
# the base lives.
_ROWS_CACHE = torch.utils.weak.WeakIdKeyDictionary()


def _row_major(M: torch.Tensor) -> torch.Tensor:
    """``M`` with unit stride along its rows (the GEMM's contraction axis):
    itself, or a copy kept for as long as its base tensor lives."""
    if M.stride(-1) == 1:
        return M
    base = M if M._base is None else M._base
    key = (M.shape, M.stride(), M.storage_offset(), base._version)
    per_base = _ROWS_CACHE.setdefault(base, {})
    hit = per_base.get(key)
    if hit is None:
        if len(per_base) >= 4:
            per_base.clear()
        hit = per_base[key] = M.contiguous()
    return hit


class _SharedMatrix:
    """One lane's product with a matrix ``S`` that every lane shares: ``S @
    v`` (``left``) or ``v @ S``, with ``v`` a vector or a matrix.

    Every form is computed as ``rows @ M.T``: ``M`` holds the operator's
    rows along the contraction axis (``S``, or ``S.T``, row-contiguous),
    ``rows`` the lanes' vectors.  Each row of a GEMM of that form comes out
    the same wherever it sits among the rows, on the CPU's BLAS once the
    rows start on aligned addresses and on cuBLAS."""

    def __init__(self, S: torch.Tensor, left: bool):
        self.S, self.left = S, left

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return matmul_hp(self.S, v) if self.left else matmul_hp(v, self.S)

    def adjoint(self, g: torch.Tensor) -> torch.Tensor:
        return matmul_hp(self.S.T, g) if self.left else matmul_hp(g, self.S.T)

    def lanes(self, V: torch.Tensor) -> torch.Tensor:
        """The product for every lane of ``V`` (lanes first), in blocks of
        a fixed number of lanes."""
        M = _row_major(self.S if self.left else self.S.T)
        if self.left:  # S @ v: v's columns are the rows
            rows = V[:, :, None] if V.dim() == 2 else V
            rows = rows.transpose(1, 2)
        else:  # v @ S: v's rows are the rows
            rows = V[:, None, :] if V.dim() == 2 else V
        out = _blocked_lanes(rows, M)
        if self.left:
            out = out.transpose(1, 2)
        return out.reshape(V.shape[0], -1) if V.dim() == 2 else out


def _blocked_lanes(rows: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``rows[j] @ M.T`` for every lane ``j`` of ``rows`` (lanes, r, k), as
    GEMMs of one shape: each takes as many whole lanes as fit in the rows
    :data:`LANE_WORK` gives ``M``, on a row count rounded up to a multiple
    of :data:`_ROW_ALIGN` (zero rows below the lanes), and reads its rows
    at a row stride of ``k`` rounded up to :data:`_ROW_ALIGN`, from a
    64-byte boundary.  Blocks of ``rows`` already so laid out are read in
    place; the rest are copied into one zero-padded buffer.  Each GEMM
    writes its block of one output."""
    B, r, k = rows.shape
    target = min(512, 1 << max(4, (LANE_WORK // max(1, M.numel())).bit_length() - 1))
    per = max(1, target // r)  # lanes a GEMM
    used = per * r
    height = used + -used % _ROW_ALIGN
    stride = k + -k % _ROW_ALIGN
    blocks = -(-B // per)
    flat = rows.reshape(B * r, k)
    aligned = height == used and flat.stride() == (stride, 1) and flat.data_ptr() % 64 == 0
    direct = B // per if aligned else 0  # blocks read in place
    if direct < blocks:
        tail = rows[direct * per:]
        rest = rows.new_zeros((blocks - direct, height, stride))
        dst = rest[:, :used, :k].unflatten(1, (per, r))
        full = tail.shape[0] // per
        dst[:full] = tail[:full * per].unflatten(0, (full, per))
        if tail.shape[0] % per:
            dst[full, :tail.shape[0] % per] = tail[full * per:]
    Mt = M.T
    out = rows.new_empty((blocks, height, M.shape[0]))
    for i in range(blocks):
        part = flat[i * used:(i + 1) * used] if i < direct else rest[i - direct, :, :k]
        torch.matmul(part, Mt, out=out[i])
    return out[:, :used].unflatten(1, (per, r)).flatten(0, 1)[:B]


class _SharedOperator(torch.autograd.Function):
    """``op.apply(v)`` for an operator linear in ``v`` whose other operand
    every lane shares.  Under ``torch.func.vmap`` its batching rule runs
    ``op.lanes`` (fixed blocks of lanes); its derivative is the operator
    itself (``jvp``) and its adjoint (``backward``), each again through the
    same rule under ``vmap``."""

    @staticmethod
    def forward(v: torch.Tensor, op) -> torch.Tensor:
        return op.apply(v)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.op = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return ctx.op.adjoint(grad), None

    @staticmethod
    def jvp(ctx, v_dot, _op):
        return ctx.op.apply(v_dot)

    @staticmethod
    def vmap(info, in_dims, v, op):
        if in_dims[0] is None:
            return _SharedOperator.apply(v, op), None
        return op.lanes(v.movedim(in_dims[0], 0)), 0


def dot_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.dot`` in full precision (vector-vector); under
    ``torch.func.vmap`` the :func:`lane_sum` of elementwise products (see
    :func:`matmul_hp`)."""
    _require_full_fp32()
    if _over_lanes(a) or _over_lanes(b):
        return lane_sum(a * b)
    return torch.dot(a, b)


def sum_hp(v: torch.Tensor) -> torch.Tensor:
    """``torch.sum`` of every element; under ``torch.func.vmap`` the
    :func:`lane_sum` of the flattened lane, so that the sum does not
    depend on the number of lanes (see :func:`lane_sum`)."""
    if _over_lanes(v):
        return lane_sum(v.reshape(-1))
    return torch.sum(v)


def mean_hp(v: torch.Tensor) -> torch.Tensor:
    """``torch.mean`` of every element; under ``torch.func.vmap`` the
    :func:`lane_sum` of the flattened lane over its length (see
    :func:`sum_hp`)."""
    if _over_lanes(v):
        return lane_sum(v.reshape(-1)) / v.numel()
    return torch.mean(v)


def lane_sum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.sum(v, dim)`` in an order set by the length of ``dim``
    alone: a pairwise tree of elementwise adds over ``v`` zero-padded to a
    power of two.

    A reduction kernel over a ``(lanes, n)`` tensor splits each row among
    its threads and blocks by the number of rows (torch's CUDA reduction
    does), so a lane's sum, and every decision it feeds, would change with
    the number of lanes beside it: a lane-sharded batch would part from
    the unsharded one.  An elementwise add rounds each element alone, so
    every lane's tree is the same whatever the lane count or device.
    ``log2(n)`` adds of halving width read about twice the bytes of one
    reduction."""
    v = v.movedim(dim, -1)
    n = v.shape[-1]
    if n == 0:
        return torch.sum(v, dim=-1)
    width = 1 << (n - 1).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while width > 1:
        width //= 2
        v = v[..., :width] + v[..., width:]
    return v[..., 0]


def conv2d_hp(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.nn.functional.conv2d`` (a correlation, unpadded) in full
    precision.  A float32 convolution on a card goes through cuDNN, which
    uses TF32 while ``torch.backends.cudnn.allow_tf32`` is on (its
    default), so a float32 CUDA call raises unless it is off.  TF32 never
    touches float64."""
    if x.is_cuda and x.dtype == torch.float32 and torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "zfista_tpu_torch needs full-fp32 convolutions: set "
            "torch.backends.cudnn.allow_tf32 = False (TF32 convolutions "
            "floor the solver's convergence test at ~1e-3)"
        )
    return torch.nn.functional.conv2d(x, w)
