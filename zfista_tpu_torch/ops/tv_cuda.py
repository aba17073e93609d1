r"""CUDA kernels for the FGP dual loop of the TV prox, and their plain versions.

PyTorch/CUDA counterpart of :mod:`zfista_tpu.ops.tv_pallas`.  Every
function here takes ``(lam, v, p0, q0, n_iter, isotropic)`` and returns
``(u, p, q)``: ``n_iter`` FGP dual iterations from the dual ``(p0, q0)``,
the final feasible dual ``(p, q)`` and ``u = v - lam * div(p, q)``.  As in
the JAX package, callers handle ``lam <= 0`` (``prox_tv`` returns ``v``).

The three kernels, one for each TPU kernel:

* :func:`fgp_resident` (``csrc/fgp_resident.cu``) replaces ``fgp_pallas``:
  all ``n_iter`` iterations in ONE cooperative launch, one band of rows
  per SM held in shared memory, the bands' edge rows exchanged and a grid
  barrier between iterations.  Taken for small images (:func:`choose` is
  the rule; :func:`fits_resident` bounds it).
* :func:`fgp_tiles` (``csrc/fgp_tiles.cu``) replaces ``fgp_pallas_strips``:
  temporal blocking over 2-D tiles with an ``HALO``-cell halo on all four
  sides; one sweep advances every tile ``HALO`` iterations in shared
  memory, and a tile's interior is exactly the whole-image iterate.
  ``pipelined=False`` is one CTA per tile (the serial strip kernel);
  ``pipelined=True`` is persistent CTAs that prefetch the next tile's
  window with ``cp.async`` while the current one computes (the
  double-buffered strip kernel; its two slots leave it a smaller window,
  and :func:`choose` does not pick it).  Both run one ``__device__`` tile
  function, so they are bitwise equal by construction.

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor it
launches its kernel or raises.  :func:`fgp_plain` is the whole-image eager
loop (the XLA ``fori_loop``'s counterpart).  :func:`fgp_tiles_plain` is the
tile kernels' decomposition — tiles, halos, sweeps of ``HALO`` iterations
then a remainder, the momentum scalar handed from sweep to sweep — and
:func:`fgp_resident_plain` the whole-image kernel's bands, in eager
PyTorch, so the CPU suite can check both plans bitwise against
:func:`fgp_plain`.  The kernels are built with ``-fmad=false`` and compute
the plain loop's operations in its order, so on the card all of them equal
:func:`fgp_plain` bitwise.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from zfista_tpu_torch._typing import Array, Scalar
from zfista_tpu_torch.ops import _build
from zfista_tpu_torch.ops.tv import _div2d, _grad2d
from zfista_tpu_torch.utils.profiling import register

#: Kernel launches made by each wrapper since import (or since a caller
#: reset the entry to 0).  Incremented only where a CUDA kernel is
#: launched, never on the plain CPU path.  ``fgp_tiles*`` count every
#: launch of a call: one per sweep, plus the pass that recovers ``u``.  A
#: replayed CUDA graph runs no wrapper: the solver adds the launches its
#: capture recorded at each replay (``core.solver.run_graphed``), and
#: takes back the capture's own.  The tracing registry's group ``tv_cuda``.
launch_counts: dict[str, int] = register("tv_cuda", {
    "fgp_resident": 0,
    "fgp_tiles": 0,
    "fgp_tiles_pipelined": 0,
})

#: Iterations one tile sweep advances, and the halo that makes them exact:
#: the FGP body reads one cell in each direction per iteration, so after
#: ``HALO`` iterations a tile's interior is the whole-image iterate.
HALO = 8

#: Shared-memory window of one tile of the serial kernel, halo included,
#: by dtype (rows, cols).  Must match ``Window<T, false>`` in
#: csrc/fgp_tiles.cu (the launcher checks).  Columns are 30 per warp
#: column (warps overlap by two lanes); the window holds v, p, q and two
#: copies of r, s: 215 KB in either dtype, one CTA per SM.
TILE_WINDOW: dict[torch.dtype, tuple[int, int]] = {
    torch.float32: (64, 120),
    torch.float64: (64, 60),
}
#: The pipelined kernel's window (``Window<T, true>``): two slots of five
#: fields and one shared second copy of r, s are ``PIPELINED_FIELDS``
#: window fields, 230,400 bytes of the 232,448 a CTA may use.
PIPELINED_WINDOW: dict[torch.dtype, tuple[int, int]] = {
    torch.float32: (80, 60),
    torch.float64: (80, 30),
}
#: Window fields each tile kernel holds in shared memory.
TILE_FIELDS = 7
PIPELINED_FIELDS = 12

#: The whole-image kernel cuts the image into one band of rows per SM and
#: holds each band, with a halo row above and below, in its CTA's shared
#: memory: ``RESIDENT_FIELDS`` fields of ``ceil(H / SMs) + 2`` rows, within
#: what one CTA may opt in to (227 KB on an H100, ``SMEM_OPTIN_BYTES``;
#: :func:`resolve` reads the card's own).  The bands exchange their edge
#: rows every iteration.  :func:`resident_plan` is the only plan: the
#: wrapper hands it to csrc/fgp_resident.cu, which checks it.
RESIDENT_FIELDS = 7
SMEM_OPTIN_BYTES = 232_448
#: Columns one warp owns in the column walk (csrc/fgp_walk.cuh kLanes), the
#: warps of one whole-image CTA, and the most rows one warp walks.
WALK_LANES = 30
RESIDENT_WARPS = 32
RESIDENT_BAND_MAX = 16

#: ``checkpoint_meta`` names of the kernels :func:`resolve` can pick.
KERNEL_NAMES = ("cuda_resident", "cuda_tiles", "cuda_tiles_pipelined", "plain")

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: Image sizes past this take int64 offsets the kernels do not use.
_MAX_CELLS = 2**30


class ResidentPlan(NamedTuple):
    """The whole-image kernel's launch: ``rows`` image rows per CTA, ``ctas``
    CTAs, ``band`` rows per warp, ``warps`` per CTA, ``smem`` bytes of
    shared memory per CTA."""

    rows: int
    ctas: int
    band: int
    warps: int
    smem: int


def resident_plan(shape: tuple[int, ...], dtype: torch.dtype, sm_count: int) -> ResidentPlan:
    """The whole-image kernel's plan for an image of ``shape`` on
    ``sm_count`` SMs: one band of rows per SM, cut into bands per warp as
    short as :data:`RESIDENT_WARPS` warps allow (shorter walks per
    iteration), at most :data:`RESIDENT_BAND_MAX` rows."""
    H, W = (int(d) for d in shape)
    rows = -(-H // sm_count)
    item = torch.empty((), dtype=dtype).element_size()
    groups = -(-W // WALK_LANES)
    per_col = max(RESIDENT_WARPS // groups, 1)
    band = min(-(-rows // per_col), RESIDENT_BAND_MAX)
    warps = min(groups * -(-rows // band), RESIDENT_WARPS)
    return ResidentPlan(
        rows, -(-H // rows), band, warps, RESIDENT_FIELDS * item * (rows + 2) * W
    )


def fits_resident(
    shape: tuple[int, ...], dtype: torch.dtype, sm_count: int,
    smem_optin: int = SMEM_OPTIN_BYTES,
) -> bool:
    """True if the whole-image kernel can hold the image: one band per SM
    fits the ``smem_optin`` bytes a CTA may use (on an H100: 768² float32
    and 512² float64 do, 1024² float32 does not)."""
    H, W = (int(d) for d in shape)
    return H >= 1 and W >= 1 and resident_plan(shape, dtype, sm_count).smem <= smem_optin


def tile_window(dtype: torch.dtype, pipelined: bool = False) -> tuple[int, int]:
    """Rows and columns of one tile's window, halo included."""
    return (PIPELINED_WINDOW if pipelined else TILE_WINDOW)[dtype]


def tile_interior(dtype: torch.dtype, pipelined: bool = False) -> tuple[int, int]:
    """Rows and columns of one tile's interior (its window less the halo)."""
    wh, ww = tile_window(dtype, pipelined)
    return wh - 2 * HALO, ww - 2 * HALO


def n_tiles(shape: tuple[int, ...], dtype: torch.dtype, pipelined: bool = False) -> int:
    """Tiles one sweep of a tile kernel cuts an image into."""
    th, tw = tile_interior(dtype, pipelined)
    H, W = (int(d) for d in shape)
    return -(-H // th) * -(-W // tw)


def choose(
    shape: tuple[int, ...], dtype: torch.dtype, sm_count: int,
    smem_optin: int = SMEM_OPTIN_BYTES,
) -> str:
    """The dispatch rule on a card with ``sm_count`` SMs and ``smem_optin``
    bytes of shared memory per CTA, measured on an
    NVIDIA H100 80GB HBM3 at 700 W (device ms per prox call, float32,
    n_iter 30; PERF.md, chip_smoke.py phase 8):

    * the whole-image kernel while one band of rows per SM fits a CTA's
      shared memory (:func:`fits_resident`): 256² 0.073 against the serial
      tiles' 0.172, 512² 0.115 against 0.184, 768² 0.165 against 0.179;
    * the serial tiles beyond (1024² 0.328, 2048² 1.102).

    The pipelined tiles have no band: their two slots leave room for an
    80 x 60 window only, so they lose to the serial kernel's 64 x 120 at
    every size (768² 0.225 against 0.179, 2048² 1.201 against 1.102; at
    n_iter 8 0.065 against 0.048 and 0.367 against 0.318) and to the
    whole-image kernel where that fits (512² 0.131 against 0.115).
    ``prox_tv(method="cuda_tiles_pipelined")`` still runs them.
    """
    if fits_resident(shape, dtype, sm_count, smem_optin):
        return "cuda_resident"
    return "cuda_tiles"


def _card(device: Any) -> tuple[int, int]:
    """SMs of the CUDA ``device``, and the shared memory one CTA may opt in
    to."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def resolve(shape: tuple[int, ...], dtype: torch.dtype, device: Any) -> str:
    """The kernel ``prox_tv(method="auto")`` runs for this image on
    ``device``: one of :data:`KERNEL_NAMES`.  Any shape reaches a kernel on
    a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain"
    return choose(shape, dtype, *_card(device))


def fgp(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True, pipelined: bool = False,
) -> tuple[Array, Array, Array]:
    """The dual loop by the kernel :func:`resolve` picks for ``v``, or by
    the pipelined tiles when ``pipelined``; a CPU tensor takes the plain
    loop either way."""
    kind = resolve(tuple(v.shape), v.dtype, v.device)
    if kind == "plain":
        return fgp_plain(lam, v, p0, q0, n_iter, isotropic)
    if kind == "cuda_resident" and not pipelined:
        return fgp_resident(lam, v, p0, q0, n_iter, isotropic)
    return fgp_tiles(lam, v, p0, q0, n_iter, isotropic, pipelined=pipelined)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _lam_of(lam: Scalar, v: Array) -> Array:
    return torch.as_tensor(lam, dtype=v.dtype, device=v.device).reshape(())


def _step_of(lam: Array) -> Array:
    safe = torch.clamp_min(lam, torch.finfo(lam.dtype).tiny)
    return 1.0 / (8.0 * safe)


def _t_next(t: Array) -> Array:
    """FISTA's momentum recursion, in the order of ``zfista_tpu/ops/tv.py``."""
    return 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))


def _project(p: Array, q: Array, isotropic: bool) -> tuple[Array, Array]:
    if isotropic:
        denom = torch.clamp_min(torch.sqrt(p * p + q * q), 1.0)
        return p / denom, q / denom
    return torch.clamp(p, -1.0, 1.0), torch.clamp(q, -1.0, 1.0)


def fgp_plain(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True,
) -> tuple[Array, Array, Array]:
    """The whole-image FGP loop in eager PyTorch: the JAX ``fori_loop`` of
    ``prox_tv`` op for op (``safe = max(lam, tiny)``, step ``1/(8 safe)``).
    ``t`` is a 0-d tensor on ``v``'s device, so the loop never reads the
    device."""
    lam = _lam_of(lam, v)
    step = _step_of(lam)
    p, q, r, s = p0, q0, p0, q0
    t = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(int(n_iter)):
        # Descent on h(z) = 0.5||v - lam*div z||^2: grad h = lam*grad(v - lam*div z).
        gx, gy = _grad2d(v - lam * _div2d(r, s))
        p_new, q_new = _project(r - step * gx, s - step * gy, isotropic)
        t_new = _t_next(t)
        gamma = (t - 1.0) / t_new
        r = p_new + gamma * (p_new - p)
        s = q_new + gamma * (q_new - q)
        p, q, t = p_new, q_new, t_new
    return v - lam * _div2d(p, q), p, q


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never without
    a card)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


#: :func:`_sweeps`'s values, by ``(n_iter, dtype, device, halo)``.
_SWEEPS: dict[tuple, tuple[tuple[float, int], ...]] = {}


def _sweeps(
    n_iter: int, dtype: torch.dtype, device: torch.device, halo: int = HALO
) -> tuple[tuple[float, int], ...]:
    """``(t at the sweep's start, iterations)`` for each tile sweep of an
    ``n_iter`` loop: sweeps of ``halo``, then the remainder.

    ``t`` does not depend on the data and restarts at 1 on every call, so
    its start values are replayed once per ``(n_iter, dtype, device)`` with
    the plain loop's own operations, in ``dtype``, ON ``device``.  A Python
    float replay rounded at the end is not the float32 recursion; and even
    a float64 replay must run where the plain loop runs: the CPU's float64
    ``torch.sqrt`` is not correctly rounded (it differs from the card's by
    an ulp from t's 12th step), the card's is.  Each start value is exact
    as a Python float.

    Reading them is a host sync, so a first call inside a CUDA graph
    capture raises: a chunk graph runs its chunk eagerly before it
    captures it, which fills this cache, and a start value read at capture
    would be baked into the graph unchecked.
    """
    key = (int(n_iter), dtype, torch.device(device), int(halo))
    out = _SWEEPS.get(key)
    if out is not None:
        return out
    if _capturing():
        raise RuntimeError(
            f"fgp_tiles: the sweeps' start values of n_iter={n_iter} {dtype} on "
            f"{device} are not cached, and reading them inside a CUDA graph "
            "capture would sync the stream; run the call once before capturing it"
        )
    t = torch.ones((), dtype=dtype, device=device)
    starts = []
    done = 0
    while done < n_iter:
        k = min(halo, n_iter - done)
        starts.append((float(t), k))
        for _ in range(k):
            t = _t_next(t)
        done += k
    out = _SWEEPS[key] = tuple(starts)
    return out


def _window(f: Array, r0: int, c0: int, wh: int, ww: int) -> Array:
    """The ``(wh, ww)`` window of ``f`` at global origin ``(r0, c0)``, with
    the cells outside the image zero-filled (as the kernel loads it)."""
    H, W = f.shape
    out = torch.zeros((wh, ww), dtype=f.dtype, device=f.device)
    i0, i1 = max(r0, 0), min(r0 + wh, H)
    j0, j1 = max(c0, 0), min(c0 + ww, W)
    if i0 < i1 and j0 < j1:
        out[i0 - r0 : i1 - r0, j0 - c0 : j1 - c0] = f[i0:i1, j0:j1]
    return out


def _advance_window(
    fields: list[Array], r0: int, c0: int, H: int, W: int, lam: Array,
    step: Array, t: Array, k: int, isotropic: bool,
) -> list[Array]:
    """``k`` FGP iterations on one window: ``advance_window`` of
    csrc/fgp_tiles.cu in eager PyTorch.

    Two masks per direction, both selected with ``torch.where`` and never
    multiplied in (a cell outside the image may hold anything, and
    0·NaN is NaN): the Neumann boundary on the pixel's IMAGE index, and
    the window's own edge, where the neighbour is missing and the cell is
    in the halo, whose values are discarded.
    """
    v, p, q, r, s = fields
    wh, ww = v.shape
    dev = v.device
    li = torch.arange(wh, device=dev)[:, None]
    lj = torch.arange(ww, device=dev)[None, :]
    gi, gj = li + r0, lj + c0
    up = (gi > 0) & (li > 0)
    left = (gj > 0) & (lj > 0)
    down = (gi < H - 1) & (li < wh - 1)
    right = (gj < W - 1) & (lj < ww - 1)
    for _ in range(k):
        dx = torch.where(up, r - torch.roll(r, 1, 0), r)
        dy = torch.where(left, s - torch.roll(s, 1, 1), s)
        w = v - lam * (dx + dy)
        gx = torch.where(down, torch.roll(w, -1, 0) - w, 0.0)
        gy = torch.where(right, torch.roll(w, -1, 1) - w, 0.0)
        p_new, q_new = _project(r - step * gx, s - step * gy, isotropic)
        t_new = _t_next(t)
        gamma = (t - 1.0) / t_new
        r = p_new + gamma * (p_new - p)
        s = q_new + gamma * (q_new - q)
        p, q, t = p_new, q_new, t_new
    return [p, q, r, s]


def _tiled_plain(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int, isotropic: bool,
    window: tuple[int, int], halo: int,
) -> tuple[Array, Array, Array]:
    """Temporal blocking in eager PyTorch: sweeps of ``halo`` iterations
    (then the remainder) over tiles whose ``window`` adds ``halo`` cells on
    every side of the interior; cells outside the image are zero.  Each
    sweep reads one buffer set and writes its interiors into fresh tensors
    — outputs never alias inputs, or a later tile's halo would see an
    earlier tile's new values."""
    lam = _lam_of(lam, v)
    step = _step_of(lam)
    H, W = v.shape
    wh, ww = window
    th, tw = wh - 2 * halo, ww - 2 * halo
    p, q, r, s = p0, q0, p0, q0
    for t0, k in _sweeps(int(n_iter), v.dtype, v.device, halo):
        t = torch.tensor(t0, dtype=v.dtype, device=v.device)
        out = [torch.empty_like(v) for _ in range(4)]
        for i0 in range(0, H, th):
            for j0 in range(0, W, tw):
                r0, c0 = i0 - halo, j0 - halo
                win = [_window(f, r0, c0, wh, ww) for f in (v, p, q, r, s)]
                new = _advance_window(win, r0, c0, H, W, lam, step, t, k, isotropic)
                i1, j1 = min(i0 + th, H), min(j0 + tw, W)
                for o, f in zip(out, new):
                    o[i0:i1, j0:j1] = f[halo : halo + i1 - i0, halo : halo + j1 - j0]
        p, q, r, s = out
    return v - lam * _div2d(p, q), p, q


def fgp_tiles_plain(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True, pipelined: bool = False,
) -> tuple[Array, Array, Array]:
    """The tile kernels' plan in eager PyTorch, bitwise equal to
    :func:`fgp_plain`: tiles with ``HALO``-cell halos, sweeps of ``HALO``
    iterations, the serial or the pipelined kernel's window
    (:func:`tile_window`)."""
    return _tiled_plain(
        lam, v, p0, q0, n_iter, isotropic, tile_window(v.dtype, pipelined), HALO
    )


def fgp_resident_plain(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True, sm_count: int = 132,
) -> tuple[Array, Array, Array]:
    """The whole-image kernel's plan in eager PyTorch, bitwise equal to
    :func:`fgp_plain`: one band of ``ceil(H / sm_count)`` rows per SM
    (:func:`resident_plan`), a halo row above and below refreshed from the
    neighbours every iteration.  Used by no main path; the CPU suite checks
    the plan."""
    rows = resident_plan(tuple(v.shape), v.dtype, sm_count).rows
    return _tiled_plain(
        lam, v, p0, q0, n_iter, isotropic, (rows + 2, v.shape[1] + 2), 1
    )


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _checked(name: str, lam: Scalar, v: Array, p0: Array, q0: Array) -> Array:
    """Validate a CUDA call's operands; returns ``lam`` as a 0-d tensor on
    ``v``'s device.  The kernels read it there by pointer: inside the
    solver it is ``lr * w * strength``, a device value, and passing it by
    value would be a host sync per prox call."""
    if v.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {v.device}")
    if v.dtype not in _SUFFIX or v.dim() != 2 or not v.is_contiguous():
        raise ValueError(
            f"{name}: v must be a contiguous 2-D float32/float64 tensor, "
            f"got {v.dtype} {tuple(v.shape)}"
        )
    if v.numel() >= _MAX_CELLS:
        raise ValueError(f"{name}: {tuple(v.shape)} has more than 2**30 cells")
    for nm, f in (("p0", p0), ("q0", q0)):
        if f.device != v.device or f.dtype != v.dtype or f.shape != v.shape:
            raise ValueError(
                f"{name}: {nm} is {f.dtype} {tuple(f.shape)} on {f.device}; "
                f"v is {v.dtype} {tuple(v.shape)} on {v.device}"
            )
        if not f.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")
    return _lam_of(lam, v)


def _stream(v: Array) -> int:
    return torch.cuda.current_stream(v.device).cuda_stream


def fgp_resident(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True,
) -> tuple[Array, Array, Array]:
    """All ``n_iter`` dual iterations in one cooperative launch of
    csrc/fgp_resident.cu (the counterpart of ``fgp_pallas``): one band of
    rows per SM, held in shared memory, a grid barrier per iteration.
    Raises for an image whose bands do not fit (:func:`fits_resident`).
    CPU tensors take :func:`fgp_plain`."""
    if v.device.type == "cpu":
        return fgp_plain(lam, v, p0, q0, n_iter, isotropic)
    lam = _checked("fgp_resident", lam, v, p0, q0)
    H, W = v.shape
    u = torch.empty_like(v)
    p = torch.empty_like(v)
    q = torch.empty_like(v)
    if v.numel() == 0:
        return u, p, q
    sms, optin = _card(v.device)
    if not fits_resident((H, W), v.dtype, sms, optin):
        raise ValueError(
            f"fgp_resident: one band of a {H}x{W} {v.dtype} image per SM does "
            "not fit a CTA's shared memory (fits_resident); the tile kernels take it"
        )
    plan = resident_plan((H, W), v.dtype, sms)
    # The exchange buffer of the bands' edge rows: [2 copies][CTAs][r, s
    # of the first row, r, s of the last][W].
    xchg = torch.empty((2, plan.ctas, 4, W), dtype=v.dtype, device=v.device)
    fn = _build.entry(
        "fgp_resident", f"zt_fgp_resident_{_SUFFIX[v.dtype]}", 8,
        (ctypes.c_int,) * 8,
    )
    code = fn(
        v.data_ptr(), p0.data_ptr(), q0.data_ptr(), lam.data_ptr(),
        p.data_ptr(), q.data_ptr(), u.data_ptr(), xchg.data_ptr(),
        H, W, int(n_iter), int(bool(isotropic)),
        plan.rows, plan.ctas, plan.band, plan.warps,
        v.device.index, _stream(v),
    )
    _build.raise_on(code, "fgp_resident", "fgp_resident")
    launch_counts["fgp_resident"] += 1
    return u, p, q


def fgp_tiles(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True, pipelined: bool = False,
) -> tuple[Array, Array, Array]:
    """``n_iter`` dual iterations as tile sweeps of csrc/fgp_tiles.cu (the
    counterpart of ``fgp_pallas_strips``): ``n_iter // HALO`` sweeps of
    ``HALO`` iterations, then one of the remainder, then one pass for
    ``u``.  ``pipelined`` picks the persistent, prefetching kernel; the two
    are bitwise equal.  CPU tensors take :func:`fgp_tiles_plain`."""
    if v.device.type == "cpu":
        return fgp_tiles_plain(lam, v, p0, q0, n_iter, isotropic, pipelined)
    lam = _checked("fgp_tiles", lam, v, p0, q0)
    H, W = v.shape
    name = "fgp_tiles_pipelined" if pipelined else "fgp_tiles"
    sfx = _SUFFIX[v.dtype]
    wh, ww = tile_window(v.dtype, pipelined)
    sweep = _build.entry(
        "fgp_tiles",
        f"zt_fgp_tiles_{'pipelined' if pipelined else 'serial'}_{sfx}",
        10,
        (ctypes.c_double,) + (ctypes.c_int,) * 6,
    )
    stream = _stream(v)
    u = torch.empty_like(v)
    if v.numel() == 0:
        return u, torch.empty_like(v), torch.empty_like(v)
    src = (p0, q0, p0, q0)
    bufs = [[torch.empty_like(v) for _ in range(4)] for _ in range(2)]
    for i, (t0, k) in enumerate(_sweeps(int(n_iter), v.dtype, v.device)):
        dst = bufs[i % 2]
        code = sweep(
            v.data_ptr(), *(f.data_ptr() for f in src), lam.data_ptr(),
            *(f.data_ptr() for f in dst),
            t0, H, W, k, int(bool(isotropic)), wh, ww,
            v.device.index, stream,
        )
        _build.raise_on(code, "fgp_tiles", name)
        launch_counts[name] += 1
        src = tuple(dst)
    p, q = src[0], src[1]
    if int(n_iter) == 0:
        p, q = p0.clone(), q0.clone()
    recover = _build.entry("fgp_tiles", f"zt_fgp_recover_u_{sfx}", 5, (ctypes.c_int,) * 2)
    code = recover(
        v.data_ptr(), p.data_ptr(), q.data_ptr(), lam.data_ptr(), u.data_ptr(),
        H, W, v.device.index, stream,
    )
    _build.raise_on(code, "fgp_tiles", name)
    launch_counts[name] += 1
    return u, p, q
