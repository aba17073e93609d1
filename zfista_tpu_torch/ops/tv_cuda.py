r"""CUDA kernels for the FGP dual loop of the TV prox, and their plain versions.

PyTorch/CUDA counterpart of :mod:`zfista_tpu.ops.tv_pallas`.  Every
function here takes ``(lam, v, p0, q0, n_iter, isotropic)`` and returns
``(u, p, q)``: ``n_iter`` FGP dual iterations from the dual ``(p0, q0)``,
the final feasible dual ``(p, q)`` and ``u = v - lam * div(p, q)``.  As in
the JAX package, callers handle ``lam <= 0`` (``prox_tv`` returns ``v``).

The three kernels, one for each TPU kernel:

* :func:`fgp_resident` (``csrc/fgp_resident.cu``) replaces ``fgp_pallas``:
  all ``n_iter`` iterations in ONE cooperative launch, the fields kept in
  the 50 MB L2 and a grid-wide barrier between iterations.  Taken for
  small images (:func:`choose` is the rule; :func:`fits_l2` bounds it).
* :func:`fgp_tiles` (``csrc/fgp_tiles.cu``) replaces ``fgp_pallas_strips``:
  temporal blocking over 2-D tiles with an ``HALO``-cell halo on all four
  sides; one sweep advances every tile ``HALO`` iterations in shared
  memory, and a tile's interior is exactly the whole-image iterate.
  ``pipelined=False`` is one CTA per tile (the serial strip kernel);
  ``pipelined=True`` is persistent CTAs that prefetch the next tile's
  window with ``cp.async`` while the current one computes (the
  double-buffered strip kernel).  Both run one ``__device__`` tile
  function, so they are bitwise equal by construction.

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor it
launches its kernel or raises.  :func:`fgp_plain` is the whole-image eager
loop (the XLA ``fori_loop``'s counterpart).  :func:`fgp_tiles_plain` is the
tile kernel's decomposition — tiles, halos, sweeps of ``HALO`` iterations
then a remainder, the momentum scalar handed from sweep to sweep — in
eager PyTorch, so the CPU suite can check the tiling plan bitwise against
:func:`fgp_plain`.  The kernels are built with ``-fmad=false`` and compute
the plain loop's operations in its order, so on the card all of them equal
:func:`fgp_plain` bitwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any

import torch

from zfista_tpu_torch._typing import Array, Scalar
from zfista_tpu_torch.ops import _build
from zfista_tpu_torch.ops.tv import _div2d, _grad2d

#: Kernel launches made by each wrapper since import (or since a caller
#: reset the entry to 0).  Incremented only where a CUDA kernel is
#: launched, never on the plain CPU path.  ``fgp_tiles*`` count every
#: launch of a call: one per sweep, plus the pass that recovers ``u``.
launch_counts: dict[str, int] = {
    "fgp_resident": 0,
    "fgp_tiles": 0,
    "fgp_tiles_pipelined": 0,
}

#: Iterations one tile sweep advances, and the halo that makes them exact:
#: the FGP body reads one cell in each direction per iteration, so after
#: ``HALO`` iterations a tile's interior is the whole-image iterate.
HALO = 8

#: Shared-memory window of one tile, halo included, by dtype (rows, cols).
#: Must match ``Window<T>`` in csrc/fgp_tiles.cu (the launcher checks).
#: Six window fields (v, p, q, r, s and the stencil's w) are 96 KB in
#: either dtype, two CTAs per SM; the pipelined kernel's second slot of
#: five fields makes 176 KB, one CTA per SM.
TILE_WINDOW: dict[torch.dtype, tuple[int, int]] = {
    torch.float32: (64, 64),
    torch.float64: (64, 32),
}

#: The whole-image kernel keeps 12 fields live (v, p0, q0, two sets of
#: p/q/r/s, u).  It is taken only while they fit in half the H100's 50 MB
#: L2 (512² float32 is 12.6 MB, 1024² is 50.3 MB), and :func:`choose`
#: narrows that further by measurement.
L2_BUDGET_BYTES = 24 * 2**20
RESIDENT_FIELDS = 12

#: CTAs of the serial tile kernel that share one SM (96 KB of shared
#: memory each); the pipelined kernel runs one persistent CTA per SM.
SERIAL_CTAS_PER_SM = 2

#: ``checkpoint_meta`` names of the kernels :func:`resolve` can pick.
KERNEL_NAMES = ("cuda_resident", "cuda_tiles", "cuda_tiles_pipelined", "plain")

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: Image sizes past this take int64 offsets the kernels do not use.
_MAX_CELLS = 2**30


def fits_l2(shape: tuple[int, ...], dtype: torch.dtype) -> bool:
    """True if the whole-image kernel's fields fit its L2 budget."""
    n = 1
    for d in shape:
        n *= int(d)
    item = torch.empty((), dtype=dtype).element_size()
    return RESIDENT_FIELDS * n * item <= L2_BUDGET_BYTES


def tile_interior(dtype: torch.dtype) -> tuple[int, int]:
    """Rows and columns of one tile's interior (its window less the halo)."""
    wh, ww = TILE_WINDOW[dtype]
    return wh - 2 * HALO, ww - 2 * HALO


def n_tiles(shape: tuple[int, ...], dtype: torch.dtype) -> int:
    """Tiles one sweep of the tile kernels cuts an image into."""
    th, tw = tile_interior(dtype)
    H, W = (int(d) for d in shape)
    return -(-H // th) * -(-W // tw)


def choose(shape: tuple[int, ...], dtype: torch.dtype, sm_count: int) -> str:
    """The dispatch rule on a card with ``sm_count`` SMs, measured on an
    NVIDIA H100 80GB HBM3 at 700 W (ms per 30-iteration call, float32;
    PERF.md).  The tile kernels run one CTA per tile, so:

    * the whole-image kernel while its fields fit the L2 budget AND the
      tiles would leave over half the SMs idle (256² float32: 36 tiles,
      0.090 ms against the pipelined tiles' 0.138; 512²: 121 tiles, 0.190
      against 0.141);
    * the pipelined tiles while the serial kernel would run all its tiles
      in one wave (there its co-resident CTAs cannot overlap one another's
      loads, and the prefetch can: 768², 256 tiles, 0.231 against 0.253);
    * the serial tiles beyond (1024², 484 tiles: 0.401 against 0.522).

    On the H100 (132 SMs) the SM rule binds first, at about 384² (7 MB of
    fields in float32), far under the L2 budget.  :func:`fits_l2` is the
    guard for a card with more SMs, where the SM rule alone would take the
    whole-image kernel past the L2.
    """
    tiles = n_tiles(shape, dtype)
    if fits_l2(shape, dtype) and 2 * tiles < sm_count:
        return "cuda_resident"
    if tiles <= SERIAL_CTAS_PER_SM * sm_count:
        return "cuda_tiles_pipelined"
    return "cuda_tiles"


def resolve(shape: tuple[int, ...], dtype: torch.dtype, device: Any) -> str:
    """The kernel ``prox_tv(method="auto")`` runs for this image on
    ``device``: one of :data:`KERNEL_NAMES`.  Any shape reaches a kernel on
    a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return choose(shape, dtype, sms)


def fgp(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True,
) -> tuple[Array, Array, Array]:
    """The dual loop by the kernel :func:`resolve` picks for ``v``."""
    kind = resolve(tuple(v.shape), v.dtype, v.device)
    if kind == "plain":
        return fgp_plain(lam, v, p0, q0, n_iter, isotropic)
    if kind == "cuda_resident":
        return fgp_resident(lam, v, p0, q0, n_iter, isotropic)
    return fgp_tiles(
        lam, v, p0, q0, n_iter, isotropic, pipelined=kind == "cuda_tiles_pipelined"
    )


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


@functools.cache
def _sweeps(
    n_iter: int, dtype: torch.dtype, device: torch.device
) -> tuple[tuple[float, int], ...]:
    """``(t at the sweep's start, iterations)`` for each tile sweep of an
    ``n_iter`` loop: sweeps of ``HALO``, then the remainder.

    ``t`` does not depend on the data and restarts at 1 on every call, so
    its start values are replayed once per ``(n_iter, dtype, device)`` with
    the plain loop's own operations, in ``dtype``, ON ``device``.  A Python
    float replay rounded at the end is not the float32 recursion; and even
    a float64 replay must run where the plain loop runs: the CPU's float64
    ``torch.sqrt`` is not correctly rounded (it differs from the card's by
    an ulp from t's 12th step), the card's is.  Each start value is exact
    as a Python float.
    """
    t = torch.ones((), dtype=dtype, device=device)
    out = []
    done = 0
    while done < n_iter:
        k = min(HALO, n_iter - done)
        out.append((float(t), k))
        for _ in range(k):
            t = _t_next(t)
        done += k
    return tuple(out)


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


def fgp_tiles_plain(
    lam: Scalar, v: Array, p0: Array, q0: Array, n_iter: int = 50,
    isotropic: bool = True,
) -> tuple[Array, Array, Array]:
    """The tile kernel's plan in eager PyTorch, bitwise equal to
    :func:`fgp_plain`.

    Each sweep cuts the image into tiles whose interiors cover it; a tile's
    window adds ``HALO`` cells on every side (cells outside the image are
    zero).  The sweep reads one buffer set and writes its interior into
    fresh tensors — outputs never alias inputs, or a later tile's halo would
    see an earlier tile's new values.  The window is the kernel's
    (:data:`TILE_WINDOW`).
    """
    lam = _lam_of(lam, v)
    step = _step_of(lam)
    H, W = v.shape
    wh, ww = TILE_WINDOW[v.dtype]
    th, tw = tile_interior(v.dtype)
    p, q, r, s = p0, q0, p0, q0
    for t0, k in _sweeps(int(n_iter), v.dtype, v.device):
        t = torch.tensor(t0, dtype=v.dtype, device=v.device)
        out = [torch.empty_like(v) for _ in range(4)]
        for i0 in range(0, H, th):
            for j0 in range(0, W, tw):
                r0, c0 = i0 - HALO, j0 - HALO
                win = [_window(f, r0, c0, wh, ww) for f in (v, p, q, r, s)]
                new = _advance_window(win, r0, c0, H, W, lam, step, t, k, isotropic)
                i1, j1 = min(i0 + th, H), min(j0 + tw, W)
                for o, f in zip(out, new):
                    o[i0:i1, j0:j1] = f[HALO : HALO + i1 - i0, HALO : HALO + j1 - j0]
        p, q, r, s = out
    return v - lam * _div2d(p, q), p, q


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _entry(source: str, symbol: str, n_ptr: int, tail: tuple[Any, ...]) -> Any:
    """The typed ctypes entry ``symbol`` of ``csrc/<source>.cu`` (built on
    first use): ``n_ptr`` pointers, then ``tail``, then device and stream.
    Every pointer and the stream are ``c_void_p``: an undeclared argument
    would be passed as a 32-bit int and cut the address."""
    lib = _build.load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + list(tail) + [
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _raise_on(code: int, source: str, what: str) -> None:
    if code != 0:
        errstr = _build.load(source).zt_cuda_error_string
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {code} "
            f"({errstr(code).decode()})"
        )


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
    csrc/fgp_resident.cu (the counterpart of ``fgp_pallas``).  CPU tensors
    take :func:`fgp_plain`."""
    if v.device.type == "cpu":
        return fgp_plain(lam, v, p0, q0, n_iter, isotropic)
    lam = _checked("fgp_resident", lam, v, p0, q0)
    H, W = v.shape
    u = torch.empty_like(v)
    p = torch.empty_like(v)
    q = torch.empty_like(v)
    if v.numel() == 0:
        return u, p, q
    # The second buffer set and the first set's r/s: the kernel ping-pongs
    # between (p, q, scratch[0:2]) and scratch[2:6], ending in (p, q).
    scratch = torch.empty((6, H, W), dtype=v.dtype, device=v.device)
    fn = _entry(
        "fgp_resident", f"zt_fgp_resident_{_SUFFIX[v.dtype]}", 8,
        (ctypes.c_int,) * 4,
    )
    code = fn(
        v.data_ptr(), p0.data_ptr(), q0.data_ptr(), lam.data_ptr(),
        p.data_ptr(), q.data_ptr(), scratch.data_ptr(), u.data_ptr(),
        H, W, int(n_iter), int(bool(isotropic)),
        v.device.index, _stream(v),
    )
    _raise_on(code, "fgp_resident", "fgp_resident")
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
        return fgp_tiles_plain(lam, v, p0, q0, n_iter, isotropic)
    lam = _checked("fgp_tiles", lam, v, p0, q0)
    H, W = v.shape
    name = "fgp_tiles_pipelined" if pipelined else "fgp_tiles"
    sfx = _SUFFIX[v.dtype]
    wh, ww = TILE_WINDOW[v.dtype]
    sweep = _entry(
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
        _raise_on(code, "fgp_tiles", name)
        launch_counts[name] += 1
        src = tuple(dst)
    p, q = src[0], src[1]
    if int(n_iter) == 0:
        p, q = p0.clone(), q0.clone()
    recover = _entry("fgp_tiles", f"zt_fgp_recover_u_{sfx}", 5, (ctypes.c_int,) * 2)
    code = recover(
        v.data_ptr(), p.data_ptr(), q.data_ptr(), lam.data_ptr(), u.data_ptr(),
        H, W, v.device.index, stream,
    )
    _raise_on(code, "fgp_tiles", name)
    launch_counts[name] += 1
    return u, p, q
