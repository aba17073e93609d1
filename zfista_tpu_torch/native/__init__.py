"""Native (C++) host-side kernels, loaded via ctypes.

PyTorch-port counterpart of :mod:`zfista_tpu.native`: the same loader over
the port's own copy of ``metrics.cpp``, built into this package's
``_build/``.  Host code, not a CUDA kernel.

Build model: ``g++ -O3 -shared`` on first use (no pybind11 in the target
image; the extern "C" ABI + ctypes keeps the binding dependency-free).  The
compiled object is cached under ``_build/`` keyed by a source hash, so
rebuilds happen only when the source changes.  Every entry point has a
pure-numpy fallback in :mod:`zfista_tpu_torch.metrics`; ``load()`` returns None
when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
from pathlib import Path

_SRC = Path(__file__).parent / "metrics.cpp"
_BUILD = Path(__file__).parent / "_build"

_lib = None
_tried = False


def _compile() -> Path | None:
    src = _SRC.read_bytes()
    # Key the cache on (source, machine arch, compiler): the object is
    # built -march=native, so a _build/*.so carried to a different
    # microarchitecture (baked image, shared home) would dlopen fine and
    # then SIGILL on first call — the arch must be part of the identity.
    import platform

    cc_id = b""
    try:
        cc_id = subprocess.run(
            ["g++", "-dumpfullversion", "-dumpversion"],
            capture_output=True,
            timeout=10,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        pass
    tag = hashlib.sha256(
        src + platform.machine().encode() + platform.processor().encode()
        + cc_id
    ).hexdigest()[:16]
    ext = sysconfig.get_config_var("SHLIB_SUFFIX") or ".so"
    out = _BUILD / f"zt_metrics_{tag}{ext}"
    if out.exists():
        return out
    try:
        _BUILD.mkdir(exist_ok=True)
    except OSError:
        # Read-only install (e.g. site-packages in a locked container):
        # the numpy fallback is the contract, not a crash.
        return None
    # Prune stale-keyed objects (old source hashes / other arches built
    # here) — they accumulate forever otherwise.
    for old in _BUILD.glob(f"zt_metrics_*{ext}"):
        if old != out:
            try:
                old.unlink()
            except OSError:
                pass
    # Compile to a process-unique temp name and rename into place: the
    # rename is atomic, so concurrent processes on a cold cache can never
    # dlopen a half-written object.
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        str(_SRC),
        "-o",
        str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def load():
    """Return the loaded native library or None (then callers fall back)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _compile()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.zt_nd_mask.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.zt_nd_mask.restype = None
    lib.zt_hypervolume.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.zt_hypervolume.restype = ctypes.c_double
    _lib = lib
    return _lib


def nd_mask_native(F):
    """Non-dominated mask via the C++ kernel; None if unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    F = np.ascontiguousarray(F, dtype=np.float64)
    n, m = F.shape
    out = np.zeros(n, dtype=np.uint8)
    lib.zt_nd_mask(
        F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def hypervolume_native(P, ref):
    """WFG hypervolume via the C++ kernel; None if unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    P = np.ascontiguousarray(P, dtype=np.float64)
    ref = np.ascontiguousarray(ref, dtype=np.float64)
    n, m = P.shape
    return float(
        lib.zt_hypervolume(
            P.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n,
            m,
            ref.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    )
