"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Build model, the same as :mod:`zfista_tpu.native` uses for its g++ kernels:
``nvcc`` compiles one source into a shared library with a plain
``extern "C"`` interface, which :mod:`ctypes` loads.  No PyTorch headers
and no ``ninja`` are involved, so a build takes seconds.  The library is
cached under ``zfista_tpu_torch/_build/`` keyed by a hash of the source,
its headers, the flags and the compiler version, so a rebuild happens
only when one of them changes.

There is no fallback: a missing ``nvcc`` or a failed build raises.  The
caller asked for a CUDA kernel on a CUDA tensor, and a silent substitute
would make every measurement of that kernel a lie.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Hopper only: ``sm_90a`` (the ``a`` keeps wgmma/setmaxnreg available to
#: later kernels).  ``-fmad=false``: every kernel here rounds after each
#: operation, so it is bitwise equal to its plain PyTorch version (see the
#: note in each source).
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``
    (PyTorch's own resolution of the toolkit).  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found: zfista_tpu_torch builds its CUDA kernels from "
        "zfista_tpu_torch/csrc with the CUDA toolkit's nvcc (put it on PATH "
        "or set CUDA_HOME). CPU tensors need no build; they take the plain "
        "PyTorch versions."
    )


def _nvcc_version(nvcc: str) -> bytes:
    return subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, timeout=60
    ).stdout


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/`` (if not cached) and
    return the library's path.  The cache key covers the source and the
    headers (``csrc/*.cuh``) it may include."""
    src = CSRC / f"{name}.cu"
    nvcc = find_nvcc()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode() + _nvcc_version(nvcc)
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a process-unique name and rename into place: the rename
    # is atomic, so a concurrent process never loads a half-written file.
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            + " ".join(cmd)
            + "\n"
            + proc.stdout[-4000:]
            + proc.stderr[-4000:]
        )
    os.replace(tmp, out)
    for old in BUILD_DIR.glob(f"lib{name}_*.so"):
        if old != out:
            old.unlink(missing_ok=True)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib


@functools.cache
def entry(source: str, symbol: str, n_ptr: int, tail: tuple[Any, ...]) -> Any:
    """The typed ctypes entry ``symbol`` of ``csrc/<source>.cu`` (built on
    first use): ``n_ptr`` pointers, then ``tail``, then device and stream.
    Every pointer and the stream are ``c_void_p``: an undeclared argument
    would be passed as a 32-bit int and cut the address."""
    fn = getattr(load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + list(tail) + [
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def raise_on(code: int, source: str, what: str) -> None:
    """Raise if ``code``, the ``cudaError_t`` an entry of ``source``
    returned right after its launch, is not 0."""
    if code != 0:
        errstr = load(source).zt_cuda_error_string
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {code} "
            f"({errstr(code).decode()})"
        )
