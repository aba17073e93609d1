"""What the kernel benches share: the card they time, and their timer.

The benches time the CUDA kernels against their plain PyTorch versions,
so they need a card: without one they exit with status 1 and a message,
and they never fall back to the CPU.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable

import torch

#: Cycles the stream is held before a timed window (~50 ms at an H100's
#: clocks).  The host queues the window meanwhile, so the events time the
#: device, not the host's launch rate, as long as the host has queued the
#: whole window before the hold runs out (:func:`held_ms` checks).
HOLD_CYCLES = 100_000_000
#: Times :func:`held_ms` doubles the hold of a window that outran it.
HOLD_DOUBLINGS = 3


def require_card(prog: str) -> str:
    """The card's ``name, power limit`` as ``nvidia-smi`` prints them;
    exits with status 1 and a message on a machine with no CUDA device."""
    if not torch.cuda.is_available():
        print(
            f"{prog}: no CUDA device (torch.cuda.is_available() is False); "
            "this bench times the CUDA kernels and does not run on the CPU",
            file=sys.stderr,
        )
        raise SystemExit(1)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def held_ms(run: Callable[[], object], repeats: int = 1, device_bound: bool = True) -> float:
    """Least device milliseconds of ``run()`` (which enqueues a whole
    window of launches) over ``repeats`` windows, by CUDA events, each
    window behind a stream hold; after one untimed warm-up run.

    With ``device_bound`` (a kernel's window) the host must have queued
    the whole window before the hold ran out, so that the card runs it
    back to back: a window whose start event had already passed when its
    last launch was queued is timed again behind a hold twice as long, up
    to :data:`HOLD_DOUBLINGS` times, and then raises.  A window the host is
    expected to pace (a plain version's many small launches, more than the
    launch queue holds) passes ``device_bound=False``: it is timed behind
    :data:`HOLD_CYCLES` at whichever rate is the slower, the card's or the
    host's."""
    run()
    hold, best = HOLD_CYCLES, float("inf")
    for _ in range(repeats):
        for doubling in range(HOLD_DOUBLINGS + 1):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(hold)
            start.record()
            run()
            outran = start.query()
            stop.record()
            stop.synchronize()
            if not (device_bound and outran):
                break
            if doubling == HOLD_DOUBLINGS:
                raise RuntimeError(
                    f"held_ms: the host still queued the window after a hold of {hold} "
                    "cycles; its time would be the host's launch rate"
                )
            hold *= 2
        best = min(best, start.elapsed_time(stop))
    return best


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors (so +0 != -0; a NaN equals any NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    same = (a.view(bits) == b.view(bits)) | (torch.isnan(a) & torch.isnan(b))
    return bool(torch.all(same))
