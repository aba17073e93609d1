"""What every test of the PyTorch port shares: one torch thread in each
test process and in the processes it starts, and the start of a world of
Gloo ranks on a port that no other process can take.

Every ``tests/test_torch_*.py`` imports this module before the port.
Each pytest-xdist worker collects every test file (``--dist loadfile``
only splits the running of them), so the import runs in every worker
before its first test.  With torch's default of one intra-op thread per
core, six workers on an eight-core machine run ~50 threads each, and a
solve that takes seconds alone takes minutes among them.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Sequence

import torch

torch.set_num_threads(1)

#: Seconds a world of Gloo ranks may take in all before its test fails.
RANKS_TIMEOUT = 600


def child_env(**extra: str) -> dict:
    """``os.environ`` for a child process, with one OpenMP thread (torch's
    intra-op threads there) and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def run_world(argv: Callable[[int, int], Sequence[str]], world: int, *, cwd, timeout: float,
              env: dict | None = None) -> list[tuple[int, str]]:
    """Run ranks ``argv(rank, port)`` for ``rank < world`` to their end
    and return each one's exit code and output (stderr within).

    The rendezvous's store is served from this process, on a port that
    the OS picks and that stays bound here until every rank has ended; the
    ranks join it as clients (``TORCHELASTIC_USE_AGENT_STORE``, which
    torch's ``tcp://`` rendezvous reads).  A port chosen, released and
    handed to rank 0 could be taken by another process before rank 0
    binds it.  ``timeout`` (seconds) bounds the whole world; a rank still
    running then is killed."""
    from torch.distributed import TCPStore

    store = TCPStore("localhost", 0, world, is_master=True, wait_for_workers=False)
    env = dict(child_env() if env is None else env, TORCHELASTIC_USE_AGENT_STORE="True")
    procs = [
        subprocess.Popen(list(argv(r, store.port)), cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del store
    return [(p.returncode, text) for p, text in zip(procs, outs)]
