"""``fds_n10``'s data recipe and the program object it builds.

FDS has no data beside its starts: call ``k``'s starts are uniform in the
box, drawn on the host from the seed and ``k`` (warm-up calls have
``k < 0``), so every call solves fresh starts.
"""

from __future__ import annotations

import numpy as np


def make_data(spec: dict, seed: int, device) -> dict:
    return {}


def build(spec: dict, data: dict):
    from zfista_tpu_torch.models.zoo import FDS

    return FDS(n_features=spec["n"])


def starts(spec: dict, seed: int, call: int, count: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), int(call) + 2**32])
    lo, hi = spec["box"]
    return rng.uniform(lo, hi, size=(count, spec["n"])).astype(spec["dtype"])
