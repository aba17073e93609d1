"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3] [--calls N]

For each seed: the cell's data, the program's warm-up and ``--calls``
calls of its traffic (the timed path, without a window), and the
comparison's numbers (the lower readings).  For each control seed the
same inputs solved by the control, the plain reference in the precision
below the configuration's (float32 for float64; TF32 products for
float32), judged by the same comparison (the upper readings), and where
the comparison judges the stop, the readings of a solve that stops early
(:func:`early_stops`).  One JSON
line per reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_calls(cell, data, calls, device) -> list[dict]:
    """``calls`` with the program's answers replaced by the control's."""
    import numpy as np
    import torch

    ref = cell.reference
    x0s = np.concatenate([c["x0"] for c in calls])
    if cell.spec["dtype"] == "float64":
        got = ref.answers(cell.traffic, x0s, torch.float32, device)
        xs, nits = got["x"], got["nit"]
        status = got["status"]
    else:
        got = ref.answers(cell.traffic, data, list(x0s), torch.float32, tf32=True,
                          max_iter=ref.CONTROL_MAX_ITER, instances=ref.lane_instances(calls))
        xs = np.stack([g["x"] for g in got])
        nits = np.array([g["nit"] for g in got])
        status = np.array([g["status"] for g in got])
    out, at = [], 0
    for c in calls:
        k = len(c["x0"])
        out.append(dict(c, x=xs[at:at + k], nit=nits[at:at + k],
                        status=status[at:at + k]))
        at += k
    return out


def early_stops(cell, data, calls) -> dict:
    """The fault of a driver or stop test that ends a converging solve
    early, planted in the float64 reference put in the program's place:
    ``stop_ratio`` where each call stops one chunk (``check_every``
    iterations) before its own count, and where it stops at 0.8 of it.
    The answer is the reference's own at that count, so ``x_gap`` reads 0
    and the stop alone can show the fault."""
    import numpy as np
    import torch

    opts = cell.traffic["options"]
    tol, chunk = float(opts["tol"]), int(opts.get("check_every") or 1)
    x0s = [x0 for c in calls for x0 in c["x0"]]
    nits = [int(n) for c in calls for n in c["nit"]]
    ref = cell.reference.answers(cell.traffic, data, x0s, torch.float64, iterations=nits,
                                 instances=cell.reference.lane_instances(calls))
    out = {}
    for name, at in (("chunk", lambda n: n - chunk), ("0.8", lambda n: int(round(0.8 * n)))):
        out[f"stop_ratio_{name}"] = float(min(
            r["errs"][at(n) - 1] / tol for r, n in zip(ref, nits) if at(n) >= 1
        ))
    out["x_gap"] = 0.0
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--calls", type=int, default=0,
                        help="calls a seed (default: one round, every instance once)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.Cell(args.workload)
    device = harness.card_check(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        data = cell.config.make_data(cell.spec, seed, device)
        client = harness.Client(cell, cell.config.build(cell.spec, data), seed, device)
        client.warm_up()
        calls = [client(k) for k in range(args.calls or len(client.problems))]
        del client
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        program = cell.reference.judge(cell.spec, cell.traffic, data, calls, seed, device)
        row = {"workload": cell.name, "seed": seed, "program": program,
               "judge_s": time.perf_counter() - t0,
               "nit": [int(c["nit"].max()) for c in calls],
               "instance": [c["instance"] for c in calls]}
        if seed in controls:
            ctrl = control_calls(cell, data, calls, device)
            row["control"] = cell.reference.judge(cell.spec, cell.traffic, data, ctrl, seed, device)
            if "stop_ratio" in program:
                row["early"] = early_stops(cell, data, calls)
        print(json.dumps(row), flush=True)
        del data
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
