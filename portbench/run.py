"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison with the plain reference gave, beside its limit); the last
lines of standard error repeat the checks.  Without the CUDA devices the
cell asks for, or with a JAX module loaded, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a whole number >= 0")

    # Kernel caches at fixed paths inside the checkout: the program builds
    # its own under zfista_tpu_torch/_build/.
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "zfista_tpu_torch" / "_build" / "triton"))
    sys.path.insert(0, str(ROOT))
    try:
        import zfista_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program is not here ({exc})", file=sys.stderr)
        return 2
    from portbench import harness

    try:
        result = harness.run(
            args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START
        )
    except harness.NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
