"""One run of one cell of the port's benchmark, driven by data.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix.  Everything that belongs to one of them is a file found by
its name:

* ``configs/<config>.json``: the configuration as it is run (sizes, dtype,
  the start box), and ``configs/<config>.py``: its data recipe (made from
  the seed, on the device), the program object it builds, or a list of
  them, one for each instance the calls take turns on, and then
  ``instance(spec, seed, call)``, the instance of each call;
* ``reference/<config>.py``: its plain reference and the comparison that
  decides ``correct``;
* ``traffic/<traffic>.json``: the request stream (the public method
  called, starts per call, the call's options, warm-up calls, the traced
  slice's length);
* ``limits/<cell>.json``: the limit of each number the comparison gives;
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(ctx)``,
  which returns its value or None where it finds nothing to read; a
  metric named ``<quantity>.<part>`` without a file of its own takes
  ``metrics/<quantity>.py`` (:func:`metric_file`).  End-to-end metrics
  are the harness's own, found the same way by their quantity.

The traffic is a closed loop with one client: calls back to back, each
waiting for its host result, until ``seconds`` have passed; the window
ends at the end of the last call, and of a whole round: as many calls as
the configuration has instances, every instance once, so that every run
does the same mix of work.  A traced run has the same window and
the same comparison; the profiler records only its first calls.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import numpy as np

from portbench import arith
from portbench import trace as tracing

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: Top-level module names that no process of the benchmark may hold: the
#: JAX stack and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "zfista_tpu")


class NoCard(RuntimeError):
    """The run asked for more CUDA devices than the machine has."""


def load_module(path: Path) -> ModuleType:
    """The module in the file ``path``, loaded by its path (names may hold
    dots, so they are not import names)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds, each
    compared whole (``zfista_tpu_torch`` is not ``zfista_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Cell:
    """A cell's entry in ``BENCHMARK.json`` and the files it names."""

    def __init__(self, name: str, root: Path = ROOT, overrides: dict | None = None) -> None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = work[name]
        self.chips = int(self.entry["chips"])
        config = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        base = root / "portbench"
        self.spec = json.loads((root / config["file"]).read_text())
        self.config = load_module(base / "configs" / f"{config['name']}.py")
        self.reference = load_module(base / "reference" / f"{config['name']}.py")
        self.traffic = json.loads((base / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((base / "limits" / f"{name}.json").read_text())
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)

        def mine(metric: dict) -> bool:
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        self.metric_files = {m["name"]: metric_file(base, m["name"]) for m in self.per_layer}


def base_name(metric: str) -> str:
    """A metric's quantity: its name before the first dot.  One quantity
    split by the end-to-end metric it moves, or by the cells it covers,
    keeps its reader (``device_idle_share.lanes`` is ``device_idle_share``)."""
    return metric.split(".", 1)[0]


def metric_file(base: Path, name: str) -> Path:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    else its quantity's, ``metrics/<base_name>.py``."""
    own = base / "metrics" / f"{name}.py"
    return own if own.exists() else base / "metrics" / f"{base_name(name)}.py"


def card_check(chips: int):
    """The CUDA device the run uses; raises :class:`NoCard` where the
    machine has fewer than ``chips`` cards.  There is no CPU fallback."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(
            f"the cell needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
        )
    return torch.device("cuda", 0)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


class Client:
    """The traffic's one client: call ``k`` draws its starts from the seed
    and ``k``, calls the program's public method on the instance the
    configuration gives it and keeps what it returned (on the host).
    ``problems`` is the program object the configuration builds, or a
    list of them, one an instance."""

    def __init__(self, cell: Cell, problems, seed: int, device) -> None:
        self.cell, self.seed, self.device = cell, seed, device
        self.problems = problems if isinstance(problems, list) else [problems]
        t = cell.traffic
        self.methods = [getattr(p, t["method"]) for p in self.problems]
        self.options = dict(t["options"])
        if "nesterov_ratio" in self.options:
            self.options["nesterov_ratio"] = tuple(self.options["nesterov_ratio"])
        self.starts = int(t["starts"])
        self.batch = bool(t["batch"])
        from zfista_tpu_torch.core.solver import graph_counts

        self.graph_counts = graph_counts

    def instance(self, k: int) -> int:
        """The instance call ``k`` solves (0 where there is one)."""
        if len(self.problems) == 1:
            return 0
        return self.cell.config.instance(self.cell.spec, self.seed, k)

    def warm_up(self) -> None:
        """The traffic's warm-up calls on every instance."""
        for i in range(len(self.problems)):
            for k in range(int(self.cell.traffic["warmup_calls"])):
                self(-1 - k, instance=i)

    def __call__(self, k: int, instance: int | None = None) -> dict:
        import torch

        i = self.instance(k) if instance is None else instance
        x0 = self.cell.config.starts(self.cell.spec, self.seed, k, self.starts)
        if not self.batch:
            x0 = x0[0]
        captured = self.graph_counts["captures"]
        before = captured + self.graph_counts["replays"]
        with torch.profiler.record_function("portbench.call"):
            t0 = time.perf_counter()
            x0_dev = torch.as_tensor(x0, device=self.device)
            res = self.methods[i](x0_dev, **self.options)
            t1 = time.perf_counter()
        chunks = self.graph_counts["captures"] + self.graph_counts["replays"] - before
        captured = self.graph_counts["captures"] - captured
        lanes = lambda v: np.atleast_1d(np.asarray(v))  # noqa: E731
        return {
            "call": k,
            "instance": i,
            "x0": np.atleast_2d(x0),
            "wall_s": t1 - t0,
            "x": np.atleast_2d(np.asarray(res.x)),
            "nit": lanes(res.nit).astype(np.int64),
            "nit_internal": lanes(res.nit_internal).astype(np.int64),
            "status": lanes(res.status).astype(np.int64),
            "graph_chunks": int(chunks),
            "graph_captures": int(captured),
        }


def run(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    t_start: float,
    device=None,
    root: Path = ROOT,
    overrides: dict | None = None,
) -> dict:
    """One run of the cell ``name``: set-up, the window, the comparison.
    Returns the result line's fields (``checks`` last).  ``device`` None
    asks for the cell's cards (:func:`card_check`); a test passes the CPU."""
    import torch

    torch.set_num_threads(1)
    cell = Cell(name, root, overrides)
    if device is None:
        device = card_check(cell.chips)
    card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if card else "cpu"
    if card:
        print(f"card: {power_limit() or kind}", file=sys.stderr)

    data = cell.config.make_data(cell.spec, seed, device)
    problems = cell.config.build(cell.spec, data)
    client = Client(cell, problems, seed, device)
    client.warm_up()
    if card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    # The window is the same in both runs.  With ``trace`` the profiler,
    # started before it, records its first calls (``trace_seconds``, one
    # round at least) and is stopped; the stop is left out of the window.
    calls = []
    per_round = len(client.problems)
    held = 0.0
    prof = tracing.start() if trace else None
    w0 = time.perf_counter()
    if trace:
        with torch.profiler.record_function(tracing.WINDOW):
            while (not calls or len(calls) % per_round
                   or time.perf_counter() - w0 < min(seconds, cell.traffic["trace_seconds"])):
                calls.append(dict(client(len(calls)), traced=True))
        t_stop = time.perf_counter()
        tracing.stop(prof)
        held = time.perf_counter() - t_stop
    while not calls or len(calls) % per_round or time.perf_counter() - w0 - held < seconds:
        calls.append(dict(client(len(calls)), traced=False))
    window_s = time.perf_counter() - w0 - held
    t_read = time.perf_counter()
    traced = tracing.read(prof) if trace else None
    walls = np.array([c["wall_s"] for c in calls])
    print(
        f"window: {len(calls)} calls in {window_s:.3f} s, wall first {walls[0]:.4f} s, "
        f"median {np.median(walls):.4f}, max {walls.max():.4f}; slowest nit "
        f"{max(int(c['nit'].max()) for c in calls)}; graph chunks "
        f"{sum(c['graph_chunks'] for c in calls)}, captured {sum(c['graph_captures'] for c in calls)}"
        f"; set-up {setup_s:.2f} s"
        + (f"; {sum(c['traced'] for c in calls)} calls traced, the profiler stopped in "
           f"{held:.1f} s and read in {time.perf_counter() - t_read:.1f} s" if trace else ""),
        file=sys.stderr,
    )
    memory_peak = torch.cuda.max_memory_allocated(device) if card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run holds forbidden modules: {', '.join(found)}")

    # The program's state goes before the reference runs, so that the
    # reference's memory never sets the peak.
    del client, problems
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    numbers = cell.reference.judge(cell.spec, cell.traffic, data, calls, seed, device)
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    status = np.concatenate([c["status"] for c in calls])
    solved = int(np.sum(status == 1))
    ctx = SimpleNamespace(
        spec=cell.spec, traffic=cell.traffic, calls=calls, trace=traced, peaks=arith.peaks(kind),
        traced=[c for c in calls if c.get("traced")],
        untraced=[c for c in calls if not c.get("traced")],
    )
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        for m in cell.per_layer:
            value = load_module(cell.metric_files[m["name"]]).read(ctx)
            if value is not None:
                metrics[m["name"]] = value
    else:
        e2e = {
            "solves_per_s": solved / window_s,
            "lanes_per_s": solved / window_s,
            "solve_ms_p95": 1e3 * arith.p95([c["wall_s"] for c in calls]),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: e2e[base_name(m["name"])] for m in cell.end_to_end}
    result = {
        "correct": bool(correct),
        "attempted": int(status.size),
        "failed": int(status.size - solved),
        "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in metrics.items()},
        "device": {
            "platform": "gpu" if card else "cpu",
            "kind": kind,
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops(), "idle_gaps": traced.idle_gaps()}
    result["calls"] = len(calls)
    result["checks"] = checks
    return result
