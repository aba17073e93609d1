"""The harness is driven by data: a configuration, a traffic mix, limits
and a per-layer metric added as files alone are found by their names;
without a card a run prints no result."""

import json
import os
import shutil
import subprocess
import sys
import time

import torch

from portbench import harness

ROOT = harness.ROOT


def _copy_bench(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(
        ROOT / "portbench", dst / "portbench",
        ignore=shutil.ignore_patterns("tests", "__pycache__"),
    )


def test_a_cell_added_as_files_is_found_and_run(tmp_path):
    _copy_bench(tmp_path)
    bench = tmp_path / "portbench"
    # A configuration: its sizes, its recipe, its reference (here the
    # LASSO's, at a toy size).
    spec = json.loads((bench / "configs" / "lasso_n10k.json").read_text())
    spec.update(name="toy", m=40, n=200, support=4)
    (bench / "configs" / "toy.json").write_text(json.dumps(spec))
    shutil.copy(bench / "configs" / "lasso_n10k.py", bench / "configs" / "toy.py")
    shutil.copy(bench / "reference" / "lasso_n10k.py", bench / "reference" / "toy.py")
    # A traffic mix, its cell's limits, and a per-layer metric.
    traffic = json.loads((bench / "traffic" / "fixed.json").read_text())
    traffic.update(warmup_calls=1, trace_seconds=0.0)
    (bench / "traffic" / "toy_traffic.json").write_text(json.dumps(traffic))
    (bench / "limits" / "toy.once.json").write_text(json.dumps({"x_gap": 1.0, "stop_ratio": 2.0}))
    (bench / "metrics" / "toy_calls.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n"
    )
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "toy", "source": "test", "file": "portbench/configs/toy.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "toy.once", "config": "toy", "traffic": "toy_traffic",
                             "chips": 1, "why": "test"})
    # An end-to-end metric and a per-layer one of quantities the harness
    # has, found by the quantity's name without a file or an edit.
    doc["end_to_end"].append({"name": "solves_per_s.toy", "unit": "solves/s", "better": "higher",
                              "bound": 0.1, "source": "host_clock", "workloads": ["toy.once"]})
    doc["per_layer"].append({"name": "toy_calls", "unit": "calls", "better": "higher",
                             "source": "program_counter", "layer": "test",
                             "moves": "solves_per_s.toy", "workloads": ["toy.once"]})
    doc["per_layer"].append({"name": "useful_step_share.toy", "unit": "%", "better": "higher",
                             "source": "program_counter", "layer": "test",
                             "moves": "solves_per_s.toy", "workloads": ["toy.once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = harness.Cell("toy.once", root=tmp_path)
    assert cell.spec["m"] == 40 and cell.traffic["method"] == "solve_fixed_step"
    assert cell.limits == {"x_gap": 1.0, "stop_ratio": 2.0}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "solves_per_s.toy"]
    names = [m["name"] for m in cell.per_layer]
    assert "toy_calls" in names and "newton_per_iter" not in names
    assert cell.metric_files["useful_step_share.toy"].name == "useful_step_share.py"

    cpu = torch.device("cpu")
    for trace in (False, True):
        out = harness.run("toy.once", 1, 0.2, trace, t_start=time.perf_counter(), device=cpu,
                          root=tmp_path)
        assert out["correct"] is True and out["attempted"] == out["calls"] >= 1
        assert list(out)[-1] == "checks"
        assert set(out["checks"]) == {"x_gap", "stop_ratio"}
        if trace:
            assert out["metrics"]["toy_calls"]["value"] == out["calls"]
            # The CPU replays no graphs: the reader finds nothing, and the
            # metric is left out of the line.
            assert "useful_step_share.toy" not in out["metrics"]
        else:
            assert set(out["metrics"]) == {"solves_per_s.toy", "setup_s"}
            assert out["metrics"]["solves_per_s.toy"]["value"] > 0


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_no_card_no_result():
    proc = _run(ROOT, "--workload", "lasso_n10k.fixed", "--seed", "2147483700", "--seconds", "1")
    assert proc.returncode != 0
    assert proc.stdout == ""
    lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("portbench:")]
    assert len(lines) == 1 and "CUDA" in lines[0]


def test_the_benchmark_alone_is_not_enough(tmp_path):
    _copy_bench(tmp_path)
    proc = _run(tmp_path, "--workload", "lasso_n10k.fixed", "--seed", "1", "--seconds", "1")
    assert proc.returncode != 0 and proc.stdout == ""


def test_every_seed_gets_the_same_work():
    # The LASSO cells solve one fixed set of instances: every round of
    # calls takes each once, and the seed draws only the order.
    cell = harness.Cell("lasso_n10k.fixed")
    count = len(cell.spec["instances"])
    assert count > 1

    def order(seed):
        return [cell.config.instance(cell.spec, seed, k) for k in range(8 * count)]

    for seed in (1, 2**31 + 5, 6_000_000_007):
        got = order(seed)
        assert got == order(seed)
        for r in range(8):
            assert sorted(got[r * count:(r + 1) * count]) == list(range(count))
    assert order(1) != order(2)
    over = {"spec": {"m": 40, "n": 200, "support": 4}, "traffic": {"warmup_calls": 1}}
    out = harness.run("lasso_n10k.fixed", 7, 0.01, False, t_start=time.perf_counter(),
                      device=torch.device("cpu"), overrides=over)
    # The window ends with a whole round.
    assert out["correct"] is True and out["calls"] % count == 0
