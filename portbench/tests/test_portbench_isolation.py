"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program.  Top-level module names
are compared whole: ``zfista_tpu_torch`` begins with ``zfista_tpu``."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.ROOT / "portbench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "zfista_tpu_torch" not in _imports(path)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "zfista_tpu_torch_like", sys)
    assert "zfista_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zfista_tpu.models", sys)
    assert "zfista_tpu" in harness.forbidden_modules()


_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from portbench import harness
refs = [harness.load_module(p) for p in harness.HERE.joinpath("reference").glob("*.py")]
after_refs = sorted({{m.split(".", 1)[0] for m in sys.modules}})
over = {{"spec": {{"m": 40, "n": 200, "support": 4}}, "traffic": {{"warmup_calls": 1}}}}
harness.run("lasso_n10k.fixed", 3, 0.1, True, t_start=time.perf_counter(),
            device=torch.device("cpu"), overrides=over)
over = {{"traffic": {{"starts": 4, "warmup_calls": 0, "options": {{
    "lr": 1.0, "tol": 1e-5, "tol_internal": 1e-11, "max_iter": 30, "decay_rate": 0.5,
    "nesterov": True, "nesterov_ratio": [0.0, 0.25], "check_every": 8}}}}}}
harness.run("fds_n10.front", 3, 0.1, False, t_start=time.perf_counter(),
            device=torch.device("cpu"), overrides=over)
print(json.dumps({{"after_refs": after_refs, "forbidden": harness.forbidden_modules()}}))
"""


def test_a_run_loads_no_jax_and_the_references_no_program():
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(root=str(harness.ROOT))],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    assert "zfista_tpu_torch" not in seen["after_refs"]
