"""The PyTorch port's notebooks (``examples/notebooks/*_torch.ipynb``) are
built and executed by ``python -m zfista_tpu_torch.examples.notebooks``:
the committed notebooks must match the generator's cell sources, carry
real executed outputs with no error, pin their device in the first code
cell, and import nothing of JAX or of the JAX package (as
``tests/test_notebooks.py`` holds the JAX notebooks)."""

import torch_env  # noqa: F401  (one torch thread a process)
import re
from pathlib import Path

import nbformat
import pytest
import torch

from zfista_tpu_torch.examples import notebooks as gen

ROOT = Path(__file__).resolve().parent.parent
NAMES = sorted(gen.NOTEBOOKS)
#: An import of JAX or of the JAX package (not of zfista_tpu_torch).
JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|zfista_tpu)(\.|\s|$)", re.MULTILINE)


def _read(name):
    path = ROOT / "examples" / "notebooks" / name
    assert path.exists(), (
        f"{name} not built: run python -m zfista_tpu_torch.examples.notebooks --device cpu"
    )
    return nbformat.read(path, as_version=4)


def test_generator_names_the_two_notebooks():
    assert NAMES == ["getting_started_torch.ipynb", "tv_deblur_torch.ipynb"]


@pytest.mark.parametrize("name", NAMES)
def test_notebook_matches_generator_sources(name):
    got = [("md" if c.cell_type == "markdown" else "code", c.source.rstrip("\n"))
           for c in _read(name).cells]
    want = [(k, s.rstrip("\n")) for k, s in gen.cells(name, "cpu")]
    assert got == want, f"{name} cells drifted from zfista_tpu_torch/examples/notebooks.py"


@pytest.mark.parametrize("name", NAMES)
def test_notebook_carries_executed_outputs(name):
    code = [c for c in _read(name).cells if c.cell_type == "code"]
    assert code
    for c in code:
        assert c.execution_count is not None, f"{name}: unexecuted cell"
        for out in c.outputs:
            assert out.output_type != "error", f"{name}: error output {out.get('ename')}"
    # The committed outputs are a CPU run, and the first code cell says so.
    assert code[0].source.startswith('DEVICE = "cpu"')
    assert any("cpu" in "".join(o.get("text", "")) for o in code[0].outputs)


@pytest.mark.parametrize("name", NAMES)
def test_notebook_imports_no_jax(name):
    for c in _read(name).cells:
        if c.cell_type == "code":
            assert not JAX_IMPORT.search(c.source), c.source
    assert JAX_IMPORT.search("import jax.numpy as jnp") and JAX_IMPORT.search("from zfista_tpu.models import x")
    assert not JAX_IMPORT.search("import zfista_tpu_torch")


def test_generator_defaults_to_the_card(monkeypatch, tmp_path):
    """``--device`` defaults to ``cuda`` and raises without a card before
    it writes anything; the device given is the first code cell's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gen, "OUT", tmp_path / "notebooks")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.main(["--no-exec"])
    assert not gen.OUT.exists()
    assert gen.main(["--no-exec", "--device", "cpu"]) == 0
    for name in NAMES:
        nb = nbformat.read(gen.OUT / name, as_version=4)
        code = [c.source for c in nb.cells if c.cell_type == "code"]
        assert code[0].startswith('DEVICE = "cpu"') and not any("DEVICE =" in c for c in code[1:])
    assert gen.cells(NAMES[0], "cuda")[1][1].startswith('DEVICE = "cuda"')
