"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Import names are compared as
whole top-level names: the program's name begins with the JAX package's."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

CARDBENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fft_tpu"}
PROGRAM = "fft_tpu_torch"


def top_level_imports(path: pathlib.Path) -> set:
    """The top-level names of every absolute import in a source file,
    wherever in the file it sits."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(CARDBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(CARDBENCH)) for p in SOURCES])
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((CARDBENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    # nor any benchmark module that does
    for name in top_level_imports(path):
        assert name in {"cardbench", "__future__", "math", "numpy",
                        "torch"}, name


def test_walk_finds_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    import fft_tpu.models.lm as m\n"
                   "from fft_tpu_torch import config\n")
    assert top_level_imports(bad) == {"fft_tpu", "fft_tpu_torch"}
    assert top_level_imports(bad) & FORBIDDEN == {"fft_tpu"}


def test_a_run_loads_no_jax():
    """Importing the harness, the loops and the readers, as a run does,
    loads none of the forbidden modules."""
    code = ("import sys, pathlib\n"
            "from cardbench import run, harness, calibrate, faults\n"
            "from cardbench.loops import train, prefill\n"
            "b = harness.Bench(pathlib.Path('.'))\n"
            "[b.reader(m['name']) for m in b.spec['per_layer']]\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=CARDBENCH.parent, check=True)
    assert out.stdout.strip() == "[]"
