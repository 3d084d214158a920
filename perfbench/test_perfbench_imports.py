"""Nothing under perfbench/ imports JAX or the JAX package, and the plain
references import no part of the program either. Imports are compared by
their top-level name, whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from perfbench._testing import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = REPO / "perfbench"


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_top_level_names_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro_torch import x\n")
    assert top_level_imports(f) == {"repro_torch"}
    f.write_text("import repro.models\n")
    assert top_level_imports(f) & FORBIDDEN == {"repro"}


def test_harness_loads_no_jax():
    """Importing every module of the harness and its references leaves no
    JAX name in ``sys.modules`` (``harness.jax_modules``)."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import perfbench.harness as h, perfbench.calibrate\n"
            "import perfbench.loops.pool_train, perfbench.loops.hier_train\n"
            "import perfbench.loops.score, perfbench.loops.serve\n"
            "import perfbench.reference.dense, perfbench.reference.ssm\n"
            "import repro_torch.serverless, repro_torch.launch.steps\n"
            "import repro_torch.serving\n"
            "print(h.jax_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
