"""Nothing under perfbench/ imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), nor the JAX benchmark's `bench.py` or `benchmarks/`; the
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "l2hmc_tpu", "bench", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "l2hmc_torch" not in names
    assert names <= {"__future__", "math", "dataclasses", "typing", "torch",
                     "perfbench"}


def test_the_scan_sees_what_it_must_refuse(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom l2hmc_tpu.ops import x\n"
                 "import l2hmc_torch\n")
    names = top_level_imports(f)
    assert {"jax", "l2hmc_tpu"} <= names & FORBIDDEN
    assert "l2hmc_torch" not in FORBIDDEN
