"""No module under portbench/ imports JAX or the JAX package (whole
top-level names: `repro_torch` begins with `repro`), the yardstick
imports nothing of the program, and nothing reads benchmarks/."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = sorted(HERE.rglob("*.py"))
OLD_BENCH = "bench" + "marks/"       # the JAX package's benchmark folder


def top_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_reference_package(path):
    assert not top_imports(path) & {"jax", "jaxlib", "flax", "repro",
                                    "benchmarks"}
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    paths = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and id(n) not in docs and OLD_BENCH in n.value]
    assert not paths


@pytest.mark.parametrize("path", sorted((HERE / "yard").glob("*.py")),
                         ids=lambda p: p.name)
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_imports(path)
