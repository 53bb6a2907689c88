"""No module of the benchmark imports JAX or the JAX package, and no
reference imports the program: each import's top-level name compared whole
(the program's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "efficient_nerf_tpu"}
PROGRAM = "efficient_nerf_tpu_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(top_level_imports(path))


def test_the_comparison_is_whole_names():
    src = "import efficient_nerf_tpu_torch\nfrom efficient_nerf_tpu.core import rays\n"
    p = BENCH / "tests" / "_probe_imports.txt"
    try:
        p.write_text(src)
        names = set(top_level_imports(p))
    finally:
        p.unlink()
    assert names & JAX_NAMES == {"efficient_nerf_tpu"}
