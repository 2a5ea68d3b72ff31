"""What the benchmark's files import, by an AST scan: nothing under
perfbench loads JAX or the JAX package (a module's top-level name compared
whole: the port's name begins with the JAX package's), and the reference
and the yardstick import nothing of the program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "chimera_st_tpu"}
PROGRAM = "chimera_st_tpu_torch"


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported(path)) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py"))
                         + sorted((BENCH / "yardstick").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_yardstick_stand_apart(path):
    assert PROGRAM not in set(imported(path))


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import chimera_st_tpu_torch.ops\nfrom chimera_st_tpu import x\n")
    assert list(imported(f)) == [PROGRAM, "chimera_st_tpu"]
