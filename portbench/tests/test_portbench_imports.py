"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
references import nothing of the program. Module names are compared by
their top-level name, whole: ``repro_torch`` is not ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py"))


def imported_tops(path: Path) -> set:
    """Top-level names of the modules a file imports (absolute imports)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro.core import x\n"
                 "import jaxtyping\n")
    assert imported_tops(f) == {"repro_torch", "repro", "jaxtyping"}
    assert imported_tops(f) & NEVER == {"repro"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_nor_jax_package(path):
    assert not imported_tops(path) & NEVER, path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & (NEVER | {"repro_torch"}), path


def test_reference_loads_no_program_module(root):
    """Importing the references loads neither the program nor JAX."""
    code = ("import sys; sys.path[:0] = [{!r}]\n"
            "import portbench.reference.mpnn, portbench.reference.lm\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            "{{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}}))"
            ).format(str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
