"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name (``adlb_tpu_torch`` begins with ``adlb_tpu`` and is
allowed where the program is driven); the references import nothing of the
program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "adlb_tpu"}
#: the yardstick: references, traffic, bounds, the per-layer readers
PROGRAM_FREE = ["reference.py", "bounds.py", "churn.py", "common.py"] + [
    f"metrics/{p.name}" for p in sorted((BENCH / "metrics").glob("*.py"))]


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    names.add(arg.value.split(".")[0])
    return names


def all_modules():
    return sorted(p for p in BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", all_modules(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_jax_package(path):
    bad = top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import adlb_tpu_torch.api\nfrom adlb_tpu.runtime import x\n"
                 "import jaxlib\n")
    assert top_level_imports(f) & FORBIDDEN == {"adlb_tpu", "jaxlib"}
    assert "adlb_tpu_torch" in top_level_imports(f)


@pytest.mark.parametrize("name", PROGRAM_FREE)
def test_yardstick_imports_nothing_of_the_program(name):
    names = top_level_imports(BENCH / name)
    assert "adlb_tpu_torch" not in names, name
    assert not names & FORBIDDEN, name


def test_reference_imports_numpy_alone():
    assert top_level_imports(BENCH / "reference.py") <= {"__future__",
                                                           "numpy"}
