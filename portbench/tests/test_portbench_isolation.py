"""No module of the benchmark imports JAX or the JAX package; the plain
reference imports nothing of the port, of chip_smoke or of the tests.
Names are compared by their whole top-level part (the port's name begins
with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "s3shuffle_tpu"}
REFERENCE_FORBIDDEN = FORBIDDEN | {"s3shuffle_tpu_torch", "chip_smoke", "tests"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".", 1)[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".", 1)[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & REFERENCE_FORBIDDEN


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom s3shuffle_tpu.codec import x\n"
                   "import s3shuffle_tpu_torch\n")
    assert top_level_imports(bad) == {"jax", "s3shuffle_tpu", "s3shuffle_tpu_torch"}
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "s3shuffle_tpu"}


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from portbench import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    monkeypatch.setitem(sys.modules, "s3shuffle_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jaxlib"]
