"""The benchmark's import guard: nothing under ``portbench/`` imports JAX or
the JAX package, and nothing under ``portbench/reference/`` imports the port.

Names are compared by their top-level part whole (the part before the first
dot), so the port's ``dvt_circuits_tpu_torch`` is not taken for the JAX
package ``dvt_circuits_tpu``.  Relative imports are resolved against the
module's own package first."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dvt_circuits_tpu"}
PORT = "dvt_circuits_tpu_torch"


def _module_name(path: Path) -> str:
    rel = path.relative_to(BENCH.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def imported_modules(path: Path) -> set:
    """Absolute names of every module ``path`` imports, at any depth."""
    tree = ast.parse(path.read_text(), filename=str(path))
    package = _module_name(path).split(".")
    if path.name != "__init__.py":
        package = package[:-1]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                out.add(".".join(base + ([node.module] if node.module else [])))
            else:
                out.add(node.module)
    return out


def _top(name: str) -> str:
    return name.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


def test_sources_found():
    assert any(p.name == "run.py" for p in SOURCES)
    assert any("reference" in p.parts for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    bad = {m for m in imported_modules(path) if _top(m) in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.relative_to(BENCH).parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    bad = {m for m in imported_modules(path) if _top(m) == PORT}
    assert not bad, f"{path} imports {bad}"
    outside = {m for m in imported_modules(path)
               if _top(m) == "portbench" and not m.startswith("portbench.reference")}
    assert not outside, f"{path} imports {outside} from outside the reference"


def test_whole_name_comparison():
    assert _top("dvt_circuits_tpu_torch.prover") not in FORBIDDEN
    assert _top("dvt_circuits_tpu.prover") in FORBIDDEN
    assert _top("jax.numpy") in FORBIDDEN


def test_relative_imports_resolve():
    mods = imported_modules(BENCH / "reference" / "frozen" / "prover" / "pipeline.py")
    assert "portbench.reference.frozen.stark.verifier" in mods
    assert "portbench.reference.frozen.prover" in mods  # from . import curve_glue
