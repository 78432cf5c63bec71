"""What the benchmark's files import and read: the reference imports
nothing of the program; nothing imports JAX or the JAX package; only
``system.py`` imports the program; nothing reads the old TPU benchmark."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
PORT = "pytorch_stable_diffusion_tpu_torch"
JAX_NAMES = {"jax", "jaxlib", "flax", "pytorch_stable_diffusion_tpu"}


def _imports(path: Path):
    """Every module ``path`` imports, relative imports resolved to their
    dotted names."""
    package = list(path.relative_to(BENCH.parent).parts[:-1])
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in JAX_NAMES | {PORT}, (path.name, name)
        assert not name.startswith("port_bench.") or name.startswith("port_bench.reference"), \
            (path.name, name)


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_the_program_only_in_system(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in JAX_NAMES, (path, name)
        if top == PORT and "tests" not in path.parts:
            assert path.name == "system.py", (path, name)


def test_nothing_reads_the_tpu_benchmark():
    for path in _sources():
        text = path.read_text()
        assert "bench.py" not in text and "benchmarks/" not in text, path
