"""The benchmark imports neither JAX nor the JAX package, and its plain
reference imports nothing of the program.

Every module under portbench/ is parsed with ``ast``; each import's
top-level name is compared whole (``velox_tpu_torch`` begins with
``velox_tpu`` and is allowed outside the reference).
"""

import ast
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parent.parent
NEVER = {"jax", "jaxlib", "flax", "velox_tpu"}
NOT_IN_REFERENCE = NEVER | {"velox_tpu_torch"}
# files the benchmark must not read: the JAX package's benchmark and
# the program's own smoke test and tools
NOT_READ = ("bench.py", "benchmarks.py", "chip_smoke.py", "tools/")


def _modules():
    return sorted(p for p in PORTBENCH.rglob("*.py")
                  if "_build" not in p.parts and "_data" not in p.parts)


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_finds_the_modules():
    names = {p.relative_to(PORTBENCH).as_posix() for p in _modules()}
    assert {"run.py", "harness.py", "reference/oracles.py",
            "plans/tpch.py"} <= names


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: p.relative_to(PORTBENCH).as_posix())
def test_no_jax_import(path):
    assert not imported_roots(path) & NEVER


@pytest.mark.parametrize(
    "path", sorted((PORTBENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_roots(path) & NOT_IN_REFERENCE


@pytest.mark.parametrize("path", [p for p in _modules()
                                  if "tests" not in p.parts],
                         ids=lambda p: p.relative_to(PORTBENCH).as_posix())
def test_reads_no_file_of_the_old_benchmark(path):
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    for s in strings:
        for name in NOT_READ:
            assert not (s == name or s.endswith("/" + name)
                        or s.startswith(name) and name.endswith("/")), \
                (path, s)


def test_names_compare_whole(tmp_path):
    jax_pkg = tmp_path / "a.py"
    jax_pkg.write_text("import velox_tpu.exec.task\n")
    port = tmp_path / "b.py"
    port.write_text("from velox_tpu_torch.exec import task\n"
                    "import importlib\n"
                    "importlib.import_module('jax.numpy')\n")
    assert imported_roots(jax_pkg) & NEVER == {"velox_tpu"}
    assert imported_roots(port) & NEVER == {"jax"}
    assert "velox_tpu_torch" in imported_roots(port) & NOT_IN_REFERENCE
