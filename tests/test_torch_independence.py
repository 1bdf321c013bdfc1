"""The port stands alone: no file of ``velox_tpu_torch/`` and no line of
``chip_smoke.py`` imports jax or the reference package, or names a path
under the reference's ``velox_tpu/`` directory.

The check reads the sources (``ast`` for Python, the ``#include`` lines of
CUDA), so it also covers modules no test imports and code that runs only on
the card. Docstrings may name the reference's files they mirror; the
``"replaces"`` entries of chip_smoke.py's kernel line name the TPU kernel
each CUDA kernel replaces, as the line's contract asks, and are not read.
The same check by grep, which must print nothing::

    grep -rnE --include='*.py' --include='*.cu' \\
      "^\\s*(import|from)\\s+(jax|jaxlib|velox_tpu)\\b|[\\"']velox_tpu[\\"'/]|\\
    #include.*velox_tpu/|import_module\\(.(jax|velox_tpu)\\b" \\
      velox_tpu_torch chip_smoke.py | grep -v '"replaces":'
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_REFERENCE = ("jax", "jaxlib", "velox_tpu")
_CODE_IMPORT = re.compile(r"\b(import|from)\s+(jax|jaxlib|velox_tpu)\b")


def _is_reference(module: str) -> bool:
    return module.split(".")[0] in _REFERENCE


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant) and isinstance(
                    first.value.value, str):
                out.add(id(first.value))
    return out


def _kernel_provenance(tree):
    """Constants inside the value of a ``"replaces"`` dictionary entry."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    out.update(id(c) for c in ast.walk(v))
    return out


def reference_uses(source: str, suffix: str = ".py"):
    """Each line of `source` that imports jax or the reference, or names a
    path under ``velox_tpu/``, as (line number, reason)."""
    if suffix == ".cu":
        return [(i, "include") for i, line in
                enumerate(source.splitlines(), 1)
                if line.lstrip().startswith("#include")
                and "velox_tpu/" in line]
    tree = ast.parse(source)
    skip = _docstrings(tree) | _kernel_provenance(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(_is_reference(a.name) for a in node.names):
                found.append((node.lineno, "import"))
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _is_reference(node.module or ""):
                found.append((node.lineno, "import"))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    _is_reference(node.args[0].value):
                found.append((node.lineno, "import"))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in skip:
            v = node.value
            if v == "velox_tpu" or "velox_tpu/" in v:
                found.append((node.lineno, "path"))
            elif _CODE_IMPORT.search(v):
                found.append((node.lineno, "import in code text"))
    return sorted(found)


def _port_files():
    files = sorted(p for p in (REPO / "velox_tpu_torch").rglob("*")
                   if p.suffix in (".py", ".cu")
                   and "_build" not in p.parts)
    return files + [REPO / "chip_smoke.py"]


def test_no_port_file_reaches_the_reference():
    files = _port_files()
    assert len(files) > 90 and any(p.suffix == ".cu" for p in files)
    bad = {str(p.relative_to(REPO)): hits for p in files
           if (hits := reference_uses(p.read_text(), p.suffix))}
    assert not bad, bad


@pytest.mark.parametrize("source, suffix", [
    ("import jax\n", ".py"),
    ("import jax.numpy as jnp\n", ".py"),
    ("from jaxlib import xla_client\n", ".py"),
    ("def f():\n    from velox_tpu.exec import task\n", ".py"),
    ("import importlib\nm = importlib.import_module('velox_tpu.ops')\n",
     ".py"),
    ("m = __import__('jax')\n", ".py"),
    ("from pathlib import Path\nP = Path('.') / 'velox_tpu' / 'x.cpp'\n",
     ".py"),
    ("SRC = open('velox_tpu/native/dbgen.cpp').read()\n", ".py"),
    ("CODE = 'import velox_tpu.tpch as t'\n", ".py"),
    ('#include "../../velox_tpu/native/x.h"\n', ".cu"),
])
def test_the_check_finds_each_kind_of_reach(source, suffix):
    assert reference_uses(source, suffix)


@pytest.mark.parametrize("source", [
    '"""Counterpart of ``velox_tpu/exec/task.py``."""\n',
    'K = "velox_tpu.task.queries"\n',
    "import velox_tpu_torch\nfrom velox_tpu_torch.exec import task\n",
    'L = {"replaces": f"velox_tpu/ops/pallas_kernels.py:{3}"}\n',
    "# mirrors velox_tpu/ops/gather.py\nx = 1\n",
])
def test_the_check_passes_what_is_not_a_reach(source):
    assert reference_uses(source) == []
