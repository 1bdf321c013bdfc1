"""Shared by the benchmark's CPU tests: a throwaway checkout root whose
BENCHMARK.json holds the benchmark's cells at SF 0.01 (the ``root``
fixture, imported by each test file)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parent.parent
REPO = PORTBENCH.parent
sys.path.insert(0, str(REPO))

TINY_SF = 0.01


def tiny_root(root: Path) -> Path:
    """A root like the checkout's, every configuration at SF 0.01 and its
    Parquet files in a directory of its own; cells keep their names."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(PORTBENCH / sub, root / "portbench" / sub)
    for conf in bench["configs"]:
        path = root / conf["file"]
        cfg = json.loads(path.read_text())
        cfg["scale_factor"] = TINY_SF
        cfg["name"] = f"{cfg['name']}_cpu_test"
        path.write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def add_cell(root: Path, name: str, config: str, traffic: str) -> None:
    """A cell of one chip added to the root's BENCHMARK.json."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test"})
    path.write_text(json.dumps(bench))


@pytest.fixture
def root(tmp_path, monkeypatch):
    from portbench import datasets
    monkeypatch.setattr(datasets, "DATA_DIR", tmp_path / "data")
    return tiny_root(tmp_path / "root")
