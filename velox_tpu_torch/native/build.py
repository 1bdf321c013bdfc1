"""Build native sources into shared libraries at first use; load with ctypes.

Two kinds of library:

* ``dbgen``: the TPC-H generator core, compiled with g++ from the port's
  own ``native/dbgen.cpp`` (a byte-for-byte copy of the reference's
  ``velox_tpu/native/dbgen.cpp``; a test holds the two equal) into
  ``velox_tpu_torch/native/_build/``.
* one library per CUDA source under ``velox_tpu_torch/csrc/`` (the
  hand-written kernels), compiled with ``nvcc`` for ``sm_90a`` into
  ``velox_tpu_torch/csrc/_build/``. Each exposes a plain C entry point, so
  the build needs neither PyTorch's headers nor ninja and takes seconds;
  ``load_kernels`` starts one ``nvcc`` per source, all at once.

Each library is keyed by a hash of its sources and flags, built into a
temporary file and renamed into place, so concurrent processes never load
a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
DBGEN_SOURCE = _PKG / "native" / "dbgen.cpp"
CSRC = _PKG / "csrc"
NATIVE_BUILD_DIR = _PKG / "native" / "_build"
CUDA_BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: Dict[str, Optional[ctypes.CDLL]] = {}
_SM_COUNT: Dict[int, int] = {}
# seconds each library's compile took in this process (0.0 when the
# hashed library was already on disk); read by chip_smoke.py
BUILD_SECONDS: Dict[str, float] = {}
# the compiler's report of each library built in this process (for the
# CUDA kernels, ptxas's registers, shared memory and spills per kernel)
BUILD_LOG: Dict[str, str] = {}


def _build(name: str, sources: Sequence[Path], cmd: List[str],
           build_dir: Path) -> Path:
    """Compile `sources` with `cmd` (which names the output as "{out}")
    unless a library with the same source and flag hash exists."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for s in sources:
        h.update(s.read_bytes())
    out = build_dir / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(
        f".so.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    argv = [a.replace("{out}", str(tmp)) for a in cmd] \
        + [str(s) for s in sources]
    res = subprocess.run(argv, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {name} failed ({' '.join(argv)}):\n"
                           f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = (res.stdout + res.stderr)[-4000:]
    return out


def load_dbgen() -> Optional[ctypes.CDLL]:
    """The native TPC-H generator, or None when no C++ compiler exists
    (the numpy generator in connectors/tpch.py then produces the same
    arrays, more slowly)."""
    with _LOCK:
        if "dbgen" not in _LOADED:
            cc = next((c for c in ("g++", "clang++", "c++")
                       if shutil.which(c)), None)
            lib = None
            if cc is not None:
                path = _build("dbgen", [DBGEN_SOURCE],
                              [cc, "-O3", "-std=c++17", "-shared", "-fPIC",
                               "-pthread", "-o", "{out}"],
                              NATIVE_BUILD_DIR)
                lib = ctypes.CDLL(str(path))
            _LOADED["dbgen"] = lib
        return _LOADED["dbgen"]


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        p = Path(home) / "bin" / "nvcc"
        cand = str(p) if p.exists() else None
    if cand is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "velox_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return cand


def _build_kernel(name: str) -> Path:
    return _build(name, [CSRC / f"{name}.cu"],
                  [_nvcc()] + NVCC_FLAGS + ["-o", "{out}"], CUDA_BUILD_DIR)


def load_kernel(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build_kernel(name)))
            _LOADED[name] = lib
        return lib


def sm_count(device) -> int:
    """The SM count of CUDA ``device`` (a ``torch.device``), read once per
    device: the persistent kernels size their grids by it."""
    import torch
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Build every CUDA source in csrc/, one ``nvcc`` per source, all
    started together, and load them."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(_build_kernel, names))
    return {n: load_kernel(n) for n in names}
