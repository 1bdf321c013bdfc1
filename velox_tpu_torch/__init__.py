"""velox_tpu_torch: the velox_tpu query engine on PyTorch and CUDA.

A port of ``velox_tpu`` (JAX on a TPU) to PyTorch on one NVIDIA H100.
Modules keep the reference's layout and names. Plain tensor code is
eager PyTorch on an explicit ``torch.device`` (``QueryCtx.device``);
every Pallas kernel of the reference becomes a hand-written CUDA kernel
under ``csrc/``, each with a plain PyTorch version that CPU tensors use.

The numpy-only layers (types, core, parse, testing/plan_builder,
tpch/queries, common) are copies of the reference's: this package never
imports ``velox_tpu``, whose ``__init__`` imports jax.
"""

__version__ = "0.1.0"

from velox_tpu_torch import types  # noqa: F401,E402
