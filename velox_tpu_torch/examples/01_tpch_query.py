"""Run a TPC-H query end to end on the port.

Counterpart of ``examples/01_tpch_query.py``: the TPC-H connector, a Task
and its per-operator stats. Runs on the card unless asked for the CPU::

    python velox_tpu_torch/examples/01_tpch_query.py               # cuda
    python velox_tpu_torch/examples/01_tpch_query.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import pyarrow as pa  # noqa: E402
import torch  # noqa: E402

from velox_tpu_torch.connectors.tpch import register_tpch  # noqa: E402
from velox_tpu_torch.exec.task import QueryCtx, Task  # noqa: E402
from velox_tpu_torch.tpch import tpch_plan  # noqa: E402


def main(argv=None) -> pa.Table:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    register_tpch(0.01)                  # scale factor (SF1 = 6M lineitem)
    task = Task(tpch_plan(6), QueryCtx(args.device))
    result = task.run()
    print(result)
    print(task.print_plan_with_stats())
    return result


if __name__ == "__main__":
    main()
