"""Build and run an ad-hoc plan with PlanBuilder on the port.

Counterpart of ``examples/02_custom_plan.py``: Values, a filter, a
group-by and an ORDER BY. Runs on the card unless asked for the CPU::

    python velox_tpu_torch/examples/02_custom_plan.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import pyarrow as pa  # noqa: E402
import torch  # noqa: E402

from velox_tpu_torch.exec.task import QueryCtx, Task  # noqa: E402
from velox_tpu_torch.testing.plan_builder import PlanBuilder  # noqa: E402

ORDERS = pa.table({
    "o_id": pa.array([1, 2, 3, 4], pa.int64()),
    "cust": pa.array(["a", "b", "a", "c"], pa.string()),
    "total": pa.array([10.0, 22.5, 7.0, 99.0], pa.float64()),
})


def main(argv=None) -> pa.Table:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    plan = (PlanBuilder()
            .values([ORDERS])
            .filter("total > 8.0")
            .single_aggregation(["cust"], ["sum(total) as spend",
                                           "count(*) as n"])
            .order_by(["spend desc"])
            .plan())
    result = Task(plan, QueryCtx(args.device)).run()
    print(result)
    return result


if __name__ == "__main__":
    main()
