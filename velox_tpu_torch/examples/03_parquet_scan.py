"""Write a partitioned Parquet table with the port, then scan it back
with partition pruning.

Counterpart of ``examples/03_parquet_scan.py``: TableWrite partitioned by
``region`` through the Hive connector, then a filtered scan and a
group-by. The data comes from a fixed seed; the files go to a temporary
directory that is removed at the end. Runs on the card unless asked for
the CPU::

    python velox_tpu_torch/examples/03_parquet_scan.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import torch  # noqa: E402

from velox_tpu_torch.connectors.hive import register_hive  # noqa: E402
from velox_tpu_torch.exec.task import QueryCtx, Task  # noqa: E402
from velox_tpu_torch.testing.plan_builder import PlanBuilder  # noqa: E402

ROWS = 1000
FILTER = "region = 'eu' and amount > 250"
SEED = 0


def sales() -> pa.Table:
    rng = np.random.default_rng(SEED)
    return pa.table({
        "region": pa.array(rng.choice(["eu", "us"], ROWS).tolist()),
        "amount": pa.array(rng.integers(0, 500, ROWS), pa.int64()),
    })


def main(argv=None) -> pa.Table:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    ctx = QueryCtx(args.device)
    conn = register_hive()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "sales")
        Task(PlanBuilder().values([sales()])
             .table_write(root, partition_keys=["region"]).plan(),
             ctx).run()
        conn.register_table("sales", root)
        plan = (PlanBuilder()
                .table_scan("sales", ["region", "amount"],
                            connector_id="hive", filter=FILTER)
                .single_aggregation(["region"], ["sum(amount) as s",
                                                 "count(*) as n"])
                .plan())
        result = Task(plan, ctx).run()
    print(result)
    return result


if __name__ == "__main__":
    main()
