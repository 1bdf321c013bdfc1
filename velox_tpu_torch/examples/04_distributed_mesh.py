"""Distributed execution over a mesh of shards on the port.

Counterpart of ``examples/04_distributed_mesh.py``: a DistributedTask
over ``make_mesh(8)``, eight shards on the one card (the reference runs
eight virtual devices), lineitem in 16,384-row splits. Runs on the card
unless asked for the CPU::

    python velox_tpu_torch/examples/04_distributed_mesh.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import pyarrow as pa  # noqa: E402
import torch  # noqa: E402

from velox_tpu_torch.connectors.connector import (  # noqa: E402
    register_connector,
)
from velox_tpu_torch.connectors.tpch import TpchConnector  # noqa: E402
from velox_tpu_torch.parallel import DistributedTask, make_mesh  # noqa: E402
from velox_tpu_torch.testing.plan_builder import PlanBuilder  # noqa: E402


def main(argv=None) -> pa.Table:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    register_connector(TpchConnector("tpch-d", scale_factor=0.01,
                                     rows_per_split=16384))
    plan = (PlanBuilder()
            .table_scan("lineitem", ["l_returnflag", "l_quantity"],
                        connector_id="tpch-d")
            .single_aggregation(["l_returnflag"], ["sum(l_quantity) as q",
                                                   "count(*) as n"])
            .order_by(["l_returnflag"])
            .plan())
    result = DistributedTask(plan, make_mesh(8, args.device)).run()
    print(result)
    return result


if __name__ == "__main__":
    main()
