#!/usr/bin/env python3
"""Device-time breakdown of velox_tpu_torch query paths on one CUDA card.

Usage: python3 tools/profile_port_paths.py [--sf N] [--paths q3,q18,...]
                                           [--table-dir DIR]

For each path (q6, q1, q3, q18, topn, sort_full, q6_generic;
tpch_rest's queries q2, q4, q5, q7, q8, q9, q10, q11, q12, q13, q14,
q15, q16, q17, q19, q20, q21, q22; the analytic phase's plans
win_lineitem, win_orders_frames, topn_row_number, row_number_hash,
distinct_counts, q1_rollup, merge_join, streaming_agg; the aggregates
phase's plans agg_moments, agg_stddev_supp, agg_sketch_flag,
agg_sketch_global, agg_sketch_linenumber, agg_pct_single,
agg_pct_split, agg_min_by, agg_abandon, dyn_filter, dyn_filter_empty,
wide_join; the types phase's raw_group, raw_join, raw_topn, raw_sort,
raw_filter, raw_functions, dt_month, dt_week_hour, dt_zone and
decimal_mul; the complex phase's cx_array_agg, cx_unnest, cx_maps,
cx_map_union, cx_join, cx_join_topn and cx_bloom; the spark phase's
spark_shuffle_hash, spark_runtime_filter, spark_runtime_filter_pass,
spark_strings and spark_remote; the distributed phase's dist_q6,
dist_q1, dist_topn, dist_q3, dist_q18, dist_partitioned_join and
dist_skew, through DistributedTask on an 8-shard mesh of the card;
default q3,q18) it clears the scan cache and runs
chip_smoke.py's plan of that name cold (every split generated and
uploaded) and warm
(every split from the cache), then warm once more under torch.profiler
with CPU and CUDA activities: the regime of the reference's benchmark,
which reports a query's second run. It prints one JSON line: the card's
name and power limit, the three walls, the device-busy time (the summed
self device time of the CUDA-side rows only, kernels and memcpys: some
torch versions give an aten op its kernels' time again), its share of
the profiled wall, the host-to-device copies' part of it, and the
largest device items with their call counts. With --table-dir, the full
tables go to DIR/profile_<path>.txt. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import DIST_PATHS, MESH_SHARDS, PATH_PLANS  # noqa: E402
from velox_tpu_torch.connectors.cache import DataCache  # noqa: E402
from velox_tpu_torch.connectors.tpch import register_tpch  # noqa: E402
from velox_tpu_torch.exec.task import QueryCtx, Task  # noqa: E402


def run(plan, ctx, mesh=None) -> float:
    """One run's wall; through DistributedTask on ``mesh`` when given."""
    from velox_tpu_torch.parallel import DistributedTask
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task = Task(plan, ctx) if mesh is None \
        else DistributedTask(plan, mesh, ctx)
    for _ in task.batches():
        pass
    task.check_errors()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--paths", default="q3,q18")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--table-dir", default=None,
                    help="write each path's full profiler table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port_paths: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    register_tpch(args.sf)
    ctx = QueryCtx(device="cuda")
    if args.table_dir:
        os.makedirs(args.table_dir, exist_ok=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name in args.paths.split(","):
        mesh, pctx = None, ctx
        if name in DIST_PATHS:
            from velox_tpu_torch.parallel import make_mesh
            make, cfg = DIST_PATHS[name]
            plan, mesh = make(), make_mesh(MESH_SHARDS)
            pctx = QueryCtx(mesh.devices[0], dict(cfg))
        else:
            plan = PATH_PLANS[name]()
        DataCache.instance().clear()
        walls = [run(plan, pctx, mesh), run(plan, pctx, mesh)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            walls.append(run(plan, pctx, mesh))
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in rows)
        htod_us = sum(e.self_device_time_total for e in rows
                      if "HtoD" in e.key)
        top = sorted(rows, key=lambda e: -e.self_device_time_total)
        if args.table_dir:
            Path(args.table_dir, f"profile_{name}.txt").write_text(
                prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
        print(json.dumps({
            "path": name, "sf": args.sf, "card": smi,
            "wall_s": {"cold": walls[0], "warm": walls[1],
                       "warm_profiled": walls[2]},
            "device_busy_ms": busy_us / 1e3,
            "busy_share_of_profiled_wall": busy_us / 1e6 / walls[-1],
            "htod_ms": htod_us / 1e3,
            "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top[:args.top]],
        }), flush=True)


if __name__ == "__main__":
    main()
