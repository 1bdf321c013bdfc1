#!/usr/bin/env python3
"""Smoke run of velox_tpu_torch on one CUDA card.

Usage: python3 chip_smoke.py [--sf N]   (default SF 10: 60M lineitem rows)

Phases, each printing one line; any failure raises and exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels (velox_tpu_torch/csrc) and the native
   TPC-H generator from the sources in this checkout.
3. kernel: the filter-sum kernel against its plain PyTorch version on the
   card, exact equality over many shapes; median times at 6.7M and 60M
   rows, in the Q6 shape and in a shape where every row loads every column
   (the one whose bytes are known, for the bandwidth figure).
4. q6: TPC-H Q6 through Task.batches() twice, through the kernel (its
   launch count is reset just before and read just after); the result
   must equal a numpy oracle over the same generated columns exactly.
5. heads: the scan+filter+project heads of Q6 and Q1 without their
   aggregations; active-row counts and column sums, reduced on the card,
   must equal numpy exactly.

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.native import build
from velox_tpu_torch.ops.filter_reduce import (
    MAX_COLS, filtered_sum_product, filtered_sum_product_reference,
)
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan

D94, D95, D980902 = 8766, 9131, 10471  # days since 1970-01-01
Q6_FILTER = ("l_shipdate >= date '1994-01-01' and "
             "l_shipdate < date '1995-01-01' and "
             "l_discount between 0.05 and 0.07 and "
             "l_quantity < 24.0")
Q6_COLS = ["l_shipdate", "l_extendedprice", "l_quantity", "l_discount"]
Q1_COLS = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
           "l_discount", "l_tax", "l_shipdate"]
Q1_PROJECT = [
    "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
    "l_extendedprice * (1.0 - l_discount) as l_sum_disc_price",
    "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax) as l_sum_charge",
    "l_discount"]


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def time_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: CUDA events around `calls` back-to-back
    calls, divided by `calls`; the median of `reps` such windows, after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    return smi


def build_phase() -> None:
    build.load_kernels()
    if build.load_dbgen() is None:
        raise RuntimeError("no C++ compiler: the native TPC-H generator "
                           "did not build")
    phase("build", seconds=dict(build.BUILD_SECONDS))


def _case(rng, n: int, k: int, n_active: int, empty: bool):
    """k random int32 columns (negative values included), up to 3
    ranges, and the (a, b) product columns."""
    cols = [torch.from_numpy(rng.integers(-50_000, 50_000, n,
                                          dtype=np.int32)).cuda()
            for _ in range(k)]
    ranges = []
    for i in range(min(k, 3)):
        lo = int(rng.integers(-40_000, 0))
        ranges.append((i, lo, lo + int(rng.integers(0, 80_000))))
    if empty:
        ranges.append((0, 10, -10))  # lo > hi keeps nothing
    return cols, tuple(ranges), k - 1, 0, n_active


def kernel_phase(rng) -> dict:
    cases = 0
    max_err = 0
    for n in (1, 1000, 131089, 6_700_000, 60_000_000):
        for n_active in sorted({0, max(0, n - 17), n}):
            for k in ((1, 4, MAX_COLS) if n <= 131089 else (4,)):
                for empty in (False, True):
                    cols, ranges, ai, bi, na = _case(rng, n, k, n_active,
                                                     empty)
                    got = filtered_sum_product(cols, ranges, ai, bi, na)
                    ref = filtered_sum_product_reference(cols, ranges, ai,
                                                         bi, na)
                    torch.cuda.synchronize()
                    err = abs(int(got.item()) - int(ref.item()))
                    max_err = max(max_err, err)
                    if err or (empty and int(got.item()) != 0):
                        raise AssertionError(
                            f"kernel {got.item()} != plain {ref.item()} at "
                            f"n={n} k={k} n_active={na} ranges={ranges}")
                    cases += 1
    timings = {}
    for n in (6_700_000, 60_000_000):
        # the Q6 shape: 4 columns, 3 ranges, `a` outside every range (so it
        # is loaded only for rows that pass), n_active on the device
        cols, ranges, ai, bi, _ = _case(rng, n, 4, n, False)
        na = torch.tensor(n - 17, dtype=torch.int32, device="cuda")
        # every column a range that keeps every row: each row loads all
        # 4 columns, 16 bytes, the count the bandwidth figure divides by
        full = tuple((i, -50_000, 50_000) for i in range(4))
        got = filtered_sum_product(cols, full, ai, bi, na)
        ref = filtered_sum_product_reference(cols, full, ai, bi, na)
        if int(got.item()) != int(ref.item()):
            raise AssertionError(f"kernel {got.item()} != plain {ref.item()}"
                                 f" at n={n} with every column a range")
        t = {
            "ms": time_ms(lambda: filtered_sum_product(cols, ranges, ai, bi,
                                                       na)),
            "plain_ms": time_ms(lambda: filtered_sum_product_reference(
                cols, ranges, ai, bi, na)),
            "all_read_ms": time_ms(lambda: filtered_sum_product(
                cols, full, ai, bi, na)),
            # the output memset each call launches, timed alone
            "zeros_ms": time_ms(lambda: torch.zeros(
                (), dtype=torch.int64, device="cuda")),
        }
        t["all_read_bytes_per_s"] = 16 * (n - 17) / (t["all_read_ms"] / 1e3)
        timings[n] = t
        del cols
    phase("kernel", cases=cases, max_abs_err=max_err,
          times={str(n): t for n, t in timings.items()})
    return {"max_abs_err": max_err, "timings": timings}


def q6_oracle(gen) -> int:
    n_orders = gen.num_rows("orders")
    li = gen.gen_lineitem(0, n_orders, Q6_COLS)
    m = ((li["l_shipdate"] >= D94) & (li["l_shipdate"] < D95)
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 2400))
    return int((li["l_extendedprice"][m].astype(np.int64)
                * li["l_discount"][m].astype(np.int64)).sum())


def q6_phase(conn, ctx) -> int:
    rows = conn.gen.num_rows("lineitem")
    n_splits = len(conn.default_splits("lineitem"))
    expect = q6_oracle(conn.gen)
    plan = tpch_plan(6)
    counter = M.K_FILTER_SUM_KERNEL
    fired0 = M.reporter().snapshot()["counters"].get(counter, 0)
    walls, values = [], []
    filtered_sum_product.launches = 0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task = Task(plan, ctx)
        out = list(task.batches())
        task.check_errors()
        col = out[0].columns["revenue"]
        values.append(int(col.data[0].item()))
        hi = int(col.children[0].data[0].item())
        walls.append(time.perf_counter() - t0)
        if hi != (-1 if values[-1] < 0 else 0):
            raise AssertionError(f"Q6 high limb {hi} for {values[-1]}")
    launches = filtered_sum_product.launches
    fired = M.reporter().snapshot()["counters"].get(counter, 0) - fired0
    if fired != 2:
        raise AssertionError(f"K_FILTER_SUM_KERNEL fired {fired} times, "
                             "expected once per run")
    if launches != 2 * n_splits:
        raise AssertionError(f"{launches} kernel launches in two runs over "
                             f"{n_splits} lineitem splits")
    if values != [expect, expect]:
        raise AssertionError(f"Q6 {values} != numpy oracle {expect}")
    phase("q6", sf=conn.scale_factor, lineitem_rows=rows, splits=n_splits,
          revenue_scaled_e4=expect, launches=launches, wall_s=walls,
          rows_per_s=[rows / w for w in walls])
    return launches


def _head_sums(plan, ctx):
    """Active-row count and per-column sums of a plan's batches, reduced
    on the card, plus the wall of the run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task = Task(plan, ctx)
    count = torch.zeros((), dtype=torch.int64, device=ctx.device)
    sums = {}
    for b in task.batches():
        count += b.mask.sum()
        for name, c in b.columns.items():
            s = torch.where(b.mask, c.data.long(), 0).sum()
            sums[name] = s if name not in sums else sums[name] + s
    task.check_errors()
    out = {k: int(v.item()) for k, v in sums.items()}
    return int(count.item()), out, time.perf_counter() - t0


def heads_phase(conn, ctx) -> None:
    n_orders = conn.gen.num_rows("orders")
    li = {k: v.astype(np.int64) for k, v in conn.gen.gen_lineitem(
        0, n_orders, sorted(set(Q1_COLS + Q6_COLS))).items()}

    q6 = (PlanBuilder().table_scan("lineitem", Q6_COLS, filter=Q6_FILTER)
          .project(["l_extendedprice * l_discount as revenue"]).plan())
    m6 = ((li["l_shipdate"] >= D94) & (li["l_shipdate"] < D95)
          & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
          & (li["l_quantity"] < 2400))
    want6 = {"revenue": (li["l_extendedprice"] * li["l_discount"])[m6].sum()}

    q1 = (PlanBuilder().table_scan("lineitem", Q1_COLS,
                                   filter="l_shipdate <= date '1998-09-02'")
          .project(Q1_PROJECT).plan())
    m1 = li["l_shipdate"] <= D980902
    disc = li["l_extendedprice"] * (100 - li["l_discount"])
    cols1 = {c: li[c] for c in ("l_returnflag", "l_linestatus", "l_quantity",
                                "l_extendedprice", "l_discount")}
    cols1["l_sum_disc_price"] = disc
    cols1["l_sum_charge"] = disc * (100 + li["l_tax"])
    want1 = {k: v[m1].sum() for k, v in cols1.items()}

    for name, plan, mask, want in (("q6_head", q6, m6, want6),
                                   ("q1_head", q1, m1, want1)):
        count, got, wall = _head_sums(plan, ctx)
        want = {k: int(v) for k, v in want.items()}
        if count != int(mask.sum()) or got != want:
            raise AssertionError(f"{name}: rows {count} vs {int(mask.sum())}"
                                 f", sums {got} vs {want}")
        phase(name, active_rows=count, columns=sorted(got), wall_s=wall)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    device_phase()
    build_phase()
    kernel = kernel_phase(np.random.default_rng(args.seed))
    conn = register_tpch(args.sf)
    ctx = QueryCtx(device="cuda")
    launches = q6_phase(conn, ctx)
    heads_phase(conn, ctx)

    main_shape = kernel["timings"][6_700_000]
    print(json.dumps({"kernels": [{
        "name": "filter_sum",
        "route": "cuda",
        "source": "velox_tpu_torch/csrc/filter_sum.cu",
        "replaces": "velox_tpu/ops/filter_reduce.py:45",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "rows": 6_700_000,
        "ms_60m_rows": kernel["timings"][60_000_000]["ms"],
        "plain_ms_60m_rows": kernel["timings"][60_000_000]["plain_ms"],
        "all_read_ms_60m_rows": kernel["timings"][60_000_000]["all_read_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
