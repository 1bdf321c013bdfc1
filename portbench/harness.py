"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic in ``mixes/<traffic>.json``, and each per-layer metric in
``metrics/<name>.py`` (a ``read(reading)`` function that returns the
value or None). Adding a cell, a configuration or a metric adds files.

The program is driven through its public entry alone:
``Task(plan, QueryCtx(device)).run()``, one query at a time.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# each query's ORDER BY, which the comparison holds the answer's rows to
ORDER_BY = json.loads((HERE / "plans" / "order_by.json").read_text())


def load_cell(workload: str, root: Path = ROOT
              ) -> Tuple[Dict, Dict, Dict, Dict]:
    """(BENCHMARK.json, the cell, its configuration, its mix) of the
    checkout at ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes"
                      / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def cell_metrics(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics this cell reports: its end-to-end metrics, or with a
    trace its per-layer metrics."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def reported(m):
        return (name in m["workloads"]) if "workloads" in m \
            else m["moves"] in moved

    return [m for m in bench["per_layer"] if reported(m)]


@dataclass
class Answer:
    query: int  # index into the stream
    seconds: float
    table: object = None
    error: str = ""


@dataclass
class Reading:
    """What a per-layer reader reads: the device window's trace (busy
    time, idle stretches, launches), the layer window's (each device
    operation's layer), the program's counters over the device window,
    the queries it completed, and the host-clock seconds that the same
    streams took unprofiled just before (``plain_s``)."""
    device: object
    layers: object
    counters: Dict[str, float]
    queries: int
    plain_s: float


def _counters() -> Dict[str, float]:
    from velox_tpu_torch.common import metrics as M
    return dict(M.reporter().snapshot()["counters"])


class Run:
    def __init__(self, cell: Dict, cfg: Dict, mix: Dict, seed: int,
                 device: str):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.device = seed, device
        self.cuda = device.startswith("cuda")
        self.cold: List[float] = []
        self._tables: Dict = {}

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        """Register the data, build the stream's plans, and run each
        query once: the scan cache fills, the allocator warms and every
        kernel the stream launches is built."""
        self.t_setup = time.time()
        import torch

        from portbench import datasets, traffic
        from portbench.plans.tpch import PLANS
        from velox_tpu_torch.common.flags import set_flag
        t0 = time.perf_counter()
        if self.cfg.get("scan_cache_bytes"):
            set_flag("scan_cache_bytes", int(self.cfg["scan_cache_bytes"]))
        if self.cuda:
            from velox_tpu_torch.native.build import load_kernels
            load_kernels()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        cid = datasets.register(self.cfg)
        self.phases = {"kernels": t1 - t0,
                       "data": time.perf_counter() - t1}
        self.stream = traffic.stream(self.mix, self.seed,
                                     self.cfg["scale_factor"])
        self.plans = [PLANS[q](cid, **params) for q, params in self.stream]
        for i in range(len(self.plans)):
            self.cold.append(self.query(i).seconds)
        # what set-up made lives on: keep the collector's full passes from
        # walking it again inside the window
        gc.collect()
        gc.freeze()

    def query(self, i: int) -> Answer:
        import torch

        from velox_tpu_torch.exec.task import QueryCtx, Task
        t0 = time.perf_counter()
        try:
            table = Task(self.plans[i], QueryCtx(self.device)).run()
            if self.cuda:
                torch.cuda.synchronize()
        except Exception as e:  # a failed query is counted, not fatal
            if self.cuda:
                torch.cuda.synchronize()
            return Answer(i, time.perf_counter() - t0,
                          error=f"{type(e).__name__}: {e}")
        return Answer(i, time.perf_counter() - t0, table)

    # -- windows ------------------------------------------------------------

    def streams(self, n: int, marks: bool = False) -> List[Answer]:
        """``n`` whole streams, one after another; with ``marks`` each
        query marked on the device's timeline, or without a card inside
        a profiler range named after it."""
        from torch.profiler import record_function

        from portbench import profile as P
        out = []
        for _ in range(n):
            for i, (q, _) in enumerate(self.stream):
                if not marks:
                    out.append(self.query(i))
                    continue
                P.mark(self.cuda)
                with record_function(P.QUERY + q):
                    out.append(self.query(i))
        return out

    def window(self, seconds: float) -> Tuple[List[Answer], float, int]:
        """Whole streams until ``seconds`` have passed: (every answer, the
        window's seconds, the streams)."""
        answers: List[Answer] = []
        t0 = time.perf_counter()
        while True:
            answers += self.streams(1)
            if time.perf_counter() - t0 >= seconds:
                return (answers, time.perf_counter() - t0,
                        len(answers) // len(self.plans))

    def traced_window(self, seconds: float):
        """Whole streams until ``seconds`` have passed, then the same
        number of streams under the profiler's CUDA activity alone (the
        device window), then under its CPU and CUDA activities and
        ``stack_ranges`` (the layer window): (every answer, Reading)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import profile as P
        cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
        answers, plain_s, n = self.window(seconds)
        traces, walls = [], [plain_s]
        for stacks in (False, True):
            acts = [cpu, cuda] if self.cuda and stacks else \
                [cuda] if self.cuda else [cpu]
            before = _counters()
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                with record_function(P.WINDOW):
                    if stacks:
                        with P.stack_ranges():
                            got = self.streams(n)
                    else:
                        P.mark(self.cuda)
                        got = self.streams(n, marks=True)
                        if self.cuda:
                            torch.cuda.synchronize()
                        P.mark(self.cuda)
                    if self.cuda:
                        torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if not stacks:
                after = _counters()
                counters = {k: after.get(k, 0) - before.get(k, 0)
                            for k in set(after) | set(before)}
                queries = len(got)
            answers += got
            t0 = time.perf_counter()
            traces.append(P.from_profiler(
                prof.profiler.kineto_results,
                [self.stream[a.query][0] for a in got]))
            print(f"portbench: the trace took "
                  f"{time.perf_counter() - t0:.3f} s to read",
                  file=sys.stderr)
        print(f"portbench: {n} stream(s): {walls[0]:.3f} s unprofiled; "
              f"the device window {traces[0].window_s:.3f} s between its "
              f"ends ({walls[1]:.3f} s with the profiler's start and "
              f"stop), the layer window {traces[1].window_s:.3f} s "
              f"({walls[2]:.3f} s)", file=sys.stderr)
        return answers, Reading(traces[0], traces[1], counters, queries,
                                plain_s)

    # -- the check ----------------------------------------------------------

    def reference(self, arith=None):
        """The plain reference's tables, generated once a run."""
        from portbench.reference import oracles, tpchgen
        arith = arith or oracles.EXACT
        if arith not in self._tables:
            t = oracles.Tables(tpchgen.TpchGen(self.cfg["scale_factor"]),
                               arith)
            for other in self._tables.values():  # the same generated columns
                t._cols, t._lock = other._cols, other._lock
            self._tables[arith] = t
        return self._tables[arith]

    def answers(self, queries, arith=None) -> Dict[int, tuple]:
        """The plain reference's answers to the stream's queries (by
        index), worked out on the host's cores at once."""
        from concurrent.futures import ThreadPoolExecutor

        from portbench.reference import oracles
        tables = self.reference(arith)

        def answer(i):
            q, params = self.stream[i]
            return oracles.ANSWERS[q](tables, **params)

        queries = sorted(set(queries))
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
            return dict(zip(queries, pool.map(answer, queries)))

    def check(self, answers: List[Answer]) -> Dict:
        """Every answer of the window against the plain reference's
        answer to the same query: (rows that differ, widest DOUBLE gap)
        over all of them."""
        from portbench.reference import compare
        want = self.answers(a.query for a in answers)
        bad, gaps = 0, []
        for a in answers:
            q = self.stream[a.query][0]
            if a.table is None:
                bad += 1
                continue
            b, w = compare.gaps(compare.rows_of(a.table), want[a.query],
                                ORDER_BY[q])
            if b:
                print(f"portbench: {q} ({self.stream[a.query][1]}): {b} of "
                      f"{len(want[a.query][1])} rows differ", file=sys.stderr)
            bad += b
            gaps += [] if w is None else [w]
        # a window whose answers hold no DOUBLE value has no DOUBLE gap
        return {"mismatched_rows": bad,
                **({"double_rel_gap": max(gaps)} if gaps else {})}


def cache_stats() -> Dict:
    from velox_tpu_torch.connectors.cache import DataCache
    return DataCache.instance().stats()


def torch_peak() -> int:
    import torch
    return int(torch.cuda.max_memory_allocated()) \
        if torch.cuda.is_available() else 0


def device_info(cuda: bool, count: int) -> Dict:
    import torch
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(count)))}


def read_metric(name: str, reading: Reading,
                root: Path = ROOT) -> Optional[float]:
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(reading)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, root: Path = ROOT) -> Dict:
    """One run: the result line's object."""
    bench, cell, cfg, mix = load_cell(workload, root)
    run = Run(cell, cfg, mix, seed, device)
    run.setup()
    setup_s = time.time() - t_start
    cache = cache_stats()
    print(f"portbench: set-up {setup_s:.3f} s (imports "
          f"{run.t_setup - t_start:.3f}, kernels {run.phases['kernels']:.3f},"
          f" data {run.phases['data']:.3f}); scan cache {cache}; "
          f"peak {torch_peak()} bytes; cold walls "
          + " ".join(f"{q}={s:.3f}" for (q, _), s in
                     zip(run.stream, run.cold)), file=sys.stderr)
    metrics: Dict[str, Dict] = {}
    if trace:
        answers, reading = run.traced_window(
            min(seconds, mix.get("trace_seconds", seconds)))
    else:
        answers, window_s, _ = run.window(seconds)
    dev = device_info(run.cuda, cell["chips"])
    want = {m["name"]: m for m in cell_metrics(bench, cell, trace)}
    ok = [a for a in answers if a.table is not None]
    if trace:
        dev["busy_s"] = reading.device.busy_s()
        dev["window_s"] = reading.device.window_s
        for name in want:
            value = read_metric(name, reading, root)
            if value is not None:
                metrics[name] = {"value": value, "unit": want[name]["unit"]}
    else:
        ms = [a.seconds * 1e3 for a in ok]
        from portbench import stats
        values = {"queries_per_s": len(ok) / window_s,
                  "geomean_ms": stats.geomean(ms) if ms else math.inf,
                  "query_p95_ms": stats.p95(ms) if ms else math.inf,
                  "setup_s": setup_s}
        for name, m in want.items():
            metrics[name] = {"value": values[name], "unit": m["unit"]}
    per_query: Dict[str, List[float]] = {}
    for a in answers:
        per_query.setdefault(run.stream[a.query][0], []).append(a.seconds)
    print("portbench: window walls " + " ".join(
        f"{q}={min(v):.4f}..{max(v):.4f}x{len(v)}"
        for q, v in per_query.items()), file=sys.stderr)
    for a in answers:
        if a.error:
            print(f"portbench: {run.stream[a.query][0]} failed: {a.error}",
                  file=sys.stderr)
    t_check = time.time()
    numbers = run.check(answers)
    print(f"portbench: the check took {time.time() - t_check:.3f} s",
          file=sys.stderr)
    lim = cfg["correct_limits"]
    check = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    correct = all(numbers[k] <= lim[k] for k in numbers) and len(ok) == len(
        answers)
    out = {"correct": correct, "attempted": len(answers),
           "failed": len(answers) - len(ok), "metrics": metrics,
           "device": dev}
    if trace:
        from portbench import profile as P
        out["breakdown"] = P.breakdown(reading.device)
    out["check"] = check
    return out
