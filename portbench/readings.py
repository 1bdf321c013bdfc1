"""The readings that the limits of ``correct`` are set from.

    python portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3

One set-up for many seeds (the cell's set-up is most of a run): for each
seed, the stream that the seed draws runs once through the program on
the card, warm, and every answer is compared with the plain reference's,
as a run's check does (the lower readings). For each control seed, the
reference computed in float32 (``oracles.FLOAT32``) is put in the
program's place and compared the same way (the upper readings). One JSON
line a seed; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from portbench import harness, traffic
    from portbench.plans.tpch import PLANS
    from portbench.reference import compare, oracles
    _, cell, cfg, mix = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    run = harness.Run(cell, cfg, mix, (seeds or controls)[0], args.device)
    t0 = time.time()
    run.setup()
    print(json.dumps({"setup_s": time.time() - t0}), flush=True)
    cid = "hive" if cfg["connector"] == "hive_parquet" else "tpch"
    for seed in sorted(set(seeds) | set(controls)):
        run.stream = traffic.stream(mix, seed, cfg["scale_factor"])
        line = {"seed": seed}
        if seed in seeds:
            run.plans = [PLANS[q](cid, **p) for q, p in run.stream]
            answers = [run.query(i) for i in range(len(run.plans))]
            t = time.time()
            line["program"] = run.check(answers)
            line["program"]["failed"] = sum(a.table is None
                                            for a in answers)
            line["check_s"] = time.time() - t
        if seed in controls:
            every = range(len(run.stream))
            exact = run.answers(every)
            low = run.answers(every, oracles.FLOAT32)
            per = {q: compare.gaps(low[i], exact[i], harness.ORDER_BY[q])
                   for i, (q, _) in enumerate(run.stream)}
            line["control"] = {
                "mismatched_rows": sum(b for b, _ in per.values()),
                "double_rel_gap": max((w for _, w in per.values()
                                       if w is not None), default=None),
                "per_query": per}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
