"""The one generator of the benchmark's traffic.

A mix (``portbench/mixes/<traffic>.json``) is data: the queries of one
stream. ``stream`` turns a mix, a seed and a scale factor into the
stream's queries in an order drawn from the seed, each with the
substitution parameters that ``plans/substitution.json`` draws for it. The traffic is a closed loop of one client: the window
repeats the same stream, as TPC-H's power test runs one stream after
another, so every seed gives the same queries and the same work, in
another order and with other parameters within the spec's ranges.
"""

from __future__ import annotations

import datetime
import itertools
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
SUBSTITUTION = HERE / "plans" / "substitution.json"


def _values(spec, lists) -> list:
    v = spec["choice"]
    if isinstance(v, str):
        v = lists[v]
    if isinstance(v, dict):
        v = [" ".join(p) for p in itertools.product(*v["product"])]
    return list(v)


def draw_params(query: str, rng: np.random.Generator, sf: float,
                table: Dict) -> Dict:
    """One query's substitution parameters, drawn in the order the
    data file lists them."""
    out: Dict = {}
    for name, spec in table.get(query, {}).items():
        if "lookup" in spec:
            out[name] = table["maps"][spec["map"]][out[spec["lookup"]]]
        elif "distinct_from" in spec:
            pool = [v for v in _values(spec, table["lists"])
                    if v != out[spec["distinct_from"]]]
            out[name] = pool[int(rng.integers(len(pool)))]
        elif "choice" in spec:
            pool = _values(spec, table["lists"])
            out[name] = pool[int(rng.integers(len(pool)))]
        elif "int" in spec:
            lo, hi = spec["int"]
            out[name] = int(rng.integers(lo, hi + 1))
        elif "scaled" in spec:
            lo, hi, scale = spec["scaled"]
            out[name] = round(int(rng.integers(lo, hi + 1)) * scale, 10)
        elif "date" in spec:
            first, last = (datetime.date.fromisoformat(d)
                           for d in spec["date"])
            days = int(rng.integers((last - first).days + 1))
            out[name] = (first + datetime.timedelta(days=days)).isoformat()
        elif "per_sf" in spec:
            out[name] = spec["per_sf"] / sf
        else:
            raise ValueError(f"{query}.{name}: unknown kind {spec}")
    return out


def stream(mix: Dict, seed: int, sf: float) -> List[Tuple[str, Dict]]:
    """The stream of ``mix`` for ``seed``: [(query name, parameters)]."""
    table = json.loads(SUBSTITUTION.read_text())
    rng = np.random.default_rng(seed % (1 << 64))
    queries = [mix["queries"][i]
               for i in rng.permutation(len(mix["queries"]))]
    return [(q, draw_params(q, rng, sf, table)) for q in queries]
