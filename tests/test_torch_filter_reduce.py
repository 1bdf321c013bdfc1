"""Filter-sum kernel of the torch port against the JAX reference.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs as its own tests run it (``interpret=True`` -> ``_xla_reference``).
Every comparison is exact: the result is an int64 sum of int32 products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu.connectors.tpch import register_tpch as jax_register_tpch
from velox_tpu.exec.fuse import collapse_chain as jax_collapse_chain
from velox_tpu.ops import filter_reduce as jfr
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch.exec.fuse import collapse_chain
from velox_tpu_torch.ops import filter_reduce as tfr
from velox_tpu_torch.tpch import tpch_plan

torch.set_num_threads(1)


def _inputs(seed: int, n: int, k: int = 4):
    """k int32 columns: column 0 is `a` (negative values included), the
    last is `b`, bounded by the reference's MAX_B_ABS so its int32 lane
    sums stay exact; three ranges over the first columns."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-(2 ** 31), 2 ** 31 - 1, n, dtype=np.int32)]
    cols += [rng.integers(-1000, 1000, n, dtype=np.int32)
             for _ in range(k - 2)]
    cols.append(rng.integers(-jfr.MAX_B_ABS, jfr.MAX_B_ABS + 1, n,
                             dtype=np.int32))
    ranges = ((1, -500, 400), (2, -900, 0), (k - 1, -20, 31))
    return cols, ranges, 0, k - 1


@pytest.mark.parametrize("n", [1000, 131072, 200000])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("active", ["zero", "minus17", "all"])
def test_plain_version_matches_jax(n, seed, active):
    cols, ranges, ai, bi = _inputs(seed, n)
    n_active = {"zero": 0, "minus17": n - 17, "all": n}[active]
    want = jfr.filtered_sum_product([jnp.asarray(c) for c in cols], ranges,
                                    ai, bi, n_active, interpret=True)
    launches = tfr.filtered_sum_product.launches
    got = tfr.filtered_sum_product([torch.from_numpy(c) for c in cols],
                                   ranges, ai, bi,
                                   torch.tensor(n_active, dtype=torch.int32))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(want)
    # the CPU runs the plain version: no kernel launch is counted
    assert tfr.filtered_sum_product.launches == launches


def test_range_that_keeps_nothing_sums_to_zero():
    cols, _, ai, bi = _inputs(3, 5000)
    got = tfr.filtered_sum_product([torch.from_numpy(c) for c in cols],
                                   ((1, 10, -10),), ai, bi, 5000)
    assert int(got) == 0


def test_plain_version_is_exact_beyond_the_tpu_bound():
    """Hopper accumulates in int64, so the plain version (and the kernel
    it stands for) is exact for any int32 b, not only |b| <= MAX_B_ABS."""
    rng = np.random.default_rng(7)
    a = rng.integers(-(2 ** 31), 2 ** 31 - 1, 4096, dtype=np.int32)
    b = rng.integers(-(2 ** 31), 2 ** 31 - 1, 4096, dtype=np.int32)
    want = sum(int(x) * int(y) for x, y in zip(a, b))
    want = (want + 2 ** 63) % 2 ** 64 - 2 ** 63  # int64 wraparound
    got = tfr.filtered_sum_product_reference(
        [torch.from_numpy(a), torch.from_numpy(b)], (), 0, 1, 4096)
    assert int(got) == want


@pytest.mark.parametrize("bad", ["int64", "length", "too_many_cols",
                                 "too_many_ranges", "index", "2d"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    c = torch.zeros(1024, dtype=torch.int32)
    cols, ranges, ai, bi = [c, c.clone()], ((0, 0, 1),), 0, 1
    if bad == "int64":
        cols = [c.long(), c.long()]
    elif bad == "length":
        cols = [c, c[:512].clone()]
    elif bad == "too_many_cols":
        cols = [c.clone() for _ in range(tfr.MAX_COLS + 1)]
    elif bad == "too_many_ranges":
        ranges = ((0, 0, 1),) * (tfr.MAX_RANGES + 1)
    elif bad == "index":
        ai = 5
    elif bad == "2d":
        cols = [c.reshape(32, 32), c.reshape(32, 32)]
    with pytest.raises(ValueError):
        tfr.filtered_sum_product(cols, ranges, ai, bi, 1024)


def _spec_key(spec):
    return (spec.scan_cols, spec.ranges, spec.a_col, spec.b_col,
            spec.out_name, str(spec.out_dtype))


def _stats(conn, scan):
    out = {}
    for c in scan.output_type().names:
        s = conn.column_stats(scan.table, c)
        if s is not None:
            out[c] = s
    return out


def test_match_filter_sum_gives_equal_specs_on_q6():
    jconn, tconn = jax_register_tpch(0.01), register_tpch(0.01)
    jplan, tplan = jax_tpch_plan(6), tpch_plan(6)
    jchain, tchain = (jax_collapse_chain(jplan.source),
                      collapse_chain(tplan.source))
    jspec = jfr.match_filter_sum(jplan, jchain,
                                 _stats(jconn, jchain.source))
    tspec = tfr.match_filter_sum(tplan, tchain,
                                 _stats(tconn, tchain.source))
    assert jspec is not None and tspec is not None
    assert _spec_key(tspec) == _spec_key(jspec)
    assert tfr.MAX_B_ABS == jfr.MAX_B_ABS


def test_stats_above_the_bound_match_nothing_in_both():
    jplan, tplan = jax_tpch_plan(6), tpch_plan(6)
    jchain, tchain = (jax_collapse_chain(jplan.source),
                      collapse_chain(tplan.source))
    big = {"l_discount": (0, jfr.MAX_B_ABS + 1),
           "l_extendedprice": (0, 10 ** 7)}
    assert jfr.match_filter_sum(jplan, jchain, big) is None
    assert tfr.match_filter_sum(tplan, tchain, big) is None
    assert tfr.match_filter_sum(tplan, tchain, None) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_running_total_equals_the_sum_of_per_batch_results(seed):
    """``out=`` adds each call's sum into one int64 total in place, as
    FilterSumOperator carries it across a query's batches."""
    total = torch.zeros((), dtype=torch.int64)
    want = 0
    for i in range(4):
        cols, ranges, ai, bi = _inputs(seed * 10 + i, 3000 + 517 * i)
        cols = [torch.from_numpy(c) for c in cols]
        n_active = torch.tensor(2900 + i, dtype=torch.int32)
        got = tfr.filtered_sum_product(cols, ranges, ai, bi, n_active,
                                       out=total)
        assert got is total
        want += int(tfr.filtered_sum_product(cols, ranges, ai, bi,
                                             n_active))
        assert int(total) == want


@pytest.mark.parametrize("bad", ["int32", "shape", "device"])
def test_running_total_must_be_one_int64_on_the_columns_device(bad):
    cols, ranges, ai, bi = _inputs(4, 1000)
    out = {"int32": torch.zeros((), dtype=torch.int32),
           "shape": torch.zeros((1,), dtype=torch.int64),
           "device": torch.zeros((), dtype=torch.int64, device="meta")}[bad]
    with pytest.raises(ValueError, match="out must be"):
        tfr.filtered_sum_product([torch.from_numpy(c) for c in cols],
                                 ranges, ai, bi, 1000, out=out)


def _matcher_specs():
    """The specs the matcher emits on this file's plans: Q6, and Q6 with
    its bounds moved so one range column, l_extendedprice, is also the
    product's `a` and l_discount is left without a range."""
    conn = register_tpch(0.01)
    plan = tpch_plan(6)
    chain = collapse_chain(plan.source)
    stats = _stats(conn, chain.source)
    specs = [tfr.match_filter_sum(plan, chain, stats)]
    from velox_tpu_torch.testing.plan_builder import PlanBuilder
    other = (PlanBuilder().table_scan(
        "lineitem", ["l_shipdate", "l_extendedprice", "l_quantity",
                     "l_discount"],
        filter="l_extendedprice between 1000.0 and 50000.0 and "
               "l_quantity < 24.0")
        .project(["l_extendedprice * l_discount as revenue"])
        .single_aggregation([], ["sum(revenue) as revenue"]).plan())
    chain = collapse_chain(other.source)
    specs.append(tfr.match_filter_sum(other, chain, stats))
    assert all(s is not None for s in specs)
    return specs


def test_every_matched_layout_has_a_kernel_instance():
    """The host-side layout, without a card: each spec the matcher emits
    maps onto csrc/filter_sum.cu's instance table (at most ``MAX_COLS``
    argument slots, at most two product columns outside every range),
    every distinct column once, the range columns first."""
    for spec in _matcher_specs():
        idx = {c: i for i, c in enumerate(spec.scan_cols)}
        layout = tfr.kernel_layout(spec.ranges, idx[spec.a_col],
                                   idx[spec.b_col])
        assert 1 <= len(layout.order) <= tfr.MAX_COLS
        assert sum(layout.instance) == len(layout.order)
        assert layout.n_product <= 2
        assert len(set(layout.order)) == len(layout.order)
        assert set(layout.order) == ({r[0] for r in spec.ranges}
                                     | {idx[spec.a_col], idx[spec.b_col]})
        assert layout.order[:layout.n_ranges] == tuple(
            sorted(r[0] for r in spec.ranges))
    # Q6: three range columns, the product's `a` outside every range
    q6 = _matcher_specs()[0]
    idx = {c: i for i, c in enumerate(q6.scan_cols)}
    assert tfr.kernel_layout(q6.ranges, idx[q6.a_col],
                             idx[q6.b_col]).instance == (3, 1)


@pytest.mark.parametrize("seed", range(6))
def test_kernel_layout_keeps_the_sum(seed):
    """The layout the kernel runs (ranges on one column intersected and
    clamped to int32, columns reordered, range columns first) gives the
    plain version's value on random calls within the kernel's limits,
    empty ranges and bounds past int32 included."""
    rng = np.random.default_rng(100 + seed)
    k = int(rng.integers(1, tfr.MAX_COLS + 1))
    n = 2000
    cols = [torch.from_numpy(rng.integers(-1000, 1000, n, dtype=np.int32))
            for _ in range(k)]
    ranges = []
    for _ in range(int(rng.integers(0, tfr.MAX_RANGES + 1))):
        lo = int(rng.integers(-(2 ** 33), 900))
        ranges.append((int(rng.integers(0, k)), lo,
                       lo + int(rng.integers(-(2 ** 31), 2 ** 34))))
    ai, bi = int(rng.integers(0, k)), int(rng.integers(0, k))
    layout = tfr.kernel_layout(ranges, ai, bi)
    assert sum(layout.instance) == len(layout.order) <= tfr.MAX_COLS
    assert all(-(2 ** 31) <= b <= 2 ** 31 - 1 for pair in layout.bounds
               for b in pair)
    slots = [cols[i] for i in layout.order]
    as_run = tfr.filtered_sum_product_reference(
        slots, [(r, lo, hi) for r, (lo, hi) in enumerate(layout.bounds)],
        layout.a, layout.b, n - 3)
    want = tfr.filtered_sum_product_reference(cols, ranges, ai, bi, n - 3)
    assert int(as_run) == int(want)
