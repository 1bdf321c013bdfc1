"""Sort-key encoding and the radix sort of the torch port against the JAX
reference (exec/sort.py), exactly.

The same numpy-seeded key columns go through both packages. Words, bit
widths, key layouts, packed lanes and decoded keys must be equal bit for
bit; the permutations must be identical: the reference sorts keys of up
to four lanes with ``lax.sort`` and wider ones with its counting radix
sort, the port always with its radix sort (whose passes run the plain
versions of kernels B2, B3 and B4 here), and a stable sort permutation is
unique.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu import types as JT
from velox_tpu.core.plan import SortOrder as JSortOrder
from velox_tpu.exec import sort as JS
from velox_tpu.expression.eval import EvalValue as JEvalValue
from velox_tpu.vector.device import Dictionary as JDictionary
from velox_tpu_torch import types as T
from velox_tpu_torch.core.plan import SortOrder
from velox_tpu_torch.exec import sort as S
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.ops import radix as R
from velox_tpu_torch.vector.device import Dictionary

torch.set_num_threads(1)

CAP = 2048
N_ACTIVE = 1900
WORDS = ["cherry", "apple", "fig", "banana", "date", "elder", "grape"]

# (type, generator, nullable, order, stats range); the range narrows the
# key as connector stats do (None: full-width words)
KEYS = {
    "int32": ("integer", lambda r: r.integers(-50, 50, CAP), False, "asc",
              None),
    "int32_narrow": ("integer", lambda r: r.integers(-50, 50, CAP), False,
                     "asc", (-50, 49)),
    "int64": ("bigint", lambda r: r.integers(-2 ** 40, 2 ** 40, CAP), False,
              "asc", None),
    "int64_desc_nulls": ("bigint", lambda r: r.integers(-9, 9, CAP), True,
                         "desc_nulls_first", None),
    "date": ("date", lambda r: r.integers(8035, 10592, CAP), False, "asc",
             (8035, 10591)),
    "date_desc": ("date", lambda r: r.integers(8035, 10592, CAP), False,
                  "desc", (8035, 10591)),
    "decimal": ("decimal(12,2)", lambda r: r.integers(-999, 999, CAP), True,
                "asc_nulls_first", (-999, 998)),
    "decimal_wide": ("decimal(15,2)", lambda r: r.integers(0, 10 ** 9, CAP),
                     False, "desc_nulls_last", None),
    "varchar": ("varchar", lambda r: r.integers(0, len(WORDS), CAP), True,
                "asc", None),
    "varchar_desc": ("varchar", lambda r: r.integers(0, len(WORDS), CAP),
                     False, "desc", None),
    "boolean": ("boolean", lambda r: r.integers(0, 2, CAP), True, "desc",
                None),
    "const": ("integer", lambda r: np.full(CAP, 7), False, "asc", (7, 7)),
}

# key sets by the path each takes (bits = 1 active bit + the keys')
CASES = {
    "zero_bit_key": ["const", "int32_narrow"],       # scatter branch
    "scatter": ["date", "varchar", "boolean"],
    "scatter_nulls_desc": ["date_desc", "decimal", "int32_narrow"],
    "classic_loop": ["int64", "int32", "varchar_desc"],  # 3 lanes
    "classic_nulls": ["int64_desc_nulls", "decimal_wide", "int32"],
    "over_four_lanes": ["int64", "int64_desc_nulls", "decimal_wide",
                        "int64", "int32"],               # 6 lanes
}


def _np_dtype(tname):
    if tname.startswith("decimal"):
        return np.int64
    return {"integer": np.int32, "bigint": np.int64, "date": np.int32,
            "varchar": np.int32, "boolean": np.bool_}[tname]


def _values(case: str, seed: int = 0):
    """(jax EvalValues, port EvalValues, jax orders, port orders, ranges,
    active mask as numpy)."""
    rng = np.random.default_rng(seed)
    jvals, tvals, jord, tord, ranges = [], [], [], [], []
    jdict, tdict = JDictionary(sorted(WORDS)), Dictionary(sorted(WORDS))
    for name in CASES[case]:
        tname, gen, nullable, order, rng_ = KEYS[name]
        data = gen(rng).astype(_np_dtype(tname))
        valid = rng.random(CAP) > 0.2 if nullable else None
        is_str = tname == "varchar"
        jvals.append(JEvalValue(
            jnp.asarray(data), None if valid is None else jnp.asarray(valid),
            JT.parse_type(tname), jdict if is_str else None))
        tvals.append(EvalValue(
            torch.from_numpy(data),
            None if valid is None else torch.from_numpy(valid),
            T.parse_type(tname), tdict if is_str else None))
        jord.append(JSortOrder(order + ("_nulls_last" if "nulls" not in order
                                        else "")))
        tord.append(SortOrder(order + ("_nulls_last" if "nulls" not in order
                                       else "")))
        ranges.append(rng_)
    active = np.arange(CAP) < N_ACTIVE
    rng.shuffle(active)
    return jvals, tvals, jord, tord, ranges, active


def _layout_key(f):
    return (f.kind, f.off, f.nb, f.base, f.desc, f.null_off, f.null_is_one,
            str(f.dtype))


def _np_words(ws):
    return [np.asarray(w).astype(np.uint64).astype(np.int64) for w in ws]


def _both_layouts(case, grouping=False):
    jv, tv, jo, to, ranges, active = _values(case)
    jw, jb, jl = JS.sort_words_layout(jv, None if grouping else jo, CAP,
                                      jnp.asarray(active), ranges)
    tw, tb, tl = S.sort_words_layout(tv, None if grouping else to, CAP,
                                     torch.from_numpy(active), ranges)
    return (jw, jb, jl), (tw, tb, tl), jv


@pytest.mark.parametrize("grouping", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_sort_words_layout_matches(case, grouping):
    (jw, jb, jl), (tw, tb, tl), _ = _both_layouts(case, grouping)
    assert tb == list(jb)
    assert [_layout_key(f) for f in tl] == [_layout_key(f) for f in jl]
    for a, b in zip(_np_words(jw), tw):
        assert b.dtype == torch.int64
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("case", list(CASES))
def test_pack_and_decode_match(case):
    (jw, jb, jl), (tw, tb, tl), _ = _both_layouts(case)
    jlanes = JS.pack_words_u64(jw, jb)
    tlanes = S.pack_words_u64(tw, tb)
    assert len(tlanes) == len(jlanes)
    for a, b in zip(jlanes, tlanes):
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(a).astype(np.uint64).view(np.int64))
    lw = S.lane_bit_widths(sum(tb))
    assert lw == JS.lane_bit_widths(sum(jb))
    for jf, tf in zip(jl, tl):
        if not tf.decodable:
            continue
        jd, jn = JS.decode_key_field(jf, jlanes, lw, CAP)
        td, tn = S.decode_key_field(tf, tlanes, lw, CAP)
        assert str(td.dtype).split(".")[-1] == str(np.asarray(jd).dtype) \
            or (td.dtype == torch.bool and np.asarray(jd).dtype == np.bool_)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert (tn is None) == (jn is None)
        if tn is not None:
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("case", list(CASES))
def test_sort_perm_key_matches(case):
    (jw, jb, _), (tw, tb, _), _ = _both_layouts(case)
    jperm, _ = JS.sort_perm_key(jw, jb, CAP)
    hist, rank, pos = (R.radix_hist.launches, R.radix_rank.launches,
                       R.radix_pos.launches)
    tperm, skey = S.sort_perm_key(tw, tb, CAP)
    assert skey is None
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    # the CPU runs the plain versions: no kernel launch counted
    assert (R.radix_hist.launches, R.radix_rank.launches,
            R.radix_pos.launches) == (hist, rank, pos)
    # sorted lanes: the run boundaries agree too
    jl = [ln[jperm] for ln in JS.pack_words_u64(jw, jb)]
    tl = [ln[tperm] for ln in S.pack_words_u64(tw, tb)]
    lw = S.lane_bit_widths(sum(tb))
    for prefix in (1, sum(tb) // 2, sum(tb)):
        np.testing.assert_array_equal(
            S.lane_prefix_neq(tl, lw, prefix).numpy(),
            np.asarray(JS.lane_prefix_neq(jl, lw, prefix)))


def test_branch_of_each_case():
    """The cases reach what their names say: the scatter branch when key
    and row-id bits fit 64, the classic loop otherwise, and keys wider
    than the reference's four-lane lax.sort cap."""
    pbits = (CAP - 1).bit_length()
    for case in CASES:
        (_, jb, _), (_, tb, _), _ = _both_layouts(case)
        total = sum(tb)
        lanes = len(S.lane_bit_widths(total))
        if case.startswith(("scatter", "zero_bit")):
            assert total + pbits <= 64, case
        else:
            assert total + pbits > 64, case
        assert (lanes > 4) == (case == "over_four_lanes"), case


def test_zero_bit_sort_is_the_identity():
    jperm, jkey = JS.sort_perm_key([], [], 16)
    tperm, tkey = S.sort_perm_key([], [], 16)
    assert jkey is None and tkey is None
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("case", ["scatter", "classic_loop"])
def test_sort_permutation_orders_active_rows_first(case):
    _, tv, _, to, _, active = _values(case, seed=3)
    perm = S.sort_permutation(tv, to, CAP, torch.from_numpy(active))
    assert active[perm.numpy()][:N_ACTIVE].all()
    assert not active[perm.numpy()][N_ACTIVE:].any()


@pytest.mark.parametrize("width", [16, 64])
def test_unported_key_words_raise(width):
    """A raw (byte-matrix) string key now gives the reference's words:
    W/4 big-endian byte words and the length word; a string key with
    neither a dictionary nor bytes still raises."""
    from velox_tpu.vector import strings as JSTR
    from velox_tpu_torch.vector import strings as TSTR
    vals = ["b", "a", "", "ab", "zz" * (width // 4), "é", None, "a"]
    b, ln = TSTR.pack_pylist(vals, 8, width)
    valid = np.array([v is not None for v in vals])
    tv = TSTR.raw_value(torch.from_numpy(b), torch.from_numpy(ln),
                        torch.from_numpy(valid))
    jv = JSTR.raw_value(jnp.asarray(b), jnp.asarray(ln), jnp.asarray(valid))
    words = S.value_words(tv, 8)
    jwords = JS.value_words(jv, 8)
    assert len(words) == len(jwords) == width // 4 + 1
    for w, jw in zip(words, jwords):
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(jw).astype(np.int64))
    active = np.arange(8) < 7
    perm = S.sort_permutation([tv], None, 8, torch.from_numpy(active))
    jperm = JS.sort_permutation([jv], None, 8, jnp.asarray(active))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    v = EvalValue(torch.zeros(8, dtype=torch.int32), None, T.VARCHAR)
    with pytest.raises(ValueError, match="dictionary or raw"):
        S.value_words(v, 8)


def _long_decimal_values(seed: int, nullable: bool):
    """(jax EvalValue, port EvalValue) of a DECIMAL(30,2) key whose values
    use both limbs, both signs and ties."""
    rng = np.random.default_rng(seed)
    vals = [int(x) * 2 ** 64 + int(y) for x, y in zip(
        rng.integers(-5, 5, CAP), rng.integers(-2 ** 63, 2 ** 63 - 1, CAP,
                                               dtype=np.int64))]
    vals[::7] = vals[1::7][:len(vals[::7])]  # ties
    lo = np.array([((v & (2 ** 64 - 1)) ^ 2 ** 63) - 2 ** 63 for v in vals],
                  np.int64)
    hi = np.array([v >> 64 for v in vals], np.int64)
    valid = rng.random(CAP) > 0.2 if nullable else None
    from velox_tpu.vector.device import DeviceColumn as JDeviceColumn
    from velox_tpu_torch.vector.device import DeviceColumn
    jv = JEvalValue(jnp.asarray(lo),
                    None if valid is None else jnp.asarray(valid),
                    JT.decimal(30, 2),
                    children=(JDeviceColumn(jnp.asarray(hi), None,
                                            JT.BIGINT, None),))
    tv = EvalValue(torch.from_numpy(lo),
                   None if valid is None else torch.from_numpy(valid),
                   T.decimal(30, 2),
                   children=(DeviceColumn(torch.from_numpy(hi), None,
                                          T.BIGINT),))
    return jv, tv, vals


@pytest.mark.parametrize("order", ["asc_nulls_last", "desc_nulls_first",
                                   "desc_nulls_last"])
def test_long_decimal_key_words_match_reference(order):
    jv, tv, vals = _long_decimal_values(4, nullable=True)
    for a, b in zip(_np_words(JS.value_words(jv, CAP)),
                    S.value_words(tv, CAP)):
        np.testing.assert_array_equal(b.numpy(), a)
    active = np.arange(CAP) < N_ACTIVE
    jw, jb, jl = JS.sort_words_layout([jv], [JSortOrder(order)], CAP,
                                      jnp.asarray(active))
    tw, tb, tl = S.sort_words_layout([tv], [SortOrder(order)], CAP,
                                     torch.from_numpy(active))
    assert tb == list(jb) and sum(tb) == 1 + 1 + 128
    assert [_layout_key(f) for f in tl] == [_layout_key(f) for f in jl]
    assert tl[0].kind == "opaque" and not tl[0].decodable
    jperm = JS.radix_sort_perm(jw, jb, CAP)
    tperm = S.radix_sort_perm(tw, tb, CAP)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    # the active non-null rows come out in value order
    valid = np.asarray(jv.validity)
    keep = [i for i in tperm.numpy() if active[i] and valid[i]]
    got = [vals[i] for i in keep]
    assert got == sorted(got, reverse=order.startswith("desc"))


@pytest.mark.parametrize("types", [
    ["bigint"], ["integer", "date"], ["decimal(12,2)"], ["varchar"],
    ["bigint", "integer"], ["decimal(38,2)"], ["double", "bigint"],
    ["bigint"] * 3, ["bigint"] * 4, ["boolean", "real"],
])
def test_join_key_word_counts_match_reference(types):
    jt = [JT.parse_type(t) for t in types]
    tt = [T.parse_type(t) for t in types]
    assert [S.num_value_words(t) for t in tt] \
        == [JS.num_value_words(t) for t in jt]
    assert S.packable_words(tt) == JS.packable_words(jt)


@pytest.mark.parametrize("case", ["int32_narrow", "int64", "date_int32",
                                  "decimal_narrowed", "varchar"])
def test_pack_key_u64_matches_reference(case):
    """One packed 64-bit key per row, as an int64 with the reference's
    uint64 bits; a narrower stored column packs like the canonical one."""
    rng = np.random.default_rng(9)
    if case == "int64":
        cols = [("bigint", rng.integers(-2 ** 62, 2 ** 62, CAP), np.int64)]
    elif case == "date_int32":
        cols = [("date", rng.integers(8035, 10592, CAP), np.int32),
                ("integer", rng.integers(-9, 9, CAP), np.int32)]
    elif case == "decimal_narrowed":  # DECIMAL(12,2) stored as int32
        cols = [("decimal(12,2)", rng.integers(-999, 999, CAP), np.int32)]
    elif case == "varchar":
        cols = [("varchar", rng.integers(0, len(WORDS), CAP), np.int32)]
    else:
        cols = [("integer", rng.integers(-50, 50, CAP), np.int32)]
    jd_, td_ = JDictionary(sorted(WORDS)), Dictionary(sorted(WORDS))
    jvals = [JEvalValue(jnp.asarray(d.astype(st)), None, JT.parse_type(t),
                        jd_ if t == "varchar" else None)
             for t, d, st in cols]
    tvals = [EvalValue(torch.from_numpy(d.astype(st)), None, T.parse_type(t),
                       td_ if t == "varchar" else None)
             for t, d, st in cols]
    want = np.asarray(JS.pack_key_u64(jvals, CAP)).view(np.int64)
    got = S.pack_key_u64(tvals, CAP)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Whole plans at SF 0.01: OrderBy, TopN, Limit
# ---------------------------------------------------------------------------

def _sort_plan(builder, kind):
    scan = builder().table_scan
    if kind == "orderby_limit":  # the orderBy config: Limit -> TopN
        return (scan("lineitem", ["l_shipdate", "l_orderkey"])
                .order_by(["l_shipdate", "l_orderkey"]).limit(1000).plan())
    if kind == "full_order_by":
        return (scan("lineitem", ["l_shipdate", "l_orderkey",
                                  "l_linenumber"])
                .order_by(["l_shipdate", "l_orderkey", "l_linenumber"])
                .plan())
    if kind == "top_n_desc":
        return (scan("lineitem", ["l_orderkey", "l_extendedprice",
                                  "l_returnflag", "l_quantity"],
                     filter="l_quantity > 20.0")
                .top_n(["l_returnflag", "l_extendedprice DESC",
                        "l_orderkey"], 50).plan())
    if kind == "limit":
        return (scan("lineitem", ["l_orderkey", "l_quantity"])
                .limit(7, offset=3).plan())
    if kind == "top_n_long_decimal":  # Q3's TopN: a DECIMAL(38,4) sum
        return (scan("lineitem", ["l_orderkey", "l_extendedprice",
                                  "l_discount", "l_shipdate"])
                .project(["l_orderkey", "l_shipdate",
                          "l_extendedprice * (1.0 - l_discount) as rev"])
                .single_aggregation(["l_orderkey", "l_shipdate"],
                                    ["sum(rev) as revenue"])
                .top_n(["revenue DESC", "l_shipdate", "l_orderkey"], 25)
                .plan())
    raise ValueError(kind)


@pytest.fixture
def _tpch():
    from velox_tpu.connectors.tpch import register_tpch as jax_register_tpch
    from velox_tpu_torch.connectors.tpch import register_tpch
    jax_register_tpch(0.01)
    register_tpch(0.01)


@pytest.mark.parametrize("kind", ["orderby_limit", "full_order_by",
                                  "top_n_desc", "limit",
                                  "top_n_long_decimal"])
def test_sort_plans_equal_reference(kind, _tpch):
    from velox_tpu.exec.task import Task as JTask
    from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
    from velox_tpu_torch.exec.task import QueryCtx, Task
    from velox_tpu_torch.testing.plan_builder import PlanBuilder
    want = JTask(_sort_plan(JPlanBuilder, kind)).run()
    got = Task(_sort_plan(PlanBuilder, kind), QueryCtx("cpu")).run()
    assert got.num_rows == want.num_rows > 0
    assert got.schema == want.schema
    assert got.equals(want)


@pytest.mark.parametrize("query", [1, 3, 18])
def test_column_stats_resolve_as_in_the_reference(query, _tpch):
    """core/stats.py is a copy: the ranges the sort words narrow by are
    the reference's, through scans, filters, projections, aggregations,
    joins and sorts."""
    from velox_tpu.core.stats import resolve_column_stats as jresolve
    from velox_tpu.tpch import tpch_plan as jax_tpch_plan
    from velox_tpu_torch.core.stats import resolve_column_stats
    from velox_tpu_torch.tpch import tpch_plan

    def nodes(n):
        yield n
        for attr in ("source", "left", "right"):
            child = getattr(n, attr, None)
            if child is not None:
                yield from nodes(child)

    seen = 0
    for jn, tn in zip(nodes(jax_tpch_plan(query)), nodes(tpch_plan(query))):
        assert type(jn).__name__ == type(tn).__name__
        for name in tn.output_type().names:
            got = resolve_column_stats(tn, name)
            assert got == jresolve(jn, name), (type(tn).__name__, name)
            seen += got is not None
    assert seen > 0


# (key bits, capacity): 1 to 6 passes of the scatter branch; the last
# fills all 64 bits of the state with key (48) and row id (16)
SCATTER_KEYS = [(5, CAP), (12, CAP), (20, CAP), (27, CAP), (39, CAP),
                (45, CAP), (48, 1 << 16)]


@pytest.mark.parametrize("total,capacity", SCATTER_KEYS)
def test_scatter_sort_perm_matches_reference(total, capacity):
    """The scatter branch (B4 over the state, then B3's scatter form, a
    pass) gives the reference's permutation, ties included."""
    rng = np.random.default_rng(total)
    bits = [32] * (total // 32) + ([total % 32] if total % 32 else [])
    # few distinct values per word: ties in every pass
    words = [rng.integers(0, 1 << b, 97, dtype=np.int64)[
        rng.integers(0, 97, capacity)] for b in bits]
    assert total + (capacity - 1).bit_length() <= 64
    jperm = JS._scatter_sort_perm(
        [jnp.asarray(w.astype(np.uint32)) for w in words], bits, capacity)
    tperm = S._scatter_sort_perm([torch.from_numpy(w) for w in words], bits,
                                 capacity)
    assert tperm.dtype == torch.int64
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(
        tperm.numpy(), np.lexsort([w for w in reversed(words)]))


# (word bits, most significant first; capacity): full 32-bit words and a
# narrow word, over several tiles and a ragged last one
CLASSIC_KEYS = [([32, 32, 5], 3 * 8192 + 5), ([7, 32, 32], 2 * 8192 + 1)]


def _classic_words(bits, capacity, seed):
    rng = np.random.default_rng(seed)
    # few distinct values per word: ties in every pass; values from 2^31
    # up included
    return [rng.integers(0, 1 << b, 97, dtype=np.int64)[
        rng.integers(0, 97, capacity)] for b in bits]


@pytest.mark.parametrize("bits,capacity", CLASSIC_KEYS)
def test_classic_sort_perm_matches_reference(bits, capacity):
    """The classic loop (each word gathered once, B4 and B2's
    rank-and-scatter form a pass) gives the reference's permutation."""
    words = _classic_words(bits, capacity, seed=capacity)
    assert sum(bits) + (capacity - 1).bit_length() > 64
    jperm = JS._radix_fallback_perm(
        [jnp.asarray(w.astype(np.uint32)) for w in words], bits, capacity)
    tperm = S._radix_fallback_perm([torch.from_numpy(w) for w in words],
                                   bits, capacity)
    assert tperm.dtype == torch.int64
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(
        tperm.numpy(), np.lexsort([w for w in reversed(words)]))


def test_classic_loop_calls_each_kernel_as_planned(monkeypatch):
    """One rank-and-scatter and one histogram a pass; one gather for each
    word after the first; the word lane dropped on each word's last
    pass."""
    calls = {"hist": 0, "rank_scatter": 0, "gather": 0, "spent": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            if name == "rank_scatter" and not kwargs.get("keep_word", True):
                calls["spent"] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(S, "radix_hist", counted("hist", S.radix_hist))
    monkeypatch.setattr(S, "radix_rank_scatter",
                        counted("rank_scatter", S.radix_rank_scatter))
    monkeypatch.setattr(S, "flat_gather", counted("gather", S.flat_gather))
    bits = [32, 32, 5]
    words = _classic_words(bits, CAP, seed=1)
    perm = S.radix_sort_perm([torch.from_numpy(w) for w in words], bits, CAP)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.lexsort([w for w in reversed(words)]))
    assert calls == {"hist": 9, "rank_scatter": 9, "gather": 2, "spent": 3}


def test_word_bits_keep_the_bits_of_words_past_2_31():
    w = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.int64)
    got = S._word_bits(torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  w.astype(np.uint32).view(np.int32))
