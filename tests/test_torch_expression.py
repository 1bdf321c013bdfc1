"""Expression evaluation of the torch port against the JAX reference.

Each expression is parsed by each package's own parser over the same row
type and evaluated over identical batches (data made from a numpy seed,
with nulls and rows that overflow BIGINT arithmetic). Data, validity and
the per-row error channel must be equal, and so must the storage dtype.
"""

import decimal

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu import types as JT
from velox_tpu.exec import fuse as jfuse
from velox_tpu.expression.eval import ExprSet as JExprSet
from velox_tpu.parse.parser import parse_expression as jparse
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.vector import device as jd
from velox_tpu_torch import types as TT
from velox_tpu_torch.exec import fuse as tfuse
from velox_tpu_torch.expression.eval import ExprSet as TExprSet
from velox_tpu_torch.parse.parser import parse_expression as tparse
from velox_tpu_torch.testing.plan_builder import PlanBuilder as TPlanBuilder
from velox_tpu_torch.vector import device as td

torch.set_num_threads(1)

CAP = 2048
N_ACTIVE = 2000
SCHEMA = [  # name, type, storage dtype, nullable
    ("l_quantity", "decimal(12,2)", np.int32, False),
    ("l_extendedprice", "decimal(12,2)", np.int32, False),
    ("l_discount", "decimal(12,2)", np.int32, False),
    ("l_tax", "decimal(12,2)", np.int32, False),
    ("l_shipdate", "date", np.int32, False),
    ("k", "bigint", np.int64, False),
    ("j", "bigint", np.int64, True),
    ("i", "integer", np.int32, True),
    ("p", "decimal(12,2)", np.int64, True),
]

Q6_FILTER = ("l_shipdate >= date '1994-01-01' and "
             "l_shipdate < date '1995-01-01' and "
             "l_discount between 0.05 and 0.07 and l_quantity < 24.0")
EXPRESSIONS = [
    # TPC-H Q6 and Q1 heads
    Q6_FILTER,
    "l_extendedprice * l_discount",
    "l_shipdate <= date '1998-09-02'",
    "l_extendedprice * (1.0 - l_discount)",
    "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax)",
    "l_quantity < 24.0",
    "l_discount between 0.05 and 0.07",
    # checked integer arithmetic with nulls and overflowing rows
    "k + j", "k - j", "k * j", "k * 3", "i + j", "i * 2", "try(k + j)",
    "try(k * j) + i",
    # decimal arithmetic with nulls, rescaled constants, mixed operands
    "p + l_tax", "p - 1.5", "p * l_discount", "p * 2", "l_quantity + 1",
    "p > 5.5", "p between 1.00 and 2000.25", "p = l_quantity",
    # comparisons, IN, null tests, Kleene logic
    "i = 5", "i <> 5", "k >= 0", "i in (1, 2, 3, 70)", "j is null",
    "k is null", "j is not null", "not (i > 0)", "(i > 0) or (j < 0)",
    "(i > 0) and (j < 0)", "i > 0 or l_quantity < 24.0",
    "l_shipdate < date '1995-01-01' and i > 0",
]


def _arrays(seed: int):
    rng = np.random.default_rng(seed)
    cols = {
        "l_quantity": rng.integers(100, 5001, CAP),
        "l_extendedprice": rng.integers(90000, 10_495_001, CAP),
        "l_discount": rng.integers(0, 11, CAP),
        "l_tax": rng.integers(0, 9, CAP),
        "l_shipdate": rng.integers(8035, 10592, CAP),
        # large magnitudes: some sums and products overflow int64
        "k": rng.integers(-2 ** 63, 2 ** 63 - 1, CAP, dtype=np.int64),
        "j": rng.integers(-2 ** 62, 2 ** 62, CAP, dtype=np.int64),
        "i": rng.integers(-100, 100, CAP),
        "p": rng.integers(-10 ** 6, 10 ** 6, CAP),
    }
    cols["j"][:100] = rng.integers(-5, 5, 100)  # small: no overflow
    out = {}
    for name, _, st, nullable in SCHEMA:
        validity = (rng.random(CAP) > 0.15) if nullable else None
        out[name] = (cols[name].astype(st), validity)
    mask = np.arange(CAP) < N_ACTIVE
    return out, mask


def _batches(seed: int):
    arrays, mask = _arrays(seed)
    jcols, tdt = {}, {}
    for name, typ, _, _ in SCHEMA:
        data, validity = arrays[name]
        jcols[name] = jd.DeviceColumn(
            jnp.asarray(data),
            None if validity is None else jnp.asarray(validity),
            JT.parse_type(typ), None)
        tdt[name] = TT.parse_type(typ)
    jbatch = jd.DeviceBatch(jcols, jnp.asarray(mask))
    tbatch = td.batch_from_numpy(arrays, mask, tdt, device="cpu")
    return jbatch, tbatch


def _row_types():
    names = [s[0] for s in SCHEMA]
    return (JT.row(names, [JT.parse_type(s[1]) for s in SCHEMA]),
            TT.row(names, [TT.parse_type(s[1]) for s in SCHEMA]))


def _np(x):
    return None if x is None else np.asarray(jax.device_get(x))


def _assert_same_column(tcol, jcol, what):
    jdata, tdata = _np(jcol.data), tcol.data.numpy()
    assert tdata.dtype == jdata.dtype, what
    np.testing.assert_array_equal(tdata, jdata, err_msg=what)
    assert (tcol.validity is None) == (jcol.validity is None), what
    if jcol.validity is not None:
        np.testing.assert_array_equal(tcol.validity.numpy(),
                                      _np(jcol.validity), err_msg=what)
    assert str(tcol.dtype) == str(jcol.dtype), what


@pytest.mark.parametrize("text", EXPRESSIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_expression_matches_reference(text, seed):
    jrt, trt = _row_types()
    je, te = jparse(text, jrt), tparse(text, trt)
    assert str(te.dtype) == str(je.dtype)
    jbatch, tbatch = _batches(seed)
    jsink, tsink = [], []
    jv = JExprSet([je], jrt).eval_batch(jbatch, err_sink=jsink)[0]
    tv = TExprSet([te], trt).eval_batch(tbatch, err_sink=tsink)[0]
    _assert_same_column(tv.to_column(CAP), jv.to_column(CAP), text)
    assert (tsink[0] is None) == (jsink[0] is None)
    if jsink[0] is not None:
        np.testing.assert_array_equal(
            np.broadcast_to(tsink[0].numpy(), (CAP,)),
            np.broadcast_to(_np(jsink[0]), (CAP,)))


def test_overflow_rows_are_flagged():
    """The batches really exercise the error channel: some k + j rows
    overflow, and TRY turns exactly those rows into NULLs."""
    _, trt = _row_types()
    _, tbatch = _batches(0)
    sink = []
    v = TExprSet([tparse("k + j", trt)], trt).eval_batch(tbatch,
                                                         err_sink=sink)[0]
    assert 0 < int(sink[0].sum()) < CAP
    t = TExprSet([tparse("try(k + j)", trt)], trt).eval_batch(tbatch)[0]
    torch.testing.assert_close(t.validity, v.validity, rtol=0, atol=0)


def _chain(builder_cls, batch, filter_text, projections):
    pb = builder_cls().values([batch])
    if filter_text:
        pb = pb.filter(filter_text)
    return pb.project(projections).plan()


@pytest.mark.parametrize("filter_text, projections", [
    (Q6_FILTER, ["l_extendedprice * l_discount as revenue"]),
    ("l_shipdate <= date '1998-09-02'",
     ["l_quantity", "l_extendedprice",
      "l_extendedprice * (1.0 - l_discount) as l_sum_disc_price",
      "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax) as l_sum_charge",
      "l_discount"]),
    # projection errors count only on rows that pass the filter
    ("i > 0", ["k + j as s", "i * 2 as t"]),
    ("k + j > 0", ["p * l_discount as r"]),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_chain_matches_reference(filter_text, projections, seed):
    jbatch, tbatch = _batches(seed)
    jnode = _chain(JPlanBuilder, jbatch, filter_text, projections)
    tnode = _chain(TPlanBuilder, tbatch, filter_text, projections)
    jout = jfuse.chain_fn(jfuse.collapse_chain(jnode))(jbatch)
    tout = tfuse.chain_fn(tfuse.collapse_chain(tnode))(tbatch)
    np.testing.assert_array_equal(tout.mask.numpy(), _np(jout.mask))
    assert int(tout.errors) == int(_np(jout.errors))
    assert list(tout.columns) == list(jout.columns)
    for name in jout.columns:
        _assert_same_column(tout.columns[name], jout.columns[name], name)


def test_unported_function_raises_naming_it():
    """Every function of the reference is ported (tests/
    test_torch_sparksql.py holds the registries equal), so a name
    neither package knows raises, naming it; split_part and bitwise_and,
    the earlier examples here, now resolve."""
    jrt, trt = _row_types()
    with pytest.raises(NotImplementedError, match="no_such_function"):
        tparse("no_such_function(k, 2)", trt)
    with pytest.raises(KeyError, match="no_such_function"):
        jparse("no_such_function(k, 2)", jrt)
    assert str(tparse("split_part(l_comment, ' ', 2)", TT.row(
        ["l_comment"], [TT.VARCHAR])).dtype) == "varchar"
    assert str(tparse("bitwise_and(k, 2)", trt).dtype) == "bigint"


# ---------------------------------------------------------------------------
# Dictionary string and long-decimal comparisons
# ---------------------------------------------------------------------------

WORDS = sorted(["cherry", "apple", "fig", "banana", "date", "elder",
                "grape"])
OTHER_WORDS = sorted(["fig", "kiwi", "apple", "lime"])  # a second dictionary
CMP_SCHEMA = [  # name, type, nullable
    ("s", "varchar", True), ("t", "varchar", False),
    ("q", "decimal(38,2)", True), ("r", "decimal(38,4)", False),
    ("p", "decimal(12,2)", True),
]
CMP_EXPRESSIONS = [
    "s = 'fig'", "s <> 'fig'", "s < 'date'", "s >= 'cherry'",
    "'elder' > s", "s = 'zzz'", "s <> 'zzz'", "s in ('apple', 'grape')",
    "s between 'banana' and 'fig'", "s = t", "s <> t",
    "q > 300.0", "q = q", "q < r", "q >= 1.5", "q <> p", "q = p",
    "p <= q",
    "q between -100000.00 and 100000.00", "r > 0",
]


def _limbs_np(vals):
    lo = np.array([((v & (2 ** 64 - 1)) ^ 2 ** 63) - 2 ** 63 for v in vals],
                  dtype=np.int64)
    hi = np.array([v >> 64 for v in vals], dtype=np.int64)
    return lo, hi


def _cmp_batches(seed: int):
    rng = np.random.default_rng(seed)
    big = [int(x) * 10 ** 12 + int(y) for x, y in zip(
        rng.integers(-10 ** 15, 10 ** 15, CAP),
        rng.integers(0, 10 ** 12, CAP))]
    small = [int(x) for x in rng.integers(-10 ** 7, 10 ** 7, CAP)]
    # q: huge and small values, and values equal to r's at the wider scale
    q = [b if i % 3 == 0 else s for i, (b, s) in enumerate(zip(big, small))]
    r = [v * 100 if i % 4 == 0 else int(rng.integers(-10 ** 9, 10 ** 9))
         for i, v in enumerate(q)]
    arrays = {
        "s": (rng.integers(0, len(WORDS), CAP).astype(np.int32),
              rng.random(CAP) > 0.15),
        "t": (rng.integers(0, len(OTHER_WORDS), CAP).astype(np.int32), None),
        "q": (*_limbs_np(q),),
        "r": (*_limbs_np(r),),
        "p": (np.where(np.arange(CAP) % 3 != 0, np.array(q[:], dtype=object),
                       rng.integers(-10 ** 9, 10 ** 9, CAP)).astype(np.int64),
              rng.random(CAP) > 0.15),
    }
    qvalid = rng.random(CAP) > 0.15
    arrays["q"] = (arrays["q"][0], qvalid, arrays["q"][1])
    arrays["r"] = (arrays["r"][0], None, arrays["r"][1])
    mask = np.arange(CAP) < N_ACTIVE
    jdicts = {"s": jd.Dictionary(WORDS), "t": jd.Dictionary(OTHER_WORDS)}
    tdicts = {"s": td.Dictionary(WORDS), "t": td.Dictionary(OTHER_WORDS)}
    jcols, tdt = {}, {}
    for name, typ, _ in CMP_SCHEMA:
        data, validity, *kids = arrays[name]
        jt = JT.parse_type(typ)
        jcols[name] = jd.DeviceColumn(
            jnp.asarray(data),
            None if validity is None else jnp.asarray(validity), jt,
            jdicts.get(name),
            tuple(jd.DeviceColumn(jnp.asarray(k), None, JT.BIGINT, None)
                  for k in kids))
        tdt[name] = TT.parse_type(typ)
    jbatch = jd.DeviceBatch(jcols, jnp.asarray(mask))
    tbatch = td.batch_from_numpy(arrays, mask, tdt, tdicts, device="cpu")
    return jbatch, tbatch, arrays


def _cmp_row_types():
    names = [s[0] for s in CMP_SCHEMA]
    return (JT.row(names, [JT.parse_type(s[1]) for s in CMP_SCHEMA]),
            TT.row(names, [TT.parse_type(s[1]) for s in CMP_SCHEMA]))


@pytest.mark.parametrize("text", CMP_EXPRESSIONS)
def test_string_and_long_decimal_compares_match_reference(text):
    jrt, trt = _cmp_row_types()
    jbatch, tbatch, _ = _cmp_batches(5)
    jv = JExprSet([jparse(text, jrt)], jrt).eval_batch(jbatch)[0]
    tv = TExprSet([tparse(text, trt)], trt).eval_batch(tbatch)[0]
    tcol, jcol = tv.to_column(CAP), jv.to_column(CAP)
    _assert_same_column(tcol, jcol, text)
    hits = tcol.data.numpy()
    assert 0 < hits.sum() < CAP or text in ("s = 'zzz'", "s <> 'zzz'",
                                            "q = q"), text


@pytest.mark.parametrize("text,op,const", [
    ("s < 'coconut'", "lt", "coconut"), ("s <= 'coconut'", "lte", "coconut"),
    ("s > 'coconut'", "gt", "coconut"), ("s >= 'coconut'", "gte", "coconut"),
    ("'coconut' < s", "gt", "coconut"), ("s < 'aardvark'", "lt", "aardvark"),
    ("s >= 'zebra'", "gte", "zebra"),
])
def test_ordered_compare_with_an_absent_constant(text, op, const):
    """A constant the sorted dictionary lacks orders by its insertion
    point (the reference binds it to id -1, which orders below every
    value; ROADMAP C)."""
    _, trt = _cmp_row_types()
    _, tbatch, arrays = _cmp_batches(6)
    tv = TExprSet([tparse(text, trt)], trt).eval_batch(tbatch)[0]
    words = np.array(WORDS, dtype=object)[arrays["s"][0]]
    want = {"lt": words < const, "lte": words <= const,
            "gt": words > const, "gte": words >= const}[op]
    np.testing.assert_array_equal(tv.data.numpy(), want)
    np.testing.assert_array_equal(tv.validity.numpy(), arrays["s"][1])


@pytest.mark.parametrize("text", [
    "s = 'fig'", "s <> 'fig'", "s < 'date'", "s >= 'cherry'",
    "'elder' > s", "s = 'zzz'", "s < 'dat'", "s = t", "s <> t",
    "s in ('apple', 'grape')", "s between 'banana' and 'fig'"])
def test_raw_string_compare_raises_naming_the_roadmap(text):
    """A raw (byte-matrix) ``s`` now compares on its bytes, against a
    constant or a dictionary column, and equals the reference."""
    from velox_tpu.vector import strings as JS
    from velox_tpu_torch.vector import strings as TS
    jrt, trt = _cmp_row_types()
    jbatch, tbatch, arrays = _cmp_batches(7)
    ids, valid = arrays["s"]
    vals = [WORDS[i] if v else None for i, v in zip(ids, valid)]
    b, ln = TS.pack_pylist(vals, CAP)
    tbatch.columns["s"] = TS.raw_column(torch.from_numpy(b),
                                        torch.from_numpy(ln),
                                        torch.from_numpy(valid))
    jbatch.columns["s"] = JS.raw_column(jnp.asarray(b), jnp.asarray(ln),
                                        jnp.asarray(valid))
    jv = JExprSet([jparse(text, jrt)], jrt).eval_batch(jbatch)[0]
    tv = TExprSet([tparse(text, trt)], trt).eval_batch(tbatch)[0]
    live = valid & (np.arange(CAP) < N_ACTIVE)
    np.testing.assert_array_equal(
        np.broadcast_to(tv.data.numpy(), (CAP,))[live],
        np.broadcast_to(np.asarray(jv.data), (CAP,))[live])
    assert 0 < int(tv.data.numpy()[live].sum()) < live.sum() \
        or text == "s = 'zzz'", text


# ---------------------------------------------------------------------------
# evaluate and compile_exprs (the counterparts of tests/test_expression.py's
# cases, each through both packages' ``evaluate`` over the same table)
# ---------------------------------------------------------------------------

def _dec(*vals):
    return [None if v is None else decimal.Decimal(v) for v in vals]


_EVAL_TABLES = {
    "ints": pa.table({"a": [1, 2, 3, None], "b": [10, None, 30, 40]}),
    "div": pa.table({"a": [7, -7, 7], "b": [2, 2, 0]}),
    "x": pa.table({"x": pa.array([1.0, 4.0, 9.0], type=pa.float64())}),
    "cmp": pa.table({"a": [1, 2, None, 4], "b": [2, 2, 2, 2]}),
    "between": pa.table({"a": [1, 5, 10, None]}),
    "null": pa.table({"a": [1, None, 3]}),
    "s": pa.table({"s": ["apple", "Banana", "cherry", None]}),
    "sorted": pa.table({"s": ["b", "a", "c"]}),
    "d": pa.table({"d": pa.array([0, 9000, 19000], type=pa.date32())}),
    "dec": pa.table({
        "p": pa.array([1, 2, 3], type=pa.decimal128(12, 2)),
        "disc": pa.array(_dec("0.05", "0.10", "0.00"),
                         type=pa.decimal128(12, 2))}),
    "cast": pa.table({"a": [1, 2, 3], "x": pa.array([1.4, 2.5, -2.5])}),
    "cse": pa.table({"a": [1.0, 2.0]}),
}
EVAL_CASES = [
    ("ints", "a + b * 2"),
    ("div", "a / b"), ("div", "a % b"),
    ("x", "sqrt(x) + 0.5"),
    ("cmp", "a < b"), ("cmp", "a < b and b = 2"), ("cmp", "a < b or b = 2"),
    ("between", "a between 2 and 9"), ("between", "a in (1, 10)"),
    ("between", "a not in (1, 10)"),
    ("null", "a is null"), ("null", "case when a is null then 0 else a end"),
    ("null", "coalesce(a, 99)"),
    ("s", "upper(s)"), ("s", "length(s)"), ("s", "s like '%an%'"),
    ("s", "s = 'cherry'"), ("s", "substr(s, 2, 3)"),
    ("sorted", "s >= 'b'"),
    ("d", "d >= DATE '1994-01-01'"), ("d", "year(d)"), ("d", "month(d)"),
    ("d", "day(d)"),
    ("dec", "p * disc"), ("dec", "p * (1.00::decimal(3,2) - disc)"),
    ("cast", "cast(a as double)"), ("cast", "cast(x as bigint)"),
    ("cast", "cast('2020-05-01' as date)"),
    ("cse", "sqrt(a) + sqrt(a)"),
]


def _evaluated_rows(value, n, capacity):
    """(values or None per row, dtype name) of an evaluated value: the
    dictionary's strings for a string result."""
    data = np.asarray(jax.device_get(value.full_data(capacity))) \
        if not isinstance(value.data, torch.Tensor) \
        else value.full_data(capacity).numpy()
    valid = value.full_validity(capacity)
    valid = valid.numpy() if isinstance(valid, torch.Tensor) \
        else np.asarray(jax.device_get(valid))
    data, valid = data[:n], valid[:n]
    if value.dictionary is not None:
        data = value.dictionary.values[data]
    return [d.item() if hasattr(d, "item") else d if v else None
            for d, v in zip(data, valid)], str(value.dtype)


def _assert_same_rows(got, want, what):
    """Equal rows and type; DOUBLE rows within the reference oracle's
    relative tolerance (tests/tpch_sql.py's default, 1e-9): torch's CPU
    ``sqrt`` of 2.0 is one ulp from the correctly rounded value."""
    assert got[1] == want[1], what
    if got[1] != "double":
        assert got[0] == want[0], what
        return
    assert [v is None for v in got[0]] == [v is None for v in want[0]]
    g = np.array([v for v in got[0] if v is not None], dtype=np.float64)
    w = np.array([v for v in want[0] if v is not None], dtype=np.float64)
    np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=what)


@pytest.mark.parametrize("table, text", EVAL_CASES)
def test_evaluate_matches_reference(table, text):
    from velox_tpu.expression import evaluate as jevaluate
    from velox_tpu_torch.expression import evaluate as tevaluate
    t = _EVAL_TABLES[table]
    jbatch, tbatch = jd.from_arrow(t), td.from_arrow(t, device="cpu")
    want = jevaluate(jparse(text, jbatch.row_type()), jbatch)
    got = tevaluate(tparse(text, tbatch.row_type()), tbatch)
    _assert_same_rows(_evaluated_rows(got, t.num_rows, tbatch.capacity),
                      _evaluated_rows(want, t.num_rows, jbatch.capacity),
                      text)


def test_compile_exprs_matches_evaluate_and_reference():
    from velox_tpu.expression import compile_exprs as jcompile
    from velox_tpu_torch.expression import compile_exprs as tcompile
    from velox_tpu_torch.expression import evaluate as tevaluate
    t = _EVAL_TABLES["dec"]
    texts = ["p * disc", "p + disc", "p * disc", "p > 1.50"]
    jbatch, tbatch = jd.from_arrow(t), td.from_arrow(t, device="cpu")
    jset = jcompile([jparse(x, jbatch.row_type()) for x in texts],
                    jbatch.row_type())
    tset = tcompile([tparse(x, tbatch.row_type()) for x in texts],
                    tbatch.row_type())
    assert isinstance(tset, TExprSet)
    for text, jv, tv in zip(texts, jset.eval_batch(jbatch),
                            tset.eval_batch(tbatch)):
        got = _evaluated_rows(tv, 3, tbatch.capacity)
        _assert_same_rows(got, _evaluated_rows(jv, 3, jbatch.capacity),
                          text)
        assert got == _evaluated_rows(
            tevaluate(tparse(text, tbatch.row_type()), tbatch), 3,
            tbatch.capacity), text
