"""Casts, CASE/coalesce, arithmetic and math, dictionary strings and date
parts of the torch port against the JAX reference.

Each expression is parsed by each package's own parser over the same row
type and evaluated over identical batches made from a numpy seed: nulls,
zero divisors, long decimals with a nonzero high limb and values near
2^53, dictionary strings with regex metacharacters, and every date from
1992-01-01 to 1998-12-31 (leap days included) with a few before 1970.
Integers, decimals, dates, booleans and string ids must be equal, with
the storage dtype and the per-row error channel; doubles agree within the
reference oracle's relative tolerance (tests/tpch_sql.py ``TOLERANCES``).
A dictionary-string result must come with the reference's dictionary.
"""

import datetime

import numpy as np
import pytest
import torch

from test_torch_expression import _assert_same_column, _limbs_np, _np
from tpch_sql import TOLERANCES
from velox_tpu import types as JT
from velox_tpu.expression.eval import ExprSet as JExprSet
from velox_tpu.parse.parser import parse_expression as jparse
from velox_tpu.vector import device as jd
from velox_tpu_torch import types as TT
from velox_tpu_torch.common.errors import VeloxUserError
from velox_tpu_torch.expression.eval import ExprSet as TExprSet
from velox_tpu_torch.parse.parser import parse_expression as tparse
from velox_tpu_torch.vector import device as td

import jax.numpy as jnp

torch.set_num_threads(1)

REL_TOL = TOLERANCES.get(0, (1e-9, 1))[0]
EPOCH = datetime.date(1970, 1, 1)
D92 = (datetime.date(1992, 1, 1) - EPOCH).days
D99 = (datetime.date(1999, 1, 1) - EPOCH).days
CAP = D99 - D92 + 11  # every day of 1992-1998 and 11 days before 1970
N_ACTIVE = CAP - 7
WORDS = sorted(["apple", "  banana ", "cherry  ", "a.b", "a+b", "(x)",
                "c*d", "e?f", "[g]", "h|i", "^j$", "k\\l", "50%", "a_b",
                "PROMO BRUSHED", "ECONOMY BRASS", "Brand#23", "", "13-555",
                "31-200"])
NUMS = sorted(["12", "-7", "0", "1995-03-15", "2.5", "x1"])
SCHEMA = [  # name, type, nullable
    ("l_quantity", "decimal(12,2)", False), ("k", "bigint", False),
    ("j", "bigint", True), ("i", "integer", True), ("d", "double", True),
    ("e", "double", False), ("p", "decimal(12,2)", True),
    ("q", "decimal(38,2)", True), ("b", "boolean", False),
    ("s", "varchar", True), ("n", "varchar", False), ("dt", "date", False),
]


def _arrays(seed: int):
    rng = np.random.default_rng(seed)
    big = [int(x) * 10 ** 12 + int(y) for x, y in zip(
        rng.integers(-10 ** 15, 10 ** 15, CAP),
        rng.integers(0, 10 ** 12, CAP))]
    near53 = [int(s) * (2 ** 53 + int(o)) for s, o in zip(
        rng.choice([-1, 1], CAP), rng.integers(-3, 4, CAP))]
    q = [b if r % 3 == 0 else (n if r % 3 == 1 else int(x))
         for r, (b, n, x) in enumerate(zip(
             big, near53, rng.integers(-10 ** 7, 10 ** 7, CAP)))]
    qlo, qhi = _limbs_np(q)
    d = rng.normal(0, 50, CAP)
    d[::17] = 0.0
    d[::23] = np.round(d[::23], 1) + 0.05  # ties for round()
    days = np.concatenate([np.arange(D92, D99), rng.integers(-400, 0, 11)])
    j = rng.integers(-10 ** 12, 10 ** 12, CAP)
    j[::5] = 0
    i = rng.integers(-20, 20, CAP)
    cols = {
        "l_quantity": (rng.integers(100, 5001, CAP).astype(np.int32), None),
        "k": (rng.integers(-10 ** 15, 10 ** 15, CAP), None),
        "j": (j, rng.random(CAP) > 0.15),
        "i": (i.astype(np.int32), rng.random(CAP) > 0.15),
        "d": (d, rng.random(CAP) > 0.1),
        "e": (rng.normal(0, 3, CAP).round(1), None),
        "p": (rng.integers(-10 ** 6, 10 ** 6, CAP), rng.random(CAP) > 0.15),
        "q": (qlo, rng.random(CAP) > 0.15, qhi),
        "b": (rng.random(CAP) > 0.5, None),
        "s": (rng.integers(0, len(WORDS), CAP).astype(np.int32),
              rng.random(CAP) > 0.1),
        "n": (rng.integers(0, len(NUMS), CAP).astype(np.int32), None),
        "dt": (days.astype(np.int32), None),
    }
    return cols, np.arange(CAP) < N_ACTIVE, q


def _batches(seed: int, keep=None):
    arrays, mask, q = _arrays(seed)
    if keep is not None:
        arrays = {n: a for n, a in arrays.items() if n in keep}
    dicts = {"s": WORDS, "n": NUMS}
    jcols, tdt = {}, {}
    for name, typ, _ in SCHEMA:
        if name not in arrays:
            continue
        data, validity, *kids = arrays[name]
        jcols[name] = jd.DeviceColumn(
            jnp.asarray(data),
            None if validity is None else jnp.asarray(validity),
            JT.parse_type(typ),
            jd.Dictionary(dicts[name]) if name in dicts else None,
            tuple(jd.DeviceColumn(jnp.asarray(k), None, JT.BIGINT, None)
                  for k in kids))
        tdt[name] = TT.parse_type(typ)
    jbatch = jd.DeviceBatch(jcols, jnp.asarray(mask))
    tbatch = td.batch_from_numpy(
        arrays, mask, tdt,
        {n: td.Dictionary(v) for n, v in dicts.items() if n in arrays},
        device="cpu")
    return jbatch, tbatch, arrays, q


def _row_types():
    names = [s[0] for s in SCHEMA]
    return (JT.row(names, [JT.parse_type(s[1]) for s in SCHEMA]),
            TT.row(names, [TT.parse_type(s[1]) for s in SCHEMA]))


def _eval_both(text, seed=0):
    jrt, trt = _row_types()
    je, te = jparse(text, jrt), tparse(text, trt)
    assert str(te.dtype) == str(je.dtype), text
    jbatch, tbatch, arrays, q = _batches(seed)
    jsink, tsink = [], []
    jv = JExprSet([je], jrt).eval_batch(jbatch, err_sink=jsink)[0]
    tv = TExprSet([te], trt).eval_batch(tbatch, err_sink=tsink)[0]
    return jv, tv, jsink[0], tsink[0], arrays, q


def _assert_matches(text, seed=0):
    jv, tv, jerr, terr, _, _ = _eval_both(text, seed)
    jcol, tcol = jv.to_column(CAP), tv.to_column(CAP)
    if tcol.dtype.is_floating:
        jdata, tdata = _np(jcol.data), tcol.data.numpy()
        assert tdata.dtype == jdata.dtype, text
        valid = (np.ones(CAP, bool) if jcol.validity is None
                 else _np(jcol.validity))
        np.testing.assert_allclose(tdata[valid], jdata[valid],
                                   rtol=REL_TOL, atol=0, err_msg=text)
        assert (tcol.validity is None) == (jcol.validity is None), text
        if jcol.validity is not None:
            np.testing.assert_array_equal(tcol.validity.numpy(), valid)
    else:
        _assert_same_column(tcol, jcol, text)
    assert (terr is None) == (jerr is None), text
    if jerr is not None:
        np.testing.assert_array_equal(
            np.broadcast_to(terr.numpy(), (CAP,)),
            np.broadcast_to(_np(jerr), (CAP,)), err_msg=text)
    if jv.dictionary is not None or tv.dictionary is not None:
        assert list(tv.dictionary.values) == list(jv.dictionary.values), text
    return tv


CASTS = [
    "cast(l_quantity as double)", "cast(p as double)", "cast(q as double)",
    "cast(q as real)", "cast(k as double)", "cast(i as bigint)",
    "cast(k as integer)", "cast(d as bigint)", "cast(d as integer)",
    "cast(d as decimal(12,2))", "cast(e as decimal(12,0))",
    "cast(p as decimal(12,0))", "cast(p as decimal(14,4))",
    "cast(p as decimal(12,1))", "cast(l_quantity as bigint)",
    "cast(p as integer)", "cast(i as decimal(12,2))",
    "cast(p as decimal(38,2))", "cast(q as decimal(38,4))",
    "cast(i as decimal(38,2))", "cast(k as decimal(38,0))",
    "cast(b as integer)", "cast(i as boolean)", "cast(d as boolean)",
    "cast(dt as timestamp)", "cast(cast(dt as timestamp) as date)",
    "cast('1995-03-15' as date)", "cast('42' as bigint)",
    "cast('2.5' as double)", "cast('12.345' as decimal(12,2))",
    "dt < cast('1995-03-15' as date)", "try_cast(n as bigint)",
    "try_cast(n as double)", "try_cast(n as date)",
    "try_cast(n as decimal(12,2))",
    "cast(q as double) > cast(p as double) * 0.0001",
]
CASE_COALESCE = [
    "if(i > 0, k, j)", "if(i > 0, k)", "case when i > 0 then 1 else 0 end",
    "case when s = 'apple' then p else 0 end",
    "if(i > 0, s, 'cherry  ')", "if(b, s, 'not a word')",
    "case when i > 0 then d else e end", "coalesce(j, k)",
    "coalesce(i, 0)", "coalesce(j, i, 7)", "coalesce(s, 'apple')",
    "coalesce(d, e, 1.5)", "coalesce(p, l_quantity)",
    "if(i is null, 1, 2)", "if(d > 0, p, l_quantity)",
]
ARITH = [
    "k / i", "i / 3", "k / j", "i % 3", "k % j", "j % i", "try(k / j)",
    "try(k % i)", "try(j / i) + 1", "d / e", "d / 0.0", "d % e",
    "e % 2.5", "p / l_quantity", "q / 3", "q / p", "d / p", "p % 7",
    "p % l_quantity", "cast(q as double) / cast(p as double)",
    "-p", "-q", "-i", "-d", "-k", "abs(p)", "abs(i)", "abs(d)", "abs(k)",
]
MATH = [
    "sqrt(abs(d))", "cbrt(d)", "cbrt(p)", "ln(abs(d) + 1)",
    "log2(abs(d) + 1)", "log10(abs(d) + 1)", "exp(d / 100)", "sin(d)",
    "cos(d)", "tan(d)", "ceil(d)", "ceiling(e)", "floor(d)", "ceil(p)",
    "floor(p)", "ceil(i)", "floor(k)", "round(d)", "round(d, 2)",
    "round(e, 0)", "round(p, 1)", "round(p)", "round(i)", "power(d, 2)",
    "pow(abs(d), 0.5)", "power(i, 3)", "sign(d)", "sign(i)", "sign(p)",
    "greatest(i, k)", "least(d, 0.5)", "greatest(p, l_quantity)",
    "least(i, j, k)",
]
STRINGS = [
    "substr(s, 2)", "substr(s, 1, 2)", "substr(s, -3)", "substr(s, -3, 2)",
    "substring(s, 0, 2)", "substr(s, -40, 3)", "substr(s, 3, 0)",
    "s like '%a%'", "s like 'a_b'", "s like '%.%'", "s like 'a.b'",
    "s like '(x)'", "s like 'a+b'", "s like '%*%'", "s like 'e?f'",
    "s like '[g]'", "s like 'h|i'", "s like '^j$'", "s like 'k\\l'",
    "s like '50%'", "s like '%BRASS'", "s like 'PROMO%'", "s like ''",
    "s like '%'", "s like '_'", "not (s like 'Brand#2_')",
    "lower(s)", "upper(s)", "length(s)", "trim(s)", "ltrim(s)", "rtrim(s)",
    "reverse(s)", "concat(s, '-x')", "concat('p:', s)",
    "replace(s, 'a', 'o')", "replace(s, 'a')", "starts_with(s, 'a')",
    "ends_with(s, ' ')", "strpos(s, 'a')",
    "substr(s, 1, 2) in ('13', '31', 'ap')",
    "substr(s, 1, 1) = 'a'", "upper(s) = 'APPLE'",
]
DATES = [
    "year(dt)", "month(dt)", "day(dt)", "quarter(dt)", "day_of_week(dt)",
    "dow(dt)", "day_of_year(dt)", "doy(dt)", "year(dt) = 1996",
    "year(cast(dt as timestamp))", "day_of_year(cast(dt as timestamp))",
]


@pytest.mark.parametrize("text", CASTS)
def test_cast_matches_reference(text):
    _assert_matches(text)


@pytest.mark.parametrize("text", CASE_COALESCE)
def test_if_and_coalesce_match_reference(text):
    _assert_matches(text)


@pytest.mark.parametrize("text", ARITH)
def test_division_modulus_and_negation_match_reference(text):
    _assert_matches(text)


@pytest.mark.parametrize("text", MATH)
def test_math_matches_reference(text):
    _assert_matches(text)


@pytest.mark.parametrize("text", STRINGS)
def test_dictionary_string_function_matches_reference(text):
    _assert_matches(text)


@pytest.mark.parametrize("text", DATES)
@pytest.mark.parametrize("seed", [0, 1])
def test_date_part_matches_reference(text, seed):
    _assert_matches(text, seed)


def test_date_parts_equal_python_dates():
    """Every day of 1992-1998 and a few before 1970, against datetime."""
    _, trt = _row_types()
    _, tbatch, arrays, _ = _batches(0)
    days = arrays["dt"][0]
    dates = [EPOCH + datetime.timedelta(days=int(x)) for x in days]
    want = {
        "year": [x.year for x in dates], "month": [x.month for x in dates],
        "day": [x.day for x in dates],
        "quarter": [(x.month - 1) // 3 + 1 for x in dates],
        "day_of_week": [x.isoweekday() for x in dates],
        "day_of_year": [x.timetuple().tm_yday for x in dates],
    }
    assert sum(x.month == 2 and x.day == 29 for x in dates) == 2
    for fn, vals in want.items():
        got = TExprSet([tparse(f"{fn}(dt)", trt)], trt).eval_batch(
            tbatch)[0]
        assert got.data.dtype == torch.int64
        assert got.data.tolist() == vals, fn


def _long_ints(col):
    lo = col.data.numpy().astype(np.int64)
    hi = col.children[0].data.numpy()
    return [(int(h) << 64) | (int(x) & (2 ** 64 - 1))
            for x, h in zip(lo, hi)]


@pytest.mark.parametrize("text,fn", [
    ("-q", lambda v: -v), ("abs(q)", abs),
    ("cast(q as decimal(38,4))", lambda v: v * 100),
    ("if(i > 0, q, cast(p as decimal(38,2)))", None),
    ("if(i > 0, q, p)", None),
    ("coalesce(q, cast(p as decimal(38,2)))", None),
])
def test_long_decimal_results_carry_both_limbs(text, fn):
    """DECIMAL(38) results against Python ints, both limbs (the
    reference's abs, if and coalesce keep the low limb alone;
    ROADMAP C)."""
    _, trt = _row_types()
    _, tbatch, arrays, q = _batches(0)
    v = TExprSet([tparse(text, trt)], trt).eval_batch(tbatch)[0]
    got = _long_ints(v.to_column(CAP))
    p = [int(x) for x in arrays["p"][0]]
    if fn is not None:
        want = [fn(x) for x in q]
    elif text.startswith("if"):
        i, iv = arrays["i"]
        want = [a if (ok and x > 0) else b
                for a, b, x, ok in zip(q, p, i, iv)]
    else:
        want = [a if ok else b for a, b, ok in zip(q, p, arrays["q"][1])]
    valid = (np.ones(CAP, bool) if v.validity is None
             else v.to_column(CAP).validity.numpy())
    assert [g for g, ok in zip(got, valid) if ok] == \
        [w for w, ok in zip(want, valid) if ok]
    assert valid.any()


def test_long_decimal_to_double_near_2_53():
    """hi * 2^64 + unsigned(lo), then the scale: the same double as the
    exact value's nearest, where a high limb is nonzero or the value lies
    near 2^53."""
    _, trt = _row_types()
    _, tbatch, arrays, q = _batches(0)
    v = TExprSet([tparse("cast(q as double)", trt)], trt).eval_batch(
        tbatch)[0]
    got = v.data.numpy()
    hi = arrays["q"][2]
    assert (hi > 0).any() and (hi < -1).any()
    assert any(abs(x) > 2 ** 53 for x in q)
    for g, x, h in zip(got, q, hi):
        lo = x - (int(h) << 64)
        assert g == (float(int(h)) * 2.0 ** 64 + float(lo)) / 100.0


@pytest.mark.parametrize("text", ["k / i", "i % 3 + k / j", "j % i"])
def test_division_by_zero_is_a_checked_error(text):
    """/0 and %0 flag their rows; under TRY they become NULL instead."""
    _, trt = _row_types()
    _, tbatch, _, _ = _batches(0)
    sink = []
    TExprSet([tparse(text, trt)], trt).eval_batch(tbatch, err_sink=sink)
    assert 0 < int(sink[0].sum()) < CAP
    sink = []
    v = TExprSet([tparse(f"try({text})", trt)], trt).eval_batch(
        tbatch, err_sink=sink)[0]
    assert sink[0] is None
    assert not v.validity.all()


def test_division_by_zero_fails_the_query():
    from velox_tpu_torch.exec.task import QueryCtx, Task
    from velox_tpu_torch.testing.plan_builder import PlanBuilder
    import pyarrow as pa
    table = pa.table({"a": pa.array([4, 5], pa.int64()),
                      "b": pa.array([2, 0], pa.int64())})
    plan = PlanBuilder().values([table]).project(["a / b as c"]).plan()
    with pytest.raises(VeloxUserError, match="1 row"):
        Task(plan, QueryCtx("cpu")).run()
    plan = PlanBuilder().values([table]).project(
        ["try(a / b) as c"]).plan()
    assert Task(plan, QueryCtx("cpu")).run()["c"].to_pylist() == [2, None]


def _raw_s(jbatch, tbatch, arrays):
    """Both batches with ``s`` as a raw byte-matrix column of the same
    values (vector/strings.py in each package)."""
    from velox_tpu.vector import strings as JS
    from velox_tpu_torch.vector import strings as TS
    ids, valid = arrays["s"][:2]
    vals = [WORDS[i] if v else None for i, v in zip(ids, valid)]
    b, ln = TS.pack_pylist(vals, CAP)
    tbatch.columns["s"] = TS.raw_column(torch.from_numpy(b),
                                        torch.from_numpy(ln),
                                        torch.from_numpy(valid))
    jbatch.columns["s"] = JS.raw_column(jnp.asarray(b), jnp.asarray(ln),
                                        jnp.asarray(valid))


@pytest.mark.parametrize("text", ["substr(s, 1, 2)", "s like '%a%'",
                                  "cast(s as bigint)", "length(s)"])
def test_raw_string_input_raises_naming_the_roadmap(text):
    """Raw (byte-matrix) string input now runs through the raw forms and
    equals the reference; a cast from a raw column raises in both, naming
    no ROADMAP item."""
    jrt, trt = _row_types()
    jbatch, tbatch, arrays, _ = _batches(0)
    _raw_s(jbatch, tbatch, arrays)
    texpr = TExprSet([tparse(text, trt)], trt)
    if text.startswith("cast"):
        with pytest.raises(NotImplementedError) as err:
            texpr.eval_batch(tbatch)
        assert "A.6" not in str(err.value)
        with pytest.raises(NotImplementedError):
            JExprSet([jparse(text, jrt)], jrt).eval_batch(jbatch)
        return
    tv = texpr.eval_batch(tbatch)[0]
    jv = JExprSet([jparse(text, jrt)], jrt).eval_batch(jbatch)[0]
    live = np.asarray(arrays["s"][1]) & (np.arange(CAP) < N_ACTIVE)
    np.testing.assert_array_equal(tv.validity.numpy()[live],
                                  _np(jv.validity)[live])
    np.testing.assert_array_equal(tv.data.numpy()[live], _np(jv.data)[live])
    if tv.children:  # a raw result: the lengths too
        np.testing.assert_array_equal(tv.children[0].data.numpy()[live],
                                      _np(jv.children[0].data)[live])


@pytest.mark.parametrize("text", ["d * i", "d * 2.5", "i * d", "d * p"])
def test_multiply_long_by_short_exact(text):
    """DECIMAL(38) x a short decimal or an integer through the limbs
    (ops/int128.py ``mul128_i64``): the reference's limbs and exact
    Python integers."""
    import decimal as pydec
    from velox_tpu.exec.task import Task as JTask
    from velox_tpu.testing.plan_builder import PlanBuilder as JPB
    from velox_tpu_torch.exec.task import QueryCtx, Task
    from velox_tpu_torch.testing.plan_builder import PlanBuilder as TPB
    import pyarrow as pa
    rng = np.random.default_rng(3)
    ints = [10 ** 25, -(10 ** 24), 777, None, 2 ** 100 + 12345, -(2 ** 90)]
    ints += [int(x) * 10 ** 20 + int(y) for x, y in zip(
        rng.integers(-10 ** 12, 10 ** 12, 50), rng.integers(0, 10 ** 12, 50))]
    n = len(ints)
    with pydec.localcontext() as c:
        c.prec = 50
        d = [None if v is None else pydec.Decimal(v).scaleb(-4)
             for v in ints]
    i_vals = rng.integers(-10 ** 6, 10 ** 6, n)
    p_vals = [pydec.Decimal(int(x)).scaleb(-2)
              for x in rng.integers(-10 ** 6, 10 ** 6, n)]
    t = pa.table({"d": pa.array(d, pa.decimal128(38, 4)),
                  "i": pa.array(i_vals, pa.int64()),
                  "p": pa.array(p_vals, pa.decimal128(12, 2))})
    want = JTask(JPB().values([t]).project([f"{text} as m"]).plan()).run()
    got = Task(TPB().values([t]).project([f"{text} as m"]).plan(),
               QueryCtx("cpu")).run()
    assert got.schema == want.schema
    assert got.column("m").to_pylist() == want.column("m").to_pylist()
    other = {"d * i": i_vals, "i * d": i_vals,
             "d * 2.5": [pydec.Decimal("2.5")] * n, "d * p": p_vals}[text]
    with pydec.localcontext() as c:
        c.prec = 60
        exact = [None if a is None else a * pydec.Decimal(int(b)
                                                          if not isinstance(
                                                              b, pydec.Decimal)
                                                          else b)
                 for a, b in zip(d, other)]
    assert got.column("m").to_pylist() == exact


def test_multiply_long_by_long_raises():
    import decimal as pydec
    import pyarrow as pa
    from velox_tpu.exec.task import Task as JTask
    from velox_tpu.testing.plan_builder import PlanBuilder as JPB
    from velox_tpu_torch.exec.task import QueryCtx, Task
    from velox_tpu_torch.testing.plan_builder import PlanBuilder as TPB
    t = pa.table({"d": pa.array([pydec.Decimal("1.5")],
                                pa.decimal128(38, 2))})
    with pytest.raises(NotImplementedError, match="int128"):
        JTask(JPB().values([t]).project(["d * d as m"]).plan()).run()
    with pytest.raises(NotImplementedError, match="int128"):
        Task(TPB().values([t]).project(["d * d as m"]).plan(),
             QueryCtx("cpu")).run()


@pytest.mark.parametrize("text", ["q + q", "q - p", "p + q", "q - 1"])
def test_long_decimal_plus_minus_match_reference(text):
    _assert_matches(text)


@pytest.mark.parametrize("text,fn", [
    ("floor(q)", lambda v: v // 100), ("ceil(q)", lambda v: -(-v // 100)),
    ("round(q)", lambda v: (abs(v) + 50) // 100 * 100 * (1 if v >= 0
                                                         else -1)),
    ("round(q, 1)", lambda v: (abs(v) + 5) // 10 * 10 * (1 if v >= 0
                                                         else -1)),
    ("sign(q)", lambda v: (v > 0) - (v < 0))])
def test_long_decimal_rounding_is_exact(text, fn):
    """ceil/floor/round/sign over DECIMAL(38,2) through both limbs, against
    Python integers (the reference rounds the low limb alone; ROADMAP C)."""
    _, trt = _row_types()
    _, tbatch, _, q = _batches(0)
    tv = TExprSet([tparse(text, trt)], trt).eval_batch(tbatch)[0]
    col = tv.to_column(CAP)
    got = (col.data.numpy().tolist() if not col.dtype.is_long_decimal
           else _long_ints(col))
    live = (np.arange(CAP) < N_ACTIVE) & np.asarray(
        tbatch.columns["q"].validity)
    for g, v, ok in zip(got, q, live):
        if ok:
            assert g == fn(v), (text, v, g)
