"""Raw (byte-matrix) strings of the torch port against the JAX reference:
the counterparts of tests/test_raw_strings.py (all but the hive scan, which
waits for the connector), plus the device-side packing, every string
function in both encodings against pyarrow, the reference's raw-encoding
faults, the "auto" choice, compares, and raw sort, TopN, group-by and join
keys through both engines.

Each plan is built by each package's own PlanBuilder over the same
numpy-seeded pyarrow tables and run by each package's Task; the two Arrow
results must hold the same rows. Where the reference is wrong (ROADMAP C)
the port is held to pyarrow or Python instead, and the test shows the
reference's answer differs.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from velox_tpu.exec.batch_utils import (
    compact as jcompact, concat_batches as jconcat, take as jtake,
)
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.vector import device as JD
from velox_tpu.vector import strings as JS
from velox_tpu_torch.exec import sort as TSort
from velox_tpu_torch.exec.batch_utils import compact, concat_batches, take
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.vector import device as D
from velox_tpu_torch.vector import strings as S

torch.set_num_threads(1)

CPU = QueryCtx("cpu")
CPUD = torch.device("cpu")
ALPHA = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789 _-"))
# non-ASCII values where utf8proc's mapping and Python's differ, where
# case changes the byte length, and Unicode whitespace
UNICODE = ["straße", "ﬁ", "Élan", "ǅx", "Ω", "naïve", "İstanbul", "ẞig",
           "　pad　", "\tTab ", " a b ", "ßßß", "日本語", "éx",
           "ΣΑΣ", "", "x", "Ǆ", "ǈ", " nb"]


def _rand_strings(n, seed=0, max_len=24, with_nulls=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = rng.randint(0, max_len + 1)
        s = "".join(rng.choice(ALPHA, ln))
        out.append(None if (with_nulls and rng.rand() < 0.15) else s)
    return out


def _rows(table: pa.Table):
    cols = table.column_names
    rows = list(zip(*(table.column(c).to_pylist() for c in cols)))
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None
                                             else 0) for v in r))


def _both(build, ordered=False):
    """Run ``build(PlanBuilder class)``'s plan through both engines and
    return the port's table, after checking it equals the reference's."""
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.schema == want.schema
    if ordered:
        assert got.to_pylist() == want.to_pylist()
    else:
        assert _rows(got) == _rows(want)
    return got


def _col(vals, cap, enc="raw"):
    return D.column_from_arrow(pa.array(vals, pa.string()), cap,
                               string_encoding=enc, device=CPUD)


def _batch(vals, cap, enc="raw"):
    return D.from_arrow(pa.table({"s": pa.array(vals, pa.string())}), cap,
                        string_encoding=enc, device=CPUD)


def _same_raw(tcol, jcol):
    np.testing.assert_array_equal(tcol.data.numpy(), np.asarray(jcol.data))
    np.testing.assert_array_equal(S.lens_of(tcol).numpy(),
                                  np.asarray(JS.lens_of(jcol)))


# ---------------------------------------------------------------------------
# counterparts of tests/test_raw_strings.py
# ---------------------------------------------------------------------------

def test_pack_arrow_roundtrip():
    vals = _rand_strings(500, with_nulls=True)
    arr = pa.array(vals, type=pa.string())
    col = _col(vals, 512)
    jcol = JD.column_from_arrow(arr, 512, string_encoding="raw")
    assert S.is_raw(col) and col.data.shape == (512, 32)
    _same_raw(col, jcol)
    np.testing.assert_array_equal(col.validity.numpy(),
                                  np.asarray(jcol.validity))
    batch = D.DeviceBatch({"s": col}, torch.arange(512) < 500)
    assert D.to_arrow(batch).column("s").to_pylist() == vals


def test_auto_encoding_picks_raw_for_high_cardinality():
    vals = [f"user-{i:06d}" for i in range(400)]
    col = _col(vals, 512, "auto")
    assert S.is_raw(col)
    assert JS.is_raw(JD.column_from_arrow(pa.array(vals), 512,
                                          string_encoding="auto"))
    low = ["red", "green", "blue"] * 100
    col2 = _col(low, 512, "auto")
    assert not S.is_raw(col2) and col2.dictionary is not None


def test_concat_mixed_widths():
    a = pa.table({"s": pa.array(["short", "tiny"])})
    b = pa.table({"s": pa.array(["x" * 60, "a-much-longer-string-here"])})
    ta, tb = (D.from_arrow(x, 4, string_encoding="raw", device=CPUD)
              for x in (a, b))
    assert ta.columns["s"].data.shape[1] != tb.columns["s"].data.shape[1]
    merged = concat_batches([ta, tb])
    jmerged = jconcat([JD.from_arrow(x, 4, string_encoding="raw")
                       for x in (a, b)])
    _same_raw(merged.columns["s"], jmerged.columns["s"])
    assert D.to_arrow(merged).column("s").to_pylist() == [
        "short", "tiny", "x" * 60, "a-much-longer-string-here"]


def test_take_and_compact_carry_lens():
    vals = _rand_strings(100, seed=3)
    t = pa.table({"s": pa.array(vals)})
    batch = D.from_arrow(t, 128, string_encoding="raw", device=CPUD)
    jbatch = JD.from_arrow(t, 128, string_encoding="raw")
    idx = np.concatenate([np.arange(99, -1, -1), np.zeros(28)]).astype(
        np.int32)
    valid = np.arange(128) < 100
    got = take(batch, torch.from_numpy(idx).long(), torch.from_numpy(valid))
    jgot = jtake(jbatch, jnp.asarray(idx), jnp.asarray(valid))
    _same_raw(got.columns["s"], jgot.columns["s"])
    assert D.to_arrow(got).column("s").to_pylist() == vals[::-1]
    even = np.arange(128) % 2 == 0
    masked = D.DeviceBatch(batch.columns, batch.mask & torch.from_numpy(even))
    jmasked = JD.DeviceBatch(jbatch.columns, jbatch.mask & jnp.asarray(even))
    c, jc = compact(masked), jcompact(jmasked)
    _same_raw(c.columns["s"], jc.columns["s"])
    assert D.to_arrow(c).column("s").to_pylist() == vals[0::2]


def _packed(vals, cap, width=None):
    b, ln = S.pack_pylist(vals, cap, width)
    jb, jln = JS.pack_pylist(vals, cap, width)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(ln, jln)
    return (torch.from_numpy(b), torch.from_numpy(ln),
            jnp.asarray(jb), jnp.asarray(jln))


def _unpack(b, ln):
    return S.unpack_numpy(np.asarray(b), np.asarray(ln))


def test_kernels_against_python():
    vals = _rand_strings(300, seed=5)
    b, ln, jb, jln = _packed(vals, 320)
    n = len(vals)
    np.testing.assert_array_equal(S.length_bytes(ln).numpy()[:n],
                                  [len(v) for v in vals])
    np.testing.assert_array_equal(S.length_chars(b, ln).numpy(),
                                  np.asarray(JS.length_chars(jb, jln)))
    up, ul = S.upper(b, ln)
    assert _unpack(up, ul)[:n] == [v.upper() for v in vals]
    np.testing.assert_array_equal(up.numpy(),
                                  np.asarray(JS.upper_ascii(jb, jln)[0]))
    t, tl = S.trim(b, ln)
    jt, jtl = JS.trim(jb, jln)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert _unpack(t, tl)[:n] == [v.strip(" ") for v in vals]
    start = torch.full((320,), 2, dtype=torch.int32)
    length = torch.full((320,), 3, dtype=torch.int32)
    sb, sl = S.substr(b, ln, start, length)
    jsb, jsl = JS.substr(jb, jln, jnp.full((320,), 2, jnp.int32),
                         jnp.full((320,), 3, jnp.int32))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    np.testing.assert_array_equal(sl.numpy(), np.asarray(jsl))
    assert _unpack(sb, sl)[:n] == [v[1:4] for v in vals]
    for fn, jfn, needle in ((S.starts_with, JS.starts_with, b"ab"),
                            (S.ends_with, JS.ends_with, b"z"),
                            (S.strpos_chars, JS.strpos_chars, b"a")):
        np.testing.assert_array_equal(fn(b, ln, needle).numpy(),
                                      np.asarray(jfn(jb, jln, needle)))
    np.testing.assert_array_equal(S.strpos_chars(b, ln, b"a").numpy()[:n],
                                  [v.find("a") + 1 for v in vals])
    rb, rl = S.reverse(b, ln)
    np.testing.assert_array_equal(rb.numpy(),
                                  np.asarray(JS.reverse_bytes(jb, jln)[0]))
    assert _unpack(rb, rl)[:n] == [v[::-1] for v in vals]


def test_concat_kernel():
    ab, al, jab, jal = _packed(["foo", "", "léft"], 4)
    bb, bl, jbb, jbl = _packed(["bar", "x", "-ri"], 4)
    cb, cl = S.concat(ab, al, bb, bl)
    jcb, jcl = JS.concat(jab, jal, jbb, jbl)
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(jcl))
    assert _unpack(cb, cl)[:3] == ["foobar", "x", "léft-ri"]


def test_compare_kernels():
    vals = ["apple", "apples", "banana", "", "apple", "é", "e"]
    other = ["apple", "apple", "banan", "a", "apricot", "f", "é"]
    ab, al, jab, jal = _packed(vals, 8)
    bb, bl, jbb, jbl = _packed(other, 8, 32)  # across size classes
    for got, want, py in (
            (S.equal(ab, al, bb, bl), JS.equal(jab, jal, jbb, jbl),
             [a == b for a, b in zip(vals, other)]),
            (S.less(ab, al, bb, bl), JS.less(jab, jal, jbb, jbl),
             [a.encode() < b.encode() for a, b in zip(vals, other)]),
            (S.less(ab, al, bb, bl, True), JS.less(jab, jal, jbb, jbl, True),
             [a.encode() <= b.encode() for a, b in zip(vals, other)])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy()[:len(vals)], py)


@pytest.mark.parametrize("pattern,esc", [
    ("abc", None), ("ab%", None), ("%yz", None), ("%mid%", None),
    ("a%z", None), ("a%m%z", None), ("", None), ("%", None),
    ("100!%%", "!"),
])
def test_like_kernel(pattern, esc):
    vals = ["abc", "abz", "xyz", "a-mid-z", "amz", "", "100%x", "100%",
            "za%z", "a"]
    b, ln, jb, jln = _packed(vals, 16)
    got = S.like(b, ln, pattern, esc).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.like(jb, jln, pattern,
                                                          esc)))


def test_sort_key_words_order():
    vals = ["", "a", "ab", "abc", "b", "aa", "z" * 20, "z" * 19, "é", "e"]
    b, ln, jb, jln = _packed(vals, 16)
    words, bits = S.sort_key_words(b, ln)
    jwords, jbits = JS.sort_key_words(jb, jln)
    assert bits == jbits
    for w, jw in zip(words, jwords):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw)
                                      .astype(np.int64))
    keys = list(zip(*[w.numpy()[:len(vals)] for w in words]))
    order_w = sorted(range(len(vals)), key=lambda i: keys[i])
    order_s = sorted(range(len(vals)), key=lambda i: vals[i].encode())
    assert order_w == order_s


def _users(n=500, seed=11):
    rng = np.random.RandomState(seed)
    return pa.table({
        "name": [f"user-{rng.randint(0, n):05d}@ex{i % 7}.com"
                 for i in range(n)],
        "v": rng.randint(0, 100, n).astype("int64"),
    })


def test_plan_filter_and_functions_on_raw():
    t = _users()
    got = _both(lambda B: B().values([t], string_encoding="raw")
                .filter("name like '%ex3.com'")
                .project(["upper(substr(name, 1, 4)) as u",
                          "length(name) as l", "v"]).plan())
    names = [s for s in t.column("name").to_pylist() if s.endswith("ex3.com")]
    assert sorted(got.column("u").to_pylist()) == sorted(
        s[:4].upper() for s in names)


def test_plan_compare_raw_to_constant():
    t = _users(200)
    got = _both(lambda B: B().values([t], string_encoding="raw")
                .filter("name = 'user-00017@ex0.com'").plan())
    assert got.num_rows == t.column("name").to_pylist().count(
        "user-00017@ex0.com")


def test_plan_group_by_raw_key():
    t = _users(2000)
    got = _both(lambda B: B().values([t], string_encoding="raw")
                .single_aggregation(["name"], ["sum(v) as s",
                                               "count(v) as c"]).plan(),
                ordered=True)
    assert got.num_rows == len(set(t.column("name").to_pylist()))


def _sku_tables():
    rng = np.random.RandomState(4)
    probe = pa.table({
        "k": [f"sku-{rng.randint(0, 300):04d}" for _ in range(600)],
        "pv": rng.randint(0, 50, 600).astype("int64")})
    build = pa.table({
        "bk": [f"sku-{i:04d}" for i in range(0, 300, 2)],
        "bv": rng.randint(0, 50, 150).astype("int64")})
    return probe, build


def test_plan_join_on_raw_key():
    probe, build = _sku_tables()

    def plan(B):
        b = B()
        bb = b.new_builder().values([build], string_encoding="raw")
        return (b.values([probe], string_encoding="raw")
                .hash_join(["k"], ["bk"], bb, output=["k", "pv", "bv"])
                .plan())
    got = _both(plan)
    assert got.num_rows == sum(int(k[4:]) % 2 == 0
                               for k in probe.column("k").to_pylist())


def test_plan_order_by_raw_strings():
    t = _users(300)
    got = _both(lambda B: B().values([t], string_encoding="raw")
                .order_by(["name"]).limit(50).plan(), ordered=True)
    assert got.column("name").to_pylist() == sorted(
        t.column("name").to_pylist())[:50]


def test_plan_raw_with_nulls():
    t = pa.table({"s": pa.array(["aa", None, "bb", "aa", None, "cc"]),
                  "v": pa.array(np.arange(6, dtype="int64"))})
    got = _both(lambda B: B().values([t], string_encoding="raw")
                .single_aggregation(["s"], ["sum(v) as t"]).plan())
    assert dict(_rows(got)) == {"aa": 3, None: 5, "bb": 2, "cc": 5}


# ---------------------------------------------------------------------------
# ingest: the device pack, the encodings
# ---------------------------------------------------------------------------

def _pack_cases():
    rng = np.random.RandomState(7)
    long_vals = ["".join(rng.choice(ALPHA, rng.randint(0, 300)))
                 for _ in range(200)]
    nulls = _rand_strings(300, seed=8, with_nulls=True)
    return {
        "ascii": pa.array(_rand_strings(1000, seed=6)),
        "nulls": pa.array(nulls),
        "unicode": pa.array(UNICODE * 7),
        "long": pa.array(long_vals),
        "sliced": pa.array(nulls).slice(37, 200),
        "chunked": pa.chunked_array([pa.array(UNICODE),
                                     pa.array(_rand_strings(50, seed=9))]),
        "empty": pa.array([], pa.string()),
        "all_empty": pa.array(["", "", None]),
        "large": pa.array(UNICODE, pa.large_string()),
    }


@pytest.mark.parametrize("case", list(_pack_cases()))
def test_device_pack_equals_pack_arrow_bit_for_bit(case, monkeypatch):
    """The device-side pack (Arrow offsets and data uploaded, one gather a
    chunk of rows) equals the host pack_arrow, and the reference's."""
    arr = _pack_cases()[case]
    monkeypatch.setattr(S, "_PACK_CHUNK", 1000)  # several chunks
    cap = D.default_capacity(len(arr))
    b, ln, valid = S.pack_arrow_device(arr, cap, CPUD)
    hb, hln, hvalid = S.pack_arrow(arr, cap)
    jb, jln, jvalid = JS.pack_arrow(arr, cap)
    for got, host, ref in ((b.numpy(), hb, jb), (ln.numpy(), hln, jln)):
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, ref)
    if jvalid is None:
        assert valid is None and hvalid is None
    else:
        np.testing.assert_array_equal(valid.numpy(), jvalid)


@pytest.mark.parametrize("vals", [
    [f"id-{i}" for i in range(100)],            # distinct: raw
    ["a", "b"] * 50,                            # two values: dict
    [f"v{i % 51}" for i in range(100)],         # 51 > 50: raw
    [f"v{i % 50}" for i in range(100)],         # 50: dict
    ["x" * 3000] + [f"{i}" for i in range(99)],  # past the widest class
    [],
])
def test_auto_matches_the_reference_choice(vals):
    arr = pa.array(vals, pa.string())
    cap = D.default_capacity(len(vals))
    jraw = JS.is_raw(JD.column_from_arrow(arr, cap, string_encoding="auto"))
    assert S.is_raw(D.column_from_arrow(arr, cap, string_encoding="auto",
                                        device=CPUD)) == jraw


def test_values_per_column_encoding():
    t = pa.table({"a": pa.array(_rand_strings(64, seed=2)),
                  "b": pa.array(["x", "y"] * 32),
                  "c": pa.array([f"c{i}" for i in range(64)])})
    enc = {"a": "raw", "c": "auto"}
    b = D.from_arrow(t, string_encoding=enc, device=CPUD)
    jb = JD.from_arrow(t, string_encoding=enc)
    for name in ("a", "b", "c"):
        assert S.is_raw(b.columns[name]) == JS.is_raw(jb.columns[name])
    assert S.is_raw(b.columns["a"]) and S.is_raw(b.columns["c"])
    assert b.columns["b"].dictionary is not None
    # (the reference's plan cache cannot hash a dict-valued encoding)
    got = Task(PlanBuilder().values([t], string_encoding=enc).project(
        ["a", "b", "c", "length(a) as la"]).plan(), CPU).run()
    assert got.select(["a", "b", "c"]).to_pylist() == t.to_pylist()
    assert got.column("la").to_pylist() == pc.utf8_length(
        t.column("a")).cast(pa.int64()).to_pylist()


# ---------------------------------------------------------------------------
# functions in both encodings, against pyarrow
# ---------------------------------------------------------------------------

_PA_FUNCS = {
    "upper(s)": lambda a: pc.utf8_upper(a),
    "lower(s)": lambda a: pc.utf8_lower(a),
    "trim(s)": lambda a: pc.utf8_trim_whitespace(a),
    "ltrim(s)": lambda a: pc.utf8_ltrim_whitespace(a),
    "rtrim(s)": lambda a: pc.utf8_rtrim_whitespace(a),
    "reverse(s)": lambda a: pc.utf8_reverse(a),
    "length(s)": lambda a: pc.utf8_length(a).cast(pa.int64()),
    "substr(s, 2, 3)": lambda a: pc.utf8_slice_codeunits(a, 1, 4),
    "substr(s, 2)": lambda a: pc.utf8_slice_codeunits(a, 1),
    "strpos(s, 'a')": lambda a: pa.array(
        [None if x is None else x.find("a") + 1 for x in a.to_pylist()],
        pa.int64()),
    "s like '%a%'": lambda a: pc.match_like(a, "%a%"),
    "starts_with(s, 'n')": lambda a: pc.starts_with(a, "n"),
    "ends_with(s, 'e')": lambda a: pc.ends_with(a, "e"),
    "concat(s, '-x')": lambda a: pc.binary_join_element_wise(a, "-x", ""),
    "s < 'm'": lambda a: pc.less(a, "m"),
}


@pytest.mark.parametrize("expr", list(_PA_FUNCS))
def test_string_function_in_both_encodings_equals_pyarrow(expr):
    vals = UNICODE + _rand_strings(40, seed=12) + [None]
    t = pa.table({"s": pa.array(vals, pa.string())})
    want = _PA_FUNCS[expr](t.column("s").combine_chunks()).to_pylist()
    for enc in ("dict", "raw"):
        got = Task(PlanBuilder().values([t], string_encoding=enc)
                   .project([f"{expr} as x"]).plan(), CPU).run()
        assert got.column("x").to_pylist() == want, enc


def test_string_functions_in_row_chunks_equal_one_pass(monkeypatch):
    """The functions run over slices of ``ROW_CHUNK_ELEMS`` elements (here
    a few rows each) and give the one-pass answer."""
    vals = UNICODE * 3 + _rand_strings(60, seed=13) + [None]
    t = pa.table({"s": pa.array(vals, pa.string())})
    plan = PlanBuilder().values([t], string_encoding="raw").project(
        [f"{e} as x{i}" for i, e in enumerate(_PA_FUNCS)]).plan()
    whole = Task(plan, CPU).run()
    monkeypatch.setattr(S, "ROW_CHUNK_ELEMS", 100)
    assert Task(plan, CPU).run() == whole


def test_dictionary_upper_lower_follow_pyarrow_like_the_reference():
    """The repair: the port's dictionary upper/lower (and the trims,
    length and reverse) map values as the reference does, through
    pyarrow's utf8 kernels, not Python's str methods."""
    t = pa.table({"s": pa.array(UNICODE)})
    for f in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse",
              "length"):
        _both(lambda B: B().values([t]).project([f"{f}(s) as x"]).plan(),
              ordered=True)
    got = Task(PlanBuilder().values([pa.table({"s": pa.array(
        ["straße", "ﬁ", "Élan", "ǅx", "Ω"])})]).project(
        ["upper(s) as x"]).plan(), CPU).run()
    assert got.column("x").to_pylist() == ["STRAẞE", "ﬁ", "ÉLAN", "ǄX", "Ω"]


def test_upper_lower_send_only_non_ascii_rows_to_the_host():
    vals = ["abc", "straße", "xyz", "Ω", "q"]
    b, ln = (torch.from_numpy(x) for x in S.pack_pylist(vals, 8))
    from velox_tpu_torch.common import metrics as M

    def host_rows():
        return M.reporter().snapshot()["counters"].get(S.K_HOST_ROWS, 0)
    before = host_rows()
    ub, ul = S.upper(b, ln)
    assert host_rows() - before == 2
    assert _unpack(ub, ul)[:5] == pc.utf8_upper(pa.array(vals)).to_pylist()
    assert ub.shape[1] == b.shape[1]


# ---------------------------------------------------------------------------
# reference faults of the raw encoding (ROADMAP C)
# ---------------------------------------------------------------------------

def test_reverse_is_by_code_point_where_the_reference_reverses_bytes():
    vals = ["straße", "Ω", "日本語", "abc"]
    t = pa.table({"s": pa.array(vals)})
    plan = JPlanBuilder().values([t], string_encoding="raw").project(
        ["reverse(s) as x"]).plan()
    jb = JS.reverse_bytes(*map(jnp.asarray, JS.pack_pylist(vals, 4)))
    ref = S.unpack_numpy(np.asarray(jb[0]), np.asarray(jb[1]))
    assert ref[0] == b"e\x9f\xc3arts" and ref[1] == b"\xa9\xce"
    ref = JTask(plan).run().column("x")
    with pytest.raises(UnicodeDecodeError):  # the bytes are not UTF-8
        ref.to_pylist()
    got = Task(PlanBuilder().values([t], string_encoding="raw").project(
        ["reverse(s) as x"]).plan(), CPU).run()
    assert got.column("x").to_pylist() == pc.utf8_reverse(
        pa.array(vals)).to_pylist()


def test_case_mapping_covers_non_ascii_where_the_reference_maps_ascii():
    vals = ["naïve", "Élan", "straße"]
    t = pa.table({"s": pa.array(vals)})
    for f, pf in (("upper", pc.utf8_upper), ("lower", pc.utf8_lower)):
        ref = JTask(JPlanBuilder().values([t], string_encoding="raw")
                    .project([f"{f}(s) as x"]).plan()).run()
        want = pf(pa.array(vals)).to_pylist()
        assert ref.column("x").to_pylist() != want
        got = Task(PlanBuilder().values([t], string_encoding="raw")
                   .project([f"{f}(s) as x"]).plan(), CPU).run()
        assert got.column("x").to_pylist() == want


# ---------------------------------------------------------------------------
# compares, sort, TopN, group-by and join keys through both engines
# ---------------------------------------------------------------------------

def _names(n=80, seed=1, nulls=True):
    rng = np.random.default_rng(seed)
    names = [f"n{int(x):03d}" for x in rng.integers(0, 40, n)]
    if nulls:
        names[3] = names[10] = None
    return pa.table({"s": pa.array(names),
                     "v": pa.array(rng.integers(0, 100, n)),
                     "k": pa.array(rng.integers(0, 5, n))})


@pytest.mark.parametrize("expr", [
    "s = 'n007'", "s <> 'n007'", "s < 'n020'", "s <= 'n020'",
    "s > 'n020'", "s >= 'n020'", "'n020' > s", "s = s",
    "s in ('n001', 'n005')", "s between 'n001' and 'n010'",
    "s < 'n0205'", "s = 'absent'"])
def test_raw_compare_matches_the_reference(expr):
    t = _names()
    _both(lambda B: B().values([t], string_encoding="raw")
          .project([f"{expr} as x", "v"]).plan(), ordered=True)


def test_raw_compare_against_a_dictionary_column():
    t = _names()
    t2 = t.append_column("d", t.column("s"))
    for op in ("=", "<", ">="):
        got = Task(PlanBuilder().values(
            [t2], string_encoding={"s": "raw"}).project(
            [f"s {op} d as x"]).plan(), CPU).run()
        vals = t.column("s").to_pylist()
        want = [None if a is None else {"=": a == a, "<": a < a,
                                        ">=": a >= a}[op] for a in vals]
        assert got.column("x").to_pylist() == want


@pytest.mark.parametrize("keys", [["s"], ["s DESC NULLS FIRST", "v"],
                                  ["k", "s DESC"]])
def test_raw_order_by_and_top_n_match_the_reference(keys):
    t = _names()
    _both(lambda B: B().values([t], string_encoding="raw")
          .order_by(keys).plan(), ordered=True)
    _both(lambda B: B().values([t], string_encoding="raw")
          .top_n(keys + ["v", "k"], 7).plan(), ordered=True)


def test_raw_group_by_partial_final_and_two_keys_match_the_reference():
    t = _names()
    _both(lambda B: B().values([t], string_encoding="raw")
          .single_aggregation(["s", "k"], ["sum(v) as x",
                                           "count(s) as c"]).plan())
    _both(lambda B: B().values([t], string_encoding="raw")
          .partial_aggregation(["s"], ["sum(v) as x"])
          .final_aggregation().plan())
    _both(lambda B: B().values([t], string_encoding="raw")
          .single_aggregation(["k"], ["approx_distinct(s) as a",
                                      "count_if(s = 'n001') as c"]).plan())
    _both(lambda B: B().values([t], string_encoding="raw")
          .single_aggregation(["k"], ["min_by(v, s) as m"]).plan())


def _join_tables():
    probe = _names(60)
    build = pa.table({"bs": pa.array([f"n{i:03d}" for i in range(0, 40, 2)]
                                     + [None, "zz" * 20]),
                      "bv": pa.array(np.arange(22))})
    return probe, build


@pytest.mark.parametrize("jt", ["inner", "left", "left_semi_filter",
                                "anti", "right_semi_filter"])
@pytest.mark.parametrize("enc", [("raw", "raw"), ("raw", "dict"),
                                 ("dict", "raw")])
def test_raw_join_keys_match_the_reference(jt, enc):
    probe, build = _join_tables()
    out = (["s", "v"] if jt in ("left_semi_filter", "anti")
           else ["bs", "bv"] if jt == "right_semi_filter"
           else ["s", "v", "bv"])

    def plan(B):
        b = B()
        bb = b.new_builder().values([build], string_encoding=enc[1])
        return (b.values([probe], string_encoding=enc[0])
                .hash_join(["s"], ["bs"], bb, output=out, join_type=jt)
                .plan())
    _both(plan)


@pytest.mark.parametrize("jt", ["right", "full"])
def test_raw_right_and_full_joins_equal_a_python_oracle(jt):
    """The reference cannot emit a raw probe column in the right phase
    (its NULL column has no dictionary; ROADMAP C): the port keeps the
    size class, and its rows equal a Python join."""
    probe, build = _join_tables()
    pb = PlanBuilder()
    bb = pb.new_builder().values([build], string_encoding="raw")
    got = Task(pb.values([probe], string_encoding="raw").hash_join(
        ["s"], ["bs"], bb, output=["s", "v", "bs", "bv"],
        join_type=jt).plan(), CPU).run()
    prows = probe.select(["s", "v"]).to_pylist()
    brows = build.to_pylist()
    want = [(p["s"], p["v"], b["bs"], b["bv"]) for p in prows for b in brows
            if p["s"] is not None and p["s"] == b["bs"]]
    matched = {b["bs"] for b in brows} & {p["s"] for p in prows}
    want += [(None, None, b["bs"], b["bv"]) for b in brows
             if b["bs"] not in matched or b["bs"] is None]
    if jt == "full":
        want += [(p["s"], p["v"], None, None) for p in prows
                 if p["s"] is None or p["s"] not in matched]
    key = lambda r: tuple((v is None, v if v is not None else 0) for v in r)
    assert sorted(_rows(got), key=key) == sorted(want, key=key)
    with pytest.raises(Exception):
        jb = JPlanBuilder()
        jbb = jb.new_builder().values([build], string_encoding="raw")
        JTask(jb.values([probe], string_encoding="raw").hash_join(
            ["s"], ["bs"], jbb, output=["s", "v", "bs", "bv"],
            join_type=jt).plan()).run()


def test_raw_join_filter_and_nested_loop_match_the_reference():
    probe, build = _join_tables()

    def hash_plan(B):
        b = B()
        bb = b.new_builder().values([build], string_encoding="raw")
        return (b.values([probe], string_encoding="raw")
                .hash_join(["s"], ["bs"], bb, output=["s", "v", "bv"],
                           filter="v > bv").plan())

    def nlj_plan(B):
        b = B()
        bb = b.new_builder().values([build], string_encoding="raw")
        return (b.values([probe], string_encoding="raw")
                .nested_loop_join(bb, filter="s = bs",
                                  output=["s", "v", "bv"]).plan())
    _both(hash_plan)
    _both(nlj_plan)


def test_raw_top_n_row_number_by_a_raw_sort_key_matches_the_reference():
    t = _names()
    _both(lambda B: B().values([t], string_encoding="raw")
          .top_n_row_number(["k"], ["s", "v"], 2).plan())


def _fails_in_both(build):
    with pytest.raises(Exception):
        JTask(build(JPlanBuilder)).run()
    with pytest.raises(NotImplementedError, match="raw"):
        Task(build(PlanBuilder), CPU).run()


@pytest.mark.parametrize("name", [
    "mark_distinct", "row_number", "window_partition", "window_order",
    "top_n_row_number_partition", "streaming", "merge_join", "if",
    "coalesce", "min", "max", "arbitrary", "first", "mode", "max_by_x",
    "cast", "like_underscore"])
def test_raw_cases_the_reference_cannot_run_raise(name):
    """Where the reference fails over a raw string, the port raises
    NotImplementedError (ROADMAP C lists them)."""
    t = _names()

    def V(B):
        return B().values([t], string_encoding="raw")

    def agg(f):
        return lambda B: V(B).single_aggregation(["k"], [f"{f} as a"]).plan()

    def merge(B):
        b = B()
        bb = b.new_builder().values([t.rename_columns(["bs", "bv", "bk"])],
                                    string_encoding="raw")
        return (b.values([t], string_encoding="raw").order_by(["s"])
                .merge_join(["s"], ["bs"], bb, output=["s", "bv"]).plan())
    builds = {
        "mark_distinct": lambda B: V(B).mark_distinct("m", ["s"]).plan(),
        "row_number": lambda B: V(B).row_number(["s"], limit=2).plan(),
        "window_partition": lambda B: V(B).window(
            ["s"], ["v"], ["row_number() as rn"]).plan(),
        "window_order": lambda B: V(B).window(
            ["k"], ["s"], ["rank() as rn"]).plan(),
        "top_n_row_number_partition": lambda B: V(B).top_n_row_number(
            ["s"], ["v"], 2).plan(),
        "streaming": lambda B: V(B).order_by(["s"]).single_aggregation(
            ["s"], ["sum(v) as x"]).plan(),
        "merge_join": merge,
        "if": lambda B: V(B).project(["if(v > 50, s, s) as a"]).plan(),
        "coalesce": lambda B: V(B).project(["coalesce(s, s) as a"]).plan(),
        "min": agg("min(s)"), "max": agg("max(s)"),
        "arbitrary": agg("arbitrary(s)"), "first": agg("first(s)"),
        "mode": agg("mode(s)"), "max_by_x": agg("max_by(s, v)"),
        "cast": lambda B: V(B).project(["cast(s as bigint) as a"]).plan(),
        "like_underscore": lambda B: V(B).project(
            ["s like 'n_0%' as a"]).plan(),
    }
    _fails_in_both(builds[name])


def test_raw_key_layout_decodes_like_the_reference():
    from velox_tpu.exec import sort as JSort
    from velox_tpu.expression.eval import EvalValue as JEvalValue
    from velox_tpu_torch.expression.eval import EvalValue
    vals = ["b", "a", "ccc", "", "ab", "é"]
    b, ln, jb, jln = _packed(vals, 8)
    active = np.arange(8) < len(vals)
    tv = S.raw_value(b, ln)
    jv = JS.raw_value(jb, jln)
    words, bits, layout = TSort.sort_words_layout(
        [tv], None, 8, torch.from_numpy(active))
    jwords, jbits, jlayout = JSort.sort_words_layout(
        [jv], None, 8, jnp.asarray(active))
    assert bits == jbits and layout[0].kind == jlayout[0].kind == "raw"
    lanes = TSort.pack_words_u64(words, bits)
    lb = TSort.lane_bit_widths(sum(bits))
    (data, lens), _ = TSort.decode_key_field(layout[0], lanes, lb, 8)
    np.testing.assert_array_equal(data.numpy(), b.numpy())
    np.testing.assert_array_equal(lens.numpy(), ln.numpy())
    perm = TSort.radix_sort_perm(words, bits, 8)
    jperm = JSort.radix_sort_perm(jwords, jbits, 8)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert isinstance(tv, EvalValue) and isinstance(jv, JEvalValue)


def test_batch_from_reference_carries_raw_strings():
    from velox_tpu_torch.testing.batches import batch_from_reference
    vals = UNICODE + [None]
    t = pa.table({"s": pa.array(vals), "v": pa.array(range(len(vals)))})
    b = batch_from_reference(JD.from_arrow(t, string_encoding="raw"))
    assert S.is_raw(b.columns["s"])
    assert b.columns["s"].children[0].data.dtype == torch.int32
    assert D.to_arrow(b).column("s").to_pylist() == vals
