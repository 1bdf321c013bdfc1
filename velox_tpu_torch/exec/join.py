"""Hash join: build + probe over a sorted-key table.

Counterpart of ``velox_tpu/exec/join.py`` (velox/exec/HashBuild.h:38,
HashProbe.h:28, HashJoinBridge.h): every join type over one build-side
table.

The table is the reference's **sorted key array**: the build side is
radix-sorted by its key words (exec/sort.py, whose passes run kernels B3
and B4), and a probe batch finds each row's run [lo, lo + count) of equal
build keys in one of two ways:

* **array mode** (velox HashMode::kArray, HashTable.h:119): a single
  integral, DATE or short-DECIMAL key whose range spans at most
  ``ARRAY_JOIN_MAX_DOMAIN`` values gets dense direct-address tables over
  the domain (``arr_start``, ``arr_count``, ``arr_row1``); a probe is one
  or two table lookups. The range comes from plan-level stats, or where
  the plan has none, from the build's own usable keys at build finish
  (one host read), as velox picks kArray from the values its table
  holds; such an observed domain also stays within
  ``ARRAY_JOIN_SLOTS_PER_ROW`` entries a build row (or
  ``ARRAY_JOIN_SMALL_DOMAIN``), so a small, sparse build keeps the
  merge-rank;
* **merge-rank**: one radix sort of the concatenated (build, probe) keys,
  build rows first among equal keys; counts of build rows before each
  probe row's key run give its [lo, hi).

``perm`` maps sorted positions back to build rows, so duplicate keys need
no side structure. Every 4- and 8-byte gather of the probe runs kernel
B5: the domain tables and ``perm`` one array at a time (ops/gather.py
``take_rows``), the build and probe columns at the matched rows all
through one index in one launch (exec/batch_utils.py
``take_columns_rows``).

* Unique-key builds without a filter emit one output row per probe row,
  with no host sync.
* Duplicate keys or a filter take the count path (HashProbe.cpp:1054
  listJoinResults): per-row match counts and their prefix sum, ONE host
  read of the total per probe batch, then output chunks of the probe
  batch's capacity.
* Right/full/right-semi joins flag matched build rows per probe batch and
  emit the build side's rows after the last one.
* A filter runs on the expanded candidate rows; LEFT/FULL probe rows whose
  candidates all fail it emit one row with a null build side, and
  semi/anti joins count only passing candidates (velox HashProbe.cpp).

The merge join (``MergeJoinOperator``, velox MergeJoin.h) shares all of
it; its presorted build compacts without a sort, and a probe row's run
comes from two binary searches over the packed build keys.

Key tuples of any width take the sorted build and the merge-rank: the
counting radix sort takes any number of key words, so the reference's
scatter-probe hash-join build past seven words is not needed (the rows
are the same as a set). Raw-string keys (vector/strings.py) always do:
their byte words and length word are the key words, a dictionary or
constant side converts to bytes (functions/raw_strings.py ``as_raw``),
and the two sides' byte matrices pad to one size class. Both build
stages hold their batches in an ``OffloadBuffer`` (exec/memory.py): past
the device budget they go to host RAM and spill files (velox Spiller
kHashJoinBuild) and come back in input order for the build.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.common.process_trace import spanned
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.core.expressions import referenced_fields
from velox_tpu_torch.core.stats import (
    resolve_column_stats, resolve_column_unique,
)
from velox_tpu_torch.exec.batch_utils import (
    concat_batches, take_columns_rows,
)
from velox_tpu_torch.exec.memory import OffloadBuffer
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.exec.sort import (
    pack_key_u64, packable_words, sort_perm_key, sort_words,
    sort_words_layout,
)
from velox_tpu_torch.expression.eval import (
    EvalValue, ExprSet, value_from_column,
)
from velox_tpu_torch.ops.gather import take_rows
from velox_tpu_torch.ops.wide import scatter_unique_set
from velox_tpu_torch.vector import strings as S
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn

# the reference's uint64 MAX as the int64 holding the same bits
_U64_MAX = -1
_I64_MIN = -(1 << 63)


class SortedBuild(NamedTuple):
    """The HashJoinBridge payload.

    ``sorted_key`` holds the packed keys in sorted order (int64 with the
    reference's uint64 bits; the tail past the usable rows is MAX), or a
    placeholder for wide keys, which probe through the merge-rank and
    never read it. In array mode, ``arr_start``/``arr_count`` give each
    domain value's run of sorted positions and ``arr_row1`` the build row
    + 1 of its first match (0 when absent): a unique build's probe needs
    one lookup instead of three (start, count, perm). The domain tables
    are int32, as B5's data and the reference's tables are."""
    sorted_key: torch.Tensor   # int64[cap]
    perm: torch.Tensor         # int64[cap]: sorted position -> build row
    batch: DeviceBatch         # build-side rows, unpermuted
    has_null_key: torch.Tensor  # 0-dim bool (null-aware anti joins)
    has_dup_keys: torch.Tensor  # 0-dim bool
    arr_start: Optional[torch.Tensor] = None  # int32[domain]
    arr_count: Optional[torch.Tensor] = None  # int32[domain]
    arr_base: Optional[int] = None            # the domain's first value
    arr_row1: Optional[torch.Tensor] = None   # int32[domain]
    # a merge join's presorted build: the usable rows (the sorted prefix
    # of ``sorted_key`` that its binary searches may land in)
    n_usable: Optional[torch.Tensor] = None   # 0-dim int64
    # a single key's (usable rows, min, max) as read on the host at build
    # finish, where it had no plan-level range (HashBuildStage)
    key_range: Optional[tuple] = None


def key_values(batch: DeviceBatch, key_fields) -> List[EvalValue]:
    return [value_from_column(batch.columns[k.name]) for k in key_fields]


def usable_rows(batch: DeviceBatch, keys: List[EvalValue]) -> torch.Tensor:
    """Active rows with fully non-null keys (SQL join null semantics)."""
    ok = batch.mask
    for v in keys:
        if v.validity is not None:
            ok = ok & v.full_validity(batch.capacity)
    return ok


def _first_last(ok: torch.Tensor, norm: torch.Tensor):
    """Run starts and ends of equal ``norm`` among sorted rows. An ok /
    not-ok edge is a run end too: a masked tail row whose clipped norm
    equals the last usable key must not hide that key's end (its count
    would go negative and drop its matches)."""
    no = torch.zeros((1,), dtype=torch.bool, device=ok.device)
    prev_ok = torch.cat([no, ok[:-1]])
    next_ok = torch.cat([ok[1:], no])
    prev = torch.cat([norm[:1] - 1, norm[:-1]])
    nxt = torch.cat([norm[1:], norm[-1:] - 1])
    first = ok & (~prev_ok | (norm != prev))
    last = ok & (~next_ok | (nxt != norm))
    return first, last


def _scatter_drop(size: int, where: torch.Tensor, idx: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``zeros(size)[idx[where]] = values[where]`` (int32)."""
    tgt = torch.where(where, idx, size)
    return scatter_unique_set(size + 1, tgt,
                              values.to(torch.int32))[:size]


def build_sorted_table(b: DeviceBatch, key_fields, array_range=None,
                       key_ranges=None) -> SortedBuild:
    """The sorted-key table of build batch ``b``.

    ``array_range`` = (min, max) storage bounds of a single integral key:
    also builds the dense direct-address tables (SortedBuild).
    ``key_ranges`` = per-key (min, max) bounds or None (core/stats.py):
    they narrow the sort words, so the build sort takes fewer radix passes
    and, when key and row-id bits fit 64, the scatter branch (B3) instead
    of the classic loop (B2). An order-preserving narrowing leaves the
    stable permutation unchanged.

    Wide keys (value words beyond one packed lane, any number of them)
    still sort; their probes go through the merge-rank, which never reads
    ``sorted_key``, and only duplicate detection needs the sorted words,
    gathered through the permutation."""
    cap = b.capacity
    dev = b.device
    keys = key_values(b, key_fields)
    usable = usable_rows(b, keys)
    # usable rows first, ordered by key words (stable)
    words, bits, _ = sort_words_layout(keys, None, cap, usable, key_ranges)
    perm, _ = sort_perm_key(words, bits, cap)
    n = usable.sum(dtype=torch.int64)
    in_prefix = torch.arange(cap, device=dev) < n
    has_null = (b.mask & ~usable).any()
    if has_raw_key(b, key_fields) \
            or not packable_words([k.dtype for k in key_fields]):
        eq = torch.ones((cap - 1,), dtype=torch.bool, device=dev)
        for w in words:
            ws = take_rows(w, perm)
            eq = eq & (ws[1:] == ws[:-1])
        dup = eq & in_prefix[1:]
        placeholder = torch.where(in_prefix, 0, _U64_MAX)
        return SortedBuild(placeholder, perm, b, has_null, dup.any())
    packed = take_rows(pack_key_u64(keys, cap), perm)
    # the tail's key words are arbitrary: MAX keeps the array sorted
    packed = torch.where(in_prefix, packed, _U64_MAX)
    dup = (packed[1:] == packed[:-1]) & in_prefix[1:]
    arr_start = arr_count = arr_base = arr_row1 = None
    if array_range is not None:
        lo_v, hi_v = int(array_range[0]), int(array_range[1])
        domain = hi_v - lo_v + 1
        ks = take_rows(keys[0].full_data(cap).to(torch.int64), perm)
        ok = in_prefix & (ks >= lo_v) & (ks <= hi_v)
        norm = torch.clamp(ks - lo_v, 0, domain - 1)
        first, last = _first_last(ok, norm)
        iota = torch.arange(cap, dtype=torch.int32, device=dev)
        arr_start = _scatter_drop(domain, first, norm, iota)
        ends = _scatter_drop(domain, last, norm, iota + 1)
        arr_count = ends - arr_start  # untouched keys: 0 - 0
        arr_base = lo_v
        arr_row1 = _scatter_drop(domain, first, norm, perm + 1)
    return SortedBuild(packed, perm, b, has_null, dup.any(),
                       arr_start, arr_count, arr_base, arr_row1)


def has_raw_key(b: DeviceBatch, key_fields) -> bool:
    """A raw (byte-matrix) string key."""
    return any(S.is_raw(b.columns[k.name]) for k in key_fields)


def build_table(b: DeviceBatch, key_fields, array_range=None,
                key_ranges=None) -> SortedBuild:
    """The build table of ``b``: key tuples of one packed lane get the
    packed sorted build (and array mode when ``array_range`` is given);
    wider tuples, of any number of value words, and raw-string keys sort
    through the same counting radix sort and probe through the
    merge-rank."""
    dtypes = [k.dtype for k in key_fields]
    if packable_words(dtypes) and not has_raw_key(b, key_fields):
        bt = build_sorted_table(b, key_fields, array_range, key_ranges)
    else:
        bt = build_sorted_table(b, key_fields, None, key_ranges)
    M.record_counter(M.K_JOIN_ARRAY_MODE_BUILDS if bt.arr_start is not None
                     else M.K_JOIN_MERGE_RANK_BUILDS)
    return bt


# Max dense direct-address domain for array-mode joins: 1 << 26 entries,
# three int32 tables of 256 MB each, which covers every TPC-H key at
# SF <= 10 (o_orderkey spans 6e7 values there). The domain is the build
# key's range, from plan-level stats or from the build's own values.
ARRAY_JOIN_MAX_DOMAIN = 1 << 26
# A domain observed in the build's own keys also stays within
# ARRAY_JOIN_SLOTS_PER_ROW entries a row the build holds (its capacity,
# whose sorted table already takes 16 bytes a row), or within
# ARRAY_JOIN_SMALL_DOMAIN (velox's kArrayHashMaxSize, HashTable.h:119):
# the tables then cost at most 96 bytes a build row or 24 MiB, and a small
# build whose keys lie far apart keeps the merge-rank. TPC-H's order keys
# span 4 values an order.
ARRAY_JOIN_SLOTS_PER_ROW = 8
ARRAY_JOIN_SMALL_DOMAIN = 1 << 21


def build_key_ranges(node: P.HashJoinNode):
    """The build keys' plan-level (min, max) bounds (None where unknown)."""
    return tuple(resolve_column_stats(node.right, k.name)
                 for k in node.right_keys)


def int_storage_type(dt) -> bool:
    """An integral, DATE or short-DECIMAL type: its storage ints order
    its values, so their (min, max) bound a key (a long decimal's would
    need both limbs)."""
    return not dt.is_long_decimal and (
        dt.is_integral or dt.kind in (T.TypeKind.DATE, T.TypeKind.DECIMAL))


def array_key(key_fields) -> bool:
    """Whether build keys ``key_fields`` can take array mode: a single
    ``int_storage_type`` key (its storage ints index the domain)."""
    return len(key_fields) == 1 and int_storage_type(key_fields[0].dtype)


def array_domain(lo: int, hi: int):
    """(lo, hi) when the range spans at most ARRAY_JOIN_MAX_DOMAIN values,
    else None."""
    if hi < lo or hi - lo + 1 > ARRAY_JOIN_MAX_DOMAIN:
        return None
    return (lo, hi)


def array_join_range(node: P.HashJoinNode):
    """Static (min, max) bounds for array-mode probing, or None: an
    ``array_key`` whose build side's plan-level stats fit
    ``array_domain`` (only build keys can match, so the probe side's range
    does not widen it)."""
    if not array_key(node.right_keys):
        return None
    rng = resolve_column_stats(node.right, node.right_keys[0].name)
    if rng is None:
        return None
    return array_domain(int(rng[0]), int(rng[1]))


def key_summaries(b: DeviceBatch, key_fields, summarized,
                  first: bool = True):
    """The usable row count of build ``b`` and, for each key index in
    ``summarized``, its (min, max) over the usable rows and, with
    ``first``, its first min(count, 64) usable values: reduced on the
    device and read in one host read (min and max are meaningless when
    no row is usable)."""
    cap = b.capacity
    keys = key_values(b, key_fields)
    ok = usable_rows(b, keys)
    parts = [ok.sum(dtype=torch.int64).reshape(1)]
    if first:
        pos = torch.cumsum(ok.to(torch.int64), 0) - 1
        tgt = torch.where(ok & (pos < 64), pos, 64)
    big = torch.iinfo(torch.int64).max
    for i in summarized:
        d = keys[i].full_data(cap).to(torch.int64)
        if first:
            head = torch.zeros((65,), dtype=torch.int64, device=d.device)
            head[tgt] = d
        parts += [torch.where(ok, d, big).min().reshape(1),
                  torch.where(ok, d, -big).max().reshape(1)]
        if first:
            parts.append(head[:64])
    host = torch.cat(parts).tolist()
    n, w = host[0], 66 if first else 2
    return n, [(host[1 + w * j], host[2 + w * j],
                host[3 + w * j:3 + w * j + min(n, 64)] if first else [])
               for j in range(len(summarized))]


def observed_domain(key_range, capacity: int):
    """The array-mode (min, max) of a build of ``capacity`` rows whose
    single key's (usable rows, min, max) is ``key_range``, or None: no
    usable row, a domain over ``array_domain``'s cap, or over both
    ARRAY_JOIN_SMALL_DOMAIN and ARRAY_JOIN_SLOTS_PER_ROW a row."""
    n, lo, hi = key_range
    if not n or hi - lo + 1 > max(ARRAY_JOIN_SMALL_DOMAIN,
                                  ARRAY_JOIN_SLOTS_PER_ROW * capacity):
        return None
    return array_domain(lo, hi)


class HashBuildStage:
    """Collects build-side batches in ``buffer`` and builds the table
    once they are all in. The Task hands it an ``OffloadBuffer`` with the
    query's spill settings (parity: velox Spiller kHashJoinBuild,
    exec/Spiller.h:29); without one every batch stays on the device,
    unaccounted.

    An ``array_key`` with no plan-level range takes array mode from the
    build's own key range where ``observed_domain`` admits it; the range
    narrows the build sort's words too, and the table keeps the
    (usable rows, min, max) read for the join's dynamic filter."""

    def __init__(self, key_fields, array_range=None, key_ranges=None,
                 buffer: Optional[OffloadBuffer] = None):
        self._key_fields = list(key_fields)
        self._array_range = array_range
        self._key_ranges = key_ranges
        self._observe = (array_range is None
                         and array_key(self._key_fields)
                         and not (key_ranges and key_ranges[0]))
        self._buf = buffer if buffer is not None else OffloadBuffer(None)

    def add_input(self, batch: DeviceBatch):
        self._buf.add(batch)

    def close(self) -> None:
        """Drop the buffered batches (a build that did not finish)."""
        self._buf.close()

    def _merged(self) -> DeviceBatch:
        batches = self._buf.restore_all()
        if not batches:
            raise RuntimeError("empty build side requires at least one "
                               "(possibly empty) batch")
        return concat_batches(batches)

    def finish(self) -> SortedBuild:
        b = self._merged()
        if not self._observe:
            return build_table(b, self._key_fields, self._array_range,
                               self._key_ranges)
        n, ((lo, hi, _),) = key_summaries(b, self._key_fields, [0],
                                          first=False)
        seen = (n, lo, hi)
        rng = observed_domain(seen, b.capacity)
        if rng is not None:
            M.record_counter(M.K_JOIN_OBSERVED_RANGE_BUILDS)
        bt = build_table(b, self._key_fields, rng,
                         self._key_ranges if rng is None else (rng,))
        return bt._replace(key_range=seen)


def build_sorted_table_presorted(b: DeviceBatch, key_fields) -> SortedBuild:
    """The SortedBuild of input already sorted by the join keys (a merge
    join's build side): the usable rows compact stably to a prefix, with
    no sort (velox MergeJoin accumulates its right side without hashing
    or sorting). Callers check the order with ``presorted_is_sorted``."""
    cap = b.capacity
    keys = key_values(b, key_fields)
    S.reject_raw(keys, "MergeJoin")
    usable = usable_rows(b, keys)
    n = usable.sum(dtype=torch.int64)
    tgt = torch.where(usable, torch.cumsum(usable.to(torch.int64), 0) - 1,
                      cap)
    iota = torch.arange(cap, dtype=torch.int64, device=b.device)
    perm = scatter_unique_set(cap + 1, tgt, iota)[:cap]
    packed = scatter_unique_set(cap + 1, tgt, pack_key_u64(keys, cap))[:cap]
    in_prefix = iota < n
    packed = torch.where(in_prefix, packed, _U64_MAX)
    dup = (packed[1:] == packed[:-1]) & in_prefix[1:]
    return SortedBuild(packed, perm, b, (b.mask & ~usable).any(), dup.any(),
                       n_usable=n)


def _unsigned_order(packed: torch.Tensor) -> torch.Tensor:
    """Packed keys (uint64 bits in int64) as int64 in the same order."""
    return packed ^ _I64_MIN


def presorted_is_sorted(bt: SortedBuild) -> torch.Tensor:
    """0-dim bool: the compacted key prefix is non-decreasing (the merge
    join's input contract)."""
    k = _unsigned_order(bt.sorted_key)
    return (k[1:] >= k[:-1]).all()


class MergeBuildStage(HashBuildStage):
    """Collects the (presorted) right side of a merge join, through the
    same offload buffer, whose ``restore_all`` keeps the input order the
    contract needs; ``finish`` checks the contract with one host read."""

    def finish(self) -> SortedBuild:
        from velox_tpu_torch.common.errors import VeloxRuntimeError
        bt = build_sorted_table_presorted(self._merged(), self._key_fields)
        if not bool(presorted_is_sorted(bt)):
            raise VeloxRuntimeError(
                "merge join right side is not sorted by the join keys")
        return bt


_NEEDS_RIGHT_PHASE = (P.JoinType.RIGHT, P.JoinType.FULL,
                      P.JoinType.RIGHT_SEMI_FILTER)


def _null_column(dt: T.DataType, cap: int, device,
                 dictionary=None, width: Optional[int] = None
                 ) -> DeviceColumn:
    """An all-NULL column of type `dt` (a long decimal with its hi limb;
    with ``width``, a raw string of that size class)."""
    def zeros(t):
        return torch.zeros((cap,), dtype=t.torch_dtype(), device=device)
    nulls = torch.zeros((cap,), dtype=torch.bool, device=device)
    if width is not None:
        return S.raw_column(torch.zeros((cap, width), dtype=torch.uint8,
                                        device=device),
                            zeros(T.INTEGER), nulls)
    children = (DeviceColumn(zeros(T.BIGINT), None, T.BIGINT),) \
        if dt.is_long_decimal else ()
    return DeviceColumn(zeros(dt), nulls, dt, dictionary, children)


def null_like(col: DeviceColumn, cap: int, device) -> DeviceColumn:
    """An all-NULL column shaped as ``col`` (its dictionary, or its raw
    size class)."""
    return _null_column(col.dtype, cap, device, col.dictionary,
                        col.data.shape[1] if S.is_raw(col) else None)


def emit_right_phase(node: P.HashJoinNode, bt: SortedBuild, matched,
                     probe_cols: Optional[Dict] = None) -> DeviceBatch:
    """The build-side rows a right-side join emits after its last probe
    batch: matched rows (right semi), or unmatched rows with a NULL probe
    side (right/full). String probe columns keep the dictionary (or the
    raw size class) the probe batches carried (``probe_cols``: name -> a
    string column of a probe batch)."""
    jt = node.join_type
    cap = bt.batch.capacity
    if jt is P.JoinType.RIGHT_SEMI_FILTER:
        out = DeviceBatch(dict(bt.batch.columns), bt.batch.mask & matched)
    else:
        lt = node.left.output_type()
        probe_cols = probe_cols or {}
        dev = bt.batch.device
        out_cols = {name: (null_like(probe_cols[name], cap, dev)
                           if name in probe_cols
                           else _null_column(dt, cap, dev))
                    for name, dt in zip(lt.names, lt.children)}
        out_cols.update(bt.batch.columns)
        out = DeviceBatch(out_cols, bt.batch.mask & ~matched)
    if node.output_columns:
        out = DeviceBatch({n: out.columns[n] for n in node.output_columns},
                          out.mask)
    return out


def _scatter_flags(size: int, hit: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """bool[size]: True at ``pos`` where ``hit``."""
    out = torch.zeros((size + 1,), dtype=torch.bool, device=hit.device)
    out[torch.where(hit, pos, size)] = True
    return out[:size]


def _merged_raw(bv: EvalValue, bcap: int, pv: EvalValue, cap: int
                ) -> EvalValue:
    """The (build, probe) concatenation of a raw-string key: a dictionary
    or constant side converts to bytes by one device gather, and the
    narrower size class pads to the wider."""
    from velox_tpu_torch.functions.raw_strings import as_raw
    dev = (bv if S.is_raw(bv) else pv).data.device
    bb, bl, bval = as_raw(bv, bcap, device=dev)
    pb, pl, pval = as_raw(pv, cap, device=dev)
    w = max(bb.shape[1], pb.shape[1])
    validity = None
    if bval is not None or pval is not None:
        validity = torch.cat([bv.full_validity(bcap), pv.full_validity(cap)])
    return S.raw_value(torch.cat([S.pad_width(bb, w), S.pad_width(pb, w)]),
                       torch.cat([bl, pl]), validity)


class HashJoinOperator(Operator):
    """Probe-side operator; the Task hands it the build's SortedBuild
    before the first probe batch."""

    def __init__(self, node: P.HashJoinNode):
        super().__init__(node)
        self._node = node
        self._bt: Optional[SortedBuild] = None
        self._outputs: List[DeviceBatch] = []
        self._unique_build = True
        self._matched = None  # bool[build_cap] for right-side joins
        self._right_done = False
        self._probe_cols: Dict = {}
        self._join_key_ranges = ()

    def set_built_table(self, bt: SortedBuild,
                        unique: Optional[bool] = None):
        """``unique``: whether the build keys are known unique already
        (the distributed join's flag over every shard), else read."""
        node = self._node
        self._bt = bt
        # the union of both sides' plan-level stats narrows the merge-rank
        # sort words (core/stats.py)
        rngs = []
        for lk, rk in zip(node.left_keys, node.right_keys):
            a = resolve_column_stats(node.left, lk.name)
            b = resolve_column_stats(node.right, rk.name)
            rngs.append((min(a[0], b[0]), max(a[1], b[1]))
                        if a is not None and b is not None else None)
        self._join_key_ranges = tuple(rngs)
        # a build keyed on a superset of a provably unique column has no
        # duplicate keys: no host read of the build's flag
        if unique is not None:
            self._unique_build = unique
        elif any(resolve_column_unique(node.right, k.name)
                 for k in node.right_keys):
            self._unique_build = True
        else:
            self._unique_build = not bool(bt.has_dup_keys.item())
        if node.join_type in _NEEDS_RIGHT_PHASE:
            self._matched = torch.zeros((bt.batch.capacity,),
                                        dtype=torch.bool,
                                        device=bt.batch.device)

    # ---- table access --------------------------------------------------------

    def _domain_index(self, batch: DeviceBatch, keys, domain: int):
        """(in_range, clipped int32 domain index) of each probe row's key
        in the array-mode domain."""
        k = keys[0].full_data(batch.capacity).to(torch.int64)
        norm = k - self._bt.arr_base
        in_range = (norm >= 0) & (norm < domain)
        return in_range, torch.clamp(norm, 0, domain - 1).to(torch.int32)

    def _lookup(self, batch: DeviceBatch, bt: SortedBuild):
        """(probe_ok, loc, counts, hit): ``loc`` is each probe row's run
        start in sorted build positions (match m of row r is build row
        perm[loc[r] + m]); ``counts`` its number of matches."""
        keys = key_values(batch, self._node.left_keys)
        probe_ok = usable_rows(batch, keys)
        if bt.arr_start is not None:
            # array mode: two lookups into the dense domain tables
            in_range, idx = self._domain_index(batch, keys,
                                               bt.arr_start.shape[0])
            lo = take_rows(bt.arr_start, idx)
            counts = torch.where(in_range, take_rows(bt.arr_count, idx), 0)
        else:
            lo, counts = self._merge_rank(batch, bt, keys, probe_ok)
            lo = torch.clamp(lo, 0, bt.perm.shape[0] - 1)
        hit = probe_ok & (counts > 0)
        return probe_ok, lo, torch.where(hit, counts, 0), hit

    @spanned("merge_rank")
    def _merge_rank(self, batch: DeviceBatch, bt: SortedBuild, pkeys,
                    probe_ok):
        """(lo, counts) per probe row, in sorted build positions: one sort
        of the concatenated (build, probe) keys, with a trailing 1-bit
        source key that puts build rows first among equal keys."""
        cap = batch.capacity
        bcap = bt.batch.capacity
        m = bcap + cap
        M.record_counter(M.K_JOIN_MERGE_RANK_ROWS, m)
        dev = batch.device
        bkeys = key_values(bt.batch, self._node.right_keys)
        busable = usable_rows(bt.batch, bkeys)
        both_ok = torch.cat([busable, probe_ok])
        merged_keys = []
        for bv, pv in zip(bkeys, pkeys):
            if S.is_raw(bv) or S.is_raw(pv):
                merged_keys.append(_merged_raw(bv, bcap, pv, cap))
                continue
            want = bv.dtype.torch_dtype()
            data = torch.cat([bv.full_data(bcap).to(want),
                              pv.full_data(cap).to(want)])
            validity = None
            if bv.validity is not None or pv.validity is not None:
                validity = torch.cat([bv.full_validity(bcap),
                                      pv.full_validity(cap)])
            children = ()
            if bv.dtype.is_long_decimal:
                children = (DeviceColumn(torch.cat([
                    bv.full_hi(bcap), pv.full_hi(cap)]), None, T.BIGINT),)
            merged_keys.append(EvalValue(data, validity, bv.dtype,
                                         bv.dictionary, children=children))
        src = torch.cat([torch.zeros((bcap,), dtype=torch.bool, device=dev),
                         torch.ones((cap,), dtype=torch.bool, device=dev)])
        merged_keys.append(EvalValue(src, None, T.BOOLEAN))
        words, bits = sort_words(merged_keys, None, m, both_ok,
                                 ranges=self._join_key_ranges + (None,))
        perm, _ = sort_perm_key(words, bits, m)
        ok_sorted = both_ok[perm]
        is_build = (perm < bcap) & ok_sorted
        nb = is_build.to(torch.int64)
        nb_before = torch.cumsum(nb, 0) - nb
        # key-run starts, word by word through the permutation, without
        # the trailing source bit: it may share a packed word with key
        # bits, so the last compared word is shifted right past it
        total = int(sum(bits))
        neq = torch.zeros((m,), dtype=torch.bool, device=dev)
        consumed = 0
        for w, wb in zip(words, bits):
            take = min(wb, (total - 1) - consumed)
            if take <= 0:
                break
            ws = take_rows(w, perm)
            if take < wb:
                ws = ws >> (wb - take)  # words are non-negative
            prev = torch.cat([ws[:1], ws[:-1]])
            neq = neq | (ws != prev)
            consumed += take
        neq[:1] = True
        # build rows before the run start = build rows with a smaller key
        base = torch.cummax(torch.where(neq, nb_before, 0), 0).values
        counts_m = nb_before - base
        # scatter the probe rows' (lo, count) back into probe-row order
        probe_pos = torch.where((perm >= bcap) & ok_sorted, perm - bcap, cap)
        lo = scatter_unique_set(cap + 1, probe_pos, base)[:cap]
        counts = scatter_unique_set(cap + 1, probe_pos, counts_m)[:cap]
        return lo, counts

    def _build_row_at(self, bt: SortedBuild, loc, within):
        """Build row of match ``within`` at run start ``loc``."""
        idx = torch.clamp(loc + within, 0, bt.perm.shape[0] - 1)
        return take_rows(bt.perm, idx)

    def _mark_matched(self, bt: SortedBuild, loc, counts, hit):
        """bool[build_cap]: build rows matched by this probe batch, from a
        difference array over sorted positions (+1 at lo, -1 at hi)."""
        bcap = bt.batch.capacity
        lo_w = torch.where(hit, loc.to(torch.int64), bcap)
        hi_w = torch.where(hit, (loc + counts).to(torch.int64), bcap)
        diff = torch.zeros((bcap + 1,), dtype=torch.int64, device=hit.device)
        one = torch.ones_like(lo_w)
        diff.index_add_(0, lo_w, one)
        diff.index_add_(0, hi_w, -one)
        covered = torch.cumsum(diff[:bcap], 0) > 0
        out = torch.zeros((bcap,), dtype=torch.bool, device=hit.device)
        out[bt.perm] = covered
        return out

    # ---- shared probe pieces -------------------------------------------------

    def _eval_filter(self, out: DeviceBatch, cap: int):
        f = ExprSet([self._node.filter], None).eval_batch(out)[0]
        passed = f.full_data(cap).to(torch.bool)
        if f.validity is not None:
            passed = passed & f.full_validity(cap)
        return passed

    def _project(self, out: DeviceBatch) -> DeviceBatch:
        if self._node.output_columns:
            out = DeviceBatch({n: out.columns[n]
                               for n in self._node.output_columns}, out.mask)
        return out

    def _gather_build_cols(self, build: DeviceBatch, build_row,
                           null_out) -> Dict[str, DeviceColumn]:
        """Build columns at ``build_row``; rows where ``null_out`` is True
        get a NULL build side (outer joins). Only the columns the join
        outputs or its filter reads are gathered."""
        need = None
        if self._node.output_columns:
            need = set(self._node.output_columns)
            if self._node.filter is not None:
                need |= referenced_fields(self._node.filter)
        row = torch.clamp(build_row, 0, None)
        taken = take_columns_rows(
            {name: col for name, col in build.columns.items()
             if need is None or name in need}, row)
        cols = {}
        for name, c in taken.items():
            validity = c.validity
            if null_out is not None:
                validity = (~null_out if validity is None
                            else validity & ~null_out)
            cols[name] = DeviceColumn(c.data, validity, c.dtype,
                                      c.dictionary, c.children, c.starts)
        return cols

    # ---- unique-build fast path (no host sync) -------------------------------

    def _probe_fast(self, batch: DeviceBatch, bt: SortedBuild):
        """Unique build keys and no filter: emit directly. Returns (output
        batch or None, newly matched build rows or None)."""
        node = self._node
        if bt.arr_row1 is not None and self._unique_build:
            # one lookup gives the build row (arr_row1 = row + 1, 0 absent)
            keys = key_values(batch, node.left_keys)
            probe_ok = usable_rows(batch, keys)
            in_range, idx = self._domain_index(batch, keys,
                                               bt.arr_row1.shape[0])
            row1 = take_rows(bt.arr_row1, idx)
            hit = probe_ok & in_range & (row1 > 0)
            build_row = row1 - 1
        else:
            probe_ok, loc, counts, hit = self._lookup(batch, bt)
            build_row = take_rows(bt.perm, loc)
        jt = node.join_type
        bcap = bt.batch.capacity
        new_matched = None
        if self._matched is not None:
            new_matched = _scatter_flags(
                bcap, hit, torch.clamp(build_row, 0, None).to(torch.int64))
        if jt in (P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.RIGHT,
                  P.JoinType.FULL):
            out_cols = dict(batch.columns)
            null_out = None if jt is P.JoinType.INNER else ~hit
            out_cols.update(self._gather_build_cols(bt.batch, build_row,
                                                    null_out))
            keep_all = jt in (P.JoinType.LEFT, P.JoinType.FULL)
            mask = batch.mask if keep_all else (batch.mask & hit)
            out = DeviceBatch(out_cols, mask)
        elif jt is P.JoinType.LEFT_SEMI_FILTER:
            out = DeviceBatch(batch.columns, batch.mask & hit)
        elif jt is P.JoinType.RIGHT_SEMI_FILTER:
            # the probe side emits nothing; the right phase emits matches
            return None, new_matched
        elif jt is P.JoinType.ANTI:
            miss = batch.mask & ~hit
            if getattr(node, "null_aware", False):
                miss = miss & ~bt.has_null_key & probe_ok
            out = DeviceBatch(batch.columns, miss)
        else:
            raise NotImplementedError(f"join type {jt}")
        return self._project(out), new_matched

    # ---- expanding probe (count + emit chunks) -------------------------------

    def _probe_counts(self, batch: DeviceBatch, bt: SortedBuild):
        """First pass of the count path (duplicate keys and/or a filter):
        per-row candidate counts and their inclusive prefix sum. Returns
        ((loc, hit) or None, cum, newly matched)."""
        node = self._node
        probe_ok, loc, counts, hit = self._lookup(batch, bt)
        jt = node.join_type
        has_filter = node.filter is not None
        expand = jt in (P.JoinType.INNER, P.JoinType.RIGHT,
                        P.JoinType.LEFT, P.JoinType.FULL)
        # semi/anti joins with a filter expand candidates to evaluate it
        if has_filter and jt in (P.JoinType.LEFT_SEMI_FILTER,
                                 P.JoinType.RIGHT_SEMI_FILTER,
                                 P.JoinType.ANTI):
            expand = True
        new_matched = None
        if self._matched is not None and not has_filter:
            new_matched = self._mark_matched(bt, loc, counts, hit)
        if not expand:
            # only a RIGHT_SEMI_FILTER over duplicate keys: its probe side
            # emits nothing, and the right phase emits the marked rows
            return None, None, new_matched
        exp_counts = counts
        if jt in (P.JoinType.LEFT, P.JoinType.FULL) and not has_filter:
            exp_counts = torch.where(hit, counts, batch.mask.to(counts.dtype))
        cum = torch.cumsum(exp_counts.to(torch.int64), 0)
        return (loc, hit), cum, new_matched

    def _emit_chunk(self, batch: DeviceBatch, bt: SortedBuild, loc, hit,
                    cum, start: int):
        """Candidate rows [start, start + cap) of the expansion. Returns
        (output batch, probe row, build row, passed, valid); without a
        filter the output is final."""
        node = self._node
        cap = batch.capacity
        j = start + torch.arange(cap, dtype=torch.int64, device=cum.device)
        valid = j < cum[-1]
        # probe row of candidate j: the first row whose inclusive sum > j
        row_c = torch.clamp(torch.searchsorted(cum, j, right=True), 0,
                            cap - 1)
        ends = take_rows(cum, row_c)
        counts_r = ends - torch.where(
            row_c > 0, take_rows(cum, torch.clamp(row_c - 1, 0, None)), 0)
        within = j - (ends - counts_r)
        row_hit = hit[row_c]
        build_row = torch.where(
            row_hit, self._build_row_at(bt, take_rows(loc, row_c), within),
            -1)
        out_cols = take_columns_rows(batch.columns, row_c)
        null_out = None
        if node.join_type in (P.JoinType.LEFT, P.JoinType.FULL):
            null_out = ~row_hit
        out_cols.update(self._gather_build_cols(bt.batch, build_row,
                                                null_out))
        out = DeviceBatch(out_cols, valid)
        if node.filter is None:
            return self._project(out), row_c, build_row, valid, valid
        passed = self._eval_filter(out, cap) & valid & row_hit
        out = DeviceBatch(out.columns, out.mask & passed)
        return self._project(out), row_c, build_row, passed, valid

    def _probe_filtered(self, batch: DeviceBatch, bt: SortedBuild, loc, hit,
                        cum, n_total: int):
        """Emit chunks with a filter, tracking probe rows and build rows
        with a passing candidate, and emit each join type's rows (velox
        HashProbe.cpp filter semantics for outer/semi/anti joins)."""
        node, jt = self._node, self._node.join_type
        cap = batch.capacity
        bcap = bt.batch.capacity
        row_pass = torch.zeros((cap,), dtype=torch.bool, device=batch.device)
        bld_pass = torch.zeros((bcap,), dtype=torch.bool,
                               device=batch.device)
        chunks = []
        for start in range(0, n_total, cap):
            out, row_c, build_row, passed, _ = self._emit_chunk(
                batch, bt, loc, hit, cum, start)
            row_pass = row_pass | _scatter_flags(cap, passed, row_c)
            bld_pass = bld_pass | _scatter_flags(
                bcap, passed, torch.clamp(build_row, 0, None))
            if jt in (P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.FULL,
                      P.JoinType.RIGHT):
                chunks.append(out)
        if self._matched is not None:
            self._matched = self._matched | bld_pass
        if jt in (P.JoinType.INNER, P.JoinType.RIGHT):
            self._outputs.extend(chunks)
            return
        if jt in (P.JoinType.LEFT, P.JoinType.FULL):
            self._outputs.extend(chunks)
            # probe rows without a passing candidate: one null-build row
            out_cols = dict(batch.columns)
            out_cols.update(self._gather_build_cols(
                bt.batch, torch.full((cap,), -1, dtype=torch.int64,
                                     device=batch.device),
                torch.ones((cap,), dtype=torch.bool, device=batch.device)))
            self._outputs.append(self._project(DeviceBatch(
                out_cols, batch.mask & ~row_pass)))
            return
        if jt is P.JoinType.LEFT_SEMI_FILTER:
            self._outputs.append(self._project(
                DeviceBatch(batch.columns, batch.mask & row_pass)))
            return
        if jt is P.JoinType.RIGHT_SEMI_FILTER:
            return  # the right phase emits the matched build rows
        if jt is P.JoinType.ANTI:
            if getattr(node, "null_aware", False):
                raise NotImplementedError("filter on null-aware anti join")
            self._outputs.append(self._project(
                DeviceBatch(batch.columns, batch.mask & ~row_pass)))
            return
        raise NotImplementedError(f"filtered join type {jt}")

    # ---- operator contract ---------------------------------------------------

    def add_input(self, batch: DeviceBatch):
        if self._bt is None:
            raise RuntimeError("build side not finished")
        bt = self._bt
        jt = self._node.join_type
        has_filter = self._node.filter is not None
        for name, col in batch.columns.items():
            if col.dictionary is not None or S.is_raw(col):
                self._probe_cols[name] = col
        needs_count_path = has_filter or (not self._unique_build and jt in (
            P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.RIGHT,
            P.JoinType.FULL, P.JoinType.RIGHT_SEMI_FILTER))
        if not needs_count_path:
            out, new_matched = self._probe_fast(batch, bt)
            self._merge_matched(new_matched)
            if out is not None:
                self._outputs.append(out)
            return
        loc_hit, cum, new_matched = self._probe_counts(batch, bt)
        self._merge_matched(new_matched)
        if loc_hit is None:
            return
        loc, hit = loc_hit
        n_total = int(cum[-1].item())  # the one host read of the batch
        if has_filter:
            self._probe_filtered(batch, bt, loc, hit, cum, n_total)
            return
        for start in range(0, n_total, batch.capacity):
            out, _, _, _, _ = self._emit_chunk(batch, bt, loc, hit, cum,
                                               start)
            self._outputs.append(out)

    def _merge_matched(self, new_matched) -> None:
        if new_matched is not None:
            self._matched = self._matched | new_matched

    def no_more_input(self):
        super().no_more_input()
        if self._matched is not None and not self._right_done:
            self._right_done = True
            self._outputs.append(emit_right_phase(
                self._node, self._bt, self._matched, self._probe_cols))

    def get_output(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def needs_input(self):
        return not self._no_more_input and not self._outputs

    def is_finished(self):
        return self._no_more_input and not self._outputs


class MergeJoinOperator(HashJoinOperator):
    """Sorted-input join (velox/exec/MergeJoin.h:45): every join type,
    filter and right phase of HashJoinOperator, over a build that
    compacted without a sort; each probe row finds its run of equal build
    keys by two binary searches over the packed build keys. The probe
    side need not be sorted: each row searches on its own."""

    def _lookup(self, batch: DeviceBatch, bt: SortedBuild):
        keys = key_values(batch, self._node.left_keys)
        S.reject_raw(keys, "MergeJoin")
        probe_ok = usable_rows(batch, keys)
        sk = _unsigned_order(bt.sorted_key)
        pk = _unsigned_order(pack_key_u64(keys, batch.capacity))
        lo = torch.searchsorted(sk, pk)
        # the MAX-padded tail: a real key can pack to MAX too, so the run
        # is clamped to the usable prefix
        hi = torch.minimum(torch.searchsorted(sk, pk, right=True),
                           bt.n_usable)
        counts = hi - lo
        hit = probe_ok & (counts > 0) & (lo < bt.n_usable)
        return (probe_ok, torch.clamp(lo, 0, bt.perm.shape[0] - 1),
                torch.where(hit, counts, 0), hit)
