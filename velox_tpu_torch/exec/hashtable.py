"""Device hash table: batched linear-probe insert and lookup rounds.

Counterpart of ``velox_tpu/exec/hashtable.py`` (velox/exec/HashTable.h
and VectorHasher): a struct-of-arrays table in device memory, one column
per key in its native dtype plus ``slot_row``, probed in **batched
linear-probe rounds**. In each round every pending row gathers its slot
(all of the table's columns through one index: kernel B5,
ops/gather.py ``take_many_rows``) and compares keys; rows that found an
empty slot claim it with a scatter-min ticket, so the smallest row id
wins a contested slot and writes its keys, and same-key losers resolve
on the re-check. The reference runs its rounds over every row in
``lax.while_loop``; here the host runs them over the rows still pending,
compacted each round (each compaction reads its row count: a few host
reads a round), so a round costs what its pending rows cost.

Differences from the reference:

* *Occupancy is* ``slot_row >= 0``, and a key's validity is stored as
  int32 (a key narrower than 4 bytes as int32 too), so that every column
  of the table is a 4- or 8-byte lane B5 gathers.
* *Only the rows that write, write.* The reference sends the claims and
  key writes of rows that do not take part to a dropped slot. On the
  H100 such a slot serializes: every one of a batch's rows hit it each
  round, and the claim's ``scatter_reduce_`` took 7.3 ms a round there
  on SF10 lineitem batches (PERF.md). Here only the rows on an empty
  slot claim, and only the winners write.
* *The table grows.* The reference sizes a streaming operator's table
  once, from its first batch, and its insert loops forever once the
  stream's distinct keys fill it. ``reserve`` rehashes into a table twice
  as large or more before a batch could push the load past one half, and
  carries per-slot state to the new slots. ``insert`` and ``lookup``
  raise ``RuntimeError`` after more rounds than the table has slots,
  which only a full table can need.
* torch has no uint32 shifts, so the hash works on int64 holding 32-bit
  values, masked after each multiply (the reference's constants).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from velox_tpu_torch.common.process_trace import spanned
from velox_tpu_torch.exec.sort import value_words
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.ops.gather import take_many_rows, take_rows

_M32 = 0xFFFFFFFF


def table_size_for(n: int, load: float = 0.5) -> int:
    """Power-of-two table size with max `load` fill."""
    want = max(16, int(n / load))
    return 1 << (want - 1).bit_length()


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """The reference's 32-bit finalizer over int64 values in [0, 2^32):
    an int64 product wraps mod 2^64, so its low 32 bits are exact."""
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def hash_rows(keys: Sequence[EvalValue], capacity: int) -> torch.Tensor:
    """A 32-bit hash per row (int64) from all key columns, through their
    order-preserving words; a null key hashes as the word 0."""
    dev = keys[0].data.device
    h = torch.full((capacity,), 0x9E3779B9, dtype=torch.int64, device=dev)
    for v in keys:
        for w in value_words(v, capacity):
            if v.validity is not None:
                w = torch.where(v.full_validity(capacity), w, 0)
            h = _mix32(h ^ w)
    return h


def bloom_hashes(v: EvalValue, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h1, h2), 32-bit hashes (int64) of a value for a double-hashed
    bloom filter: probe i of k sets bit (h1 + i * h2) mod m. The
    reference's layout, bit for bit. The hashes follow the value, not its
    storage: a dictionary string hashes its text (crc32 of the UTF-8, one
    host pass over the dictionary, then a gather by id) and a number its
    type's canonical width, so two columns with other dictionaries or
    widths agree. A raw string raises, as in the reference."""
    if v.dtype.is_string:
        if v.dictionary is None:
            raise NotImplementedError(
                "bloom over non-dictionary string columns")
        import zlib
        table = torch.tensor([zlib.crc32(str(x).encode("utf-8"))
                              for x in v.dictionary.values] or [0],
                             dtype=torch.int64, device=v.data.device)
        ids = torch.clamp(v.full_data(capacity).to(torch.int64), 0,
                          table.shape[0] - 1)
        h1 = _mix32(take_rows(table, ids) ^ 0x9E3779B9)
    else:
        want = v.dtype.torch_dtype()
        data = v.full_data(capacity)
        if data.dtype != want:
            v = EvalValue(data.to(want), v.validity, v.dtype)
        h1 = hash_rows([v], capacity)
    return h1, _mix32(h1 ^ 0xB5297A4D)


def _lane(d: torch.Tensor) -> torch.Tensor:
    """A key column as a lane B5 gathers: narrower than 4 bytes -> int32."""
    return d.to(torch.int32) if d.element_size() < 4 else d


class HashTable(NamedTuple):
    """Table state: one entry a slot in every array."""
    key_cols: Tuple[torch.Tensor, ...]   # per key: data lane
    key_valid: Tuple[torch.Tensor, ...]  # per key: int32, 1 = non-null
    slot_row: torch.Tensor               # int32: inserting row, -1 empty

    @property
    def size(self) -> int:
        return self.slot_row.shape[0]

    def occupied(self) -> torch.Tensor:
        return self.slot_row >= 0


def empty_table(keys: Sequence[EvalValue], size: int) -> HashTable:
    dev = keys[0].data.device
    cols = tuple(torch.zeros((size,), dtype=_lane(v.data).dtype,
                             device=dev) for v in keys)
    valids = tuple(torch.ones((size,), dtype=torch.int32, device=dev)
                   for _ in keys)
    return HashTable(cols, valids,
                     torch.full((size,), -1, dtype=torch.int32, device=dev))


def _keys_data(keys: Sequence[EvalValue], capacity: int
               ) -> List[torch.Tensor]:
    """Per key its data lane (null lanes zeroed), then per key its int32
    validity."""
    datas, valids = [], []
    for v in keys:
        d = _lane(v.full_data(capacity))
        if v.validity is not None:
            val = v.full_validity(capacity)
            d = torch.where(val, d, torch.zeros((), dtype=d.dtype,
                                                device=d.device))
            valids.append(val.to(torch.int32))
        else:
            valids.append(torch.ones((capacity,), dtype=torch.int32,
                                     device=d.device))
        datas.append(d)
    return datas + valids


def _probe(table: HashTable, pos: torch.Tensor, lanes):
    """(occupied, matches) of slot ``pos`` per row: every table column
    through one index (B5). ``lanes`` is ``_keys_data``'s list."""
    got = take_many_rows(list(table.key_cols) + list(table.key_valid)
                         + [table.slot_row], pos)
    occ = got[-1] >= 0
    m = occ
    for col, lane in zip(got[:-1], lanes):
        m = m & (col == lane)
    return occ, m


class _Pending:
    """The rows a probe loop has not resolved, compacted: their row ids,
    hashes and key lanes."""

    def __init__(self, keys, active, capacity: int):
        self.rows = active.nonzero().squeeze(1)
        self.h, *self.lanes = take_many_rows(
            [hash_rows(keys, capacity)] + _keys_data(keys, capacity),
            self.rows)

    def keep(self, still: torch.Tensor) -> None:
        sel = still.nonzero().squeeze(1)
        if sel.shape[0] == 0:
            self.rows = self.rows[:0]
            return
        self.rows = take_rows(self.rows, sel)
        self.h, *self.lanes = take_many_rows([self.h] + self.lanes, sel)

    def __len__(self) -> int:
        return self.rows.shape[0]


def _check_rounds(r: int, table: HashTable, what: str) -> None:
    if r >= table.size:
        raise RuntimeError(
            f"hash table {what}: rows still unresolved after {r} rounds "
            f"over {table.size} slots (the table is full)")


@spanned("hash_insert")
def insert(table: HashTable, keys: Sequence[EvalValue], active,
           capacity: int):
    """Insert active rows' keys; returns (table, slots, is_new).

    slots[i] = the slot of row i's key (-1 for inactive rows); is_new[i]
    = True iff row i created its slot. NULL keys group like values (SQL
    GROUP BY semantics). The table's arrays are updated in place.
    ``insert.rounds`` counts the rounds run."""
    S = table.size
    dev = active.device
    slots = torch.full((capacity,), -1, dtype=torch.int64, device=dev)
    is_new = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    # scatter-min tickets, reset after each round where they were taken
    claim = torch.full((S,), capacity, dtype=torch.int64, device=dev)
    p = _Pending(keys, active, capacity)
    r = 0
    while len(p):
        _check_rounds(r, table, "insert")
        pos = (p.h + r) & (S - 1)
        occ, done = _probe(table, pos, p.lanes)
        e = (~occ).nonzero().squeeze(1)  # rows on an empty slot
        if e.shape[0]:
            pe, re = take_rows(pos, e), take_rows(p.rows, e)
            lanes = take_many_rows(p.lanes, e)
            # the smallest row id wins each contested empty slot
            claim.scatter_reduce_(0, pe, re, "amin")
            won = (take_rows(claim, pe) == re).nonzero().squeeze(1)
            claim[pe] = capacity
            pw = take_rows(pe, won)
            for col, lane in zip(table.key_cols + table.key_valid,
                                 take_many_rows(lanes, won)):
                col[pw] = lane
            wrows = take_rows(re, won)
            table.slot_row[pw] = wrows.to(torch.int32)
            is_new[wrows] = True
            # re-check after the writes: winners and same-key losers
            done[e] = _probe(table, pe, lanes)[1]
        d = done.nonzero().squeeze(1)
        slots[take_rows(p.rows, d)] = take_rows(pos, d)
        p.keep(~done)
        r += 1
        insert.rounds += 1
    return table, slots, is_new


insert.rounds = 0


@spanned("hash_lookup")
def lookup(table: HashTable, keys: Sequence[EvalValue], active,
           capacity: int):
    """Probe; returns (slots, found). Stops at the first empty slot
    (absent): valid for linear probing without deletions.
    ``lookup.rounds`` counts the rounds run."""
    S = table.size
    dev = active.device
    slots = torch.full((capacity,), -1, dtype=torch.int64, device=dev)
    found = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    p = _Pending(keys, active, capacity)
    r = 0
    while len(p):
        _check_rounds(r, table, "lookup")
        pos = (p.h + r) & (S - 1)
        occ, match = _probe(table, pos, p.lanes)
        hit = match.nonzero().squeeze(1)
        hit_rows = take_rows(p.rows, hit)
        slots[hit_rows] = take_rows(pos, hit)
        found[hit_rows] = True
        p.keep(occ & ~match)
        r += 1
        lookup.rounds += 1
    return slots, found


lookup.rounds = 0


def extract_keys(table: HashTable,
                 keys: Sequence[EvalValue]) -> List[EvalValue]:
    """Per-slot key columns as EvalValues (length = table size), in each
    key's own dtype."""
    out = []
    for v, col, cval in zip(keys, table.key_cols, table.key_valid):
        validity = None if v.validity is None else cval != 0
        out.append(EvalValue(col.to(v.data.dtype), validity, v.dtype,
                             v.dictionary))
    return out


def reserve(table: HashTable, keys: Sequence[EvalValue], live: int,
            incoming: int, states: Sequence[torch.Tensor] = ()):
    """Make room for ``incoming`` more keys beside ``live`` occupied
    slots: if they could push the load past one half, rehash into a table
    of ``table_size_for(live + incoming)`` slots (twice the size or more).
    ``keys`` gives the key types. Per-slot ``states`` move with their
    keys. Returns (table, states). ``reserve.rehashes`` counts the
    rehashes."""
    if live + incoming <= table.size // 2:
        return table, tuple(states)
    old = table
    new_size = max(table_size_for(live + incoming), 2 * old.size)
    idx = old.occupied().nonzero().squeeze(1)
    n = idx.shape[0]
    cols = take_many_rows(list(old.key_cols) + list(old.key_valid)
                          + [old.slot_row] + list(states), idx)
    k = len(keys)
    old_keys = [EvalValue(col, None if v.validity is None else val != 0,
                          v.dtype, v.dictionary)
                for v, col, val in zip(keys, cols[:k], cols[k:2 * k])]
    table = empty_table(old_keys, new_size)
    # every old key is distinct, so no slot is contested by equal keys
    table, slots, _ = insert(table, old_keys,
                             torch.ones((n,), dtype=torch.bool,
                                        device=idx.device), n)
    table.slot_row[slots] = cols[2 * k]
    moved = []
    for st, kept in zip(states, cols[2 * k + 1:]):
        out = torch.zeros((new_size,), dtype=st.dtype, device=st.device)
        out[slots] = kept
        moved.append(out)
    reserve.rehashes += 1
    return table, tuple(moved)


reserve.rehashes = 0


class StreamTable:
    """The table of a streaming operator (MarkDistinct, RowNumber): sized
    from the first batch's capacity as the reference's, then grown by
    ``reserve`` before each batch; ``states`` are per-slot int64 arrays
    that move with their keys."""

    def __init__(self, n_states: int = 0):
        self.table = None
        self.states: Tuple[torch.Tensor, ...] = ()
        self._n_states = n_states
        self._live = 0  # occupied slots

    def insert(self, keys: Sequence[EvalValue], active, capacity: int):
        """``insert`` of a batch after making room; returns (slots,
        is_new)."""
        if self.table is None:
            self.table = empty_table(keys, table_size_for(capacity))
            self.states = tuple(
                torch.zeros((self.table.size,), dtype=torch.int64,
                            device=active.device)
                for _ in range(self._n_states))
        self.table, self.states = reserve(self.table, keys, self._live,
                                          int(active.sum()), self.states)
        _, slots, is_new = insert(self.table, keys, active, capacity)
        self._live += int(is_new.sum())
        return slots, is_new
