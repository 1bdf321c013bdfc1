"""Radix sort: LSD counting sort over order-preserving unsigned words.

Counterpart of ``velox_tpu/exec/sort.py`` (velox/exec/PrefixSort.h:92 +
prefixsort/PrefixSortEncoder.h: normalized binary-comparable keys, then a
sort). Keys become order-preserving unsigned words, packed by bit width;
the permutation comes from the module's own counting radix sort, whose
every 8-bit pass runs the hand-written kernels of ``ops/radix.py``:

* keys + row id within 64 bits: ``_scatter_sort_perm``, one histogram
  (B4) and one place-and-scatter (B3) launch a pass over the 64-bit
  state, no row gather;
* otherwise the classic loop, ``_classic_sort_perm``: each 32-bit word
  gathered once through the permutation (B5), then one histogram (B4)
  and one rank-and-scatter (B2) launch a pass, which carry the word and
  the permutation.

The reference sends every key of at most four u64 lanes to ``lax.sort``
instead, a cap that exists for XLA:TPU compile time only; the port has
one sort for every key width, and a stable sort permutation is unique,
so the two give the same permutation.

Key encoding (the reference's):

* signed ints  -> biased unsigned words (hi/lo for 64-bit)
* f32          -> monotone u32 via an int32 view + sign fold
* f64          -> three f32 words (hi = f32(x), lo = f32(x - hi),
                  lo2 = f32(x - hi - lo))
* long decimal -> four words: the hi limb biased, then the lo limb's
                  halves
* strings      -> sorted-dictionary ids; a raw string's W/4 big-endian
                  byte words and its length word (vector/strings.py)
* descending   -> every value word inverted
* nulls        -> a leading 1-bit field per nullable key
* active       -> the most significant bit: inactive rows sort last

Representation: this build of torch has no shifts for uint32/uint64 and
no uint64 indexing, so a word (the reference's uint32) is an int64 tensor
holding a value in [0, 2^32), and a packed lane (the reference's uint64)
is an int64 tensor holding the same 64 bits in two's complement. Right
shifts of a lane are masked to the field they extract. Permutations are
int64, torch's index type.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common.process_trace import spanned
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.ops.gather import flat_gather
from velox_tpu_torch.ops.radix import (RADIX, _destinations, radix_hist,
                                       radix_rank_scatter,
                                       radix_scatter_pass)
from velox_tpu_torch.vector import strings as S

_M32 = 0xFFFFFFFF
_DIGIT_BITS = RADIX.bit_length() - 1  # bits a radix pass consumes
_SIGN32 = 1 << 31


def _f32_monotone_u32(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64)
    u = bits & _M32
    return torch.where(bits < 0, u ^ _M32, u | _SIGN32)


def _signed_words(data: torch.Tensor) -> List[torch.Tensor]:
    """Biased unsigned words (most significant first) for an integer
    tensor."""
    if data.dtype == torch.int64:
        return [(data >> 32) + _SIGN32, data & _M32]
    return [data.to(torch.int64) + _SIGN32]


def value_words(v: EvalValue, capacity: int) -> List[torch.Tensor]:
    """Order-preserving unsigned words, most significant first. An
    ARRAY/MAP/ROW value has none: a sort, group or join key of such a
    type raises (the reference orders an ARRAY by its element count and
    fails on a group key)."""
    dt = v.dtype
    if dt.is_complex:
        raise NotImplementedError(
            f"a {dt} sort, grouping or join key is not supported")
    if dt.is_string and v.dictionary is None:
        if v.data is None or v.data.dim() != 2:
            raise ValueError("a string sort key needs a dictionary or raw "
                             "bytes")
        words, _ = S.sort_key_words(v.data, S.lens_of(v))
        return words
    data = v.full_data(capacity)
    if dt.is_long_decimal:
        # int128 limbs: the signed hi limb biased like an int64, then the
        # unsigned lo limb's two halves (ops/int128.py)
        return _signed_words(v.full_hi(capacity)) + [(data >> 32) & _M32,
                                                      data & _M32]
    if dt.kind is T.TypeKind.DOUBLE:
        d64 = data.to(torch.float64)
        hi = d64.to(torch.float32)
        lo = (d64 - hi.to(torch.float64)).to(torch.float32)
        lo2 = (d64 - hi.to(torch.float64)
               - lo.to(torch.float64)).to(torch.float32)
        return [_f32_monotone_u32(hi), _f32_monotone_u32(lo),
                _f32_monotone_u32(lo2)]
    if dt.kind is T.TypeKind.REAL:
        return [_f32_monotone_u32(data)]
    if dt.kind is T.TypeKind.BOOLEAN:
        return [data.to(torch.int64)]
    if dt.is_string:
        return _signed_words(data.to(torch.int32))
    return _signed_words(data)


def _narrow_bits(v: EvalValue, rng) -> int:
    """Static bit width of the normalized (value - min) field, or -1 when
    the key cannot be narrowed: dictionary strings narrow to their id
    range, BOOLEAN to 1 bit, integral/DATE/DECIMAL keys to the span of
    their true (min, max) storage bounds (core/stats.py)."""
    dt = v.dtype
    if dt.is_long_decimal or S.is_raw(v):
        return -1
    if dt.kind is T.TypeKind.BOOLEAN:
        return 1
    if dt.is_string and v.dictionary is not None:
        return max(0, max(1, len(v.dictionary)) - 1).bit_length()
    if rng is None:
        return -1
    if not (dt.is_integral or dt.kind in (T.TypeKind.DATE,
                                          T.TypeKind.DECIMAL)):
        return -1
    lo, hi = int(rng[0]), int(rng[1])
    span = hi - lo
    if span < 0 or span >= (1 << 32):
        return -1
    return span.bit_length()


class KeyFieldLayout:
    """Bit layout of one sort key inside the packed msb-first key stream,
    enough to decode the key value back out of sorted lane words.

    kind: 'const' (no bits; value == base), 'narrow' (value = base +
    bits), 'words' (full-width order-preserving words), 'raw' (a raw
    string's byte words and length word; base holds the width W),
    'opaque' (not invertible: DOUBLE's three-f32 split, int128 limbs)."""

    __slots__ = ("kind", "off", "nb", "base", "desc", "null_off",
                 "null_is_one", "dtype", "arr_dtype", "dictionary")

    def __init__(self, kind, off, nb, base, desc, null_off, null_is_one,
                 dtype, arr_dtype, dictionary):
        self.kind = kind
        self.off = off
        self.nb = nb
        self.base = base
        self.desc = desc
        self.null_off = null_off
        self.null_is_one = null_is_one
        self.dtype = dtype
        self.arr_dtype = arr_dtype
        self.dictionary = dictionary

    @property
    def decodable(self) -> bool:
        return self.kind != "opaque"


def sort_words(keys: Sequence[EvalValue], orders, capacity: int, active,
               ranges=None):
    words, bits, _ = sort_words_layout(keys, orders, capacity, active,
                                       ranges)
    return words, bits


@spanned("sort_keys")
def sort_words_layout(keys: Sequence[EvalValue], orders, capacity: int,
                      active, ranges=None):
    """(words, bit_widths, layout) for a multi-key sort, most significant
    first; ``layout`` holds one KeyFieldLayout per key.

    `orders` is a list of plan.SortOrder or None entries (None: grouping
    only). The leading bit puts inactive rows last. `ranges` optionally
    gives (min, max) storage bounds per key: narrowed keys are bit-packed
    msb-first into shared 32-bit words, so the number of radix passes
    follows the information content of the key tuple.
    """
    # fields: (int64 tensor with the value in the low nb bits, nb)
    fields = [((~active).to(torch.int64), 1)]
    layout: List[KeyFieldLayout] = []
    off = 1  # bit offset after the leading active bit
    for i, v in enumerate(keys):
        order = orders[i] if orders is not None else None
        desc = order is not None and not order.ascending
        rng = ranges[i] if ranges is not None else None
        null = None
        null_off = None
        null_is_one = True
        if v.validity is not None:
            null = ~v.full_validity(capacity)
            nulls_first = order is not None and order.nulls_first
            nw = (null ^ nulls_first).to(torch.int64) \
                if order is not None else null.to(torch.int64)
            fields.append((nw, 1))
            null_off = off
            null_is_one = not (order is not None and nulls_first)
            off += 1
        arr_dt = v.full_data(capacity).dtype
        nb = _narrow_bits(v, rng)
        if nb == 0:
            base = 0 if (v.dtype.is_string
                         or v.dtype.kind is T.TypeKind.BOOLEAN) \
                else int(rng[0])
            layout.append(KeyFieldLayout(
                "const", off, 0, base, desc, null_off, null_is_one,
                v.dtype, arr_dt, v.dictionary))
            continue  # provably constant: contributes nothing
        if nb > 0:
            data = v.full_data(capacity)
            if v.dtype.is_string or v.dtype.kind is T.TypeKind.BOOLEAN:
                base = 0
            else:
                base = int(rng[0])
            mask = (1 << nb) - 1
            w = (data.to(torch.int64) - base) & mask
            if null is not None:
                w = torch.where(null, 0, w)
            if desc:
                w = w ^ mask
            fields.append((w, nb))
            layout.append(KeyFieldLayout(
                "narrow", off, nb, base, desc, null_off, null_is_one,
                v.dtype, arr_dt, v.dictionary))
            off += nb
            continue
        vw = value_words(v, capacity)
        if null is not None:
            vw = [torch.where(null, 0, x) for x in vw]
        if desc:
            vw = [x ^ _M32 for x in vw]
        fields.extend((x, 32) for x in vw)
        # DOUBLE's three-f32 split and int128 limbs are not invertible
        kind, base = "words", 0
        if v.dtype.kind is T.TypeKind.DOUBLE or v.dtype.is_long_decimal:
            kind = "opaque"
        elif S.is_raw(v):
            kind, base = "raw", int(v.data.shape[1])
        layout.append(KeyFieldLayout(
            kind, off, 32 * len(vw), base, desc, null_off, null_is_one,
            v.dtype, arr_dt, v.dictionary))
        off += 32 * len(vw)

    # msb-first bit packing into up-to-32-bit words
    words: List[torch.Tensor] = []
    bits: List[int] = []
    cur = None
    cur_bits = 0
    for val, nb in fields:
        while nb > 0:
            take = min(32 - cur_bits, nb)
            piece = (val >> (nb - take)) & ((1 << take) - 1)
            cur = piece if cur is None else ((cur << take) | piece)
            cur_bits += take
            nb -= take
            if cur_bits == 32:
                words.append(cur)
                bits.append(32)
                cur, cur_bits = None, 0
    if cur_bits:
        words.append(cur)
        bits.append(cur_bits)
    return words, bits, layout


def extract_lane_bits(lanes: List[torch.Tensor], lane_bits: List[int],
                      off: int, nb: int) -> torch.Tensor:
    """The ``nb``-bit field at msb-first stream offset ``off`` of packed
    lanes (inverse of pack_words_u64), nb <= 32, as an int64 word."""
    if nb > 32:
        raise ValueError(f"extract_lane_bits takes at most 32 bits, not {nb}")
    lane_start = 0
    for lane, lb in zip(lanes, lane_bits):
        if off < lane_start + lb:
            s = off - lane_start
            avail = lb - s
            if avail >= nb:
                # the mask drops the sign bits an arithmetic shift adds
                return (lane >> (lb - s - nb)) & ((1 << nb) - 1)
            # spans into the next lane
            hi = lane & ((1 << avail) - 1)
            rest = extract_lane_bits(lanes, lane_bits, lane_start + lb,
                                     nb - avail)
            return (hi << (nb - avail)) | rest
        lane_start += lb
    raise ValueError(f"bit range [{off}, {off + nb}) beyond lanes")


def _decode_f32_word(u: torch.Tensor) -> torch.Tensor:
    """Inverse of _f32_monotone_u32."""
    neg = (u & _SIGN32) == 0
    bits_u = torch.where(neg, u ^ _M32, u ^ _SIGN32)
    return bits_u.to(torch.int32).view(torch.float32)


def decode_key_field(f: KeyFieldLayout, lanes: List[torch.Tensor],
                     lane_bits: List[int], capacity: int):
    """(data, isnull_or_None) for one key decoded from packed lanes with
    the sort_words bit layout (sorted or compacted)."""
    isnull = None
    if f.null_off is not None:
        nb = extract_lane_bits(lanes, lane_bits, f.null_off, 1)
        isnull = (nb == 1) if f.null_is_one else (nb == 0)
    dev = lanes[0].device if lanes else None
    if f.kind == "const":
        return torch.full((capacity,), f.base, dtype=f.arr_dtype,
                          device=dev), isnull
    if f.kind == "narrow":
        w = extract_lane_bits(lanes, lane_bits, f.off, f.nb)
        if f.desc:
            w = w ^ ((1 << f.nb) - 1)
        if f.dtype.kind is T.TypeKind.BOOLEAN:
            return (w != 0).to(f.arr_dtype), isnull
        return (w + f.base).to(f.arr_dtype), isnull
    if f.kind == "words":
        nwords = f.nb // 32
        ws = [extract_lane_bits(lanes, lane_bits, f.off + 32 * j, 32)
              for j in range(nwords)]
        if f.desc:
            ws = [w ^ _M32 for w in ws]
        dt = f.dtype
        if dt.kind is T.TypeKind.BOOLEAN:
            return (ws[0] != 0).to(f.arr_dtype), isnull
        if dt.kind is T.TypeKind.REAL:
            return _decode_f32_word(ws[0]).to(f.arr_dtype), isnull
        if nwords == 1:  # biased int32 (dictionary ids and DATE included)
            return (ws[0] - _SIGN32).to(f.arr_dtype), isnull
        if nwords == 2:  # biased-hi int64
            hi = ws[0] - _SIGN32
            return (hi * (1 << 32) + ws[1]).to(f.arr_dtype), isnull
    if f.kind == "raw":
        # W/4 big-endian byte words and the length word: the byte matrix
        # comes back by shifts, with no gather
        ws = [extract_lane_bits(lanes, lane_bits, f.off + 32 * j, 32)
              for j in range(f.nb // 32)]
        if f.desc:
            ws = [w ^ _M32 for w in ws]
        cols = [(ws[j] >> sh) & 0xFF for j in range(f.base // 4)
                for sh in (24, 16, 8, 0)]
        data = torch.stack(cols, dim=1).to(torch.uint8)
        return (data, ws[-1].to(torch.int32)), isnull
    raise NotImplementedError(f"cannot decode key field kind {f.kind}")


def pack_words_u64(words: List[torch.Tensor],
                   bits: List[int]) -> List[torch.Tensor]:
    """Pack order-preserving words into as few 64-bit lanes as possible
    (words[0] most significant), greedy msb-first. A lane is an int64
    tensor holding the reference's uint64 bits."""
    lanes: List[torch.Tensor] = []
    cur = None
    cur_bits = 0
    for w, nb in zip(words, bits):
        while nb > 0:
            take = min(64 - cur_bits, nb)
            piece = (w >> (nb - take)) & ((1 << take) - 1)
            cur = piece if cur is None else ((cur << take) | piece)
            cur_bits += take
            nb -= take
            if cur_bits == 64:
                lanes.append(cur)
                cur, cur_bits = None, 0
    if cur_bits:
        lanes.append(cur)
    return lanes


@spanned("radix_sort")
def sort_perm_key(words: List[torch.Tensor], bits: List[int],
                  capacity: int):
    """(perm, None): the stable sort permutation from the counting radix
    sort. The second slot is the reference's sorted key lanes, which only
    its ``lax.sort`` path returns; callers derive run boundaries from the
    words instead."""
    if int(sum(bits)) == 0:
        dev = words[0].device if words else None
        return torch.arange(capacity, dtype=torch.int64, device=dev), None
    return _radix_fallback_perm(words, bits, capacity), None


def lane_prefix_neq(lanes: List[torch.Tensor], lane_bits: List[int],
                    prefix_bits: int) -> torch.Tensor:
    """Row-boundary mask over sorted packed key lanes: True at row i when
    the first ``prefix_bits`` of row i's key differ from row i-1's.
    Position 0 is always True. (An arithmetic shift compares the same
    bits as a logical one: the top bit is one of them.)"""
    neq = None
    consumed = 0
    for lane, nb in zip(lanes, lane_bits):
        if consumed >= prefix_bits:
            break
        take = min(nb, prefix_bits - consumed)
        w = lane >> (nb - take) if take < nb else lane
        prev = torch.cat([w[:1], w[:-1]])
        d = w != prev
        neq = d if neq is None else (neq | d)
        consumed += take
    if neq is None:
        n = lanes[0].shape[0] if lanes else 0
        dev = lanes[0].device if lanes else None
        neq = torch.zeros((n,), dtype=torch.bool, device=dev)
    neq = neq.clone()
    neq[:1] = True
    return neq


def lane_bit_widths(total_bits: int) -> List[int]:
    """Per-lane bit widths produced by pack_words_u64 for a key of
    ``total_bits`` bits."""
    out = []
    rem = total_bits
    while rem > 0:
        out.append(min(64, rem))
        rem -= 64
    return out


def _scatter_sort_perm(words: List[torch.Tensor], bits: List[int],
                       capacity: int) -> torch.Tensor:
    """Stable radix sort with one scatter per pass and no row gather.

    Key bits and row id pack into one 64-bit state per row (row id high,
    key low, consumed least significant first): a pass counts the low
    digit of the state, which is already in pass order (B4 over the
    state), scans the table, and moves ``state >> width`` to each row's
    destination (B3's scatter form): two launches and a scan, with the
    digit taken inside both kernels. Consumed key bits fall away; after
    the last pass the state is the permutation. (The reference splits the
    state into two u32 halves because 64-bit shifts are emulated on a
    TPU; Hopper shifts int64 natively.)
    """
    total = int(sum(bits))
    dev = words[0].device
    state = torch.arange(capacity, dtype=torch.int64, device=dev) << total
    shift = total
    for w, b in zip(words, bits):  # words[0] most significant
        shift -= b
        state = state | (w << shift)
    rem = total
    while rem > 0:
        width = min(_DIGIT_BITS, rem)
        table = radix_hist(state, width)
        state = radix_scatter_pass(state, width, _destinations(table))
        rem -= width
    return state


def radix_sort_perm(words: List[torch.Tensor], bits: List[int],
                    capacity: int) -> torch.Tensor:
    """Stable permutation sorting rows by unsigned words (lexicographic,
    words[0] most significant)."""
    perm, _ = sort_perm_key(words, bits, capacity)
    return perm


def _word_bits(word: torch.Tensor) -> torch.Tensor:
    """A 32-bit sort word (int64 in [0, 2^32)) as the int32 with the same
    bits: words from 2^31 up become negative, exactly."""
    return ((word ^ _SIGN32) - _SIGN32).to(torch.int32)


def _classic_sort_perm(words: List[torch.Tensor], bits: List[int],
                       capacity: int) -> torch.Tensor:
    """Stable radix sort of keys too wide for the scatter branch.

    The words go least significant first. Each rides its passes beside
    the int32 permutation: a pass counts the word's low digit (B4), scans
    the table, and moves ``word >> width`` and the permutation entry to
    each row's destination (B2's rank-and-scatter form), so the word stays
    in the permutation's order and is gathered once, when its turn comes
    (B5; the first word is in row order already). A word's last pass
    drops it. (The reference gathers the digit through the permutation
    every pass.)"""
    perm = None
    for word, wb in zip(reversed(words), reversed(bits)):
        w = _word_bits(word)
        if perm is None:
            perm = torch.arange(capacity, dtype=torch.int32, device=w.device)
        else:
            w = flat_gather(w, perm)
        for shift in range(0, wb, _DIGIT_BITS):
            width = min(_DIGIT_BITS, wb - shift)
            table = radix_hist(w, width)
            w, perm = radix_rank_scatter(w, width, perm, _destinations(table),
                                         keep_word=shift + width < wb)
    return perm.long()


def _radix_fallback_perm(words: List[torch.Tensor], bits: List[int],
                         capacity: int) -> torch.Tensor:
    """Counting radix sort: scatter-only when the key fits 64 bits beside
    the row id, otherwise the classic loop. Every pass runs the kernels
    of ops/radix.py, whatever its digit width: a digit below 2^width is
    still a digit below 256."""
    total = int(sum(bits))
    pbits = max(1, capacity - 1).bit_length()
    if total + pbits <= 64 and total > 0:
        return _scatter_sort_perm(words, bits, capacity)
    return _classic_sort_perm(words, bits, capacity)


def sort_permutation(keys, orders, capacity: int, active) -> torch.Tensor:
    """Permutation putting active rows first, ordered by keys (stable)."""
    words, bits = sort_words(keys, orders, capacity, active)
    return radix_sort_perm(words, bits, capacity)


# ---------------------------------------------------------------------------
# Join keys (exec/join.py)
# ---------------------------------------------------------------------------

def num_value_words(dt: T.DataType) -> int:
    """Static word count of value_words() over a column stored at the
    type's canonical dtype; pack_key_u64 casts to it first, so both join
    sides pack identically even when one is stored narrower."""
    if dt.is_long_decimal:
        return 4
    if dt.kind is T.TypeKind.DOUBLE:
        return 3
    if dt.kind in (T.TypeKind.REAL, T.TypeKind.BOOLEAN):
        return 1
    if dt.is_string or dt.is_complex:
        return 1
    return 2 if dt.torch_dtype() == torch.int64 else 1


def packable_words(dtypes: Sequence[T.DataType]) -> bool:
    """True if the key tuple's order-preserving words fit one 64-bit lane:
    the precondition of the packed sorted-key build (exec/join.py)."""
    return sum(num_value_words(dt) for dt in dtypes) <= 2


def pack_key_u64(keys: Sequence[EvalValue], capacity: int) -> torch.Tensor:
    """One order-preserving 64-bit key per row from at most two value
    words, as an int64 holding the reference's uint64 bits: compare it
    unsigned (flip the sign bit) where order matters; equality needs
    nothing. Null rows are not canonicalized: callers exclude them."""
    words: List[torch.Tensor] = []
    for v in keys:
        canon = v
        want = v.dtype.torch_dtype()
        if not v.dtype.is_string and v.data.dtype != want:
            canon = EvalValue(v.full_data(capacity).to(want), v.validity,
                              v.dtype, v.dictionary)
        words.extend(value_words(canon, capacity))
    if len(words) > 2:
        raise ValueError(f"{len(words)} key words exceed one packed lane")
    if len(words) == 1:
        return words[0]
    return (words[0] << 32) | words[1]
