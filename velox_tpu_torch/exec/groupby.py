"""Group-by core: the dense "array mode" and sort + segment-reduce.

Counterpart of ``velox_tpu/exec/groupby.py`` (velox/exec/GroupingSet.cpp +
HashTable.cpp's kArray / kNormalizedKey modes):

* **array mode** (kArray, HashTable.h:119): when every key has a small
  known domain (dictionary strings, booleans), the group id is the
  mixed-radix combination of the key ids, and each state reduces by id.
* **sort mode**: rows are radix-sorted by their packed key words
  (exec/sort.py, whose passes run the kernels of ops/radix.py), the
  addends are gathered into sorted order through kernel B5 (eight to a
  launch), equal-key runs become groups, and states reduce over the runs
  (ops/wide.py). Groups come out as a dense prefix in key order.

``sorted_group_info_vals`` sorts each group's rows by values too, for
the collect aggregates (exec/aggregation.py).

Vector states (``StateSpec.width`` > 1: approx_distinct's registers) are
(groups x width) tensors. A raw row contributes a
``functions/aggregates.py`` ``RegisterAddend``, reduced straight into the
group buffer by one ``scatter_reduce_`` at ``group * width + register``;
intermediate (rows x width) states reduce by rows.
In sort mode a batch with vector states is cut to a power of two above
its group count (one host read), so the group buffers stay that size.

Not ported: the reference's payload-riding ``lax.sort`` form of sort mode
(a TPU gather workaround; this is its gather formulation, with the same
keys and states) and the hash mode (``reduce_hash_mode``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common.process_trace import spanned
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.functions.aggregates import RegisterAddend
from velox_tpu_torch.ops.gather import take_many_rows, take_rows


def _dtype_max(dt: torch.dtype):
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


def _dtype_min(dt: torch.dtype):
    return float("-inf") if dt.is_floating_point else torch.iinfo(dt).min


# Array mode reduces with one masked dense reduce per (group, addend) when
# the domain is this small and the batch this large, else with one scatter
# per addend. On an H100 with Q1's 22 int64 addends, the scatter's atomics
# into few addresses cost ~2 ms an addend at 6.7M rows, 4.6x the masked
# reduces at 6 groups and 1.9x at 16; at 32 groups the two tie. Below 2M
# rows (1M at 6 groups) the masked form is bound by its 2 x groups
# launches an addend and the scatter wins.
_MASKED_MAX_DOMAIN = 16
_MASKED_MIN_ROWS = 1 << 21


def array_mode_domain(keys: List[EvalValue]) -> Optional[int]:
    """Total combined domain if all keys are small-domain, else None.
    Parity: kArrayHashMaxSize cutoff (velox/exec/HashTable.h:119)."""
    total = 1
    for v in keys:
        if v.dtype.is_string and v.dictionary is not None:
            total *= max(1, len(v.dictionary))
        elif v.dtype.kind is T.TypeKind.BOOLEAN:
            total *= 2
        else:
            return None
        if v.validity is not None:
            total += 1  # null bucket handled by +1 radix; conservative
    return total if total <= (1 << 21) else None


def _card(v: EvalValue) -> int:
    card = max(1, len(v.dictionary)) if v.dtype.is_string else 2
    return card + 1 if v.validity is not None else card


def group_ids_array_mode(keys: List[EvalValue], capacity: int, active):
    """Mixed-radix dense group id per row. Returns (ids, num_groups)."""
    ids = torch.zeros((capacity,), dtype=torch.int64,
                      device=active.device)
    domain = 1
    for v in keys:
        card = _card(v)
        data = v.full_data(capacity).to(torch.int64)
        if v.validity is not None:
            # nulls get their own id = card - 1 (the radix grew by 1)
            data = torch.where(v.full_validity(capacity), data, card - 1)
        ids = ids * card + data
        domain *= card
    return ids, domain


@spanned("group_reduce")
def reduce_array_mode(keys: List[EvalValue],
                      addends: List[Tuple[torch.Tensor, str]],
                      active, capacity: int, domain: int):
    """Dense reduce over the mixed-radix key domain.

    Returns (group_key_values, group_addends, group_mask), tensors of
    length `domain` (occupied groups flagged in group_mask).
    """
    ids, _ = group_ids_array_mode(keys, capacity, active)
    ids = torch.where(active, ids, domain)  # inactive -> overflow bucket
    occupied = torch.bincount(ids, minlength=domain + 1)[:domain] > 0
    out_states = []
    masked = domain <= _MASKED_MAX_DOMAIN and capacity >= _MASKED_MIN_ROWS
    masks = [ids == d for d in range(domain)] if masked else None
    for data, combine in addends:
        if isinstance(data, RegisterAddend) or data.dim() > 1:
            out_states.append(_reduce_vector(data, ids, domain))
            continue
        if masked and data.dim() == 1:
            if combine == "sum":
                per = [torch.where(m, data, 0).sum(dtype=data.dtype)
                       for m in masks]
            elif combine == "min":
                per = [torch.where(m, data, _dtype_max(data.dtype)).min()
                       for m in masks]
            else:
                per = [torch.where(m, data, _dtype_min(data.dtype)).max()
                       for m in masks]
            out_states.append(torch.stack(per))
            continue
        if combine == "sum":
            red = torch.zeros((domain + 1,), dtype=data.dtype,
                              device=data.device).index_add_(0, ids, data)
        else:
            init = _dtype_max(data.dtype) if combine == "min" \
                else _dtype_min(data.dtype)
            red = torch.full((domain + 1,), init, dtype=data.dtype,
                             device=data.device).scatter_reduce_(
                0, ids, data, reduce="amin" if combine == "min" else "amax")
        out_states.append(red[:domain])
    # reconstruct key values per group from the mixed-radix id
    gid = torch.arange(domain, dtype=torch.int64, device=active.device)
    cards = [_card(v) for v in keys]
    key_vals = []
    rem = gid
    for card in reversed(cards):
        key_vals.append(rem % card)
        rem = rem // card
    key_vals.reverse()
    out_keys = []
    for v, kv, card in zip(keys, key_vals, cards):
        base_card = card - 1 if v.validity is not None else card
        is_null = (kv == base_card) if v.validity is not None else None
        data = torch.clamp(kv, max=base_card - 1).to(
            torch.int32 if v.dtype.is_string else v.dtype.torch_dtype())
        validity = None if is_null is None else ~is_null
        out_keys.append(EvalValue(data, validity, v.dtype, v.dictionary))
    return out_keys, out_states, occupied


def _reduce_vector(data, gids: torch.Tensor, n_groups: int
                   ) -> torch.Tensor:
    """A vector state's (n_groups x width) max, from a RegisterAddend or
    (rows x width) states; rows with ``gids`` == n_groups are dropped.
    Registers are >= 0, so the buffer starts at 0."""
    if isinstance(data, RegisterAddend):
        w = data.width
        out = torch.zeros(((n_groups + 1) * w,), dtype=data.val.dtype,
                          device=data.val.device)
        out.scatter_reduce_(0, gids.to(torch.int64) * w + data.reg,
                            data.val, reduce="amax")
        return out.view(n_groups + 1, w)[:n_groups]
    out = torch.zeros((n_groups + 1, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    out.scatter_reduce_(0, gids.to(torch.int64)[:, None].expand_as(data),
                        data, reduce="amax")
    return out[:n_groups]


def _run_boundaries(words: List[torch.Tensor], perm: torch.Tensor,
                    capacity: int) -> torch.Tensor:
    """True at sorted position i when its key words differ from i-1's."""
    neq = torch.zeros((capacity,), dtype=torch.bool, device=perm.device)
    for w in words:
        ws = w[perm]
        prev = torch.cat([ws[:1], ws[:-1]])
        neq = neq | (ws != prev)
    neq[:1] = True
    return neq


@spanned("group_reduce")
def sorted_group_info(keys: Sequence[EvalValue], active, capacity: int,
                      ranges=None):
    """Radix-sort rows by key words and segment equal-key runs.

    Returns (perm, gid, boundary, active_sorted, num_groups):
      perm[i]        = original row at sorted position i (active first)
      gid[i]         = dense group id of sorted position i (grows with i)
      boundary[i]    = True iff sorted position i starts a new key run
      active_sorted  = active mask permuted
      num_groups     = count of active groups (a 0-dim device tensor)
    """
    from velox_tpu_torch.exec.sort import sort_perm_key, sort_words

    words, bits = sort_words(keys, None, capacity, active, ranges=ranges)
    perm, _ = sort_perm_key(words, bits, capacity)
    boundary = _run_boundaries(words, perm, capacity)
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    active_sorted = active[perm]
    num_groups = (boundary & active_sorted).sum()
    return perm, gid, boundary, active_sorted, num_groups


@spanned("group_reduce")
def sorted_group_info_vals(keys: Sequence[EvalValue],
                           vals: Sequence[EvalValue], active, capacity: int,
                           ranges=None):
    """Like sorted_group_info, but rows within each key run are further
    sorted by ``vals`` (ascending, nulls first), through the same counting
    radix sort. Returns sorted_group_info's 5-tuple plus ``vboundary``,
    True where sorted position i starts a new (key, value) run (mode's
    run counts read it). The value words follow the key words, so group
    numbering is the same."""
    from velox_tpu_torch.exec.sort import sort_perm_key, sort_words, \
        value_words

    words, bits = sort_words(keys, None, capacity, active, ranges=ranges)
    n_key_words = len(words)
    for v in vals:
        if v.validity is not None:
            words.append((~v.full_validity(capacity)).to(torch.int64))
            bits.append(1)
        vw = value_words(v, capacity)
        words.extend(vw)
        bits.extend([32] * len(vw))
    perm, _ = sort_perm_key(words, bits, capacity)
    boundary = _run_boundaries(words[:n_key_words], perm, capacity)
    vboundary = _run_boundaries(words, perm, capacity)
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    active_sorted = active[perm]
    num_groups = (boundary & active_sorted).sum()
    return perm, gid, boundary, active_sorted, num_groups, vboundary


def group_keys_sorted(keys: Sequence[EvalValue], perm, gid, boundary,
                      active_sorted, num_groups, capacity: int):
    """Dense per-group key columns (group g's key values), taken from each
    group's first sorted row. A long decimal's high limb and a raw
    string's lengths go through the same gather and scatter as the data;
    a raw string's byte matrix is gathered through B5 as 8-byte lanes."""
    from velox_tpu_torch.ops.wide import scatter_unique_set
    from velox_tpu_torch.vector import strings as S
    from velox_tpu_torch.vector.device import DeviceColumn
    group_mask = torch.arange(capacity, device=perm.device) < num_groups
    target = torch.where(boundary & active_sorted, gid, capacity)

    def first_of_group(rows: torch.Tensor) -> torch.Tensor:
        ordered = take_rows(rows, perm) if rows.dim() == 2 else rows[perm]
        return scatter_unique_set(capacity + 1, target, ordered)[:capacity]

    out_keys = []
    for v in keys:
        gd = first_of_group(v.full_data(capacity))
        if v.validity is not None:
            validity = first_of_group(v.full_validity(capacity))
            validity = validity | ~group_mask  # padding rows: non-null
        else:
            validity = None
        children = ()
        if v.dtype.is_long_decimal:
            children = (DeviceColumn(first_of_group(v.full_hi(capacity)),
                                     None, T.BIGINT),)
        elif S.is_raw(v):
            children = (DeviceColumn(first_of_group(S.lens_of(v)), None,
                                     T.INTEGER),)
        out_keys.append(EvalValue(gd, validity, v.dtype, v.dictionary,
                                  children=children))
    return out_keys, group_mask


def _head(v: EvalValue, n: int) -> EvalValue:
    """The first n rows of a dense group-key value."""
    from velox_tpu_torch.vector.device import DeviceColumn
    children = tuple(DeviceColumn(c.data[:n], None, c.dtype)
                     for c in v.children)
    return EvalValue(v.data[:n], None if v.validity is None
                     else v.validity[:n], v.dtype, v.dictionary,
                     children=children)


@spanned("group_reduce")
def reduce_sort_mode(keys: List[EvalValue], addends, active,
                     capacity: int, ranges=None):
    """Generic grouping: radix sort by packed key words + run reduce.

    Returns (group_keys, group_states, group_mask), with groups as a
    dense prefix in key-sorted order, of length `capacity`; with vector
    states, of a power of two at or above the group count.
    """
    from velox_tpu_torch.ops.wide import segmented_reduce_sorted

    perm, gid, boundary, active_sorted, num_groups = sorted_group_info(
        keys, active, capacity, ranges)
    vector = [isinstance(d, RegisterAddend) or d.dim() > 1
              for d, _ in addends]
    out_cap = capacity
    if any(vector):
        out_cap = min(capacity, 1 << max(0, int(num_groups) - 1)
                      .bit_length())
        out_gid = torch.where(active_sorted, gid, out_cap)
    # the rows' addends in sorted order: B5's multi-column gather, up to
    # eight addends a launch through the one permutation
    flat = iter(take_many_rows([d for (d, _), vec in zip(addends, vector)
                                if not vec], perm))
    out_states = []
    for (data, combine), vec in zip(addends, vector):
        if not vec:
            out_states.append(segmented_reduce_sorted(
                next(flat), gid, boundary, active_sorted, capacity,
                combine)[:out_cap])
        elif isinstance(data, RegisterAddend):
            # the rows' registers and values in sorted order: one B5
            # launch for both
            reg, val = take_many_rows([data.reg, data.val], perm)
            out_states.append(_reduce_vector(
                RegisterAddend(reg, val, data.width), out_gid, out_cap))
        else:
            out_states.append(_reduce_vector(take_rows(data, perm),
                                             out_gid, out_cap))
    out_keys, group_mask = group_keys_sorted(
        keys, perm, gid, boundary, active_sorted, num_groups, capacity)
    if out_cap < capacity:
        out_keys = [_head(v, out_cap) for v in out_keys]
        group_mask = group_mask[:out_cap]
    return out_keys, out_states, group_mask
