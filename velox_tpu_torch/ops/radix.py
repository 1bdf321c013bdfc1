"""One 8-bit counting-sort pass: histogram (B4), rank and rank-and-scatter
(B2), position and scatter (B3).

Counterpart of ``velox_tpu/ops/pallas_kernels.py``'s radix kernels. The
pass splits rows into tiles of ``TILE_ROWS`` consecutive rows and runs in
three steps (``csrc/radix_pass.cu`` explains the kernels):

1. ``radix_hist`` (B4, ``_radix_hist_kernel``): the (256, n_tiles) int32
   table of per-tile digit counts, digit-major. Its source is int32
   digits, or a sort key and a digit width, whose digit is the key's low
   ``width`` bits, taken in the kernel: the int64 sort state of the
   scatter branch or the int32 sort word of the classic loop. Bound by
   bytes: 4 a row from digits or a word, 8 from the state, plus the
   table. Each thread loads its rows with 16-byte loads before counting
   them with shared-memory atomics into its warp's histogram, one atomic
   per run of equal digits.
2. glue here, in PyTorch (the reference's XLA glue): one exclusive scan of
   the flattened table, which in digit-major order gives each (digit,
   tile) its first destination.
3. one of:
   - ``radix_rank`` (B2's rank form, ``_radix_rank_kernel``): every row's
     stable rank inside its tile plus the tile's offset within the digit,
     which is the row's rank among all rows of its digit. Bound by bytes:
     8 a row plus the table;
   - ``radix_rank_scatter`` (B2's rank-and-scatter form), one pass of
     ``exec/sort.py``'s classic loop: with the int32 sort word and the
     int32 permutation in the permutation's order, the word's remaining
     bits, ``(uint32)word >> width``, and the row's permutation entry
     written to the row's counting-sort destination. Bound by bytes: 16 a
     row plus the table (12 on a word's last pass, which drops the spent
     word);
   - ``radix_pos`` (B3, ``_radix_pos_kernel``): the same rank plus the
     (digit, tile)'s destination, the row's counting-sort destination.
     Bound by bytes: 8 a row plus the table;
   - ``radix_scatter_pass`` (B3's scatter form): with the int64 sort state
     of ``exec/sort.py``'s scatter branch, the state's remaining bits,
     ``(uint64)state >> width``, written to that destination: the next
     pass's state. Bound by bytes: 16 a row plus the table.
   So one pass of either sort branch is two launches and a scan, with no
   row-sized digit or position tensor. All four forms run on one kernel:
   the tile comes into shared memory by bulk asynchronous copies and is
   ranked with a ballot multi-split; B2's rank form is B3's positions
   given another table.

``radix_pass_positions`` (B4, B2, then a 256-entry gather) and
``radix_pass_positions_nogather`` (B4 then B3) keep the reference's names
and give the stable counting-sort destinations of one pass: row i goes to
``#{rows with a smaller digit} + #{earlier rows with the same digit}``.

Each wrapper dispatches on its tensors' device: a CUDA tensor launches the
kernel and adds one to the wrapper's ``launches`` (``radix_scatter_pass``
adds to ``radix_pos.launches`` and ``radix_rank_scatter`` to
``radix_rank.launches``: the forms of B3 and of B2); a CPU tensor runs the
plain PyTorch version beside it (``*_reference``); any other device
raises. Digits are int32 in [0, 256) (the kernels mask them to 8 bits
only to stay inside their tables); positions are int32, so a pass takes
fewer than 2^31 rows. On the card the kernels read their sources 16
bytes at a time, so each must start on a 16-byte boundary, as PyTorch's
allocations do.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from velox_tpu_torch.ops import count_launch

RADIX = 256
TILE_ROWS = 8192   # rows per tile: kTile in csrc/radix_pass.cu

_LIB = None
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "vt_radix_hist": [_P, _I, _I, _I64, _P, _P],
    "vt_radix_rank": [_P, _I64, _P, _P, _P],
    "vt_radix_pos": [_P, _I64, _P, _P, _P],
    "vt_radix_scatter": [_P, _I, _I64, _P, _P, _P],
    "vt_radix_rank_scatter": [_P, _P, _I, _I64, _P, _P, _P, _P],
    "vt_radix_place_occupancy": [_I, _P, _P],
}
# the place kernel's forms, as vt_radix_place_occupancy numbers them
PLACE_FORMS = ("positions", "scatter", "rank_scatter")


def _n_tiles(n: int) -> int:
    return -(-n // TILE_ROWS)


def _check_source(src: torch.Tensor, width: Optional[int],
                  dtypes=(torch.int32,)) -> None:
    """1-D, contiguous, fewer than 2^31 rows, of one of ``dtypes``; a
    digit width (None: int32 digits) in 1..8."""
    if src.dim() != 1 or not src.is_contiguous():
        raise ValueError("a radix pass takes a contiguous 1-D tensor; got "
                         f"{src.dtype} {tuple(src.shape)}")
    if src.dtype not in dtypes:
        raise ValueError(f"this radix pass takes {dtypes} with digit width "
                         f"{width}, got {src.dtype}")
    if width is not None and not 1 <= width <= 8:
        raise ValueError(f"a radix digit is 1..8 bits wide, not {width}")
    if src.shape[0] >= 2 ** 31:
        raise ValueError(f"a radix pass takes fewer than 2^31 rows, got "
                         f"{src.shape[0]}")


def _check_perm(word: torch.Tensor, perm: torch.Tensor) -> None:
    if perm.dtype != torch.int32 or tuple(perm.shape) != tuple(word.shape) \
            or perm.device != word.device or not perm.is_contiguous():
        raise ValueError(
            f"the permutation must be a contiguous int32 {tuple(word.shape)} "
            f"tensor on {word.device}; got {perm.dtype} {tuple(perm.shape)} "
            f"on {perm.device}")


def _check_table(src: torch.Tensor, table: torch.Tensor) -> None:
    want = (RADIX, _n_tiles(src.shape[0]))
    if table.dtype != torch.int32 or tuple(table.shape) != want \
            or table.device != src.device or not table.is_contiguous():
        raise ValueError(
            f"radix pass table must be a contiguous int32 {want} tensor on "
            f"{src.device}; got {table.dtype} {tuple(table.shape)} on "
            f"{table.device}")


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from velox_tpu_torch.native.build import load_kernel
        lib = load_kernel("radix_pass")
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        tile = lib.vt_radix_tile_rows()
        if tile != TILE_ROWS:
            raise RuntimeError(f"csrc/radix_pass.cu tiles {tile} rows, "
                               f"ops/radix.py expects {TILE_ROWS}")
        _LIB = lib
    return _LIB


def _launch(name: str, src: torch.Tensor, *args, aligned=()) -> None:
    """Call entry point ``name`` on ``src``'s device and current stream
    with (src, *args); tensors in ``args`` pass as pointers, None as a
    null pointer. ``src`` and the tensors in ``aligned`` must start on a
    16-byte boundary."""
    if any(t.data_ptr() % 16 for t in (src, *aligned)):
        raise ValueError(f"{name}: the sources must start on a 16-byte "
                         "boundary")
    dev = src.device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(_kernel_lib(), name)(src.data_ptr(), *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _no_kernel(fn_name: str, dev: torch.device) -> ValueError:
    return ValueError(f"{fn_name} has no kernel for {dev}")


def place_occupancy(form: str):
    """(resident blocks per SM, dynamic shared memory bytes) of the place
    kernel's instance for ``form`` (one of ``PLACE_FORMS``), from the CUDA
    occupancy calculator on the current card."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = _kernel_lib().vt_radix_place_occupancy(
        PLACE_FORMS.index(form), ctypes.addressof(blocks),
        ctypes.addressof(smem))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return blocks.value, smem.value


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU queries, tests, and the card's comparisons).
# ---------------------------------------------------------------------------

def low_digits(key: torch.Tensor, width: int) -> torch.Tensor:
    """The int32 digit of each row of an int64 sort state or int32 sort
    word: its low ``width`` bits."""
    return (key & ((1 << width) - 1)).to(torch.int32)


def _cell_keys(digits: torch.Tensor) -> torch.Tensor:
    """Each row's (digit, tile) cell of the digit-major table."""
    tile = torch.arange(digits.shape[0], device=digits.device) // TILE_ROWS
    return digits.long() * _n_tiles(digits.shape[0]) + tile


def radix_hist_reference(src: torch.Tensor,
                         width: Optional[int] = None) -> torch.Tensor:
    """Plain B4: ``torch.bincount`` of (digit, tile)."""
    digits = src if width is None else low_digits(src, width)
    n_tiles = _n_tiles(digits.shape[0])
    counts = torch.bincount(_cell_keys(digits), minlength=RADIX * n_tiles)
    return counts.to(torch.int32).reshape(RADIX, n_tiles)


def _place_reference(digits: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """table[d, tile] + stable rank inside the tile, through a stable
    ``torch.sort`` of (digit, tile) scattered back into row order."""
    keys = _cell_keys(digits)
    order = torch.sort(keys, stable=True).indices
    sorted_at = torch.empty_like(order)
    sorted_at[order] = torch.arange(keys.shape[0], device=keys.device)
    counts = torch.bincount(keys, minlength=table.numel())
    first = torch.cumsum(counts, 0) - counts  # first sorted slot of a key
    return (table.reshape(-1).long()[keys] + sorted_at
            - first[keys]).to(torch.int32)


def radix_rank_reference(digits: torch.Tensor,
                         tile_offset: torch.Tensor) -> torch.Tensor:
    """Plain B2."""
    return _place_reference(digits, tile_offset)


def radix_pos_reference(digits: torch.Tensor,
                        tile_base: torch.Tensor) -> torch.Tensor:
    """Plain B3."""
    return _place_reference(digits, tile_base)


def radix_scatter_pass_reference(state: torch.Tensor, width: int,
                                 dest: torch.Tensor) -> torch.Tensor:
    """Plain B3 scatter: the destinations of the state's low digits, then
    ``next[pos] = state >> width`` (logical: the mask drops the sign bits
    the arithmetic shift copies in when row id and key fill 64 bits)."""
    pos = radix_pos_reference(low_digits(state, width), dest)
    nxt = torch.empty_like(state)
    nxt[pos] = (state >> width) & ((1 << (64 - width)) - 1)
    return nxt


def radix_rank_scatter_reference(word: torch.Tensor, width: int,
                                 perm: torch.Tensor, dest: torch.Tensor,
                                 keep_word: bool = True):
    """Plain B2 rank-and-scatter: the destinations of the word's low
    digits, then ``next_perm[pos] = perm`` and ``next_word[pos] = word >>
    width`` (logical: the mask drops the sign bits torch's arithmetic
    shift copies in); ``next_word`` is None without ``keep_word``."""
    pos = radix_pos_reference(low_digits(word, width), dest).long()
    nperm = torch.empty_like(perm)
    nperm[pos] = perm
    if not keep_word:
        return None, nperm
    nword = torch.empty_like(word)
    nword[pos] = (word >> width) & ((1 << (32 - width)) - 1)
    return nword, nperm


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------

def radix_hist(src: torch.Tensor,
               width: Optional[int] = None) -> torch.Tensor:
    """B4: the (256, n_tiles) int32 per-tile digit counts, digit-major, of
    int32 digits, or of the low ``width`` bits of an int64 sort state or
    int32 sort word."""
    _check_source(src, width, (torch.int32,) if width is None
                  else (torch.int32, torch.int64))
    dev = src.device
    if dev.type == "cuda":
        table = torch.empty((RADIX, _n_tiles(src.shape[0])),
                            dtype=torch.int32, device=dev)
        _launch("vt_radix_hist", src, src.element_size(), width or 8,
                src.shape[0], table)
        count_launch(radix_hist)
        return table
    if dev.type == "cpu":
        return radix_hist_reference(src, width)
    raise _no_kernel("radix_hist", dev)


def radix_rank(digits: torch.Tensor,
               tile_offset: torch.Tensor) -> torch.Tensor:
    """B2's rank form: ``tile_offset[d, tile]`` + the row's stable rank
    among its tile's rows of digit d. With ``tile_offset`` the exclusive
    scan of ``radix_hist`` over tiles, that is the row's stable rank among
    all rows of its digit."""
    _check_source(digits, None)
    _check_table(digits, tile_offset)
    dev = digits.device
    if dev.type == "cuda":
        out = torch.empty_like(digits)
        _launch("vt_radix_rank", digits, digits.shape[0], tile_offset, out)
        count_launch(radix_rank)
        return out
    if dev.type == "cpu":
        return radix_rank_reference(digits, tile_offset)
    raise _no_kernel("radix_rank", dev)


def radix_pos(digits: torch.Tensor, tile_base: torch.Tensor) -> torch.Tensor:
    """B3: ``tile_base[d, tile]`` + the row's stable rank among its tile's
    rows of digit d: with the digit's base added to the tile offsets, the
    counting-sort destination."""
    _check_source(digits, None)
    _check_table(digits, tile_base)
    dev = digits.device
    if dev.type == "cuda":
        out = torch.empty_like(digits)
        _launch("vt_radix_pos", digits, digits.shape[0], tile_base, out)
        count_launch(radix_pos)
        return out
    if dev.type == "cpu":
        return radix_pos_reference(digits, tile_base)
    raise _no_kernel("radix_pos", dev)


def radix_scatter_pass(state: torch.Tensor, width: int,
                       dest: torch.Tensor) -> torch.Tensor:
    """B3's scatter form, one pass of the scatter branch: the next state,
    ``next[destination of row i] = (uint64)state[i] >> width``, where the
    destination is ``dest[d, tile]`` + the row's stable rank among its
    tile's rows of digit d = ``state & (2^width - 1)``, and ``dest`` is
    ``_destinations(radix_hist(state, width))``. Counts in
    ``radix_pos.launches``."""
    _check_source(state, width, (torch.int64,))
    _check_table(state, dest)
    dev = state.device
    if dev.type == "cuda":
        out = torch.empty_like(state)
        _launch("vt_radix_scatter", state, width, state.shape[0], dest, out)
        count_launch(radix_pos)
        return out
    if dev.type == "cpu":
        return radix_scatter_pass_reference(state, width, dest)
    raise _no_kernel("radix_scatter_pass", dev)


def radix_rank_scatter(word: torch.Tensor, width: int, perm: torch.Tensor,
                       dest: torch.Tensor, keep_word: bool = True):
    """B2's rank-and-scatter form, one pass of the classic loop:
    ``(next_word, next_perm)`` with ``next_word[destination of row i] =
    (uint32)word[i] >> width`` and ``next_perm[destination] = perm[i]``,
    where the destination is ``dest[d, tile]`` + the row's stable rank
    among its tile's rows of digit d = ``word & (2^width - 1)``, and
    ``dest`` is ``_destinations(radix_hist(word, width))``. ``word`` (the
    int32 bits of a 32-bit sort word) and ``perm`` are int32 in the
    permutation's order. Without ``keep_word`` (a word's last pass: it is
    spent) ``next_word`` is None and is not written. Counts in
    ``radix_rank.launches``."""
    _check_source(word, width, (torch.int32,))
    _check_table(word, dest)
    _check_perm(word, perm)
    dev = word.device
    if dev.type == "cuda":
        nperm = torch.empty_like(perm)
        nword = torch.empty_like(word) if keep_word else None
        _launch("vt_radix_rank_scatter", word, perm, width, word.shape[0],
                dest, nword, nperm, aligned=(perm,))
        count_launch(radix_rank)
        return nword, nperm
    if dev.type == "cpu":
        return radix_rank_scatter_reference(word, width, perm, dest,
                                            keep_word)
    raise _no_kernel("radix_rank_scatter", dev)


radix_hist.launches = 0
radix_rank.launches = 0
radix_pos.launches = 0


# ---------------------------------------------------------------------------
# Whole passes (the reference's public functions).
# ---------------------------------------------------------------------------

def _tile_offsets(table: torch.Tensor):
    """(each tile's offset within its digit, the digit totals)."""
    offset = torch.cumsum(table, 1, dtype=torch.int32) - table
    return offset, table.sum(1, dtype=torch.int32)


def _destinations(table: torch.Tensor) -> torch.Tensor:
    """Each (digit, tile)'s first destination: one exclusive scan of the
    flattened digit-major table."""
    flat = table.reshape(-1)
    return (torch.cumsum(flat, 0, dtype=torch.int32)
            - flat).reshape(table.shape)


def _as_digits(digits: torch.Tensor, capacity: int) -> torch.Tensor:
    if digits.shape[0] != capacity:
        raise ValueError(f"{digits.shape[0]} digits for capacity {capacity}")
    return digits.to(torch.int32).contiguous()


def radix_ranks_totals(digits: torch.Tensor):
    """(ranks, totals) of one pass: each row's stable rank among the rows
    of its digit, and each digit's count (B4 then B2)."""
    _check_source(digits, None)
    tile_offset, totals = _tile_offsets(radix_hist(digits))
    return radix_rank(digits, tile_offset.contiguous()), totals


def radix_pass_positions(digits: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """Stable counting-sort destinations of one pass (int32), through the
    rank mode: B4, B2, then ``digit_base[d] + rank``."""
    digits = _as_digits(digits, capacity)
    ranks, totals = radix_ranks_totals(digits)
    digit_base = torch.cumsum(totals, 0, dtype=torch.int32) - totals
    return digit_base[digits.long()] + ranks


def radix_pass_positions_nogather(digits: torch.Tensor,
                                  capacity: int) -> torch.Tensor:
    """Stable counting-sort destinations of one pass (int32), with no
    row-sized gather: B4, then B3 with the digit base folded into the
    per-tile table."""
    digits = _as_digits(digits, capacity)
    return radix_pos(digits, _destinations(radix_hist(digits)))


def radix_pass_positions_reference(digits: torch.Tensor,
                                   capacity: int) -> torch.Tensor:
    """Plain version of both whole-pass functions: a stable ``torch.sort``
    of the digits, scattered back into row order."""
    digits = _as_digits(digits, capacity)
    order = torch.sort(digits, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(capacity, device=digits.device)
    return pos.to(torch.int32)
