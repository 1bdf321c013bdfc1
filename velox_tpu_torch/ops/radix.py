"""One 8-bit counting-sort pass: histogram (B4), rank (B2), position (B3).

Counterpart of ``velox_tpu/ops/pallas_kernels.py``'s radix kernels. The
pass splits rows into tiles of ``TILE_ROWS`` consecutive rows and runs in
three steps (``csrc/radix_pass.cu`` explains the kernel):

1. ``radix_hist`` (B4): the (256, n_tiles) int32 table of per-tile digit
   counts, digit-major;
2. glue here, in PyTorch (the reference's XLA glue): one exclusive scan of
   the flattened table, which in digit-major order gives each (digit,
   tile) its first destination;
3. ``radix_rank`` (B2) or ``radix_pos`` (B3): every row's stable rank
   inside its tile plus the (digit, tile) entry of the table they are
   given. B2 gets each tile's offset within its digit and so returns the
   stable rank among all rows of that digit; B3 gets that offset plus the
   digit's base and so returns the final counting-sort destination.

``radix_pass_positions`` (B4, B2, then a 256-entry gather) and
``radix_pass_positions_nogather`` (B4 then B3) keep the reference's names
and give the stable counting-sort destinations of one pass: row i goes to
``#{rows with a smaller digit} + #{earlier rows with the same digit}``.

Each wrapper dispatches on its tensors' device: a CUDA tensor launches the
kernel and adds one to the wrapper's ``launches``; a CPU tensor runs the
plain PyTorch version beside it (``*_reference``); any other device
raises. Digits are int32 in [0, 256) (the kernel masks them to 8 bits
only to stay inside its tables); positions are int32, so a pass takes
fewer than 2^31 rows.
"""

from __future__ import annotations

import ctypes

import torch

RADIX = 256
TILE_ROWS = 8192   # rows per tile: kTile in csrc/radix_pass.cu
_HIST, _PLACE = 0, 1  # the kernel's modes (kHist, kPlace)


def _n_tiles(n: int) -> int:
    return -(-n // TILE_ROWS)


def _check_digits(digits: torch.Tensor) -> None:
    if digits.dtype != torch.int32 or digits.dim() != 1 \
            or not digits.is_contiguous():
        raise ValueError("radix pass digits must be a contiguous 1-D int32 "
                         f"tensor; got {digits.dtype} {tuple(digits.shape)}")
    if digits.shape[0] >= 2 ** 31:
        raise ValueError(f"a radix pass takes fewer than 2^31 rows, got "
                         f"{digits.shape[0]}")


def _check_table(digits: torch.Tensor, table: torch.Tensor) -> None:
    want = (RADIX, _n_tiles(digits.shape[0]))
    if table.dtype != torch.int32 or tuple(table.shape) != want \
            or table.device != digits.device or not table.is_contiguous():
        raise ValueError(
            f"radix pass table must be a contiguous int32 {want} tensor on "
            f"{digits.device}; got {table.dtype} {tuple(table.shape)} on "
            f"{table.device}")


def _kernel_lib():
    from velox_tpu_torch.native.build import load_kernel
    lib = load_kernel("radix_pass")
    fn = lib.vt_radix_pass
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tile = lib.vt_radix_tile_rows()
        if tile != TILE_ROWS:
            raise RuntimeError(f"csrc/radix_pass.cu tiles {tile} rows, "
                               f"ops/radix.py expects {TILE_ROWS}")
    return fn


def _launch(mode: int, digits: torch.Tensor, table: torch.Tensor,
            out) -> None:
    dev = digits.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_lib()(mode, digits.data_ptr(), digits.shape[0],
                            table.data_ptr(),
                            out.data_ptr() if out is not None else None,
                            stream)
    if err != 0:
        name = "histogram" if mode == _HIST else "place"
        raise RuntimeError(f"radix {name} kernel launch failed: CUDA error "
                           f"{err}")


def _no_kernel(fn_name: str, dev: torch.device) -> ValueError:
    return ValueError(f"{fn_name} has no kernel for {dev}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU queries, tests, and the card's comparisons).
# ---------------------------------------------------------------------------

def _cell_keys(digits: torch.Tensor) -> torch.Tensor:
    """Each row's (digit, tile) cell of the digit-major table."""
    tile = torch.arange(digits.shape[0], device=digits.device) // TILE_ROWS
    return digits.long() * _n_tiles(digits.shape[0]) + tile


def radix_hist_reference(digits: torch.Tensor) -> torch.Tensor:
    """Plain B4: ``torch.bincount`` of (digit, tile)."""
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


# ---------------------------------------------------------------------------
# The three modes.
# ---------------------------------------------------------------------------

def radix_hist(digits: torch.Tensor) -> torch.Tensor:
    """B4: the (256, n_tiles) int32 per-tile digit counts, digit-major."""
    _check_digits(digits)
    dev = digits.device
    if dev.type == "cuda":
        table = torch.empty((RADIX, _n_tiles(digits.shape[0])),
                            dtype=torch.int32, device=dev)
        _launch(_HIST, digits, table, None)
        radix_hist.launches += 1
        return table
    if dev.type == "cpu":
        return radix_hist_reference(digits)
    raise _no_kernel("radix_hist", dev)


def radix_rank(digits: torch.Tensor,
               tile_offset: torch.Tensor) -> torch.Tensor:
    """B2: ``tile_offset[d, tile]`` + the row's stable rank among its
    tile's rows of digit d. With ``tile_offset`` the exclusive scan of
    ``radix_hist`` over tiles, that is the row's stable rank among all
    rows of its digit."""
    _check_digits(digits)
    _check_table(digits, tile_offset)
    dev = digits.device
    if dev.type == "cuda":
        out = torch.empty_like(digits)
        _launch(_PLACE, digits, tile_offset, out)
        radix_rank.launches += 1
        return out
    if dev.type == "cpu":
        return radix_rank_reference(digits, tile_offset)
    raise _no_kernel("radix_rank", dev)


def radix_pos(digits: torch.Tensor, tile_base: torch.Tensor) -> torch.Tensor:
    """B3: ``tile_base[d, tile]`` + the row's stable rank among its tile's
    rows of digit d: with the digit's base added to the tile offsets, the
    counting-sort destination."""
    _check_digits(digits)
    _check_table(digits, tile_base)
    dev = digits.device
    if dev.type == "cuda":
        out = torch.empty_like(digits)
        _launch(_PLACE, digits, tile_base, out)
        radix_pos.launches += 1
        return out
    if dev.type == "cpu":
        return radix_pos_reference(digits, tile_base)
    raise _no_kernel("radix_pos", dev)


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
    _check_digits(digits)
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
