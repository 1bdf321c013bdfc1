"""Flat gather: ``out[i] = data[idx[i]]`` (kernel B5), one column or
several through one index.

Counterpart of ``velox_tpu/ops/pallas_kernels.py``'s ``flat_gather``. The
reference builds it for the TPU's VMEM and lanes: 128 lane rotations, a
(R, 128) reshape, output and data split into sub-calls, and a fallback to
``data[idx]`` past 2^20 data elements, so nothing in its engine reaches
it. On Hopper it is an indexed load with no length cap
(``csrc/flat_gather.cu``: one tile of consecutive index rows a block, all
of a thread's data loads in flight, 16-byte index loads and stores that
leave L2 to the data), and the join probe and the sort send their 4- and
8-byte gathers through it (exec/join.py, exec/sort.py).

``flat_gather`` (one column) and ``gather_rows`` (up to ``MAX_COLUMNS``
columns through one index, in one launch that reads the index once)
dispatch on the tensors' device: a CUDA tensor launches the kernel and
adds one to the wrapper's ``launches``; a CPU tensor runs the plain
PyTorch version, ``flat_gather_reference``; any other device raises.
Data is a contiguous 1-D tensor of 4- or 8-byte elements (moved as raw
bits, so any such dtype), indices a contiguous 1-D int32 or int64 tensor
whose every value lies in [0, len(data)): the kernel does not check them,
so callers clip first, as the reference's callers do.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from velox_tpu_torch.native.build import load_kernel
from velox_tpu_torch.ops import count_launch

_INDEX_DTYPES = (torch.int32, torch.int64)
# columns one gather_rows launch takes (csrc/flat_gather.cu kMaxCols)
MAX_COLUMNS = 8


class _GatherArgs(ctypes.Structure):
    """Mirror of ``GatherArgs`` in csrc/flat_gather.cu."""
    _fields_ = [
        ("data", ctypes.c_void_p * MAX_COLUMNS),
        ("out", ctypes.c_void_p * MAX_COLUMNS),
        ("elem_bytes", ctypes.c_int32 * MAX_COLUMNS),
        ("n_cols", ctypes.c_int32),
        ("idx_bytes", ctypes.c_int32),
        ("idx", ctypes.c_void_p),
        ("m", ctypes.c_int64),
    ]


def _is_gatherable(a: torch.Tensor) -> bool:
    return a.dim() == 1 and a.element_size() in (4, 8) \
        and a.dtype != torch.bool


def _check(columns: Sequence[torch.Tensor], idx: torch.Tensor,
           what: str) -> None:
    for data in columns:
        if not _is_gatherable(data) or not data.is_contiguous():
            raise ValueError(f"{what} data must be a contiguous 1-D tensor "
                             "of 4- or 8-byte elements; got "
                             f"{data.dtype} {tuple(data.shape)}")
        if idx.device != data.device:
            raise ValueError(f"{what} data on {data.device}, indices on "
                             f"{idx.device}")
        if data.shape[0] == 0 and idx.shape[0] > 0:
            raise ValueError(f"{what} from empty data")
    if idx.dtype not in _INDEX_DTYPES or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError(f"{what} indices must be a contiguous 1-D int32 "
                         f"or int64 tensor; got {idx.dtype} "
                         f"{tuple(idx.shape)}")


# each C entry's arguments: the one-column form takes scalars, the
# multi-column form one struct
_ARGTYPES = {
    "vt_flat_gather": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p],
    "vt_flat_gather_multi": [_GatherArgs, ctypes.c_void_p],
}


def _entry(name: str):
    fn = getattr(load_kernel("flat_gather"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"flat gather kernel launch failed: CUDA error "
                           f"{err}")


def _launch_one(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One column through the scalar entry, which fills no struct."""
    dev = idx.device
    out = torch.empty(idx.shape, dtype=data.dtype, device=dev)
    fn = _entry("vt_flat_gather")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _raise_on(fn(data.element_size(), idx.element_size(),
                     data.data_ptr(), idx.data_ptr(), idx.shape[0],
                     out.data_ptr(), stream))
    return out


def _launch(columns: Sequence[torch.Tensor],
            idx: torch.Tensor) -> List[torch.Tensor]:
    dev = idx.device
    outs = [torch.empty(idx.shape, dtype=c.dtype, device=dev)
            for c in columns]
    args = _GatherArgs()
    data, out, widths = args.data, args.out, args.elem_bytes
    for i, (c, o) in enumerate(zip(columns, outs)):
        data[i], out[i], widths[i] = c.data_ptr(), o.data_ptr(), \
            c.element_size()
    args.n_cols, args.idx_bytes = len(columns), idx.element_size()
    args.idx, args.m = idx.data_ptr(), idx.shape[0]
    fn = _entry("vt_flat_gather_multi")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _raise_on(fn(args, stream))
    return outs


def flat_gather_reference(data: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain B5: torch indexing."""
    return data[idx.long()]


def flat_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """B5: ``data[idx]`` for 4- or 8-byte data and int32/int64 indices in
    [0, len(data))."""
    _check([data], idx, "flat_gather")
    dev = data.device
    if dev.type == "cuda":
        out = _launch_one(data, idx)
        count_launch(flat_gather)
        return out
    if dev.type == "cpu":
        return flat_gather_reference(data, idx)
    raise ValueError(f"flat_gather has no kernel for {dev}")


flat_gather.launches = 0


def gather_rows(columns: Sequence[torch.Tensor],
                idx: torch.Tensor) -> List[torch.Tensor]:
    """B5 over up to ``MAX_COLUMNS`` columns through one index:
    ``[c[idx] for c in columns]``, each column 4- or 8-byte data (widths
    may differ), in one launch that reads ``idx`` once. CUDA tensors
    launch the kernel and add one to ``gather_rows.launches``; CPU
    tensors run ``flat_gather_reference`` per column."""
    if not 1 <= len(columns) <= MAX_COLUMNS:
        raise ValueError(f"gather_rows takes 1 to {MAX_COLUMNS} columns, "
                         f"got {len(columns)}")
    _check(columns, idx, "gather_rows")
    dev = idx.device
    if dev.type == "cuda":
        outs = _launch(columns, idx)
        count_launch(gather_rows)
        return outs
    if dev.type == "cpu":
        return [flat_gather_reference(c, idx) for c in columns]
    raise ValueError(f"gather_rows has no kernel for {dev}")


gather_rows.launches = 0


def _take_vector_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` of a (rows x width) tensor whose rows are whole 8- or
    4-byte lanes (the HLL registers: 512 int32 = 256 8-byte lanes):
    through B5 with the flat indices ``row * lanes + j``."""
    row_bytes = a.shape[1] * a.element_size()
    lane = torch.int64 if row_bytes % 8 == 0 else torch.int32
    flat = a.contiguous().view(lane)
    k = flat.shape[1]
    fidx = (idx.to(torch.int64)[:, None] * k
            + torch.arange(k, device=idx.device)).reshape(-1)
    out = flat_gather(flat.reshape(-1), fidx)
    return out.view(idx.shape[0], k).view(a.dtype)


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` of a row-aligned tensor: through B5 when ``a`` has 4- or
    8-byte elements (or is 2-D with rows of whole 4-byte lanes) and
    ``idx`` is an int32/int64 index tensor, plain indexing otherwise
    (bool validity and narrower columns lie outside B5's contract)."""
    if idx.dtype in _INDEX_DTYPES:
        if _is_gatherable(a):
            return flat_gather(a.contiguous(), idx.contiguous())
        if a.dim() == 2 and a.shape[1] > 0 and a.dtype != torch.bool \
                and (a.shape[1] * a.element_size()) % 4 == 0:
            return _take_vector_rows(a, idx)
    return a[idx]


def take_many_rows(arrays: Sequence[torch.Tensor],
                   idx: torch.Tensor) -> List[torch.Tensor]:
    """``[a[idx] for a in arrays]`` of 1-D row-aligned tensors: the 4- and
    8-byte ones through ``gather_rows``, ``MAX_COLUMNS`` to a launch, the
    rest (bool validity, narrower columns) by plain indexing."""
    out: List[Optional[torch.Tensor]] = [None] * len(arrays)
    wide = [i for i, a in enumerate(arrays) if _is_gatherable(a)]
    if idx.dtype not in _INDEX_DTYPES:
        wide = []
    idx_c = idx.contiguous()
    for k in range(0, len(wide), MAX_COLUMNS):
        part = wide[k:k + MAX_COLUMNS]
        for i, g in zip(part, gather_rows(
                [arrays[i].contiguous() for i in part], idx_c)):
            out[i] = g
    for i, a in enumerate(arrays):
        if out[i] is None:
            out[i] = take_rows(a, idx)
    return out
