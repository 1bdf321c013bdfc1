"""Flat gather: ``out[i] = data[idx[i]]`` (kernel B5).

Counterpart of ``velox_tpu/ops/pallas_kernels.py``'s ``flat_gather``. The
reference builds it for the TPU's VMEM and lanes: 128 lane rotations, a
(R, 128) reshape, output and data split into sub-calls, and a fallback to
``data[idx]`` past 2^20 data elements, so nothing in its engine reaches
it. On Hopper it is a plain indexed load (``csrc/flat_gather.cu``) with no
length cap, and the join probe sends its 4- and 8-byte gathers through it
(exec/join.py).

``flat_gather`` dispatches on the tensors' device: a CUDA tensor launches
the kernel and adds one to ``flat_gather.launches``; a CPU tensor runs the
plain PyTorch version beside it, ``flat_gather_reference``; any other
device raises. Data is a contiguous 1-D tensor of 4- or 8-byte elements
(moved as raw bits, so any such dtype), indices a contiguous 1-D int32 or
int64 tensor whose every value lies in [0, len(data)): the kernel does not
check them, so callers clip first, as the reference's callers do.
"""

from __future__ import annotations

import ctypes

import torch

_INDEX_DTYPES = (torch.int32, torch.int64)


def _check(data: torch.Tensor, idx: torch.Tensor) -> None:
    if data.dim() != 1 or not data.is_contiguous() \
            or data.element_size() not in (4, 8) or data.dtype == torch.bool:
        raise ValueError("flat_gather data must be a contiguous 1-D tensor "
                         "of 4- or 8-byte elements; got "
                         f"{data.dtype} {tuple(data.shape)}")
    if idx.dtype not in _INDEX_DTYPES or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError("flat_gather indices must be a contiguous 1-D int32 "
                         f"or int64 tensor; got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != data.device:
        raise ValueError(f"flat_gather data on {data.device}, indices on "
                         f"{idx.device}")
    if data.shape[0] == 0 and idx.shape[0] > 0:
        raise ValueError("flat_gather from empty data")


def _kernel_lib():
    from velox_tpu_torch.native.build import load_kernel
    fn = load_kernel("flat_gather").vt_flat_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flat_gather_reference(data: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain B5: torch indexing."""
    return data[idx.long()]


def flat_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """B5: ``data[idx]`` for 4- or 8-byte data and int32/int64 indices in
    [0, len(data))."""
    _check(data, idx)
    dev = data.device
    if dev.type == "cuda":
        out = torch.empty(idx.shape, dtype=data.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = _kernel_lib()(data.element_size(), idx.element_size(),
                                data.data_ptr(), data.shape[0],
                                idx.data_ptr(), idx.shape[0], out.data_ptr(),
                                stream)
        if err != 0:
            raise RuntimeError(f"flat gather kernel launch failed: CUDA error "
                               f"{err}")
        flat_gather.launches += 1
        return out
    if dev.type == "cpu":
        return flat_gather_reference(data, idx)
    raise ValueError(f"flat_gather has no kernel for {dev}")


flat_gather.launches = 0


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` of a 1-D row-aligned tensor: through B5 when ``a`` has
    4- or 8-byte elements and ``idx`` is an int32/int64 index tensor,
    plain indexing otherwise (bool validity and narrower columns lie
    outside B5's contract)."""
    if a.dim() == 1 and a.element_size() in (4, 8) \
            and a.dtype != torch.bool and idx.dtype in _INDEX_DTYPES:
        return flat_gather(a.contiguous(), idx.contiguous())
    return a[idx]
