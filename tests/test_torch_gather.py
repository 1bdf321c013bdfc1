"""Kernel B5 (ops/gather.py ``flat_gather``) against the JAX reference.

On the CPU the wrapper runs its plain version: it must equal the
reference's Pallas kernel run in interpret mode on the reference's own
cases (32-bit data), and numpy on the 8-byte and int64-index cases the
TPU kernel does not take. The dispatch is checked too: CPU tensors count
no launch, and what the kernel does not take raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu.ops.pallas_kernels import flat_gather as jax_flat_gather
from velox_tpu_torch.ops.gather import (
    flat_gather, flat_gather_reference, take_rows,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("n,m", [(1000, 3000), (1 << 16, 1 << 15),
                                 (129, 7)])
def test_plain_gather_equals_interpret_kernel(n, m):
    rng = np.random.RandomState(7)
    data = rng.randint(-10 ** 9, 10 ** 9, n).astype(np.int32)
    idx = rng.randint(0, n, m).astype(np.int32)
    want = np.asarray(jax_flat_gather(jnp.asarray(data), jnp.asarray(idx),
                                      interpret=True))
    launches = flat_gather.launches
    got = flat_gather(torch.from_numpy(data), torch.from_numpy(idx))
    assert flat_gather.launches == launches  # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.float32,
                                   np.int32])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("pattern", ["uniform", "sorted", "reversed",
                                     "constant"])
def test_plain_gather_equals_numpy(dtype, idx_dtype, pattern):
    rng = np.random.default_rng(3)
    n, m = 4099, 10_007
    data = (rng.standard_normal(n) * 1e6).astype(dtype)
    idx = rng.integers(0, n, m)
    if pattern == "sorted":
        idx = np.sort(idx)
    elif pattern == "reversed":
        idx = np.sort(idx)[::-1]
    elif pattern == "constant":
        idx = np.full(m, n - 1)
    idx = np.ascontiguousarray(idx.astype(idx_dtype))
    got = flat_gather(torch.from_numpy(data), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(got.numpy(), data[idx])
    np.testing.assert_array_equal(
        flat_gather_reference(torch.from_numpy(data),
                              torch.from_numpy(idx)).numpy(), data[idx])


def test_empty_index_and_one_row_data():
    data = torch.tensor([42], dtype=torch.int64)
    assert flat_gather(data, torch.zeros(0, dtype=torch.int32)).shape == (0,)
    np.testing.assert_array_equal(
        flat_gather(data, torch.zeros(5, dtype=torch.int64)).numpy(),
        [42] * 5)


@pytest.mark.parametrize("bad", ["int16_data", "bool_data", "int8_index",
                                 "2d_data", "strided_data", "empty_data",
                                 "meta_device"])
def test_what_the_kernel_does_not_take_raises(bad):
    data = torch.arange(16, dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32)
    if bad == "int16_data":
        data = data.to(torch.int16)
    elif bad == "bool_data":
        data = data > 3
    elif bad == "int8_index":
        idx = idx.to(torch.int8)
    elif bad == "2d_data":
        data = data.reshape(4, 4)
    elif bad == "strided_data":
        data = data[::2]
    elif bad == "empty_data":
        data = data[:0]
    else:
        data, idx = data.to("meta"), idx.to("meta")
    launches = flat_gather.launches
    with pytest.raises(ValueError):
        flat_gather(data, idx)
    assert flat_gather.launches == launches


def test_take_rows_routes_only_4_and_8_byte_rows_to_the_kernel():
    idx = torch.tensor([2, 0, 1], dtype=torch.int64)
    for t in (torch.arange(3, dtype=torch.int32),
              torch.arange(3, dtype=torch.int64),
              torch.tensor([True, False, True]),
              torch.arange(3, dtype=torch.int16)):
        np.testing.assert_array_equal(take_rows(t, idx).numpy(),
                                      t.numpy()[idx.numpy()])
    # a non-contiguous 8-byte view is made contiguous for the kernel
    strided = torch.arange(6, dtype=torch.int64)[::2]
    np.testing.assert_array_equal(take_rows(strided, idx).numpy(), [4, 0, 2])
