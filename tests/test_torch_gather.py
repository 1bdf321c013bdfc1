"""Kernel B5 (ops/gather.py ``flat_gather``, ``gather_rows``) against the
JAX reference.

On the CPU the wrappers run their plain version: it must equal the
reference's Pallas kernel run in interpret mode on the reference's own
cases (32-bit data), and numpy on the 8-byte and int64-index cases the
TPU kernel does not take; the multi-column form must equal per-column
gathers over mixed widths. The dispatch is checked too: CPU tensors count
no launch, and what the kernel does not take raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu.ops.pallas_kernels import flat_gather as jax_flat_gather
from velox_tpu_torch import types as T
from velox_tpu_torch.exec.batch_utils import take_columns_rows
from velox_tpu_torch.ops import gather as G
from velox_tpu_torch.ops.gather import (
    flat_gather, flat_gather_reference, gather_rows, take_many_rows,
    take_rows,
)
from velox_tpu_torch.vector.device import DeviceColumn

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


_MIXES = {
    "int32": [np.int32],
    "int64_float64": [np.int64, np.float64],
    "all_four": [np.int32, np.int64, np.float32, np.float64],
    "eight": [np.int32, np.int64, np.float32, np.float64] * 2,
}


def _columns(dtypes, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 1e6).astype(dt) for dt in dtypes]


def _indices(pattern: str, n: int, m: int, idx_dtype, seed: int):
    rng = np.random.default_rng(seed)
    idx = {"uniform": rng.integers(0, n, m),
           "sorted": np.sort(rng.integers(0, n, m)),
           "constant": np.full(m, n // 2)}[pattern]
    return np.ascontiguousarray(idx.astype(idx_dtype))


@pytest.mark.parametrize("mix", sorted(_MIXES))
@pytest.mark.parametrize("pattern", ["uniform", "sorted", "constant"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_rows_equals_per_column_gathers(mix, pattern, idx_dtype):
    cols = _columns(_MIXES[mix], 3001, 5)
    idx = _indices(pattern, 3001, 7919, idx_dtype, 6)
    launches = gather_rows.launches
    got = gather_rows([torch.from_numpy(c) for c in cols],
                      torch.from_numpy(idx))
    assert gather_rows.launches == launches  # CPU: the plain version
    assert len(got) == len(cols)
    for g, c in zip(got, cols):
        assert g.dtype == torch.from_numpy(c).dtype
        np.testing.assert_array_equal(g.numpy(), c[idx])
        np.testing.assert_array_equal(
            g.numpy(), flat_gather_reference(torch.from_numpy(c),
                                             torch.from_numpy(idx)).numpy())


@pytest.mark.parametrize("case", ["empty_index", "one_row_data",
                                  "one_row_index"])
def test_gather_rows_edges(case):
    cols = [torch.tensor([7], dtype=torch.int32),
            torch.tensor([-3], dtype=torch.float64)]
    if case == "empty_index":
        idx = torch.zeros(0, dtype=torch.int64)
    elif case == "one_row_data":
        idx = torch.zeros(9, dtype=torch.int32)
    else:
        cols = [torch.arange(10, dtype=torch.int64),
                torch.arange(10, dtype=torch.float32)]
        idx = torch.tensor([9], dtype=torch.int32)
    got = gather_rows(cols, idx)
    for g, c in zip(got, cols):
        assert g.shape == idx.shape and g.dtype == c.dtype
        np.testing.assert_array_equal(g.numpy(), c.numpy()[idx.numpy()])


@pytest.mark.parametrize("bad", ["no_columns", "nine_columns", "bool_column",
                                 "int16_column", "other_device",
                                 "int8_index"])
def test_gather_rows_rejects_what_the_kernel_does_not_take(bad):
    cols = [torch.arange(16, dtype=torch.int32),
            torch.arange(16, dtype=torch.int64)]
    idx = torch.arange(4, dtype=torch.int32)
    if bad == "no_columns":
        cols = []
    elif bad == "nine_columns":
        cols = [cols[0]] * (G.MAX_COLUMNS + 1)
    elif bad == "bool_column":
        cols.append(cols[0] > 3)
    elif bad == "int16_column":
        cols.append(cols[0].to(torch.int16))
    elif bad == "other_device":
        cols.append(cols[0].to("meta"))
    else:
        idx = idx.to(torch.int8)
    with pytest.raises(ValueError):
        gather_rows(cols, idx)


def test_take_many_rows_routes_4_and_8_byte_arrays_in_launch_sized_chunks(
        monkeypatch):
    """Eleven wide arrays go to gather_rows as 8 + 3; bool and int16
    arrays are indexed plainly; the results keep their order."""
    calls = []
    real = G.gather_rows

    def spy(columns, idx):
        calls.append(len(columns))
        return real(columns, idx)

    monkeypatch.setattr(G, "gather_rows", spy)
    rng = np.random.default_rng(9)
    arrays = [torch.from_numpy(c) for c in _columns(
        [np.int32, np.int64, np.float32, np.float64] * 3, 500, 10)][:11]
    arrays.insert(3, torch.from_numpy(rng.random(500) < 0.5))
    arrays.append(torch.arange(500, dtype=torch.int16))
    idx = torch.from_numpy(_indices("uniform", 500, 1200, np.int64, 11))
    got = take_many_rows(arrays, idx)
    assert calls == [8, 3]
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g.numpy(), a.numpy()[idx.numpy()])


def test_take_columns_rows_moves_validity_and_high_limbs():
    rng = np.random.default_rng(12)
    n = 300
    hi = DeviceColumn(torch.from_numpy(rng.integers(-5, 5, n)), None,
                      T.BIGINT)
    cols = {
        "d": DeviceColumn(torch.from_numpy(rng.integers(-9, 9, n)),
                          torch.from_numpy(rng.random(n) < 0.8),
                          T.decimal(38, 2), None, (hi,)),
        "s": DeviceColumn(torch.from_numpy(
            rng.integers(0, 5, n).astype(np.int32)), None, T.VARCHAR),
    }
    idx = torch.from_numpy(_indices("uniform", n, 777, np.int32, 13))
    got = take_columns_rows(cols, idx)
    i = idx.numpy()
    for name, col in cols.items():
        g = got[name]
        assert g.dtype == col.dtype
        np.testing.assert_array_equal(g.data.numpy(), col.data.numpy()[i])
        if col.validity is not None:
            np.testing.assert_array_equal(g.validity.numpy(),
                                          col.validity.numpy()[i])
    np.testing.assert_array_equal(got["d"].children[0].data.numpy(),
                                  hi.data.numpy()[i])
