"""Radix-pass kernels B2, B3 and B4 of the torch port against the JAX
reference's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas.py does,
at up to a few tiles of rows. Every comparison is exact: ranks, positions and
counts are integers. The CUDA kernels themselves are held against the same
plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu.ops import pallas_kernels as PK
from velox_tpu_torch.ops import radix as R

torch.set_num_threads(1)

DISTS = ["uniform", "one_digit", "w1", "w2", "w7", "sorted", "reversed"]


def _digits(dist: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "one_digit":
        return np.full(n, 173, np.int32)
    if dist.startswith("w"):
        return rng.integers(0, 1 << int(dist[1:]), n, dtype=np.int32)
    d = rng.integers(0, 256, n, dtype=np.int32)
    if dist == "sorted":
        d.sort()
    elif dist == "reversed":
        d = np.sort(d)[::-1].copy()
    return d


def _stable_positions(d: np.ndarray) -> np.ndarray:
    pos = np.empty(len(d), np.int64)
    pos[np.argsort(d, kind="stable")] = np.arange(len(d))
    return pos


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n", [1, 255, 3 * 4096 - 5])
def test_pass_positions_match_pallas(n, dist):
    d = _digits(dist, n)
    want = np.asarray(PK.radix_pass_positions(jnp.asarray(d), n,
                                              interpret=True))
    want_ng = np.asarray(PK.radix_pass_positions_nogather(
        jnp.asarray(d), n, interpret=True))
    t = torch.from_numpy(d)
    got = R.radix_pass_positions(t, n)
    got_ng = R.radix_pass_positions_nogather(t, n)
    assert got.dtype == got_ng.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_ng.numpy(), want_ng)
    np.testing.assert_array_equal(got.numpy(), _stable_positions(d))


@pytest.mark.parametrize("dist", ["uniform", "one_digit", "w2"])
@pytest.mark.parametrize("n_blocks", [1, 3])
def test_hist_matches_pallas(n_blocks, dist):
    d = _digits(dist, n_blocks * PK.BLOCK, seed=n_blocks)
    want = np.asarray(PK._radix_hist_call(jnp.asarray(d), n_blocks,
                                          interpret=True))
    table = R.radix_hist(torch.from_numpy(d))
    assert table.dtype == torch.int32
    assert tuple(table.shape) == (R.RADIX, R._n_tiles(len(d)))
    np.testing.assert_array_equal(table.sum(1).numpy(), want)


@pytest.mark.parametrize("dist", ["uniform", "w1", "reversed"])
def test_ranks_and_totals_match_pallas(dist):
    n_blocks = 3
    d = _digits(dist, n_blocks * PK.BLOCK, seed=5)
    want_r, want_t = PK._radix_rank_call(jnp.asarray(d), n_blocks,
                                         interpret=True)
    ranks, totals = R.radix_ranks_totals(torch.from_numpy(d))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("n", [R.TILE_ROWS - 1, 3 * R.TILE_ROWS + 17])
def test_modes_over_tiles(n):
    """The per-tile modes, fed the scans of the histogram, give what the
    whole-pass functions give: B2 the rank among all rows of the digit,
    B3 the destination; over several tiles and a ragged last one."""
    d = torch.from_numpy(_digits("uniform", n, seed=n))
    table = R.radix_hist(d)
    np.testing.assert_array_equal(
        table.sum(1).numpy(), np.bincount(d.numpy(), minlength=256))
    offset, totals = R._tile_offsets(table)
    base = torch.cumsum(totals, 0) - totals
    pos = R.radix_pos(d, R._destinations(table))
    np.testing.assert_array_equal(pos.numpy(), _stable_positions(d.numpy()))
    rank = R.radix_rank(d, offset.contiguous())
    np.testing.assert_array_equal((rank + base[d.long()]).numpy(),
                                  pos.numpy())
    np.testing.assert_array_equal(
        R.radix_pass_positions_reference(d, n).numpy(), pos.numpy())


def test_cpu_runs_the_plain_versions():
    d = torch.from_numpy(_digits("uniform", 5000))
    before = (R.radix_hist.launches, R.radix_rank.launches,
              R.radix_pos.launches)
    R.radix_pass_positions(d, 5000)
    R.radix_pass_positions_nogather(d, 5000)
    assert (R.radix_hist.launches, R.radix_rank.launches,
            R.radix_pos.launches) == before


@pytest.mark.parametrize("bad", ["int64", "2d", "strided", "capacity",
                                 "table", "device"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    d = torch.zeros(2048, dtype=torch.int32)
    table = R.radix_hist(d)
    with pytest.raises(ValueError):
        if bad == "int64":
            R.radix_hist(d.long())
        elif bad == "2d":
            R.radix_hist(d.reshape(32, 64))
        elif bad == "strided":
            R.radix_hist(torch.zeros(4096, dtype=torch.int32)[::2])
        elif bad == "capacity":
            R.radix_pass_positions(d, 1024)
        elif bad == "table":
            R.radix_pos(d, table[:128].contiguous())
        else:
            R.radix_hist(torch.zeros(2048, dtype=torch.int32,
                                     device="meta"))


# ---------------------------------------------------------------------------
# The int64 sort state: B4 over its low digit, B3's scatter form
# ---------------------------------------------------------------------------

def _state(n: int, width: int, seed: int) -> np.ndarray:
    """An int64 sort state: a random low digit of `width` bits under
    random upper bits that use all 64, the sign bit included."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    return (hi & ~np.int64((1 << width) - 1)) \
        | rng.integers(0, 1 << width, n, dtype=np.int64)


@pytest.mark.parametrize("width", range(1, 9))
@pytest.mark.parametrize("n", [1, 255, 3 * 4096 - 5, 2 * 8192 + 3])
def test_hist_of_the_state_matches_numpy_and_pallas(n, width):
    state = _state(n, width, seed=n + width)
    table = R.radix_hist(torch.from_numpy(state), width)
    assert table.dtype == torch.int32
    assert tuple(table.shape) == (R.RADIX, R._n_tiles(n))
    digits = (state & ((1 << width) - 1)).astype(np.int32)
    want = np.zeros((R.RADIX, R._n_tiles(n)), np.int64)
    np.add.at(want, (digits, np.arange(n) // R.TILE_ROWS), 1)
    np.testing.assert_array_equal(table.numpy(), want)
    # the reference's histogram kernel over the extracted digits, padded
    # to its blocks with digit 255 as the reference pads
    n_blocks = -(-n // PK.BLOCK)
    padded = np.full(n_blocks * PK.BLOCK, R.RADIX - 1, np.int32)
    padded[:n] = digits
    totals = np.array(PK._radix_hist_call(jnp.asarray(padded), n_blocks,
                                          interpret=True))
    totals[R.RADIX - 1] -= len(padded) - n
    np.testing.assert_array_equal(table.sum(1).numpy(), totals)


def _numpy_scatter(state: np.ndarray, width: int, pos) -> np.ndarray:
    nxt = np.empty_like(state)
    nxt[np.asarray(pos)] = (state.view(np.uint64)
                            >> np.uint64(width)).view(np.int64)
    return nxt


@pytest.mark.parametrize("width", [1, 3, 8])
@pytest.mark.parametrize("n", [255, 3 * 4096 - 5, 3 * R.TILE_ROWS + 17])
def test_scatter_pass_matches_pallas_positions(n, width):
    """B3's scatter form: the reference's no-gather destinations of the
    low digits, then the logically shifted state scattered there; the
    same order as a stable argsort of the digits. The largest n spans
    several tiles and a ragged last one."""
    state = _state(n, width, seed=7 * n + width)
    t = torch.from_numpy(state)
    got = R.radix_scatter_pass(t, width, R._destinations(
        R.radix_hist(t, width)))
    assert got.dtype == torch.int64
    digits = (state & ((1 << width) - 1)).astype(np.int32)
    pos = PK.radix_pass_positions_nogather(jnp.asarray(digits), n,
                                           interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_scatter(state, width, pos))
    order = np.argsort(digits, kind="stable")
    np.testing.assert_array_equal(
        got.numpy(),
        (state[order].view(np.uint64) >> np.uint64(width)).view(np.int64))


def test_state_wrappers_run_the_plain_versions_on_the_cpu():
    t = torch.from_numpy(_state(5000, 8, seed=1))
    before = (R.radix_hist.launches, R.radix_rank.launches,
              R.radix_pos.launches)
    table = R.radix_hist(t, 8)
    R.radix_scatter_pass(t, 8, R._destinations(table))
    assert (R.radix_hist.launches, R.radix_rank.launches,
            R.radix_pos.launches) == before


@pytest.mark.parametrize("bad", ["meta", "width0", "width9", "int32",
                                 "table", "strided"])
def test_scatter_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = torch.from_numpy(_state(2048, 8, seed=2))
    dest = R._destinations(R.radix_hist(t, 8))
    with pytest.raises(ValueError):
        if bad == "meta":
            R.radix_scatter_pass(t.to("meta"), 8, dest.to("meta"))
        elif bad == "width0":
            R.radix_scatter_pass(t, 0, dest)
        elif bad == "width9":
            R.radix_hist(t, 9)
        elif bad == "int32":
            R.radix_scatter_pass(t.to(torch.int32), 8, dest)
        elif bad == "table":
            R.radix_scatter_pass(t, 8, dest[:, :0].contiguous())
        else:
            R.radix_hist(torch.from_numpy(_state(4096, 8, seed=3))[::2], 8)


# ---------------------------------------------------------------------------
# The int32 sort word of the classic loop: B4 over its low digit, B2's
# rank-and-scatter form
# ---------------------------------------------------------------------------

def _word(kind: str, n: int, width: int, seed: int) -> np.ndarray:
    """An int32 sort word (the bits of a uint32): random over all 32 bits,
    so about half have bit 31 set; one digit under random upper bits; or
    sorted as unsigned words."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    if kind == "one_digit":
        w = (w & ~np.int32((1 << width) - 1)) | np.int32(5 % (1 << width))
    elif kind == "sorted":
        w = np.sort(w.view(np.uint32)).view(np.int32)
    return w


def _scatter_lanes(word: np.ndarray, perm: np.ndarray, width: int, pos):
    """numpy scatter of ((uint32)word >> width, perm) to `pos`."""
    pos = np.asarray(pos)
    nword, nperm = np.empty_like(word), np.empty_like(perm)
    nword[pos] = (word.view(np.uint32) >> np.uint32(width)).view(np.int32)
    nperm[pos] = perm
    return nword, nperm


@pytest.mark.parametrize("kind", ["bit31", "one_digit", "sorted"])
@pytest.mark.parametrize("width", range(1, 9))
@pytest.mark.parametrize("n", [1, 255, 8193, 3 * 8192 + 5])
def test_rank_scatter_matches_pallas_positions(n, width, kind):
    """B2's rank-and-scatter form: the reference's no-gather destinations
    of the word's low digits, then the logically shifted word and the
    permutation scattered there; without the word lane, the permutation
    alone."""
    word = _word(kind, n, width, seed=31 * n + width)
    perm = np.random.default_rng(n + width).permutation(n).astype(np.int32)
    tw, tp = torch.from_numpy(word), torch.from_numpy(perm)
    dest = R._destinations(R.radix_hist(tw, width))
    digits = (word & ((1 << width) - 1)).astype(np.int32)
    pos = PK.radix_pass_positions_nogather(jnp.asarray(digits), n,
                                           interpret=True)
    want_word, want_perm = _scatter_lanes(word, perm, width, pos)
    got_word, got_perm = R.radix_rank_scatter(tw, width, tp, dest)
    assert got_word.dtype == got_perm.dtype == torch.int32
    np.testing.assert_array_equal(got_word.numpy(), want_word)
    np.testing.assert_array_equal(got_perm.numpy(), want_perm)
    spent, last_perm = R.radix_rank_scatter(tw, width, tp, dest,
                                            keep_word=False)
    assert spent is None
    np.testing.assert_array_equal(last_perm.numpy(), want_perm)


@pytest.mark.parametrize("width", range(1, 9))
def test_hist_of_a_word_matches_numpy(width):
    n = 3 * R.TILE_ROWS + 5
    word = _word("bit31", n, width, seed=width)
    table = R.radix_hist(torch.from_numpy(word), width)
    assert table.dtype == torch.int32
    want = np.zeros((R.RADIX, R._n_tiles(n)), np.int64)
    np.add.at(want, (word & ((1 << width) - 1), np.arange(n) // R.TILE_ROWS),
              1)
    np.testing.assert_array_equal(table.numpy(), want)


def test_word_wrappers_run_the_plain_versions_on_the_cpu():
    t = torch.from_numpy(_word("bit31", 5000, 8, seed=1))
    perm = torch.arange(5000, dtype=torch.int32)
    before = (R.radix_hist.launches, R.radix_rank.launches,
              R.radix_pos.launches)
    R.radix_rank_scatter(t, 8, perm, R._destinations(R.radix_hist(t, 8)))
    assert (R.radix_hist.launches, R.radix_rank.launches,
            R.radix_pos.launches) == before


@pytest.mark.parametrize("bad", ["int64", "width0", "width9", "perm_int64",
                                 "perm_short", "strided_word",
                                 "strided_perm", "table", "meta"])
def test_rank_scatter_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = torch.from_numpy(_word("bit31", 2048, 8, seed=2))
    perm = torch.arange(2048, dtype=torch.int32)
    dest = R._destinations(R.radix_hist(t, 8))
    with pytest.raises(ValueError):
        if bad == "int64":
            R.radix_rank_scatter(t.long(), 8, perm, dest)
        elif bad == "width0":
            R.radix_rank_scatter(t, 0, perm, dest)
        elif bad == "width9":
            R.radix_rank_scatter(t, 9, perm, dest)
        elif bad == "perm_int64":
            R.radix_rank_scatter(t, 8, perm.long(), dest)
        elif bad == "perm_short":
            R.radix_rank_scatter(t, 8, perm[:2047], dest)
        elif bad == "strided_word":
            R.radix_rank_scatter(
                torch.from_numpy(_word("bit31", 4096, 8, seed=3))[::2], 8,
                perm, dest)
        elif bad == "strided_perm":
            R.radix_rank_scatter(
                t, 8, torch.arange(4096, dtype=torch.int32)[::2], dest)
        elif bad == "table":
            R.radix_rank_scatter(t, 8, perm, dest[:, :0].contiguous())
        else:
            R.radix_rank_scatter(t.to("meta"), 8, perm.to("meta"),
                                 dest.to("meta"))
