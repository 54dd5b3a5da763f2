"""The gram kernel's tile map, row split and summation order, on the CPU.

``csrc/gram.cu`` runs only on the card.  These tests restate in Python
what it does, from the constants ``kernels/ops.py`` passes it
(``GRAM_CLUSTER``, ``gram_stage_rows``, ``gram_tile``, ``GRAM_THREADS``,
``GRAM_MAX_GROUPS``), and check that:

- the folded tile map (4 x 4 or 8 x 8 sums a thread) covers every entry
  (i ≤ j) of the augmented triangle [X | y]ᵀ[X | y] exactly once, for
  every c the kernel takes, and each rank's count of the bytes it waits
  for matches the slots it owns;
- the cluster's ranks, and the stages inside a rank, cover every row of X
  exactly once;
- the kernel's order of summation (per group over interleaved rows of
  each stage; per rank the groups in order, then the ranks 0, 1, ... in
  order), repeated in f32 torch with each FMA taken in f64 and rounded
  once to f32, agrees with ``ref.gram_ref`` and with the Pallas kernel in
  interpret mode (``repro.kernels.ops.gram``) within rtol 1e-5 and atol
  1e-5·max|G|, the tolerance of tests/test_torch_kernels.py: the same f32
  products summed in another order move an entry by a few ulps of the
  largest partial sum;
- that order gives an exactly symmetric G and the same bits twice.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref

#: shared memory a Hopper block can take (bytes), and the kernel's tile
SMEM_OPTIN = 232_448
TILES = (4, 8)


def _shape(c: int, tile: int):
    """(columns of [X | y], padded pitch, tiles per side, folded slots,
    row groups, passes): ``make_shape`` in csrc/gram.cu.  A group's threads
    are the slots rounded up to a whole warp."""
    cols = c + 1
    pitch = -(-cols // tile) * tile
    nt = pitch // tile
    slots = (nt // 2 + 1) * nt
    fit = ops.GRAM_THREADS // (-(-slots // 32) * 32)
    groups = 1 if fit < 1 else min(fit, ops.GRAM_MAX_GROUPS)
    return cols, pitch, nt, slots, groups, -(-slots // ops.GRAM_THREADS)


def _slot_tiles(nt: int):
    """Every folded slot -> (bi, bj, valid): ``slot_tile`` in csrc/gram.cu,
    over numpy arrays."""
    s = np.arange((nt // 2 + 1) * nt)
    r, q = s // nt, s % nt
    upper = q >= r
    bi = np.where(upper, r, nt - r)
    bj = np.where(upper, q, nt - r + q)
    return bi, bj, upper | (nt - r > r)


def _rank_rows(m: int, n: int):
    """Rank q's rows [lo, hi): m // n each, one more for the first m % n
    ranks (``rank_rows`` in csrc/gram.cu)."""
    base, extra = divmod(m, n)
    out = []
    for q in range(n):
        lo = q * base + min(q, extra)
        out.append((lo, lo + base + (q < extra)))
    return out


@pytest.mark.parametrize("m,c,tile", [
    (1000, 45, 4), (2000, 45, 4), (100000, 45, 8), (1000, 1, 4),
    (4096, 1, 4), (4097, 1, 8), (1000, 83, 4), (1000, 84, 8),
    (777, 256, 8)])
def test_tile_choice(m, c, tile):
    """4 x 4 where one pass covers the triangle and each rank's rows fit
    one stage; 8 x 8 where the call streams rows or needs more passes."""
    assert ops.gram_tile(m, c) == tile


def test_constants_match_the_kernel_source():
    src = (build.CSRC / "gram.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == ops.GRAM_THREADS
    assert const("kStageElems") == ops.GRAM_STAGE_ELEMS
    assert const("kMaxGroups") == ops.GRAM_MAX_GROUPS
    assert const("kMaxCols") == ops.GRAM_MAX_COLS
    assert 1 <= ops.GRAM_CLUSTER <= const("kMaxCluster")


@pytest.mark.parametrize("tile", TILES)
def test_tile_map_covers_the_augmented_triangle_once(tile):
    for c in range(1, ops.GRAM_MAX_COLS + 1):
        cols, pitch, nt, slots, groups, passes = _shape(c, tile)
        bi, bj, valid = _slot_tiles(nt)
        assert len(bi) == slots and np.all(bi[valid] <= bj[valid])
        assert np.all((0 <= bi) & (bj < nt))
        a, b = np.meshgrid(np.arange(tile), np.arange(tile), indexing="ij")
        i = tile * bi[valid, None, None] + a
        j = tile * bj[valid, None, None] + b
        keep = (i <= j) & (j < cols)          # upper half of diagonal tiles
        count = np.zeros((cols, cols), np.int64)
        np.add.at(count, (i[keep], j[keep]), 1)
        want = np.triu(np.ones((cols, cols), np.int64))
        assert np.array_equal(count, want), c
        # one slot per thread: groups x slots in one pass, or slots over
        # passes of one group
        stride = -(-slots // 32) * 32
        assert (passes == 1 and groups * stride <= ops.GRAM_THREADS
                or groups == 1 and passes * ops.GRAM_THREADS >= slots)
        # a stage fits the threads' loads; a block's shared memory (its
        # barrier, two stages, the sums it owns from every rank and, with
        # more than one group, every group's sums) fits
        rows = ops.gram_stage_rows(c)
        assert 1 <= rows <= ops.GRAM_THREADS
        assert rows * cols <= ops.GRAM_STAGE_ELEMS
        for n in range(1, 17):
            # the bytes each rank waits for: its slots that exist, counted
            # without walking them (csrc/gram.cu's owned_below)
            def below(b, q):
                return (b - q + n - 1) // n if b > q else 0
            half = nt // 2
            for q in range(n):
                count = below(slots, q)
                if nt % 2 == 0:
                    count -= (below(half * nt + half, q)
                              - below(half * nt, q))
                assert count == int(np.sum(valid[q::n])), (c, n, q)
            owned = -(-slots // n)
            sums = (n * owned + (groups * slots if groups > 1 else 0))
            smem = 16 + 4 * (2 * rows * pitch + sums * tile * tile)
            assert smem <= SMEM_OPTIN, (c, n)


@pytest.mark.parametrize("m", [1, 7, 8, 15, 1000, 2000, 100003])
def test_row_split_covers_each_row_once(m):
    for n in sorted({1, 8, ops.GRAM_CLUSTER}):
        seen = np.zeros(m, np.int64)
        for c in (1, 45, 256):
            seen[:] = 0
            stage = ops.gram_stage_rows(c)
            for lo, hi in _rank_rows(m, n):
                assert lo <= hi
                for s0 in range(lo, hi, stage):
                    seen[s0:min(s0 + stage, hi)] += 1
            assert np.all(seen == 1), (m, n, c)


def _emulate(x: torch.Tensor, y: torch.Tensor,
             cluster: int = ops.GRAM_CLUSTER):
    """csrc/gram.cu's sums in its order, in f32 (each FMA in f64, rounded
    once to f32)."""
    m, c = x.shape
    cols, _, _, _, groups, _ = _shape(c, ops.gram_tile(m, c, cluster))
    stage = ops.gram_stage_rows(c)
    xt = torch.cat([x.float(), y.float()[:, None]], 1).double()
    total = None
    for lo, hi in _rank_rows(m, cluster):
        acc = torch.zeros(groups, cols, cols, dtype=torch.float32)
        for s0 in range(lo, hi, stage):
            rows = min(stage, hi - s0)
            for t in range(0, rows, groups):  # group g takes row t + g
                n = min(groups, rows - t)
                xs = xt[s0 + t:s0 + t + n]
                acc[:n] = (xs[:, :, None] * xs[:, None, :]
                           + acc[:n].double()).float()
        part = acc[0]
        for g in range(1, groups):
            part = part + acc[g]
        total = part if total is None else total + part
    upper = torch.triu(total[:c, :c])
    return upper + torch.triu(upper, 1).T, total[:c, c].clone()


def _inputs(m, c, dtype):
    rng = np.random.default_rng(7 * m + c)
    x = rng.normal(size=(m, c)).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)))


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("m,c", [(1, 45), (7, 45), (1000, 45), (1000, 1),
                                 (777, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_summation_order_matches_ref_and_pallas(m, c, dtype):
    (jx, jy), (tx, ty) = _inputs(m, c, dtype)
    g, r = _emulate(tx, ty)
    g_ref, r_ref = ref.gram_ref(tx, ty)
    g_pl, r_pl = jops.gram(jx, jy)                  # Pallas, interpret mode
    for want_g, want_r in ((g_ref.numpy(), r_ref.numpy()), (g_pl, r_pl)):
        _close(g.numpy(), want_g)
        _close(r.numpy(), want_r)


@pytest.mark.parametrize("m,c", [(1000, 45), (777, 256)])
def test_summation_order_is_symmetric_and_repeatable(m, c):
    _, (tx, ty) = _inputs(m, c, "f32")
    g1, r1 = _emulate(tx, ty)
    g2, r2 = _emulate(tx, ty)
    assert torch.equal(g1, g1.T)
    assert torch.equal(g1, g2) and torch.equal(r1, r2)
    # another cluster size sums in another order: close, not the same bits
    g8, _ = _emulate(tx, ty, cluster=8)
    _close(g8.numpy(), g1.numpy())
