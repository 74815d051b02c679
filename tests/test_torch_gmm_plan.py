"""The bf16 grouped-matmul kernels' walks (``dlsc_tpu_torch/csrc/gmm.cu``),
which no CPU run can execute, held to their contracts through their Python
mirrors under hypothesis, over group sizes with empty groups, one-row groups
and one group holding every row:

- K4a (``_row_tiles``, ``_gmm_plan``, ``_tile_walk``): the row tiles
  partition [0, M) without straddling a group, there are at most
  ceil(M/128) + E of them, and the persistent walk visits each (row tile,
  column tile) pair once, whatever the SM count;
- K4b (``_tgmm_plan``, ``_slices``, ``_tile_walk``): the slices partition
  [0, M) without straddling a group, none longer than the plan's slice
  length, no more of them than the workspace's slots, and the walk of the
  (slice, output tile) units covers every (group, row, output tile) once.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from dlsc_tpu_torch.ops import gmm as G  # noqa: E402

# group sizes: empty groups, one-row groups, sizes about a 128-row tile, and
# (sometimes) one group holding every row
_sizes = st.one_of(
    st.lists(st.one_of(st.just(0), st.just(1), st.integers(0, 300),
                       st.sampled_from([127, 128, 129, 255, 256, 257])),
             min_size=1, max_size=12),
    st.tuples(st.integers(1, 40), st.integers(0, 11), st.integers(1, 1000)).map(
        lambda t: [0] * min(t[1], t[0] - 1) + [t[2]] + [0] * (t[0] - 1 - min(t[1], t[0] - 1))),
)


@settings(max_examples=300, deadline=None)
@given(_sizes)
def test_row_tiles_partition_the_rows_by_group(sizes):
    tiles = G._row_tiles(sizes)
    M, E = sum(sizes), len(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    owner = np.full(M, -1)
    for g, r0, r1 in tiles:
        assert 0 < r1 - r0 <= 128
        assert starts[g] <= r0 < r1 <= starts[g + 1]   # inside one group, never straddling
        assert (owner[r0:r1] == -1).all()
        owner[r0:r1] = g
    assert (owner >= 0).all()   # every row of [0, M) in exactly one tile
    assert {g for g, _, _ in tiles} == {g for g, size in enumerate(sizes) if size > 0}
    assert len(tiles) <= -(-M // 128) + E
    assert tiles == sorted(tiles, key=lambda t: t[1])


@settings(max_examples=300, deadline=None)
@given(_sizes, st.sampled_from([8, 96, 136, 384, 1536]), st.integers(1, 200),
       st.booleans())
def test_persistent_walk_covers_each_tile_once(sizes, n, sms, transpose_rhs):
    M, E = sum(sizes), len(sizes)
    plan = G._gmm_plan(max(M, 1), 384, n, E, transpose_rhs, sms)
    row_tiles = len(G._row_tiles(sizes))
    assert plan["col_tiles"] == -(-n // 128)
    assert row_tiles * plan["col_tiles"] <= plan["max_tiles"]
    assert 1 <= plan["grid"] <= sms
    walk = G._tile_walk(row_tiles, plan["col_tiles"], plan["grid"])
    seen = [pair for cta in walk for pair in cta]
    assert sorted(seen) == [(r, c) for r in range(row_tiles) for c in range(plan["col_tiles"])]
    for cta in walk:   # a CTA's row tiles never go back: the kernel carries the group forward
        assert [r for r, _ in cta] == sorted(r for r, _ in cta)


@settings(max_examples=300, deadline=None)
@given(_sizes, st.sampled_from([(384, 1536), (1536, 384), (40, 136), (8, 8)]),
       st.integers(1, 200))
def test_tgmm_walk_covers_each_group_row_and_tile_once(sizes, kn, sms):
    k, n = kn
    M, E = sum(sizes), len(sizes)
    plan = G._tgmm_plan(M, k, n, E, sms)
    S = plan["slice_rows"]
    assert S % 64 == 0 and S >= 64
    assert plan["tiles"] == -(-k // 128) * -(-n // 128) == plan["k_tiles"] * plan["n_tiles"]
    slices = G._slices(sizes, S)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for g, r0, r1 in slices:
        assert 0 < r1 - r0 <= S
        assert starts[g] <= r0 < r1 <= starts[g + 1]   # inside one group, never straddling
    assert len(slices) <= plan["slots"] == -(-M // S) + E
    assert plan["workspace"] == plan["slots"] * plan["tiles"] * 128 * 128
    assert plan["reduce_grid"] == (plan["tiles"] * 128 // 8, E)   # 8 output rows a CTA
    assert 1 <= plan["grid"] <= min(sms, plan["max_units"])
    assert plan["max_units"] >= len(slices) * plan["tiles"]
    walk = G._tile_walk(len(slices), plan["tiles"], plan["grid"])
    seen = sorted((slices[s][0], row, tile) for cta in walk for s, tile in cta
                  for row in range(slices[s][1], slices[s][2]))
    assert seen == sorted((g, row, tile) for g in range(E)
                          for row in range(starts[g], starts[g + 1])
                          for tile in range(plan["tiles"]))
    for cta in walk:   # a CTA's slices never go back: the kernel carries the group forward
        assert [s for s, _ in cta] == sorted(s for s, _ in cta)


@pytest.mark.parametrize("sizes", [(0, 5, 0), (0, 0, 700), (700, 0, 0), (700,), (0,), (64, 64)])
def test_tgmm_slices_at_the_edges(sizes):
    """Empty first and last groups, one group, no rows at all: the slices
    are the nonempty groups' rows, cut at the slice length; rows past M (a
    size sum above M) are cut as the kernel cuts them."""
    M = sum(sizes)
    plan = G._tgmm_plan(M, 384, 1536, len(sizes), 132)
    S = plan["slice_rows"]
    slices = G._slices(sizes, S)
    assert {g for g, _, _ in slices} == {g for g, s in enumerate(sizes) if s}
    assert sum(r1 - r0 for _, r0, r1 in slices) == M
    assert [r0 for _, r0, _ in slices] == sorted(r0 for _, r0, _ in slices)
    assert plan["grid"] >= 1 and len(slices) <= plan["slots"]
    if M:
        assert sum(r1 - r0 for _, r0, r1 in G._slices(sizes, S, M - 1)) == M - 1
