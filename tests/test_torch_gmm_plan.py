"""The bf16 grouped-matmul kernel's tile walk (``dlsc_tpu_torch/csrc/gmm.cu``),
which no CPU run can execute, held to its contract through its Python
mirrors ``_row_tiles``, ``_gmm_plan`` and ``_tile_walk`` under hypothesis,
over group sizes with empty groups, one-row groups and one group holding
every row: the row tiles partition [0, M) without straddling a group, there
are at most ceil(M/128) + E of them, and the persistent walk visits each
(row tile, column tile) pair once, whatever the SM count."""

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
