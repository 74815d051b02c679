"""K3b's launch and walk (``dlsc_tpu_torch/csrc/ln_fused.cu``), which no CPU
run can execute, held to their contracts through their Python mirrors
(``_bwd_plan``, ``_bwd_tiles``) under hypothesis, over 1 to 10^6 rows, the
models' widths and the bounds of d, both element sizes, any SM count, with
the add and without (the LayerNorm alone: no dr stream):

- the CTAs' tiles cover every row exactly once, each CTA walking its own in
  increasing order, with no more CTAs than tiles or than the card holds;
- every bulk copy (a tile's r, dy and dr rows, or x and dy; its mu and rsig, past the
  last whole 16 bytes plain loads) starts and ends on 16 bytes in global and
  in shared memory, and never reads past the last row;
- a stage's bytes stay under the mbarrier's transaction count, the ring holds
  at least two stages, and the CTA's shared memory fits its share of the SM;
- a row's lanes are a power of two with at most 4 chunks each, and at the
  models' widths (192, 384, 768, 1024) no lane idles; without the add a
  stage holds twice the rows where two fit the stage's aim.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from dlsc_tpu_torch.ops import ln_fused as L  # noqa: E402

_rows = st.one_of(st.integers(1, 10**6), st.integers(1, 70),
                  st.sampled_from([10**6, 10**6 - 1, 49_152, 106_496, 106_495]))
_widths = st.one_of(st.sampled_from([8, 192, 384, 768, 1024]),
                    st.integers(1, L.MAX_D // 8).map(lambda c: 8 * c))


@settings(max_examples=120, deadline=None)
@given(rows=_rows, d=_widths, n_sm=st.integers(1, 132), elem=st.sampled_from([2, 4]),
       add=st.booleans())
def test_tiles_cover_every_row_once_with_aligned_spans(rows, d, n_sm, elem, add):
    p = L._bwd_plan(rows, d, n_sm, elem, add)
    streams = p["streams"]
    assert streams == (3 if add else 2)
    R = p["tile_rows"]
    assert R % 4 == 0 and R % p["rows_per_warp"] == 0
    assert (p["tiles"] - 1) * R < rows <= p["tiles"] * R
    assert 1 <= p["grid"] <= min(p["tiles"], n_sm * L.BWD_CTAS_PER_SM)
    walks = [np.asarray(L._bwd_tiles(p, cta)) for cta in range(p["grid"])]
    assert all(len(w) and (np.diff(w) > 0).all() for w in walks)
    tiles = np.sort(np.concatenate(walks))
    assert np.array_equal(tiles, np.arange(p["tiles"]))   # each tile, hence each row, once

    # bulk copies: global offsets and sizes of every tile (the last one short)
    row0 = tiles * R
    n = np.minimum(R, rows - row0)
    n4 = n & ~3
    assert (n > 0).all() and (row0 + n <= rows).all()
    assert (row0 * d * elem % 16 == 0).all() and (n * d * elem % 16 == 0).all()
    assert (row0 * 4 % 16 == 0).all() and (n4 * 4 % 16 == 0).all()
    assert (n - n4 <= 3).all() and (n4 == n)[:-1].all()   # plain stats loads: last tile only

    # shared memory: the mbarriers, then the stages, which end holding every
    # (warp, slot)'s dgamma / dbeta sums
    span = R * d * elem
    assert p["stage_bytes"] == streams * span + 8 * R
    ring = L.BWD_BAR_BYTES
    assert ring % 16 == 0 and p["stage_bytes"] % 16 == 0
    assert L.BWD_WARPS * p["rows_per_warp"] * 2 * d * 4 <= p["stages"] * p["stage_bytes"]
    assert all(off % 16 == 0 for off in (span, 2 * span, 3 * span, streams * span + 4 * R))
    assert 2 <= p["stages"] <= L.BWD_MAX_STAGES
    assert p["smem"] == ring + p["stages"] * p["stage_bytes"] <= L.BWD_SMEM_BUDGET
    assert L.BWD_CTAS_PER_SM * (p["smem"] + 1024) <= L.SMEM_LIMIT + 1024
    assert streams * span + 8 * R < 2**20   # one phase's transaction bytes

    # a row's lanes and chunks
    lanes, chunks = p["lanes"], p["chunks"]
    assert lanes & (lanes - 1) == 0 and lanes * p["rows_per_warp"] == 32
    assert 1 <= chunks <= 4 and lanes * chunks >= d // 8 > lanes * (chunks - 1)
    assert p["workspace"] == 2 * p["grid"] * d
    assert p["reduce_grid"] == (-(-d // 32), 2)


@pytest.mark.parametrize("add,d,lanes,tile_rows,stage_bytes", [
    (True, 192, 8, 16, 18_560), (True, 384, 16, 8, 18_496), (True, 768, 32, 4, 18_464),
    (True, 1024, 32, 4, 24_608), (False, 192, 8, 32, 24_832), (False, 384, 16, 16, 24_704),
    (False, 768, 32, 8, 24_640), (False, 1024, 32, 4, 16_416)])
def test_no_lane_idles_at_the_models_widths(add, d, lanes, tile_rows, stage_bytes):
    """At the models' widths a row's lanes hold 3 (4 at 1024) chunks each and
    none idles; a bf16 stage is 18-25 KB with the add and 16-25 KB without
    (twice the add's rows but at 1024), and the ring holds 4 of them."""
    p = L._bwd_plan(106_496, d, 132, add=add)
    assert (p["lanes"], p["tile_rows"]) == (lanes, tile_rows)
    assert p["lanes"] * p["chunks"] == d // 8
    assert p["stage_bytes"] == stage_bytes and p["stages"] == 4
    assert p["grid"] == 264
