"""The counter-based dropout draw (``dlsc_tpu_torch/ops/dropout_draw.py``,
the plain version that a CPU tensor runs; its kernel ``csrc/dropout_draw.cu``
is held to it bit for bit on the card in ``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py``).

Bars, all exact (integer words, and one f32 division a kept entry):

- ``philox4x32`` against Random123's known-answer vectors of
  Philox4x32-10 and against a numpy reference written here (uint64
  products) at random keys and counters;
- a whole draw against the numpy reference: element g of the unsplit
  tensor kept iff word g & 3 of Philox(g >> 2, block, site; seed) is below
  floor(keep · 2^32), a kept entry x / keep in f32;
- under hypothesis: any box of any shape (an offset and a count on every
  dim, the last included) drawn alone is the same box of the unsplit draw;
  so are a forward's rows (``Draw.rows``) and a rank's equal part of a dim
  (``part``);
- under ``torch.func.vmap`` with a (K,) seed (and a per-trial rate), trial
  i equals the unbatched call at seed i, and so do the gradients;
- the ragged MoE's draw in the sort order (``dropout_rows``) equals the
  unsorted (token, choice) tensor's draw gathered into that order;
- the keep rate within 5 sigma of the binomial at rates 0.1 and 0.5;
- the kernel's launch plan (``_plan``), mirrored here as the kernel reads
  it: its magic numbers divide exactly like ``//``, its merged leading dims
  give every row the plain version's counter base, and each row's vector
  chunks and edge blocks cover every column exactly once, over the boxes
  the hypothesis tests above draw, the ragged rows and the models' sites.
"""

import math

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from dlsc_tpu_torch.ops import dropout_draw as D

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

M32 = np.uint64(0xFFFFFFFF)


def np_philox(ctr, key, rounds=10):
    """Philox4x32-R (Random123) on uint64 arrays holding 32-bit words."""
    c = [np.asarray(v, np.uint64) for v in ctr]
    k0, k1 = (np.asarray(v, np.uint64) for v in key)
    for i in range(rounds):
        if i:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & M32, (k1 + np.uint64(0xBB67AE85)) & M32
        p0, p1 = np.uint64(0xD2511F53) * c[0], np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M32, (p0 >> np.uint64(32)) ^ c[3] ^ k1,
             p0 & M32]
    return c


def np_draw(x: np.ndarray, rate: float, seed: int, block: int, site: int) -> np.ndarray:
    """The draw over an unsplit x, element by element as the docstring says."""
    g = np.arange(x.size, dtype=np.uint64)
    q = g >> np.uint64(2)
    s = np.uint64(seed)
    w = np_philox((q & M32, q >> np.uint64(32), np.full_like(q, block), np.full_like(q, site)),
                  (s & M32, s >> np.uint64(32)))
    word = np.choose((g & np.uint64(3)).astype(np.int64), w)
    keep = np.float32(1.0 - rate)
    kept = word < np.uint64(np.floor(np.float64(keep) * 2.0**32))
    return np.where(kept.reshape(x.shape), (x / keep).astype(np.float32), np.float32(0))


def test_philox_known_answers_and_numpy():
    """Random123's kat_vectors for philox4x32-10, and random words."""
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        got = D.philox4x32(*(torch.tensor(v) for v in ctr + key))
        assert [int(v) for v in got] == list(want)
        assert [int(v) for v in np_philox(ctr, key)] == list(want)
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (6, 1000), dtype=np.uint64)
    got = D.philox4x32(*(torch.from_numpy(w.astype(np.int64)) for w in words))
    want = np_philox(words[:4], words[4:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


@pytest.mark.parametrize("seed,block,site", [(0, 0, 0), (12345, 3, 1), (2**62 + 7, 11, 2)])
def test_draw_matches_numpy(seed, block, site):
    x = np.random.default_rng(seed % 97).standard_normal((3, 5, 37)).astype(np.float32)
    got = D.dropout(torch.from_numpy(x), 0.3, D.Draw(seed, block), site)
    np.testing.assert_array_equal(got.numpy(), np_draw(x, 0.3, seed, block, site))
    mask = D.keep_mask(x.shape, 0.3, seed, block, site)
    np.testing.assert_array_equal(mask.numpy(), np_draw(np.ones_like(x), 0.3, seed, block,
                                                        site) != 0)


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_any_box_is_the_same_box_of_the_unsplit_draw(data):
    """A box of x (a start and a count on every dim) drawn alone, with its
    unsplit strides and the counter of its first element, is the same box
    of the draw of the whole tensor."""
    ndim = data.draw(st.integers(1, 4))
    full = [data.draw(st.integers(1, 7)) for _ in range(ndim)]
    box = []
    for n in full:
        a = data.draw(st.integers(0, n - 1))
        box.append(slice(a, data.draw(st.integers(a + 1, n))))
    seed = data.draw(st.integers(0, 2**63 - 1))
    x = torch.randn(full)
    whole = D.dropout(x, 0.4, D.Draw(seed, 2), 1)
    strides, _ = D.geometry(tuple(full))
    all_strides = strides + [1]
    base = sum(s.start * t for s, t in zip(box, all_strides))
    part = x[tuple(box)].contiguous()
    if part.ndim == 1:   # a lone row: one leading dim of size 1
        got = D._dropout_op(part[None], torch.tensor(seed), torch.tensor(0.6), 2, 1,
                            [int(x.numel())], base, None)[0]
    else:
        got = D._dropout_op(part, torch.tensor(seed), torch.tensor(0.6), 2, 1,
                            all_strides[:-1], base, None)
    assert torch.equal(got, whole[tuple(box)])


@settings(max_examples=30, deadline=None)
@given(total=st.integers(1, 6), data=st.data())
def test_rows_and_parts_are_slices_of_the_unsplit_draw(total, data):
    """A forward's rows [start, start + count) of a global batch, with k
    entries a row on ``dim``, and a rank's equal part of another dim."""
    start = data.draw(st.integers(0, total - 1))
    count = data.draw(st.integers(1, total - start))
    k = data.draw(st.integers(1, 3))
    n, i = data.draw(st.integers(1, 3)), None
    i = data.draw(st.integers(0, n - 1))
    width = data.draw(st.integers(1, 4)) * n
    dim = data.draw(st.integers(0, 1))
    shape = [5, 6, width]
    shape[dim] = total * k
    x = torch.randn(shape)
    whole = D.dropout(x, 0.25, D.Draw(99, 1), 2)
    idx = [slice(None)] * 3
    idx[dim] = slice(start * k, (start + count) * k)
    idx[2] = slice(i * (width // n), (i + 1) * (width // n))
    got = D.dropout(x[tuple(idx)].contiguous(), 0.25, D.Draw(99, 1, (start, count, total)), 2,
                    dim=dim, part=(2, i, n))
    assert torch.equal(got, whole[tuple(idx)])


def test_vmap_trials_equal_unbatched_calls():
    """Under vmap the (K,) seeds and per-trial rates: trial i is the
    unbatched call at seed i, and so is its gradient (the same mask over
    the rate)."""
    seeds = D.trial_seeds(5, range(3))
    rates = torch.tensor([0.0, 0.3, 0.9])
    xs = torch.randn(3, 4, 9)

    def f(x, s, r):
        return D.dropout(x, r, D.Draw(s, 4), 1)

    out = vmap(f, randomness="error")(xs, seeds, rates)
    gs = vmap(grad(lambda x, s, r: (f(x, s, r) * x).sum()))(xs, seeds, rates)
    for i in range(3):
        want = f(xs[i], int(seeds[i]), rates[i])
        assert torch.equal(out[i], want)
        xi = xs[i].clone().requires_grad_()
        (f(xi, int(seeds[i]), rates[i]) * xi).sum().backward()
        assert torch.equal(gs[i], xi.grad)
    assert torch.equal(out[0], xs[0])   # rate 0 keeps everything
    # a trial's seed is its global slot's: the same on a rank holding slots 2..3
    assert torch.equal(D.trial_seeds(5, range(2, 4)), D.trial_seeds(5, range(4))[2:])


def test_ragged_sorted_rows_equal_the_unsorted_draw():
    """The ragged MoE's experts' masks drawn in the sort order (a sorted
    row's counter is its (token, choice) pair's row of the unsplit (B,
    n_real, K, F) tensor) equal the unsorted draw gathered into that order,
    also at a forward's rows and a rank's slice of the units."""
    B, N, n_real, K, F, E = 3, 8, 6, 2, 16, 4
    gen = torch.Generator().manual_seed(0)
    topi = torch.randint(0, E, (B, N, K), generator=gen)
    valid = torch.arange(N) < n_real
    e_flat = torch.where(valid[:, None], topi, E).reshape(-1)
    order = torch.argsort(e_flat, stable=True)[:B * n_real * K]
    h = torch.randn(B, n_real, K, F)
    for first, total, t, tp in ((0, B, 0, 1), (2, 7, 1, 2)):
        draw = D.Draw(3, 5, (first, B, total))
        pair = (order // (N * K) + first) * (n_real * K) + order % (N * K)
        Fl = F // tp
        rows_h = h[:, :, :, t * Fl:(t + 1) * Fl].reshape(B * n_real * K, Fl)
        local = order // (N * K) * (n_real * K) + order % (N * K)
        got = D.dropout_rows(rows_h[local], 0.5, draw, 1, pair, F, t * Fl)
        want = D.dropout(h[..., t * Fl:(t + 1) * Fl].contiguous(), 0.5, draw, 1,
                         part=(3, t, tp)).reshape(-1, Fl)[local]
        assert torch.equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_is_binomial(rate):
    n = 1 << 20
    kept = int(D.keep_mask((n,), rate, 2024, 0, 0).sum())
    p = 1.0 - rate
    assert abs(kept - n * p) <= 5 * (n * p * rate) ** 0.5, kept


def test_cpu_never_launches_and_other_devices_raise():
    D.reset_launches()
    D.dropout(torch.ones(4, 8), 0.5, D.Draw(1), 0)
    assert D.launches == 0
    with pytest.raises(ValueError, match="no kernel for meta"):
        D._run(1, torch.ones(1, 4, 8, device="meta"), torch.tensor([1]), torch.tensor([0.5]),
               0, 0, [8], 0, None)


def _kernel_row_bases(plan: D.Plan, trials: int, base: int, row_ids=None) -> list[int]:
    """Each row's counter base as the kernel computes it from ``plan``: the
    trial and the leading dims' indices by its magic numbers (// when wide)."""
    def div(n, d, mg):
        q = n // d if plan.wide else D.fast_div(n, *mg)
        return q, n - q * d

    out = []
    for row in range(trials * plan.rows):
        r = div(row, plan.rows, plan.rows_magic)[1] if trials > 1 else row
        if row_ids is not None:
            out.append(base + int(row_ids[row]) * plan.strides[0])
            continue
        rb = base
        for d in range(len(plan.sizes) - 1, 0, -1):
            r, idx = div(r, plan.sizes[d], plan.magic[d])
            rb += idx * plan.strides[d]
        out.append(rb + r * plan.strides[0])
    return out


def _check_plan(mode, esize, lead, strides, base, cols, trials, row_ids, aligned):
    plan = D._plan(mode, esize, tuple(lead), tuple(strides), base, cols, trials,
                   row_ids is not None, aligned)
    for d, mg in zip(plan.sizes + (plan.rows,), plan.magic + (plan.rows_magic,)):
        n = np.concatenate([np.arange(min(4 * d, 4096)), [d - 1, d, d + 1, 2**31 - 1],
                            np.random.default_rng(d).integers(0, 2**31, 256)]).astype(np.uint64)
        q = (((2 * n) * np.uint64(mg[0])) >> np.uint64(32)) >> np.uint64(mg[1])
        np.testing.assert_array_equal(q, n // np.uint64(d))
    rid = None if row_ids is None else row_ids.reshape(-1)
    want = D._row_bases(tuple(lead), list(strides), base, None if row_ids is None
                        else row_ids, "cpu").reshape(-1).tolist()
    if row_ids is None:
        want = want * trials
    got = _kernel_row_bases(plan, trials, base, rid)
    assert got == want
    vec_cols = list(range(plan.nvec * plan.vec))
    for rb in set(got):
        a = rb & 3
        if plan.nvec:
            assert a == 0 and (cols * esize) % 16 == 0 and aligned
        edge = [c for s in plan.slots(a, cols) for c in range(4 * s - a, 4 * s - a + 4)
                if plan.nvec * plan.vec <= c < cols]
        assert sorted(vec_cols + edge) == list(range(cols))
    assert 0 <= plan.log2_group <= 5 and not plan.wide
    return plan


@pytest.mark.parametrize("mode,esize", [(1, 2), (1, 4), (0, 1)], ids=["bf16", "f32", "mask"])
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_launch_plan_divides_and_covers_every_element_once(mode, esize, data):
    """Boxes of any shape (the draws of ``test_any_box_...``) at a counter
    base of any residue, 1 to 3 trials, pointers on 16 bytes or not."""
    ndim = data.draw(st.integers(2, 5))
    full = [data.draw(st.integers(1, 7)) for _ in range(ndim - 1)]
    full.append(data.draw(st.sampled_from([1, 3, 5, 7, 8, 9, 16, 17, 24, 32, 40])))
    box = [data.draw(st.integers(1, n)) for n in full]
    start = [data.draw(st.integers(0, n - b)) for n, b in zip(full, box)]
    strides, _ = D.geometry(tuple(full))
    base = sum(s * t for s, t in zip(start, strides + [1])) + data.draw(st.integers(0, 3)) * 4
    _check_plan(mode, esize, box[:-1], strides, base, box[-1], data.draw(st.integers(1, 3)),
                None, data.draw(st.booleans()))


@pytest.mark.parametrize("stride,base", [(1536, 0), (1536, 768), (37, 2), (8, 3)])
def test_launch_plan_of_sorted_rows(stride, base):
    """The ragged MoE's row-indexed rows (a permutation of an unsplit
    tensor's rows, 2 trials)."""
    rows = torch.randperm(40, generator=torch.Generator().manual_seed(stride))[:23]
    ids = torch.stack([rows, rows.flip(0)])
    plan = _check_plan(1, 2, [23], [stride], base, min(stride, 24), 2, ids, True)
    assert (plan.nvec > 0) == (stride % 4 == 0 and base % 4 == 0)


def test_launch_plan_at_the_models_sites():
    """Every training site (bf16, batch 64) goes by vector chunks, a whole
    unsplit tensor as one dim of rows, 32-bit indices; the 1-D geometry's
    rows and the wide switch."""
    sites = (((64, 1664), 3072, False), ((64, 1664), 768, False), ((88_192,), 1536, True),
             ((64, 768), 384, False), ((64, 12, 1664), 1664, False))
    for lead, cols, by_rows in sites:
        strides, base = ([cols], 0) if by_rows else D.geometry(lead + (cols,))
        plan = D._plan(1, 2, lead, tuple(strides), base, cols, 1, by_rows, True)
        assert plan.nvec * plan.vec == cols and len(plan.sizes) == 1 and not plan.wide
        assert plan.rows == math.prod(lead)
    assert D._plan(1, 4, (2**20, 2**10), (2**10, 1), 0, 1, 4, False, True).wide
    plan = D._plan(1, 2, (3, 4), (40, 8), 16, 8, 1, False, True)   # a rank's unit slice
    assert plan.sizes == (3, 4) and plan.nvec == 1
