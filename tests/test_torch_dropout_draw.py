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
- the keep rate within 5 sigma of the binomial at rates 0.1 and 0.5.
"""

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
