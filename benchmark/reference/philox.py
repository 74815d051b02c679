"""Keep masks of counter-based dropout, plainly: Philox4x32-10 (Salmon et al.,
SC'11, the generator of cuRAND) keyed by the 64-bit dropout seed (low word
first), counter (q low, q high, block, site) with q = g >> 2 for an
element's flat index g in the unsplit tensor, which takes word g & 3; an
element is kept iff that word is below floor(keep · 2^32), keep = 1 - rate
in f32, and a kept x becomes x / keep computed in f32.

The words are computed in int64 tensors: a 32 x 32-bit product is exact
below 2^63 in its low word after masking, and its high word is taken from
the product shifted right, where the wrap above 2^63 of a signed product
leaves the bit pattern of the unsigned one.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a · m for a < 2^32 (int64 tensors)."""
    lo_a, hi_a = a & 0xFFFF, a >> 16
    p_lo = lo_a * m                       # < 2^48
    p_hi = hi_a * m                       # < 2^48
    low = (p_lo + ((p_hi & 0xFFFF) << 16)) & MASK
    high = ((p_hi + (p_lo >> 16)) >> 16) & MASK
    return high, low


def philox(q: torch.Tensor, block: int, site: int, seed: int) -> list[torch.Tensor]:
    """The four words of Philox4x32-10 at counters (q low, q high, block,
    site) under ``seed``."""
    c0, c1 = q & MASK, (q >> 32) & MASK
    c2 = torch.full_like(q, block & MASK)
    c3 = torch.full_like(q, site & MASK)
    k0, k1 = seed & MASK, (seed >> 32) & MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def _threshold(rate: float) -> int:
    return int(float(torch.tensor(1.0 - rate, dtype=torch.float32)) * 2.0**32)


def keep_mask(g: torch.Tensor, rate: float, block: int, site: int, seed: int) -> torch.Tensor:
    """Keep bits of the elements at flat indices ``g`` (int64)."""
    words = philox(g >> 2, block, site, seed)
    pick = g & 3
    w = torch.where(pick == 0, words[0], torch.where(
        pick == 1, words[1], torch.where(pick == 2, words[2], words[3])))
    return w < _threshold(rate)


def keep_range(start: int, count: int, rate: float, block: int, site: int, seed: int,
               device) -> torch.Tensor:
    """Keep bits of the ``count`` elements at flat indices start, start + 1,
    ...; both multiples of 4, so each counter's four words serve four
    elements in order."""
    if start % 4 or count % 4:
        raise ValueError(f"keep_range takes whole counters: start {start}, count {count}")
    q = start // 4 + torch.arange(count // 4, device=device)
    return torch.stack(philox(q, block, site, seed), -1).reshape(-1) < _threshold(rate)


def keep_value(rate: float) -> float:
    """1 - rate in f32, the divisor of a kept element."""
    return torch.tensor(1.0 - rate, dtype=torch.float32).item()
