"""Philox-4x32-10 and the keyed draws of the link, in plain torch.

A frozen copy of the published key schedule the simulator documents
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11):
every draw is a pure function of (seed, role, channel id, row, column,
lane). key = seed ^ role as a 64-bit word, counter = (channel, row,
column, lane). Words are int64 tensors holding uint32 values; every
product is split into 16-bit halves so that nothing overflows.
"""

from __future__ import annotations

import math

import torch

ROLE_PAYLOAD = 0x0B175
ROLE_NOISE = 0x4015E
ROLE_FADING = 0xFAD1E

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
TWO_PI_F32 = 6.2831855  # float32(2π)


def split_key(seed: int, role: int) -> tuple[int, int]:
    s = (int(seed) ^ int(role)) & 0xFFFFFFFFFFFFFFFF
    return s & MASK32, s >> 32


def _mulhilo(m: int, x: torch.Tensor):
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & MASK32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words of Philox-4x32-10 on broadcast counters."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ ((k0 + r * _W0) & MASK32), lo1,
                          hi0 ^ c3 ^ ((k1 + r * _W1) & MASK32), lo0)
    return c0, c1, c2, c3


def words(seed: int, role: int, ch_ids: torch.Tensor, rows, cols, lane: int = 0):
    """Words for counters (ch_ids[b], rows[i], cols[j], lane): each (B, I, J).
    ``rows`` and ``cols`` are 1-D int64 tensors of counter values."""
    dev = ch_ids.device
    c0 = ch_ids.to(torch.int64).reshape(-1, 1, 1) & MASK32
    c1 = rows.to(torch.int64, copy=False).reshape(1, -1, 1).to(dev)
    c2 = cols.to(torch.int64, copy=False).reshape(1, 1, -1).to(dev)
    c3 = torch.full((1, 1, 1), lane, dtype=torch.int64, device=dev)
    return philox(c0, c1, c2, c3, *split_key(seed, role))


def uniform(w: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in (0, 1]: the top 24 bits plus half an ulp."""
    return (w >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)


def gauss_pair(w0: torch.Tensor, w1: torch.Tensor):
    """Box–Muller on two word planes: two N(0, 1) float32 planes."""
    r = torch.sqrt(-2.0 * torch.log(uniform(w0)))
    t = TWO_PI_F32 * uniform(w1)
    return r * torch.cos(t), r * torch.sin(t)


def complex_gauss(seed: int, role: int, ch_ids: torch.Tensor, n_cols: int, var: float = 1.0):
    """CN(0, var) (B, n_cols) complex64 from counters (ch, 0, col, 0)."""
    dev = ch_ids.device
    w0, w1, _, _ = words(seed, role, ch_ids, torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.arange(n_cols, device=dev))
    g1, g2 = gauss_pair(w0, w1)
    std = math.sqrt(var * 0.5)
    return torch.complex(g1 * std, g2 * std)[:, 0, :]
