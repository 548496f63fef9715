"""The plain reference of the LDPC-coded link: the code, its encoder, the
bit interleaver and an offset min-sum decoder, in numpy and torch.

The code is the simulator's documented stock family: a QC-LDPC base
matrix of nb × mb blocks of Z × Z, the information columns of weight 3
(rows drawn without replacement, shifts uniform in [0, Z), by numpy's
``default_rng(0x1D9C)``), a shift-0 block-bidiagonal parity part, shifts
redrawn until the lifted graph has no 4-cycle. Check row r of block row
i meets variable (r + s) mod Z of block column j. The interleaver is
numpy's ``default_rng(0x1EAF).permutation`` of the frame, applied as
x[perm]. The decoder is flooding offset min-sum over an explicit edge
list: totals = channel LLR + every check message, check messages the
sign product times max(second-or-first minimum − offset, 0).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from linkbench.reference import philox
from linkbench.reference.link import llr_plane

CODE_SEED = 0x1D9C
INTERLEAVER_SEED = 0x1EAF
INFO_LANE = 1


def _has_4cycle(base: np.ndarray, z: int) -> bool:
    mb = base.shape[0]
    for a in range(mb):
        for b in range(a + 1, mb):
            both = np.flatnonzero((base[a] >= 0) & (base[b] >= 0))
            if len(both) >= 2:
                d = (base[a, both] - base[b, both]) % z
                if len(np.unique(d)) < len(d):
                    return True
    return False


@functools.lru_cache(maxsize=None)
def base_matrix(nb: int, mb: int, z: int, seed: int = CODE_SEED) -> np.ndarray:
    """(mb, nb) int64: −1 for a zero block, else the cyclic shift."""
    kb = nb - mb
    rng = np.random.default_rng(seed)
    for _ in range(200):
        base = np.full((mb, nb), -1, np.int64)
        for j in range(kb):
            rows = rng.choice(mb, size=min(3, mb), replace=False)
            base[rows, j] = rng.integers(0, z, size=len(rows))
        for c in range(mb):
            base[c, kb + c] = 0
            if c + 1 < mb:
                base[c + 1, kb + c] = 0
        if not _has_4cycle(base, z):
            return base
    raise RuntimeError("no 4-cycle-free lifting")


@functools.lru_cache(maxsize=None)
def lifted_rows(nb: int, mb: int, z: int):
    """(var (R, dmax) int64, valid (R, dmax) bool): each lifted check's variables."""
    base = base_matrix(nb, mb, z)
    deg = int((base >= 0).sum(axis=1).max())
    var = np.zeros((mb * z, deg), np.int64)
    valid = np.zeros((mb * z, deg), bool)
    r = np.arange(z)
    for i in range(mb):
        cols = [(j, s) for j, s in enumerate(base[i]) if s >= 0]
        for d, (j, s) in enumerate(cols):
            var[i * z:(i + 1) * z, d] = j * z + (r + s) % z
            valid[i * z:(i + 1) * z, d] = True
    return var, valid


def encode(info: torch.Tensor, nb: int, mb: int, z: int) -> torch.Tensor:
    """(..., k) int64 bits → (..., n) codeword: info, then p_i = p_(i−1) ⊕ r_i
    with r_i the XOR of row i's rotated information blocks."""
    base = base_matrix(nb, mb, z)
    kb = nb - mb
    blocks = info.reshape(info.shape[:-1] + (kb, z))
    idx = torch.arange(z, device=info.device)
    parity, prev = [], None
    for i in range(mb):
        acc = torch.zeros(info.shape[:-1] + (z,), dtype=info.dtype, device=info.device)
        for j in range(kb):
            s = int(base[i, j])
            if s >= 0:
                acc = acc ^ blocks[..., j, (idx + s) % z]
        prev = acc if prev is None else prev ^ acc
        parity.append(prev)
    return torch.cat([info] + parity, dim=-1)


@functools.lru_cache(maxsize=None)
def permutation(n: int, seed: int = INTERLEAVER_SEED) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


def decode(llr: torch.Tensor, nb: int, mb: int, z: int, iters: int,
           offset: float = 0.5) -> torch.Tensor:
    """Flooding offset min-sum: (C, n) float32 LLRs → (C, n) hard bits (1 where < 0)."""
    var_np, valid_np = lifted_rows(nb, mb, z)
    dev = llr.device
    var = torch.as_tensor(var_np, device=dev)
    valid = torch.as_tensor(valid_np, device=dev)
    flat_var = var[valid]
    big = torch.tensor(3.0e38, device=dev)
    c2v = torch.zeros((llr.shape[0],) + tuple(var.shape), dtype=torch.float32, device=dev)
    for _ in range(iters):
        total = llr.index_add(1, flat_var, c2v[:, valid])
        v2c = total[:, var] - c2v
        mag = torch.where(valid, v2c.abs(), big)
        neg = (v2c < 0) & valid
        sign = 1.0 - 2.0 * (neg.sum(dim=-1, keepdim=True) % 2).to(torch.float32)
        two = torch.topk(mag, 2, dim=-1, largest=False).values
        excl = torch.where(mag == two[..., :1], two[..., 1:], two[..., :1])
        own = torch.where(neg, -1.0, 1.0)
        c2v = torch.where(valid, sign * own * (excl - offset).clamp_min(0.0), 0.0)
    total = llr.index_add(1, flat_var, c2v[:, valid])
    return (total < 0).to(torch.int64)


def info_bits(seed: int, ch_ids: torch.Tensor, n_cw: int, k: int) -> torch.Tensor:
    """(B, n_cw, k) int64: bit t of word w of counter (ch, cw, i, 1) on
    ROLE_PAYLOAD is bit i·128 + w·32 + t of codeword cw."""
    dev = ch_ids.device
    n_blk = -(-k // 128)
    w = torch.stack(philox.words(seed, philox.ROLE_PAYLOAD, ch_ids, torch.arange(n_cw, device=dev),
                                 torch.arange(n_blk, device=dev), INFO_LANE), dim=-1)
    bits = (w[..., None] >> torch.arange(32, device=dev)) & 1
    return bits.reshape(ch_ids.shape[0], n_cw, n_blk * 128)[:, :, :k]


def coded_errors(cfg: dict, channel: dict, code: dict, seed: int, ch_ids: torch.Tensor,
                 precision: str = "float32") -> torch.Tensor:
    """Per-channel information-bit errors (B,) int64 of one coded call:
    info bits → encode → zero-pad to the frame → interleave → symbol
    indices (MSB first) → the link → LLRs → deinterleave → decode."""
    nb, mb, z, iters = code["nb"], code["mb"], code["z"], code["iters"]
    n, k = nb * z, (nb - mb) * z
    bps = cfg["bits_per_symbol"]
    S, N = cfg["n_symbols"], cfg["n_fft"]
    frame = S * N * bps
    n_cw = frame // n
    B = ch_ids.shape[0]
    info = info_bits(seed, ch_ids, n_cw, k)
    bits = torch.zeros((B, frame), dtype=torch.int64, device=ch_ids.device)
    bits[:, :n_cw * n] = encode(info, nb, mb, z).reshape(B, n_cw * n)
    perm = torch.as_tensor(permutation(frame), device=ch_ids.device)
    sent = bits[:, perm].reshape(B, S * N, bps)
    idx = (sent * (1 << torch.arange(bps - 1, -1, -1, device=ch_ids.device))).sum(-1)
    llr = llr_plane(cfg, channel, seed, ch_ids, idx.reshape(B, S, N), precision)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(frame, device=perm.device)
    coded = llr[:, inv[:n_cw * n]].reshape(B * n_cw, n)
    decided = decode(coded, nb, mb, z, iters).reshape(B, n_cw, n)[:, :, :k]
    return (decided != info).sum(dim=(1, 2))
