"""Polar codes: construction, butterfly encoder, SC and CA-SCL decoders
(port of ``sdr_tpu/ops/polar.py``).

- Constructions (Bhattacharyya ``polar_construct``, Gaussian
  approximation ``polar_construct_ga``), the CRC matrices and
  ``PolarCode`` are the JAX module's numpy code, copied: they build the
  same tables.
- The encoder is the n-stage butterfly x = u·F^{⊗n} (F = [[1,0],[1,1]],
  natural bit order), log2(N) XOR stages batched over codewords.
- ``polar_decode_sc`` and ``polar_decode_scl`` are the bit-serial
  oracles: Python loops over the N leaf bits with the static per-bit
  tables (how far to climb with a g update, how many f descents follow,
  how many partial-sum merges close), on per-depth planes with the list
  (SCL) as an axis behind the codewords.
- ``polar_decode_scl_fast`` is the throughput decoder the coded link
  runs: the code tree's recursion pruned at rate-0 nodes (the exact
  all-frozen metric in log2(W) parallel steps, ``_rate0_penalty``) and
  rate-1 nodes (τ = min(L−1, W) sorted forks, ``_rate1_node``), every
  mixed node split in two.

What the port changes, with the same values and decisions:

- survivors are selected by index gathers (the JAX decoders' one-hot
  matmuls ``_selmm`` worked round slow TPU gathers; they select exactly,
  so a gather gives the same values), and a selection composes as an
  index of indices;
- every ``lax.top_k`` is a stable ascending sort that keeps the first
  ones: ``top_k(-x, k)`` returns the k smallest x with the lower index
  first among equal values, which is what a stable sort of x keeps. Ties
  are the normal case, not a corner: inactive list slots carry BIG =
  1e30, and 1e30 plus a penalty rounds back to 1e30;
- every argmin takes the first index (torch's rule, as ``jnp.argmin``);
- the CRC syndrome is an f32 matmul of 0/1 values (exact: counts ≤ k <
  2^24) mod 2.

The decoders are plain torch on every device (the JAX ones are XLA
outside any kernel). Min-sum f/g updates in float32; path-metric
penalties |LLR| on the decision that disagrees with the LLR's sign. LLR
convention: positive ⇒ bit 0.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

BIG = 1e30  # the metric of an inactive list slot
CRC_PENALTY = 1e15  # added to a path whose CRC fails


def _require_pow2(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"polar block length must be a power of 2, got {n}")
    return int(n).bit_length() - 1


@functools.lru_cache(maxsize=None)
def polar_construct(block_len: int, k: int, design_z: float = 0.5):
    """Info-bit positions for a (block_len, k) polar code by the
    Bhattacharyya recursion from z = design_z (worse child 2z − z², better
    z², interleaved): the k positions with the smallest final z carry
    information. Returns (info_idx, frozen mask) as numpy."""
    n = _require_pow2(block_len)
    if not 1 <= k <= block_len:
        raise ValueError(f"k must be in [1, {block_len}], got {k}")
    z = np.array([design_z], dtype=np.float64)
    for _ in range(n):
        nz = np.empty(2 * z.size, np.float64)
        # W_{2N}^{(2j)} = worse(W_N^{(j)}), W_{2N}^{(2j+1)} = better(W_N^{(j)}).
        nz[0::2] = 2.0 * z - z * z
        nz[1::2] = z * z
        z = nz
    order = np.argsort(z, kind="stable")
    info_idx = np.sort(order[:k]).astype(np.int32)
    frozen = np.ones(block_len, dtype=bool)
    frozen[info_idx] = False
    return info_idx, frozen


def polar_encode(u: torch.Tensor) -> torch.Tensor:
    """x = u · F^{⊗n} over GF(2), natural order. u: int8 (..., N)."""
    N = u.shape[-1]
    n = _require_pow2(N)
    x = u
    for s in range(n):
        step = 1 << s
        xb = x.reshape(x.shape[:-1] + (N // (2 * step), 2, step))
        top = torch.bitwise_xor(xb[..., 0, :], xb[..., 1, :])
        x = torch.stack([top, xb[..., 1, :]], dim=-2).reshape(u.shape)
    return x


def polar_encode_info(info: torch.Tensor, block_len: int) -> torch.Tensor:
    """Info bits (..., k) → codeword (..., block_len) with frozen 0s
    (the Bhattacharyya construction)."""
    k = info.shape[-1]
    info_idx, _ = polar_construct(block_len, k)
    u = torch.zeros(info.shape[:-1] + (block_len,), dtype=torch.int8, device=info.device)
    u[..., torch.as_tensor(info_idx, dtype=torch.int64, device=info.device)] = info.to(torch.int8)
    return polar_encode(u)


def _f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check-node (left-child) update: sgn(a)sgn(b)·min(|a|,|b|)."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(torch.abs(a), torch.abs(b))


def _g(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Variable-node (right-child) update: b + (1−2s)·a, s the left
    subtree's partial sum."""
    return b + (1.0 - 2.0 * s.to(torch.float32)) * a


@functools.lru_cache(maxsize=None)
def _sc_tables(block_len: int):
    """Static per-bit tables: trailing zeros (g depth) and trailing ones
    (partial-sum merges) of each leaf index."""
    idx = np.arange(block_len)
    tz = np.zeros(block_len, np.int32)
    to = np.zeros(block_len, np.int32)
    for i in range(1, block_len):
        v = i
        while v % 2 == 0:
            tz[i] += 1
            v //= 2
        v = i
        while v % 2 == 1:
            to[i] += 1
            v //= 2
    return idx, tz, to


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def polar_decode_sc(llr: torch.Tensor, block_len: int, k: int) -> torch.Tensor:
    """Successive-cancellation decode. llr: float32 (..., block_len)
    channel LLRs (positive ⇒ bit 0). Returns the decoded INFO bits int8
    (..., k) (the Bhattacharyya construction)."""
    if llr.shape[-1] != block_len:
        raise ValueError(f"llr last axis {llr.shape[-1]} != block_len {block_len}")
    n = _require_pow2(block_len)
    info_idx, frozen = polar_construct(block_len, k)
    N = block_len
    batch = llr.shape[:-1]
    flat = llr.reshape(-1, N).to(torch.float32)
    dev = flat.device
    Bc = flat.shape[0]
    _, tz_tab, to_tab = _sc_tables(N)
    # Ls[d]: the current path's LLRs at depth d, (Bc, N >> d); Bs[d]: the
    # partial sums of depth d's nodes at their natural positions (Bc, N).
    Ls = [flat] + [None] * n
    Bs = [torch.zeros((Bc, N), dtype=torch.int8, device=dev) for _ in range(n + 1)]
    u = torch.zeros((Bc, N), dtype=torch.int8, device=dev)

    def f_descend(d_from):
        for d in range(d_from, n + 1):
            w = N >> d
            Ls[d] = _f_minsum(Ls[d - 1][:, :w], Ls[d - 1][:, w:2 * w])

    for i in range(N):
        if i == 0:
            f_descend(1)
        else:
            # The path from bit i-1 to bit i turns right at depth a = n − t
            # (one g against the left sibling's sums), then f-descends.
            a = n - min(int(tz_tab[i]), n)
            w = N >> a
            j = i >> (n - a)
            left = Bs[a][:, (j - 1) * w:j * w]
            Ls[a] = _g(Ls[a - 1][:, :w], Ls[a - 1][:, w:2 * w], left)
            f_descend(a + 1)
        dec = torch.zeros((Bc,), dtype=torch.int8, device=dev) if frozen[i] else (
            Ls[n][:, 0] < 0).to(torch.int8)
        u[:, i] = dec
        Bs[n][:, i] = dec
        _merge(Bs, i, int(to_tab[i]), n, N)
    info = u[:, _index(info_idx, dev)]
    return info.reshape(batch + (k,))


def _merge(Bs, i: int, t: int, n: int, N: int) -> None:
    """Bit i closes t right children: merge each with its stored left
    sibling into the parent's slot, parent = [left ⊕ right, right]."""
    for d in range(n, n - t, -1):
        w = N >> d
        j = i >> (n - d)  # odd
        start = (j - 1) * w
        pair = Bs[d][..., start:start + 2 * w]
        Bs[d - 1][..., start:start + w] = torch.bitwise_xor(pair[..., :w], pair[..., w:])
        Bs[d - 1][..., start + w:start + 2 * w] = pair[..., w:]


# ---------------------------------------------------------------------------
# Gaussian-approximation construction (BPSK-AWGN density evolution).

# phi() underflows to exactly 0.0 past ~3000 (exp(-m/4) leaves float64
# range); clamping keeps phi_inv's bracket well-conditioned.
_GA_M_MAX = 2800.0


def _ga_phi(m: float) -> float:
    """Chung et al.'s approximation of phi(m): decreasing, phi(0)=1,
    phi(inf)=0."""
    if m <= 1e-12:
        return 1.0
    if m < 10.0:
        return math.exp(-0.4527 * m**0.86 + 0.0218)
    return math.sqrt(math.pi / m) * math.exp(-m / 4.0) * (1.0 - 10.0 / (7.0 * m))


def _ga_phi_inv(y: float) -> float:
    """Inverse of _ga_phi on [0, _GA_M_MAX] by bisection."""
    if y >= 1.0:
        return 0.0
    lo, hi = 0.0, _GA_M_MAX
    if _ga_phi(hi) >= y:
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _ga_phi(mid) > y:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@functools.lru_cache(maxsize=None)
def polar_construct_ga(block_len: int, k: int, design_snr_db: float = 2.0):
    """Info-bit positions via the Gaussian approximation: density-evolve
    the mean LLR from m0 = 4·Es/N0 (worse child phi_inv(1 − (1 −
    phi(m))²), better 2m, interleaved); the k positions with the largest
    final mean carry information. design_snr_db is Es/N0 per coded bit."""
    n = _require_pow2(block_len)
    if not 1 <= k <= block_len:
        raise ValueError(f"k must be in [1, {block_len}], got {k}")
    m0 = 4.0 * 10.0 ** (design_snr_db / 10.0)
    m = np.array([min(m0, _GA_M_MAX)], dtype=np.float64)
    for _ in range(n):
        nm = np.empty(2 * m.size, np.float64)
        nm[0::2] = [_ga_phi_inv(1.0 - (1.0 - _ga_phi(x)) ** 2) for x in m]
        nm[1::2] = np.minimum(2.0 * m, _GA_M_MAX)
        m = nm
    order = np.argsort(-m, kind="stable")
    info_idx = np.sort(order[:k]).astype(np.int32)
    frozen = np.ones(block_len, dtype=bool)
    frozen[info_idx] = False
    return info_idx, frozen


# ---------------------------------------------------------------------------
# CRC as GF(2) linear algebra.

#: CRC polynomials by name: (degree, coefficient bits below the top
#: term, MSB first). crc11 is 5G NR's g(x)=x^11+x^10+x^9+x^5+1.
_CRC_POLYS = {
    "crc8": (8, 0x9B),
    "crc11": (11, 0x621),
    "crc16": (16, 0x1021),
}


def _crc_lfsr_matrix(msg_len: int, crc_name: str) -> np.ndarray:
    """(msg_len, c) GF(2) matrix M with CRC(msg) = msg @ M (mod 2), by
    running the MSB-first LFSR over each basis vector."""
    c, low = _CRC_POLYS[crc_name]
    taps = np.array([(low >> (c - 1 - j)) & 1 for j in range(c)], np.int8)
    M = np.zeros((msg_len, c), np.int8)
    for i in range(msg_len):
        reg = np.zeros(c, np.int8)
        for pos in range(msg_len):
            b = 1 if pos == i else 0
            fb = reg[0] ^ b
            reg = np.concatenate([reg[1:], np.zeros(1, np.int8)])
            if fb:
                reg ^= taps
        M[i] = reg
    return M


@functools.lru_cache(maxsize=None)
def crc_matrices(payload_len: int, crc_name: str):
    """(gen, chk): gen (payload_len, c) with crc = payload @ gen; chk
    (payload_len + c, c) with syndrome = (payload‖crc) @ chk == 0 iff
    the CRC is consistent."""
    c, _ = _CRC_POLYS[crc_name]
    gen = _crc_lfsr_matrix(payload_len, crc_name)
    chk = _crc_lfsr_matrix(payload_len + c, crc_name)
    return gen, chk


@functools.lru_cache(maxsize=None)
def _crc_tensor(payload_len: int, crc_name: str, which: int, device: str) -> torch.Tensor:
    return torch.as_tensor(crc_matrices(payload_len, crc_name)[which], dtype=torch.float32,
                           device=device)


def _mod2_matmul(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(bits @ m) mod 2 of 0/1 operands as f32 (exact: counts < 2^24)."""
    return torch.remainder(torch.matmul(bits.to(torch.float32), m), 2.0)


# ---------------------------------------------------------------------------
# PolarCode: the static descriptor the encoder/decoder pair shares.


@dataclasses.dataclass(frozen=True)
class PolarCode:
    """Static polar code descriptor: block_len = N, k = info POSITIONS
    (payload + CRC bits), crc: a name of ``_CRC_POLYS`` or None;
    payload_len = k − crc_len is what users send and count."""

    block_len: int
    k: int
    crc: str | None
    info_idx: np.ndarray = dataclasses.field(compare=False)
    frozen: np.ndarray = dataclasses.field(compare=False)

    @property
    def crc_len(self) -> int:
        return _CRC_POLYS[self.crc][0] if self.crc else 0

    @property
    def payload_len(self) -> int:
        return self.k - self.crc_len

    @property
    def rate(self) -> float:
        return self.payload_len / self.block_len


@functools.lru_cache(maxsize=None)
def make_polar_code(block_len: int, k: int, crc: str | None = "crc11",
                    design_snr_db: float = 2.0, construction: str = "ga") -> PolarCode:
    """The production code: GA construction by default, CRC-11 inside the
    k info positions (payload = k − 11 bits)."""
    if crc is not None and crc not in _CRC_POLYS:
        raise ValueError(f"crc must be one of {sorted(_CRC_POLYS)} or None")
    c = _CRC_POLYS[crc][0] if crc else 0
    if k - c < 1:
        raise ValueError(f"k={k} leaves no payload after a {c}-bit CRC")
    if construction == "ga":
        info_idx, frozen = polar_construct_ga(block_len, k, design_snr_db)
    elif construction == "bhattacharyya":
        info_idx, frozen = polar_construct(block_len, k)
    else:
        raise ValueError("construction must be 'ga' or 'bhattacharyya'")
    return PolarCode(block_len, k, crc, info_idx, frozen)


def polar_encode_payload(payload: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """Payload bits (..., payload_len) → codeword (..., N): append the CRC
    (GF(2) matmul), scatter into the info positions, butterfly."""
    if payload.shape[-1] != code.payload_len:
        raise ValueError(f"payload last axis {payload.shape[-1]} != {code.payload_len}")
    dev = payload.device
    info = payload.to(torch.int8)
    if code.crc_len:
        crc = _mod2_matmul(payload, _crc_tensor(code.payload_len, code.crc, 0, str(dev)))
        info = torch.cat([info, crc.to(torch.int8)], dim=-1)
    u = torch.zeros(payload.shape[:-1] + (code.block_len,), dtype=torch.int8, device=dev)
    u[..., _index(code.info_idx, dev)] = info
    return polar_encode(u)


# ---------------------------------------------------------------------------
# List decoding: survivors by index, ties by position.


def _smallest(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries of x's last axis in
    ascending order, the lower index first among equal values (what
    ``lax.top_k(-x, k)`` returns, negated)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _select(arr: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """arr (Bc, Lw, ...) with its list axis gathered by perm (Bc, Lw):
    new path l is old path perm[:, l]."""
    if arr.ndim == 2:
        return torch.gather(arr, 1, perm)
    idx = perm.view(perm.shape + (1,) * (arr.ndim - 2)).expand(perm.shape + arr.shape[2:])
    return torch.gather(arr, 1, idx)


def _sel(arr: torch.Tensor, perm) -> torch.Tensor:
    """``_select`` for an optional perm; a list-invariant plane (list axis
    1) has every path's values already."""
    if perm is None or arr.shape[1] == 1:
        return arr
    return _select(arr, perm)


def _compose(p1, p2):
    """The selection p1 then p2, as one index: p1[p2]."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    return torch.gather(p1, 1, p2)


def _rate0_penalty(alpha: torch.Tensor) -> torch.Tensor:
    """The path-metric increment of an all-frozen subtree in log2(W)
    parallel steps: with every decision 0 its leaf LLRs are an f/g
    cascade of the node LLRs (each level maps every segment a‖b to
    (minsum(a, b), a + b)), and the penalty Σ_leaf max(−λ_leaf, 0) is
    order-invariant. alpha (Bc, Lw, W) → (Bc, Lw) float32, the bitwise
    decoder's sum up to float32 rounding of its order. The W terms are
    summed as a halving tree of elementwise adds, so the result does not
    depend on the device's reduction order (the card and the CPU give the
    same floats)."""
    x = alpha.unsqueeze(-2)  # (Bc, Lw, segments, seg_width)
    while x.shape[-1] > 1:
        w = x.shape[-1] // 2
        a = x[..., :w]
        b = x[..., w:]
        x = torch.cat([_f_minsum(a, b), a + b], dim=-2)
    t = torch.clamp(-x.reshape(alpha.shape[0], alpha.shape[1], -1), min=0.0)
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _rate1_node(alpha: torch.Tensor, pm: torch.Tensor, Lw: int):
    """SCL of an all-information node (fast-SSCL, Hashemi et al.):
    hard-decide every bit, then fork in turn on the τ = min(L−1, W)
    least-reliable positions of each path — the same L survivors and
    metrics as forking bit by bit through the subtree. Returns (beta
    (Bc, Lw, W) int8 node codeword, pm, perm or None)."""
    Bc, _, W = alpha.shape
    alpha = alpha.expand(Bc, Lw, W)
    absl = torch.abs(alpha)
    dec0 = (alpha < 0.0).to(torch.int8)
    tau = min(Lw - 1, W)
    if tau == 0:
        return dec0, pm, None
    pen, order = _smallest(absl, tau)  # (Bc, Lw, τ) each
    perm = None
    flips = torch.zeros((Bc, Lw, tau), dtype=torch.int8, device=alpha.device)
    for t in range(tau):
        cat = torch.cat([pm, pm + pen[:, :, t]], dim=1)
        pm, idx = _smallest(cat, Lw)
        parent = torch.remainder(idx, Lw)
        order = _select(order, parent)
        pen = _select(pen, parent)
        flips = _select(flips, parent)
        flips[:, :, t] = (idx >= Lw).to(torch.int8)
        perm = _compose(perm, parent)
    dec = _select(dec0, perm)
    # Flip positions are distinct per path (order rows are distinct
    # indices): XOR each path's flips into its decisions.
    dec.scatter_(2, order, torch.gather(dec, 2, order) ^ flips)
    return dec, pm, perm


def _fast_node(fz: np.ndarray, alpha: torch.Tensor, pm: torch.Tensor, Lw: int):
    """→ (beta, u, pm, perm); beta/u (Bc, Lw, W) int8. alpha may be
    list-invariant (list axis 1)."""
    Bc, _, W = alpha.shape
    if not fz.any():  # rate-1
        beta, pm, perm = _rate1_node(alpha, pm, Lw)
        u = beta if W == 1 else polar_encode(beta)  # F^{⊗} is an involution
        return beta, u, pm, perm
    if fz.all():  # rate-0
        pm = pm + _rate0_penalty(alpha)
        z = torch.zeros((Bc, Lw, W), dtype=torch.int8, device=alpha.device)
        return z, z, pm, None
    if W == 1:
        raise AssertionError("unreachable: width-1 node is pure")
    w2 = W // 2
    al = _f_minsum(alpha[..., :w2], alpha[..., w2:])
    bl, ul, pm, s1 = _fast_node(fz[:w2], al, pm, Lw)
    a_in = _sel(alpha, s1)
    ar = _g(a_in[..., :w2], a_in[..., w2:], bl)
    br, ur, pm, s2 = _fast_node(fz[w2:], ar, pm, Lw)
    bl = _sel(bl, s2)
    ul = _sel(ul, s2)
    beta = torch.cat([torch.bitwise_xor(bl, br), br], dim=-1)
    u = torch.cat([ul, ur], dim=-1)
    return beta, u, pm, _compose(s1, s2)


def _initial_metrics(Bc: int, Lw: int, device) -> torch.Tensor:
    """Only path 0 is live at the start; the first fork grows the list."""
    pm = torch.full((Bc, Lw), BIG, dtype=torch.float32, device=device)
    pm[:, 0] = 0.0
    return pm


def _crc_select(u: torch.Tensor, pm: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """The lowest-metric path whose CRC checks (the lowest-metric path if
    none does; the first index among equal metrics) → its payload."""
    dev = u.device
    info = u[:, :, _index(code.info_idx, dev)]  # (Bc, Lw, k)
    if code.crc_len:
        syn = _mod2_matmul(info, _crc_tensor(code.payload_len, code.crc, 1, str(dev)))
        ok = torch.all(syn == 0.0, dim=-1)
        sel = pm + torch.where(ok, torch.zeros((), device=dev),
                               torch.full((), CRC_PENALTY, device=dev))
    else:
        sel = pm
    best = torch.argmin(sel, dim=1)
    return info[torch.arange(info.shape[0], device=dev), best, :code.payload_len]


def _list_size(list_size: int) -> int:
    if list_size < 1:
        raise ValueError(f"list_size must be >= 1, got {list_size}")
    return int(list_size)


def polar_decode_scl_fast(llr: torch.Tensor, code: PolarCode, list_size: int = 8) -> torch.Tensor:
    """Fast-SSCL CRC-aided list decode — the throughput polar decoder.

    Same contract and decisions as ``polar_decode_scl``; the bit-serial
    loop is replaced by the code tree's recursion pruned at rate-0 and
    rate-1 nodes (module docstring). llr (..., N) → payload (...,
    payload_len) int8."""
    N = code.block_len
    if llr.shape[-1] != N:
        raise ValueError(f"llr last axis {llr.shape[-1]} != block_len {N}")
    Lw = _list_size(list_size)
    _require_pow2(N)
    batch = llr.shape[:-1]
    flat = llr.reshape(-1, N).to(torch.float32)
    pm = _initial_metrics(flat.shape[0], Lw, flat.device)
    _, u, pm, _ = _fast_node(np.asarray(code.frozen, bool), flat.unsqueeze(1), pm, Lw)
    return _crc_select(u, pm, code).reshape(batch + (code.payload_len,))


def polar_decode_scl(llr: torch.Tensor, code: PolarCode, list_size: int = 8) -> torch.Tensor:
    """CRC-aided successive-cancellation LIST decode (the bit-serial
    oracle).

    llr: float32 (..., N) channel LLRs (positive ⇒ bit 0). Returns the
    decoded PAYLOAD bits int8 (..., payload_len): the lowest-metric path
    whose CRC checks, else the lowest-metric path (plain SCL when
    code.crc is None; plain SC at list_size=1). Each bit forks every path
    into stay/flip with penalty |leaf LLR| on the decision that disagrees
    with the LLR's sign (a frozen bit's flip adds BIG), and the list_size
    smallest of the 2·list_size candidates survive."""
    N = code.block_len
    if llr.shape[-1] != N:
        raise ValueError(f"llr last axis {llr.shape[-1]} != block_len {N}")
    Lw = _list_size(list_size)
    n = _require_pow2(N)
    _, tz_tab, to_tab = _sc_tables(N)
    frozen = np.asarray(code.frozen, bool)
    batch = llr.shape[:-1]
    flat = llr.reshape(-1, N).to(torch.float32)
    dev = flat.device
    Bc = flat.shape[0]
    # Ls[d]: (Bc, Lw, N >> d) (depth 0, the channel LLRs, list-invariant);
    # Bs[d]: (Bc, Lw, N), node j of depth d owns [j·w, (j+1)·w).
    Ls = [flat.unsqueeze(1)] + [None] * n
    Bs = [torch.zeros((Bc, Lw, N), dtype=torch.int8, device=dev) for _ in range(n + 1)]
    u = torch.zeros((Bc, Lw, N), dtype=torch.int8, device=dev)
    pm = _initial_metrics(Bc, Lw, dev)

    def f_descend(d_from):
        for d in range(d_from, n + 1):
            w = N >> d
            Ls[d] = _f_minsum(Ls[d - 1][..., :w], Ls[d - 1][..., w:2 * w])

    for i in range(N):
        if i == 0:
            f_descend(1)
        else:
            a = n - min(int(tz_tab[i]), n)
            w = N >> a
            j = i >> (n - a)
            left = Bs[a][..., (j - 1) * w:j * w]
            Ls[a] = _g(Ls[a - 1][..., :w], Ls[a - 1][..., w:2 * w], left)
            f_descend(a + 1)
        leaf = Ls[n][..., 0]
        c0 = pm + torch.clamp(-leaf, min=0.0)
        c1 = pm + torch.clamp(leaf, min=0.0)
        c1 = c1 + (BIG if frozen[i] else 0.0)
        pm, idx = _smallest(torch.cat([c0, c1], dim=1), Lw)
        parent = torch.remainder(idx, Lw)
        dec = (idx >= Lw).to(torch.int8)
        for d in range(1, n + 1):
            Ls[d] = _sel(Ls[d], parent)
        Bs = [_select(b, parent) for b in Bs]
        u = _select(u, parent)
        u[:, :, i] = dec
        Bs[n][:, :, i] = dec
        _merge(Bs, i, int(to_tab[i]), n, N)
    return _crc_select(u, pm, code).reshape(batch + (code.payload_len,))


__all__ = [
    "PolarCode", "make_polar_code", "polar_construct", "polar_construct_ga", "crc_matrices",
    "polar_encode", "polar_encode_info", "polar_encode_payload", "polar_decode_sc",
    "polar_decode_scl", "polar_decode_scl_fast",
]
