"""Quasi-cyclic LDPC codes: construction, encode, min-sum decode.

Port of ``sdr_tpu/ops/ldpc.py``. H is an (mb × nb) base matrix of Z×Z
blocks, each zero or a cyclic shift of I; the last mb columns are the
block lower-bidiagonal parity part, so H is full-rank and encoding is
forward substitution.

- ``make_qc_ldpc`` draws the information part (column weight 3, seeded
  shifts, redrawn until the lifted graph is 4-cycle-free) with numpy's
  ``default_rng`` in the JAX package's order, so both packages build the
  same ``base`` for every (nb, mb, z, seed).
- ``ldpc_encode`` / ``ldpc_syndrome``: XOR of rotated int8 blocks.
- ``ldpc_decode``: offset min-sum, flooding or layered, dispatched by
  device: plain torch on a CPU tensor, kernel H (``kernels/ldpc.py``) on
  a CUDA tensor, or the call raises. The JAX ``backend=`` argument and
  its lane/sublane routing were TPU layout choices and do not carry over:
  every schedule takes any batch on both devices.

LLR convention: positive = bit 0 (the demapper's).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sdr_tpu_torch.kernels import ldpc as _kh
from sdr_tpu_torch.kernels.ldpc import _rot


@dataclasses.dataclass(frozen=True)
class QcLdpcCode:
    """A lifted QC-LDPC code. ``base`` holds -1 for zero blocks, else the
    cyclic shift; shape (mb, nb) with the LAST mb columns the bidiagonal
    parity part. Hashable (tuples), so tables can be cached per code."""

    base: Tuple[Tuple[int, ...], ...]
    z: int

    @property
    def mb(self) -> int:
        return len(self.base)

    @property
    def nb(self) -> int:
        return len(self.base[0])

    @property
    def kb(self) -> int:
        return self.nb - self.mb

    @property
    def n(self) -> int:
        return self.nb * self.z

    @property
    def k(self) -> int:
        return self.kb * self.z

    @property
    def rate(self) -> float:
        return self.k / self.n

    def row_edges(self, i: int):
        """[(col, shift), ...] for base row i."""
        return [(j, s) for j, s in enumerate(self.base[i]) if s >= 0]


def _has_4cycle(base: np.ndarray, z: int) -> bool:
    """4-cycle in the lifted graph: rows i1 ≠ i2 sharing columns
    j1 ≠ j2 with s(i1,j1)−s(i2,j1) ≡ s(i1,j2)−s(i2,j2) (mod Z)."""
    mb, _ = base.shape
    for i1 in range(mb):
        for i2 in range(i1 + 1, mb):
            both = np.flatnonzero((base[i1] >= 0) & (base[i2] >= 0))
            if len(both) < 2:
                continue
            d = (base[i1, both] - base[i2, both]) % z
            if len(np.unique(d)) < len(d):
                return True
    return False


@functools.lru_cache(maxsize=None)
def make_qc_ldpc(nb: int = 24, mb: int = 12, z: int = 128, seed: int = 0x1D9C) -> QcLdpcCode:
    """Construct a girth-≥6 QC-LDPC code (rate (nb−mb)/nb): information
    columns of weight 3 (rows without replacement, shifts uniform in
    [0, Z)), shift-0 bidiagonal parity; shifts redrawn until the lifted
    graph is 4-cycle-free."""
    if mb < 2 or nb <= mb:
        raise ValueError(f"need nb > mb >= 2, got nb={nb} mb={mb}")
    kb = nb - mb
    rng = np.random.default_rng(seed)
    for _attempt in range(200):
        base = np.full((mb, nb), -1, np.int64)
        for j in range(kb):
            rows = rng.choice(mb, size=min(3, mb), replace=False)
            base[rows, j] = rng.integers(0, z, size=len(rows))
        for c in range(mb):
            base[c, kb + c] = 0
            if c + 1 < mb:
                base[c + 1, kb + c] = 0
        if not _has_4cycle(base, z):
            return QcLdpcCode(tuple(tuple(int(x) for x in r) for r in base), z)
    raise RuntimeError(f"no 4-cycle-free lifting found for nb={nb} mb={mb} z={z}")


def ldpc_encode(code: QcLdpcCode, info: torch.Tensor) -> torch.Tensor:
    """Systematic encode: (..., k) int8 bits → (..., n) int8 codeword.
    r_i = ⊕_j rot(s_j, shift(i, j)) over the information part, then the
    bidiagonal forward substitution p_i = p_{i-1} ⊕ r_i."""
    z, kb, mb = code.z, code.kb, code.mb
    if info.shape[-1] != code.k:
        raise ValueError(f"info length {info.shape[-1]} != k={code.k}")
    s = info.reshape(info.shape[:-1] + (kb, z)).to(torch.int8)
    p = []
    for i in range(mb):
        acc = torch.zeros(s.shape[:-2] + (z,), dtype=torch.int8, device=info.device)
        for j, sh in code.row_edges(i):
            if j < kb:
                acc = acc ^ _rot(s[..., j, :], sh, z)
        p.append(acc if i == 0 else p[i - 1] ^ acc)
    return torch.cat([s.reshape(s.shape[:-2] + (code.k,))] + p, dim=-1)


def ldpc_syndrome(code: QcLdpcCode, cw: torch.Tensor) -> torch.Tensor:
    """H·c over GF(2): (..., n) → (..., mb·Z) int8; all zero iff valid."""
    z = code.z
    c = cw.reshape(cw.shape[:-1] + (code.nb, z)).to(torch.int8)
    rows = []
    for i in range(code.mb):
        acc = torch.zeros(c.shape[:-2] + (z,), dtype=torch.int8, device=cw.device)
        for j, sh in code.row_edges(i):
            acc = acc ^ _rot(c[..., j, :], sh, z)
        rows.append(acc)
    return torch.cat(rows, dim=-1)


def ldpc_decode(code: QcLdpcCode, llr: torch.Tensor, iters: int = 25, offset: float = 0.5,
                schedule: str = "flooding") -> torch.Tensor:
    """Offset min-sum over (..., n) channel LLRs → (..., n) int8 hard
    bits. ``schedule="layered"`` halves the iteration count for the same
    waterfall (use iters ≈ half the flooding count); flooding decisions
    are the JAX ``ldpc_decode``'s exactly."""
    if llr.shape[-1] != code.n:
        raise ValueError(f"llr length {llr.shape[-1]} != n={code.n}")
    flat = llr.reshape(-1, code.n)
    return _kh.ldpc_decode(code, flat, iters, offset, schedule).reshape(llr.shape)


def ldpc_decode_t(code: QcLdpcCode, llr_t: torch.Tensor, iters: int = 25, offset: float = 0.5,
                  schedule: str = "flooding") -> torch.Tensor:
    """Transposed form: (n, batch) LLRs → (n, batch) hard bits, codewords
    on the minor axis (the JAX ``ldpc_decode_sublane_t``'s layout, the
    coded engine's fused seam)."""
    return _kh.ldpc_decode(code, llr_t, iters, offset, schedule, transposed=True)
