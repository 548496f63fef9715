"""Gray-coded QAM constellation mapping — the full roster.

Port of ``sdr_tpu/ops/modulation.py``. Square (BPSK: one-axis) Gray
constellations built from a per-axis binary-reflected-Gray PAM map:

- symbol index = (I Gray index << m) | Q Gray index; per-axis level
  2·gray_to_binary(g) − (L−1), scaled to unit average power (1/√10 for
  16-QAM, the reference library's table);
- bits are MSB first everywhere (bytes, symbols);
- ``nearest_symbol`` slices each axis to the nearest level.

The tables are built host-side in numpy; every function takes tensors
with arbitrary leading batch dims and runs on the tensors' device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.core.config import Modulation


def _gray_to_binary(g: np.ndarray) -> np.ndarray:
    """Inverse Gray code via prefix-XOR."""
    b = g.copy()
    shift = 1
    while (b >> shift).any():
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def _pam_amplitudes(bits_per_axis: int) -> np.ndarray:
    """amplitude[gray_index] for a 2^m-level reflected-Gray PAM axis
    (odd integers −(L−1) … +(L−1))."""
    L = 1 << bits_per_axis
    i = _gray_to_binary(np.arange(L, dtype=np.int64))
    return (2 * i - (L - 1)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _tables(mod: Modulation):
    """(constellation complex64 (M,), pam float32 (L,), norm, inorm)."""
    m = mod.bits_per_axis
    L = mod.levels_per_axis
    pam = _pam_amplitudes(m)
    norm = mod.unit_energy_scale
    if mod is Modulation.BPSK:
        const = pam.astype(np.complex128)
    else:
        gi = np.arange(1 << mod.bits_per_symbol, dtype=np.int64)
        const = pam[gi >> m] + 1j * pam[gi & (L - 1)]
    const = (const * norm).astype(np.complex64)
    return const, pam.astype(np.float32), np.float32(norm), np.float32(1.0 / norm)


def constellation(mod: Modulation, device=None) -> torch.Tensor:
    """Normalised constellation (2**bits_per_symbol,) complex64."""
    return torch.as_tensor(_tables(mod)[0], device=device)


def pam_table(mod: Modulation, device=None) -> torch.Tensor:
    """Per-axis un-normalised PAM amplitudes indexed by Gray code."""
    return torch.as_tensor(_tables(mod)[1], device=device)


# ---------------------------------------------------------------------------
# Bit/byte packing (MSB first).
# ---------------------------------------------------------------------------


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 (..., n) → int8 bits (..., 8n), MSB of each byte first."""
    shifts = torch.arange(7, -1, -1, device=data.device)
    bits = (data.to(torch.int64)[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8).to(torch.int8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """int bits (..., 8n) → uint8 (..., n), MSB first."""
    return _bits_to_ints(bits, 8).to(torch.uint8)


def _bits_to_ints(bits: torch.Tensor, width: int) -> torch.Tensor:
    """(..., n·width) bits → (..., n) int32, MSB first within each group."""
    n = bits.shape[-1] // width
    b = bits.reshape(*bits.shape[:-1], n, width).to(torch.int32)
    weights = 1 << torch.arange(width - 1, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1, dtype=torch.int32)


def _ints_to_bits(vals: torch.Tensor, width: int) -> torch.Tensor:
    """(..., n) ints → (..., n·width) int8 bits, MSB first."""
    shifts = torch.arange(width - 1, -1, -1, dtype=torch.int32, device=vals.device)
    bits = (vals.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*vals.shape[:-1], vals.shape[-1] * width).to(torch.int8)


# ---------------------------------------------------------------------------
# Mapping / demapping.
# ---------------------------------------------------------------------------


def modulate(bits: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Bits (..., n_sym·bps) → normalised points (..., n_sym) complex64."""
    bps = mod.bits_per_symbol
    if bits.shape[-1] % bps != 0:
        raise ValueError(
            f"bit count {bits.shape[-1]} not a multiple of bits/symbol {bps}"
        )
    idx = _bits_to_ints(bits, bps)
    return constellation(mod, bits.device)[idx.to(torch.int64)]


def _axis_hard_index(x: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Un-normalised axis amplitude → Gray index of the nearest level."""
    L = mod.levels_per_axis
    i = torch.clamp(torch.round((x + (L - 1)) * 0.5).to(torch.int32), 0, L - 1)
    return i ^ (i >> 1)


def nearest_symbol(points: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Normalised points (...,) → hard symbol indices (int32)."""
    inorm = float(_tables(mod)[3])
    unp = points * inorm
    if mod is Modulation.BPSK:
        return _axis_hard_index(unp.real, mod)
    gi = _axis_hard_index(unp.real, mod)
    gq = _axis_hard_index(unp.imag, mod)
    return (gi << mod.bits_per_axis) | gq


def demodulate_hard(points: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Normalised points (..., n_sym) → bits (..., n_sym·bps)."""
    return _ints_to_bits(nearest_symbol(points, mod), mod.bits_per_symbol)


# ---------------------------------------------------------------------------
# Reference byte-level API (to_constl / from_constl).
# ---------------------------------------------------------------------------


def to_constl(data: torch.Tensor, mod: Modulation = Modulation.QAM16) -> torch.Tensor:
    """Packed bytes (..., n) → constellation points, MSB bits first."""
    return modulate(bytes_to_bits(data), mod)


def from_constl(points: torch.Tensor, mod: Modulation = Modulation.QAM16) -> torch.Tensor:
    """Constellation points → packed bytes (hard decisions); a trailing
    partial byte is dropped, as in the reference."""
    bits = demodulate_hard(points, mod)
    usable = (bits.shape[-1] // 8) * 8
    return bits_to_bytes(bits[..., :usable])
