"""Comb and block pilots with LS/DFT channel estimation (port of
``sdr_tpu/ops/pilots.py``).

Neither the reference (noiseless loopback, no channel) nor genie-CSI
simulation needs this; a deployable receiver does. Two schemes:

- OFDM comb: every ``spacing``-th subcarrier carries the known point
  ``PILOT_VALUE``; the receiver least-squares-estimates the channel at
  the pilots (averaged over the frame's symbols, or per symbol for
  time-varying fading) and interpolates across subcarriers, linearly
  (``estimate_ls_comb``) or by projection onto the CP-bounded
  impulse-response subspace (``estimate_dft_comb``);
- SC-FDMA block pilots: one full-grid Zadoff–Chu symbol heads each block
  of ``spacing`` symbols (``estimate_block_pilots`` and its interpolating
  and tracking forms).

The index, weight and projection tables are numpy, computed once per
shape (``functools.lru_cache``), exactly as the JAX module computes
them, so the tests can hold them equal; the estimators are plain torch
on complex64 tensors (the JAX package runs them in XLA outside any
Pallas kernel). The DFT projections are complex matrix products
(``_project``), run in full float32: TF32 is held off for them on the
card whatever the caller's global setting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Unit-power pilot point (45° QPSK corner), known at both ends.
PILOT_VALUE = complex(2 ** -0.5, 2 ** -0.5)


@functools.lru_cache(maxsize=None)
def zadoff_chu(n: int, root: int = 1) -> np.ndarray:
    """Length-n Zadoff–Chu sequence (unit power per element), complex64:
    x[k] = exp(−jπ·u·k²/n) for even n, exp(−jπ·u·k(k+1)/n) for odd n.
    Constant amplitude in both domains (CAZAC): every subcarrier of a
    full-grid SC-FDMA reference symbol is observed at unit power, while
    the waveform stays constant-modulus."""
    k = np.arange(n, dtype=np.float64)
    quad = k * k if n % 2 == 0 else k * (k + 1)
    return np.exp(-1j * np.pi * root * quad / n).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def pn_preamble_grid(n_fft: int, seed: int = 0xA11) -> np.ndarray:
    """Unit-power pseudo-random QPSK pilot grid (n_fft,), complex64: a
    preamble whose waveform has a data symbol's statistics (a constant
    grid would transform to an impulse that a nonlinear PA clips)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, n_fft)
    return np.exp(1j * (np.pi / 4 + np.pi / 2 * q)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def pilot_indices(n_fft: int, spacing: int) -> tuple:
    """The comb 0, spacing, 2·spacing, ... (< n_fft)."""
    if spacing < 2:
        raise ValueError(f"pilot spacing must be >= 2, got {spacing}")
    return tuple(range(0, n_fft, spacing))


@functools.lru_cache(maxsize=None)
def data_indices(n_fft: int, spacing: int) -> tuple:
    pil = set(pilot_indices(n_fft, spacing))
    return tuple(k for k in range(n_fft) if k not in pil)


def n_data_subcarriers(n_fft: int, spacing: int) -> int:
    return len(data_indices(n_fft, spacing))


@functools.lru_cache(maxsize=None)
def _interp_tables(n_fft: int, spacing: int):
    """(left_idx, right_idx, weight) per subcarrier for the pilot lerp."""
    pil = np.asarray(pilot_indices(n_fft, spacing))
    k = np.arange(n_fft)
    left = np.clip((k // spacing), 0, len(pil) - 1)
    right = np.clip(left + 1, 0, len(pil) - 1)
    denom = np.maximum(pil[right] - pil[left], 1)
    w = np.clip((k - pil[left]) / denom, 0.0, 1.0)
    return left.astype(np.int32), right.astype(np.int32), w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_projection(n_fft: int, spacing: int, n_taps: int):
    """(n_pilots, n_fft) matrix projecting pilot LS samples onto the
    n_taps-tap impulse-response subspace, evaluated on the full grid:
    W = (IDFT over the comb, rows < n_taps) @ (DFT rows)."""
    pil = np.asarray(pilot_indices(n_fft, spacing), np.float64)
    n_pil = len(pil)
    l = np.arange(n_taps)[None, :]  # (1, n_taps)
    E = np.exp(2j * np.pi * pil[:, None] * l / n_fft) / n_pil  # (n_pil, L)
    k = np.arange(n_fft)[None, :]
    D = np.exp(-2j * np.pi * l.T * k / n_fft)  # (n_taps, n_fft)
    return (E @ D).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _dft_projection_full(n_fft: int, n_taps: int):
    """(n_fft, n_fft) projector onto the n_taps-tap impulse-response
    subspace for full-grid estimates (every subcarrier observed)."""
    k = np.arange(n_fft, dtype=np.float64)
    l = np.arange(n_taps)[None, :]
    E = np.exp(2j * np.pi * k[:, None] * l / n_fft) / n_fft  # (n_fft, L)
    D = np.exp(-2j * np.pi * l.T * k[None, :] / n_fft)  # (L, n_fft)
    return (E @ D).astype(np.complex64)


def dft_n_taps(n_fft: int, cp_len: int, spacing: int) -> int:
    """The denoiser's tap budget: the CP bounds the legal delay spread
    (cp_len + 1 taps), the comb's alias-free span what n_pilots samples
    resolve."""
    return min(cp_len + 1, len(pilot_indices(n_fft, spacing)))


@functools.lru_cache(maxsize=None)
def _on(table_fn, device: str, *args) -> torch.Tensor:
    """The numpy table ``table_fn(*args)`` (an array, or a tuple of
    indices) as a tensor on ``device``, made once per (table, shape,
    device)."""
    out = table_fn(*args)
    if isinstance(out, tuple):
        out = np.asarray(out, np.int64)
    return torch.from_numpy(np.ascontiguousarray(out)).to(device)


def _table(table_fn, like: torch.Tensor, *args) -> torch.Tensor:
    return _on(table_fn, str(like.device), *args)


def _interp_weights(n_fft: int, spacing: int, i: int) -> np.ndarray:
    """Entry i of ``_interp_tables`` (left, right: int64 for indexing)."""
    t = _interp_tables(n_fft, spacing)[i]
    return t if i == 2 else t.astype(np.int64)


def _pilot(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(PILOT_VALUE, dtype=like.dtype, device=like.device)


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w in full float32: on the card with TF32 held off for the call."""
    if not h.is_cuda or not torch.backends.cuda.matmul.allow_tf32:
        return h @ w
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return h @ w
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def _phase(phi: torch.Tensor) -> torch.Tensor:
    """exp(i·phi), complex64."""
    return torch.exp(torch.complex(torch.zeros_like(phi), phi))


def _chained_phases(hb: torch.Tensor):
    """Common phases of consecutive rows (..., B, n): (φ, Δφ), φ (..., B)
    with φ_0 = 0 and φ_b = Σ_{u<b} Δφ_u, Δφ_u = angle(Σ_k h_{u+1}[k]·
    conj(h_u[k])) (..., B − 1); one row has φ = 0."""
    if hb.shape[-2] == 1:
        return torch.zeros(hb.shape[:-1], dtype=torch.float32, device=hb.device), None
    d = torch.sum(hb[..., 1:, :] * torch.conj(hb[..., :-1, :]), dim=-1)
    dphi = torch.angle(d)
    phi = torch.cat([torch.zeros_like(dphi[..., :1]), torch.cumsum(dphi, dim=-1)], dim=-1)
    return phi, dphi


def _next_chord(c: torch.Tensor, dim: int) -> torch.Tensor:
    """The value at the next pilot instant along ``dim``: the next entry,
    the last extrapolated along its previous chord (itself alone when
    there is one)."""
    n = c.shape[dim]
    if n == 1:
        return c
    last = 2.0 * c.narrow(dim, n - 1, 1) - c.narrow(dim, n - 2, 1)
    return torch.cat([c.narrow(dim, 1, n - 1), last], dim=dim)


def _block_ls(y_pil: torch.Tensor) -> torch.Tensor:
    """Per-block per-tone LS against the chirp: y·conj(ZC) (|ZC| = 1)."""
    zc = _table(zadoff_chu, y_pil, y_pil.shape[-1])
    return y_pil * torch.conj(zc)


def insert_pilots(data_points: torch.Tensor, n_fft: int, spacing: int) -> torch.Tensor:
    """Data points (..., n_data) → full grid (..., n_fft) with the comb."""
    grid = torch.empty(data_points.shape[:-1] + (n_fft,), dtype=data_points.dtype,
                       device=data_points.device)
    grid[..., _table(data_indices, data_points, n_fft, spacing)] = data_points
    grid[..., _table(pilot_indices, data_points, n_fft, spacing)] = _pilot(data_points)
    return grid


def extract_data(grid: torch.Tensor, spacing: int) -> torch.Tensor:
    """Full grid (..., n_fft) → data subcarriers (..., n_data)."""
    return grid[..., _table(data_indices, grid, grid.shape[-1], spacing)]


def data_tones(plane: torch.Tensor, spacing: int, per_tone: int = 1) -> torch.Tensor:
    """``extract_data`` of a plane with ``per_tone`` consecutive entries a
    tone (an LLR plane's bits): (..., N·per_tone) → (..., n_data·per_tone)."""
    n = plane.shape[-1] // per_tone
    keep = _table(data_indices, plane, n, spacing)
    out = plane.reshape(*plane.shape[:-1], n, per_tone)[..., keep, :]
    return out.reshape(*plane.shape[:-1], keep.numel() * per_tone)


def estimate_ls_comb(y: torch.Tensor, spacing: int, per_symbol: bool = False) -> torch.Tensor:
    """LS channel estimate from comb pilots with linear interpolation.

    y: post-FFT grid (..., n_syms, n_fft). The pilot observations are
    averaged over the symbols (the frame-static models) unless
    ``per_symbol`` (time-varying fading), divided by the pilot and lerped
    across subcarriers. Returns h (..., 1, n_fft) or (..., n_syms, n_fft)."""
    n_fft = y.shape[-1]
    y_p = y[..., _table(pilot_indices, y, n_fft, spacing)]
    if not per_symbol:
        y_p = torch.mean(y_p, dim=-2, keepdim=True)
    h_p = y_p / _pilot(y)
    left, right, w = (_table(_interp_weights, y, n_fft, spacing, i) for i in range(3))
    return h_p[..., left] * (1.0 - w) + h_p[..., right] * w


def estimate_dft_comb(y: torch.Tensor, spacing: int, n_taps: int,
                      per_symbol: bool = False) -> torch.Tensor:
    """Transform-domain denoised estimate from comb pilots: LS at the
    pilots, then one (n_pil, n_fft) product that inverts to the impulse
    response, keeps its first ``n_taps`` taps (the CP bounds the true
    channel there) and re-evaluates on the full grid."""
    n_fft = y.shape[-1]
    y_p = y[..., _table(pilot_indices, y, n_fft, spacing)]
    if not per_symbol:
        y_p = torch.mean(y_p, dim=-2, keepdim=True)
    h_p = y_p / _pilot(y)
    return _project(h_p, _table(_dft_projection, y, n_fft, spacing, n_taps))


def estimate_ls_comb_tracked(y: torch.Tensor, spacing: int, base=None) -> torch.Tensor:
    """Frame-averaged estimate with per-symbol common-phase tracking: the
    differential phase of consecutive symbols' pilot vectors, chained;
    the grid derotated, ``base`` (default ``estimate_ls_comb``; a
    ``functools.partial`` of ``estimate_dft_comb`` composes tracking with
    the denoiser) on it, the phase re-applied → (..., n_syms, n_fft)."""
    if base is None:
        base = estimate_ls_comb
    yp = y[..., _table(pilot_indices, y, y.shape[-1], spacing)]
    rot = _phase(-_chained_phases(yp)[0])[..., None]
    h_avg = base(y * rot, spacing)  # (..., 1, n_fft)
    return h_avg * torch.conj(rot)


def estimate_block_pilots(y_pil: torch.Tensor, n_taps: int = 0) -> torch.Tensor:
    """LS estimate from full-grid Zadoff–Chu pilot symbols (..., n_blocks,
    n_fft), averaged over the blocks, optionally projected onto the
    n_taps-tap impulse-response subspace → (..., n_fft)."""
    h = torch.mean(_block_ls(y_pil), dim=-2)
    if n_taps:
        h = _project(h, _table(_dft_projection_full, h, h.shape[-1], n_taps))
    return h


def estimate_block_pilots_interp_full(y_pil: torch.Tensor, spacing: int) -> torch.Tensor:
    """Block-pilot estimate for selective time-varying fading
    (MULTIPATH_TIME): per-tone complex chord between consecutive blocks'
    LS estimates; data symbol (block b, offset o) takes (1 − o/p)·h_b +
    (o/p)·h_{b+1}, the last block extrapolating its previous chord.
    (..., B, n_fft) → (..., B, spacing − 1, n_fft)."""
    p = int(spacing)
    hb = _block_ls(y_pil)
    h_next = _next_chord(hb, -2)
    w = (torch.arange(1, p, dtype=torch.float32, device=hb.device) / p)[:, None]
    return (1.0 - w) * hb[..., :, None, :] + w * h_next[..., :, None, :]


def estimate_block_pilots_interp(y_pil: torch.Tensor, spacing: int) -> torch.Tensor:
    """Block-pilot estimate for flat time-varying fading (Jakes): the
    frame-averaged per-tone shape (blocks derotated by their chained
    common phases, so a residual timing phase does not average away)
    times a per-block complex scalar c_b = ⟨h_b, shape⟩/‖shape‖²,
    interpolated per data symbol along its chord.
    (..., B, n_fft) → (..., B, spacing − 1, n_fft)."""
    p = int(spacing)
    hb = _block_ls(y_pil)
    rot = _phase(-_chained_phases(hb)[0])[..., None]
    shape = torch.mean(hb * rot, dim=-2)  # (..., n_fft)
    denom = torch.clamp(torch.sum(shape.abs() ** 2, dim=-1, keepdim=True), min=1e-30)
    c = torch.sum(hb * torch.conj(shape)[..., None, :], dim=-1) / denom  # (..., B)
    c_next = _next_chord(c, -1)
    w = torch.arange(1, p, dtype=torch.float32, device=hb.device) / p
    ci = (1.0 - w) * c[..., :, None] + w * c_next[..., :, None]
    return ci[..., None] * shape[..., None, None, :]


def estimate_block_pilots_tracked(y_pil: torch.Tensor, spacing: int,
                                  n_taps: int = 0) -> torch.Tensor:
    """Block-pilot LS estimate with per-symbol common-phase tracking (the
    SC-FDMA twin of ``estimate_ls_comb_tracked``): chained block phases
    φ_b, the derotated blocks averaged into one shape (optionally
    DFT-projected), each data symbol (block b, offset o) given
    shape·e^{i(φ_b + o·Δφ_b/p)}, the last block reusing the previous
    slope. (..., B, n_fft) → (..., B, spacing − 1, n_fft)."""
    p = int(spacing)
    hb = _block_ls(y_pil)
    phi, dphi = _chained_phases(hb)  # (..., B), (..., B - 1)
    if hb.shape[-2] > 1:
        slope = torch.cat([dphi, dphi[..., -1:]], dim=-1) / p
    else:
        slope = torch.zeros_like(phi)
    shape = torch.mean(hb * _phase(-phi)[..., None], dim=-2)
    if n_taps:
        shape = _project(shape, _table(_dft_projection_full, shape, shape.shape[-1], n_taps))
    offs = torch.arange(1, p, dtype=torch.float32, device=hb.device)
    track = _phase(phi[..., :, None] + slope[..., :, None] * offs)  # (..., B, p-1)
    return shape[..., None, None, :] * track[..., None]


def estimate_mimo_preamble(y_pre: torch.Tensor, n_taps: int = 0) -> torch.Tensor:
    """Per-antenna-pair LS estimate from a time-orthogonal MIMO preamble
    (..., n_rx, n_tx, n_fft), optionally projected onto the CP-bounded
    impulse-response subspace; ĥ of the same shape."""
    h = y_pre / _pilot(y_pre)
    if n_taps > 0:
        h = _project(h, _table(_dft_projection_full, h, y_pre.shape[-1], n_taps))
    return h
