"""Frame synchronisation: Schmidl & Cox timing and carrier frequency offset.

Port of ``sdr_tpu/ops/sync.py``, batched over leading axes: where the JAX
functions run under ``vmap`` per channel (``acquire``, the link's
``_simulate_one_acquired``), every reduction and every
``dynamic_slice_in_dim`` here is per channel — a per-channel gather whose
start is clamped into [0, n − size], as ``dynamic_slice`` clamps.

- The preamble: symbol 1 carries PN-QPSK·√2 on the even subcarriers only
  (two identical time halves), symbol 2 PN-QPSK on every subcarrier (its
  even bins differentially encode the integer-CFO key). The grids are
  numpy ``default_rng(0x5C)``, as in the JAX module.
- The timing metric M(d) = |P(d)|²/(R(d) + δ)² with Minn's symmetric
  energy; P and the energies are sliding sums by float32 cumsum
  differences, in the JAX order.
- ``acquire``: coarse timing and fractional CFO from the plateau, the
  integer CFO from the two preamble symbols' FFTs, the full correction,
  then matched-filter fine timing against the whole preamble in a window
  around the coarse point. ``acquire_start`` (and ``acquire_array_start``
  for antenna arrays) gives the start and CFO without the corrected
  stream, and ``corrected_slice`` the corrected
  samples of a per-channel window: the rotation at each sample's
  absolute index, the angles of slicing ``correct_cfo`` of the whole
  stream.
- ``cp_residual_cfo`` / ``correct_residual_cfo``: the van de Beek CP
  correlation over every symbol of an aligned payload.

Plain torch on every device: the JAX module runs in XLA, outside any
kernel. Angles are computed in float32 in the JAX order (2π·ε first,
then the sample index, then / N).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sdr_tpu_torch.ops.fft import fft, ifft
from sdr_tpu_torch.ops.ofdm import cp_insert

PREAMBLE_SEED = 0x5C


def _pn_qpsk(rng, n: int) -> np.ndarray:
    quad = rng.integers(0, 4, n)
    return np.exp(1j * (np.pi / 4 + np.pi / 2 * quad))


def _preamble_grids(n_fft: int, seed: int):
    """Frequency grids of the two preamble symbols: PN-QPSK·√2 on the even
    subcarriers (symbol 1), independent PN-QPSK on all (symbol 2)."""
    rng = np.random.default_rng(seed)
    g1 = np.zeros(n_fft, np.complex64)
    g1[0::2] = (_pn_qpsk(rng, n_fft // 2) * np.sqrt(2.0)).astype(np.complex64)
    g2 = _pn_qpsk(rng, n_fft).astype(np.complex64)
    return g1, g2


@functools.lru_cache(maxsize=None)
def _preamble(n_fft: int, cp_len: int, seed: int, both: bool, device: str) -> torch.Tensor:
    g1, g2 = _preamble_grids(n_fft, seed)
    grids = (g1, g2) if both else (g1,)
    sym = [cp_insert(ifft(torch.from_numpy(g)), cp_len) for g in grids]
    return torch.cat(sym).to(device)


def schmidl_cox_preamble(n_fft: int, cp_len: int, seed: int = PREAMBLE_SEED,
                         device="cpu") -> torch.Tensor:
    """The CP-prefixed half-symmetric preamble symbol, (n_fft + cp_len,)
    complex64."""
    return _preamble(n_fft, cp_len, seed, False, str(device))


def acquisition_preamble(n_fft: int, cp_len: int, seed: int = PREAMBLE_SEED,
                         device="cpu") -> torch.Tensor:
    """The two-symbol preamble, 2·(n_fft + cp_len) samples complex64."""
    return _preamble(n_fft, cp_len, seed, True, str(device))


def _slide(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding sums of w samples by cumsum differences (the JAX order)."""
    c = torch.cumsum(x, dim=-1)
    out = c[..., w - 1:].clone()
    out[..., 1:] -= c[..., :-w]
    return out


def timing_metric(rx: torch.Tensor, n_fft: int):
    """Schmidl & Cox (P, R, M) over the candidate offsets, each
    (..., n − n_fft): P(d) = Σ_{m<L} conj(r[d+m])·r[d+m+L], R(d) the mean
    of the two half-window energies, M = |P|²/(R + δ)², δ = 0.05·mean(R)
    per leading index, L = n_fft/2."""
    L = n_fft // 2
    n_valid = rx.shape[-1] - n_fft
    P = _slide(torch.conj(rx[..., :-L]) * rx[..., L:], L)[..., :n_valid]
    E = _slide(torch.abs(rx) ** 2, L)
    R = 0.5 * (E[..., :n_valid] + E[..., L:L + n_valid])
    delta = 0.05 * torch.mean(R, dim=-1, keepdim=True)
    M = torch.abs(P) ** 2 / (R + delta) ** 2
    return P, R, M


def _centroid(M: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The plateau's centre (..., ) int64: argmax d0 of M, moved by the
    rounded mean offset of the near-max positions (M > 0.9·max M) within
    n_fft of d0. The positions are gathered from that window only (max M
    is M[d0]), the same integers as the JAX whole-array form."""
    d0 = torch.argmax(M, dim=-1)
    k = torch.arange(-n_fft, n_fft + 1, device=M.device)
    pos = d0[..., None] + k
    valid = (pos >= 0) & (pos < M.shape[-1])
    win = torch.gather(M, -1, pos.clamp(0, M.shape[-1] - 1))
    peak = torch.gather(M, -1, d0[..., None])
    near = (win > 0.9 * peak) & valid
    off = (k * near).sum(dim=-1)
    cnt = torch.clamp(near.sum(dim=-1), min=1)
    return d0 + torch.round(off / cnt).to(d0.dtype)


def estimate_timing_cfo(rx: torch.Tensor, n_fft: int):
    """(timing index (...,) int64, fractional CFO in subcarrier spacings
    (...,) float32, range ±1) from the metric's plateau."""
    P, _, M = timing_metric(rx, n_fft)
    d = _centroid(M, n_fft)
    p_peak = torch.gather(P, -1, d[..., None])[..., 0]
    return d, torch.angle(p_peak) / torch.tensor(math.pi, dtype=torch.float32)


def _rotation(n: torch.Tensor, cfo, n_fft: int) -> torch.Tensor:
    """e^{i·2π·ε·n/N} at float32 sample indices n: the angle in float32 as
    (2π·ε)·n / N, ε broadcast over n's last axis."""
    eps = torch.as_tensor(cfo, dtype=torch.float32, device=n.device)[..., None]
    ang = (2.0 * math.pi) * eps * n / n_fft
    return torch.complex(torch.cos(ang), torch.sin(ang))


def apply_cfo(samples: torch.Tensor, cfo_subcarriers, n_fft: int) -> torch.Tensor:
    """Impose a carrier frequency offset of ``cfo_subcarriers`` Δf (one
    value, or one per leading index) at sample indices 0 … n−1."""
    n = torch.arange(samples.shape[-1], dtype=torch.float32, device=samples.device)
    return samples * _rotation(n, cfo_subcarriers, n_fft)


def correct_cfo(samples: torch.Tensor, cfo_subcarriers, n_fft: int) -> torch.Tensor:
    """Undo an estimated CFO (the inverse rotation)."""
    return apply_cfo(samples, -torch.as_tensor(cfo_subcarriers), n_fft)


def _starts(start: torch.Tensor, size: int, n: int) -> torch.Tensor:
    """``dynamic_slice``'s clamp: a start moved into [0, n − size] (the
    JAX functions pass starts ≥ 0 only; ``dynamic_slice`` would wrap a
    negative one)."""
    return torch.clamp(start, 0, n - size)


def _gather(x: torch.Tensor, start: torch.Tensor, size: int):
    """(indices, x[..., s : s + size]) with s = clamp(start) per leading
    index of ``start`` (which broadcasts over x's leading axes but the
    last)."""
    s = _starts(start, size, x.shape[-1])
    idx = s[..., None] + torch.arange(size, device=x.device)
    return idx, torch.gather(x, -1, idx.expand(*x.shape[:-1], size))


def take(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``dynamic_slice_in_dim`` batched: x[..., s : s + size] per leading
    index, s = clamp(start)."""
    return _gather(x, start, size)[1]


def corrected_slice(rx: torch.Tensor, cfo, start: torch.Tensor, size: int, n_fft: int):
    """``take(correct_cfo(rx, cfo), start, size)`` without the whole
    corrected stream: the window's samples rotated at their absolute
    indices, the same angles."""
    idx, win = _gather(rx, start, size)
    eps = -torch.as_tensor(cfo, dtype=torch.float32, device=rx.device)
    n = idx.to(torch.float32)
    while eps.ndim < n.ndim - 1:
        eps = eps[..., None]
    return win * _rotation(n, eps, n_fft)


def fine_timing(rx: torch.Tensor, template: torch.Tensor, combine_axis: int | None = None):
    """Matched-filter fine timing: argmax_d |Σ_m conj(t[m])·rx[d+m]|² (int32,
    per leading index), as an FFT cross-correlation of length the next
    power of two above n + m − 1. ``combine_axis``: an antenna axis whose
    scores add non-coherently."""
    n = rx.shape[-1]
    m = template.shape[-1]
    L = 1 << (n + m - 1).bit_length()
    rf = fft(torch.nn.functional.pad(rx.to(torch.complex64), (0, L - n)))
    tf = fft(torch.nn.functional.pad(template.to(torch.complex64), (0, L - m)))
    corr = ifft(rf * torch.conj(tf))
    score = torch.abs(corr[..., :n - m + 1]) ** 2
    if combine_axis is not None:
        score = torch.sum(score, dim=combine_axis)
    return torch.argmax(score, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _integer_key(n_fft: int, seed: int, device: str) -> torch.Tensor:
    g1, g2 = _preamble_grids(n_fft, seed)
    even = np.arange(0, n_fft, 2)
    return torch.from_numpy((g2[even] / g1[even]).astype(np.complex64)).to(device)


def estimate_integer_cfo(y1: torch.Tensor, y2: torch.Tensor, n_fft: int, max_shift: int = 2,
                         seed: int = PREAMBLE_SEED, noncoherent_axis: int | None = None):
    """Even integer CFO (int32, in ±2·max_shift) from the two preamble
    symbols' FFT grids: argmax over shifts g of
    |Σ_{k even} Y2[k+2g]·conj(Y1[k+2g])·conj(v[k])|², v = X2/X1 on the
    even bins; ``noncoherent_axis`` sums the scores over an antenna axis."""
    vj = torch.conj(_integer_key(n_fft, seed, str(y1.device)))
    diff = y2 * torch.conj(y1)
    scores = []
    for g in range(-max_shift, max_shift + 1):
        shifted = torch.roll(diff, -2 * g, dims=-1)
        scores.append(torch.abs(torch.sum(shifted[..., 0::2] * vj, dim=-1)) ** 2)
    stacked = torch.stack(scores, dim=-1)
    if noncoherent_axis is not None:
        stacked = torch.sum(stacked, dim=noncoherent_axis)
    return (2 * (torch.argmax(stacked, dim=-1) - max_shift)).to(torch.int32)


def _fine_start(rx: torch.Tensor, total, d: torch.Tensor, n_fft: int, cp_len: int, seed: int,
                combine_axis: int | None = None) -> torch.Tensor:
    """The payload start: fine timing in the window of min(4 symbols, n)
    samples from clamp(d − sym_len), on the corrected samples."""
    sym_len = n_fft + cp_len
    n = rx.shape[-1]
    W = min(4 * sym_len, n)
    win_start = torch.clamp(d - sym_len, 0, n - W)
    ws = win_start if combine_axis is None else win_start[..., None]
    win = corrected_slice(rx, total, ws, W, n_fft)
    pre = acquisition_preamble(n_fft, cp_len, seed, rx.device)
    return win_start + fine_timing(win, pre, combine_axis) + 2 * sym_len


def acquire_start(rx: torch.Tensor, n_fft: int, cp_len: int, max_int_shift: int = 2,
                  seed: int = PREAMBLE_SEED):
    """``acquire`` without the corrected stream: (payload start (...,)
    int64, total CFO (...,) float32) of a (..., n) stream."""
    sym_len = n_fft + cp_len
    d, frac = estimate_timing_cfo(rx, n_fft)
    w1 = corrected_slice(rx, frac, d, n_fft, n_fft)
    w2 = corrected_slice(rx, frac, d + sym_len, n_fft, n_fft)
    mu = estimate_integer_cfo(fft(w1), fft(w2), n_fft, max_int_shift, seed)
    total = frac + mu.to(torch.float32)
    return _fine_start(rx, total, d, n_fft, cp_len, seed), total


def acquire(rx: torch.Tensor, n_fft: int, cp_len: int, max_int_shift: int = 2,
            seed: int = PREAMBLE_SEED):
    """Full blind acquisition against the two-symbol preamble, per leading
    index of rx (..., n): (payload start, total CFO in subcarriers, the
    CFO-corrected stream). The start indexes the first sample after the
    two preamble symbols."""
    start, total = acquire_start(rx, n_fft, cp_len, max_int_shift, seed)
    return start, total, correct_cfo(rx, total, n_fft)


def acquire_array_start(rx: torch.Tensor, n_fft: int, cp_len: int, max_int_shift: int = 2,
                        seed: int = PREAMBLE_SEED):
    """``acquire_array`` without the corrected stream: (start (B,) int64,
    total CFO (B,) float32) of antenna arrays (B, n_rx, n)."""
    sym_len = n_fft + cp_len
    P, _, M = timing_metric(rx, n_fft)
    Mc = torch.mean(M, dim=-2)
    d = _centroid(Mc, n_fft)
    half = max(cp_len // 2, 1)
    ws = torch.clamp(d - half, 0, P.shape[-1] - cp_len)
    win_p = take(P, ws[..., None], cp_len)
    frac = torch.angle(torch.sum(win_p, dim=(-2, -1))) / torch.tensor(math.pi,
                                                                      dtype=torch.float32)
    w1 = corrected_slice(rx, frac, d[..., None], n_fft, n_fft)
    w2 = corrected_slice(rx, frac, (d + sym_len)[..., None], n_fft, n_fft)
    mu = estimate_integer_cfo(fft(w1), fft(w2), n_fft, max_int_shift, seed,
                              noncoherent_axis=-2)
    total = frac + mu.to(torch.float32)
    return _fine_start(rx, total, d, n_fft, cp_len, seed, combine_axis=-2), total


def acquire_array(rx: torch.Tensor, n_fft: int, cp_len: int, max_int_shift: int = 2,
                  seed: int = PREAMBLE_SEED):
    """Blind acquisition from antenna arrays (B, n_rx, n), one link per
    leading index: the timing metric and the matched filter combined
    non-coherently over the antennas, P (over the CP-wide plateau window)
    and the integer-CFO scores as in the JAX function. Returns (start (B,),
    total CFO (B,), corrected (B, n_rx, n))."""
    start, total = acquire_array_start(rx, n_fft, cp_len, max_int_shift, seed)
    return start, total, correct_cfo(rx, total[..., None], n_fft)


def cp_residual_cfo(payload: torch.Tensor, n_fft: int, cp_len: int) -> torch.Tensor:
    """Residual fractional CFO (subcarriers, |ε| < 0.5) of aligned symbols
    (..., n_symbols, n_fft + cp_len) from the CP correlation over every
    symbol and CP sample (van de Beek)."""
    c = torch.sum(torch.conj(payload[..., :cp_len]) * payload[..., n_fft:], dim=(-2, -1))
    return torch.angle(c) / (2.0 * math.pi)


def correct_residual_cfo(payload: torch.Tensor, n_fft: int, cp_len: int) -> torch.Tensor:
    """Estimate (``cp_residual_cfo``) and derotate an aligned payload's
    residual carrier offset, the angle (−2π/N)·ε·t in float32 at the
    payload's own sample index t."""
    sym_len = n_fft + cp_len
    eps = cp_residual_cfo(payload, n_fft, cp_len)
    n_sym = payload.shape[-2]
    t = torch.arange(n_sym * sym_len, dtype=torch.float32,
                     device=payload.device).reshape(n_sym, sym_len)
    ph = (-2.0 * math.pi / n_fft) * eps[..., None, None] * t
    return payload * torch.complex(torch.cos(ph), torch.sin(ph))
