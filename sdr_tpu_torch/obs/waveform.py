"""Waveform-domain analysis: PAPR, EVM and Welch PSD (port of
``sdr_tpu/obs/waveform.py``).

The reference renders its TX waveform visually (time-domain Re/Im in
QFDemoWindow.cpp:29-163) but computes no waveform statistics; a deployable
SDR stack needs the standard three:

- **PAPR** — peak-to-average power ratio of the OFDM time waveform and its
  CCDF (the quantity PA back-off is budgeted against; OFDM's Gaussian-sum
  behaviour makes it grow ~log(n_fft)).
- **EVM** — RMS error-vector magnitude between equalised RX points and the
  nearest (or known) constellation points (3GPP/802.11 report %EVM per
  MCS). For an AWGN-limited link EVM² → noise_var.
- **PSD** — Welch-averaged periodogram of the serialised waveform; the
  occupied band of a CP-OFDM signal is flat over the loaded subcarriers.

All are plain torch reductions over arbitrary batch axes, on the device of
the tensor they are given (the JAX functions run in XLA, outside any
kernel), in float32 in the JAX order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.ops.modulation import constellation, nearest_symbol


def _power(x: torch.Tensor) -> torch.Tensor:
    return x.real ** 2 + x.imag ** 2


def papr_db(waveform: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Peak-to-average power ratio in dB along ``axis``; each slice along it
    is one PAPR measurement unit (conventionally one OFDM symbol)."""
    p = _power(waveform)
    peak = torch.amax(p, dim=axis)
    mean = torch.mean(p, dim=axis)
    return 10.0 * torch.log10(peak / torch.clamp(mean, min=1e-30))


def papr_ccdf(papr_samples_db: torch.Tensor, grid_db: torch.Tensor) -> torch.Tensor:
    """CCDF Pr[PAPR > x] on ``grid_db`` from measured per-symbol PAPRs (any
    shape, flattened)."""
    s = papr_samples_db.reshape(-1)
    grid = torch.as_tensor(grid_db, dtype=s.dtype, device=s.device)
    return torch.mean((s[None, :] > grid[:, None]).to(torch.float32), dim=1)


def evm_rms(rx_points: torch.Tensor, mod: Modulation,
            ref_points: torch.Tensor | None = None) -> torch.Tensor:
    """RMS EVM (a linear fraction of the unit constellation RMS).

    With ``ref_points`` the error vector is measured against the known
    transmitted points (data-aided, the exact definition); without, against
    the nearest constellation point per sample (blind — biased low once
    errors occur). Multiply by 100 for %EVM."""
    if ref_points is None:
        ref_points = constellation(mod, rx_points.device)[nearest_symbol(rx_points, mod).long()]
    return torch.sqrt(torch.mean(_power(rx_points - ref_points)))


@functools.lru_cache(maxsize=None)
def _hann(nperseg: int, device: str):
    """(Hann window float32, 1/mean(w²)) of ``np.hanning``."""
    w = np.hanning(nperseg)
    return torch.from_numpy(w.astype(np.float32)).to(device), 1.0 / float(np.mean(w ** 2))


def psd_welch(waveform: torch.Tensor, nperseg: int = 256, overlap: int = 128) -> torch.Tensor:
    """Welch-averaged power spectral density (Hann window, fftshifted).

    waveform: (..., n_samples) complex; batch axes average together with the
    segments. Returns (nperseg,) float32, normalised so the mean PSD equals
    the mean sample power (Parseval). The segments are one strided view and
    one batched FFT."""
    x = waveform.reshape(-1).to(torch.complex64)
    n = x.shape[0]
    step = nperseg - overlap
    if step <= 0:
        raise ValueError(f"overlap {overlap} must be < nperseg {nperseg}")
    n_seg = (n - nperseg) // step + 1
    if n_seg < 1:
        raise ValueError(f"waveform of {n} samples too short for nperseg={nperseg}")
    segs = x.unfold(0, nperseg, step)[:n_seg]
    win, scale = _hann(nperseg, str(x.device))
    spec = torch.fft.fftshift(torch.mean(_power(torch.fft.fft(segs * win, dim=-1)), dim=0))
    return (spec * scale / nperseg).to(torch.float32)


@functools.lru_cache(maxsize=None)
def papr_ccdf_theory(n_fft: int):
    """Classic OFDM CCDF approximation Pr[PAPR > x] = 1 − (1 − e^{−x})^N for N
    i.i.d. complex-Gaussian samples (van Nee & de Wild 1998) — the overlay
    reference for measured CCDFs. Returns f(grid_db) on numpy."""

    def f(grid_db: np.ndarray) -> np.ndarray:
        x = 10.0 ** (np.asarray(grid_db, np.float64) / 10.0)
        return 1.0 - (1.0 - np.exp(-x)) ** n_fft

    return f
