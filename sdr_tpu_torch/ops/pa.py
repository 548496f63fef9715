"""Power-amplifier nonlinearity (Rapp SSPA model) and ideal predistortion.

Port of ``sdr_tpu/ops/pa.py``. The transmitter's amplifier is memoryless
in amplitude: the Rapp AM/AM characteristic

    g(r) = r / (1 + (r/A_sat)^(2p))^(1/(2p))

with smoothness ``p`` and no AM/PM, its operating point set by the input
backoff IBO = 10·log10(A_sat² / P_in) over the NOMINAL input power (1/N
for unit-power subcarriers through the 1/N inverse FFT), so the
characteristic is a design constant and batching-invariant.

Every function is elementwise and takes either a complex tensor or a
planar pair (re, im) of float32 tensors, and returns the same form; the
arithmetic follows the JAX functions operation for operation (a real
gain factor from re² + im², then the samples scaled by it). Plain torch
on every device: the JAX package runs these in XLA, outside any kernel.
"""

from __future__ import annotations

import torch


def _parts(x):
    return (x.real, x.imag) if isinstance(x, torch.Tensor) else x


def _scaled(x, g: torch.Tensor):
    """x · g for a real factor g, in x's form."""
    if isinstance(x, torch.Tensor):
        return x * g
    return x[0] * g, x[1] * g


def rapp_sat_amplitude(ibo_db: float, signal_power: float) -> float:
    """Saturation amplitude A_sat for an input backoff over ``signal_power``
    (the nominal mean power of the PA input: 1/n_fft here)."""
    return float((signal_power * 10.0 ** (ibo_db / 10.0)) ** 0.5)


def apply_rapp(x, sat_amplitude: float, smoothness: float = 2.0):
    """Rapp AM/AM, elementwise: the phase is preserved, the gain factor is
    (1 + (r/A_sat)^{2p})^{-1/(2p)} computed from r² (exact at r = 0)."""
    p2 = 2.0 * float(smoothness)
    re, im = _parts(x)
    r2 = (re * re + im * im) / torch.tensor(sat_amplitude ** 2, dtype=torch.float32)
    gain = (1.0 + r2 ** (p2 / 2.0)) ** (-1.0 / p2)
    return _scaled(x, gain.to(torch.float32))


def rapp_predistort(x, sat_amplitude: float, smoothness: float = 2.0, max_out: float = 0.99):
    """Ideal digital predistortion for the Rapp AM/AM (its exact inverse
    r = a / (1 − (a/A_sat)^{2p})^{1/(2p)}), the desired amplitude first
    limited to ``max_out``·A_sat: the cascade PA(DPD(x)) is x wherever
    |x| ≤ max_out·A_sat and an ideal limiter beyond."""
    p2 = 2.0 * float(smoothness)
    re, im = _parts(x)
    a = torch.sqrt(re * re + im * im)
    cap = torch.tensor(max_out * sat_amplitude, dtype=torch.float32)
    a_clip = torch.minimum(a, cap.to(a.device))
    scale = torch.where(a > cap, cap / torch.clamp(a, min=1e-30), 1.0)
    u = (a_clip / torch.tensor(sat_amplitude, dtype=torch.float32)) ** p2
    boost = (1.0 - u) ** (-1.0 / p2)
    return _scaled(x, (scale * boost).to(torch.float32))


def apply_pa(x, ibo_db: float, signal_power: float, smoothness: float = 2.0, dpd: bool = False):
    """The configured TX front end: optional DPD, then the Rapp PA."""
    sat = rapp_sat_amplitude(ibo_db, signal_power)
    if dpd:
        x = rapp_predistort(x, sat, smoothness)
    return apply_rapp(x, sat, smoothness)
