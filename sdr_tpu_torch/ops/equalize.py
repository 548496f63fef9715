"""One-tap frequency-domain equalizers (port of ``sdr_tpu/ops/equalize.py``).

Both return (equalized_symbols, effective_noise_var) so the soft
demapper can scale LLRs per subcarrier:

- ZF:    s = Y·conj(H)/|H|²,  var = noise_var/|H|²
- MMSE:  s = conj(H)·Y/(|H|² + noise_var), unbiased by the MMSE gain,
         with the unbiased effective variance noise_var/|H|²;
- SC-FDE MMSE (``equalize_mmse_fde``): the SC-FDMA receiver, biased
  per tone, despread, bias-corrected per symbol.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.ops.fft import ifft


def equalize_zf(y: torch.Tensor, h: torch.Tensor, noise_var):
    h2 = h.real ** 2 + h.imag ** 2
    eps = 1e-12
    s = y * torch.conj(h) / (h2 + eps)
    eff_var = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device) / (h2 + eps)
    return s, eff_var


def equalize_mmse(y: torch.Tensor, h: torch.Tensor, noise_var):
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device)
    h2 = h.real ** 2 + h.imag ** 2
    g = torch.conj(h) / (h2 + nv)
    s_biased = g * y
    # Unbias: E[s_biased | s] = (h2/(h2+nv))·s; divide by that gain.
    bias = h2 / (h2 + nv)
    s = s_biased / torch.clamp(bias, min=1e-12)
    eff_var = nv / torch.clamp(h2, min=1e-12)
    return s, eff_var


def equalize_mmse_fde(y: torch.Tensor, h: torch.Tensor, noise_var):
    """SC-FDE MMSE receiver (full-grid SC-FDMA): per-tone biased MMSE,
    unitary despread, symbol-level bias correction.

    The biased weight conj(H)/(|H|² + nv) keeps a deep notch from
    amplifying noise into every despread symbol; the despread output's
    useful-signal gain is the tone mean b = mean(|H|²/(|H|² + nv)),
    divided out once per symbol, and its SINR is b/(1 − b).

    y, h: (..., n_syms, n_fft) post-FFT grid and a response that
    broadcasts against it. Returns (s_time (..., n_syms, n_fft) complex64
    despread symbol estimates, eff_var (..., n_syms, 1) per-symbol
    effective noise variance)."""
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device)
    h2 = h.real ** 2 + h.imag ** 2
    s_f = torch.conj(h) * y / (h2 + nv)
    g = h2 / (h2 + nv)
    bias = torch.broadcast_to(g, y.shape).to(torch.float32).mean(dim=-1, keepdim=True)
    bias = torch.clamp(bias, min=1e-9)
    m = y.shape[-1]
    s_t = (ifft(s_f) * (m ** 0.5) / bias).to(torch.complex64)
    sinr = bias / torch.clamp(1.0 - bias, min=1e-9)
    return s_t, 1.0 / sinr
