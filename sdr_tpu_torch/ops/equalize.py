"""One-tap frequency-domain equalizers (port of ``sdr_tpu/ops/equalize.py``).

Both return (equalized_symbols, effective_noise_var) so the soft
demapper can scale LLRs per subcarrier:

- ZF:    s = Y·conj(H)/|H|²,  var = noise_var/|H|²
- MMSE:  s = conj(H)·Y/(|H|² + noise_var), unbiased by the MMSE gain,
         with the unbiased effective variance noise_var/|H|².
"""

from __future__ import annotations

import torch


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
