"""OFDM modulation/demodulation with the reference's exact CP layout.

Port of ``sdr_tpu/ops/ofdm.py``:

- ``ofdm_tx``: frequency-domain loading (..., N) → (..., cp_len + N)
  time samples, samples[cp_len:] = ifft(input) and samples[:cp_len] a
  copy of the LAST cp_len time-domain samples;
- ``ofdm_rx``: drop the first cp_len samples, forward-FFT the rest.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.ops.fft import fft, ifft


def cp_insert(time_symbols: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Prefix each time-domain symbol with its own last cp_len samples."""
    if cp_len == 0:
        return time_symbols
    n = time_symbols.shape[-1]
    if not 0 < cp_len <= n:
        raise ValueError(f"cp_len {cp_len} out of range for symbol length {n}")
    return torch.cat([time_symbols[..., n - cp_len:], time_symbols], dim=-1)


def cp_remove(samples: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Strip the cyclic prefix: (..., cp + N) → (..., N)."""
    if cp_len == 0:
        return samples
    return samples[..., cp_len:]


def ofdm_tx(freq_symbols: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Frequency-domain subcarriers → CP-prefixed time samples."""
    return cp_insert(ifft(freq_symbols), cp_len)


def ofdm_rx(samples: torch.Tensor, cp_len: int) -> torch.Tensor:
    """CP-prefixed time samples → frequency-domain subcarriers."""
    return fft(cp_remove(samples, cp_len))
