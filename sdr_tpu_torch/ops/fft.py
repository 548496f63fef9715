"""FFT/IFFT with the reference's conventions, on ``torch.fft``.

Contract (the JAX package's ``sdr_tpu/ops/fft.py``, from the reference
library's fft.hpp):

- the forward transform is UNSCALED with kernel e^{-2πi·nk/N};
- the inverse uses e^{+2πi·nk/N} and scales by 1/N;
- sizes must be powers of two (raises ``ValueError`` otherwise).

These are exactly torch's default ("backward") normalisation, so both
functions are direct ``torch.fft`` calls on the last axis, with
arbitrary leading batch dims. This is the plain path; the CUDA kernels
of the port carry their own in-kernel transforms.
"""

from __future__ import annotations

import torch


def _validate(n: int) -> None:
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError(f"The sequence size must be a power of 2, got {n}")


def fft(x: torch.Tensor) -> torch.Tensor:
    """Unscaled forward DFT over the last axis (complex64 out)."""
    _validate(x.shape[-1])
    return torch.fft.fft(x.to(torch.complex64), dim=-1)


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Inverse DFT over the last axis with 1/N scaling (complex64 out)."""
    _validate(x.shape[-1])
    return torch.fft.ifft(x.to(torch.complex64), dim=-1)
