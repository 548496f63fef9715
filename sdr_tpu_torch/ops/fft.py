"""FFT/IFFT with the reference's conventions and a backend switch.

Contract (the JAX package's ``sdr_tpu/ops/fft.py``, from the reference
library's fft.hpp):

- the forward transform is UNSCALED with kernel e^{-2πi·nk/N};
- the inverse uses e^{+2πi·nk/N} and scales by 1/N;
- sizes must be powers of two (raises ``ValueError`` otherwise).

Backends, under the JAX module's names so that its scripts and the cli's
JSON keys carry over:

- ``"xla"``: ``torch.fft`` (cuFFT on the card). The name is JAX's, for
  its native FFT; these are exactly torch's default ("backward")
  normalisation.
- ``"matmul"``: the four-step DFT as dense matrix products
  (``ops.fft_matmul.matmul_fft``), in full float32.
- ``"auto"``: ``"matmul"`` from the crossover ``set_matmul_min_n`` sets,
  ``"xla"`` below it. The crossover defaults to never (``1 << 62``, what
  ``obs.autotune.recommend_crossover`` returns when matmul wins at no
  size): JAX's 8192 was measured on a TPU and says nothing of this card,
  so until a caller sets it from ``tune_fft`` on the card every result is
  torch's FFT, bit for bit.

The default backend is ``"auto"``; the port reads no environment variable
(JAX's ``SDR_TPU_FFT_BACKEND``): ``set_default_backend`` sets it. Every
plain-torch transform of the port goes through these two functions; the
CUDA kernels carry their own in-kernel transforms. All functions operate
on the last axis with arbitrary leading batch dims.
"""

from __future__ import annotations

from typing import Literal

import torch

from sdr_tpu_torch.ops.fft_matmul import matmul_fft

Backend = Literal["auto", "xla", "matmul"]
_BACKENDS = ("auto", "xla", "matmul")
NEVER = 1 << 62  # the crossover when matmul wins at no measured size

_DEFAULT_BACKEND: Backend = "auto"
_MATMUL_MIN_N = NEVER


def set_matmul_min_n(n: int) -> None:
    """Set the auto-backend crossover (from ``obs.autotune`` measurements)."""
    global _MATMUL_MIN_N
    _MATMUL_MIN_N = int(n)


def set_default_backend(backend: Backend) -> None:
    global _DEFAULT_BACKEND
    if backend not in _BACKENDS:
        raise ValueError(f"unknown FFT backend {backend!r}")
    _DEFAULT_BACKEND = backend


def get_default_backend() -> Backend:
    return _DEFAULT_BACKEND


def _validate(n: int) -> None:
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError(f"The sequence size must be a power of 2, got {n}")


def _resolve(n: int, backend: Backend | None) -> str:
    b = backend or _DEFAULT_BACKEND
    if b not in _BACKENDS:
        raise ValueError(f"unknown FFT backend {b!r}")
    if b == "auto":
        return "matmul" if n >= _MATMUL_MIN_N else "xla"
    return b


def fft(x: torch.Tensor, backend: Backend | None = None) -> torch.Tensor:
    """Unscaled forward DFT over the last axis (complex64 out)."""
    n = x.shape[-1]
    _validate(n)
    x = x.to(torch.complex64)
    if _resolve(n, backend) == "matmul":
        return matmul_fft(x, inverse=False)
    return torch.fft.fft(x, dim=-1)


def ifft(x: torch.Tensor, backend: Backend | None = None) -> torch.Tensor:
    """Inverse DFT over the last axis with 1/N scaling (complex64 out)."""
    n = x.shape[-1]
    _validate(n)
    x = x.to(torch.complex64)
    if _resolve(n, backend) == "matmul":
        return matmul_fft(x, inverse=True)
    return torch.fft.ifft(x, dim=-1)
