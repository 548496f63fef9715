"""Precision policy (port of ``sdr_tpu/core/precision.py``).

The reference templates everything over float/double and manages FP drift
by renormalising its twiddle recurrence every 32 steps
(the reference library's lib/inc/fft.hpp:144-150) — a scalar-CPU artifact. The
port's policy, in torch dtypes:

- compute dtype: complex64 (float32 re/im) — twiddles are precomputed
  tables, not recurrences, so there is no drift to manage;
- LLR / metric output dtype: float32 by default, bfloat16 optional for
  the bandwidth-bound demod outputs (kernel F's bf16 mode);
- accumulation (BER counters, power sums): float32/int32 on the device.

The accepted accuracy bound is the reference's own float test tolerance
(abs 1e-5 / rel 1e-6 per component, fft_test.cpp:48-64) plus the north
star's 0.1 dB BER parity bound. The JAX package's TPU matmul modes
(``SDR_TPU_MXU_PRECISION``) have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    complex_dtype: torch.dtype = torch.complex64
    real_dtype: torch.dtype = torch.float32
    llr_dtype: torch.dtype = torch.float32

    @property
    def bytes_per_complex(self) -> int:
        return self.complex_dtype.itemsize


def default_precision() -> Precision:
    return Precision()
