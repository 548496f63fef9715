"""The matmul DFT: the Cooley–Tukey four-step FFT as dense matrix products.

Port of ``sdr_tpu/kernels/fft_matmul.py`` (the ``"matmul"`` backend of
``ops.fft``). For N = N1·N2,

    X[N1·k2 + k1] = Σ_n2 W_N2[n2, k2] · (T[k1, n2] ·
                    Σ_n1 x[N2·n1 + n2] · W_N1[n1, k1]),

i.e. reshape to (N1, N2), an N1-point DFT down the columns (a matrix
product), the pointwise twiddle T[k1, n2] = e^{∓2πi·k1·n2/N}, an N2-point
DFT along the rows (another product), then transpose and flatten.
Sub-DFTs of at most 128 points are direct DFT-matrix products; larger
factors recurse (``_split``: N1 ≤ N2, N1 the largest power of two at most
√N). A complex product is four real ones:
(xr + i·xi)(Wr + i·Wi) = (xr·Wr − xi·Wi) + i·(xr·Wi + xi·Wr).

The tables are float64, rounded once to float32 (no recurrence). The
products run in full float32 whatever the caller's TF32 setting: the JAX
module pins ``Precision.HIGHEST`` (its ``_cmatmul``) to hold the
reference's float tolerance, so on the card ``full_f32_matmul`` holds TF32
off around them and restores the setting after. Conventions as
``ops.fft``: unscaled forward, 1/N inverse.

This is a plain-torch backend (``torch.matmul`` on cuBLAS on the card, as
JAX left its products to XLA), not a kernel: the TPU module had no
``pl.pallas_call``. Whether it beats cuFFT at any N on the card is what
``obs.autotune.tune_fft`` measures.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

_DIRECT_MAX = 128  # the largest direct (single-product) DFT


@contextlib.contextmanager
def full_f32_matmul(t: torch.Tensor):
    """Float32 matrix products on ``t``'s device in full float32: on the
    card TF32 is held off inside the block and restored after."""
    if not t.is_cuda or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, inverse: bool):
    """(Wr, Wi) float32 (n, n): W[j, k] = e^{∓2πi·jk/n}."""
    jk = np.outer(np.arange(n), np.arange(n)).astype(np.float64)
    w = np.exp((2.0 if inverse else -2.0) * 1j * np.pi * jk / n)
    return np.real(w).astype(np.float32), np.imag(w).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, inverse: bool):
    """(Tr, Ti) float32 (n1, n2): T[k1, n2] = e^{∓2πi·k1·n2/(n1·n2)}."""
    k1n2 = np.outer(np.arange(n1), np.arange(n2)).astype(np.float64)
    t = np.exp((2.0 if inverse else -2.0) * 1j * np.pi * k1n2 / (n1 * n2))
    return np.real(t).astype(np.float32), np.imag(t).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _table(fn, device: torch.device, *args):
    """A float32 table pair on ``device``, built once per arguments."""
    return tuple(torch.from_numpy(a).to(device) for a in fn(*args))


def _split(n: int) -> tuple[int, int]:
    """Factor a power of two as n1·n2 with n1 ≤ n2, n1 maximal ≤ √n."""
    log = n.bit_length() - 1
    l1 = log // 2
    return 1 << l1, 1 << (log - l1)


def _cmatmul(xr, xi, wr, wi):
    """Complex (..., m, n) @ (n, k) as four real products."""
    return xr @ wr - xi @ wi, xr @ wi + xi @ wr


def _dft_planar(xr, xi, inverse: bool):
    """Unscaled DFT over the last axis of planar real/imag tensors."""
    n = xr.shape[-1]
    if n == 1:
        return xr, xi
    if n <= _DIRECT_MAX:
        return _cmatmul(xr, xi, *_table(_dft_matrix_np, xr.device, n, inverse))
    n1, n2 = _split(n)
    # Step 1: n = N2·n1 + n2 → rows index n1, columns n2; move n1 last.
    xr = xr.reshape(*xr.shape[:-1], n1, n2).transpose(-1, -2)
    xi = xi.reshape(*xi.shape[:-1], n1, n2).transpose(-1, -2)
    # Step 2: the N1-point DFT over n1, giving (..., n2, k1).
    ar, ai = _dft_planar(xr, xi, inverse)
    # Step 3: the twiddle T[k1, n2] in the (..., k1, n2) layout.
    ar, ai = ar.transpose(-1, -2), ai.transpose(-1, -2)
    tr, ti = _table(_twiddle_np, xr.device, n1, n2, inverse)
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    # Step 4: the N2-point DFT over n2, giving (..., k1, k2).
    cr, ci = _dft_planar(br, bi, inverse)
    # Output index k = N1·k2 + k1: transpose to (k2, k1) and flatten.
    cr = cr.transpose(-1, -2).reshape(*cr.shape[:-2], n)
    ci = ci.transpose(-1, -2).reshape(*ci.shape[:-2], n)
    return cr, ci


def matmul_fft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(I)FFT over the last axis by the matmul DFT (complex64 out):
    unscaled forward, inverse scaled by 1/N."""
    n = x.shape[-1]
    x = x.to(torch.complex64)
    with full_f32_matmul(x):
        yr, yi = _dft_planar(x.real.to(torch.float32), x.imag.to(torch.float32), inverse)
    if inverse:
        yr, yi = yr * (1.0 / n), yi * (1.0 / n)
    return torch.complex(yr, yi)
