"""Receive chain: CP strip → FFT → one-tap equalize → max-log LLR.

Port of ``sdr_tpu/ops/demod.py`` for the slice on the H100: the plain
LLR plane ``demod_chain``, the fast engine's count terminal
``demod_count_chain`` (kernel C) and the channels-last sum terminal
``demod_sum_chain_cl`` (kernel D) that the headline benchmark measures.

Dispatch is by device, through the port's own shape predicates (the
JAX package's ``select_backend`` / ``select_backend_cl`` chose among
Pallas kernels by VMEM budgets; those do not carry over): a CPU tensor
takes the plain torch version; a CUDA tensor takes the kernel, or the
call raises ``ValueError`` — nothing falls back.

Layouts: rows (B, S, N+cp) planar samples with h (B, 1|S, N); channels-
last (S·(N+cp), B) samples with h (N, B) in natural bin order.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import demod as _kc
from sdr_tpu_torch.kernels import demod_cl as _kd
from sdr_tpu_torch.kernels.demod import demod_chain  # noqa: F401  (plain LLR plane)


def select_backend(re_shape, hr_shape, idx_shape, cp_len: int, device) -> str:
    """"plain" on the CPU; "cuda" where kernel C takes the shapes;
    ``ValueError`` for a CUDA device and shapes it does not take."""
    if torch.device(device).type == "cpu":
        return "plain"
    if _kc.supported(re_shape, hr_shape, idx_shape, cp_len):
        return "cuda"
    raise ValueError(
        f"no CUDA count kernel for re {tuple(re_shape)}, h {tuple(hr_shape)}, "
        f"idx {tuple(idx_shape)}, cp {cp_len}"
    )


def select_backend_cl(re_t_shape, n_fft: int, cp_len: int, device) -> str:
    """Channels-last twin of ``select_backend`` for kernel D."""
    if torch.device(device).type == "cpu":
        return "plain"
    if _kd.supported(re_t_shape, n_fft, cp_len):
        return "cuda"
    raise ValueError(
        f"no CUDA channels-last kernel for {tuple(re_t_shape)}, n_fft {n_fft}, cp {cp_len}"
    )


def demod_count_chain(re, im, hr, hi, idx, cp_len: int, mod: Modulation,
                      noise_var: float) -> torch.Tensor:
    """Demod + hard-decision bit-error count vs transmitted indices:
    per-channel (B,) int32. No LLR plane is materialised on the card."""
    select_backend(re.shape, hr.shape, idx.shape, cp_len, re.device)
    return _kc.demod_count(re, im, hr, hi, idx, cp_len, mod, noise_var)


def demod_sum_chain_cl(re_t, im_t, hr_t, hi_t, cp_len: int, mod: Modulation,
                       noise_var: float, h_in_dif_order: bool = False) -> torch.Tensor:
    """Scalar float32 LLR sum over a channels-last grid (the bench
    terminal). ``h_in_dif_order``: h rows permuted by
    ``kernels.demod_cl.dif_perm``, as the JAX bench passes them."""
    select_backend_cl(re_t.shape, hr_t.shape[0], cp_len, re_t.device)
    return _kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, cp_len, mod, noise_var,
                            h_in_dif_order=h_in_dif_order)
