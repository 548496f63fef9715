"""Receive chain: CP strip → FFT → one-tap equalize → max-log LLR.

Port of ``sdr_tpu/ops/demod.py`` for the slice on the H100: the LLR
plane ``demod_chain`` (kernel C's LLR and sum modes; with
``despread=True`` the SC-FDE receive of full-grid SC-FDMA,
``demod_chain_jnp(despread=True)``), the channels-last LLR plane
``demod_llr_chain_cl`` (kernel F's LLR mode, float32 or bfloat16, in the
kernel order or the public one) that a coded receiver consumes, the fast
engine's count terminals ``demod_count_chain`` (kernel C, rows; with
``taps=`` the per-symbol TDL response is built in the kernel, with
``despread=True`` the SC-FDE receive at any N up to 4096 — the narrow
route and the wideband count the JAX package ran in two kernels) and
``demod_count_chain_cl``
(kernel F, channels-last), the channels-last sum terminal
``demod_sum_chain_cl`` (kernel D) that the headline benchmark measures,
and the hybrid route ``demod_chain_hybrid`` (torch's FFT, then kernel C's
post-FFT mode ``llr_chain``). The channels-last kernels take N up to
4096: above N = 512 a block holds fewer channels (their wideband mode).

Dispatch is by device, through the port's own shape predicates (the
JAX package's ``select_backend`` / ``select_backend_cl`` chose among
Pallas kernels by VMEM budgets; those do not carry over): a CPU tensor
takes the plain torch version; a CUDA tensor takes the kernel, or the
call raises ``ValueError`` — nothing falls back.

Layouts: rows (B, S, N+cp) planar samples with h (B, 1|S, N); channels-
last (S·(N+cp), B) samples with h (N, B) in natural bin order and, for
the count, indices (S·N, B). Sample planes are float32 or both bfloat16
(the JAX bench's input) on every route but the hybrid one, whose
post-FFT mode reads float32 bins; h stays float32, and a mix raises.
``demod_chain_plain`` is the plain composition on any device.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import demod as _kc
from sdr_tpu_torch.kernels import demod_cl as _kd
from sdr_tpu_torch.ops.ofdm import ofdm_rx


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


def select_backend_cl(re_t_shape, n_fft: int, cp_len: int, device,
                      idx_t_shape=None) -> str:
    """Channels-last twin of ``select_backend`` for kernels D (sum) and F
    (count: ``idx_t_shape`` given, which must be (S·N, B))."""
    if torch.device(device).type == "cpu":
        return "plain"
    ok = _kd.supported(re_t_shape, n_fft, cp_len)
    if ok and idx_t_shape is not None:
        n_syms = re_t_shape[0] // (n_fft + cp_len)
        ok = tuple(idx_t_shape) == (n_syms * n_fft, re_t_shape[1])
    if ok:
        return "cuda"
    raise ValueError(
        f"no CUDA channels-last kernel for {tuple(re_t_shape)}, n_fft {n_fft}, cp {cp_len}"
        + ("" if idx_t_shape is None else f", idx {tuple(idx_t_shape)}")
    )


def demod_count_chain(re, im, hr, hi, idx, cp_len: int, mod: Modulation,
                      noise_var: float, taps=None, despread: bool = False) -> torch.Tensor:
    """Demod + hard-decision bit-error count vs transmitted indices:
    per-channel (B,) int32. No LLR plane is materialised on the card.
    ``taps=(taps_r, taps_i)`` (B, S, L ≤ 8) stands for the channel plane
    (hr/hi may then be None). ``despread``: SC-FDE receive, ``idx`` the
    time-domain symbols."""
    chan_shape = hr.shape if taps is None else taps[0].shape
    select_backend(re.shape, chan_shape, idx.shape, cp_len, re.device)
    return _kc.demod_count(re, im, hr, hi, idx, cp_len, mod, noise_var, taps=taps,
                           despread=despread)


def demod_sum_chain_cl(re_t, im_t, hr_t, hi_t, cp_len: int, mod: Modulation,
                       noise_var: float, h_in_dif_order: bool = False) -> torch.Tensor:
    """Scalar float32 LLR sum over a channels-last grid (the bench
    terminal). ``h_in_dif_order``: h rows permuted by
    ``kernels.demod_cl.dif_perm``, as the JAX bench passes them."""
    select_backend_cl(re_t.shape, hr_t.shape[0], cp_len, re_t.device)
    return _kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, cp_len, mod, noise_var,
                            h_in_dif_order=h_in_dif_order)


def demod_count_chain_cl(re_t, im_t, hr_t, hi_t, idx_t, cp_len: int, mod: Modulation,
                         noise_var: float, h_in_dif_order: bool = False) -> torch.Tensor:
    """Per-channel (B,) int32 hard-decision bit-error counts over a
    channels-last grid — the fast engine's terminal under ``layout="cl"``."""
    select_backend_cl(re_t.shape, hr_t.shape[0], cp_len, re_t.device, idx_t.shape)
    return _kd.demod_count_cl(re_t, im_t, hr_t, hi_t, idx_t, cp_len, mod, noise_var,
                              h_in_dif_order=h_in_dif_order)


def demod_chain(re, im, hr, hi, cp_len: int, mod: Modulation, noise_var: float,
                reduce_sum: bool = False, despread: bool = False) -> torch.Tensor:
    """LLR plane (B, S, N·bps) float32 in the public order (per
    subcarrier, or per time symbol with ``despread``; I bits then Q bits,
    MSB first), or its float32 sum with ``reduce_sum``. re/im (B, S,
    N+cp) float32 or both bfloat16; hr/hi (B, 1 | S, N) float32. Plain
    torch on a CPU tensor, kernel C on a CUDA tensor (or ``ValueError``)."""
    return _kc.demod_llr(re, im, hr, hi, cp_len, mod, noise_var, reduce_sum=reduce_sum,
                         despread=despread)


def demod_chain_plain(re, im, hr, hi, cp_len: int, mod: Modulation, noise_var: float,
                      reduce_sum: bool = False, despread: bool = False) -> torch.Tensor:
    """The plain composition, always available (the JAX package's
    ``ops.demod.demod_chain_jnp``): ``ofdm_rx``, the one-tap or SC-FDE
    equaliser and the max-log LLRs in torch on whatever device the tensors
    are on — kernel C's plain version, ``kernels.demod.demod_chain``.
    Arguments and result as ``demod_chain``."""
    return _kc.demod_chain(re, im, hr, hi, cp_len, mod, noise_var, reduce_sum=reduce_sum,
                           despread=despread)


def demod_chain_hybrid(re, im, hr, hi, cp_len: int, mod: Modulation, noise_var: float,
                       reduce_sum: bool = False) -> torch.Tensor:
    """The hybrid route of the JAX package (``ops.demod.demod_chain_hybrid``):
    CP strip and FFT in torch (``ops.ofdm.ofdm_rx``, outside any kernel,
    as XLA's FFT is outside Pallas there), then kernel C's post-FFT mode
    ``llr_chain``, which reads the FFT's complex64 output in place
    (``torch.view_as_real``, no copies). re/im (B, S, N+cp); hr/hi
    (B, 1 | S, N). Returns the (B, S, N·bps) LLR plane in the public order,
    or its float32 sum."""
    y = ofdm_rx(torch.complex(re, im), cp_len)
    return _kc.llr_chain(torch.view_as_real(y.contiguous()), None, hr, hi, mod, noise_var,
                         reduce_sum=reduce_sum)


def demod_llr_chain_cl(re_t, im_t, hr_t, hi_t, cp_len: int, mod: Modulation,
                       noise_var: float, out_dtype=torch.float32, kernel_order: bool = False,
                       h_in_dif_order: bool = False) -> torch.Tensor:
    """LLR-materialising channels-last terminal — what a coded receiver
    consumes. ``kernel_order=True`` returns the plane as kernel F writes
    it, (S·bps·N, B): row (s·bps + j)·N + k holds bit j of subcarrier k of
    symbol s, natural bin order (not the TPU kernel's DIF order; compose
    any (de)interleaver with this order, as ``link.fast_coded`` does);
    ``kernel_order=False`` the public (B, S, N·bps) form (a torch
    relayout). ``out_dtype=torch.bfloat16`` halves the plane's write."""
    select_backend_cl(re_t.shape, hr_t.shape[0], cp_len, re_t.device)
    plane = _kd.demod_llr_cl(re_t, im_t, hr_t, hi_t, cp_len, mod, noise_var,
                             out_dtype=out_dtype, h_in_dif_order=h_in_dif_order)
    if kernel_order:
        return plane
    n_fft = hr_t.shape[0]
    return _kd.kernel_to_public(plane, re_t.shape[0] // (n_fft + cp_len), mod.bits_per_symbol,
                                n_fft)
