"""Kernels D and F: channels-last demod + LLR sum, the headline receive
terminal, channels-last demod + per-channel error count, and the
channels-last LLR plane (ports of
``sdr_tpu/kernels/demod_cl_pallas.py::demod_sum_cl``, ``::demod_count_cl``
and ``::demod_llr_cl``).

Layout contract (the JAX package's, demod_cl_pallas.py:37-45):

  re_t/im_t : (S·(N+cp), B) float32 planar samples, time-major — symbol
              s occupies rows [s·(N+cp), (s+1)·(N+cp)), its first cp
              rows being the CP; the minor axis is the channel batch.
  hr_t/hi_t : (N, B) per-link channel response, natural bin order;
  idx_t     : (S·N, B) transmitted symbol indices (count only), int8 for
              bps ≤ 7 and int16 above, natural bin order.

D returns the float32 sum of every max-log LLR over the grid, F the
(B,) int32 count of hard decisions (LLR < 0) that differ from the bits
of ``idx_t``, and F's LLR mode (``demod_llr_cl``) the plane itself in
the kernel order (S·bps·N, B) — row (s·bps + j)·N + k holds bit j of
subcarrier k of symbol s — as float32 or bfloat16 (counters
``demod_llr_cl``, ``demod_llr_cl_bf16``). The TPU kernel's DIF bin order
was a Mosaic artifact; these kernels work in natural order (so the
kernel-order plane's rows are natural bins, and ``kernel_to_public``
gives the public (B, S, N·bps) form), and ``h_in_dif_order=True`` (h
permuted by ``dif_perm``, as the JAX bench passes it) is un-permuted
here before the launch.

The kernels take N a power of two up to 4096 (the JAX kernel's range,
N = 128·2^k ≤ 4096, and below it), in one register-resident form
(``csrc/demod_cl.cuh``; one translation unit a mode): each thread holds
R points of one channel (the whole symbol at N < R) in registers from its
loads to its tail, adjacent lanes take adjacent channels, and h is staged
in shared memory once per run of symbols. Up to N = 512 (the narrow plan,
N = R · N/R with R = 16, 32 at N = 512: one exchange a symbol) a block
takes 2^13/N channels, at least 32, and runs 32 symbols; above it (the
wideband plan, N = 32 · 32 · N/1024) a block takes 2^14/N channels (16,
8, 4) and runs 16. The sample planes re_t/im_t may be
float32 or bfloat16, both of one type (the JAX bench feeds bf16 by
default, ``demod_cl_pallas.py:145``); the kernels widen bf16 samples on
load and compute in float32, and the plain versions cast to float32
first. h stays float32. bf16 input has its own counters
(``demod_sum_cl_in_bf16``, ``demod_count_cl_in_bf16``,
``demod_llr_cl_in_bf16``, ``demod_llr_cl_bf16_in_bf16``: one counter per
input and output type); it passes the JAX
package's BER gate (``chip_smoke.py`` phase 2b). D's cross-block sum is
a deterministic two-pass reduction, so repeated runs give the same bits;
F's counts are integer atomics, exact in any order.

On a CPU tensor the plain version runs; on a CUDA tensor the CUDA
kernel (``csrc/demod_cl.cu``, ``demod_cl_count.cu``, ``demod_cl_llr.cu``)
runs, or the call raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.kernels.demod import count_errors, demod_chain, inv_noise_var

_BASE = 128  # the TPU kernel's leaf DFT size, which fixes its DIF order
MAX_N_FFT = 4096  # the wideband radix plan 32 · 32 · N/1024 ends at N/1024 = 4


@functools.lru_cache(maxsize=None)
def dif_perm(n_fft: int) -> np.ndarray:
    """Kernel-row → natural-bin map of the JAX kernel's recursive DIF
    split: perm(N) = concat(2·perm(N/2), 2·perm(N/2)+1), perm(128) =
    arange. Defined for N = 128·2^k."""
    if n_fft < _BASE or n_fft % _BASE or (n_fft // _BASE) & (n_fft // _BASE - 1):
        raise ValueError(f"DIF order is defined for n_fft = 128·2^k, got {n_fft}")
    if n_fft == _BASE:
        return np.arange(_BASE)
    half = dif_perm(n_fft // 2)
    return np.concatenate([2 * half, 2 * half + 1])


@functools.lru_cache(maxsize=None)
def inv_dif_perm(n_fft: int) -> np.ndarray:
    p = dif_perm(n_fft)
    inv = np.empty_like(p)
    inv[p] = np.arange(n_fft)
    return inv


def h_natural(hr_t, hi_t, h_in_dif_order: bool):
    """Undo a caller-side DIF permutation of the (N, B) channel planes."""
    if not h_in_dif_order:
        return hr_t, hi_t
    inv = torch.as_tensor(inv_dif_perm(hr_t.shape[0]), device=hr_t.device)
    return hr_t[inv], hi_t[inv]


_IN_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtypes(name: str, re_t, im_t, hr_t, hi_t) -> bool:
    """Raise unless re_t/im_t are both float32 or both bfloat16 and h is
    float32 (the plain versions hold the kernels' contract too); True for
    bf16 samples."""
    if re_t.dtype not in _IN_DTYPES or im_t.dtype != re_t.dtype:
        raise ValueError(f"{name}: re_t/im_t must both be float32 or both bfloat16, "
                         f"got {re_t.dtype} and {im_t.dtype}")
    if hr_t.dtype != torch.float32 or hi_t.dtype != torch.float32:
        raise ValueError(f"{name}: hr_t/hi_t must be float32")
    return re_t.dtype == torch.bfloat16


def _counter(name: str, in_bf16: bool) -> str:
    """Launch counter of a channels-last kernel for its sample type."""
    return name + "_in_bf16" if in_bf16 else name


def supported(shape, n_fft: int, cp_len: int) -> bool:
    """(S·(N+cp), B) planes with N a power of two in [2, 4096]."""
    if len(shape) != 2 or not (2 <= n_fft <= MAX_N_FFT and (n_fft & (n_fft - 1)) == 0):
        return False
    return cp_len >= 0 and shape[0] % (n_fft + cp_len) == 0 and shape[0] > 0 and shape[1] > 0


def _symbol_rows(x_t, s: int, sym_len: int, cp_len: int, n_fft: int):
    """Symbol s of a channels-last plane, CP stripped, as (B, 1, N) rows."""
    o = s * sym_len + cp_len
    return x_t[o:o + n_fft].T[:, None, :]


def demod_sum_cl_plain(re_t, im_t, hr_t, hi_t, cp_len: int, mod: Modulation,
                       noise_var: float):
    """Plain version: the plain LLR plane (``kernels.demod.demod_chain``)
    summed symbol by symbol, as the JAX twin ``demod_cl_jnp`` loops."""
    n_fft = hr_t.shape[0]
    sym_len = n_fft + cp_len
    n_syms = re_t.shape[0] // sym_len
    hr = hr_t.T[:, None, :]
    hi = hi_t.T[:, None, :]
    acc = None
    for s in range(n_syms):
        xr = _symbol_rows(re_t, s, sym_len, cp_len, n_fft)
        xi = _symbol_rows(im_t, s, sym_len, cp_len, n_fft)
        r = demod_chain(xr, xi, hr, hi, 0, mod, noise_var, reduce_sum=True)
        acc = r if acc is None else acc + r
    return acc


def demod_sum_cl(re_t, im_t, hr_t, hi_t, cp_len: int, mod: Modulation, noise_var: float,
                 h_in_dif_order: bool = False):
    """Scalar float32 LLR sum over the channels-last grid (0-d tensor)."""
    hr_t, hi_t = h_natural(hr_t, hi_t, h_in_dif_order)
    in_bf16 = _check_dtypes("demod_sum_cl", re_t, im_t, hr_t, hi_t)
    if re_t.device.type == "cpu":
        return demod_sum_cl_plain(re_t, im_t, hr_t, hi_t, cp_len, mod, noise_var)
    n_fft = hr_t.shape[0]
    if not supported(re_t.shape, n_fft, cp_len):
        raise ValueError(
            f"demod_sum_cl kernel: unsupported shape {tuple(re_t.shape)} n_fft={n_fft} cp={cp_len}"
        )
    B = re_t.shape[1]
    if im_t.shape != re_t.shape or hr_t.shape != (n_fft, B) or hi_t.shape != (n_fft, B):
        raise ValueError("demod_sum_cl kernel: plane shapes disagree")
    hr_t = hr_t.contiguous()
    hi_t = hi_t.contiguous()
    _lib.require_cuda("demod_sum_cl", re_t, im_t, hr_t, hi_t)
    n_syms = re_t.shape[0] // (n_fft + cp_len)
    lib = _lib.lib()
    partials = torch.empty((lib.sdr_demod_sum_cl_partials(B, n_syms, _lib.log2_exact(n_fft)),),
                           dtype=torch.float32, device=re_t.device)
    out = torch.empty((1,), dtype=torch.float32, device=re_t.device)
    twr, twi = _lib.twiddles(n_fft, re_t.device)
    rc = lib.sdr_demod_sum_cl(
        re_t.data_ptr(), im_t.data_ptr(), int(in_bf16), hr_t.data_ptr(), hi_t.data_ptr(),
        partials.data_ptr(), out.data_ptr(), B, n_syms, _lib.log2_exact(n_fft), cp_len,
        mod.bits_per_axis, int(mod is Modulation.BPSK), _lib.axis_tables(mod),
        inv_noise_var(noise_var), twr.data_ptr(), twi.data_ptr(), _lib.stream(),
    )
    name = _counter("demod_sum_cl", in_bf16)
    _lib.check(rc, name)
    _lib.LAUNCHES[name] += 1
    return out[0]


_LLR_DTYPES = (torch.float32, torch.bfloat16)


def kernel_to_public(plane, n_syms: int, bps: int, n_fft: int):
    """Kernel-order (S·bps·N, B) plane → the public (B, S, N·bps) order:
    row (s·bps + j)·N + k holds bit j of subcarrier k of symbol s."""
    B = plane.shape[1]
    return plane.reshape(n_syms, bps, n_fft, B).permute(3, 0, 2, 1).reshape(B, n_syms, n_fft * bps)


def demod_llr_cl_plain(re_t, im_t, hr_t, hi_t, cp_len: int, mod: Modulation, noise_var: float,
                       out_dtype=torch.float32):
    """Plain version: the plain LLR plane (``kernels.demod.demod_chain``)
    of each symbol, laid out in the kernel order (S·bps·N, B)."""
    n_fft = hr_t.shape[0]
    sym_len = n_fft + cp_len
    n_syms = re_t.shape[0] // sym_len
    bps = mod.bits_per_symbol
    hr = hr_t.T[:, None, :]
    hi = hi_t.T[:, None, :]
    planes = []
    for s in range(n_syms):
        llr = demod_chain(_symbol_rows(re_t, s, sym_len, cp_len, n_fft),
                          _symbol_rows(im_t, s, sym_len, cp_len, n_fft), hr, hi, 0, mod,
                          noise_var)  # (B, 1, N·bps)
        planes.append(llr.reshape(-1, n_fft, bps).permute(2, 1, 0).reshape(bps * n_fft, -1))
    return torch.cat(planes, dim=0).to(out_dtype)


def demod_llr_cl(re_t, im_t, hr_t, hi_t, cp_len: int, mod: Modulation, noise_var: float,
                 out_dtype=torch.float32, h_in_dif_order: bool = False):
    """The LLR plane over the channels-last grid in the kernel order
    (S·bps·N, B): per symbol, bit-major planes of natural-order bins,
    channels minor; float32 or bfloat16."""
    hr_t, hi_t = h_natural(hr_t, hi_t, h_in_dif_order)
    if out_dtype not in _LLR_DTYPES:
        raise ValueError(f"demod_llr_cl: out_dtype must be float32 or bfloat16, got {out_dtype}")
    in_bf16 = _check_dtypes("demod_llr_cl", re_t, im_t, hr_t, hi_t)
    if re_t.device.type == "cpu":
        return demod_llr_cl_plain(re_t, im_t, hr_t, hi_t, cp_len, mod, noise_var, out_dtype)
    n_fft = hr_t.shape[0]
    if not supported(re_t.shape, n_fft, cp_len):
        raise ValueError(
            f"demod_llr_cl kernel: unsupported shape {tuple(re_t.shape)} n_fft={n_fft} "
            f"cp={cp_len}"
        )
    B = re_t.shape[1]
    if im_t.shape != re_t.shape or hr_t.shape != (n_fft, B) or hi_t.shape != (n_fft, B):
        raise ValueError("demod_llr_cl kernel: plane shapes disagree")
    hr_t = hr_t.contiguous()
    hi_t = hi_t.contiguous()
    _lib.require_cuda("demod_llr_cl", re_t, im_t, hr_t, hi_t)
    n_syms = re_t.shape[0] // (n_fft + cp_len)
    bf16 = out_dtype == torch.bfloat16
    out = torch.empty((n_syms * mod.bits_per_symbol * n_fft, B), dtype=out_dtype,
                      device=re_t.device)
    twr, twi = _lib.twiddles(n_fft, re_t.device)
    rc = _lib.lib().sdr_demod_llr_cl(
        re_t.data_ptr(), im_t.data_ptr(), int(in_bf16), hr_t.data_ptr(), hi_t.data_ptr(),
        out.data_ptr(), int(bf16), B, n_syms, _lib.log2_exact(n_fft), cp_len, mod.bits_per_axis,
        int(mod is Modulation.BPSK), _lib.axis_tables(mod), inv_noise_var(noise_var),
        twr.data_ptr(), twi.data_ptr(), _lib.stream(),
    )
    name = _counter("demod_llr_cl_bf16" if bf16 else "demod_llr_cl", in_bf16)
    _lib.check(rc, name)
    _lib.LAUNCHES[name] += 1
    return out


def demod_count_cl_plain(re_t, im_t, hr_t, hi_t, idx_t, cp_len: int, mod: Modulation,
                         noise_var: float):
    """Plain version: the plain LLR plane (``kernels.demod.demod_chain``)
    counted symbol by symbol, as the JAX twin ``demod_cl_jnp`` loops."""
    n_fft = hr_t.shape[0]
    sym_len = n_fft + cp_len
    n_syms = re_t.shape[0] // sym_len
    hr = hr_t.T[:, None, :]
    hi = hi_t.T[:, None, :]
    acc = torch.zeros((re_t.shape[1],), dtype=torch.int32, device=re_t.device)
    for s in range(n_syms):
        llr = demod_chain(_symbol_rows(re_t, s, sym_len, cp_len, n_fft),
                          _symbol_rows(im_t, s, sym_len, cp_len, n_fft), hr, hi, 0, mod,
                          noise_var)
        acc += count_errors(llr, idx_t[s * n_fft:(s + 1) * n_fft].T[:, None, :],
                            mod.bits_per_symbol)
    return acc


def demod_count_cl(re_t, im_t, hr_t, hi_t, idx_t, cp_len: int, mod: Modulation,
                   noise_var: float, h_in_dif_order: bool = False):
    """Per-channel (B,) int32 bit-error counts over the channels-last grid."""
    hr_t, hi_t = h_natural(hr_t, hi_t, h_in_dif_order)
    in_bf16 = _check_dtypes("demod_count_cl", re_t, im_t, hr_t, hi_t)
    if re_t.device.type == "cpu":
        return demod_count_cl_plain(re_t, im_t, hr_t, hi_t, idx_t, cp_len, mod, noise_var)
    n_fft = hr_t.shape[0]
    if not supported(re_t.shape, n_fft, cp_len):
        raise ValueError(
            f"demod_count_cl kernel: unsupported shape {tuple(re_t.shape)} "
            f"n_fft={n_fft} cp={cp_len}"
        )
    B = re_t.shape[1]
    n_syms = re_t.shape[0] // (n_fft + cp_len)
    if (im_t.shape != re_t.shape or hr_t.shape != (n_fft, B) or hi_t.shape != (n_fft, B)
            or idx_t.shape != (n_syms * n_fft, B)):
        raise ValueError("demod_count_cl kernel: plane shapes disagree")
    if idx_t.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"demod_count_cl kernel: indices must be int8/int16, got {idx_t.dtype}")
    hr_t = hr_t.contiguous()
    hi_t = hi_t.contiguous()
    _lib.require_cuda("demod_count_cl", re_t, im_t, hr_t, hi_t, idx_t)
    out = torch.zeros((B,), dtype=torch.int32, device=re_t.device)
    twr, twi = _lib.twiddles(n_fft, re_t.device)
    rc = _lib.lib().sdr_demod_count_cl(
        re_t.data_ptr(), im_t.data_ptr(), int(in_bf16), hr_t.data_ptr(), hi_t.data_ptr(),
        idx_t.data_ptr(), idx_t.element_size(), out.data_ptr(), B, n_syms,
        _lib.log2_exact(n_fft), cp_len, mod.bits_per_axis, int(mod is Modulation.BPSK),
        _lib.axis_tables(mod), inv_noise_var(noise_var), twr.data_ptr(), twi.data_ptr(),
        _lib.stream(),
    )
    name = _counter("demod_count_cl", in_bf16)
    _lib.check(rc, name)
    _lib.LAUNCHES[name] += 1
    return out
