"""Kernel B: fused TX + flat channel (port of
``sdr_tpu/kernels/tx_pallas.py::tx_channel_chain_pallas`` in its
flat-gain and AWGN-only modes, and of ``tx_chain_pallas``).

Symbol indices (B, S, N) → Gray map → N-point inverse DFT (1/N and the
unit-energy norm folded in) → cyclic prefix → optional per-channel
complex gain ``hs`` → optional noise σ·n on every sample of the CP'd
symbol, σ = sqrt(noise_var/2), where ``noise_var`` is the TIME-domain
complex variance (the fast link's ``tvar = nv/N``). Returns planar
float32 (re, im), each (B, S, N+cp).

Noise modes:

- ``noise=(n_re, n_im)``: injected N(0, 1) planes of shape (B, S, N+cp)
  — for exact comparison with the plain version and with the JAX
  kernels, which draw from another stream;
- ``seed`` and ``ch_ids``: keyed Philox, counter (ch_ids[b], s, sample,
  0) on ``seed ^ ROLE_NOISE``, Box–Muller on words 0 and 1;
- neither: channel off (``tx_chain``), the waveform alone.

On a CPU tensor the plain version (``tx_channel_plain``) runs; on a
CUDA tensor the CUDA kernel (``csrc/tx.cu``) runs, or the call raises.
"""

from __future__ import annotations

import math

import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.ops.modulation import constellation
from sdr_tpu_torch.ops.ofdm import ofdm_tx

_IDX_DTYPES = (torch.int8, torch.int16, torch.int32)
MAX_N_FFT = 4096  # two (symbols, N) f32 tiles in 48 KB of shared memory


def supported(shape, cp_len: int, mod: Modulation) -> bool:
    """(B, S, N) indices with N a power of two in [2, 4096], 0 ≤ cp ≤ N."""
    if len(shape) != 3:
        return False
    n = shape[2]
    return 2 <= n <= MAX_N_FFT and (n & (n - 1)) == 0 and 0 <= cp_len <= n


def _sigma(noise_var: float) -> float:
    return math.sqrt(max(float(noise_var), 0.0) / 2.0)


def _noise_mode(noise, seed, ch_ids) -> int:
    if noise is not None and seed is not None:
        raise ValueError("pass either injected noise or a seed, not both")
    if seed is not None and ch_ids is None:
        raise ValueError("keyed noise needs the global channel ids")
    return 1 if noise is not None else (2 if seed is not None else 0)


def tx_channel_plain(idx, cp_len: int, mod: Modulation, hs_r=None, hs_i=None,
                     noise_var: float = 0.0, noise=None, seed=None, ch_ids=None):
    """Plain torch version (same arguments and modes as ``tx_channel``)."""
    mode = _noise_mode(noise, seed, ch_ids)
    pts = constellation(mod, idx.device)[idx.to(torch.int64)]
    x = ofdm_tx(pts, cp_len)
    yr, yi = x.real, x.imag
    if hs_r is not None:
        fr = hs_r.reshape(-1, 1, 1)
        fi = hs_i.reshape(-1, 1, 1)
        yr, yi = yr * fr - yi * fi, yr * fi + yi * fr
    if mode == 0:
        return yr.contiguous(), yi.contiguous()
    if mode == 1:
        n_re, n_im = noise
    else:
        B, S, L = yr.shape
        n_re, n_im = prng.normal_pair(seed, prng.ROLE_NOISE, ch_ids, (S, L))
    sigma = _sigma(noise_var)
    return yr + sigma * n_re, yi + sigma * n_im


def tx_channel(idx, cp_len: int, mod: Modulation, hs_r=None, hs_i=None,
               noise_var: float = 0.0, noise=None, seed=None, ch_ids=None):
    """Fused TX + flat channel over explicit indices.

    idx (B, S, N) int8/int16/int32; hs_r/hs_i (B,) or (B, 1) float32
    per-channel gain, or None; see the module docstring for the noise
    modes. Returns (re, im) (B, S, N+cp) float32."""
    mode = _noise_mode(noise, seed, ch_ids)
    if idx.device.type == "cpu":
        return tx_channel_plain(idx, cp_len, mod, hs_r, hs_i, noise_var, noise, seed, ch_ids)
    if not supported(idx.shape, cp_len, mod):
        raise ValueError(f"tx kernel: unsupported shape {tuple(idx.shape)} cp={cp_len}")
    if idx.dtype not in _IDX_DTYPES:
        raise ValueError(f"tx kernel: indices must be int8/16/32, got {idx.dtype}")
    B, S, N = idx.shape
    L = N + cp_len
    operands = [idx]
    if hs_r is not None:
        if hs_r.numel() != B or hs_i.numel() != B:
            raise ValueError("tx kernel: hs_r/hs_i must hold one gain per channel")
        if hs_r.dtype != torch.float32 or hs_i.dtype != torch.float32:
            raise ValueError("tx kernel: gains must be float32")
        operands += [hs_r, hs_i]
    if mode == 1:
        for n in noise:
            if n.shape != (B, S, L) or n.dtype != torch.float32:
                raise ValueError(f"tx kernel: noise planes must be float32 {(B, S, L)}")
        operands += list(noise)
    if mode == 2:
        if ch_ids.shape != (B,) or ch_ids.dtype != torch.int32:
            raise ValueError("tx kernel: ch_ids must be int32 (B,)")
        operands.append(ch_ids)
    _lib.require_cuda("tx", *operands)
    out_re = torch.empty((B, S, L), dtype=torch.float32, device=idx.device)
    out_im = torch.empty_like(out_re)
    twr, twi = _lib.twiddles(N, idx.device)
    k0, k1 = prng.split_key(seed, prng.ROLE_NOISE) if mode == 2 else (0, 0)
    rc = _lib.lib().sdr_tx(
        idx.data_ptr(), idx.element_size(), out_re.data_ptr(), out_im.data_ptr(),
        B, S, _lib.log2_exact(N), cp_len, mod.bits_per_axis,
        int(mod is Modulation.BPSK), mod.unit_energy_scale / N,
        twr.data_ptr(), twi.data_ptr(), _lib.ptr(hs_r), _lib.ptr(hs_i), mode,
        _lib.ptr(noise[0]) if mode == 1 else None,
        _lib.ptr(noise[1]) if mode == 1 else None,
        _lib.ptr(ch_ids) if mode == 2 else None,
        k0, k1, _sigma(noise_var), _lib.stream(),
    )
    _lib.check(rc, "tx")
    _lib.LAUNCHES["tx"] += 1
    return out_re, out_im


def tx_chain(idx, cp_len: int, mod: Modulation):
    """The waveform alone (channel off): ``tx_chain_pallas``'s contract."""
    return tx_channel(idx, cp_len, mod)
