"""Kernel B: fused TX + channel (port of
``sdr_tpu/kernels/tx_pallas.py::tx_channel_chain_pallas`` and of
``tx_chain_pallas``).

Symbol indices (B, S, N) → Gray map → N-point inverse DFT (1/N and the
unit-energy norm folded in) → cyclic prefix → the channel → optional
noise σ·n on every sample of the CP'd symbol, σ = sqrt(noise_var/2),
where ``noise_var`` is the TIME-domain complex variance (the fast link's
``tvar = nv/N``). Returns planar float32 (re, im), each (B, S, N+cp).

Channel modes (mutually exclusive, as in the TPU kernel):

- ``hs_r``/``hs_i``: complex scalar gains, per link ((B,) or (B, 1)) or
  per symbol ((B, S));
- ``taps_r``/``taps_i``: a causal FIR, y[u] = Σ_l tap_l·x[u−l], with at
  most 16 taps: static (B, L), the zero-history convolution of each
  channel's whole CP'd stream (``ops.channel.apply_multipath``), or per
  symbol (B, S, L), each symbol through its own taps with the previous
  symbol's tail as history (``ops.channel.symbol_history``).

Noise modes:

- ``noise=(n_re, n_im)``: injected N(0, 1) planes of shape (B, S, N+cp)
  — for exact comparison with the plain version and with the JAX
  kernels, which draw from another stream;
- ``seed`` and ``ch_ids``: keyed Philox, counter (ch_ids[b], s, sample,
  0) on ``seed ^ ROLE_NOISE``, Box–Muller on words 0 and 1;
- neither: channel off (``tx_chain``), the waveform alone.

The pilot comb (``pilot_spacing`` in [2, N], any mode but the FIR; 0 off):
tone k with k % pilot_spacing == 0 carries ``ops.pilots.PILOT_VALUE``
in place of its index's point (the index plane stays (B, S, N); its
entries at the pilot tones are not read), as ``ops.pilots.insert_pilots``
lays out the grid of the JAX ``tx_chain``. It counts its launches under
``tx_comb``.

At N = 128 to 4096 the kernel runs its warp-group form
(``csrc/tx_rows.cuh``: a symbol in the registers of 1–8 warps, the
inverse DFT by shuffles, a block a run of 32 symbols of one channel), which
also serves the JAX package's wideband TX
(``fourstep_tx_split_pallas.py::tx_chain_fourstep2``,
``fourstep_tx_pallas.py::tx_chain_fourstep``) in place of their N1·N2
matmul split; N = 2 to 64 runs a shared-memory tile.

On a CPU tensor the plain version (``tx_channel_plain``) runs; on a
CUDA tensor the CUDA kernel runs (``csrc/tx.cu`` without the FIR,
``csrc/tx_fir.cu`` with it), or the call raises. The FIR mode counts its
launches under ``tx_taps``, the pilot comb under ``tx_comb``, the
channel-off mode (``tx_chain``: no gain, no FIR, no noise) under
``tx_off``, the others under ``tx``.
"""

from __future__ import annotations

import math

import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.ops.channel import grid_fir
from sdr_tpu_torch.ops.modulation import constellation
from sdr_tpu_torch.ops.ofdm import ofdm_tx
from sdr_tpu_torch.ops.pilots import PILOT_VALUE, pilot_indices

_IDX_DTYPES = (torch.int8, torch.int16, torch.int32)
MAX_N_FFT = 4096  # the widest plan of the warp-group form (8 warps of 16 points a lane)
MAX_TAPS = 16  # the FIR's tap budget (the TPU kernel's, fast.py:283-291)


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


def _gain_syms(hs_r, B: int, S: int) -> int:
    """1 for per-link gains ((B,) or (B, 1)), S for per-symbol (B, S)."""
    if hs_r.numel() == B and (hs_r.ndim == 1 or hs_r.shape == (B, 1)):
        return 1
    if hs_r.shape == (B, S):
        return S
    raise ValueError(f"tx: gains must be (B,), (B, 1) or (B, S), got {tuple(hs_r.shape)}")


def _taps_shape(taps_r, B: int, S: int) -> bool:
    """Whether (B, L) static or (B, S, L) per-symbol taps; raises otherwise."""
    if taps_r.ndim == 2 and taps_r.shape[0] == B:
        return False
    if taps_r.ndim == 3 and taps_r.shape[:2] == (B, S):
        return True
    raise ValueError(f"tx: taps must be (B, L) or (B, S, L), got {tuple(taps_r.shape)}")


def _check_comb(pilot_spacing: int, n_fft: int, taps_r) -> None:
    if pilot_spacing and not 2 <= pilot_spacing <= n_fft:
        raise ValueError(f"tx: pilot_spacing must be 0 or in [2, {n_fft}], got {pilot_spacing}")
    if pilot_spacing and taps_r is not None:
        raise ValueError("tx: the pilot comb does not run with the FIR")


def tx_channel_plain(idx, cp_len: int, mod: Modulation, hs_r=None, hs_i=None,
                     noise_var: float = 0.0, noise=None, seed=None, ch_ids=None,
                     taps_r=None, taps_i=None, pilot_spacing: int = 0):
    """Plain torch version (same arguments and modes as ``tx_channel``)."""
    mode = _noise_mode(noise, seed, ch_ids)
    if hs_r is not None and taps_r is not None:
        raise ValueError("tx: taps and scalar gains are mutually exclusive")
    B, S, N = idx.shape
    _check_comb(pilot_spacing, N, taps_r)
    pts = constellation(mod, idx.device)[idx.to(torch.int64)]
    if pilot_spacing:
        pts[..., list(pilot_indices(N, pilot_spacing))] = PILOT_VALUE
    x = ofdm_tx(pts, cp_len)
    if taps_r is not None:
        _taps_shape(taps_r, B, S)
        x = grid_fir(x, torch.complex(taps_r.to(torch.float32), taps_i.to(torch.float32)))
    yr, yi = x.real, x.imag
    if hs_r is not None:
        h_syms = _gain_syms(hs_r, B, S)
        fr = hs_r.reshape(B, h_syms, 1)
        fi = hs_i.reshape(B, h_syms, 1)
        yr, yi = yr * fr - yi * fi, yr * fi + yi * fr
    if mode == 0:
        return yr.contiguous(), yi.contiguous()
    if mode == 1:
        n_re, n_im = noise
    else:
        n_re, n_im = prng.normal_pair(seed, prng.ROLE_NOISE, ch_ids, (S, yr.shape[-1]))
    sigma = _sigma(noise_var)
    return yr + sigma * n_re, yi + sigma * n_im


def tx_channel(idx, cp_len: int, mod: Modulation, hs_r=None, hs_i=None,
               noise_var: float = 0.0, noise=None, seed=None, ch_ids=None,
               taps_r=None, taps_i=None, pilot_spacing: int = 0):
    """Fused TX + channel over explicit indices.

    idx (B, S, N) int8/int16/int32; hs_r/hs_i float32 gains (B,), (B, 1)
    or (B, S), or None; taps_r/taps_i float32 FIR taps (B, L) or
    (B, S, L), L ≤ 16, or None; see the module docstring for the noise
    modes and the pilot comb. Returns (re, im) (B, S, N+cp) float32."""
    mode = _noise_mode(noise, seed, ch_ids)
    if idx.device.type == "cpu":
        return tx_channel_plain(idx, cp_len, mod, hs_r, hs_i, noise_var, noise, seed, ch_ids,
                                taps_r, taps_i, pilot_spacing)
    if not supported(idx.shape, cp_len, mod):
        raise ValueError(f"tx kernel: unsupported shape {tuple(idx.shape)} cp={cp_len}")
    if idx.dtype not in _IDX_DTYPES:
        raise ValueError(f"tx kernel: indices must be int8/16/32, got {idx.dtype}")
    if hs_r is not None and taps_r is not None:
        raise ValueError("tx: taps and scalar gains are mutually exclusive")
    B, S, N = idx.shape
    _check_comb(pilot_spacing, N, taps_r)
    if N >= 128 and idx.data_ptr() % 16:
        raise ValueError("tx kernel: the index plane must start 16-byte aligned (cp.async rows)")
    L = N + cp_len
    operands = [idx]
    h_syms = 0
    if hs_r is not None:
        h_syms = _gain_syms(hs_r, B, S)
        if hs_i.shape != hs_r.shape:
            raise ValueError("tx kernel: hs_r and hs_i shapes differ")
        operands += [hs_r, hs_i]
    if taps_r is not None:
        per_sym = _taps_shape(taps_r, B, S)
        n_taps = taps_r.shape[-1]
        if taps_i.shape != taps_r.shape or not 1 <= n_taps <= MAX_TAPS or n_taps - 1 > L:
            raise ValueError(f"tx kernel: unsupported taps {tuple(taps_r.shape)} (at most "
                             f"{MAX_TAPS} taps)")
        operands += [taps_r, taps_i]
    if any(t.dtype != torch.float32 for t in operands[1:]):
        raise ValueError("tx kernel: gains and taps must be float32")
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
    common = (idx.data_ptr(), idx.element_size(), out_re.data_ptr(), out_im.data_ptr(),
              B, S, _lib.log2_exact(N), cp_len, mod.bits_per_axis,
              int(mod is Modulation.BPSK), mod.unit_energy_scale / N,
              twr.data_ptr(), twi.data_ptr())
    noise_args = (mode,
                  _lib.ptr(noise[0]) if mode == 1 else None,
                  _lib.ptr(noise[1]) if mode == 1 else None,
                  _lib.ptr(ch_ids) if mode == 2 else None,
                  k0, k1, _sigma(noise_var), _lib.stream())
    if taps_r is None:
        counter = "tx_comb" if pilot_spacing else (
            "tx_off" if hs_r is None and mode == 0 else "tx")
        p_r, p_i = (PILOT_VALUE.real / mod.unit_energy_scale,
                    PILOT_VALUE.imag / mod.unit_energy_scale)
        rc = _lib.lib().sdr_tx(*common, _lib.ptr(hs_r), _lib.ptr(hs_i), h_syms, *noise_args[:-1],
                               pilot_spacing, p_r, p_i, noise_args[-1])
        _lib.check(rc, counter)
        _lib.LAUNCHES[counter] += 1
    else:
        rc = _lib.lib().sdr_tx_fir(*common, taps_r.data_ptr(), taps_i.data_ptr(), n_taps,
                                   int(per_sym), *noise_args)
        _lib.check(rc, "tx_taps")
        _lib.LAUNCHES["tx_taps"] += 1
    return out_re, out_im


def tx_chain(idx, cp_len: int, mod: Modulation, pilot_spacing: int = 0):
    """The waveform alone (channel off): ``tx_chain_pallas``'s contract;
    with ``pilot_spacing``, the comb of ``ops.pilots.insert_pilots``."""
    return tx_channel(idx, cp_len, mod, pilot_spacing=pilot_spacing)
