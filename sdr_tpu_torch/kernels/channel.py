"""Kernel E: the staged channel stage over an externally built waveform
(port of ``sdr_tpu/kernels/channel_pallas.py::fade_awgn_pallas`` and of
the FIR the JAX route runs before it, ``sdr_tpu/link/fast.py``'s staged
channel).

(B, S, L) planar float32 samples → FIR(x) + σ·n or x·h + σ·n,
σ = sqrt(noise_var/2) with ``noise_var`` the time-domain complex
variance; h an optional complex gain per link (``hr_s``/``hi_s`` of shape
(B, 1)) or per symbol ((B, S)); the FIR, exclusive with the gains, takes
planar taps ``taps_r``/``taps_i``, static (B, Lt) — each channel's whole
CP'd stream from zero history — or per symbol (B, S, Lt) — each symbol
with its own taps and the previous symbol's tail as history
(``ops.channel.grid_fir``), 1 ≤ Lt ≤ L + 1. ``history_r``/``history_i``
(B, Lt − 1) planes, with the FIR only, hold the clean samples that
precede row 0 (a time block's halo, ``link.stream``): they replace the
zero start of static taps and symbol 0's zero history of per-symbol
taps.

Noise modes, as kernel B's (``kernels/tx.py``):

- ``noise=(n_re, n_im)``: injected N(0, 1) planes of shape (B, S, L),
  for exact comparison with the plain version and the JAX kernel;
- ``seed`` and ``ch_ids``: keyed Philox, counter (ch_ids[b], s0 + s,
  sample, 0) on ``seed ^ ROLE_NOISE`` — kernel B's stream, so the staged
  and the fused channel routes of ``link.fast`` draw the same noise, and
  a time block whose first symbol is ``s0`` draws the rows of the whole
  frame's noise (the TPU kernel's per-128-block seeding is not carried
  over);
- neither: the channel alone.

On a CPU tensor the plain version (``fade_awgn_plain``) runs; on a CUDA
tensor the CUDA kernel (``csrc/channel.cu``) runs, or the call raises.
The FIR mode counts its launches under ``fade_awgn_fir``, the others
under ``fade_awgn``.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.kernels.tx import _noise_mode, _sigma
from sdr_tpu_torch.ops.channel import grid_fir


def _check_gains(hr_s, hi_s, B: int, S: int) -> int:
    """h_syms of a (B, 1 | S) gain pair (0 without gains); raises otherwise."""
    if hr_s is None:
        return 0
    if (hr_s.ndim != 2 or hr_s.shape[0] != B or hr_s.shape[1] not in (1, S)
            or hi_s.shape != hr_s.shape):
        raise ValueError(f"fade_awgn: gains must be (B, 1) or (B, S), got {tuple(hr_s.shape)}")
    return hr_s.shape[1]


def _check_taps(hr_s, taps_r, taps_i, B: int, S: int, L: int) -> bool:
    """Whether a tap pair is per symbol ((B, S, Lt)) or static ((B, Lt));
    raises on any other shape, on Lt outside [1, L + 1] and on gains
    given with taps."""
    if hr_s is not None:
        raise ValueError("fade_awgn: taps and gains are mutually exclusive")
    per_sym = taps_r.ndim == 3 and taps_r.shape[:2] == (B, S)
    if (not per_sym and not (taps_r.ndim == 2 and taps_r.shape[0] == B)) or (
            taps_i.shape != taps_r.shape):
        raise ValueError(f"fade_awgn: taps must be (B, Lt) or (B, S, Lt), got "
                         f"{tuple(taps_r.shape)}")
    if not 1 <= taps_r.shape[-1] <= L + 1:
        raise ValueError(f"fade_awgn: {taps_r.shape[-1]} taps, rows of {L} samples take 1 to "
                         f"{L + 1}")
    return per_sym


def _check_history(history_r, history_i, taps_r, B: int) -> None:
    """History planes go with the FIR, (B, Lt − 1) each."""
    if history_r is None and history_i is None:
        return
    if taps_r is None:
        raise ValueError("fade_awgn: history planes go with the FIR taps")
    shape = (B, taps_r.shape[-1] - 1)
    if history_r is None or history_i is None or tuple(history_r.shape) != shape or (
            tuple(history_i.shape) != shape):
        raise ValueError(f"fade_awgn: history planes must both be {shape}")


def fade_awgn_plain(re, im, hr_s=None, hi_s=None, noise_var: float = 0.0, noise=None,
                    seed=None, ch_ids=None, taps_r=None, taps_i=None, s0: int = 0,
                    history_r=None, history_i=None):
    """Plain torch version (same arguments and modes as ``fade_awgn``):
    ``grid_fir`` over the complex stream from the history, then the gains
    and the noise."""
    mode = _noise_mode(noise, seed, ch_ids)
    B, S, L = re.shape
    _check_gains(hr_s, hi_s, B, S)
    _check_history(history_r, history_i, taps_r, B)
    yr, yi = re, im
    if taps_r is not None:
        _check_taps(hr_s, taps_r, taps_i, B, S, L)
        hist = None if history_r is None else torch.complex(history_r, history_i)
        y = grid_fir(torch.complex(re, im), torch.complex(taps_r, taps_i), hist)
        yr, yi = y.real, y.imag
    if hr_s is not None:
        fr = hr_s[:, :, None]
        fi = hi_s[:, :, None]
        yr, yi = re * fr - im * fi, re * fi + im * fr
    if mode == 0:
        return yr.contiguous(), yi.contiguous()
    if mode == 1:
        n_re, n_im = noise
    else:
        n_re, n_im = prng.normal_pair(seed, prng.ROLE_NOISE, ch_ids, (S, L), i0=s0)
    sigma = _sigma(noise_var)
    return yr + sigma * n_re, yi + sigma * n_im


def fade_awgn(re, im, hr_s=None, hi_s=None, noise_var: float = 0.0, noise=None, seed=None,
              ch_ids=None, taps_r=None, taps_i=None, s0: int = 0, history_r=None,
              history_i=None):
    """Faded (or filtered), noisy planes (out_re, out_im), each (B, S, L)
    float32. ``s0``: the first symbol's index in the frame (keyed noise);
    ``history_r``/``history_i``: the FIR's history before row 0."""
    mode = _noise_mode(noise, seed, ch_ids)
    if s0 < 0:
        raise ValueError(f"fade_awgn: s0 must be >= 0, got {s0}")
    if re.device.type == "cpu":
        return fade_awgn_plain(re, im, hr_s, hi_s, noise_var, noise, seed, ch_ids, taps_r,
                               taps_i, s0, history_r, history_i)
    if re.ndim != 3 or im.shape != re.shape:
        raise ValueError(
            f"fade_awgn kernel: samples must be a (B, S, L) pair, got {tuple(re.shape)}")
    B, S, L = re.shape
    h_syms = _check_gains(hr_s, hi_s, B, S)
    _check_history(history_r, history_i, taps_r, B)
    fir = taps_r is not None
    per_sym = fir and _check_taps(hr_s, taps_r, taps_i, B, S, L)
    operands = [re, im]
    if h_syms:
        operands += [hr_s, hi_s]
    if fir:
        operands += [taps_r, taps_i]
    if history_r is not None:
        operands += [history_r, history_i]
    if mode == 1:
        if any(n.shape != re.shape for n in noise):
            raise ValueError(f"fade_awgn kernel: noise planes must be {tuple(re.shape)}")
        operands += list(noise)
    if any(t.dtype != torch.float32 for t in operands):
        raise ValueError("fade_awgn kernel: samples, gains, taps and noise must be float32")
    if mode == 2:
        if ch_ids.shape != (B,) or ch_ids.dtype != torch.int32:
            raise ValueError("fade_awgn kernel: ch_ids must be int32 (B,)")
        operands.append(ch_ids)
    _lib.require_cuda("fade_awgn", *operands)
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(im)
    k0, k1 = prng.split_key(seed, prng.ROLE_NOISE) if mode == 2 else (0, 0)
    rc = _lib.lib().sdr_fade_awgn(
        re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), B, S, L,
        _lib.ptr(hr_s), _lib.ptr(hi_s), h_syms, _lib.ptr(taps_r), _lib.ptr(taps_i),
        taps_r.shape[-1] if fir else 0, int(per_sym), _lib.ptr(history_r),
        _lib.ptr(history_i), s0, mode,
        _lib.ptr(noise[0]) if mode == 1 else None,
        _lib.ptr(noise[1]) if mode == 1 else None,
        _lib.ptr(ch_ids) if mode == 2 else None,
        k0, k1, _sigma(noise_var), _lib.stream(),
    )
    _lib.check(rc, "fade_awgn")
    _lib.LAUNCHES["fade_awgn_fir" if fir else "fade_awgn"] += 1
    return out_re, out_im
