"""Kernel G: one Monte-Carlo pass of the whole link in one kernel (port
of ``sdr_tpu/kernels/mc_pallas.py::mc_count_pallas``, n_fft 128–512,
and ``::_mc_count_fourstep``, n_fft 1024–4096: one CUDA kernel serves
both, ``csrc/mc.cuh`` says why). A group of G warps holds a symbol in
registers (one warp up to N 512, 4–16 points a lane; 2, 4 and 8 warps of
16 points a lane at N 1024, 2048 and 4096), its DFTs run across the
lanes by shuffles with no bit-reversal pass, and a block draws its
channel's state once.

Per channel and symbol: indices → Gray map → [SC-FDMA: spread, a
forward DFT scaled by N^-1/2] → ×H per subcarrier → inverse DFT (1/N) →
+ σ·n over the N payload samples only, σ = √(nv/N/2) → DFT → the
unbiased one-tap MMSE (OFDM) or the SC-FDE despread
(``ops.equalize.equalize_mmse_fde``) → max-log LLR → hard-decision
errors against the indices → per-channel (B,) int32 counts.

Keyed mode: nothing but the seed and the global channel ids goes in.
Every draw is the fast engine's (``link/fast.py``): the payload in
kernel A's layout (four indices per Philox call, word n mod 4 of
counter (ch, s, n div 4, 0); the stream changed with that layout, so
BER figures before and after it are different draws), the fading on ``ops/channel.py``'s ``ROLE_FADING``
lanes, the noise of time sample n on kernel B's counter at sample
cp + n. With CP ≥ L−1 the per-subcarrier channel here and the fast
engine's time-domain channel are the same map, so a keyed pass equals
``fast_simulate(cfg, seed)`` per channel, up to decisions on near-zero
LLRs — an exact check of the whole stream, where the JAX MC kernel
(on-core PRNG) is validated only statistically.

Injected mode, ``rand_inputs=(idx, nr, ni, hr, hi)`` (mc_pallas.py:
242-247): idx (B, S, N) indices, nr/ni (B, S, N) N(0, 1) planes, hr/hi
(B, 1 | S, N) float32 response planes (read for the fading models,
ignored for AWGN and IDENTITY) replace the draws.

On CPU tensors the plain version (``mc_count_plain``, the JAX test
oracle of tests/test_mc.py:44-83 written in torch) runs; on CUDA tensors
the kernel runs, or the call raises ``ValueError``.
"""

from __future__ import annotations

import math

import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.core.config import ChannelModel, LinkConfig, Modulation
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.kernels.demod import count_errors
from sdr_tpu_torch.link.fast import _PER_SYMBOL, draw_idx, fade_state, noise_var
from sdr_tpu_torch.ops.channel import _pdp_amps
from sdr_tpu_torch.ops.equalize import equalize_mmse, equalize_mmse_fde
from sdr_tpu_torch.ops.fft import fft, ifft
from sdr_tpu_torch.ops.llr import llr_maxlog
from sdr_tpu_torch.ops.modulation import constellation

SUPPORTED_MODELS = (
    ChannelModel.IDENTITY,
    ChannelModel.AWGN,
    ChannelModel.RAYLEIGH_FLAT,
    ChannelModel.MULTIPATH,
    ChannelModel.RAYLEIGH_TIME,
    ChannelModel.RICIAN,
    ChannelModel.MULTIPATH_TIME,
)
MIN_N_FFT, MAX_N_FFT = 128, 4096  # the TPU kernels' range; at least 4 points a lane here
MAX_SPREAD_N_FFT = 256  # SC-FDMA in the kernel (mc_pallas.py:102); wider: link/mc.py's route
_FADING = (ChannelModel.RAYLEIGH_FLAT, ChannelModel.RICIAN, ChannelModel.RAYLEIGH_TIME,
           ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME)
# Channel kinds of csrc/mc.cu.
_KIND = {ChannelModel.IDENTITY: 0, ChannelModel.AWGN: 0, ChannelModel.RAYLEIGH_FLAT: 1,
         ChannelModel.RICIAN: 2, ChannelModel.RAYLEIGH_TIME: 3, ChannelModel.MULTIPATH: 4,
         ChannelModel.MULTIPATH_TIME: 5}
_KIND_PLANE = 6


def supported(cfg: LinkConfig) -> bool:
    """What the kernel runs (mc_pallas.py:87-116 in the port's terms: no
    VMEM tile rule): a supported channel model with genie CSI, no pilots,
    MIMO, CFO, timing offset or PA, n_fft a power of two in [128, 4096],
    SC-FDMA at n_fft ≤ 256."""
    n = cfg.ofdm.n_fft
    ch = cfg.channel
    return (
        ch.model in SUPPORTED_MODELS
        and cfg.pilot_spacing == 0
        and cfg.mimo is None
        and ch.cfo_subcarriers == 0.0
        and ch.timing_offset == 0
        and not ch.has_pa
        and MIN_N_FFT <= n <= MAX_N_FFT
        and (n & (n - 1)) == 0
        and (not cfg.dft_spread or n <= MAX_SPREAD_N_FFT)
    )


def h_syms(cfg: LinkConfig) -> int:
    """Symbols of the response plane: S for the per-symbol models, else 1."""
    return cfg.n_symbols if cfg.channel.model in _PER_SYMBOL else 1


def _keyed_inputs(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor):
    """The keyed draws as planes: the fast engine's indices, response
    plane and the noise of the N payload samples (counter cp + n)."""
    S, N, cp = cfg.n_symbols, cfg.ofdm.n_fft, cfg.ofdm.cp_len
    idx = draw_idx(cfg, seed, ch_ids)
    nr, ni = prng.normal_pair(seed, prng.ROLE_NOISE, ch_ids, (S, N + cp))
    h, _ = fade_state(cfg, seed, ch_ids)
    return idx, nr[..., cp:], ni[..., cp:], h


def mc_llr_plain(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, rand_inputs=None):
    """The plain pass up to the LLRs: (llr (B, S, N·bps) float32,
    idx (B, S, N)) — the count's plain version, and the margin of
    near-zero LLRs the comparisons with the kernel allow."""
    mod, model = cfg.modulation, cfg.channel.model
    N = cfg.ofdm.n_fft
    nv = noise_var(cfg)
    if rand_inputs is None:
        idx, nr, ni, h = _keyed_inputs(cfg, seed, ch_ids)
    else:
        idx, nr, ni, hr, hi = rand_inputs
        h = torch.complex(hr.to(torch.float32), hi.to(torch.float32))
    x = constellation(mod, ch_ids.device)[idx.to(torch.int64)]
    if cfg.dft_spread:
        x = fft(x) * N ** -0.5
    h_eq = torch.ones((1, 1, 1), dtype=torch.complex64, device=x.device)
    if model in _FADING:
        x = x * h
        h_eq = h
    xt = ifft(x)
    if model != ChannelModel.IDENTITY:
        xt = xt + torch.complex(nr.to(torch.float32), ni.to(torch.float32)) * math.sqrt(nv / N / 2)
    y = fft(xt)
    eq = equalize_mmse_fde if cfg.dft_spread else equalize_mmse
    s, eff = eq(y, h_eq, nv)
    return llr_maxlog(s, mod, eff), idx


def mc_count_plain(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, rand_inputs=None):
    """Plain torch version of one pass: per-channel (B,) int32 errors."""
    llr, idx = mc_llr_plain(cfg, seed, ch_ids, rand_inputs)
    return count_errors(llr, idx, cfg.modulation.bits_per_symbol)


def _check_inputs(cfg: LinkConfig, ch_ids: torch.Tensor, rand_inputs):
    B, S, N = ch_ids.shape[0], cfg.n_symbols, cfg.ofdm.n_fft
    idx, nr, ni, hr, hi = rand_inputs
    ok = (idx.shape == (B, S, N) and idx.dtype == torch.int32
          and all(t.shape == (B, S, N) and t.dtype == torch.float32 for t in (nr, ni)))
    if cfg.channel.model in _FADING:
        ok = ok and all(t.shape == (B, h_syms(cfg), N) and t.dtype == torch.float32
                        for t in (hr, hi))
    if not ok:
        raise ValueError(f"mc kernel: rand_inputs must be int32 idx and float32 noise (B, S, N) "
                         f"= {(B, S, N)} and response planes (B, {h_syms(cfg)}, N)")
    return [idx, nr, ni] + ([hr, hi] if cfg.channel.model in _FADING else [])


def mc_count(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, rand_inputs=None):
    """One Monte-Carlo pass over the channels ``ch_ids`` (B,) int32, each
    of ``cfg.n_symbols`` symbols: per-channel (B,) int32 bit errors (bits
    counted per channel: n_symbols · n_fft · bits_per_symbol)."""
    if ch_ids.ndim != 1:
        raise ValueError(f"ch_ids must be 1-D, got {tuple(ch_ids.shape)}")
    if ch_ids.device.type == "cpu":
        return mc_count_plain(cfg, seed, ch_ids, rand_inputs)
    if not supported(cfg):
        raise ValueError(f"mc kernel does not run this config: {cfg}")
    if ch_ids.dtype != torch.int32:
        raise ValueError(f"mc kernel: ch_ids must be int32, got {ch_ids.dtype}")
    model, mod = cfg.channel.model, cfg.modulation
    B, N = ch_ids.shape[0], cfg.ofdm.n_fft
    idx_in = n_re = n_im = h_re = h_im = None
    kind = _KIND[model]
    if rand_inputs is not None:
        idx_in, n_re, n_im, *planes = _check_inputs(cfg, ch_ids, rand_inputs)
        h_re, h_im = planes if planes else (None, None)
        kind = _KIND_PLANE if planes else 0
    n_taps = len(cfg.channel.pdp) if kind in (_KIND[ChannelModel.MULTIPATH],
                                              _KIND[ChannelModel.MULTIPATH_TIME]) else 0
    amps = _pdp_amps(cfg.channel.pdp, ch_ids.device) if n_taps else None
    _lib.require_cuda("mc_count", *(t for t in (ch_ids, idx_in, n_re, n_im, h_re, h_im, amps)
                                    if t is not None))
    out = torch.zeros((B,), dtype=torch.int32, device=ch_ids.device)
    twr, twi = _lib.twiddles(N, ch_ids.device)
    nv = noise_var(cfg)
    K = float(cfg.channel.k_factor)
    norm = mod.unit_energy_scale
    keys = [k for role in (prng.ROLE_PAYLOAD, prng.ROLE_NOISE, prng.ROLE_FADING)
            for k in prng.split_key(seed, role)]
    p = _lib.McParams(
        ch_ids.data_ptr(), out.data_ptr(), *(_lib.ptr(t) for t in (idx_in, n_re, n_im, h_re, h_im,
                                                                    amps, twr, twi)),
        B, cfg.n_symbols, _lib.log2_exact(N), cfg.ofdm.cp_len, 0, 0, kind, n_taps,
        h_syms(cfg), int(model != ChannelModel.IDENTITY),
        *keys, (1 << mod.bits_per_symbol) - 1,
        math.sqrt(nv / N / 2.0), max(nv, 1e-12), 1.0 / max(nv, 1e-12),
        (1.0 if cfg.dft_spread else norm) / N, norm / math.sqrt(N),
        math.sqrt(K / (K + 1.0)), math.sqrt(1.0 / (K + 1.0) * 0.5),
        2.0 * math.pi * float(cfg.channel.doppler_norm or 0.0),
    )
    rc = _lib.lib().sdr_mc_count(p, mod.bits_per_axis, int(mod is Modulation.BPSK),
                                 int(cfg.dft_spread), _lib.axis_tables(mod), _lib.stream())
    _lib.check(rc, "mc_count")
    _lib.LAUNCHES["mc_count"] += 1
    return out
