"""The Monte-Carlo link over kernel G (port of ``sdr_tpu/link/mc.py``).

``mc_simulate`` runs ``iters`` passes of the one-kernel Monte-Carlo
link (``kernels/mc.py``), each with its own seed, and sums the
per-channel counts. Per pass the only device traffic is the channel ids
in and the (B,) counts out. Each pass draws on the fast engine's keyed
stream, so pass i is ``fast_simulate(cfg, seed_i)`` per channel, up to
decisions on near-zero LLRs (the JAX engine's MC stream is the TPU's
on-core PRNG and is validated only statistically).

Wideband SC-FDMA (n_fft ≥ 1024, where the kernel does not despread)
takes the staged route of the JAX module (mc.py:106-154): the fast
engine's ``fast_core`` per pass — the trivial single-carrier TX, the
staged channel and kernel C's ``despread`` count.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where the plain versions run; without a card they raise.
"""

from __future__ import annotations

import functools

import torch

from sdr_tpu_torch.core.config import LinkConfig
from sdr_tpu_torch.kernels import demod as _kc
from sdr_tpu_torch.kernels.mc import SUPPORTED_MODELS, mc_count, supported
from sdr_tpu_torch.link.fast import fast_core

_PASS_STRIDE = 0x9E3779B9 & 0x7FFFFFFF  # the JAX module's per-pass seed step (mc.py:67)


def _wrap_i32(v: int) -> int:
    """Two's-complement wrap to int32, as the JAX module's int32 seed arithmetic."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def pass_seed(seed: int, i: int) -> int:
    """Seed of pass i: seed + i·(0x9E3779B9 & 0x7FFFFFFF), wrapped to int32."""
    return _wrap_i32(int(seed) + i * _PASS_STRIDE)


def bits_per_pass(cfg: LinkConfig) -> int:
    """Bits counted per channel per pass (the CP carries no payload)."""
    return cfg.n_symbols * cfg.ofdm.n_fft * cfg.modulation.bits_per_symbol


def _check_overflow(cfg: LinkConfig, iters: int) -> None:
    if bits_per_pass(cfg) * iters >= 2**31:
        raise ValueError(
            f"iters={iters} overflows the int32 per-channel bit counter "
            f"({bits_per_pass(cfg)} bits/pass); accumulate across mc_simulate "
            "calls at the caller instead"
        )


def mc_simulate(cfg: LinkConfig, seed: int = 0, iters: int = 1, device="cuda",
                rand_inputs=None):
    """Run ``iters`` Monte-Carlo passes on ``device``; returns per-channel
    (bit_errors, bits_counted), both (n_channels,) int32.

    ``rand_inputs=(idx, nr, ni, hr, hi)`` replaces the draws of one pass
    (``kernels/mc.py``); it takes ``iters=1`` (the JAX module ran one pass
    and counted ``iters`` passes' bits). A config that neither the kernel
    nor the wideband SC-FDMA route runs raises ``ValueError``."""
    if not supported(cfg):
        if _fde_mc_supported(cfg) and rand_inputs is None:
            return _mc_scfdma_wideband(cfg, seed, iters, device)
        raise ValueError(f"mc_simulate does not support this config: {cfg}")
    _check_overflow(cfg, iters)
    if rand_inputs is not None and iters != 1:
        raise ValueError("rand_inputs fixes the draws of one pass: iters must be 1")
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    errs = mc_count(cfg, pass_seed(seed, 0), ch_ids, rand_inputs=rand_inputs)
    for i in range(1, iters):
        errs += mc_count(cfg, pass_seed(seed, i), ch_ids)
    counted = torch.full((cfg.n_channels,), bits_per_pass(cfg) * iters, dtype=torch.int32,
                         device=device)
    return errs, counted


def make_mc_fn(cfg: LinkConfig, iters: int = 1, device="cuda"):
    """mc_simulate with cfg, iters and device bound: fn(seed)."""
    return functools.partial(mc_simulate, cfg, iters=iters, device=device)


def _fde_mc_supported(cfg: LinkConfig) -> bool:
    """Wideband SC-FDMA Monte-Carlo: full-grid SC-FDMA at n_fft ≥ 1024,
    up to the n_fft kernel C's despread mode takes."""
    n = cfg.ofdm.n_fft
    return bool(
        cfg.dft_spread
        and 1024 <= n <= _kc.MAX_N_FFT
        and cfg.channel.model in SUPPORTED_MODELS
        and cfg.pilot_spacing == 0
        and cfg.mimo is None
        and not cfg.channel.impaired
        and not cfg.channel.has_pa
    )


def _mc_scfdma_wideband(cfg: LinkConfig, seed: int, iters: int, device):
    """Wideband uplink Monte-Carlo: the fast engine per pass, pass i keyed
    by (seed·1_000_003 + i) & 0x7FFFFFFF (the JAX route's fold)."""
    _check_overflow(cfg, iters)
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    errs = torch.zeros((cfg.n_channels,), dtype=torch.int32, device=device)
    for i in range(iters):
        e, _ = fast_core(cfg, (int(seed) * 1_000_003 + i) & 0x7FFFFFFF, ch_ids)
        errs += e
    counted = torch.full((cfg.n_channels,), bits_per_pass(cfg) * iters, dtype=torch.int32,
                         device=device)
    return errs, counted
