"""Fast batched link: keyed payload → fused TX + channel → fused RX count.

Port of ``sdr_tpu/link/fast.py`` (the keyed fast engine) for the
flat-channel rows path. The whole link runs at batch level on
(n_channels, n_symbols, ·) planes:

    payload draw (kernel A) → Gray map, IDFT, CP, flat gain, AWGN
    (kernel B) → CP strip, DFT, equalize, max-log LLR, error count
    (kernel C)

Every random draw is keyed Philox (``core/prng.py``), a pure function of
(seed, role, global channel id, position): the TX side and the RX
side's recompute draw the same payload and fading independently, and
the result for a channel does not depend on the batch it runs in
(channels [0, k) alone give the same counts as in the full run).

The BER is validated statistically against the exact theory
(``link/ber.py``), as the JAX engine's is; it is a different stream
from the JAX engine's threefry and on-core draws.

Covered: channel models IDENTITY, AWGN, RAYLEIGH_FLAT and RICIAN, in the
rows layout. The rest raise ``NotImplementedError`` naming the ROADMAP
entry that ports them.
"""

from __future__ import annotations

import functools

import torch

from sdr_tpu_torch.core.config import ChannelModel, LinkConfig
from sdr_tpu_torch.kernels.payload import payload_idx
from sdr_tpu_torch.kernels.tx import tx_channel
from sdr_tpu_torch.ops import channel as chan
from sdr_tpu_torch.ops.demod import demod_count_chain

_FLAT = (ChannelModel.IDENTITY, ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT,
         ChannelModel.RICIAN)


def check_supported(cfg: LinkConfig, layout: str = "rows") -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.pilot_spacing:
        raise NotImplementedError(
            "fast_simulate is the full-grid throughput path; pilot-based "
            "estimation is ported with link.pipeline (ROADMAP queue 1, item 11)"
        )
    if cfg.mimo is not None:
        raise NotImplementedError(
            "fast_simulate is SISO; MIMO is ported with link.pipeline "
            "(ROADMAP queue 1, item 11)"
        )
    if cfg.dft_spread:
        raise NotImplementedError(
            "SC-FDMA (dft_spread) is ported with the wideband and SC-FDE "
            "routes (ROADMAP queue 1, item 10)"
        )
    if cfg.channel.model not in _FLAT:
        raise NotImplementedError(
            f"channel model {cfg.channel.model.value} needs the FIR-taps TX mode "
            "and the taps= count mode (ROADMAP queue 1, item 7; queue 2)"
        )
    if layout not in ("auto", "rows"):
        raise NotImplementedError(
            "the channels-last fast engine (layout='cl') needs the count kernel "
            "demod_count_cl (ROADMAP queue 2)"
        )


def noise_var(cfg: LinkConfig) -> float:
    """Subcarrier noise variance nv = 1/(Eb/N0 · bps), a host float."""
    return 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * cfg.modulation.bits_per_symbol)


def draw_idx(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor) -> torch.Tensor:
    """Per-channel transmitted symbol indices (B, S, N), int8 (bps ≤ 7)
    or int16 — kernel A on the card."""
    return payload_idx(cfg.n_symbols, cfg.ofdm.n_fft, cfg.modulation.bits_per_symbol,
                       seed, ch_ids)


def fade_state(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor):
    """Per-channel flat gain h (B, 1, 1) complex64, or None (no fading)."""
    model = cfg.channel.model
    if model == ChannelModel.RAYLEIGH_FLAT:
        return chan.rayleigh_flat(seed, ch_ids)
    if model == ChannelModel.RICIAN:
        return chan.rician_flat(seed, ch_ids, cfg.channel.k_factor)
    return None


def tx_with_channel(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, idx: torch.Tensor,
                    h: torch.Tensor | None = None, noise=None):
    """TX + channel over explicit indices → impaired planar (re, im),
    each (B, S, N+cp) float32, in one fused pass (kernel B).

    ``h`` overrides the keyed fade state with explicit per-channel gains
    (B, 1, 1) complex; ``noise`` injects (n_re, n_im) N(0, 1) planes in
    place of the keyed noise — the injection form the parity tests use.
    """
    check_supported(cfg)
    model = cfg.channel.model
    if h is None:
        h = fade_state(cfg, seed, ch_ids)
    hs_r = hs_i = None
    if h is not None:
        hs_r = h.real.reshape(-1).to(torch.float32).contiguous()
        hs_i = h.imag.reshape(-1).to(torch.float32).contiguous()
    if model == ChannelModel.IDENTITY:
        return tx_channel(idx, cfg.ofdm.cp_len, cfg.modulation, hs_r, hs_i)
    tvar = noise_var(cfg) / cfg.ofdm.n_fft
    if noise is not None:
        return tx_channel(idx, cfg.ofdm.cp_len, cfg.modulation, hs_r, hs_i, tvar, noise=noise)
    return tx_channel(idx, cfg.ofdm.cp_len, cfg.modulation, hs_r, hs_i, tvar,
                      seed=seed, ch_ids=ch_ids)


def tx_channel_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor):
    """Payload draw + TX + channel for explicit global channel ids."""
    return tx_with_channel(cfg, seed, ch_ids, draw_idx(cfg, seed, ch_ids))


def rx_count_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, re: torch.Tensor,
                  im: torch.Tensor, h: torch.Tensor | None = None,
                  idx: torch.Tensor | None = None):
    """Demod + error count over impaired planar samples.

    Recomputes the channel gains and the transmitted indices from the
    keys (both pure functions of them) unless given explicitly, so the
    samples are the only data taken from the TX side. Returns
    per-channel (bit_errors, bits_counted), both (B,) int32."""
    check_supported(cfg)
    B = ch_ids.shape[0]
    S, N = cfg.n_symbols, cfg.ofdm.n_fft
    bps = cfg.modulation.bits_per_symbol
    if h is None:
        h = fade_state(cfg, seed, ch_ids)
    if idx is None:
        idx = draw_idx(cfg, seed, ch_ids)
    if h is None:
        hr = torch.ones((B, 1, N), dtype=torch.float32, device=re.device)
        hi = torch.zeros((B, 1, N), dtype=torch.float32, device=re.device)
    else:
        hb = h.reshape(B, 1, 1).to(torch.complex64)
        hr = hb.real.expand(B, 1, N).contiguous()
        hi = hb.imag.expand(B, 1, N).contiguous()
    errors = demod_count_chain(re, im, hr, hi, idx, cfg.ofdm.cp_len, cfg.modulation,
                               max(noise_var(cfg), 1e-12))
    counted = torch.full((B,), S * N * bps, dtype=torch.int32, device=re.device)
    return errors, counted


def fast_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, layout: str = "auto"):
    """The batched link over explicit GLOBAL channel ids (B,) int32 on
    the target device. Returns per-channel (bit_errors, bits_counted).

    The payload and the fading are drawn once and handed to both sides;
    ``rx_count_core``'s own recompute (the same bits) serves callers
    that run the two sides apart."""
    check_supported(cfg, layout)
    idx = draw_idx(cfg, seed, ch_ids)
    h = fade_state(cfg, seed, ch_ids)
    re, im = tx_with_channel(cfg, seed, ch_ids, idx, h=h)
    return rx_count_core(cfg, seed, ch_ids, re, im, h=h, idx=idx)


def fast_simulate(cfg: LinkConfig, seed: int, device="cpu", layout: str = "auto"):
    """Full link over (n_channels, n_symbols) as one batched program on
    ``device``. Returns (bit_errors (n_channels,) int32, bits_counted)."""
    check_supported(cfg, layout)
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    return fast_core(cfg, seed, ch_ids, layout=layout)


def make_fast_fn(cfg: LinkConfig, device="cpu", layout: str = "auto"):
    """fast_simulate with cfg and device bound: fn(seed)."""
    check_supported(cfg, layout)
    return functools.partial(fast_simulate, cfg, device=device, layout=layout)
