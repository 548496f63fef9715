"""End-to-end link pipeline: bits → TX → channel → RX → LLR → BER.

Port of ``sdr_tpu/link/pipeline.py`` (ROADMAP queue 1, items 11a, 11c,
11d and 11e): ``LinkResult``, ``generate_bits``, ``tx_chain``,
``apply_channel`` (the seven channel models of ``_apply_channel_model``,
with the PA before and the LO walk and I/Q mismatch after them),
``rx_chain``'s genie, pilot and front-end branches, the acquired link
(``_simulate_one_acquired``), ``simulate`` and ``make_simulate_fn``. The
whole link runs at batch level on (n_channels, n_symbols, ·) planes, and
on the card through the port's kernels wherever one computes the same
function (the JAX pipeline has no Pallas kernel; the port's rules keep the
plain versions of the kernels off the card):

    payload draw (kernel A) → Gray map, IDFT, CP (kernel B, channel off;
    SC-FDMA: ``link.fast.scfdma_tx``) → fading draws (``link.fast.
    fading_at``) → FIR or gains, then AWGN (kernel E, one launch) →
    CP strip, DFT, equalise, max-log LLR (kernel C)

- The payload bits are kernel A's indices in ``modulate``'s order (I bits
  then Q bits, MSB first), so ``simulate`` draws the payload of
  ``link.fast.fast_simulate`` and, for the MMSE links, counts the same
  errors on the same seed.
- The receive: kernel C (the LLR plane, or the count when no LLRs are
  asked for; SC-FDMA through C's despread modes). OFDM ZF is C's one-tap
  tail, as MMSE is; where the JAX receiver skips the equaliser (h None:
  AWGN, IDENTITY; and NONE) C takes a unit h, as ``link.fast.
  rx_count_core`` does. Plain torch (``ops/equalize.py``, ``ops/llr.py``)
  keeps what no kernel computes: the SC-FDMA ZF despread, and the
  unequalised SC-FDMA LLRs at a noise variance below 1e-2, where C's
  despread no longer resolves the SINR (IDENTITY's among them).
- The noise variance follows the JAX receiver: the Eb/N0 variance, 0 for
  IDENTITY, floored at 1e-12 (so IDENTITY's LLRs reach about 1e12, with
  their signs).
- Pilots (``cfg.pilot_spacing``, ``ops/pilots.py``). OFDM comb: kernel B
  puts ``PILOT_VALUE`` on every spacing-th tone; the receiver takes one
  torch FFT of the frame (``ops.ofdm.ofdm_rx``) for the pilot tones, the
  LS or DFT estimate (frame-averaged, per symbol for the time-varying
  models, or phase-tracked with ``track_phase``) is kernel C's h plane,
  and C's count skips the pilot tones (``pilot_spacing``), or its LLR
  plane is cut to the data tones. SC-FDMA block pilots: a Zadoff–Chu
  symbol (``ofdm_tx(zadoff_chu(N))``) heads each block of spacing rows,
  the data rows are ``link.fast.scfdma_tx``'s; the receiver transforms
  the pilot rows (``ofdm_rx``), estimates (frame-static, DFT-projected,
  or interpolated per block for RAYLEIGH_TIME and per tone for
  MULTIPATH_TIME) and runs C's despread on the data rows, gathered to
  (B, n_data_symbols, N+cp). The payload is kernel A's (B, S, N) grid at
  the data tones or rows (pilot tones and rows are drawn and discarded),
  so a pilot link and its genie twin carry the same data there.

- Front-end impairments (item 11d, ``ops/pa.py``, ``ops/sync.py``, the
  LO walk and I/Q functions of ``ops/channel.py``). Aligned links: the
  PA on the TX waveform, the propagation (one E launch), then the Wiener
  LO rotation and the I/Q mismatch over each channel's flattened frame;
  the receive compensates the image blindly (moments of consecutive
  symbols' differences, or blocks' for SC-FDMA block pilots), refines
  SC-FDMA's residual CFO from the CP, and tracks the common phase
  (``estimate_ls_comb_tracked``, ``estimate_block_pilots_tracked``). A
  timing offset or CFO takes the acquired link: the stream (delay,
  two-symbol Schmidl & Cox preamble, body, one tail symbol) through the
  PA, E's channel over the contiguous (B, S+3, N+cp) plane, the CFO, E's
  noise over one (B, 1, T) row, the walk, the mixer and the compensator
  lagged one symbol (one block), then batched ``ops.sync.acquire`` and
  the payload at the recovered start into the pilot receive. The torch
  stages run in passes of ``CHUNK`` channels.

Every draw is keyed Philox on (seed, role, global channel id, position)
— the payload on ``ROLE_PAYLOAD``, the fading on ``ROLE_FADING``, the
noise on ``ROLE_NOISE`` at counter (channel, symbol, sample) (the
acquired stream's at (channel, 0, sample)), the LO walk's increments on
``ROLE_PHASE`` at the sample's position in the frame or stream
(``ops.channel.wiener_increments``) — not the JAX package's per-channel
``fold_in`` threefry keys. ``s0`` (a time block's first symbol,
``link.stream``) moves every per-symbol draw to the block's absolute
symbols, so a blocked stream equals the whole frame. The acquired link's
fading is ``fast.fading_at`` over 2 + S symbols from symbol 0.

- MIMO (item 11e, ``_simulate_one_mimo``, ``mimo_llr_link``,
  ``_mimo_detect_per_symbol``, ``_mimo_llrs``; ``ops/mimo.py``): A's grid
  over n_streams·S rows → B off on the antennas' index grids (``mimo_tx``;
  SC-FDMA in torch), the preamble rows placed ahead (a head preamble) or
  every K data rows (a midamble schedule), the acquired link's two sync
  rows on antenna 0 → the PA per antenna → E's channel alone over the pair
  plane, the 1/√n_tx split in its gains or taps, per row on the
  time-varying models → the torch sum over TX antennas → E's noise over the
  RX planes (``mimo_channel``) or, acquired, the CFO and E's noise over the
  streams (``mimo_stream``) → the shared LO walk, the I/Q mismatch and its
  blind compensation per antenna (``mixer``) → ``acquire_array`` and the
  corrected slice (``mimo_acquire``) → the torch FFT, the head-preamble or
  the tracked midamble estimate, the detector, per symbol on a per-symbol
  h → C's post-FFT mode on whitened tones (``mimo_rx``; ML's LLRs in
  torch); in passes of ``CHUNK`` channels. The pairs' fading is keyed at
  (channel, pair r·n_tx + t) (the Jakes state at row p, a TDL tap at row
  p·L + l), the noise at (channel, r·S' + s, sample) on a frame link and at
  (channel, r, sample) on the acquired streams, the walk at (channel,
  sample) as the SISO link's.

The stream and the fast engines are SISO; coded links, MIMO among them,
run through this module from ``link.coded``. The entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU; without a card they raise, and a CUDA tensor that
a kernel refuses raises: nothing falls back to plain torch or to the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from sdr_tpu_torch.core.config import (
    TIME_VARYING_MODELS,
    ChannelEstimator,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOScheme,
)
from sdr_tpu_torch.kernels import demod as _kc
from sdr_tpu_torch.kernels import tx as _kb
from sdr_tpu_torch.kernels.channel import fade_awgn
from sdr_tpu_torch.kernels.payload import out_dtype, payload_idx
from sdr_tpu_torch.link import fast
from sdr_tpu_torch.ops import channel as chan
from sdr_tpu_torch.ops import equalize as eq
from sdr_tpu_torch.ops import mimo as mo
from sdr_tpu_torch.ops import pa as _pa
from sdr_tpu_torch.ops import pilots as pil
from sdr_tpu_torch.ops import sync
from sdr_tpu_torch.ops.fft import ifft
from sdr_tpu_torch.ops.llr import llr_maxlog, llr_to_hard_bits
from sdr_tpu_torch.ops.modulation import _bits_to_ints, _ints_to_bits, constellation
from sdr_tpu_torch.ops.ofdm import ofdm_rx, ofdm_tx

_SELECTIVE = (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME)


@dataclasses.dataclass
class LinkResult:
    """Per-invocation link statistics (tensors on the run's device)."""

    bit_errors: torch.Tensor  # (n_channels,) int32
    bits_counted: torch.Tensor  # (n_channels,) int32
    llrs: torch.Tensor | None = None  # (n_channels, n_data_symbols, bits/sym) f32 or None

    @property
    def ber(self) -> torch.Tensor:
        return self.bit_errors.to(torch.float32) / torch.clamp(
            self.bits_counted.to(torch.float32), min=1.0)


def front_end_impaired(cfg: LinkConfig) -> bool:
    """Whether the config has a front-end impairment: a PA, LO phase
    noise, I/Q imbalance, or a timing offset or CFO (the acquired link)."""
    ch = cfg.channel
    return bool(ch.impaired or ch.has_pa or ch.phase_noise_std or ch.iq_imbalanced)


def noise_var(cfg: LinkConfig) -> float:
    """The receiver's subcarrier noise variance: the Eb/N0 variance, 0 for
    IDENTITY (floored at 1e-12 where it divides)."""
    return 0.0 if cfg.channel.model == ChannelModel.IDENTITY else fast.noise_var(cfg)


def draw_idx(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, s0: int = 0,
             n_symbols: int | None = None) -> torch.Tensor:
    """Kernel A's symbol indices (B, n_symbols, N) of symbols s0 …
    (default: the whole frame)."""
    n = cfg.n_symbols if n_symbols is None else n_symbols
    return payload_idx(n, cfg.ofdm.n_fft, cfg.modulation.bits_per_symbol, seed, ch_ids, s0)


def _block_view(cfg: LinkConfig, t: torch.Tensor) -> torch.Tensor:
    """A (B, S, ...) plane as (B, S/p, p, ...): row 0 of each block is the
    pilot symbol."""
    B, S = t.shape[:2]
    return t.reshape(B, S // cfg.pilot_spacing, cfg.pilot_spacing, *t.shape[2:])


def _data_rows(cfg: LinkConfig, t: torch.Tensor) -> torch.Tensor:
    """The data rows of a block-pilot frame's (B, S, ...) plane, gathered
    to (B, n_data_symbols, ...)."""
    return _block_view(cfg, t)[:, :, 1:].reshape(t.shape[0], cfg.n_data_symbols, *t.shape[2:])


def payload_of(cfg: LinkConfig, idx: torch.Tensor) -> torch.Tensor:
    """The payload of kernel A's (B, S, N) grid: its data tones (comb) or
    rows (block pilots), in ``modulate``'s order; the grid itself without
    pilots."""
    if not cfg.pilot_spacing:
        return idx
    return _data_rows(cfg, idx) if cfg.dft_spread else pil.data_tones(idx, cfg.pilot_spacing)


def generate_bits(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, s0: int = 0,
                  n_symbols: int | None = None) -> torch.Tensor:
    """Source bits (B, n_data_symbols, bits_per_ofdm_symbol) int8: the bits
    of kernel A's indices at the payload positions (``payload_of``; a
    pilot frame is drawn whole) in ``modulate``'s order (MSB first per
    symbol)."""
    if cfg.pilot_spacing and (s0 or n_symbols not in (None, cfg.n_symbols)):
        raise ValueError("a pilot frame's payload is drawn for the whole frame")
    idx = payload_of(cfg, draw_idx(cfg, seed, ch_ids, s0, n_symbols))
    return _ints_to_bits(idx, cfg.modulation.bits_per_symbol)


@functools.lru_cache(maxsize=None)
def _zc_row(n_fft: int, cp_len: int, device: str):
    """The block pilots' reference waveform, planar (N+cp,) each:
    ``ofdm_tx(zadoff_chu(N))`` (the 1/N inverse), made once per (N, cp,
    device)."""
    z = ofdm_tx(torch.from_numpy(pil.zadoff_chu(n_fft)), cp_len)
    return fast._planar(z.to(device))


def _block_tx(cfg: LinkConfig, idx: torch.Tensor):
    """Block-pilot SC-FDMA TX of A's (B, S, N) grid: the data rows through
    ``link.fast.scfdma_tx``, each block headed by the Zadoff–Chu row."""
    B, S, _ = idx.shape
    L = cfg.ofdm.n_fft + cfg.ofdm.cp_len
    data = fast.scfdma_tx(cfg, _block_view(cfg, idx)[:, :, 1:])  # (B, S/p, p-1, L) each
    zc = _zc_row(cfg.ofdm.n_fft, cfg.ofdm.cp_len, str(idx.device))
    return tuple(torch.cat([z.expand(B, S // cfg.pilot_spacing, 1, L), d], dim=2).reshape(B, S, L)
                 for z, d in zip(zc, data))


def tx_idx(cfg: LinkConfig, idx: torch.Tensor):
    """The waveform of A's (B, S, N) grid: planar (re, im), each
    (B, S, N+cp) float32 — kernel B with the channel off (with the comb
    when the config has pilots), or SC-FDMA's full-grid TX (with block
    pilots: its data rows; see ``_block_tx``)."""
    if cfg.dft_spread:
        return _block_tx(cfg, idx) if cfg.pilot_spacing else fast.scfdma_tx(cfg, idx)
    return _kb.tx_chain(idx, cfg.ofdm.cp_len, cfg.modulation, pilot_spacing=cfg.pilot_spacing)


def _grid_of(cfg: LinkConfig, ints: torch.Tensor) -> torch.Tensor:
    """The payload's indices (B, n_data_symbols, n_data) laid on a (B, S, N)
    grid, zeros at the pilot tones or rows (``tx_idx`` reads none there)."""
    if not cfg.pilot_spacing:
        return ints
    B = ints.shape[0]
    grid = torch.zeros((B, cfg.n_symbols, cfg.ofdm.n_fft), dtype=ints.dtype, device=ints.device)
    if cfg.dft_spread:
        _block_view(cfg, grid)[:, :, 1:] = ints.reshape(
            B, cfg.n_pilot_symbols, cfg.pilot_spacing - 1, -1)
    else:
        grid[..., list(pil.data_indices(cfg.ofdm.n_fft, cfg.pilot_spacing))] = ints
    return grid


def tx_chain(cfg: LinkConfig, bits: torch.Tensor):
    """Bits (B, n_data_symbols, bits_per_ofdm_symbol) → time samples, planar
    (re, im) (B, S, N+cp): the bits packed to indices MSB first, laid on
    the data tones or rows, then ``tx_idx``."""
    bps = cfg.modulation.bits_per_symbol
    return tx_idx(cfg, _grid_of(cfg, _bits_to_ints(bits, bps).to(out_dtype(bps))))


def apply_pa(cfg: LinkConfig, tx):
    """The TX front end on a planar waveform: the configured PA (DPD, then
    Rapp) at the nominal input power 1/N, or the waveform as it is."""
    ch = cfg.channel
    if not ch.has_pa:
        return tx
    return _pa.apply_pa(tx, ch.pa_ibo_db, 1.0 / cfg.ofdm.n_fft, ch.pa_smoothness, ch.pa_dpd)


# Channels a pass of the front end's plain-torch stages (the LO walk, the
# mixer, the blind I/Q compensation, acquisition, the payload gather): at
# config 2's acquired stream (21477 samples) their temporaries take about
# 2 GB a thousand channels, so a pass of 2048 holds them near 4 GB. Every
# stage is per channel (keyed draws, per-channel moments and decisions), so
# a pass gives each channel what one pass over the batch gives it, up to the
# order torch's reductions take for the pass's shape.
CHUNK = 2048


def _in_passes(fn, *xs: torch.Tensor):
    """fn(channel slice, *(x[slice] for x in xs)) over passes of ``CHUNK``
    channels of the (B, ...) inputs, each of fn's outputs (a tensor or a
    tuple of them) gathered into one (B, ...) tensor of its dtype."""
    B = xs[0].shape[0]
    outs = None
    for a in range(0, max(B, 1), CHUNK):
        sl = slice(a, min(a + CHUNK, B))
        got = fn(sl, *(x[sl] for x in xs))
        got = got if isinstance(got, tuple) else (got,)
        if outs is None:
            outs = tuple(torch.empty((B, *t.shape[1:]), dtype=t.dtype, device=t.device)
                         for t in got)
        for o, t in zip(outs, got):
            o[sl] = t
    return outs if len(outs) > 1 else outs[0]


def mixer(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, z: torch.Tensor, phase=None,
          compensate_lag: int = 0):
    """The receiver's analog stages over each channel's serialised samples
    z (B, n), or (B, n_rx, n) for an antenna array: the Wiener LO rotation
    (keyed increments at sample positions 0 … n−1, or the injected
    ``phase`` (B, n) N(0, 1) increments; one walk a channel, rotating its
    antennas alike — a shared LO), then the I/Q mismatch, then with
    ``compensate_lag`` the blind compensation on moments of samples that
    lag apart, per channel and antenna (each antenna owns a mixer); in
    passes of ``CHUNK`` channels."""
    ch = cfg.channel
    compensate = bool(compensate_lag and ch.iq_imbalanced)
    n = z.shape[-1]

    def stages(sl, zc):
        if ch.phase_noise_std:
            ph = chan.wiener_phase(seed, ch_ids[sl], n, ch.phase_noise_std,
                                   None if phase is None else phase[sl])
            zc = zc * ph.view(ph.shape[0], *(1,) * (zc.ndim - 2), n)
        if ch.iq_imbalanced:
            zc = chan.apply_iq_imbalance(zc, ch.iq_gain, ch.iq_phase_rad)
        if compensate:
            zc = chan.iq_compensate(zc.reshape(-1, n), diff_lag=compensate_lag).view(zc.shape)
        return zc

    return _in_passes(stages, z) if ch.phase_noise_std or ch.iq_imbalanced else z


def _iq_compensated(z: torch.Tensor, **kw) -> torch.Tensor:
    """``ops.channel.iq_compensate`` (per-channel moments) in passes."""
    return _in_passes(lambda _, zc: chan.iq_compensate(zc, **kw), z)


def apply_channel(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, tx, *, s0: int = 0,
                  history=None, fading=None, noise=None, phase=None):
    """The channel over a planar waveform ``tx`` (B, S, N+cp) → (rx, h_freq,
    noise_var).

    rx is planar (re, im); h_freq the complex response that broadcasts
    against the post-FFT grid (B, S, N) — (B, 1, 1) flat, (B, S, 1) per
    symbol, (B, 1, N) or (B, S, N) selective — or None (AWGN, IDENTITY);
    noise_var the subcarrier variance (0 for IDENTITY). The order is the
    JAX function's: the PA on the waveform (``apply_pa``), the
    propagation — after the fading draws (``link.fast.fading_at``, at the
    absolute symbols from ``s0``) one launch of kernel E: the FIR or the
    gains, then the noise (keyed at counter (channel, s0 + s, sample)) —,
    then the LO walk and the I/Q mismatch over each channel's flattened
    frame (``mixer``).

    ``history`` (hr, hi), each (B, L−1): the clean samples before row 0
    that the FIR of a selective model reads (a time block's halo), zeros
    when None. ``fading`` ((h, taps) in ``fade_state``'s form), ``noise``
    (N(0, 1) planes (n_re, n_im) of the waveform's shape) and ``phase``
    (the Wiener walk's N(0, 1) increments, (B, S·(N+cp))) are the
    injection forms the parity tests use."""
    tx = apply_pa(cfg, tx)
    rx, h_freq, nv = _propagate(cfg, seed, ch_ids, tx, s0, history, fading, noise)
    ch = cfg.channel
    if ch.phase_noise_std or ch.iq_imbalanced:
        re, im = rx
        z = mixer(cfg, seed, ch_ids, torch.complex(re, im).reshape(re.shape[0], -1), phase)
        rx = fast._planar(z.reshape(re.shape))
    return rx, h_freq, nv


def _propagate(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, tx, s0, history, fading,
               noise):
    """The propagation model (``apply_channel``'s middle): one E launch."""
    re, im = tx
    model = cfg.channel.model
    nv = noise_var(cfg)
    if model == ChannelModel.IDENTITY:
        return (re, im), None, nv
    B, S, _ = re.shape
    N = cfg.ofdm.n_fft
    h, taps = fading if fading is not None else fast.fading_at(
        cfg, fast.fading_params(cfg, seed, ch_ids), s0, S)
    kw = dict(noise=noise) if noise is not None else dict(seed=seed, ch_ids=ch_ids)
    chan_kw = {}
    h_freq = None
    if model in _SELECTIVE:
        chan_kw["taps_r"], chan_kw["taps_i"] = fast._planar(taps)
        if history is not None and taps.shape[-1] > 1:
            chan_kw["history_r"], chan_kw["history_i"] = (
                t.to(torch.float32).contiguous() for t in history)
        h_freq = fast.rx_plane(taps, N)
    elif h is not None:
        chan_kw["hr_s"], chan_kw["hi_s"] = fast._gains(h)
        h_freq = h
    rx = fade_awgn(re, im, noise_var=nv / N, s0=s0, **chan_kw, **kw)
    return rx, h_freq, nv


def _h_plane(h: torch.Tensor | None, B: int, N: int, device):
    """Kernel C's (hr, hi) planes (B, 1 | S, N) of a response that
    broadcasts against the grid; a unit response for None."""
    if h is None:
        return (torch.ones((B, 1, N), dtype=torch.float32, device=device),
                torch.zeros((B, 1, N), dtype=torch.float32, device=device))
    return fast._planar(h.to(torch.complex64).expand(B, h.shape[1], N))


# Below this noise variance kernel C's despread does not resolve an
# unequalised link's SINR: on a unit h it takes nv back as (1 − b)/b with
# b = 1/(1 + nv), a relative rounding of about 2^-24/nv, 1e-5 of the LLRs
# at nv = 1e-2 (IDENTITY's 1e-12 leaves 1 − b = 0).
_DESPREAD_UNIT_NV_MIN = 1e-2


def _kernel_h(cfg: LinkConfig, h, nv: float):
    """Whether kernel C computes the JAX receiver's branch for ``h`` and
    ``nv``, and the response it equalises with (None: a unit h).

    OFDM, every branch: ZF and MMSE are both C's one-tap tail, s =
    conj(h)·y/max(|h|², 1e-12) with LLRs scaled by |h|²/nv (ZF's floor
    is |h|² + 1e-12: they part only where |h|² is near 1e-12); NONE, and
    no h, are that tail on a unit h (the raw tones, scaled by 1/nv).
    SC-FDMA: MMSE on h is C's despread; the unequalised despread (no h,
    or NONE) is C's despread on a unit h where nv ≥ ``_DESPREAD_UNIT_NV_MIN``;
    the ZF despread (per tone nv/|h|², averaged) is no kernel's."""
    unequalised = h is None or cfg.equalizer == Equalizer.NONE
    if not cfg.dft_spread:
        return True, None if unequalised else h
    if unequalised:
        return nv >= _DESPREAD_UNIT_NV_MIN, None
    return cfg.equalizer == Equalizer.MMSE, h


def _rx_plain(cfg: LinkConfig, re, im, h, nv: float) -> torch.Tensor:
    """The JAX receiver's SC-FDMA branches that no kernel computes, in
    plain torch (pipeline.py:387-416): the ZF despread, and the
    unequalised despread at a noise variance C does not resolve."""
    y = ofdm_rx(torch.complex(re, im), cfg.ofdm.cp_len)
    if h is not None and cfg.equalizer == Equalizer.ZF:
        s, eff = eq.equalize_zf(y, h, nv)
    else:
        s, eff = y, nv
    m = s.shape[-1]
    eff = torch.broadcast_to(
        torch.as_tensor(eff, dtype=torch.float32, device=s.device), s.shape
    ).mean(dim=-1, keepdim=True)
    s = (ifft(s) * (m ** 0.5)).to(torch.complex64)
    return llr_maxlog(s, cfg.modulation, eff)


def _tracked(cfg: LinkConfig, track_phase: bool = False) -> bool:
    """Whether a frame-static model takes the phase-tracked estimate: a
    residual CFO after acquisition or an LO walk rotates the grid a little
    more each symbol (pipeline.py:303-320, :351-376)."""
    ch = cfg.channel
    return bool(ch.impaired or ch.phase_noise_std or track_phase)


def _comb_estimate(cfg: LinkConfig, y: torch.Tensor, track_phase: bool) -> torch.Tensor:
    """The comb's estimate from the post-FFT grid (B, S, N)
    (pipeline.py:324-376): LS or DFT, per symbol for the time-varying
    models, phase-tracked on the impaired and phase-noise links or with
    ``track_phase``, else frame-averaged → (B, 1 | S, N)."""
    sp = cfg.pilot_spacing
    base = pil.estimate_ls_comb
    if cfg.estimator == ChannelEstimator.DFT:
        base = functools.partial(
            pil.estimate_dft_comb, n_taps=pil.dft_n_taps(cfg.ofdm.n_fft, cfg.ofdm.cp_len, sp))
    if cfg.channel.model in TIME_VARYING_MODELS:
        return base(y, sp, per_symbol=True)
    if _tracked(cfg, track_phase):
        return pil.estimate_ls_comb_tracked(y, sp, base=base)
    return base(y, sp, per_symbol=False)


def _block_estimate(cfg: LinkConfig, y_pil: torch.Tensor) -> torch.Tensor:
    """The block pilots' estimate from the post-FFT pilot rows (B, S/p, N)
    (pipeline.py:283-329): interpolated per block (RAYLEIGH_TIME) or per
    tone (MULTIPATH_TIME), phase-tracked on the impaired and phase-noise
    links → (B, n_data_symbols, N); else frame-static, DFT-projected with
    the DFT estimator → (B, 1, N)."""
    p, N = cfg.pilot_spacing, cfg.ofdm.n_fft
    n_taps = min(cfg.ofdm.cp_len + 1, N) if cfg.estimator == ChannelEstimator.DFT else 0
    if cfg.channel.model == ChannelModel.RAYLEIGH_TIME:
        h = pil.estimate_block_pilots_interp(y_pil, p)
    elif cfg.channel.model == ChannelModel.MULTIPATH_TIME:
        h = pil.estimate_block_pilots_interp_full(y_pil, p)
    elif _tracked(cfg):
        h = pil.estimate_block_pilots_tracked(y_pil, p, n_taps)
    else:
        return pil.estimate_block_pilots(y_pil, n_taps)[:, None, :]
    return h.reshape(y_pil.shape[0], cfg.n_data_symbols, N)


def _front(cfg: LinkConfig, rx, skip_iq: bool = False):
    """The receive's steps before the FFT (pipeline.py:232-265), on planar
    (B, S, N+cp): the blind I/Q compensation (moments of consecutive
    symbols' differences, or consecutive blocks' for SC-FDMA block pilots;
    skipped with ``skip_iq``), then SC-FDMA block pilots' CP-based
    residual-CFO refinement on the impaired links."""
    ch = cfg.channel
    block = bool(cfg.dft_spread and cfg.pilot_spacing)
    iq = ch.iq_imbalanced and not skip_iq
    resid = block and ch.impaired
    if not (iq or resid):
        return rx
    z = torch.complex(*rx)
    if iq and block:
        z = _iq_compensated(_block_view(cfg, z), diff_axis=-3).reshape(z.shape)
    elif iq:
        z = _iq_compensated(z, diff_axis=-2)
    if resid:
        z = _in_passes(lambda _, zc: sync.correct_residual_cfo(zc, cfg.ofdm.n_fft,
                                                                cfg.ofdm.cp_len), z)
    return fast._planar(z)


def _estimate(cfg: LinkConfig, rx, track_phase: bool = False):
    """A pilot frame's receive front: (the planes of its data symbols, the
    estimated response that broadcasts against their grid). Comb: the
    frame's planes, and the estimate from one torch FFT of the frame;
    block pilots: the data rows gathered to (B, n_data_symbols, N+cp),
    and the estimate from the FFT of the pilot rows."""
    re, im = rx
    cp = cfg.ofdm.cp_len
    if cfg.dft_spread:
        rows = tuple(_block_view(cfg, t)[:, :, 0] for t in rx)
        h = _block_estimate(cfg, ofdm_rx(torch.complex(*rows), cp))
        return (_data_rows(cfg, re), _data_rows(cfg, im)), h
    return rx, _comb_estimate(cfg, ofdm_rx(torch.complex(re, im), cp), track_phase)


def _llrs(cfg: LinkConfig, rx, h_freq, nv: float) -> torch.Tensor:
    """The LLR plane (B, S', N·bps) of the planes ``rx`` (the whole grid;
    the comb's pilot tones included)."""
    re, im = rx
    kernel, h = _kernel_h(cfg, h_freq, nv)
    if kernel:
        hr, hi = _h_plane(h, re.shape[0], cfg.ofdm.n_fft, re.device)
        return _kc.demod_llr(re, im, hr, hi, cfg.ofdm.cp_len, cfg.modulation, nv,
                             despread=cfg.dft_spread)
    return _rx_plain(cfg, re, im, h_freq, nv)


def rx_chain(cfg: LinkConfig, rx, h_freq, noise_var, skip_iq: bool = False,
             track_phase: bool = False):
    """Receiver: planar samples (B, S, N+cp) → (llrs (B, n_data_symbols,
    bits_per_ofdm_symbol) float32 in the public order, hard bits int8).
    First the front-end compensation (``_front``: the blind I/Q stage
    unless ``skip_iq``, SC-FDMA block pilots' residual CFO). Kernel C's
    LLR mode (SC-FDMA: its despread mode) wherever it computes the branch
    (``_kernel_h``); the SC-FDMA ZF despread, and the unequalised
    despread at a noise variance below ``_DESPREAD_UNIT_NV_MIN``, in plain
    torch. With pilots the response is estimated (``_estimate``; ``h_freq``
    is not read, and ``track_phase`` selects the comb's tracked estimator
    for the frame-static models) and only the data tones or rows are
    demapped."""
    nv = max(float(noise_var), 1e-12)
    rx = _front(cfg, rx, skip_iq)
    if cfg.pilot_spacing:
        rx, h_freq = _estimate(cfg, rx, track_phase)
    llrs = _llrs(cfg, rx, h_freq, nv)
    if cfg.pilot_spacing and not cfg.dft_spread:
        llrs = pil.data_tones(llrs, cfg.pilot_spacing, cfg.modulation.bits_per_symbol)
    return llrs, llr_to_hard_bits(llrs)


def count_errors(cfg: LinkConfig, rx, h_freq, noise_var, idx: torch.Tensor,
                 track_phase: bool = False, skip_iq: bool = False) -> torch.Tensor:
    """Per-channel (B,) int32 bit errors of the received planes against
    kernel A's transmitted grid ``idx`` (B, S, N): after ``_front``,
    kernel C's count on ``_kernel_h``'s response (its hard decisions do
    not depend on nv, so the unequalised despread counts there at any
    nv), the SC-FDMA ZF despread through the plain plane. With pilots, on
    the estimate (``_estimate``): the comb's count skips the pilot tones,
    the block pilots' counts the gathered data rows."""
    nv = max(float(noise_var), 1e-12)
    mod = cfg.modulation
    comb = 0
    rx = _front(cfg, rx, skip_iq)
    if cfg.pilot_spacing:
        rx, h_freq = _estimate(cfg, rx, track_phase)
        if cfg.dft_spread:
            idx = _data_rows(cfg, idx)
        else:
            comb = cfg.pilot_spacing
    re, im = rx
    kernel, h = _kernel_h(cfg, h_freq, nv)
    if not kernel and h is not None:
        return _kc.count_errors(_llrs(cfg, rx, h_freq, nv), idx, mod.bits_per_symbol)
    hr, hi = _h_plane(h, re.shape[0], cfg.ofdm.n_fft, re.device)
    return _kc.demod_count(re, im, hr, hi, idx, cfg.ofdm.cp_len, mod, nv,
                           despread=cfg.dft_spread, pilot_spacing=comb)


# ---- the acquired link: blind timing and CFO acquisition ----------------------------

def stream_len(cfg: LinkConfig) -> int:
    """Samples of the acquired link's stream: the delay, the two preamble
    symbols, the body and one symbol of tail zeros."""
    return cfg.channel.timing_offset + (cfg.n_symbols + 3) * cfg.ofdm.symbol_len


def _tail_row(fade: torch.Tensor, selective: bool) -> torch.Tensor:
    """Per-step fading (..., steps, ·) with the acquired plane's tail row
    after it: the last step's taps repeated (the JAX tail convolution,
    pipeline.py:491-495 and :788-792, is exactly one symbol with those
    taps and the last symbol's tail as history), or a unit gain (the tail
    row is zeros)."""
    last = fade[..., -1:, :] if selective else torch.ones_like(fade[..., :1, :])
    return torch.cat([fade, last], dim=-2)


def _tail_fading(cfg: LinkConfig, h, taps):
    """The acquired plane's (B, S+3, ·) fading from the 2 + S symbols'
    state: the per-symbol models with ``_tail_row``; the static models as
    drawn."""
    model = cfg.channel.model
    if model == ChannelModel.MULTIPATH_TIME:
        return None, _tail_row(taps, True)
    if model == ChannelModel.RAYLEIGH_TIME:
        return _tail_row(h, False), None
    return h, taps


def acquired_plane(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, idx: torch.Tensor,
                   fading=None):
    """The acquired link's transmitted plane and its channel: planar
    (B, S+3, N+cp) — the two preamble symbols, the body (kernel B, with
    its comb; SC-FDMA's ``tx_idx``) and one symbol of zeros, through the
    PA (zeros stay zeros) — and kernel E's channel arguments for it
    (``_tail_fading``'s gains or taps), None for IDENTITY and AWGN.
    ``fading``: (h, taps) of ``fast.fading_at`` over 2 + S symbols."""
    model = cfg.channel.model
    L = cfg.ofdm.symbol_len
    B, S = idx.shape[:2]
    pre = sync.acquisition_preamble(cfg.ofdm.n_fft, cfg.ofdm.cp_len,
                                    device=idx.device).reshape(2, L)
    zeros = torch.zeros((B, 1, L), dtype=torch.float32, device=idx.device)
    plane = tuple(torch.cat([p.expand(B, 2, L), b, zeros], dim=1)
                  for p, b in zip(fast._planar(pre), tx_idx(cfg, idx)))
    plane = tuple(t.contiguous() for t in apply_pa(cfg, plane))
    if model in (ChannelModel.IDENTITY, ChannelModel.AWGN):
        return plane, None
    h, taps = fading if fading is not None else fast.fading_at(
        cfg, fast.fading_params(cfg, seed, ch_ids), 0, S + 2)
    h, taps = _tail_fading(cfg, h, taps)
    if model in _SELECTIVE:
        return plane, dict(zip(("taps_r", "taps_i"), fast._planar(taps)))
    return plane, dict(zip(("hr_s", "hi_s"), fast._gains(h)))


def acquired_stream(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, idx: torch.Tensor, *,
                    fading=None, noise=None, phase=None) -> torch.Tensor:
    """TX and channel of the acquired link (pipeline.py:435-543) for A's
    grid ``idx`` (B, S, N): the received stream (B, T) complex64,
    T = ``stream_len``.

    The stream is the delay's zeros, then ``acquired_plane`` after one
    launch of kernel E with the channel only (the delay stays zeros
    through any FIR); then the CFO at absolute sample index n
    (``ops.sync.apply_cfo``), E's keyed noise over the stream as one
    (B, 1, T) row at counter (channel, 0, n) (none for IDENTITY), the
    Wiener walk, the I/Q mismatch and the blind I/Q compensation with
    moments lagged one symbol (one pilot block for SC-FDMA block pilots)
    (``mixer``).

    Injection forms: ``fading`` ((h, taps) of ``fast.fading_at`` over
    2 + S symbols), ``noise`` ((n_re, n_im) N(0, 1) planes (B, 1, T)),
    ``phase`` ((B, T) N(0, 1) increments)."""
    ch = cfg.channel
    N, L = cfg.ofdm.n_fft, cfg.ofdm.symbol_len
    B = idx.shape[0]
    plane, chan_kw = acquired_plane(cfg, seed, ch_ids, idx, fading)
    if chan_kw is not None:
        plane = fade_awgn(*plane, **chan_kw)
    delay = torch.zeros((B, ch.timing_offset), dtype=torch.float32, device=idx.device)
    z = torch.complex(*(torch.cat([delay, t.reshape(B, -1)], dim=1) for t in plane))
    del plane
    z = sync.apply_cfo(z, ch.cfo_subcarriers, N)
    if ch.model != ChannelModel.IDENTITY:
        kw = dict(noise=noise) if noise is not None else dict(seed=seed, ch_ids=ch_ids)
        re, im = fast._planar(z[:, None, :])
        del z
        re, im = fade_awgn(re, im, noise_var=fast.noise_var(cfg) / N, **kw)
        z = torch.complex(re[:, 0], im[:, 0])
        del re, im
    lag = L * (cfg.pilot_spacing if cfg.dft_spread and cfg.pilot_spacing else 1)
    return mixer(cfg, seed, ch_ids, z, phase, compensate_lag=lag)


def acquire_payload(cfg: LinkConfig, stream: torch.Tensor):
    """The acquired link's receive front (pipeline.py:551-565): batched
    ``ops.sync.acquire`` on the stream (B, T), then the CFO-corrected
    payload (B, S, N+cp) planar from max(start − backoff, 0) (clamped
    into the stream, as ``dynamic_slice`` clamps; backoff 2 for SC-FDMA
    with cp ≥ 4, else 0); in passes of ``CHUNK`` channels. Returns
    (start, total CFO, payload planes)."""
    N, cp = cfg.ofdm.n_fft, cfg.ofdm.cp_len
    backoff = 2 if (cfg.dft_spread and cp >= 4) else 0
    S, L = cfg.n_symbols, cfg.ofdm.symbol_len

    def front(_, zc):
        start, total = sync.acquire_start(zc, N, cp)
        pay = sync.corrected_slice(zc, total, torch.clamp(start - backoff, min=0), S * L,
                                   N).reshape(-1, S, L)
        return start, total, pay.real, pay.imag

    start, total, re, im = _in_passes(front, stream)
    return start, total, (re, im)


# ---- MIMO on frame-static channels (item 11e-i) ---------------------------------------

def _split(cfg: LinkConfig) -> float:
    """The per-antenna amplitude the encoders give the data: n_tx^-½
    (Alamouti, spatial mux) or 1 (MRC)."""
    mc = cfg.mimo
    return 1.0 if mc.scheme == MIMOScheme.MRC else mc.n_tx ** -0.5


def mimo_noise_var(cfg: LinkConfig) -> float:
    """The MIMO link's subcarrier noise variance: Eb/N0 against the bits
    of every stream (pipeline.py:745-747)."""
    return 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * cfg.modulation.bits_per_symbol
                  * cfg.mimo.n_streams)


def midamble(cfg: LinkConfig) -> bool:
    """Whether the MIMO link re-sends its preamble every ``midamble_period``
    data symbols (pipeline.py:638-642): estimated CSI on a time-varying
    model, under LO phase noise, or after acquisition."""
    ch = cfg.channel
    return cfg.mimo.csi == "preamble" and (
        ch.model in TIME_VARYING_MODELS or bool(ch.phase_noise_std) or ch.impaired)


def n_preamble(cfg: LinkConfig) -> int:
    """Preamble rows a block: n_tx with ``csi="preamble"``, else 0."""
    return cfg.mimo.n_tx if cfg.mimo.csi == "preamble" else 0


def _blocks(cfg: LinkConfig) -> tuple[int, int]:
    """(blocks, data rows a block) of the MIMO frame: (S/K, K) with a
    midamble schedule of period K, else (1, S) — the head preamble is the
    one-block layout."""
    if midamble(cfg):
        K = cfg.mimo.midamble_period
        return cfg.n_symbols // K, K
    return 1, cfg.n_symbols


def n_tx_symbols(cfg: LinkConfig) -> int:
    """S', the transmitted symbol rows: blocks · (preamble rows + data rows
    a block) — S + n_tx with a head preamble, (S/K)(n_tx + K) with a
    midamble schedule, S with genie CSI."""
    nb, K = _blocks(cfg)
    return nb * (n_preamble(cfg) + K)


@functools.lru_cache(maxsize=None)
def _preamble_grid(n_fft: int, dft_spread: bool, has_pa: bool, ant_pwr: float) -> np.ndarray:
    """The head preamble's reference tones (N,) complex64, as the JAX link
    forms them (pipeline.py:646-672): a Zadoff–Chu grid (SC-FDMA, at the
    per-antenna data power with a PA), the PN QPSK grid at that power (a
    PA), or ``PILOT_VALUE`` on every tone."""
    if dft_spread:
        return (pil.zadoff_chu(n_fft) * (ant_pwr ** 0.5 if has_pa else 1.0)).astype(np.complex64)
    if has_pa:
        return (pil.pn_preamble_grid(n_fft) * ant_pwr ** 0.5).astype(np.complex64)
    return np.full(n_fft, pil.PILOT_VALUE, np.complex64)


def _ant_pwr(cfg: LinkConfig) -> float:
    """The per-antenna subcarrier power of the data: 1/n_tx (Alamouti,
    spatial mux) or 1 (MRC)."""
    return 1.0 if cfg.mimo.scheme == MIMOScheme.MRC else 1.0 / cfg.mimo.n_tx


def preamble_ref(cfg: LinkConfig) -> np.ndarray:
    """``_preamble_grid`` of the config: the reference the receiver divides
    out, on the tones antenna t radiates in preamble row t."""
    return _preamble_grid(cfg.ofdm.n_fft, cfg.dft_spread, cfg.channel.has_pa, _ant_pwr(cfg))


@functools.lru_cache(maxsize=None)
def _preamble_row_on(n_fft: int, cp_len: int, dft_spread: bool, has_pa: bool, ant_pwr: float,
                     split: float, device: str):
    grid = _preamble_grid(n_fft, dft_spread, has_pa, ant_pwr) / np.float32(split)
    return fast._planar(ofdm_tx(torch.from_numpy(grid), cp_len).to(device))


def preamble_row(cfg: LinkConfig, device):
    """The preamble row's waveform before the power split, planar (N+cp,)
    each: ``ofdm_tx`` of ``preamble_ref``/split, made once per (grid, cp,
    split, device)."""
    return _preamble_row_on(cfg.ofdm.n_fft, cfg.ofdm.cp_len, cfg.dft_spread,
                            cfg.channel.has_pa, _ant_pwr(cfg), _split(cfg), str(device))


def _conj_flips(mod) -> tuple[int, int]:
    """The index bits whose flip negates an axis of the Gray square
    constellation (the axis level 2·gray_to_binary(g) − (L−1) changes sign
    with the axis MSB): (I, Q) — BPSK has no Q axis."""
    return 1 << (mod.bits_per_symbol - 1), (
        0 if mod.bits_per_axis == mod.bits_per_symbol else 1 << (mod.bits_per_axis - 1))


def alamouti_idx(idx: torch.Tensor, mod) -> torch.Tensor:
    """A's (B, S, N) grid → the G2 antennas' index grid (B, 2·S, N),
    antenna 0's rows first: for each symbol pair (i0, i1) antenna 0 sends
    [i0, i1 ^ I] (−conj(x1): the I axis negated) and antenna 1 [i1, i0 ^ Q]
    (conj(x0): the Q axis negated) — ``ops.mimo.alamouti_layout`` in the
    index domain."""
    B, S, N = idx.shape
    f_i, f_q = _conj_flips(mod)
    pairs = idx.reshape(B, S // 2, 2, N)
    i0, i1 = pairs[:, :, 0], pairs[:, :, 1]
    ant0 = torch.stack([i0, i1 ^ f_i], dim=2)
    ant1 = torch.stack([i1, i0 ^ f_q], dim=2)
    return torch.stack([ant0, ant1], dim=1).reshape(B, 2 * S, N)


def draw_mimo_idx(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor) -> torch.Tensor:
    """Kernel A's payload grid (B, n_streams·S, N): stream j on rows
    j·S … j·S+S−1 (stream j's bits are the indices MSB first)."""
    return payload_idx(cfg.mimo.n_streams * cfg.n_symbols, cfg.ofdm.n_fft,
                       cfg.modulation.bits_per_symbol, seed, ch_ids)


def _scfdma_mimo_tx(cfg: LinkConfig, idx: torch.Tensor):
    """SC-FDMA MIMO data (pipeline.py:620-639), plain torch: each stream's
    points DFT-precoded, the scheme's layout, ``ofdm_tx``."""
    B = idx.shape[0]
    S, N = cfg.n_symbols, cfg.ofdm.n_fft
    pts = constellation(cfg.modulation, idx.device)[idx.to(torch.int64)]
    pts = (torch.fft.fft(pts.reshape(B, cfg.mimo.n_streams, S, N), dim=-1)
           * N ** -0.5).to(torch.complex64)
    ant = mo.alamouti_layout(pts[:, 0]) if cfg.mimo.scheme == MIMOScheme.ALAMOUTI else pts
    return fast._planar(ofdm_tx(ant, cfg.ofdm.cp_len))


@functools.lru_cache(maxsize=None)
def _sync_rows_on(n_fft: int, cp_len: int, split: float, device: str):
    pre = sync.acquisition_preamble(n_fft, cp_len).reshape(2, n_fft + cp_len) / np.float32(split)
    return fast._planar(pre.to(device))


def mimo_tx(cfg: LinkConfig, idx: torch.Tensor):
    """The antennas' waveforms of A's MIMO grid ``idx`` (B, n_streams·S, N):
    planar (B, n_tx, S', N+cp), S' = ``n_tx_symbols``, before the power
    split (E applies it, ``pair_channel``). OFDM: kernel B with the channel
    off on the stream's grid (MRC), on the (B, n_tx·S, N) grid (spatial
    mux: stream t is antenna t), or on ``alamouti_idx``'s grid; SC-FDMA:
    ``_scfdma_mimo_tx``. With a preamble the rows are blocks of [n_tx
    preamble rows | K data rows] (pipeline.py:672-693: one block of S data
    rows for the head preamble, S/K blocks with a midamble schedule),
    antenna t radiating ``preamble_row`` in preamble row t and zeros in
    the others; B's rows are placed there by one copy.

    The acquired link (a timing offset or CFO) adds the two Schmidl & Cox
    rows ahead, on antenna 0 alone and stored divided by the split (the
    JAX head is at full amplitude: E's split gives it back), and one zero
    row after: (B, n_tx, 2 + S' + 1, N+cp) (pipeline.py:698-719)."""
    mc = cfg.mimo
    B = idx.shape[0]
    S, cp, L = cfg.n_symbols, cfg.ofdm.cp_len, cfg.ofdm.symbol_len
    if cfg.dft_spread:
        data = _scfdma_mimo_tx(cfg, idx)
    else:
        grid = alamouti_idx(idx, cfg.modulation) if mc.scheme == MIMOScheme.ALAMOUTI else idx
        data = tuple(t.view(B, mc.n_tx, S, L) for t in _kb.tx_chain(grid, cp, cfg.modulation))
    n_pre = n_preamble(cfg)
    acquired = cfg.channel.impaired
    if not (n_pre or acquired):
        return data
    nb, K = _blocks(cfg)
    Sp = nb * (n_pre + K)
    head = 2 if acquired else 0
    dev = idx.device
    rows = preamble_row(cfg, dev) if n_pre else (None, None)
    heads = _sync_rows_on(cfg.ofdm.n_fft, cp, _split(cfg), str(dev)) if acquired else (None,) * 2
    out = []
    for d, row, sync_row in zip(data, rows, heads):
        a = torch.empty((B, mc.n_tx, head + Sp + head // 2, L), dtype=torch.float32, device=dev)
        body = a[:, :, head:head + Sp].view(B, mc.n_tx, nb, n_pre + K, L)
        body[:, :, :, :n_pre] = 0.0
        body[:, :, :, n_pre:] = d.view(B, mc.n_tx, nb, K, L)
        for t in range(n_pre):
            body[:, t, :, t] = row
        if acquired:
            a[:, :, :head] = 0.0
            a[:, 0, :head] = sync_row
            a[:, :, head + Sp:] = 0.0
        out.append(a)
    return tuple(out)


def mimo_fading(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor,
                n_steps: int | None = None) -> torch.Tensor:
    """The pairs' keyed fading, pair p = r·n_tx + t. Frame-static models:
    flat gains (B, n_rx, n_tx, 1) (RAYLEIGH_FLAT, RICIAN) or static taps
    (B, n_rx, n_tx, L) (MULTIPATH) at counter (channel, p, ·) of
    ``ROLE_FADING``. Time-varying models, at steps 0 … n_steps−1 (one a
    transmitted symbol): Jakes gains (B, n_rx, n_tx, n_steps, 1)
    (RAYLEIGH_TIME, Jakes row p) or per-tap-Jakes taps
    (B, n_rx, n_tx, n_steps, L) (MULTIPATH_TIME, tap l at row p·L + l;
    ``ops.channel.jakes_params``). Pair 0 is the SISO draw."""
    mc = cfg.mimo
    n_pairs = mc.n_rx * mc.n_tx
    ch = cfg.channel
    B = ch_ids.shape[0]
    if ch.model == ChannelModel.RAYLEIGH_TIME:
        g = chan.jakes_gains(seed, ch_ids, n_steps, ch.doppler_norm, n_pairs=n_pairs)
        return g.reshape(B, mc.n_rx, mc.n_tx, n_steps, 1)
    if ch.model == ChannelModel.MULTIPATH_TIME:
        taps = chan.multipath_time_taps(seed, ch_ids, ch.pdp, n_steps, ch.doppler_norm,
                                        n_pairs=n_pairs)
        return taps.reshape(B, mc.n_rx, mc.n_tx, n_steps, -1)
    if ch.model == ChannelModel.RAYLEIGH_FLAT:
        f = chan.rayleigh_flat(seed, ch_ids, n_pairs)
    elif ch.model == ChannelModel.RICIAN:
        f = chan.rician_flat(seed, ch_ids, ch.k_factor, n_pairs)
    else:
        f = chan.multipath_taps(seed, ch_ids, ch.pdp, n_pairs)
    return f.reshape(B, mc.n_rx, mc.n_tx, -1)


def apply_pa_mimo(cfg: LinkConfig, tx):
    """One PA per antenna (pipeline.py:721-743) on the antennas' planes
    before the split. The JAX PA runs at the nominal power ant_pwr/N on the
    split waveform s·x; Rapp and its predistorter are homogeneous of degree
    one in (x, A_sat), and A_sat scales with √power, so PA(s·x) at
    ant_pwr/N = s²/N is s·PA(x) at 1/N: the PA at 1/N here, the split in E
    (the acquired link's sync rows, stored divided by s, come out of E as
    the JAX PA of the full-amplitude head)."""
    ch = cfg.channel
    if not ch.has_pa:
        return tx
    return _pa.apply_pa(tx, ch.pa_ibo_db, 1.0 / cfg.ofdm.n_fft, ch.pa_smoothness, ch.pa_dpd)


def pair_plane(tx, n_rx: int):
    """The antennas' planes (B, n_tx, S', L) → the pair plane
    (B·n_rx·n_tx, S', L): pair (r, t) carries antenna t's waveform."""
    B, n_tx, Sp, L = tx[0].shape
    return tuple(t[:, None].expand(B, n_rx, n_tx, Sp, L).reshape(B * n_rx * n_tx, Sp, L)
                 for t in tx)


def pair_channel(cfg: LinkConfig, fade: torch.Tensor, tail: bool = False) -> dict:
    """Kernel E's channel arguments for the pair plane, times the split:
    per pair its gain (B·n_rx·n_tx, 1) or static taps (B·n_rx·n_tx, Lt) —
    the FIR runs each pair's whole stream from zero history, the JAX
    ``apply_multipath(tx_flat[None], taps)`` —, or per row its gains
    (B·n_rx·n_tx, S') or taps (B·n_rx·n_tx, S', Lt) — each row with its
    own taps and the previous row's tail as history, the JAX
    ``symbol_history`` convention, preamble rows included. ``tail``: the
    acquired plane's last row (``_tail_row``)."""
    selective = cfg.channel.model in _SELECTIVE
    if fade.ndim == 5 and tail:
        fade = _tail_row(fade, selective)
    w = fade * _split(cfg)
    if selective:
        return dict(zip(("taps_r", "taps_i"), fast._planar(w.reshape(-1, *fade.shape[3:]))))
    return dict(zip(("hr_s", "hi_s"),
                    fast._planar(w.reshape(-1, fade.shape[3] if fade.ndim == 5 else 1))))


def rx_sum(y, B: int, n_rx: int, n_tx: int):
    """E's pair-plane output → the RX antennas' planes (B, n_rx, S', L):
    the sum over TX antennas, in torch (a K ≤ 8 weighted sum of planes)."""
    return tuple(t.view(B, n_rx, n_tx, *t.shape[1:]).sum(dim=2) if n_tx > 1
                 else t.view(B, n_rx, *t.shape[1:]) for t in y)


def mimo_genie(cfg: LinkConfig, fade: torch.Tensor) -> torch.Tensor:
    """The detectors' genie response of ``mimo_fading``'s draw: the gains,
    or the taps' ``freq_response``; (B, n_rx, n_tx, 1 | N) frame-static,
    (B, S', n_rx, n_tx, 1 | N) per symbol."""
    h = chan.freq_response(fade, cfg.ofdm.n_fft) if cfg.channel.model in _SELECTIVE else fade
    return h.movedim(3, 1) if fade.ndim == 5 else h


def _propagate_pairs(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, tx, n_steps: int,
                     fading, tail: bool = False):
    """The PA, then E's channel alone over the pair plane, then the sum over
    TX antennas: (the RX planes (B, n_rx, rows, L), the fading)."""
    mc = cfg.mimo
    B, n_tx = tx[0].shape[:2]
    fade = mimo_fading(cfg, seed, ch_ids, n_steps) if fading is None else fading
    y = fade_awgn(*pair_plane(apply_pa_mimo(cfg, tx), mc.n_rx), **pair_channel(cfg, fade, tail))
    return rx_sum(y, B, mc.n_rx, n_tx), fade


def mimo_channel(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, tx, *, fading=None,
                 noise=None, phase=None):
    """The MIMO channel of an aligned link over the antennas' planes ``tx``
    (``mimo_tx``'s) → (rx planar (B, n_rx, S', L), the genie response or
    None). The PA per antenna (``apply_pa_mimo``), then kernel E twice:
    the channel alone over the pair plane (``pair_plane``,
    ``pair_channel``; per-row gains or taps on the time-varying models),
    the sum over TX antennas (``rx_sum``), then E's keyed noise over the
    RX planes as one (B, n_rx·S', L) plane — counter (channel, r·S' + s,
    sample) on the batch's global channel ids; then over each antenna's
    serialised frame (``mixer``) the shared LO walk (one per channel,
    keyed at the sample's position in the frame, rotating every antenna
    alike), the I/Q mismatch and its blind compensation per antenna
    (moments of samples a row apart, the JAX symbol-row differences).
    The genie response (``mimo_genie``): frame-static always, per symbol
    with genie CSI only (a midamble link estimates its own).

    Injection forms: ``fading`` (``mimo_fading``'s gains or taps),
    ``noise`` (N(0, 1) planes (n_re, n_im), each (B, n_rx·S', L)),
    ``phase`` (the walk's N(0, 1) increments (B, S'·L))."""
    mc = cfg.mimo
    ch = cfg.channel
    B, _, Sp, L = tx[0].shape
    rx, fade = _propagate_pairs(cfg, seed, ch_ids, tx, Sp, fading)
    kw = dict(noise=noise) if noise is not None else dict(seed=seed, ch_ids=ch_ids)
    rx = fade_awgn(*(t.view(B, mc.n_rx * Sp, L) for t in rx),
                   noise_var=mimo_noise_var(cfg) / cfg.ofdm.n_fft, **kw)
    if ch.phase_noise_std or ch.iq_imbalanced:
        z = mixer(cfg, seed, ch_ids, torch.complex(*rx).view(B, mc.n_rx, Sp * L), phase,
                  compensate_lag=L)
        rx = fast._planar(z)
    h = mimo_genie(cfg, fade) if fade.ndim == 4 or mc.csi == "genie" else None
    return tuple(t.view(B, mc.n_rx, Sp, L) for t in rx), h


def mimo_stream(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, tx, *, fading=None,
                noise=None, phase=None) -> torch.Tensor:
    """TX and channel of the acquired MIMO link (pipeline.py:698-906) over
    ``mimo_tx``'s acquired planes (B, n_tx, 2 + S' + 1, L): the received
    streams (B, n_rx, T) complex64, T = offset + (S' + 3)·L.

    The PA per antenna, E's channel alone over the pair plane (a step's
    gains or taps a row from symbol 0 — the sync rows' two steps, then the
    body's —, the tail row ``pair_channel``'s), the sum over TX antennas,
    the delay's zeros in front; then the CFO at absolute sample index n,
    E's keyed noise over the streams as one (B, n_rx, T) plane at counter
    (channel, r, n), the shared LO walk keyed at n, the I/Q mismatch and
    the blind compensation per antenna with moments lagged one symbol
    (``mixer``).

    Injection forms: ``fading`` (``mimo_fading``'s over S' + 2 steps),
    ``noise`` ((n_re, n_im) N(0, 1) planes (B, n_rx, T)), ``phase`` ((B, T)
    N(0, 1) increments)."""
    mc = cfg.mimo
    ch = cfg.channel
    B, _, R, L = tx[0].shape
    rx, _ = _propagate_pairs(cfg, seed, ch_ids, tx, R - 1, fading, tail=True)
    delay = torch.zeros((B, mc.n_rx, ch.timing_offset), dtype=torch.float32,
                        device=tx[0].device)
    z = torch.complex(*(torch.cat([delay, t.reshape(B, mc.n_rx, R * L)], dim=-1) for t in rx))
    del rx
    z = sync.apply_cfo(z, ch.cfo_subcarriers, cfg.ofdm.n_fft)
    re, im = fast._planar(z)
    del z
    kw = dict(noise=noise) if noise is not None else dict(seed=seed, ch_ids=ch_ids)
    re, im = fade_awgn(re, im, noise_var=mimo_noise_var(cfg) / cfg.ofdm.n_fft, **kw)
    z = torch.complex(re, im)
    del re, im
    return mixer(cfg, seed, ch_ids, z, phase, compensate_lag=L)


def mimo_acquire(cfg: LinkConfig, z: torch.Tensor):
    """The acquired MIMO link's receive front (pipeline.py:896-906):
    ``ops.sync.acquire_array_start`` on the streams (B, n_rx, T), then the
    CFO-corrected S'·L samples from the start, every antenna at once (no
    backoff; ``dynamic_slice``'s clamp); in passes of ``CHUNK`` channels.
    Returns (start, total CFO, planes (B, n_rx, S', L))."""
    N, cp, L = cfg.ofdm.n_fft, cfg.ofdm.cp_len, cfg.ofdm.symbol_len
    Sp = n_tx_symbols(cfg)

    def front(_, zc):
        start, total = sync.acquire_array_start(zc, N, cp)
        pay = sync.corrected_slice(zc, total, start[:, None], Sp * L, N)
        pay = pay.reshape(zc.shape[0], zc.shape[1], Sp, L)
        return start, total, pay.real, pay.imag

    start, total, re, im = _in_passes(front, z)
    return start, total, (re, im)


def mimo_detect(cfg: LinkConfig, y: torch.Tensor, h: torch.Tensor, nv: float):
    """The configured detector on the post-FFT data grid y (B, n_rx, S, N):
    (s (B, n_streams, S, N), eff_var (B, n_streams, 1, N')), or for ML its
    LLRs (B, n_tx, S, N·bps) and None."""
    mc = cfg.mimo
    if mc.scheme == MIMOScheme.ALAMOUTI:
        s, eff = mo.alamouti_combine(y, h, nv)
    elif mc.scheme == MIMOScheme.MRC:
        s, eff = mo.mrc_combine(y, h, nv)
    elif mc.detector == "ml":
        return mo.mux_detect_ml(y, h, nv, cfg.modulation), None
    elif mc.detector == "sic":
        return mo.mux_detect_sic(y, h, nv, cfg.modulation)
    elif cfg.equalizer == Equalizer.ZF:
        return mo.mux_detect_zf(y, h, nv)
    else:
        return mo.mux_detect_mmse(y, h, nv)
    return s[:, None], eff[:, None]  # the combiners' one stream


def mimo_detect_per_symbol(cfg: LinkConfig, y: torch.Tensor, h_t: torch.Tensor, nv: float):
    """Detection under per-symbol CSI (``_mimo_detect_per_symbol``,
    pipeline.py:1034-1081): y (B, n_rx, S, N), h_t (B, S, n_rx, n_tx, 1 | N).
    The symbol axis joins the detectors' batch; Alamouti combines each
    symbol pair with the pair's mean H (the quasi-static receiver, so the
    channel's motion within a pair shows as the Doppler floor). Returns
    (s (B, n_streams, S, N), eff_var (B, n_streams, S, N')), or for ML its
    LLRs (B, n_tx, S, N·bps) and None."""
    mc = cfg.mimo
    B, n_rx, S, N = y.shape
    if mc.scheme == MIMOScheme.ALAMOUTI:
        yp = y.view(B, n_rx, S // 2, 2, N).movedim(2, 1)  # (B, P, n_rx, 2, N)
        h_pair = h_t.reshape(B, S // 2, 2, n_rx, 2, -1).mean(dim=2)  # (B, P, n_rx, 2, N')
        s, eff = mo.alamouti_combine(yp, h_pair, nv)  # (B, P, 2, N), (B, P, 1, N')
        eff = eff.expand(B, S // 2, 2, eff.shape[-1])
        return s.reshape(B, 1, S, N), eff.reshape(B, 1, S, -1)
    ys = y.movedim(2, 1)[:, :, :, None, :]  # (B, S, n_rx, 1, N)
    if mc.scheme == MIMOScheme.MRC:
        s, eff = mo.mrc_combine(ys, h_t, nv)  # (B, S, 1, N), (B, S, 1, N')
        return s.movedim(2, 1), eff.movedim(2, 1)
    if mc.detector == "ml":
        return mo.mux_detect_ml(ys, h_t, nv, cfg.modulation)[:, :, :, 0].movedim(1, 2), None
    if mc.detector == "sic":
        s, eff = mo.mux_detect_sic(ys, h_t, nv, cfg.modulation)
    elif cfg.equalizer == Equalizer.ZF:
        s, eff = mo.mux_detect_zf(ys, h_t, nv)
    else:
        s, eff = mo.mux_detect_mmse(ys, h_t, nv)
    return s[:, :, :, 0].movedim(1, 2), eff[:, :, :, 0].movedim(1, 2)


# eff_var's floor where the whitening takes 1/√eff_var: below any variance
# a float32 link reaches (the detectors floor nv at 1e-12).
_EFF_FLOOR = 1e-30


def whitened_llrs(cfg: LinkConfig, s: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """``llr_maxlog(s, mod, eff_var)`` of the detectors' estimates s
    (B, K, S, N) on kernel C's post-FFT mode (pipeline.py:1017-1031): with
    g = 1/√eff_var, C takes y = s·g, h = g (hi = 0) and nv = 1, so it forms
    conj(h)·y/|h|² = s and scales the LLRs by |h|² = 1/eff_var. eff_var is
    (B, K, 1 | S, 1 | N): one h row a link, or one a symbol (per-symbol
    detection). SC-FDMA despreads first: the tone mean of eff_var per
    symbol row (h is then a (B·K, S, N) plane), then ``ifft``·√N. Returns
    (B, K, S, N·bps).

    Where eff_var > 1e12, |h|² falls under C's 1e-12 floor: there
    |LLR| < ~1e-11 and its sign is not the JAX one."""
    B, K, S, N = s.shape
    if cfg.dft_spread:
        eff = torch.broadcast_to(eff, s.shape).mean(dim=-1, keepdim=True)
        s = (ifft(s) * N ** 0.5).to(torch.complex64)
    g = torch.rsqrt(torch.clamp(eff, min=_EFF_FLOOR))  # (B, K, 1 | S, 1 | N)
    y = torch.view_as_real((s * g).reshape(B * K, S, N))
    hr = g.expand(B, K, g.shape[2], N).reshape(B * K, g.shape[2], N).contiguous()
    llrs = _kc.llr_chain(y, None, hr, torch.zeros_like(hr), cfg.modulation, 1.0)
    return llrs.view(B, K, S, N * cfg.modulation.bits_per_symbol)


@functools.lru_cache(maxsize=None)
def _midamble_tables(n_symbols: int, K: int, n_tx: int):
    """The static interpolation of the midamble estimates
    (pipeline.py:964-978), numpy as in the JAX link: per data symbol its
    block b and the next (the last block's own), the weight w (float32) of
    the next, and its phase time (g − t_0)/period (float32), g the
    symbol's row in the frame and t_b block b's first preamble row."""
    period = n_tx + K
    nb = n_symbols // K
    s_idx = np.arange(n_symbols)
    b_of = s_idx // K
    g = b_of * period + n_tx + (s_idx % K)
    t_b = b_of * period + 0.0
    w = np.clip((g - t_b) / period, 0.0, 1.0).astype(np.float32)
    b_next = np.minimum(b_of + 1, nb - 1)
    return b_of, b_next, w, ((g - t_b[0]) / period).astype(np.float32)


def estimate_mimo_midamble(cfg: LinkConfig, y: torch.Tensor):
    """The midamble receive (pipeline.py:910-981) on the post-FFT frame
    y (B, n_rx, S', N): per block the per-pair LS of its preamble rows over
    ``preamble_ref`` — its tone mean on RAYLEIGH_TIME, its
    ``_dft_projection_full`` product with the DFT estimator, else raw —;
    the common-phase slope dphi, the angle of the sum over every block
    product h_{b+1}·conj(h_b) of one channel (blocks, antennas and tones);
    each block derotated by b·dphi and each TX antenna's estimate by its
    slot's t·dphi/period; the linear interpolation between blocks; the
    exact per-symbol phase dphi·(g − t_0)/period. In the JAX float32
    order. Returns (h_t (B, S, n_rx, n_tx, 1 | N), the data rows
    (B, n_rx, S, N))."""
    mc = cfg.mimo
    B, n_rx = y.shape[:2]
    N, S, K, n_tx = cfg.ofdm.n_fft, cfg.n_symbols, mc.midamble_period, mc.n_tx
    nb, period = S // K, n_tx + K
    dev = y.device
    yb = y.view(B, n_rx, nb, period, N)
    raw = yb[:, :, :, :n_tx] / torch.from_numpy(preamble_ref(cfg)).to(dev)  # (B, n_rx, nb, n_tx, N)
    if cfg.channel.model == ChannelModel.RAYLEIGH_TIME:
        h_b = raw.mean(dim=-1, keepdim=True)
    elif cfg.estimator == ChannelEstimator.DFT:
        h_b = pil._project(raw, pil._table(pil._dft_projection_full, raw, N,
                                           min(cfg.ofdm.cp_len + 1, N)))
    else:
        h_b = raw
    h_b = h_b.movedim(2, 1)  # (B, nb, n_rx, n_tx, N')
    data = yb[:, :, :, n_tx:].reshape(B, n_rx, S, N)
    if nb >= 2:
        dphi = torch.angle(torch.sum(h_b[:, 1:] * torch.conj(h_b[:, :-1]), dim=(1, 2, 3, 4)))
    else:
        dphi = torch.zeros((B,), dtype=torch.float32, device=dev)
    blocks = torch.arange(nb, dtype=torch.float32, device=dev)
    h_b = h_b * pil._phase(-dphi[:, None] * blocks)[:, :, None, None, None]
    slot = torch.arange(n_tx, dtype=torch.float32, device=dev) * (dphi / period)[:, None]
    h_b = h_b * pil._phase(-slot)[:, None, None, :, None]
    b_of, b_next, w, t_phase = (torch.from_numpy(t).to(dev)
                                for t in _midamble_tables(S, K, n_tx))
    wj = w[:, None, None, None]
    h_t = (1.0 - wj) * h_b[:, b_of] + wj * h_b[:, b_next]
    h_t = h_t * pil._phase(dphi[:, None] * t_phase)[:, :, None, None, None]
    return h_t, data


def mimo_rx(cfg: LinkConfig, rx, h: torch.Tensor | None, noise_var: float) -> torch.Tensor:
    """The MIMO receive (pipeline.py:907-1014) on the RX planes (B, n_rx, S',
    L): ``ofdm_rx``; with a midamble schedule the tracked per-symbol
    estimate (``estimate_mimo_midamble``); with a head preamble the per-pair
    estimate (``estimate_mimo_preamble`` on the preamble rows times
    PILOT_VALUE/``preamble_ref``, DFT-projected onto min(cp+1, N) taps with
    the DFT estimator); then the detector — per symbol
    (``mimo_detect_per_symbol``) on a per-symbol h (B, S, n_rx, n_tx, ·),
    else ``mimo_detect`` —; the LLRs (``whitened_llrs``, ML's from the
    detector). ``h`` (the genie response) is read with genie CSI only.
    Returns (B, n_streams, S, N·bps) float32 in the bits' order."""
    N, cp = cfg.ofdm.n_fft, cfg.ofdm.cp_len
    nv = max(float(noise_var), 1e-12)
    y = ofdm_rx(torch.complex(*rx), cp)  # (B, n_rx, S', N)
    n_pre = n_preamble(cfg)
    if midamble(cfg):
        h, y = estimate_mimo_midamble(cfg, y)
    elif n_pre:
        ref = torch.from_numpy(preamble_ref(cfg)).to(y.device)
        norm = torch.tensor(pil.PILOT_VALUE, dtype=torch.complex64, device=y.device) / ref
        n_taps = min(cp + 1, N) if cfg.estimator == ChannelEstimator.DFT else 0
        h = pil.estimate_mimo_preamble(y[:, :, :n_pre] * norm, n_taps)
        y = y[:, :, n_pre:]
    detect = mimo_detect_per_symbol if h.ndim == 5 else mimo_detect
    s, eff = detect(cfg, y, h, nv)
    return s if eff is None else whitened_llrs(cfg, s, eff)


def mimo_llrs(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, idx: torch.Tensor, *,
              fading=None, noise=None, phase=None) -> torch.Tensor:
    """A's MIMO grid → LLRs (B, n_streams, S, N·bps): ``mimo_tx``, then
    ``mimo_channel`` (an aligned link) or ``mimo_stream`` and
    ``mimo_acquire`` (a timing offset or CFO), then ``mimo_rx``."""
    tx = mimo_tx(cfg, idx)
    kw = dict(fading=fading, noise=noise, phase=phase)
    if cfg.channel.impaired:
        z = mimo_stream(cfg, seed, ch_ids, tx, **kw)
        del tx
        rx, h = mimo_acquire(cfg, z)[2], None
        del z
    else:
        rx, h = mimo_channel(cfg, seed, ch_ids, tx, **kw)
    return mimo_rx(cfg, rx, h, mimo_noise_var(cfg))


def mimo_llr_link(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, bits: torch.Tensor, *,
                  fading=None, noise=None, phase=None) -> torch.Tensor:
    """The MIMO link as bits → LLRs (the JAX ``mimo_llr_link``): bits
    (B, n_streams, S, N·bps) int8 → float32 LLRs of that shape and order.
    The draws are keyed on ``seed`` and ``ch_ids`` unless injected
    (``mimo_channel``, ``mimo_stream``)."""
    bps = cfg.modulation.bits_per_symbol
    idx = _bits_to_ints(bits, bps).to(out_dtype(bps))
    return mimo_llrs(cfg, seed, ch_ids, idx.reshape(bits.shape[0], -1, cfg.ofdm.n_fft),
                     fading=fading, noise=noise, phase=phase)


def _mimo_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, want_llrs: bool):
    """(bit_errors, llrs | None) of the MIMO link: A's grid drawn once, then
    the link in passes of ``CHUNK`` channels, each counted against A's bits
    in torch (``kernels.demod.count_errors``)."""
    bps = cfg.modulation.bits_per_symbol

    def link(_, ids, idx):
        llrs = mimo_llrs(cfg, seed, ids, idx)
        errors = _kc.count_errors(llrs.reshape(*idx.shape[:2], -1), idx, bps)
        return (errors, llrs) if want_llrs else errors

    out = _in_passes(link, ch_ids, draw_mimo_idx(cfg, seed, ch_ids))
    return out if want_llrs else (out, None)


def simulate_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, want_llrs: bool = False):
    """The link over explicit GLOBAL channel ids (B,) int32 on the target
    device: (bit_errors, bits_counted, llrs | None). bits_counted is
    n_data_symbols × bits_per_ofdm_symbol: the payload alone. As in the JAX
    ``_simulate_one``, a MIMO config takes the MIMO link (``_mimo_core``;
    llrs (B, n_streams, S, N·bps)) and a timing offset or CFO the acquired
    link: ``acquired_stream``, ``acquire_payload``, then the pilot receive
    with ``skip_iq`` (the raw stream was compensated)."""
    B = ch_ids.shape[0]
    counted = torch.full((B,), cfg.n_data_symbols * cfg.bits_per_ofdm_symbol, dtype=torch.int32,
                         device=ch_ids.device)
    if cfg.mimo is not None:
        errors, llrs = _mimo_core(cfg, seed, ch_ids, want_llrs)
        return errors, counted, llrs
    idx = draw_idx(cfg, seed, ch_ids)
    acquired = cfg.channel.impaired
    if acquired:
        rx = acquire_payload(cfg, acquired_stream(cfg, seed, ch_ids, idx))[2]
        h_freq, nv = None, fast.noise_var(cfg)
    else:
        rx, h_freq, nv = apply_channel(cfg, seed, ch_ids, tx_idx(cfg, idx))
    if want_llrs:
        llrs, _ = rx_chain(cfg, rx, h_freq, nv, skip_iq=acquired)
        errors = _kc.count_errors(llrs, payload_of(cfg, idx), cfg.modulation.bits_per_symbol)
        return errors, counted, llrs
    return count_errors(cfg, rx, h_freq, nv, idx, skip_iq=acquired), counted, None


def simulate(cfg: LinkConfig, seed: int, device="cuda", want_llrs: bool = False) -> LinkResult:
    """Run cfg.n_channels independent links as one batched program on
    ``device`` (the card unless the caller asks for the CPU). Every draw
    is keyed by global channel id, so channels [a, b) alone give the
    counts they have in the full run."""
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    errors, counted, llrs = simulate_core(cfg, seed, ch_ids, want_llrs)
    return LinkResult(bit_errors=errors, bits_counted=counted, llrs=llrs)


def make_simulate_fn(cfg: LinkConfig, device="cuda", want_llrs: bool = False):
    """``simulate`` with cfg and device bound: fn(seed) → LinkResult."""
    return functools.partial(simulate, cfg, device=device, want_llrs=want_llrs)
