"""Fast batched link: keyed payload → TX + channel → RX count.

Port of ``sdr_tpu/link/fast.py`` (the keyed fast engine). The whole link
runs at batch level on (n_channels, n_symbols, ·) planes:

    payload draw (kernel A) → Gray map, IDFT, CP, channel, AWGN
    (kernel B) → CP strip, DFT, equalize, max-log LLR, error count
    (kernel C in the rows layout, kernel F channels-last)

Every random draw is keyed Philox (``core/prng.py``), a pure function of
(seed, role, global channel id, position): the TX side and the RX
side's recompute draw the same payload and fading independently, and
the result for a channel does not depend on the batch it runs in
(channels [0, k) alone give the same counts as in the full run).

Channel routes (JAX fast.py:250-411), the same on the CPU (plain
versions) and on the card (kernels):

- fused: every model whose FIR has at most 16 taps runs in kernel B —
  flat gains per link (RAYLEIGH_FLAT, RICIAN) or per symbol
  (RAYLEIGH_TIME), static taps (MULTIPATH) or per-symbol taps
  (MULTIPATH_TIME), then the noise;
- staged (``apply_channel_fast``): MULTIPATH and MULTIPATH_TIME with 17
  to cp+1 taps — kernel B with the channel off, then kernel E for the
  FIR (XLA before the channel kernel in the JAX route) and the noise in
  one pass. Both routes draw the noise with one counter and run the FIR
  in one order, so they agree sample for sample.

Receive routes (fast.py:414-511): MULTIPATH_TIME with at most 8 taps
hands its per-symbol taps to kernel C, which builds the response in the
kernel; otherwise kernel C takes h (B, 1, N) (flat models, MULTIPATH
through ``freq_response``) or (B, S, N) (RAYLEIGH_TIME, MULTIPATH_TIME);
``layout="cl"`` relayouts the samples to (S·(N+cp), B) and counts with
kernel F on h (N, B) — per-link channels only, as in the JAX engine.

SC-FDMA (``dft_spread``, full grid, fast.py:53-65 and :508): the DFT
precode and the IFFT cancel, so the TX is the constellation scaled by
N^-1/2 with the CP, plain torch on the card (XLA outside any kernel in
the JAX engine); the channel always takes the staged route, and kernel
C's ``despread`` mode receives (SC-FDE), at any N up to 4096.

The BER is validated statistically against theory (``link/ber.py``,
and the BER over the drawn channel), as the JAX engine's is; it is a
different stream from the JAX engine's threefry and on-core draws.

Not covered: pilots and MIMO raise ``NotImplementedError`` naming
``link.pipeline.simulate``, where they run, as in the JAX package.

The entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU; without a card they raise, nothing moves to the CPU.
"""

from __future__ import annotations

import functools

import torch

from sdr_tpu_torch.core.config import ChannelModel, LinkConfig
from sdr_tpu_torch.kernels import demod as _kc
from sdr_tpu_torch.kernels import demod_cl as _kd
from sdr_tpu_torch.kernels import tx as _kb
from sdr_tpu_torch.kernels.channel import fade_awgn
from sdr_tpu_torch.kernels.payload import out_dtype, payload_idx
from sdr_tpu_torch.ops import channel as chan
from sdr_tpu_torch.ops.demod import demod_count_chain, demod_count_chain_cl
from sdr_tpu_torch.ops.modulation import constellation
from sdr_tpu_torch.ops.ofdm import cp_insert

_PER_SYMBOL = (ChannelModel.RAYLEIGH_TIME, ChannelModel.MULTIPATH_TIME)
_SELECTIVE = (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME)
LAYOUTS = ("auto", "rows", "cl")


def check_supported(cfg: LinkConfig, layout: str = "auto") -> None:
    """Raise for what this engine does not run: ``NotImplementedError``
    naming the ROADMAP entry for what is still to port, and for
    per-symbol fading or SC-FDMA under ``layout="cl"`` (the JAX engine
    refuses the first and never routes the second there)."""
    if cfg.pilot_spacing:
        raise NotImplementedError(
            "fast_simulate is the full-grid throughput path; pilot-based "
            "estimation lives in link.pipeline.simulate (pilot_spacing=0 here)"
        )
    if cfg.mimo is not None:
        raise NotImplementedError(
            "fast_simulate is SISO; MIMO links run in "
            "link.pipeline.simulate (set mimo=None here)"
        )
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "cl" and cfg.channel.model in _PER_SYMBOL:
        raise NotImplementedError(
            "channels-last demod takes a per-link channel plane; "
            "per-symbol fading models run in the rows layout"
        )
    if layout == "cl" and cfg.dft_spread:
        raise NotImplementedError(
            "SC-FDMA (dft_spread) receives through kernel C's despread mode "
            "in the rows layout"
        )


def noise_var(cfg: LinkConfig) -> float:
    """Subcarrier noise variance nv = 1/(Eb/N0 · bps), a host float."""
    return 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * cfg.modulation.bits_per_symbol)


def _n_taps(cfg: LinkConfig) -> int:
    """FIR taps of a selective model (len(pdp)); 0 for the others."""
    return len(cfg.channel.pdp) if cfg.channel.model in _SELECTIVE else 0


def select_layout(cfg: LinkConfig, n_ch: int, platform: str | None = None) -> str:
    """Auto rule for the demod layout: "rows", as in the JAX engine
    (fast.py:187-201), whose TX, channel and index planes are rows-major
    and whose relayout cost more than the channels-last demod won on the
    TPU. ``layout="cl"`` stays an explicit choice; ``chip_smoke.py``
    times both layouts on the H100."""
    del cfg, n_ch, platform
    return "rows"


def layout_supported_cl(cfg: LinkConfig, n_ch: int) -> bool:
    """Whether ``layout="cl"`` applies: plain OFDM, a per-link channel
    plane, and shapes kernel F takes (N a power of two ≤ 4096: configs 3
    and 5 run it in F's wideband mode)."""
    if cfg.dft_spread or cfg.channel.model in _PER_SYMBOL:
        return False
    shape = (cfg.n_symbols * (cfg.ofdm.n_fft + cfg.ofdm.cp_len), n_ch)
    return _kd.supported(shape, cfg.ofdm.n_fft, cfg.ofdm.cp_len)


def _to_cl(re: torch.Tensor, im: torch.Tensor):
    """(B, S, L) planar → channels-last (S·L, B): a torch relayout (the
    JAX engine's is an XLA relayout fused into the channel stage)."""
    B, S, L = re.shape
    return (re.permute(1, 2, 0).reshape(S * L, B).contiguous(),
            im.permute(1, 2, 0).reshape(S * L, B).contiguous())


def draw_idx(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor) -> torch.Tensor:
    """Per-channel transmitted symbol indices (B, S, N), int8 (bps ≤ 7)
    or int16 — kernel A on the card."""
    return payload_idx(cfg.n_symbols, cfg.ofdm.n_fft, cfg.modulation.bits_per_symbol,
                       seed, ch_ids)


def fading_params(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor):
    """The channels' fading state, drawn once from the keys: the static
    models' (h, taps) — h (B, 1, 1) flat gain (RAYLEIGH_FLAT, RICIAN),
    taps (B, L) (MULTIPATH), either None —, the Jakes (θ, φ) of
    RAYLEIGH_TIME and (θ, φ, amps) of MULTIPATH_TIME, which ``fading_at``
    evaluates at any symbols."""
    model = cfg.channel.model
    if model == ChannelModel.RAYLEIGH_FLAT:
        return chan.rayleigh_flat(seed, ch_ids), None
    if model == ChannelModel.RICIAN:
        return chan.rician_flat(seed, ch_ids, cfg.channel.k_factor), None
    if model == ChannelModel.RAYLEIGH_TIME:
        return chan.jakes_params(seed, ch_ids)
    if model == ChannelModel.MULTIPATH:
        return None, chan.multipath_taps(seed, ch_ids, cfg.channel.pdp)
    if model == ChannelModel.MULTIPATH_TIME:
        return chan.multipath_time_params(seed, ch_ids, cfg.channel.pdp)
    return None, None


def fading_at(cfg: LinkConfig, params, s0: int, n_symbols: int):
    """(h, taps) of ``fading_params``' state at the absolute symbols s0 …
    s0+n_symbols−1: the per-symbol models evaluated there — h (B, S, 1)
    Jakes gain (RAYLEIGH_TIME), taps (B, S, L) (MULTIPATH_TIME) —, the
    static ones as drawn. A time block (``link.stream``) and the whole
    frame (``fade_state``) evaluate the same state."""
    model = cfg.channel.model
    if model not in _PER_SYMBOL:
        return params
    t = torch.arange(s0, s0 + n_symbols, dtype=torch.float32, device=params[0].device)
    if model == ChannelModel.RAYLEIGH_TIME:
        return chan.jakes_eval(*params, t, cfg.channel.doppler_norm)[:, :, None], None
    return None, chan.multipath_time_taps_at(*params, t, cfg.channel.doppler_norm)


def fade_state(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, plane: bool = True):
    """Per-channel fading state of the whole frame from the keys: (h,
    taps), either None (``fading_at`` symbols 0 … S−1).

    h: (B, 1, 1) flat gain (RAYLEIGH_FLAT, RICIAN); (B, S, 1) per-symbol
    Jakes gain (RAYLEIGH_TIME); (B, 1, N) or (B, S, N) frequency response
    (MULTIPATH, MULTIPATH_TIME). taps: (B, L) static or (B, S, L)
    per-symbol TDL taps. ``plane=False`` leaves the selective models' h
    out (None): the engine derives it (``rx_plane``) only where its
    receive route reads it."""
    h, taps = fading_at(cfg, fading_params(cfg, seed, ch_ids), 0, cfg.n_symbols)
    if plane and taps is not None:
        h = rx_plane(taps, cfg.ofdm.n_fft)
    return h, taps


def rx_plane(taps: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The channel plane of FIR taps: (B, L) → (B, 1, N), (B, S, L) →
    (B, S, N) complex64."""
    h = chan.freq_response(taps, n_fft)
    return h[:, None, :] if taps.ndim == 2 else h


def scfdma_tx(cfg: LinkConfig, idx: torch.Tensor):
    """Full-grid SC-FDMA TX (fast.py:53-65): the time waveform is the
    constellation sequence scaled by N^-1/2, with the CP. Planar
    (B, S, N+cp) float32."""
    pts = constellation(cfg.modulation, idx.device)[idx.to(torch.int64)] * cfg.ofdm.n_fft ** -0.5
    return _planar(cp_insert(pts, cfg.ofdm.cp_len))


def _planar(z: torch.Tensor):
    """complex → contiguous float32 (real, imag)."""
    return z.real.to(torch.float32).contiguous(), z.imag.to(torch.float32).contiguous()


def _gains(h: torch.Tensor):
    """(B, 1 | S, 1) complex gains → (B, 1 | S) float32 planes."""
    return _planar(h[:, :, 0])


def _noise_kw(seed, ch_ids, noise):
    return dict(noise=noise) if noise is not None else dict(seed=seed, ch_ids=ch_ids)


def _laid_out(re, im, layout: str):
    return _to_cl(re, im) if layout == "cl" else (re, im)


def tx_with_channel(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, idx: torch.Tensor,
                    h: torch.Tensor | None = None, taps: torch.Tensor | None = None,
                    noise=None, layout: str = "rows"):
    """TX + channel over explicit indices → impaired planar (re, im),
    each (B, S, N+cp) float32, or channels-last (S·(N+cp), B) when
    ``layout == "cl"``. The fused route (kernel B alone) for every model
    with at most 16 taps; the staged one (``apply_channel_fast``) above.

    ``h``/``taps`` override the keyed fade state (``fade_state``'s pair;
    the selective models read only the taps); ``noise`` injects (n_re,
    n_im) N(0, 1) planes in place of the keyed noise — the injection form
    the parity tests use. SC-FDMA takes ``scfdma_tx`` and the staged
    channel, as the JAX engine does (its ``want_fused`` excludes
    ``dft_spread``)."""
    check_supported(cfg, layout)
    model = cfg.channel.model
    cp, mod = cfg.ofdm.cp_len, cfg.modulation
    if cfg.dft_spread:
        return apply_channel_fast(cfg, seed, ch_ids, *scfdma_tx(cfg, idx), h=h, taps=taps,
                                  noise=noise, layout=layout)
    if model == ChannelModel.IDENTITY:
        return _laid_out(*_kb.tx_chain(idx, cp, mod), layout)
    if _n_taps(cfg) > _kb.MAX_TAPS:
        re, im = _kb.tx_chain(idx, cp, mod)
        return apply_channel_fast(cfg, seed, ch_ids, re, im, h=h, taps=taps, noise=noise,
                                  layout=layout)
    if h is None and taps is None:
        h, taps = fade_state(cfg, seed, ch_ids, plane=False)
    tvar = noise_var(cfg) / cfg.ofdm.n_fft
    kw = _noise_kw(seed, ch_ids, noise)
    if model in _SELECTIVE:
        tr, ti = _planar(taps)
        re, im = _kb.tx_channel(idx, cp, mod, noise_var=tvar, taps_r=tr, taps_i=ti, **kw)
    else:
        hs_r, hs_i = (None, None) if h is None else _gains(h)
        re, im = _kb.tx_channel(idx, cp, mod, hs_r, hs_i, tvar, **kw)
    return _laid_out(re, im, layout)


def apply_channel_fast(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, re: torch.Tensor,
                       im: torch.Tensor, h: torch.Tensor | None = None,
                       taps: torch.Tensor | None = None, noise=None, layout: str = "rows"):
    """The staged channel over an externally built waveform (B, S, N+cp):
    kernel E in one pass — the FIR of a selective model (over the whole
    CP'd stream for static taps, per symbol with the previous symbol's
    tail as history for per-symbol taps) or the gains, then the keyed
    noise. The route the engine takes for 17 to cp+1 taps and for
    SC-FDMA, and the channel stage a coded engine calls. Arguments as
    ``tx_with_channel``."""
    check_supported(cfg, layout)
    model = cfg.channel.model
    if model == ChannelModel.IDENTITY:
        return _laid_out(re, im, layout)
    if h is None and taps is None:
        h, taps = fade_state(cfg, seed, ch_ids, plane=False)
    hs_r = hs_i = taps_r = taps_i = None
    if model in _SELECTIVE:
        taps_r, taps_i = _planar(taps)
    elif h is not None:
        hs_r, hs_i = _gains(h)
    tvar = noise_var(cfg) / cfg.ofdm.n_fft
    re, im = fade_awgn(re, im, hs_r, hs_i, tvar, taps_r=taps_r, taps_i=taps_i,
                       **_noise_kw(seed, ch_ids, noise))
    return _laid_out(re, im, layout)


def tx_channel_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, layout: str = "rows"):
    """Payload draw + TX + channel for explicit global channel ids."""
    return tx_with_channel(cfg, seed, ch_ids, draw_idx(cfg, seed, ch_ids), layout=layout)


def rx_count_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, re: torch.Tensor,
                  im: torch.Tensor, h: torch.Tensor | None = None,
                  taps: torch.Tensor | None = None, idx: torch.Tensor | None = None,
                  layout: str = "rows"):
    """Demod + error count over impaired planar samples ((B, S, N+cp),
    or (S·(N+cp), B) under ``layout="cl"``).

    Recomputes the channel and the transmitted indices from the keys
    (both pure functions of them) unless given explicitly, so the
    samples are the only data taken from the TX side. SC-FDMA receives
    through kernel C's ``despread`` mode on the h plane. Returns
    per-channel (bit_errors, bits_counted), both (B,) int32."""
    check_supported(cfg, layout)
    B = ch_ids.shape[0]
    S, N, cp = cfg.n_symbols, cfg.ofdm.n_fft, cfg.ofdm.cp_len
    mod = cfg.modulation
    nv = max(noise_var(cfg), 1e-12)
    if h is None and taps is None:
        h, taps = fade_state(cfg, seed, ch_ids, plane=False)
    if idx is None:
        idx = draw_idx(cfg, seed, ch_ids)
    counted = torch.full((B,), S * N * mod.bits_per_symbol, dtype=torch.int32, device=re.device)
    if (layout == "rows" and cfg.channel.model == ChannelModel.MULTIPATH_TIME
            and not cfg.dft_spread and taps is not None and taps.shape[-1] <= _kc.MAX_TAPS):
        # TDL taps route: the response is built in kernel C.
        errors = demod_count_chain(re, im, None, None, idx, cp, mod, nv, taps=_planar(taps))
        return errors, counted
    if h is None and taps is not None:
        h = rx_plane(taps, N)
    if layout == "cl":
        hb = torch.ones((B, N), dtype=torch.complex64, device=re.device) if h is None else (
            h[:, 0, :].to(torch.complex64).expand(B, N))
        hr_t, hi_t = _planar(hb.T)
        idx_t = idx.permute(1, 2, 0).reshape(S * N, B).to(out_dtype(mod.bits_per_symbol))
        errors = demod_count_chain_cl(re, im, hr_t, hi_t, idx_t.contiguous(), cp, mod, nv)
        return errors, counted
    if h is None:
        hr = torch.ones((B, 1, N), dtype=torch.float32, device=re.device)
        hi = torch.zeros((B, 1, N), dtype=torch.float32, device=re.device)
    else:
        hr, hi = _planar(h.to(torch.complex64).expand(B, h.shape[1], N))
    errors = demod_count_chain(re, im, hr, hi, idx, cp, mod, nv, despread=cfg.dft_spread)
    return errors, counted


def fast_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, layout: str = "auto"):
    """The batched link over explicit GLOBAL channel ids (B,) int32 on
    the target device. Returns per-channel (bit_errors, bits_counted).

    The payload and the fading are drawn once and handed to both sides;
    ``rx_count_core``'s own recompute (the same bits) serves callers
    that run the two sides apart. Both layouts draw the same per-channel
    randomness, so their BER statistics agree."""
    if layout == "auto":
        layout = select_layout(cfg, ch_ids.shape[0])
    check_supported(cfg, layout)
    idx = draw_idx(cfg, seed, ch_ids)
    h, taps = fade_state(cfg, seed, ch_ids, plane=False)
    re, im = tx_with_channel(cfg, seed, ch_ids, idx, h=h, taps=taps, layout=layout)
    return rx_count_core(cfg, seed, ch_ids, re, im, h=h, taps=taps, idx=idx, layout=layout)


def fast_simulate(cfg: LinkConfig, seed: int, device="cuda", layout: str = "auto"):
    """Full link over (n_channels, n_symbols) as one batched program on
    ``device`` (the card unless the caller asks for the CPU). Returns
    (bit_errors (n_channels,) int32, bits_counted)."""
    check_supported(cfg, layout)
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    return fast_core(cfg, seed, ch_ids, layout=layout)


def make_fast_fn(cfg: LinkConfig, device="cuda", layout: str = "auto"):
    """fast_simulate with cfg and device bound: fn(seed)."""
    check_supported(cfg, layout)
    return functools.partial(fast_simulate, cfg, device=device, layout=layout)
