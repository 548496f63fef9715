"""Channel models the fast link uses: AWGN, flat Rayleigh and Rician,
Jakes block fading, static multipath and the per-tap-Jakes TDL.

Port of ``sdr_tpu/ops/channel.py`` (channel.py:31-371: the subset on the
fast engine's path, and the receiver front end's LO phase noise and I/Q
mismatch with its blind compensator, channel.py:63-156). The JAX functions take a ``jax.random`` key per
channel; here every draw is keyed Philox (``sdr_tpu_torch.core.prng``):
a pure function of (seed, role, global channel id, position), so a
channel's fading and noise do not depend on the batch it is computed
in. Lanes of the fading stream (``ROLE_FADING``), one per draw of a
model: 0 the complex Gaussians (flat Rayleigh gain, Rician diffuse
part, multipath taps), 1 the Rician LOS phase, 2 the Jakes state
(θ on word 0, φ on word 1; counter (channel, tap, path)). The Wiener
phase walk's increments are on ``ROLE_PHASE`` (``wiener_increments``).

The deterministic halves — ``jakes_eval``, ``multipath_time_taps_at``,
``symbol_history``, ``apply_multipath``, ``freq_response`` — follow the
JAX functions operation for operation, so the same (θ, φ) or taps give
the same gains and waveforms in both packages.

Noise calibration (as in the JAX package): constellations have unit
average power per subcarrier. With the unscaled forward / 1/N inverse
FFT a unit-power subcarrier symbol is a time signal of power 1/N, and
the RX forward FFT multiplies noise power by N, so ``time_noise_var``
divides the subcarrier variance by n_fft. Es/N0 = bits_per_symbol·Eb/N0.
"""

from __future__ import annotations

import math

import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.ops.fft import fft

JAKES_LANE = 2  # the fading-stream lane of the Jakes (θ, φ) draws
JAKES_PATHS = 16  # sum-of-sinusoids paths, the JAX default


def ebno_db_to_noise_var(ebno_db, bits_per_symbol: int) -> torch.Tensor:
    """Eb/N0 [dB] → complex noise variance N0 at the subcarrier (Es = 1),
    computed in float32 like the JAX function."""
    ebno = torch.as_tensor(ebno_db, dtype=torch.float32)
    esno = 10.0 ** (ebno / 10.0) * bits_per_symbol
    return 1.0 / esno


def time_noise_var(noise_var, n_fft: int) -> torch.Tensor:
    """Subcarrier noise variance → time-domain (pre-FFT) variance."""
    return torch.as_tensor(noise_var, dtype=torch.float32) / n_fft


def cgauss(seed: int, role: int, ch_ids: torch.Tensor, shape, var=1.0,
           lane: int = 0) -> torch.Tensor:
    """CN(0, var) complex64 (B, *shape) for a per-channel 2-D ``shape``:
    Box–Muller on words 0 and 1 of Philox(seed ^ role, (ch, i, j, lane))."""
    g1, g2 = prng.normal_pair(seed, role, ch_ids, shape, lane)
    std = math.sqrt(float(var) * 0.5)
    return torch.complex(g1 * std, g2 * std)


def awgn(x: torch.Tensor, noise_var, seed: int, ch_ids: torch.Tensor) -> torch.Tensor:
    """y = x + CN(0, noise_var) for x (B, S, L), the noise keyed by
    (seed ^ ROLE_NOISE, ch_ids[b], s, l) — the fused TX kernel's stream."""
    if x.ndim != 3:
        raise ValueError(f"awgn takes (B, S, L) samples, got {tuple(x.shape)}")
    n = cgauss(seed, prng.ROLE_NOISE, ch_ids, x.shape[1:])
    return x + n * math.sqrt(float(noise_var))


def rayleigh_flat(seed: int, ch_ids: torch.Tensor, n_pairs: int = 1) -> torch.Tensor:
    """Per-channel flat Rayleigh gain h ~ CN(0, 1), (B, 1, 1) complex64;
    (B, n_pairs, 1) for the antenna pairs of a MIMO link, pair p at counter
    (channel, p, 0) (pair 0 is the SISO draw)."""
    return cgauss(seed, prng.ROLE_FADING, ch_ids, (n_pairs, 1))


def rician_flat(seed: int, ch_ids: torch.Tensor, k_factor: float,
                n_pairs: int = 1) -> torch.Tensor:
    """Per-channel flat Rician gain with linear K-factor, E|h|² = 1:
    h = √(K/(K+1))·e^{jφ} + √(1/(K+1))·CN(0, 1), φ ~ U[0, 2π) drawn on
    lane 1 of the fading stream. (B, 1, 1) complex64, or (B, n_pairs, 1)
    as ``rayleigh_flat``."""
    K = float(k_factor)
    phase = prng.uniform_plane(seed, prng.ROLE_FADING, ch_ids, (n_pairs, 1), lane=1)
    phase = phase * (2.0 * math.pi)
    los = math.sqrt(K / (K + 1.0)) * torch.complex(torch.cos(phase), torch.sin(phase))
    return los + cgauss(seed, prng.ROLE_FADING, ch_ids, (n_pairs, 1), var=1.0 / (K + 1.0))


def jakes_params(seed: int, ch_ids: torch.Tensor, n_paths: int = JAKES_PATHS,
                 n_taps: int | None = None, n_pairs: int | None = None):
    """The Jakes sum-of-sinusoids state (θ, φ), each uniform on (0, 2π]:
    (B, n_paths) float32, or (B, n_taps, n_paths) for a TDL with one
    independent process per tap; with ``n_pairs`` (the antenna pairs of a
    MIMO link) a pair axis after the batch, (B, n_pairs, [n_taps,]
    n_paths). Words 0 and 1 of the fading stream's lane ``JAKES_LANE`` at
    counter (channel, row, path), row p·n_taps + l for tap l of pair p
    (p for a pair's gain; l for a SISO tap), so pair 0 is the SISO draw.

    The state is the whole realisation: ``jakes_eval`` gives the gains at
    any time index, so a run over symbols [t0, t1) evaluates the same
    sum as a run over the whole frame."""
    rows = (n_pairs or 1) * (n_taps or 1)
    w0, w1, _, _ = prng.keyed_words(seed, prng.ROLE_FADING, ch_ids, (rows, n_paths),
                                    lane=JAKES_LANE)
    shape = (ch_ids.shape[0], *((n_pairs,) if n_pairs else ()), *((n_taps,) if n_taps else ()),
             n_paths)
    theta = (prng.uniform_01(w0) * prng.TWO_PI_F32).reshape(shape)
    phi = (prng.uniform_01(w1) * prng.TWO_PI_F32).reshape(shape)
    return theta, phi


def jakes_eval(theta: torch.Tensor, phi: torch.Tensor, t, doppler_norm: float) -> torch.Tensor:
    """g[t] = (1/√P) Σ_p exp(i(2π·fd·t·cosθ_p + φ_p)) at time indices
    ``t`` (n_steps,). θ, φ (..., P) → (..., n_steps) complex64, E|g|² = 1."""
    t = torch.as_tensor(t, dtype=torch.float32, device=theta.device)
    n_paths = theta.shape[-1]
    ang = (
        2.0 * math.pi * doppler_norm * t[..., :, None] * torch.cos(theta)[..., None, :]
        + phi[..., None, :]
    )
    g = torch.complex(torch.cos(ang).sum(dim=-1), torch.sin(ang).sum(dim=-1))
    return (g / math.sqrt(n_paths)).to(torch.complex64)


def jakes_gains(seed: int, ch_ids: torch.Tensor, n_steps: int, doppler_norm: float,
                n_paths: int = JAKES_PATHS, n_pairs: int | None = None) -> torch.Tensor:
    """Per-channel time-varying Rayleigh gains (B, n_steps) complex64 by
    the Jakes model, or (B, n_pairs, n_steps) for the antenna pairs of a
    MIMO link (``jakes_params``' keying); ``doppler_norm`` = fd·T_step
    (steps = OFDM symbols for block fading per symbol). The
    autocorrelation approaches J₀(2π·fd·Δt) as n_paths grows."""
    theta, phi = jakes_params(seed, ch_ids, n_paths, n_pairs=n_pairs)
    t = torch.arange(n_steps, dtype=torch.float32, device=ch_ids.device)
    return jakes_eval(theta, phi, t, doppler_norm)


def _pdp_amps(pdp, device) -> torch.Tensor:
    """√(p/Σp) per tap, float32, normalised in float32 as the JAX code does."""
    p = torch.as_tensor(pdp, dtype=torch.float32, device=device)
    return torch.sqrt(p / torch.sum(p))


def multipath_taps(seed: int, ch_ids: torch.Tensor, pdp,
                   n_pairs: int | None = None) -> torch.Tensor:
    """Static Rayleigh taps for a power-delay profile (normalised to
    total power 1): (B, L) complex64 from lane 0 of the fading stream;
    with ``n_pairs``, (B, n_pairs, L) for the antenna pairs of a MIMO link,
    tap l of pair p at counter (channel, p, l) (pair 0 is the SISO draw)."""
    amps = _pdp_amps(pdp, ch_ids.device)
    taps = cgauss(seed, prng.ROLE_FADING, ch_ids, (n_pairs or 1, amps.shape[0])) * amps
    return taps if n_pairs else taps[:, 0, :]


def multipath_time_params(seed: int, ch_ids: torch.Tensor, pdp, n_paths: int = JAKES_PATHS,
                          n_pairs: int | None = None):
    """State of the time-varying TDL: per-tap Jakes (θ, φ), each
    (B, L, n_paths) or (B, n_pairs, L, n_paths) (``jakes_params``' keying:
    tap l of pair p at row p·L + l), and the static tap amplitudes
    √(p/Σp) (L,)."""
    amps = _pdp_amps(pdp, ch_ids.device)
    theta, phi = jakes_params(seed, ch_ids, n_paths, n_taps=amps.shape[0], n_pairs=n_pairs)
    return theta, phi, amps


def multipath_time_taps_at(theta, phi, amps, t, doppler_norm: float) -> torch.Tensor:
    """TDL taps c_l[t] = √p_l·g_l[t] at step indices ``t``: (..., n_steps, L)."""
    g = jakes_eval(theta, phi, t, doppler_norm)  # (..., L, n_steps)
    return g.transpose(-1, -2) * amps


def multipath_time_taps(seed: int, ch_ids: torch.Tensor, pdp, n_steps: int,
                        doppler_norm: float, n_paths: int = JAKES_PATHS,
                        n_pairs: int | None = None) -> torch.Tensor:
    """Per-tap-Jakes TDL taps for steps 0..n_steps-1: (B, n_steps, L), or
    (B, n_pairs, n_steps, L) for the antenna pairs of a MIMO link."""
    theta, phi, amps = multipath_time_params(seed, ch_ids, pdp, n_paths, n_pairs)
    t = torch.arange(n_steps, dtype=torch.float32, device=ch_ids.device)
    return multipath_time_taps_at(theta, phi, amps, t, doppler_norm)


def symbol_history(x: torch.Tensor, L: int) -> torch.Tensor | None:
    """Per-symbol FIR history for a (..., n_symbols, sym_len) grid: row s
    gets the last L−1 samples of row s−1, zeros for s = 0."""
    if L <= 1:
        return None
    tails = x[..., :-1, -(L - 1):]
    zeros = torch.zeros(x.shape[:-2] + (1, L - 1), dtype=x.dtype, device=x.device)
    return torch.cat([zeros, tails], dim=-2)


def apply_multipath(samples: torch.Tensor, taps: torch.Tensor,
                    history: torch.Tensor | None = None) -> torch.Tensor:
    """Causal FIR along the last axis: y[n] = Σ_l taps[..., l]·x[n−l],
    x[n<0] taken from ``history`` (the last L−1 samples of the preceding
    block) or zeros. An L-term shift-and-add, as in the JAX function."""
    L = taps.shape[-1]
    n = samples.shape[-1]
    if L == 1:
        return samples * taps[..., 0:1]
    if history is None:
        history = torch.zeros(samples.shape[:-1] + (L - 1,), dtype=samples.dtype,
                              device=samples.device)
    else:
        history = history[..., -(L - 1):]
    ext = torch.cat([history, samples], dim=-1)  # (..., L-1+n)
    y = torch.zeros_like(samples)
    for l in range(L):
        y = y + taps[..., l:l + 1] * ext[..., L - 1 - l:L - 1 - l + n]
    return y


def grid_fir(x: torch.Tensor, taps: torch.Tensor,
             history: torch.Tensor | None = None) -> torch.Tensor:
    """The fast engine's FIR over a (B, S, sym_len) grid of CP'd symbols
    (the plain version of kernel B's and kernel E's FIR modes).
    Static taps (B, L): each channel's whole stream through one FIR from
    ``history``. Per-symbol taps (B, S, L): each symbol through its own
    taps, the previous symbol's tail as history, ``history`` before
    symbol 0. ``history`` (B, L−1): the samples that precede the grid (a
    time block's halo, ``link.stream``), zeros when None."""
    L = taps.shape[-1]
    if history is not None and L > 1:
        history = history[..., -(L - 1):]
    if taps.ndim == 2:
        return apply_multipath(x.reshape(x.shape[0], -1), taps,
                               history=history).reshape(x.shape)
    hist = symbol_history(x, L)
    if hist is not None and history is not None:
        hist = torch.cat([history[:, None, :].to(hist.dtype), hist[:, 1:]], dim=1)
    return apply_multipath(x, taps, history=hist)


def freq_response(taps: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Per-subcarrier response H = FFT_N(taps zero-padded): (..., n_fft)
    complex64. With CP ≥ L−1 the FIR is circulant per OFDM symbol, so
    Y = H·X + N on the subcarriers."""
    L = taps.shape[-1]
    pad = torch.zeros(taps.shape[:-1] + (n_fft - L,), dtype=torch.complex64,
                      device=taps.device)
    return fft(torch.cat([taps.to(torch.complex64), pad], dim=-1))


def wiener_increments(seed: int, ch_ids: torch.Tensor, n: int) -> torch.Tensor:
    """The Wiener walk's N(0, 1) increments (B, n) float32 of samples
    0 … n−1: sample k is normal k mod 4 of counter (channel, 0, k div 4, 0)
    on ``seed ^ ROLE_PHASE`` — Box–Muller on words 0 and 1 (normals 0, 1)
    and on words 2 and 3 (normals 2, 3), four increments a Philox call.
    A pure function of (seed, channel, sample)."""
    n4 = -(-n // 4)
    w0, w1, w2, w3 = prng.keyed_words(seed, prng.ROLE_PHASE, ch_ids, (1, n4))
    g = torch.stack((*prng.box_muller(w0, w1), *prng.box_muller(w2, w3)), dim=-1)
    return g.reshape(ch_ids.shape[0], 4 * n4)[:, :n]


def wiener_phase(seed: int, ch_ids: torch.Tensor, n: int, std: float,
                 increments: torch.Tensor | None = None) -> torch.Tensor:
    """RX-LO phase-noise rotation e^{jθ[k]}, θ a Wiener walk: θ[k] =
    Σ_{i≤k} std·g[i] with g the keyed increments (``wiener_increments``)
    or the injected (B, n) N(0, 1) ``increments``. ``std`` is the
    per-sample increment in radians. Returns (B, n) complex64 of unit
    magnitude; the walk is a float32 cumsum, as in the JAX function."""
    g = wiener_increments(seed, ch_ids, n) if increments is None else increments
    theta = torch.cumsum(g.to(torch.float32) * torch.tensor(std, dtype=torch.float32), dim=-1)
    return torch.complex(torch.cos(theta), torch.sin(theta))


def iq_imbalance_coeffs(gain: float, phase_rad: float):
    """Widely-linear mixer coefficients (μ, ν) for y = μ·x + ν·x*:
    μ = (1 + g·e^{jφ})/2, ν = (1 − g·e^{jφ})/2 (Python complex)."""
    ge = gain * complex(math.cos(phase_rad), math.sin(phase_rad))
    return (1.0 + ge) / 2.0, (1.0 - ge) / 2.0


def apply_iq_imbalance(x: torch.Tensor, gain: float, phase_rad: float) -> torch.Tensor:
    """RX front-end I/Q mismatch y = μ·x + ν·conj(x) over complex x (any
    shape), applied after the noise."""
    mu, nu = iq_imbalance_coeffs(gain, phase_rad)
    c64 = dict(dtype=torch.complex64, device=x.device)
    return x * torch.tensor(mu, **c64) + torch.conj(x) * torch.tensor(nu, **c64)


def iq_compensate(r: torch.Tensor, diff_axis: int | None = None, diff_lag: int = 0) -> torch.Tensor:
    """Blind I/Q-image cancellation by exact properization, per channel.

    r: (B, ...) complex, the batch on axis 0. The moments of each channel
    — c = mean(m²), p = mean(|m|²) over every axis but the batch (the JAX
    function's whole-array means under ``vmap``) — give the minimal-|w|
    root w of c̄·w² − 2p·w + c = 0, and z = r − w·conj(r). m is r itself,
    the consecutive differences along ``diff_axis`` (the symbol axis, or
    the block axis of SC-FDMA's pilot blocks), or r[n + lag] − r[n] for
    a serialised stream (``diff_lag``), each over √2, so a frame-periodic
    deterministic part cannot bias the pseudo-variance."""
    if diff_lag:
        m = (r[..., diff_lag:] - r[..., :-diff_lag]) * (2 ** -0.5)
    elif diff_axis is None:
        m = r
    else:
        n = r.shape[diff_axis]
        if n < 2:
            raise ValueError("diff_axis needs >= 2 symbols to difference")
        m = (r.narrow(diff_axis, 1, n - 1) - r.narrow(diff_axis, 0, n - 1)) * (2 ** -0.5)
    axes = tuple(range(1, r.ndim))
    c = torch.mean(m * m, dim=axes)
    p = torch.mean(torch.abs(m) ** 2, dim=axes)
    c_abs = torch.abs(c)
    disc = torch.sqrt(torch.clamp(p * p - c_abs ** 2, min=0.0))
    nz = c_abs > 0
    denom = torch.where(nz, torch.conj(c), torch.ones_like(c))
    w = torch.where(nz, (p - disc).to(c.dtype) / denom, torch.zeros_like(c))
    return r - w.reshape((-1,) + (1,) * (r.ndim - 1)) * torch.conj(r)
