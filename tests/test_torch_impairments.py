"""Front-end impairments in the port (ROADMAP item 11d) on the CPU, against
the JAX package at small sizes (N 64 or 128, CP 16, a few channels):
``ops/pa.py``, the LO phase noise and I/Q functions of ``ops/channel.py``,
the aligned links' channel stage, ``rx_chain``'s I/Q, residual-CFO and
tracked branches, the acquired link's channel stage and receive half, and
the JAX tests' link gates on the port's keyed draws.

Tolerances (stated before each comparison; u = 2^-24):

- the PA: abs 1e-5 / rel 1e-6 (BASELINE.md:13-16), the DPD cascade as
  the JAX test states it (pass-through within 2e-3 below the clip);
- I/Q: the coefficients exactly, the mismatch at abs 1e-5 / rel 1e-6;
  the compensator's weight w = (p − √(p² − |c|²))/c̄ from the per-channel
  means p = mean|m|², c = mean m², each a float32 sum of n terms within
  n·u·Σ|·| of exact (δp = n·u, δc = n·u·Σ|m|²/|Σm²|); w moves by at most
  |w|·(δp + 3δc + 8u·p²/|c|² + 4u) (the last terms: the cancellation in
  p − √·), the output by that times |r| plus 2u|r|(1 + |w|);
- the Wiener walk θ = cumsum(std·g): each package's running sum to
  sample k within (k + 1)·u·Σ_{i≤k}|std·g_i|, so θ within twice that,
  the rotation within that plus 4 ulp(θ) (float32 sin/cos);
- the CFO rotation: the angle formed in the same float32 order, sin/cos
  within 4 ulp(θmax);
- channel stages: the sum of those bounds through each stage (the
  propagation at abs 1e-5 / rel 1e-6, ``tests/test_torch_pipeline.py``'s),
  scaled by |μ| + |ν| after the mixer;
- LLR planes: abs 1e-5 of the plane's peak |LLR| (the pipeline tests'
  convention) plus 4ρ of it, ρ the bound on the samples' relative error
  from the stages above (an LLR is piecewise linear in the equalised
  symbol, which moves with the samples and with the estimate taken from
  them), and for the SC-FDE despread the pilots tests' SINR term; hard
  bits equal but where the JAX |LLR| < 1e-3; counts within the bits
  whose JAX |LLR| < 1e-3;
- acquisition decisions (start, integer CFO) exactly.

The link gates are the JAX tests' (tests/test_sync.py, test_pa.py,
test_phase_noise.py, test_iq_imbalance.py) at their sizes, on the port's
keyed draws with the JAX tests' key numbers as seeds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.link import pipeline as jpipe
from sdr_tpu.ops import channel as jchan
from sdr_tpu.ops import pa as jpa
from sdr_tpu.ops import sync as jsync
from sdr_tpu_torch import interop
from sdr_tpu_torch.core import prng
from sdr_tpu_torch.link import pipeline, stream
from sdr_tpu_torch.ops import channel as chan
from sdr_tpu_torch.ops import pa
from sdr_tpu_torch.ops import pilots as pil

torch.set_num_threads(1)

U = 2.0 ** -24
B, S, N, CP = 4, 16, 64, 16
L = N + CP
PDP3 = (1.0, 0.5, 0.25)
SEED = 20


def _cfgs(model=jcfg.ChannelModel.AWGN, mod=jcfg.Modulation.QAM16, spacing=4,
          dft_spread=False, estimator=jcfg.ChannelEstimator.LS,
          equalizer=jcfg.Equalizer.MMSE, n_symbols=S, n_channels=B, n_fft=N, cp=CP,
          ebno_db=12.0, **channel):
    """The same link in both packages: (JAX LinkConfig, the port's)."""
    if model in (jcfg.ChannelModel.MULTIPATH, jcfg.ChannelModel.MULTIPATH_TIME):
        channel.setdefault("pdp", PDP3)
    if model in (jcfg.ChannelModel.RAYLEIGH_TIME, jcfg.ChannelModel.MULTIPATH_TIME):
        channel.setdefault("doppler_norm", 0.02)
    ref = jcfg.LinkConfig(modulation=mod, ofdm=jcfg.OFDMConfig(n_fft=n_fft, cp_len=cp),
                          channel=jcfg.ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=equalizer, n_symbols=n_symbols, n_channels=n_channels,
                          dft_spread=dft_spread, pilot_spacing=spacing, estimator=estimator)
    return ref, interop.link_config_from_reference(ref)


def _cn(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * (scale / np.sqrt(2))).astype(np.complex64)


def _planar(z):
    return (torch.from_numpy(np.ascontiguousarray(np.real(z)).astype(np.float32)),
            torch.from_numpy(np.ascontiguousarray(np.imag(z)).astype(np.float32)))


def _complex(planes):
    return torch.complex(*planes).numpy()


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-6)


def _walk_tol(inc, std):
    """The Wiener rotation's bound per sample (module docstring)."""
    d = np.abs(inc.astype(np.float64) * np.float32(std))
    rb = np.arange(1, d.shape[-1] + 1) * U * np.cumsum(d, axis=-1)
    theta = np.cumsum(inc.astype(np.float64) * np.float32(std), axis=-1)
    return 2 * rb + 4 * _ulp(theta) + 2 * U


def _w_tol(m):
    """|Δw| per channel for moments over m (B, ...) (module docstring)."""
    m = m.reshape(m.shape[0], -1).astype(np.complex128)
    n = m.shape[-1]
    p = (np.abs(m) ** 2).mean(-1)
    c = (m * m).mean(-1)
    w = (p - np.sqrt(np.maximum(p * p - np.abs(c) ** 2, 0))) / np.conj(c)
    dp = n * U
    dc = n * U * (np.abs(m) ** 2).sum(-1) / np.abs((m * m).sum(-1))
    return np.abs(w) * (dp + 3 * dc + 8 * U * p ** 2 / np.abs(c) ** 2 + 4 * U), np.abs(w)


def _iq_moments_input(cfg, r):
    """The compensator's m for rx_chain's branch (numpy, (B, S, L))."""
    if cfg.dft_spread and cfg.pilot_spacing:
        rb = r.reshape(r.shape[0], -1, cfg.pilot_spacing, r.shape[-1])
        return (rb[:, 1:] - rb[:, :-1]) * np.float32(2 ** -0.5)
    return (r[:, 1:] - r[:, :-1]) * np.float32(2 ** -0.5)


def _jit(fn, *static):
    return jax.jit(lambda *a: fn(*a, *static))


# ---- ops/pa.py -----------------------------------------------------------------------

_PA = {
    "rapp_p2": lambda m, x: m.apply_rapp(x, 0.4, 2.0),
    "rapp_p3": lambda m, x: m.apply_rapp(x, 0.4, 3.0),
    "predistort": lambda m, x: m.rapp_predistort(x, 0.7, 2.0),
    "pa_ibo3": lambda m, x: m.apply_pa(x, 3.0, 1.0 / N),
    "pa_dpd_ibo5": lambda m, x: m.apply_pa(x, 5.0, 1.0 / N, 2.5, True),
}


@pytest.mark.parametrize("name", list(_PA))
def test_pa_matches_jax(rng, name):
    """abs 1e-5 / rel 1e-6, over amplitudes from 0 to far past saturation;
    the planar form gives the complex form's floats."""
    x = _cn(rng, (3, 400), 0.3)
    x[0, :5] = 0
    fn = _PA[name]
    want = np.asarray(jax.jit(lambda v: fn(jpa, v))(jnp.asarray(x)))
    got = fn(pa, torch.from_numpy(x))
    assert got.dtype == torch.complex64
    _close(got.real, want.real)
    _close(got.imag, want.imag)
    re, im = fn(pa, _planar(x))
    assert torch.equal(re, got.real) and torch.equal(im, got.imag)
    assert pa.rapp_sat_amplitude(6.0, 1 / N) == jpa.rapp_sat_amplitude(6.0, 1 / N)


def test_dpd_cascade_is_ideal_limiter():
    """PA(DPD(x)) passes x below 0.99·A_sat and clips above it (the JAX
    test's statement and tolerances), and equals the JAX cascade."""
    sat, p = 0.7, 2.0
    x = (np.random.default_rng(3).normal(size=(2, 512))
         + 1j * np.random.default_rng(4).normal(size=(2, 512))).astype(np.complex64) * 0.3
    y = pa.apply_rapp(pa.rapp_predistort(torch.from_numpy(x), sat, p), sat, p).numpy()
    a = np.abs(x)
    below = a <= 0.99 * sat * 0.999
    assert np.max(np.abs(y[below] - x[below])) < 2e-3
    above = a > 0.99 * sat
    assert above.any()
    assert np.allclose(np.abs(y[above]), 0.99 * sat, atol=2e-3)
    assert np.allclose(np.angle(y[above]), np.angle(x[above]), atol=1e-3)
    want = np.asarray(jpa.apply_rapp(jpa.rapp_predistort(jnp.asarray(x), sat, p), sat, p))
    _close(y.real, want.real)
    _close(y.imag, want.imag)


# ---- ops/channel.py: I/Q and the Wiener walk -------------------------------------------

def test_iq_imbalance_matches_jax(rng):
    for g, ph in ((1.1, 0.1), (0.7, -0.4), (1.0, 0.0)):
        assert chan.iq_imbalance_coeffs(g, ph) == jchan.iq_imbalance_coeffs(g, ph)
    x = _cn(rng, (3, 5, 40))
    want = np.asarray(_jit(jchan.apply_iq_imbalance, 1.1, 0.1)(jnp.asarray(x)))
    got = chan.apply_iq_imbalance(torch.from_numpy(x), 1.1, 0.1)
    assert got.dtype == torch.complex64
    _close(got.real, want.real)
    _close(got.imag, want.imag)


@pytest.mark.parametrize("mode", ["plain", "diff_axis_symbols", "diff_axis_blocks", "diff_lag"])
def test_iq_compensate_matches_jax_per_channel(rng, mode):
    """The JAX function vmapped per channel: per-channel moments, w's bound
    (module docstring) on the output."""
    shape = {"plain": (B, 6, 40), "diff_axis_symbols": (B, 6, 40),
             "diff_axis_blocks": (B, 3, 4, 40), "diff_lag": (B, 900)}[mode]
    kw = {"plain": {}, "diff_axis_symbols": dict(diff_axis=-2),
          "diff_axis_blocks": dict(diff_axis=-3), "diff_lag": dict(diff_lag=L)}[mode]
    s = _cn(rng, shape)
    r = np.asarray(jchan.apply_iq_imbalance(jnp.asarray(s), 1.2, 0.2)) * np.arange(
        1, B + 1).reshape((B,) + (1,) * (len(shape) - 1)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda v: jchan.iq_compensate(v, **kw)))(jnp.asarray(r)))
    got = chan.iq_compensate(torch.from_numpy(r), **kw).numpy()
    if mode == "plain":
        m = r
    elif mode == "diff_lag":
        m = (r[..., L:] - r[..., :-L]) * np.float32(2 ** -0.5)
    else:
        ax = kw["diff_axis"] % r.ndim
        m = (np.take(r, range(1, shape[ax]), ax) - np.take(r, range(shape[ax] - 1), ax)) / np.sqrt(2)
    dw, w = _w_tol(m)
    bshape = (B,) + (1,) * (len(shape) - 1)
    tol = (dw.reshape(bshape) + 2 * U * (1 + w.reshape(bshape))) * np.abs(r)
    assert np.all(np.abs(got - want) <= tol + 1e-12)
    # The compensator removes the image: the output is proper to rounding.
    pseudo = np.abs((got.reshape(B, -1) ** 2).mean(-1)) / (np.abs(got.reshape(B, -1)) ** 2).mean(-1)
    assert np.all(pseudo < 0.2)


def test_wiener_phase_matches_jax_on_its_increments():
    """The JAX function on a key, the port on that key's increments
    (``jax.random.normal(key, (n,))``, what the JAX function draws)."""
    n, std = 1500, 0.01
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    want = np.stack([np.asarray(jchan.wiener_phase(k, n, std)) for k in keys])
    inc = np.stack([np.asarray(jax.random.normal(k, (n,), jnp.float32)) for k in keys])
    got = chan.wiener_phase(0, torch.arange(3, dtype=torch.int32), n, std,
                            increments=torch.from_numpy(inc))
    assert got.dtype == torch.complex64 and got.shape == (3, n)
    assert np.all(np.abs(got.numpy() - want) <= _walk_tol(inc, std))


def test_wiener_increments_are_keyed_four_a_call():
    """Sample k is normal k mod 4 of Philox counter (channel, 0, k div 4, 0)
    on ROLE_PHASE; a channel slice draws the full run's rows; N(0, 1)."""
    ids = torch.arange(5, 9, dtype=torch.int32)
    g = chan.wiener_increments(SEED, ids, 4001)
    w = prng.keyed_words(SEED, prng.ROLE_PHASE, ids, (1, 1001))
    want = torch.stack((*prng.box_muller(w[0], w[1]), *prng.box_muller(w[2], w[3])), dim=-1)
    torch.testing.assert_close(g, want.reshape(4, -1)[:, :4001], rtol=0, atol=0)
    part = chan.wiener_increments(SEED, ids[2:], 4001)
    torch.testing.assert_close(part, g[2:], rtol=0, atol=0)
    assert abs(float(g.mean())) < 0.03 and abs(float(g.var()) - 1.0) < 0.05


# ---- the aligned links' channel stage -------------------------------------------------

MP, MT, RT = (jcfg.ChannelModel.MULTIPATH, jcfg.ChannelModel.MULTIPATH_TIME,
              jcfg.ChannelModel.RAYLEIGH_TIME)
AWGN, RICIAN, IDENT = jcfg.ChannelModel.AWGN, jcfg.ChannelModel.RICIAN, jcfg.ChannelModel.IDENTITY

_STAGE = {
    "pa_awgn": (AWGN, dict(pa_ibo_db=3.0)),
    "pa_dpd_multipath": (MP, dict(pa_ibo_db=5.0, pa_dpd=True)),
    "pn_rayleigh_time": (RT, dict(phase_noise_std=0.01)),
    "iq_multipath_time": (MT, dict(iq_gain=1.1, iq_phase_rad=0.1)),
    "pa_pn_iq_rician": (RICIAN, dict(pa_ibo_db=6.0, phase_noise_std=0.005, iq_gain=1.05,
                                     iq_phase_rad=0.03, k_factor=2.0)),
    "pn_iq_identity": (IDENT, dict(phase_noise_std=0.01, iq_gain=0.9, iq_phase_rad=-0.05)),
}


@pytest.mark.parametrize("case", list(_STAGE))
def test_apply_channel_matches_jax_composition(rng, case):
    """PA, propagation, LO walk, mixer in the JAX order on injected fading,
    noise and walk increments, against the JAX ops composed on the same."""
    model, kw = _STAGE[case]
    ref, cfg = _cfgs(model, **kw)
    ch = ref.channel
    tx = _cn(rng, (B, S, L), N ** -0.5)
    noise = rng.standard_normal((2, B, S, L)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    inc = np.stack([np.asarray(jax.random.normal(k, (S * L,), jnp.float32)) for k in keys])
    jtx = jnp.asarray(tx)
    if ch.has_pa:
        jtx = jpa.apply_pa(jtx, ch.pa_ibo_db, 1.0 / N, ch.pa_smoothness, ch.pa_dpd)
    nv = jchan.ebno_db_to_noise_var(ch.ebno_db, ref.modulation.bits_per_symbol)
    jn = jnp.asarray(noise[0] + 1j * noise[1]) * jnp.sqrt(jnp.float32(0.5)) * jnp.sqrt(
        jchan.time_noise_var(nv, N))
    h = taps = None
    if model == RICIAN:
        h = _cn(rng, (B, 1, 1))
        rx = jtx * h + jn
    elif model == RT:
        h = _cn(rng, (B, S, 1))
        rx = jtx * h + jn
    elif model == MP:
        taps = _cn(rng, (B, 3), 0.5)
        rx = jchan.apply_multipath(jtx.reshape(B, -1), jnp.asarray(taps)).reshape(B, S, L) + jn
    elif model == MT:
        taps = _cn(rng, (B, S, 3), 0.5)
        rx = jchan.apply_multipath(jtx, jnp.asarray(taps),
                                   history=jchan.symbol_history(jtx, 3)) + jn
    elif model == AWGN:
        rx = jtx + jn
    else:
        rx = jtx
    x_mag = np.abs(np.asarray(rx))
    tol = 1e-5 + 1e-6 * x_mag
    if ch.phase_noise_std:
        ph = jnp.stack([jchan.wiener_phase(k, S * L, ch.phase_noise_std) for k in keys])
        rx = (rx.reshape(B, -1) * ph).reshape(B, S, L)
        tol = tol + x_mag * _walk_tol(inc, ch.phase_noise_std).reshape(B, S, L)
    if ch.iq_imbalanced:
        rx = jchan.apply_iq_imbalance(rx, ch.iq_gain, ch.iq_phase_rad)
        mu, nu = jchan.iq_imbalance_coeffs(ch.iq_gain, ch.iq_phase_rad)
        tol = tol * (abs(mu) + abs(nu)) + 1e-6 * np.abs(np.asarray(rx))
    want = np.asarray(rx)
    fading = (None if h is None else torch.from_numpy(h),
              None if taps is None else torch.from_numpy(taps))
    got, h_freq, got_nv = pipeline.apply_channel(
        cfg, SEED, torch.arange(B, dtype=torch.int32), _planar(tx), fading=fading,
        noise=tuple(torch.from_numpy(n) for n in noise), phase=torch.from_numpy(inc))
    assert np.all(np.abs(_complex(got) - want) <= tol)
    assert got_nv == pytest.approx(0.0 if model == IDENT else float(nv), rel=1e-6)


def test_apply_channel_keyed_walk_and_mixer():
    """The keyed form rotates by the walk of ``wiener_increments`` over each
    channel's flattened frame, then images: the injected form on those
    increments gives the same floats."""
    _, cfg = _cfgs(AWGN, phase_noise_std=0.01, iq_gain=1.1, iq_phase_rad=0.1)
    ids = torch.arange(3, 3 + B, dtype=torch.int32)
    tx = pipeline.tx_idx(cfg, pipeline.draw_idx(cfg, SEED, ids))
    keyed, _, _ = pipeline.apply_channel(cfg, SEED, ids, tx)
    inc = chan.wiener_increments(SEED, ids, S * L)
    injected, _, _ = pipeline.apply_channel(cfg, SEED, ids, tx, phase=inc)
    for a, b in zip(keyed, injected):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- rx_chain's front-end branches ----------------------------------------------------

DFT, ZF = jcfg.ChannelEstimator.DFT, jcfg.Equalizer.ZF

# name → (config keywords, residual CFO of the planes in subcarriers)
_RX = {
    "comb_iq": (dict(iq_gain=1.1, iq_phase_rad=0.1), 0.0),
    "comb_iq_pn_tracked": (dict(iq_gain=1.1, iq_phase_rad=0.1, phase_noise_std=0.005), 0.0),
    "comb_pn_dft_zf": (dict(phase_noise_std=0.005, estimator=DFT, equalizer=ZF), 0.0),
    "comb_impaired_tracked": (dict(cfo_subcarriers=1.3, timing_offset=5), 0.02),
    "comb_impaired_rayleigh_time": (dict(model=RT, cfo_subcarriers=1.3, timing_offset=5), 0.02),
    "block_iq_pn": (dict(dft_spread=True, iq_gain=1.1, iq_phase_rad=0.1,
                         phase_noise_std=0.002), 0.0),
    "block_impaired_dft": (dict(dft_spread=True, estimator=DFT, cfo_subcarriers=1.3,
                                timing_offset=5), 0.03),
    "block_impaired_zf": (dict(dft_spread=True, equalizer=ZF, cfo_subcarriers=1.3,
                               timing_offset=5), 0.03),
    "block_impaired_multipath_time": (dict(dft_spread=True, model=MT, cfo_subcarriers=1.3,
                                           timing_offset=5), 0.03),
}


@functools.lru_cache(maxsize=None)
def _received(case):
    """One received frame for ``case`` and the JAX receiver on it (vmapped
    per channel): (ref, cfg, bits, rx (B, S, L), nv, llrs, hard, ρ). The
    frame: the JAX ``tx_chain`` of random bits, a static 3-tap channel,
    noise, a residual CFO, the LO walk and the mixer of the config."""
    kw, resid = _RX[case]
    kw = dict(kw)
    model = kw.pop("model", MP)
    ref, cfg = _cfgs(model, **kw)
    ch = ref.channel
    rng = np.random.default_rng(sum(map(ord, case)))
    bits = rng.integers(0, 2, (B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)).astype(np.int8)
    tx = np.asarray(jpipe.tx_chain(ref, jnp.asarray(bits))).reshape(B, -1)
    taps = _cn(rng, (B, 3)) * np.sqrt(np.asarray(PDP3) / sum(PDP3)).astype(np.float32)
    faded = np.stack([np.convolve(tx[b], taps[b])[:tx.shape[1]] for b in range(B)])
    nv = 0.02
    r = faded + _cn(rng, faded.shape, np.sqrt(nv / N))
    r = r * np.exp(2j * np.pi * resid * np.arange(r.shape[1]) / N)
    if ch.phase_noise_std:
        r = r * np.exp(1j * np.cumsum(rng.standard_normal(r.shape) * ch.phase_noise_std, -1))
    if ch.iq_imbalanced:
        mu, nu = jchan.iq_imbalance_coeffs(ch.iq_gain, ch.iq_phase_rad)
        r = mu * r + nu * np.conj(r)
    rx = r.reshape(B, S, L).astype(np.complex64)
    llrs, hard = jax.jit(jax.vmap(lambda v: jpipe.rx_chain(ref, v, None, jnp.float32(nv))))(
        jnp.asarray(rx))
    # ρ: the samples' relative error bound after the front end.
    rho = 0.0
    if ch.iq_imbalanced:
        dw, w = _w_tol(_iq_moments_input(cfg, rx))
        rho += float((dw + 2 * U * (1 + w)).max())
    if cfg.dft_spread and ch.impaired:
        terms = (np.conj(rx[..., :CP]) * rx[..., N:]).reshape(B, -1).astype(np.complex128)
        tol_e = terms.shape[-1] * U * np.abs(terms).sum(-1) / (2 * np.pi * np.abs(terms.sum(-1)))
        t = S * L
        rho += float((2 * np.pi * (tol_e + 2 * U) * t / N).max()) + float(
            4 * _ulp(2 * np.pi * 0.5 * t / N))
    return ref, cfg, bits, rx, nv, np.asarray(llrs), np.asarray(hard), rho


def _despread_rtol(cfg, h, nv):
    """The pilots tests' SC-FDE term: 1e-6 + 2^-20/(1 − b), b the tone mean
    of |h|²/(|h|² + nv) per data symbol."""
    h2 = np.abs(np.broadcast_to(h.numpy(), (B, cfg.n_data_symbols, N)).astype(np.complex128)) ** 2
    b = (h2 / (h2 + nv)).mean(axis=-1)
    return 1e-6 + 2.0 ** -20 / (1.0 - b)


@pytest.mark.parametrize("case", list(_RX))
def test_rx_chain_front_end_matches_jax(case):
    """The blind I/Q stage (symbol or block differences), SC-FDMA's
    residual-CFO refinement and the tracked estimators on the same planes."""
    ref, cfg, bits, rx, nv, want, want_hard, rho = _received(case)
    got, hard = pipeline.rx_chain(cfg, _planar(rx), None, nv)
    got = got.numpy()
    assert got.shape == want.shape == (B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)
    peak = float(np.abs(want).max())
    tol = (1e-5 + 4 * rho) * peak + 1e-6 * np.abs(want)
    if cfg.dft_spread and cfg.equalizer == jcfg.Equalizer.MMSE:
        _, h = pipeline._estimate(cfg, pipeline._front(cfg, _planar(rx)))
        tol = tol + np.repeat(_despread_rtol(cfg, h, nv)[..., None], want.shape[-1], -1) * np.abs(
            want)
    assert np.all(np.abs(got - want) <= tol)
    sure = np.abs(want) >= 1e-3
    np.testing.assert_array_equal(hard.numpy()[sure], want_hard[sure])
    ints = pipeline._bits_to_ints(torch.from_numpy(bits), cfg.modulation.bits_per_symbol)
    grid = pipeline._grid_of(cfg, ints.to(torch.int8))
    count = pipeline.count_errors(cfg, _planar(rx), None, nv, grid)
    margin = (np.abs(want) < 1e-3).sum(axis=(1, 2))
    assert np.all(np.abs(count.numpy() - (want_hard != bits).sum(axis=(1, 2))) <= margin)


def test_skip_iq_skips_the_compensator():
    ref, cfg, bits, rx, nv, *_ = _received("comb_iq")
    want = jax.jit(jax.vmap(lambda v: jpipe.rx_chain(ref, v, None, jnp.float32(nv),
                                                     skip_iq=True)[0]))(jnp.asarray(rx))
    got, _ = pipeline.rx_chain(cfg, _planar(rx), None, nv, skip_iq=True)
    peak = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy() / peak, np.asarray(want) / peak, atol=1e-5, rtol=1e-6)


# ---- the acquired link ----------------------------------------------------------------

# name → (config keywords): the acquired links whose channel stage and
# receive half are held against the JAX composition.
_ACQ = {
    "awgn": dict(mod=jcfg.Modulation.QPSK, cfo_subcarriers=2.3, timing_offset=37),
    "multipath_pa": dict(model=MP, cfo_subcarriers=-1.7, timing_offset=21, pa_ibo_db=6.0),
    "multipath_time_pn_iq": dict(model=MT, cfo_subcarriers=1.3, timing_offset=37,
                                 phase_noise_std=0.002, iq_gain=1.05, iq_phase_rad=0.03),
    "rayleigh_time_dpd": dict(model=RT, cfo_subcarriers=0.6, timing_offset=9, pa_ibo_db=5.0,
                              pa_dpd=True),
    "rician_iq_zero_cfo": dict(model=RICIAN, k_factor=3.0, timing_offset=37, iq_gain=1.05,
                               iq_phase_rad=0.03),
    "scfdma_block_dft_pa": dict(model=MP, dft_spread=True, estimator=DFT, cfo_subcarriers=1.3,
                                timing_offset=37, pa_ibo_db=6.0),
}


def _acq_fading(rng, model, n_steps):
    """Injected (h, taps) in ``fast.fading_at``'s form over n_steps symbols."""
    if model == MP:
        return None, _cn(rng, (B, 3), 0.5)
    if model == MT:
        return None, _cn(rng, (B, n_steps, 3), 0.5)
    if model == RT:
        return _cn(rng, (B, n_steps, 1)), None
    if model == RICIAN:
        return _cn(rng, (B, 1, 1)), None
    return None, None


def _jax_acquired_stream(ref, bits, h, taps, noise, keys):
    """The JAX channel stage of ``_simulate_one_acquired`` (pipeline.py:
    435-543) composed from its ops on the injected fading, noise and walk
    keys, vmapped over the channels. Returns the stream (B, T) and the
    per-sample bound on the port's (module docstring)."""
    ch = ref.channel
    n_fft, cp = ref.ofdm.n_fft, ref.ofdm.cp_len
    sl = n_fft + cp
    off = ch.timing_offset
    body_len = (2 + ref.n_symbols) * sl
    lag = sl * (ref.pilot_spacing if ref.dft_spread else 1)
    nv = jchan.ebno_db_to_noise_var(ch.ebno_db, ref.modulation.bits_per_symbol)

    def one(bits_b, h_b, taps_b, n_re, n_im, key):
        body = jpipe.tx_chain(ref, bits_b).reshape(-1)
        s = jnp.concatenate([jnp.zeros((off,), jnp.complex64),
                             jsync.acquisition_preamble(n_fft, cp), body,
                             jnp.zeros((sl,), jnp.complex64)])
        if ch.has_pa:
            s = jpa.apply_pa(s, ch.pa_ibo_db, 1.0 / n_fft, ch.pa_smoothness, ch.pa_dpd)
        if ch.model == MP:
            s = jchan.apply_multipath(s, taps_b)
        elif ch.model == MT:
            grid = s[off:off + body_len].reshape(-1, sl)
            fg = jchan.apply_multipath(grid, taps_b, history=jchan.symbol_history(grid, 3))
            tail = jchan.apply_multipath(s[off + body_len:], taps_b[-1], history=grid[-1, -2:])
            s = jnp.concatenate([s[:off], fg.reshape(-1), tail])
        elif ch.model == RT:
            s = s * jnp.concatenate([jnp.ones((off,), jnp.complex64), jnp.repeat(h_b[:, 0], sl),
                                     jnp.ones((sl,), jnp.complex64)])
        elif ch.model == RICIAN:
            s = s * h_b[0, 0]
        faded = s
        s = jsync.apply_cfo(s, ch.cfo_subcarriers, n_fft)
        s = s + (n_re + 1j * n_im) * jnp.sqrt(jnp.float32(0.5)) * jnp.sqrt(
            jchan.time_noise_var(nv, n_fft))
        if ch.phase_noise_std:
            s = s * jchan.wiener_phase(key, s.shape[0], ch.phase_noise_std)
        walked = s
        if ch.iq_imbalanced:
            s = jchan.apply_iq_imbalance(s, ch.iq_gain, ch.iq_phase_rad)
        imaged = s
        if ch.iq_imbalanced:
            s = jchan.iq_compensate(s, diff_lag=lag)
        inc = jax.random.normal(key, (s.shape[0],), jnp.float32)
        return s, faded, walked, imaged, inc

    hh = jnp.zeros((bits.shape[0], 1, 1), jnp.complex64) if h is None else jnp.asarray(h)
    tt = jnp.zeros((bits.shape[0], 1), jnp.complex64) if taps is None else jnp.asarray(taps)
    s, faded, walked, imaged, inc = (np.array(t) for t in jax.jit(jax.vmap(one))(
        jnp.asarray(bits), hh, tt, jnp.asarray(noise[0][:, 0]), jnp.asarray(noise[1][:, 0]),
        keys))
    T = s.shape[-1]
    theta = 2 * np.pi * abs(ch.cfo_subcarriers) * np.arange(T) / n_fft
    mag = np.abs(faded)
    tol = (1e-5 + 1e-6 * mag) + mag * (4 * _ulp(theta) + 2 * U)
    if ch.phase_noise_std:
        tol = tol + np.abs(walked) * _walk_tol(inc, ch.phase_noise_std)
    if ch.iq_imbalanced:
        mu, nu = jchan.iq_imbalance_coeffs(ch.iq_gain, ch.iq_phase_rad)
        dw, w = _w_tol((imaged[:, lag:] - imaged[:, :-lag]) * np.float32(2 ** -0.5))
        tol = (tol * (abs(mu) + abs(nu)) * (1 + w[:, None])
               + (dw + 2 * U * (1 + w))[:, None] * np.abs(imaged))
    return s, tol


@functools.lru_cache(maxsize=None)
def _acquired(case):
    """(ref, cfg, ids, idx, bits, injected inputs, JAX stream, its bound)."""
    kw = dict(_ACQ[case])
    model = kw.pop("model", AWGN)
    ref, cfg = _cfgs(model, n_symbols=8, **kw)
    rng = np.random.default_rng(sum(map(ord, case)))
    ids = torch.arange(B, dtype=torch.int32)
    idx = pipeline.draw_idx(cfg, SEED, ids)
    bits = pipeline.generate_bits(cfg, SEED, ids).numpy()
    T = pipeline.stream_len(cfg)
    h, taps = _acq_fading(rng, model, cfg.n_symbols + 2)
    noise = rng.standard_normal((2, B, 1, T)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(13), B)
    inc = np.stack([np.asarray(jax.random.normal(k, (T,), jnp.float32)) for k in keys])
    want, tol = _jax_acquired_stream(ref, bits, h, taps, noise, keys)
    inputs = dict(fading=(None if h is None else torch.from_numpy(h),
                          None if taps is None else torch.from_numpy(taps)),
                  noise=tuple(torch.from_numpy(n) for n in noise),
                  phase=torch.from_numpy(inc))
    return ref, cfg, ids, idx, bits, inputs, want, tol


@pytest.mark.parametrize("case", list(_ACQ))
def test_acquired_stream_matches_jax_composition(case):
    """Delay, preamble, body, tail; the PA; one E launch of fading over the
    (B, S+3, L) plane; the CFO; E's noise over the (B, 1, T) row; the walk,
    the mixer and the lagged compensator — against the JAX ops."""
    ref, cfg, ids, idx, bits, inputs, want, tol = _acquired(case)
    got = pipeline.acquired_stream(cfg, SEED, ids, idx, **inputs).numpy()
    assert got.shape == want.shape == (B, pipeline.stream_len(cfg))
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("case", ["awgn", "multipath_pa", "rician_iq_zero_cfo",
                                  "scfdma_block_dft_pa"])
def test_acquired_receive_matches_jax(case):
    """The receive half (pipeline.py:551-570) on one JAX-built stream:
    start and integer CFO exactly, the total CFO within the fractional
    estimate's bound, then the LLRs (``rx_chain`` with ``skip_iq``)."""
    ref, cfg, ids, idx, bits, inputs, stream_np, _ = _acquired(case)
    n_fft, cp, sl = N, CP, L
    nv = jchan.ebno_db_to_noise_var(ref.channel.ebno_db, ref.modulation.bits_per_symbol)
    backoff = 2 if ref.dft_spread and cp >= 4 else 0

    def jax_rx(s):
        start, total, rx_c = jsync.acquire(s, n_fft, cp)
        payload = jax.lax.dynamic_slice_in_dim(rx_c, jnp.maximum(start - backoff, 0),
                                               ref.n_symbols * sl).reshape(ref.n_symbols, sl)
        llrs, hard = jpipe.rx_chain(ref, payload, None, nv, skip_iq=True)
        return start, total, payload, llrs, hard

    js, jt, jpay, jllr, jhard = (np.asarray(t) for t in jax.jit(jax.vmap(jax_rx))(
        jnp.asarray(stream_np)))
    start, total, payload = pipeline.acquire_payload(cfg, torch.from_numpy(stream_np))
    np.testing.assert_array_equal(start.numpy(), js)
    # The fractional estimate's bound: P at the JAX coarse index.
    h = n_fft // 2
    a = np.conj(stream_np[:, :-h]).astype(np.complex128) * stream_np[:, h:]
    P = np.asarray(_jit(jsync.timing_metric, n_fft)(jnp.asarray(stream_np))[0])
    d = np.asarray(_jit(jsync.estimate_timing_cfo, n_fft)(jnp.asarray(stream_np))[0])
    rb = np.arange(1, a.shape[-1] + 1) * U * np.cumsum(np.abs(a), -1)
    tol_p = 4 * np.take_along_axis(rb, (d + h - 1)[:, None], -1)[:, 0]
    tol_c = tol_p / (np.pi * np.abs(np.take_along_axis(P, d[:, None], -1)[:, 0])) + 4 * U
    assert np.all(np.abs(total.numpy() - jt) <= tol_c)
    n_max = stream_np.shape[-1]
    rho = float((2 * np.pi * tol_c * n_max / n_fft).max() + 4 * _ulp(
        2 * np.pi * 5 * n_max / n_fft) + 2 * U)
    got_pay = _complex(payload)
    assert np.all(np.abs(got_pay - jpay) <= np.abs(jpay) * rho + 1e-9)
    got, hard = pipeline.rx_chain(cfg, payload, None, float(nv), skip_iq=True)
    got = got.numpy()
    peak = float(np.abs(jllr).max())
    rho_rx = rho
    if cfg.dft_spread:
        terms = (np.conj(jpay[..., :cp]) * jpay[..., n_fft:]).reshape(B, -1).astype(np.complex128)
        tol_e = terms.shape[-1] * U * np.abs(terms).sum(-1) / (2 * np.pi * np.abs(terms.sum(-1)))
        rho_rx += float((2 * np.pi * (tol_e + 2 * U) * ref.n_symbols * sl / n_fft).max())
    tol = (1e-5 + 4 * rho_rx) * peak + 1e-6 * np.abs(jllr)
    if cfg.dft_spread:
        _, hh = pipeline._estimate(cfg, pipeline._front(cfg, payload, True))
        tol = tol + np.repeat(_despread_rtol(cfg, hh, float(nv))[..., None], jllr.shape[-1],
                              -1) * np.abs(jllr)
    assert np.all(np.abs(got - jllr) <= tol)
    sure = np.abs(jllr) >= 1e-3
    np.testing.assert_array_equal(hard.numpy()[sure], jhard[sure])


@pytest.mark.parametrize("case", ["awgn", "multipath_time_pn_iq"])
def test_acquired_link_split_equals_full(case):
    """Channels [0, 1) and [1, B) alone give the full run's counts; the LLR
    plane's hard bits count what the count counts (but for |LLR| < 1e-3)."""
    _, cfg, *_ = _acquired(case)
    full = pipeline.simulate(cfg, SEED, device="cpu")
    parts = [pipeline.simulate_core(cfg, SEED, torch.arange(a, b, dtype=torch.int32))[0]
             for a, b in ((0, 1), (1, B))]
    assert torch.equal(torch.cat(parts), full.bit_errors)
    assert int(full.bits_counted[0]) == cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    res = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
    margin = (res.llrs.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((res.bit_errors - full.bit_errors).abs() <= margin).all())
    assert torch.equal(pipeline.make_simulate_fn(cfg, device="cpu")(SEED).bit_errors,
                       full.bit_errors)


def test_acquired_link_in_channel_passes(monkeypatch):
    """The plain-torch front end in passes of ``CHUNK`` channels (3 and 1
    here) counts what one pass counts, and its streams agree within
    2u of their magnitude."""
    _, cfg, ids, idx, *_ = _acquired("multipath_time_pn_iq")
    whole = pipeline.simulate(cfg, SEED, device="cpu").bit_errors
    one = pipeline.acquired_stream(cfg, SEED, ids, idx)
    monkeypatch.setattr(pipeline, "CHUNK", 3)
    assert torch.equal(pipeline.simulate(cfg, SEED, device="cpu").bit_errors, whole)
    parts = pipeline.acquired_stream(cfg, SEED, ids, idx)
    assert bool(((parts - one).abs() <= 2 * U * one.abs() + 1e-12).all())


def test_stream_refuses_impairments_the_pipeline_runs():
    """The pipeline runs every impairment (every bit counted, a finite BER
    under 0.5); the blocked stream raises for each impairment, naming
    11d."""
    for kw in (dict(pa_ibo_db=6.0), dict(phase_noise_std=0.01), dict(iq_gain=1.1),
               dict(iq_phase_rad=0.1), dict(cfo_subcarriers=1.0), dict(timing_offset=3)):
        _, cfg = _cfgs(AWGN, n_symbols=4, **kw)
        res = pipeline.simulate(cfg, 0, device="cpu")
        assert bool((res.bits_counted == cfg.n_data_symbols * cfg.bits_per_ofdm_symbol).all())
        assert 0.0 <= float(res.ber.mean()) < 0.5
        with pytest.raises(NotImplementedError, match="item 11d"):
            stream.stream_simulate(cfg, 0, 2, device="cpu")


# ---- the JAX tests' link gates on the port's keyed draws --------------------------------

def _ber(ref, seed):
    cfg = interop.link_config_from_reference(ref)
    res = pipeline.simulate(cfg, seed, device="cpu")
    return int(res.bit_errors.sum()) / int(res.bits_counted.sum())


def _link(model=AWGN, mod=jcfg.Modulation.QPSK, n_fft=64, cp=16, spacing=4, n_symbols=32,
          n_channels=64, dft_spread=False, **channel):
    return jcfg.LinkConfig(modulation=mod, ofdm=jcfg.OFDMConfig(n_fft, cp),
                           channel=jcfg.ChannelConfig(model=model, **channel),
                           equalizer=jcfg.Equalizer.MMSE, pilot_spacing=spacing,
                           n_symbols=n_symbols, n_channels=n_channels, dft_spread=dft_spread)


def test_gate_acquired_within_half_db_of_aligned():
    """tests/test_sync.py:122-161: acquired AWGN (QPSK 6 dB, CFO 2.3,
    offset 37) < 1.1 × the aligned link at 5.5 dB; seed 33."""
    imp = _ber(_link(ebno_db=6.0, cfo_subcarriers=2.3, timing_offset=37), 33)
    ref = _ber(_link(ebno_db=5.5), 33)
    assert imp < 1.1 * ref, (imp, ref)


def test_gate_acquired_multipath():
    """tests/test_sync.py:164-205: acquired MULTIPATH (PDP (1, .3, .1),
    8 dB) < 2 × its aligned twin; seed 33."""
    kw = dict(model=MP, ebno_db=8.0, pdp=(1.0, 0.3, 0.1))
    imp = _ber(_link(cfo_subcarriers=2.3, timing_offset=37, **kw), 33)
    ref = _ber(_link(**kw), 33)
    assert imp < 2.0 * ref, (imp, ref)


def _pa_link(**kw):
    return _link(mod=jcfg.Modulation.QAM16, n_fft=128, spacing=8, n_channels=32, **kw)


def test_gate_pa_backoff_dpd_and_scfdma():
    """tests/test_pa.py:163-240, seed 2: IBO 20 dB within the linear link's
    Poisson band and IBO 0 dB far above it; DPD at IBO 5 below raw; SC-FDMA
    below OFDM at IBO 3 dB (QPSK, 9 dB)."""
    def errs(ref):
        cfg = interop.link_config_from_reference(ref)
        return int(pipeline.simulate(cfg, 2, device="cpu").bit_errors.sum())

    e_lin = errs(_pa_link(ebno_db=10.0))
    e_deep = errs(_pa_link(ebno_db=10.0, pa_ibo_db=20.0))
    e_hard = errs(_pa_link(ebno_db=10.0, pa_ibo_db=0.0))
    assert abs(e_deep - e_lin) <= 4.0 * np.sqrt(max(e_lin, 1)) + 10.0, (e_deep, e_lin)
    assert e_hard > 5 * max(e_lin, 1), (e_hard, e_lin)
    assert errs(_pa_link(ebno_db=10.0, pa_ibo_db=5.0, pa_dpd=True)) < errs(
        _pa_link(ebno_db=10.0, pa_ibo_db=5.0))
    sc = dict(ebno_db=9.0, pa_ibo_db=3.0)
    e_sc = errs(dataclasses.replace(_pa_link(**sc), modulation=jcfg.Modulation.QPSK,
                                    dft_spread=True))
    e_of = errs(dataclasses.replace(_pa_link(**sc), modulation=jcfg.Modulation.QPSK))
    assert e_sc < e_of, (e_sc, e_of)


def test_gate_pa_composes_with_acquisition():
    """tests/test_pa.py:243-262: delay, CFO 1.7 and a PA at IBO 6 dB,
    QPSK 12 dB, N 128 CP 32: BER < 5e-3; seed 2."""
    ref = _link(n_fft=128, cp=32, spacing=8, n_symbols=16, n_channels=8, ebno_db=12.0,
                cfo_subcarriers=1.7, timing_offset=41, pa_ibo_db=6.0)
    assert _ber(ref, 2) < 5e-3


def _pn_link(model, std, **kw):
    return _link(model, jcfg.Modulation.QAM16, n_channels=32, ebno_db=16.0,
                 phase_noise_std=std, **kw)


def test_gate_phase_noise_tracked():
    """tests/test_phase_noise.py:111-133, seed 3: the tracked links —
    AWGN std 0.01 < 3 × clean + 2e-3 and < 0.02; MULTIPATH std 0.008
    < 3 × clean + 5e-3."""
    noisy, clean = _ber(_pn_link(AWGN, 0.01), 3), _ber(_pn_link(AWGN, 0.0), 3)
    assert noisy < 3.0 * clean + 2e-3 and noisy < 0.02, (noisy, clean)
    pdp = (1.0, 0.5, 0.25)
    noisy = _ber(_pn_link(MP, 0.008, pdp=pdp), 3)
    clean = _ber(_pn_link(MP, 0.0, pdp=pdp), 3)
    assert noisy < 3.0 * clean + 5e-3, (noisy, clean)


def test_gate_phase_noise_untracked_would_fail():
    """tests/test_phase_noise.py:136-171, seed 3: the same walk with the
    frame-averaged LS estimate (no tracking) decodes near-randomly, and
    the tracked link beats it tenfold."""
    ref = _pn_link(AWGN, 0.01)
    cfg = interop.link_config_from_reference(ref)
    ids = torch.arange(cfg.n_channels, dtype=torch.int32)
    idx = pipeline.draw_idx(cfg, 3, ids)
    rx, _, nv = pipeline.apply_channel(cfg, 3, ids, pipeline.tx_idx(cfg, idx))
    y = torch.fft.fft(torch.complex(*rx)[..., CP:])
    h = pil.estimate_ls_comb(y, cfg.pilot_spacing)
    hr, hi = pipeline._h_plane(h, cfg.n_channels, N, "cpu")
    from sdr_tpu_torch.kernels import demod as kc

    errs = kc.demod_count(*rx, hr, hi, idx, CP, cfg.modulation, nv,
                          pilot_spacing=cfg.pilot_spacing)
    untracked = int(errs.sum()) / (cfg.n_channels * cfg.n_data_symbols * cfg.bits_per_ofdm_symbol)
    tracked = _ber(ref, 3)
    assert untracked > 0.015 and tracked < untracked / 10.0, (tracked, untracked)


def test_gate_acquisition_with_phase_noise_and_iq():
    """tests/test_phase_noise.py:78-108 (seed 3) and
    tests/test_iq_imbalance.py:222-252 (seed 4): CFO 1.3 and offset 37 with
    an LO walk (2e-3) or an I/Q mismatch (1.05, 0.03) < max(2.5 × the
    acquisition-only BER, 5e-3)."""
    base = _link(mod=jcfg.Modulation.QAM16, n_symbols=16, n_channels=96, ebno_db=14.0,
                 cfo_subcarriers=1.3, timing_offset=37)
    for extra, seed in ((dict(phase_noise_std=2e-3), 3),
                        (dict(iq_gain=1.05, iq_phase_rad=0.03), 4)):
        both = dataclasses.replace(base, channel=dataclasses.replace(base.channel, **extra))
        b_acq, b_both = _ber(base, seed), _ber(both, seed)
        assert b_both < max(2.5 * b_acq, 5e-3), (extra, b_both, b_acq)


def _iq_link(gain, phase, **kw):
    return _link(mod=jcfg.Modulation.QAM16, n_channels=32, ebno_db=16.0, iq_gain=gain,
                 iq_phase_rad=phase, **kw)


def test_gate_iq_compensated_and_oracle():
    """tests/test_iq_imbalance.py:154-219, seed 5: the compensated link
    (1.1, 0.1) < 3 × the matched mixer + 2e-3; at (1.3, 0.25) without the
    compensator (the planes demodulated with ``skip_iq``) the BER is above
    2 × compensated + 1e-3."""
    bad, clean = _ber(_iq_link(1.1, 0.1), 5), _ber(_iq_link(1.0, 0.0), 5)
    assert bad < 3.0 * clean + 2e-3, (bad, clean)
    ref = _iq_link(1.3, 0.25)
    cfg = interop.link_config_from_reference(ref)
    ids = torch.arange(cfg.n_channels, dtype=torch.int32)
    idx = pipeline.draw_idx(cfg, 5, ids)
    rx, _, nv = pipeline.apply_channel(cfg, 5, ids, pipeline.tx_idx(cfg, idx))
    raw = int(pipeline.count_errors(cfg, rx, None, nv, idx, skip_iq=True).sum())
    raw /= cfg.n_channels * cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    comp = _ber(ref, 5)
    assert raw > 2.0 * comp + 1e-3, (raw, comp)


def test_gate_iq_zero_cfo_and_fading_stack():
    """tests/test_iq_imbalance.py:255-281 (seed 6): offset 37 alone with
    the I/Q mismatch < max(2.5 × aligned, 2e-4); the stack MULTIPATH + LO
    walk 0.008 + I/Q (1.1, 0.1) < 3 × its clean twin + 5e-3 (seed 5)."""
    base = _link(mod=jcfg.Modulation.QAM16, n_symbols=16, n_channels=96, ebno_db=14.0,
                 iq_gain=1.05, iq_phase_rad=0.03)
    acquired = dataclasses.replace(base, channel=dataclasses.replace(base.channel,
                                                                     timing_offset=37))
    b_al, b_acq = _ber(base, 6), _ber(acquired, 6)
    assert b_acq < max(2.5 * b_al, 2e-4), (b_acq, b_al)
    stack = _iq_link(1.1, 0.1, model=MP, pdp=(1.0, 0.5, 0.25), phase_noise_std=0.008)
    clean = dataclasses.replace(stack, channel=dataclasses.replace(
        stack.channel, iq_gain=1.0, iq_phase_rad=0.0, phase_noise_std=0.0))
    b_imp, b_cln = _ber(stack, 5), _ber(clean, 5)
    assert b_imp < 3.0 * b_cln + 5e-3, (b_imp, b_cln)
