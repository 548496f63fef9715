"""Time-varying and impaired MIMO in the port (ROADMAP item 11e-ii) on the
CPU, against the JAX package at small sizes (N 64, CP 16, S 4–16, 2–4
channels): the pairs' Jakes and TDL draws (``ops/channel.py``'s
``n_pairs``), the midamble frame layout (``pipeline.mimo_tx``), per-symbol
detection (``pipeline.mimo_detect_per_symbol`` against the JAX
``_mimo_detect_per_symbol`` itself), the midamble receive
(``pipeline.estimate_mimo_midamble`` against the JAX receive's code,
pipeline.py:910-981), and the whole link against the JAX ``mimo_llr_link``
itself, one channel at a time, with each channel's JAX draws regenerated
from its key and injected into the port; then the keyed link's structure
(split == full, passes).

Tolerances (stated before each comparison; u = 2^-24):

- detector outputs and estimates: abs 1e-5 / rel 1e-6 (BASELINE.md:13-16)
  on O(1) inputs; the linear detectors' solves within the κ-bound of
  ``tests/test_torch_mimo.py`` (abs 64·κ·u of the output's peak);
- LLR planes: ``tests/test_torch_mimo.py::_assert_llrs_close`` — abs 1e-5
  of the plane's peak |LLR|, hard bits equal but where the JAX |LLR| <
  1e-3 — plus, on the acquired links, 4ρ of the peak, ρ the samples'
  relative error after the CFO correction: 2π·δε·T/N for the total-CFO
  estimates' difference δε (its bound from the float32 sliding sums the
  fractional estimate averages, as ``tests/test_torch_impairments.py``
  derives it, summed over the antennas and the CP-wide window), plus the
  rotations' own float32 error 4 ulp(2π·5·T/N) and 2u;
- acquisition starts exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.core import prng as jprng
from sdr_tpu.link import pipeline as jpipe
from sdr_tpu.ops import channel as jchan
from sdr_tpu.ops import pilots as jpil
from sdr_tpu.ops import sync as jsync
from sdr_tpu_torch import interop
from sdr_tpu_torch.core import prng
from sdr_tpu_torch.link import pipeline
from sdr_tpu_torch.ops import channel as chan
from sdr_tpu_torch.ops import sync as sync_ops
from sdr_tpu_torch.ops.ofdm import ofdm_rx
from sdr_tpu_torch.parallel.mesh import make_link_mesh
from sdr_tpu_torch.parallel.shard import make_sharded_simulate_fn

torch.set_num_threads(1)

U = 2.0 ** -24
SEED = 22
N, CP = 64, 16
L = N + CP
PDP3 = (1.0, 0.5, 0.25)
_A, _M, _X = jcfg.MIMOScheme.ALAMOUTI, jcfg.MIMOScheme.MRC, jcfg.MIMOScheme.SPATIAL_MUX
_RT, _MT = jcfg.ChannelModel.RAYLEIGH_TIME, jcfg.ChannelModel.MULTIPATH_TIME
_DFT = jcfg.ChannelEstimator.DFT


def _cfgs(mimo, model=jcfg.ChannelModel.RAYLEIGH_FLAT, mod=jcfg.Modulation.QAM16,
          ebno_db=12.0, n_channels=3, n_symbols=8, estimator=jcfg.ChannelEstimator.LS,
          equalizer=jcfg.Equalizer.MMSE, dft_spread=False, **channel):
    """The same link in both packages: (JAX LinkConfig, the port's)."""
    if model in (_RT, _MT):
        channel.setdefault("doppler_norm", 0.02)
    if model in (jcfg.ChannelModel.MULTIPATH, _MT):
        channel.setdefault("pdp", PDP3)
    ref = jcfg.LinkConfig(modulation=mod, ofdm=jcfg.OFDMConfig(N, CP),
                          channel=jcfg.ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=equalizer, estimator=estimator, n_symbols=n_symbols,
                          n_channels=n_channels, dft_spread=dft_spread,
                          mimo=jcfg.MIMOConfig(*mimo[:3], **mimo[3] if len(mimo) > 3 else {}))
    return ref, interop.link_config_from_reference(ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _cn(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * (scale / np.sqrt(2))).astype(np.complex64)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-6)


def _assert_llrs_close(got, want, extra=0.0, sure_at=1e-3):
    """``tests/test_torch_mimo.py``'s LLR bound: abs 1e-5 of the peak plus
    ``extra``; hard bits equal where the JAX |LLR| ≥ ``sure_at``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * peak + extra, rtol=0)
    sure = np.abs(want) >= sure_at
    np.testing.assert_array_equal((got < 0)[sure], (want < 0)[sure])


# ---- the pairs' time-varying draws ------------------------------------------------------

def test_pair_draws_are_keyed_rows():
    """Jakes pair p is row p of the fading stream's Jakes lane, TDL tap l of
    pair p row p·L + l: pair 0 is the SISO draw of the same channel, the
    other pairs are other rows; a split batch draws what the full one does."""
    ids = torch.arange(6, dtype=torch.int32)
    theta, phi = chan.jakes_params(SEED, ids, n_pairs=4)
    assert tuple(theta.shape) == (6, 4, chan.JAKES_PATHS)
    t0, p0 = chan.jakes_params(SEED, ids)
    assert torch.equal(theta[:, 0], t0) and torch.equal(phi[:, 0], p0)
    rows, _ = chan.jakes_params(SEED, ids, n_taps=4)  # rows 0..3 of the same lane
    assert torch.equal(theta, rows)
    tt, tp, amps = chan.multipath_time_params(SEED, ids, PDP3, n_pairs=4)
    assert tuple(tt.shape) == (6, 4, 3, chan.JAKES_PATHS)
    rows, _ = chan.jakes_params(SEED, ids, n_taps=12)
    assert torch.equal(tt.reshape(6, 12, -1), rows)
    siso = chan.multipath_time_params(SEED, ids, PDP3)
    assert torch.equal(tt[:, 0], siso[0]) and torch.equal(tp[:, 0], siso[1])
    g = chan.jakes_gains(SEED, ids, 8, 0.02, n_pairs=4)
    assert tuple(g.shape) == (6, 4, 8)
    assert torch.equal(g[:, 0], chan.jakes_gains(SEED, ids, 8, 0.02))
    taps = chan.multipath_time_taps(SEED, ids, PDP3, 8, 0.02, n_pairs=4)
    assert tuple(taps.shape) == (6, 4, 8, 3)
    assert torch.equal(taps[:, 0], chan.multipath_time_taps(SEED, ids, PDP3, 8, 0.02))
    part = chan.multipath_time_taps(SEED, ids[2:5], PDP3, 8, 0.02, n_pairs=4)
    assert torch.equal(part, taps[2:5])
    assert torch.equal(chan.jakes_gains(SEED, ids[3:], 8, 0.02, n_pairs=4), g[3:])


def test_pair_draws_are_independent():
    """Over 4096 channels the pairs' gains at one step are uncorrelated
    (|E[g_p·conj(g_q)]| < 0.05 for p ≠ q, 4.7 standard errors of a
    unit-power CN(0, 1) product mean) and of unit power (within 0.05)."""
    ids = torch.arange(4096, dtype=torch.int32)
    g = chan.jakes_gains(SEED, ids, 3, 0.02, n_pairs=4)[:, :, 1].to(torch.complex128)
    cov = (g[:, :, None] * torch.conj(g[:, None, :])).mean(dim=0).abs()
    off = cov[~torch.eye(4, dtype=torch.bool)]
    assert float(off.max()) < 0.05
    assert float((torch.diagonal(cov) - 1.0).abs().max()) < 0.05


def test_mimo_fading_time_varying_shapes():
    """``mimo_fading`` under time variation: (B, n_rx, n_tx, steps, 1 | L),
    pair r·n_tx + t; its genie response per symbol (B, steps, n_rx, n_tx,
    1 | N); ``pair_channel``'s rows, the acquired tail row the last taps or
    a unit gain."""
    ids = torch.arange(3, dtype=torch.int32)
    for model, F in ((_RT, 1), (_MT, 3)):
        _, cfg = _cfgs((_A, 2, 2), model)
        f = pipeline.mimo_fading(cfg, SEED, ids, 10)
        assert tuple(f.shape) == (3, 2, 2, 10, F)
        h = pipeline.mimo_genie(cfg, f)
        assert tuple(h.shape) == (3, 10, 2, 2, 1 if F == 1 else N)
        kw = pipeline.pair_channel(cfg, f, tail=True)
        side = kw.get("taps_r", kw.get("hr_s"))
        split = np.float32(2 ** -0.5)
        if F == 1:
            assert tuple(side.shape) == (12, 11)
            np.testing.assert_array_equal(side[:, -1].numpy(), split)
            _close(side[:, :10].numpy(), (f.real * split).reshape(12, 10).numpy())
        else:
            assert tuple(side.shape) == (12, 11, 3)
            assert torch.equal(side[:, -1], side[:, -2])


# ---- the midamble layout ---------------------------------------------------------------

@pytest.mark.parametrize("scheme,ntx,nrx,acquired", [(_A, 2, 2, False), (_X, 2, 2, False),
                                                     (_M, 1, 2, True), (_A, 2, 1, True)])
def test_midamble_layout(scheme, ntx, nrx, acquired):
    """[n_tx preamble rows | K data rows] × S/K per antenna: antenna t sends
    ``preamble_row`` in row t of each block's preamble, zeros in the other
    preamble rows, and B's rows in order after it; the acquired plane adds
    the sync rows on antenna 0 (stored over the split) and a zero tail."""
    kw = dict(cfo_subcarriers=1.3, timing_offset=5) if acquired else {}
    _, cfg = _cfgs((scheme, ntx, nrx, dict(csi="preamble", midamble_period=4)), _RT,
                   **kw)
    assert pipeline.midamble(cfg) and pipeline.n_tx_symbols(cfg) == 2 * (ntx + 4)
    ids = torch.arange(3, dtype=torch.int32)
    idx = pipeline.draw_mimo_idx(cfg, SEED, ids)
    tx = pipeline.mimo_tx(cfg, idx)
    genie = dataclasses.replace(cfg, mimo=dataclasses.replace(cfg.mimo, csi="genie",
                                                              midamble_period=0),
                                channel=dataclasses.replace(cfg.channel, cfo_subcarriers=0.0,
                                                            timing_offset=0))
    data = pipeline.mimo_tx(genie, idx)
    head = 2 if acquired else 0
    Sp = pipeline.n_tx_symbols(cfg)
    assert tuple(tx[0].shape) == (3, ntx, head + Sp + head // 2, L)
    row = pipeline.preamble_row(cfg, "cpu")
    for got, d, r in zip(tx, data, row):
        body = got[:, :, head:head + Sp].reshape(3, ntx, 2, ntx + 4, L)
        assert torch.equal(body[:, :, :, ntx:].reshape(3, ntx, 8, L), d)
        for t in range(ntx):
            for u in range(ntx):
                want = r if t == u else torch.zeros_like(r)
                assert torch.equal(body[:, t, :, u], want.expand(3, 2, L))
        if acquired:
            assert not bool(got[:, :, head + Sp:].any()) and not bool(got[:, 1:, :head].any())
    if acquired:
        pre = pipeline.sync.acquisition_preamble(N, CP).reshape(2, L) / pipeline._split(cfg)
        np.testing.assert_array_equal(torch.complex(tx[0][:, 0, :2], tx[1][:, 0, :2]).numpy(),
                                      pre.expand(3, 2, L).numpy())


# ---- per-symbol detection against the JAX function --------------------------------------

_DETECT = {
    "alamouti_2x2": ((_A, 2, 2), {}), "alamouti_2x1_scfdma": ((_A, 2, 1), dict(dft_spread=True)),
    "mrc_1x3": ((_M, 1, 3), {}), "mux_2x2_mmse": ((_X, 2, 2), {}),
    "mux_2x3_zf": ((_X, 2, 3), dict(equalizer=jcfg.Equalizer.ZF)),
    "mux_2x2_sic": ((_X, 2, 2, dict(detector="sic")), {}),
    "mux_2x2_ml": ((_X, 2, 2, dict(detector="ml")), {}),
    "mux_2x2_mmse_scfdma": ((_X, 2, 2), dict(dft_spread=True)),
}


@pytest.mark.parametrize("n_prime", [1, N], ids=["flat", "per_tone"])
@pytest.mark.parametrize("name", list(_DETECT))
def test_detect_per_symbol_matches_jax(rng, name, n_prime):
    """``mimo_detect_per_symbol`` then ``whitened_llrs`` (C's plain version
    on the CPU) against the JAX ``_mimo_detect_per_symbol`` on the same
    y (n_rx, S, N) and h_t (S, n_rx, n_tx, N'), per channel: the LLR bound,
    with the linear detectors' κ-bound carried through the LLR's slope."""
    mimo, kw = _DETECT[name]
    ref, cfg = _cfgs(mimo, **kw)
    mc = ref.mimo
    B, S = 3, 8
    y = _cn(rng, (B, mc.n_rx, S, N))
    h = _cn(rng, (B, S, mc.n_rx, mc.n_tx, n_prime))
    nv = 0.05
    want = np.stack([np.asarray(jpipe._mimo_detect_per_symbol(
        ref, jnp.asarray(y[b]), jnp.asarray(h[b]), jnp.float32(nv))) for b in range(B)])
    s, eff = pipeline.mimo_detect_per_symbol(cfg, _t(y), _t(h), nv)
    got = (s if eff is None else pipeline.whitened_llrs(cfg, s, eff)).numpy()
    extra = 0.0
    if mc.scheme == _X and mc.detector != "ml":
        a = np.moveaxis(h.astype(np.complex128) / np.sqrt(mc.n_tx), -1, -3)
        zf = cfg.equalizer.value == "zf" and mc.detector == "linear"
        g = np.conj(np.swapaxes(a, -1, -2)) @ a + (1e-12 if zf else nv) * np.eye(mc.n_tx)
        kappa = float(np.linalg.cond(g).max())
        levels = float(np.abs(pipeline.constellation(cfg.modulation).numpy().real).max())
        extra = 64 * kappa * U * float(np.abs(s.numpy()).max()) * 4 * levels / float(
            eff.min())
    _assert_llrs_close(got, want, extra, max(1e-3, 4 * extra))


# ---- the midamble receive against the JAX receive's code --------------------------------

def _jax_midamble(ref, y, pre_ref):
    """pipeline.py:910-981 for one channel's post-FFT frame y (n_rx, S', N):
    (h_t (S, n_rx, n_tx, N'), the data rows (n_rx, S, N))."""
    mc = ref.mimo
    K = mc.midamble_period
    Bk = ref.n_symbols // K
    period = mc.n_tx + K
    yb = y.reshape(mc.n_rx, Bk, period, N)
    raw = yb[:, :, :mc.n_tx] / pre_ref
    if ref.channel.model == _RT:
        h_b = jnp.mean(raw, axis=-1, keepdims=True)
    elif ref.estimator == _DFT:
        h_b = raw @ jnp.asarray(jpil._dft_projection_full(N, min(CP + 1, N)))
    else:
        h_b = raw
    h_b = jnp.moveaxis(h_b, 1, 0)
    data = yb[:, :, mc.n_tx:].reshape(mc.n_rx, ref.n_symbols, N)
    dphi = jnp.angle(jnp.sum(h_b[1:] * jnp.conj(h_b[:-1]))) if Bk >= 2 else jnp.float32(0.0)
    h_b = h_b * jnp.exp(jax.lax.complex(jnp.zeros((Bk,), jnp.float32),
                                        -dphi * jnp.arange(Bk, dtype=jnp.float32)))[
        :, None, None, None]
    slot = jnp.arange(mc.n_tx, dtype=jnp.float32) * (dphi / period)
    h_b = h_b * jnp.exp(jax.lax.complex(jnp.zeros_like(slot), -slot))[None, None, :, None]
    s_idx = np.arange(ref.n_symbols)
    b_of = s_idx // K
    g = b_of * period + mc.n_tx + (s_idx % K)
    t_b = b_of * period + 0.0
    w = np.clip((g - t_b) / period, 0.0, 1.0).astype(np.float32)
    b_next = np.minimum(b_of + 1, Bk - 1)
    wj = jnp.asarray(w)[:, None, None, None]
    h_t = (1.0 - wj) * h_b[jnp.asarray(b_of)] + wj * h_b[jnp.asarray(b_next)]
    phi_s = dphi * jnp.asarray((g - t_b[0]) / period, jnp.float32)
    h_t = h_t * jnp.exp(jax.lax.complex(jnp.zeros_like(phi_s), phi_s))[:, None, None, None]
    return h_t, data


@pytest.mark.parametrize("mimo,model,kw", [
    ((_M, 1, 2, dict(csi="preamble", midamble_period=2)), _RT, {}),
    ((_A, 2, 2, dict(csi="preamble", midamble_period=4)), _MT, dict(estimator=_DFT)),
    ((_X, 2, 3, dict(csi="preamble", midamble_period=4)), _MT, {}),
    ((_A, 2, 2, dict(csi="preamble", midamble_period=8)), jcfg.ChannelModel.RAYLEIGH_FLAT,
     dict(phase_noise_std=0.01, pa_ibo_db=6.0)),
    ((_M, 1, 2, dict(csi="preamble", midamble_period=8)), jcfg.ChannelModel.RAYLEIGH_FLAT,
     dict(phase_noise_std=0.01, dft_spread=True)),
], ids=["rayleigh_time_mrc", "multipath_time_dft", "multipath_time_ls_mux",
        "phase_noise_pa_one_block", "phase_noise_scfdma_one_block"])
def test_midamble_estimate_matches_jax(rng, mimo, model, kw):
    """``estimate_mimo_midamble`` against the JAX receive's code on the same
    post-FFT frames: the data rows exactly, h_t at abs 1e-5 / rel 1e-6 of
    O(1) values (a planted common phase drift of 0.3 rad a block, so dphi
    is not 0)."""
    ref, cfg = _cfgs(mimo, model, n_symbols=8, **kw)
    mc = ref.mimo
    Sp = pipeline.n_tx_symbols(cfg)
    y = _cn(rng, (3, mc.n_rx, Sp, N))
    y = (y * np.exp(0.3j * np.arange(Sp) / (mc.n_tx + mc.midamble_period))[:, None]).astype(
        np.complex64)
    pre_ref = jnp.asarray(pipeline.preamble_ref(cfg))
    h_t, data = pipeline.estimate_mimo_midamble(cfg, _t(y))
    assert tuple(h_t.shape) == (3, 8, mc.n_rx, mc.n_tx, 1 if model == _RT else N)
    for b in range(3):
        jh, jd = _jax_midamble(ref, jnp.asarray(y[b]), pre_ref)
        np.testing.assert_array_equal(data[b].numpy(), np.asarray(jd))
        _close(h_t[b].numpy(), np.asarray(jh))


# ---- the whole link against the JAX mimo_llr_link ----------------------------------------

_PRE2 = dict(csi="preamble", midamble_period=2)
_PRE4 = dict(csi="preamble", midamble_period=4)
_ACQ = dict(cfo_subcarriers=1.3, timing_offset=37)
LINKS = {
    # the six configs ``test_torch_mimo.py::test_item_11e_ii_raises`` names
    "rayleigh_time": dict(mimo=(_M, 1, 2), model=_RT, n_symbols=4),
    "multipath_time": dict(mimo=(_M, 1, 2), model=_MT, n_symbols=4),
    "midamble": dict(mimo=(_M, 1, 2, _PRE2), model=_RT, n_symbols=4),
    "phase_noise": dict(mimo=(_M, 1, 2, _PRE2), phase_noise_std=0.01, n_symbols=4),
    "iq": dict(mimo=(_M, 1, 2, dict(csi="preamble")), iq_gain=1.1, n_symbols=4),
    "acquisition": dict(mimo=(_M, 1, 2, _PRE2), n_symbols=4, **_ACQ),
    # time variation with midambles, acquisition composed with the rest
    "multipath_time_genie_alamouti": dict(mimo=(_A, 2, 2), model=_MT),
    "multipath_time_midamble_dft": dict(mimo=(_A, 2, 2, _PRE4), model=_MT, estimator=_DFT),
    "multipath_time_midamble_ls_mux_sic": dict(mimo=(_X, 2, 2, dict(detector="sic", **_PRE4)),
                                               model=_MT),
    "rayleigh_time_ml": dict(mimo=(_X, 2, 2, dict(detector="ml")), model=_RT),
    "rayleigh_time_midamble_ml": dict(mimo=(_X, 2, 2, dict(detector="ml", **_PRE4)), model=_RT,
                                      mod=jcfg.Modulation.QPSK),
    "rayleigh_time_zf_mux": dict(mimo=(_X, 2, 3), model=_RT, equalizer=jcfg.Equalizer.ZF),
    "phase_noise_multipath_dft_ml": dict(mimo=(_X, 2, 2, dict(detector="ml", **_PRE4)),
                                         model=jcfg.ChannelModel.MULTIPATH, estimator=_DFT,
                                         phase_noise_std=2e-3, pdp=(1.0, 0.5)),
    "iq_scfdma": dict(mimo=(_A, 2, 2, dict(csi="preamble")), iq_gain=1.05, iq_phase_rad=0.03,
                      dft_spread=True, estimator=_DFT),
    "acquisition_rayleigh_time": dict(mimo=(_M, 1, 2, _PRE4), model=_RT, cfo_subcarriers=1.7,
                                      timing_offset=21),
    "acquisition_walk_iq": dict(mimo=(_A, 2, 2, _PRE4), phase_noise_std=2e-3, iq_gain=1.05,
                                iq_phase_rad=0.03, **_ACQ),
    "acquisition_pa": dict(mimo=(_A, 2, 2, _PRE4), pa_ibo_db=6.0, **_ACQ),
    "acquisition_scfdma": dict(mimo=(_A, 2, 2, _PRE4), dft_spread=True, **_ACQ),
    "acquisition_multipath_time_sic": dict(mimo=(_X, 2, 2, dict(detector="sic", **_PRE4)),
                                           model=_MT, cfo_subcarriers=-0.7, timing_offset=11),
}


def _jax_draws(ref, keys):
    """Each channel's draws as the JAX link makes them from its key
    (pipeline.py:745-870), in the port's injection forms: the pairs' fading
    (``mimo_fading``'s shape), the noise planes (``mimo_channel``'s
    (B, n_rx·S', L) or ``mimo_stream``'s (B, n_rx, T)) and the walk's
    increments (B, n)."""
    mc, ch = ref.mimo, ref.channel
    cfg = interop.link_config_from_reference(ref)
    Sp = pipeline.n_tx_symbols(cfg)
    n_gain = Sp + (2 if ch.impaired else 0)
    n = ch.timing_offset + (Sp + 3) * L if ch.impaired else Sp * L
    M = jcfg.ChannelModel

    def one(key):
        kf = jprng.role_key(key, jprng.ROLE_FADING)
        pairs = (mc.n_rx, mc.n_tx)
        if ch.model == M.RAYLEIGH_TIME:
            f = jchan.jakes_gains(kf, n_gain, ch.doppler_norm, batch_shape=pairs)[..., None]
        elif ch.model == M.MULTIPATH_TIME:
            f = jchan.multipath_time_taps(kf, ch.pdp, n_gain, ch.doppler_norm,
                                          batch_shape=pairs)
        elif ch.model == M.RAYLEIGH_FLAT:
            f = jchan.rayleigh_flat(kf, pairs)[..., None]
        else:
            f = jchan.multipath_taps(kf, ch.pdp, batch_shape=pairs)
        kr, ki = jax.random.split(jprng.role_key(key, jprng.ROLE_NOISE))
        nre = jax.random.normal(kr, (mc.n_rx, n), jnp.float32)
        nim = jax.random.normal(ki, (mc.n_rx, n), jnp.float32)
        walk = jax.random.normal(jprng.role_key(key, jprng.ROLE_PHASE), (n,), jnp.float32)
        return f, nre, nim, walk

    f, nre, nim, walk = (np.asarray(t) for t in jax.jit(jax.vmap(one))(keys))
    B = keys.shape[0]
    noise = (nre, nim) if ch.impaired else tuple(t.reshape(B, mc.n_rx * Sp, L)
                                                 for t in (nre, nim))
    return cfg, dict(fading=_t(f), noise=tuple(map(_t, noise)), phase=_t(walk))


@functools.lru_cache(maxsize=None)
def _link_case(name):
    """(ref, cfg, bits, injected draws, the JAX LLRs per channel)."""
    kw = dict(LINKS[name])
    ref, _ = _cfgs(kw.pop("mimo"), **kw)
    B = ref.n_channels
    keys = jax.vmap(lambda c: jax.random.fold_in(jax.random.PRNGKey(SEED), c))(jnp.arange(B))
    bps = ref.modulation.bits_per_symbol
    bits = np.random.default_rng(sorted(LINKS).index(name)).integers(
        0, 2, (B, ref.mimo.n_streams, ref.n_symbols, N * bps)).astype(np.int8)
    want = np.asarray(jax.jit(jax.vmap(lambda k, b: jpipe.mimo_llr_link(ref, k, b)))(
        keys, jnp.asarray(bits)))
    cfg, draws = _jax_draws(ref, keys)
    return ref, cfg, bits, draws, want


def _acquisition_tol(z):
    """(δε bound (B,), ρ) of the module docstring on the port's streams z
    (B, n_rx, T): the float32 sliding sums P(d) = c[d+h−1] − c[d−1] of
    c = cumsum(conj(r[k])·r[k+h]) are each within k·u·Σ_{i≤k}|a_i| of exact
    at index k in either package, so the window sum the fractional CFO
    takes the angle of (the CP-wide plateau window, every antenna) within
    4·Σ of those plus its own rounding; its angle / π moves by that over
    π|sum|."""
    h, half = N // 2, max(CP // 2, 1)
    P, _, M = sync_ops.timing_metric(_t(z), N)
    d = sync_ops._centroid(M.mean(dim=-2), N).numpy()
    P = P.numpy().astype(np.complex128)
    a = np.conj(z[..., :-h]).astype(np.complex128) * z[..., h:]
    rb = np.arange(1, a.shape[-1] + 1) * U * np.cumsum(np.abs(a), -1)
    win = np.clip(d - half, 0, P.shape[-1] - CP)[:, None] + np.arange(CP)
    n_rx = z.shape[1]
    win_p = np.take_along_axis(P, np.repeat(win[:, None], n_rx, 1), -1)
    tol_p = 4 * np.take_along_axis(rb, np.repeat((win + h - 1)[:, None], n_rx, 1), -1).sum(
        (1, 2)) + CP * n_rx * U * np.abs(win_p).sum((1, 2))
    tol_c = tol_p / (np.pi * np.abs(win_p.sum((1, 2)))) + 4 * U
    T = z.shape[-1]
    rho = float((2 * np.pi * tol_c * T / N).max() + 4 * np.spacing(
        np.float32(2 * np.pi * 5 * T / N)) + 2 * U)
    return tol_c, rho


@pytest.mark.parametrize("name", sorted(LINKS))
def test_link_matches_jax_mimo_llr_link(name):
    """The port's ``mimo_llr_link`` on the JAX link's own draws (its keys'
    fading, noise and walk) against the JAX ``mimo_llr_link``, per channel:
    the LLR bound of the module docstring; on the acquired links the
    start equal to the JAX ``acquire_array``'s on the same streams."""
    ref, cfg, bits, draws, want = _link_case(name)
    ids = torch.arange(cfg.n_channels, dtype=torch.int32)
    got = pipeline.mimo_llr_link(cfg, SEED, ids, _t(bits), **draws).numpy()
    assert got.shape == want.shape == bits.shape
    extra = 0.0
    if cfg.channel.impaired:
        bps = cfg.modulation.bits_per_symbol
        idx = pipeline._bits_to_ints(_t(bits), bps).to(pipeline.out_dtype(bps)).reshape(
            bits.shape[0], -1, N)
        z = pipeline.mimo_stream(cfg, SEED, ids, pipeline.mimo_tx(cfg, idx), **draws)
        start, total, _ = pipeline.mimo_acquire(cfg, z)
        js, jt, _ = jax.jit(jax.vmap(lambda r: jsync.acquire_array(r, N, CP)))(
            jnp.asarray(z.numpy()))
        np.testing.assert_array_equal(start.numpy(), np.asarray(js))
        tol_c, rho = _acquisition_tol(z.numpy())
        assert np.all(np.abs(total.numpy() - np.asarray(jt)) <= tol_c)
        extra = 4 * rho * float(np.abs(want).max())
    _assert_llrs_close(got, want, extra)


# ---- the keyed link ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rayleigh_time_ml", "multipath_time_midamble_dft",
                                  "acquisition_walk_iq", "iq_scfdma"])
def test_keyed_link_split_passes_and_llrs(name, monkeypatch):
    """Channels [0, 2) alone count what they count in the full run; passes
    of ``CHUNK`` channels (2 here) equal one pass; ``want_llrs`` gives
    (B, n_streams, S, N·bps) whose hard bits the count counts; the sharded
    function on one rank equals ``simulate``."""
    kw = dict(LINKS[name])
    _, cfg = _cfgs(kw.pop("mimo"), **{**kw, "n_channels": 5})
    full = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
    B, mc, bps = cfg.n_channels, cfg.mimo, cfg.modulation.bits_per_symbol
    assert tuple(full.llrs.shape) == (B, mc.n_streams, cfg.n_symbols, N * bps)
    assert int(full.bits_counted[0]) == mc.n_streams * cfg.n_symbols * N * bps
    part, _, _ = pipeline.simulate_core(cfg, SEED, torch.arange(2, dtype=torch.int32))
    assert torch.equal(part, full.bit_errors[:2])
    idx = pipeline.draw_mimo_idx(cfg, SEED, torch.arange(B, dtype=torch.int32))
    bits = pipeline._ints_to_bits(idx, bps).reshape(full.llrs.shape)
    assert torch.equal(full.bit_errors, ((full.llrs < 0).to(torch.int8) != bits).sum(
        dim=(1, 2, 3), dtype=torch.int32))
    monkeypatch.setattr(pipeline, "CHUNK", 2)
    assert torch.equal(pipeline.simulate(cfg, SEED, device="cpu").bit_errors, full.bit_errors)
    assert torch.equal(make_sharded_simulate_fn(cfg, make_link_mesh(), device="cpu")(SEED)[0],
                       full.bit_errors)


def test_keyed_walk_is_shared_and_noise_counters():
    """The walk is one per channel (``wiener_increments`` at the sample's
    position), rotating every antenna alike: a walk-only link's RX planes
    are the planes of a zero walk times one rotation (within 1e-6 of O(1)
    samples); the acquired streams' noise is E's at counter (channel, r,
    n) (abs 1e-5 / rel 1e-6)."""
    _, cfg = _cfgs((_M, 1, 2, _PRE2), phase_noise_std=0.05, n_symbols=4)
    ids = torch.arange(3, dtype=torch.int32)
    tx = pipeline.mimo_tx(cfg, pipeline.draw_mimo_idx(cfg, SEED, ids))
    rx, _ = pipeline.mimo_channel(cfg, SEED, ids, tx)
    Sp = pipeline.n_tx_symbols(cfg)
    rx0, _ = pipeline.mimo_channel(cfg, SEED, ids, tx, phase=torch.zeros((3, Sp * L)))
    ph = chan.wiener_phase(SEED, ids, Sp * L, 0.05)
    want = torch.complex(*rx0).reshape(3, 2, -1) * ph[:, None]
    got = torch.complex(*rx).reshape(3, 2, -1)
    assert float((got - want).abs().max()) <= 1e-6
    _, acq = _cfgs((_M, 1, 2, _PRE2), n_symbols=4, ebno_db=0.0, **_ACQ)
    z = pipeline.mimo_stream(acq, SEED, ids, pipeline.mimo_tx(acq, pipeline.draw_mimo_idx(
        acq, SEED, ids)), fading=torch.zeros((3, 2, 1, 1), dtype=torch.complex64))
    n_re, n_im = prng.normal_pair(SEED, prng.ROLE_NOISE, ids, tuple(z.shape[1:]))
    sigma = (pipeline.mimo_noise_var(acq) / N / 2) ** 0.5
    _close(z.real.numpy(), (sigma * n_re).numpy())
    _close(z.imag.numpy(), (sigma * n_im).numpy())


def test_ofdm_rx_of_the_acquired_slice_is_the_frame():
    """``mimo_acquire``'s planes are (B, n_rx, S', L): on a noiseless,
    CFO-free stream at offset 0 the slice starts at the body and its FFT is
    the aligned link's."""
    _, cfg = _cfgs((_M, 1, 2, _PRE2), n_symbols=4, ebno_db=200.0, timing_offset=9,
                   cfo_subcarriers=0.0)
    ids = torch.arange(2, dtype=torch.int32)
    tx = pipeline.mimo_tx(cfg, pipeline.draw_mimo_idx(cfg, SEED, ids))
    fade = torch.ones((2, 2, 1, 1), dtype=torch.complex64)
    z = pipeline.mimo_stream(cfg, SEED, ids, tx, fading=fade)
    start, total, rx = pipeline.mimo_acquire(cfg, z)
    np.testing.assert_array_equal(start.numpy(), [9 + 2 * L] * 2)
    assert float(total.abs().max()) < 1e-3
    body = torch.complex(*tx)[:, :, 2:-1]
    y = ofdm_rx(torch.complex(*rx), CP)
    np.testing.assert_allclose(y.numpy(), ofdm_rx(body.expand(2, 2, -1, L), CP).numpy(),
                               atol=2e-3)
