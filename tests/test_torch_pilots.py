"""Pilots and pilot-based channel estimation in the port
(``sdr_tpu_torch.ops.pilots`` and the pilot branches of
``sdr_tpu_torch.link.pipeline``) on the CPU, against the JAX package at a
small size (B 8, S 8 or 16, N 16–64).

- The tables (pilot and data indices, the lerp tables, Zadoff–Chu, the
  PN preamble grid, both DFT projections) and ``insert_pilots`` /
  ``extract_data`` exactly equal to JAX's.
- Every estimator on the same y within the reference tolerance.
- ``tx_chain`` (kernel B's plain version with the comb; SC-FDMA block
  pilots) against the JAX ``tx_chain`` on the same bits, with a spacing
  that does not divide N.
- ``rx_chain`` on the same received planes for every branch that config
  validation admits without impairments, and the counts (kernel C's
  plain comb count, the despread count on the data rows) against the
  JAX count on those planes.
- ``simulate``: a channel slice equals the full run's, and a pilot link
  draws its genie twin's data at the data positions.

Tolerances (stated before each comparison): tables, ``insert_pilots``
and ``extract_data`` exact; estimates abs 1e-5 / rel 1e-6 on unit-scale
inputs (BASELINE.md:13-16); samples the same; LLR planes abs 1e-5 / rel
1e-6 of the plane divided by its peak |LLR| (``tests/test_torch_pipeline.py``'s
convention), SC-FDE LLRs with their SINR's conditioning added
(``_despread_rtol``); hard bits equal but where the JAX |LLR| < 1e-3;
counts within the bits whose JAX |LLR| < 1e-3.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.link import pipeline as jpipe
from sdr_tpu.ops import pilots as jpil
from sdr_tpu_torch import interop
from sdr_tpu_torch.kernels import demod as kc
from sdr_tpu_torch.kernels import tx as kb
from sdr_tpu_torch.link import pipeline
from sdr_tpu_torch.ops import pilots as pil

torch.set_num_threads(1)

B, S, N, CP = 8, 16, 64, 16
L = N + CP
PDP3 = (1.0, 0.5, 0.25)
SEED = 19


def _cfgs(spacing=4, dft_spread=False, estimator=jcfg.ChannelEstimator.LS,
          model=jcfg.ChannelModel.MULTIPATH, equalizer=jcfg.Equalizer.MMSE, n_symbols=S,
          n_channels=B, ebno_db=12.0, **channel):
    """The same pilot link in both packages: (JAX LinkConfig, the port's)."""
    if model in (jcfg.ChannelModel.MULTIPATH, jcfg.ChannelModel.MULTIPATH_TIME):
        channel.setdefault("pdp", PDP3)
    if model in (jcfg.ChannelModel.RAYLEIGH_TIME, jcfg.ChannelModel.MULTIPATH_TIME):
        channel.setdefault("doppler_norm", 0.02)
    ref = jcfg.LinkConfig(modulation=jcfg.Modulation.QAM16,
                          ofdm=jcfg.OFDMConfig(n_fft=N, cp_len=CP),
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


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-6)


# ---- the tables ------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,spacing,n_taps", [(16, 4, 4), (64, 8, 8), (64, 3, 17),
                                                  (64, 64, 1), (32, 5, 7)])
def test_tables_equal_jax(n_fft, spacing, n_taps):
    """Exactly equal: same values, same dtypes."""
    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    assert pil.pilot_indices(n_fft, spacing) == jpil.pilot_indices(n_fft, spacing)
    assert pil.data_indices(n_fft, spacing) == jpil.data_indices(n_fft, spacing)
    assert pil.n_data_subcarriers(n_fft, spacing) == jpil.n_data_subcarriers(n_fft, spacing)
    for a, b in zip(pil._interp_tables(n_fft, spacing), jpil._interp_tables(n_fft, spacing)):
        same(a, b)
    same(pil._dft_projection(n_fft, spacing, n_taps),
         jpil._dft_projection(n_fft, spacing, n_taps))
    same(pil._dft_projection_full(n_fft, n_taps), jpil._dft_projection_full(n_fft, n_taps))
    same(pil.zadoff_chu(n_fft), jpil.zadoff_chu(n_fft))
    same(pil.zadoff_chu(n_fft - 1, 3), jpil.zadoff_chu(n_fft - 1, 3))
    same(pil.pn_preamble_grid(n_fft), jpil.pn_preamble_grid(n_fft))
    same(pil.pn_preamble_grid(n_fft, 7), jpil.pn_preamble_grid(n_fft, 7))
    assert pil.dft_n_taps(n_fft, CP, spacing) == jpil.dft_n_taps(n_fft, CP, spacing)
    assert pil.PILOT_VALUE == jpil.PILOT_VALUE
    with pytest.raises(ValueError, match="spacing"):
        pil.pilot_indices(n_fft, 1)


@pytest.mark.parametrize("spacing", [4, 3])
def test_insert_and_extract_equal_jax(rng, spacing):
    data = _cn(rng, (3, 5, pil.n_data_subcarriers(N, spacing)))
    want = np.asarray(jpil.insert_pilots(jnp.asarray(data), N, spacing))
    got = pil.insert_pilots(torch.from_numpy(data), N, spacing)
    np.testing.assert_array_equal(got.numpy(), want)
    grid = _cn(rng, (3, 5, N))
    np.testing.assert_array_equal(pil.extract_data(torch.from_numpy(grid), spacing).numpy(),
                                  np.asarray(jpil.extract_data(jnp.asarray(grid), spacing)))


# ---- the estimators -------------------------------------------------------------

def _dft_base(mod, n_taps):
    return functools.partial(mod.estimate_dft_comb, n_taps=n_taps)


# name → (function of the module (jpil or pil) and y, input shape)
_ESTIMATORS = {
    "ls": (lambda m, y: m.estimate_ls_comb(y, 4), (B, S, N)),
    "ls_per_symbol": (lambda m, y: m.estimate_ls_comb(y, 3, per_symbol=True), (B, S, N)),
    "dft": (lambda m, y: m.estimate_dft_comb(y, 4, 16), (B, S, N)),
    "dft_per_symbol": (lambda m, y: m.estimate_dft_comb(y, 8, 8, per_symbol=True), (B, S, N)),
    "ls_tracked": (lambda m, y: m.estimate_ls_comb_tracked(y, 4), (B, S, N)),
    "dft_tracked": (lambda m, y: m.estimate_ls_comb_tracked(y, 4, base=_dft_base(m, 16)),
                    (B, S, N)),
    "block": (lambda m, y: m.estimate_block_pilots(y), (B, 4, N)),
    "block_dft": (lambda m, y: m.estimate_block_pilots(y, CP + 1), (B, 4, N)),
    "block_interp": (lambda m, y: m.estimate_block_pilots_interp(y, 4), (B, 4, N)),
    "block_interp_one_block": (lambda m, y: m.estimate_block_pilots_interp(y, 4), (B, 1, N)),
    "block_interp_full": (lambda m, y: m.estimate_block_pilots_interp_full(y, 4), (B, 4, N)),
    "block_tracked": (lambda m, y: m.estimate_block_pilots_tracked(y, 4), (B, 4, N)),
    "block_tracked_dft": (lambda m, y: m.estimate_block_pilots_tracked(y, 4, CP + 1),
                          (B, 4, N)),
    "block_tracked_one_block": (lambda m, y: m.estimate_block_pilots_tracked(y, 4), (B, 1, N)),
    "mimo_preamble": (lambda m, y: m.estimate_mimo_preamble(y), (B, 2, 2, N)),
    "mimo_preamble_dft": (lambda m, y: m.estimate_mimo_preamble(y, CP + 1), (B, 2, 2, N)),
}


@pytest.mark.parametrize("name", list(_ESTIMATORS))
def test_estimators_match_jax(rng, name):
    """Unit-scale y (the comb and block estimators, the tracked forms,
    which only impaired links reach in the pipeline, and the MIMO
    preamble): abs 1e-5 / rel 1e-6."""
    fn, shape = _ESTIMATORS[name]
    y = _cn(rng, shape)
    want = np.asarray(fn(jpil, jnp.asarray(y)))
    got = fn(pil, torch.from_numpy(y))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    _close(got.numpy(), want)


# ---- the TX ---------------------------------------------------------------------

_TX = {
    "comb4": dict(spacing=4),
    "comb3": dict(spacing=3),  # 3 does not divide N: the comb is range(0, N, 3)
    "comb64": dict(spacing=N),  # one pilot, tone 0
    "block4": dict(spacing=4, dft_spread=True),
    "block2": dict(spacing=2, dft_spread=True, n_symbols=8),
}


@pytest.mark.parametrize("case", list(_TX))
def test_tx_chain_matches_jax(rng, case):
    """Kernel B's plain version with the comb (and the SC-FDMA block-pilot
    TX) against the JAX ``tx_chain`` on the same bits: abs 1e-5 / rel 1e-6."""
    ref, cfg = _cfgs(**_TX[case])
    bits = rng.integers(0, 2, (B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)).astype(np.int8)
    want = np.asarray(jpipe.tx_chain(ref, jnp.asarray(bits)))
    re, im = pipeline.tx_chain(cfg, torch.from_numpy(bits))
    assert re.shape == (B, cfg.n_symbols, L) and re.dtype == torch.float32
    _close(re, want.real)
    _close(im, want.imag)


def test_tx_comb_plain_is_insert_pilots():
    """B's plain comb mode on A's grid is ``ofdm_tx(insert_pilots(...))`` of
    the grid's data tones: the pilot tones' indices are not read."""
    _, cfg = _cfgs(spacing=3)
    ids = torch.arange(B, dtype=torch.int32)
    idx = pipeline.draw_idx(cfg, SEED, ids)
    other = idx.clone()
    other[..., list(pil.pilot_indices(N, 3))] = 0
    got = kb.tx_channel_plain(idx, CP, cfg.modulation, pilot_spacing=3)
    for a, b in zip(got, kb.tx_channel_plain(other, CP, cfg.modulation, pilot_spacing=3)):
        assert torch.equal(a, b)
    from sdr_tpu_torch.ops.modulation import constellation
    from sdr_tpu_torch.ops.ofdm import ofdm_tx
    pts = constellation(cfg.modulation)[pil.data_tones(idx, 3).to(torch.int64)]
    want = ofdm_tx(pil.insert_pilots(pts, N, 3), CP)
    _close(got[0].numpy(), want.real.numpy())
    _close(got[1].numpy(), want.imag.numpy())


def test_comb_wrappers_refuse_spacings_outside_the_grid():
    _, cfg = _cfgs()
    idx = pipeline.draw_idx(cfg, SEED, torch.arange(2, dtype=torch.int32))
    re, im = kb.tx_chain(idx, CP, cfg.modulation)
    h = torch.ones((2, 1, N))
    for bad in (1, N + 1, -2):
        with pytest.raises(ValueError, match="pilot_spacing"):
            kb.tx_chain(idx, CP, cfg.modulation, pilot_spacing=bad)
        with pytest.raises(ValueError, match="pilot_spacing"):
            kc.demod_count(re, im, h, 0 * h, idx, CP, cfg.modulation, 0.1, pilot_spacing=bad)
    with pytest.raises(ValueError, match="despread"):
        kc.demod_count(re, im, h, 0 * h, idx, CP, cfg.modulation, 0.1, despread=True,
                       pilot_spacing=4)
    taps = torch.ones((2, 2))
    with pytest.raises(ValueError, match="FIR"):
        kb.tx_channel(idx, CP, cfg.modulation, taps_r=taps, taps_i=0 * taps, pilot_spacing=4)


# ---- the receive ------------------------------------------------------------------

DFT, LS = jcfg.ChannelEstimator.DFT, jcfg.ChannelEstimator.LS
MP, RT, MT = (jcfg.ChannelModel.MULTIPATH, jcfg.ChannelModel.RAYLEIGH_TIME,
              jcfg.ChannelModel.MULTIPATH_TIME)
ZF = jcfg.Equalizer.ZF

# Every branch config validation admits without impairments: name →
# (config keywords, track_phase).
_RX = {
    "comb_ls": (dict(), False),
    "comb_dft": (dict(estimator=DFT), False),
    "comb_ls_zf": (dict(equalizer=ZF), False),
    "comb_dft_zf": (dict(estimator=DFT, equalizer=ZF), False),
    "comb_ls_spacing3": (dict(spacing=3), False),
    "comb_rayleigh_time": (dict(model=RT), False),
    "comb_multipath_time_dft": (dict(model=MT, estimator=DFT), False),
    "comb_tracked_ls": (dict(), True),
    "comb_tracked_dft": (dict(estimator=DFT, equalizer=ZF), True),
    "block_static": (dict(dft_spread=True), False),
    "block_static_dft": (dict(dft_spread=True, estimator=DFT), False),
    "block_static_dft_zf": (dict(dft_spread=True, estimator=DFT, equalizer=ZF), False),
    "block_interp": (dict(dft_spread=True, model=RT), False),
    "block_interp_full": (dict(dft_spread=True, model=MT), False),
    "block_interp_full_zf": (dict(dft_spread=True, model=MT, equalizer=ZF), False),
}


@functools.lru_cache(maxsize=None)
def _received(case):
    """One received frame for ``case`` and the JAX receiver on it:
    (ref, cfg, bits, rx (B, S, L) complex64, nv, JAX llrs, JAX hard bits).
    The frame is the JAX ``tx_chain`` of random bits through a static
    3-tap channel per link (within the CP) plus noise, so the estimates
    and the LLRs are a link's."""
    kw, track = _RX[case]
    ref, cfg = _cfgs(**kw)
    rng = np.random.default_rng(sum(map(ord, case)))
    bits = rng.integers(0, 2, (B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)).astype(np.int8)
    tx = np.asarray(jpipe.tx_chain(ref, jnp.asarray(bits)))
    taps = _cn(rng, (B, 3)) * np.sqrt(np.asarray(PDP3) / sum(PDP3)).astype(np.float32)
    stream = tx.reshape(B, -1)
    faded = np.stack([np.convolve(stream[b], taps[b])[:stream.shape[1]] for b in range(B)])
    nv = 0.05
    rx = (faded + _cn(np.random.default_rng(1), faded.shape, np.sqrt(nv / N)))
    rx = rx.reshape(B, cfg.n_symbols, L).astype(np.complex64)
    llrs, hard = jpipe.rx_chain(ref, jnp.asarray(rx), None, jnp.float32(nv), track_phase=track)
    return ref, cfg, bits, rx, nv, np.asarray(llrs), np.asarray(hard)


def _despread_rtol(cfg, h, nv):
    """The SC-FDE LLRs' relative tolerance per data symbol: 1e-6 plus the
    conditioning of its SINR b/(1 − b), b the tone mean of |h|²/(|h|² + nv)
    (float32 sums of N terms, in another order in each package): 8 float32
    ulps of b over 1 − b."""
    h2 = np.abs(np.broadcast_to(h.numpy(), (B, cfg.n_data_symbols, N)).astype(np.complex128)) ** 2
    b = (h2 / (h2 + nv)).mean(axis=-1)
    return 1e-6 + 2.0 ** -20 / (1.0 - b)


@pytest.mark.parametrize("case", list(_RX))
def test_rx_chain_matches_jax(case):
    """The pilot receive on the same planes: the comb through kernel C's
    plain LLR plane on the estimate, cut to the data tones; the block
    pilots through C's plain despread (MMSE) or the plain ZF despread on
    the gathered data rows."""
    ref, cfg, bits, rx, nv, want, want_hard = _received(case)
    track = _RX[case][1]
    got, hard = pipeline.rx_chain(cfg, _planar(rx), None, nv, track_phase=track)
    assert tuple(got.shape) == want.shape == (B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)
    got = got.numpy()
    peak = float(np.abs(want).max())
    if cfg.dft_spread and cfg.equalizer == jcfg.Equalizer.MMSE:
        _, h = pipeline._estimate(cfg, _planar(rx))
        rtol = np.repeat(_despread_rtol(cfg, h, nv)[..., None], want.shape[-1], axis=-1)
        assert bool(np.all(np.abs(got - want) <= 1e-5 * peak + rtol * np.abs(want)))
    else:
        np.testing.assert_allclose(got / peak, want / peak, atol=1e-5, rtol=1e-6)
    sure = np.abs(want) >= 1e-3
    np.testing.assert_array_equal(hard.numpy()[sure], want_hard[sure])
    assert int((want_hard != bits).sum()) > 0  # the link makes errors: the counts are tested


@pytest.mark.parametrize("case", list(_RX))
def test_count_matches_jax(case):
    """Kernel C's plain count on the same planes (the comb: its count
    skipping the pilot tones; block pilots: the despread count on the data
    rows, the ZF despread through its plane) against the JAX count:
    per channel within the bits whose JAX |LLR| < 1e-3."""
    ref, cfg, bits, rx, nv, want, want_hard = _received(case)
    bps = cfg.modulation.bits_per_symbol
    ints = pipeline._bits_to_ints(torch.from_numpy(bits), bps).to(torch.int8)
    grid = pipeline._grid_of(cfg, ints)
    got = pipeline.count_errors(cfg, _planar(rx), None, nv, grid, track_phase=_RX[case][1])
    want_count = (want_hard != bits).sum(axis=(1, 2))
    margin = (np.abs(want) < 1e-3).sum(axis=(1, 2))
    assert got.dtype == torch.int32 and bool(np.all(np.abs(got.numpy() - want_count) <= margin))
    if not cfg.dft_spread:
        # The comb count is C's count over the whole grid but the pilot tones.
        _, h = pipeline._estimate(cfg, _planar(rx), _RX[case][1])
        hr, hi = pipeline._h_plane(h, B, N, "cpu")
        direct = kc.demod_count_plain(*_planar(rx), hr, hi, grid, CP, cfg.modulation, nv,
                                      pilot_spacing=cfg.pilot_spacing)
        assert torch.equal(direct, got)


# ---- simulate ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(estimator=DFT), dict(dft_spread=True, model=RT)],
                         ids=["comb_dft", "block_interp"])
def test_simulate_split_equals_full(kw):
    """Channels [0, 3) and [3, B) alone give the full run's counts; the
    LLR plane's hard bits count what the count counts (but for bits with
    |LLR| < 1e-3); bits_counted is the payload."""
    _, cfg = _cfgs(**kw)
    full = pipeline.simulate(cfg, SEED, device="cpu")
    parts = [pipeline.simulate_core(cfg, SEED, torch.arange(a, b, dtype=torch.int32))[0]
             for a, b in ((0, 3), (3, B))]
    assert torch.equal(torch.cat(parts), full.bit_errors) and int(full.bit_errors.sum()) > 0
    assert int(full.bits_counted[0]) == cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    res = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
    margin = (res.llrs.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((res.bit_errors - full.bit_errors).abs() <= margin).all())
    assert tuple(res.llrs.shape) == (B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)
    fn = pipeline.make_simulate_fn(cfg, device="cpu")
    assert torch.equal(fn(SEED).bit_errors, full.bit_errors)


@pytest.mark.parametrize("kw", [dict(spacing=3), dict(spacing=4, dft_spread=True)],
                         ids=["comb3", "block4"])
def test_pilot_link_draws_its_genie_twins_data(kw):
    """A pilot config and its genie twin (pilot_spacing 0, same seed) draw
    the same indices at the data positions: the pilot link's payload is the
    twin's grid at the data tones or rows."""
    _, cfg = _cfgs(**kw)
    twin = dataclasses.replace(cfg, pilot_spacing=0)
    ids = torch.arange(2, 2 + B, dtype=torch.int32)
    bits = pipeline.generate_bits(cfg, SEED, ids)
    grid = pipeline.draw_idx(twin, SEED, ids)
    bps = cfg.modulation.bits_per_symbol
    assert tuple(bits.shape) == (B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)
    if cfg.dft_spread:
        data = grid.reshape(B, -1, cfg.pilot_spacing, N)[:, :, 1:].reshape(B, -1, N)
    else:
        data = grid[..., list(pil.data_indices(N, cfg.pilot_spacing))]
    assert torch.equal(pipeline._bits_to_ints(bits, bps), data.to(torch.int32))
    assert torch.equal(pipeline.payload_of(cfg, grid), data)
