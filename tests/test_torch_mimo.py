"""MIMO on frame-static channels in the port (ROADMAP item 11e-i) on the CPU,
against the JAX package at small sizes (B ≤ 4, S ≤ 8, N 16 or 64, CP 4 or
16): every function of ``ops/mimo.py``, the diversity curves of
``link/ber.py``, the index-domain Alamouti layout, and the MIMO link's two
halves — TX and channel (``pipeline.mimo_tx``, ``mimo_channel``) and the
receive (``pipeline.mimo_rx``) — against a JAX chain built from the JAX ops
(``alamouti_encode``/``mux_encode``, ``ofdm_tx``, the channel einsum or
``apply_multipath``, ``ofdm_rx``, ``estimate_mimo_preamble``, the
detectors, ``_mimo_llrs``) on injected bits, fading and noise, for each
scheme, detector, model, CSI mode, SC-FDMA and the PA; then the keyed link's
structure (split == full, passes, the LLR plane against the count), the
item 11e-ii configs that now run, and what the port refuses. ``tests/test_torch_mimo_links.py`` holds the JAX tests'
link gates.

Tolerances (stated before each comparison; u = 2^-24):

- the combiners, the encoders and the channel's samples: abs 1e-5 /
  rel 1e-6 (BASELINE.md:13-16) on O(1) inputs;
- the linear detectors: a solve by a matrix of condition κ moves its result
  by about κ·u relative to its scale, so abs 64·κ·u times the peak of the
  JAX output (the 2 × 2 closed form and ``linalg.inv`` on both sides);
- SIC and ML: decisions exactly — SIC's hard symbols of every round (the
  ordering and the slices), ML's hard bits — and the soft values as the
  linear detectors' (SIC) or at abs 1e-5 of the plane's peak |LLR| (ML);
- LLR planes of the link: abs 1e-5 of the plane's peak |LLR| (the pipeline
  tests' convention) plus, for the linear detectors, their κ-bound carried
  through the LLR's slope (an LLR is piecewise linear in the estimate,
  slope ≤ 4·max level/eff_var); hard bits equal but where the JAX
  |LLR| < 1e-3 (the same share of its peak for ZF and SIC);
- the diversity curves to 1e-12; the Alamouti index identity exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.link import ber as jber
from sdr_tpu.link import pipeline as jpipe
from sdr_tpu.ops import channel as jchan
from sdr_tpu.ops import mimo as jmo
from sdr_tpu.ops import pa as jpa
from sdr_tpu.ops import pilots as jpil
from sdr_tpu.ops.modulation import modulate as jmodulate
from sdr_tpu.ops.ofdm import ofdm_rx as jofdm_rx
from sdr_tpu.ops.ofdm import ofdm_tx as jofdm_tx
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.link import ber, fast, pipeline, stream
from sdr_tpu_torch.ops import mimo as mo
from sdr_tpu_torch.ops.modulation import constellation, modulate, nearest_symbol
from sdr_tpu_torch.parallel.mesh import make_link_mesh
from sdr_tpu_torch.parallel.shard import make_sharded_fast_fn, make_sharded_simulate_fn

torch.set_num_threads(1)

U = 2.0 ** -24
SEED = 21
MODS = [Modulation.BPSK, Modulation.QPSK, Modulation.QAM16, Modulation.QAM64,
        Modulation.QAM256, Modulation.QAM1024]
JMOD = {m: jcfg.Modulation(m.value) for m in MODS}


def _cn(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * (scale / np.sqrt(2))).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-6)


def _kappa(h, nv, zf):
    """Condition number of the matrix each linear detector inverts."""
    a = np.moveaxis(h.astype(np.complex128) / np.sqrt(h.shape[-2]), -1, -3)
    g = np.conj(np.swapaxes(a, -1, -2)) @ a + (1e-12 if zf else nv) * np.eye(h.shape[-2])
    return float(np.linalg.cond(g).max())


def _close_kappa(got, want, kappa):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=64 * kappa * U * float(np.abs(want).max()), rtol=0)


def _assert_llrs_close(got, want, extra=0.0, sure_at=1e-3):
    """LLR planes (module docstring): abs 1e-5 of the peak plus ``extra``;
    hard bits equal where the JAX |LLR| ≥ ``sure_at``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * peak + extra, rtol=0)
    sure = np.abs(want) >= sure_at
    np.testing.assert_array_equal((got < 0)[sure], (want < 0)[sure])


# ---- ops/mimo.py -----------------------------------------------------------------------

def test_alamouti_encode_and_layout(rng):
    x = _cn(rng, (3, 8, 16))
    _close(mo.alamouti_encode(_t(x)).numpy(), jmo.alamouti_encode(jnp.asarray(x)))
    np.testing.assert_array_equal(mo.alamouti_layout(_t(x)).numpy() * np.float32(2 ** -0.5),
                                  mo.alamouti_encode(_t(x)).numpy())
    with pytest.raises(ValueError, match="even symbol count"):
        mo.alamouti_encode(_t(x[:, :3]))
    xs = _cn(rng, (3, 4, 8, 16))
    _close(mo.mux_encode(_t(xs)).numpy(), jmo.mux_encode(jnp.asarray(xs)))


@pytest.mark.parametrize("n_prime", [1, 16], ids=["flat", "per_tone"])
@pytest.mark.parametrize("n_rx", [1, 2, 4])
def test_combiners_match_jax(rng, n_rx, n_prime):
    y = _cn(rng, (3, n_rx, 8, 16))
    h = _cn(rng, (3, n_rx, 2, n_prime))
    for got, want in zip(mo.alamouti_combine(_t(y), _t(h), 0.1),
                         jmo.alamouti_combine(jnp.asarray(y), jnp.asarray(h), 0.1)):
        assert tuple(got.shape) == want.shape
        _close(got.numpy(), want)
    h1 = h[:, :, :1]
    for got, want in zip(mo.mrc_combine(_t(y), _t(h1), 0.1),
                         jmo.mrc_combine(jnp.asarray(y), jnp.asarray(h1), 0.1)):
        assert tuple(got.shape) == want.shape
        _close(got.numpy(), want)


def test_combiner_floors_keep_a_dead_channel_finite():
    """g = Σ|h|² is floored at 1e-12 in both combiners, as in the JAX ones."""
    y = np.ones((2, 4, 8), np.complex64)
    h = np.zeros((2, 2, 1), np.complex64)
    s, eff = mo.alamouti_combine(_t(y), _t(h), 0.1)
    js, jeff = jmo.alamouti_combine(jnp.asarray(y), jnp.asarray(h), 0.1)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _close(eff.numpy() / 1e12, np.asarray(jeff) / 1e12)
    s, eff = mo.mrc_combine(_t(y), _t(h[:, :1]), 0.1)
    assert bool(torch.isfinite(s).all()) and float(eff.max()) == pytest.approx(0.1 / 1e-12)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_inv_hermitian_matches_jax(rng, k):
    a = _cn(rng, (5, 7, k, k))
    m = (np.conj(np.swapaxes(a, -1, -2)) @ a + 0.1 * np.eye(k)).astype(np.complex64)
    kappa = float(np.linalg.cond(m).max())
    _close_kappa(mo._inv_hermitian(_t(m)).numpy(), jmo._inv_hermitian(jnp.asarray(m)), kappa)


@pytest.mark.parametrize("n_prime", [1, 16], ids=["flat", "per_tone"])
@pytest.mark.parametrize("zf", [False, True], ids=["mmse", "zf"])
@pytest.mark.parametrize("n_tx,n_rx", [(2, 2), (2, 3), (3, 4), (4, 4)])
def test_linear_detectors_match_jax(rng, n_tx, n_rx, zf, n_prime):
    y = _cn(rng, (3, n_rx, 4, 16))
    h = _cn(rng, (3, n_rx, n_tx, n_prime))
    nv = 0.1
    det, jdet = (mo.mux_detect_zf, jmo.mux_detect_zf) if zf else (
        mo.mux_detect_mmse, jmo.mux_detect_mmse)
    kappa = _kappa(h, nv, zf)
    for got, want in zip(det(_t(y), _t(h), nv), jdet(jnp.asarray(y), jnp.asarray(h), nv)):
        assert tuple(got.shape) == want.shape
        _close_kappa(got.numpy(), want, kappa)


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16])
@pytest.mark.parametrize("n_tx,n_rx,n_prime", [(2, 2, 16), (2, 4, 1), (3, 4, 16)])
def test_sic_matches_jax(rng, n_tx, n_rx, n_prime, mod):
    """The same ordering and slices (hard symbols of the estimates, which
    each round's cancellation feeds on), the estimates within the κ-bound."""
    y = _cn(rng, (3, n_rx, 4, 16))
    h = _cn(rng, (3, n_rx, n_tx, n_prime))
    s, eff = mo.mux_detect_sic(_t(y), _t(h), 0.1, mod)
    js, jeff = jmo.mux_detect_sic(jnp.asarray(y), jnp.asarray(h), 0.1, JMOD[mod])
    kappa = _kappa(h, 0.1, False)
    _close_kappa(s.numpy(), js, kappa)
    _close_kappa(eff.numpy(), jeff, kappa)
    np.testing.assert_array_equal(nearest_symbol(s, mod).numpy(),
                                  nearest_symbol(_t(np.asarray(js)), mod).numpy())


def test_sic_argmax_takes_the_first_of_equal_sinrs():
    """Two streams of equal post-SINR (orthogonal columns of equal norm):
    both packages detect stream 0 first, so its estimate is the round-1
    one and stream 1's is cancelled — equal outputs on the tie."""
    h = np.zeros((1, 2, 2, 1), np.complex64)
    h[0, 0, 0, 0] = h[0, 1, 1, 0] = 1.0
    y = np.asarray([[[[0.3 + 0.2j]], [[-0.1 + 0.4j]]]], np.complex64)
    s, eff = mo.mux_detect_sic(_t(y), _t(h), 0.05, Modulation.QPSK)
    js, jeff = jmo.mux_detect_sic(jnp.asarray(y), jnp.asarray(h), 0.05, jcfg.Modulation.QPSK)
    _close(s.numpy(), js)
    _close(eff.numpy(), jeff)


def test_ml_tables_match_jax():
    for mod, n_tx in ((Modulation.BPSK, 4), (Modulation.QPSK, 2), (Modulation.QAM16, 3),
                      (Modulation.QAM64, 2)):
        got, want = mo._ml_tables(mod, n_tx), jmo._ml_tables(JMOD[mod], n_tx)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert mo.ML_MAX_CANDIDATES == jmo.ML_MAX_CANDIDATES
    with pytest.raises(ValueError, match="budget"):
        mo._ml_tables(Modulation.QAM256, 2)


@pytest.mark.parametrize("mod,n_tx,n_rx,n_prime", [
    (Modulation.QPSK, 2, 2, 16), (Modulation.QAM16, 2, 2, 1), (Modulation.QAM16, 2, 3, 16),
    (Modulation.QAM64, 2, 2, 1), (Modulation.QPSK, 3, 4, 16), (Modulation.BPSK, 4, 4, 1),
], ids=["qpsk_2x2", "qam16_2x2_flat", "qam16_2x3", "qam64_2x2_flat", "qpsk_3x4", "bpsk_4x4"])
def test_ml_matches_jax(rng, mod, n_tx, n_rx, n_prime):
    """The running per-point minima give the JAX function's LLRs (abs 1e-5
    of the peak) and its hard bits exactly."""
    y = _cn(rng, (2, n_rx, 4, 16))
    h = _cn(rng, (2, n_rx, n_tx, n_prime))
    got = mo.mux_detect_ml(_t(y), _t(h), 0.05, mod).numpy()
    want = np.asarray(jmo.mux_detect_ml(jnp.asarray(y), jnp.asarray(h), 0.05, JMOD[mod]))
    assert got.shape == want.shape == (2, n_tx, 4, 16 * mod.bits_per_symbol)
    _assert_llrs_close(got, want, sure_at=0.0)


# ---- the noiseless and brute-force identities of tests/test_mimo.py ----------------------

@pytest.mark.parametrize("n_rx", [1, 2, 4])
def test_alamouti_noiseless_exact(rng, n_rx):
    """tests/test_mimo.py:50-70: encode → flat channel → combine recovers x."""
    x, H = _cn(rng, (8, 16)), _cn(rng, (n_rx, 2))
    y = torch.einsum("rt,tsn->rsn", _t(H), mo.alamouti_encode(_t(x)))
    s, eff = mo.alamouti_combine(y, _t(H[..., None]), 1e-3)
    np.testing.assert_allclose(s.numpy(), x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(eff.reshape(-1)[0]), 2e-3 / float(np.sum(np.abs(H) ** 2)),
                               rtol=1e-5)


def test_alamouti_energy_preserved(rng):
    x = _cn(rng, (16, 32))
    ant = mo.alamouti_encode(_t(x)).numpy()
    np.testing.assert_allclose(np.sum(np.mean(np.abs(ant) ** 2, axis=(1, 2))),
                               np.mean(np.abs(x) ** 2), rtol=1e-5)


@pytest.mark.parametrize("n_rx", [2, 4])
def test_mrc_noiseless_exact(rng, n_rx):
    x, h = _cn(rng, (4, 8)), _cn(rng, (n_rx, 1))
    s, eff = mo.mrc_combine(_t(h[:, :, None] * x[None]), _t(h[..., None]), 0.5)
    np.testing.assert_allclose(s.numpy(), x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(eff.reshape(-1)[0]), 0.5 / float(np.sum(np.abs(h) ** 2)),
                               rtol=1e-5)


@pytest.mark.parametrize("zf", [True, False], ids=["zf", "mmse"])
@pytest.mark.parametrize("n_tx,n_rx", [(2, 2), (2, 4), (3, 4)])
def test_mux_noiseless_exact(rng, n_tx, n_rx, zf):
    x, H = _cn(rng, (n_tx, 4, 8)), _cn(rng, (n_rx, n_tx))
    y = torch.einsum("rt,tsn->rsn", _t(H), mo.mux_encode(_t(x)))
    det = mo.mux_detect_zf if zf else mo.mux_detect_mmse
    s, _ = det(y, _t(H[..., None]), 1e-9)
    np.testing.assert_allclose(s.numpy(), x, rtol=2e-4, atol=2e-4)


def test_mux_detect_per_subcarrier_channel(rng):
    x, H = _cn(rng, (2, 4, 8)), _cn(rng, (2, 2, 8))
    y = torch.einsum("rtn,tsn->rsn", _t(H), mo.mux_encode(_t(x)))
    s, _ = mo.mux_detect_zf(y, _t(H), 1e-9)
    np.testing.assert_allclose(s.numpy(), x, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16])
def test_ml_matches_bruteforce(mod):
    """tests/test_mimo.py:255-301: hard bits from the max-log LLRs equal
    exhaustive joint ML (numpy double loop), seed 7."""
    rng = np.random.default_rng(7)
    n_tx = n_rx = 2
    S, N = 3, 4
    bps = mod.bits_per_symbol
    M = 1 << bps
    const = constellation(mod).numpy()
    H = (rng.normal(size=(n_rx, n_tx, N)) + 1j * rng.normal(size=(n_rx, n_tx, N))) / np.sqrt(2)
    x = const[rng.integers(0, M, size=(n_tx, S, N))] / np.sqrt(n_tx)
    noise = (rng.normal(size=(n_rx, S, N)) + 1j * rng.normal(size=(n_rx, S, N))) * 0.15
    y = np.einsum("rtn,tsn->rsn", H, x) + noise
    got = (mo.mux_detect_ml(_t(y.astype(np.complex64)), _t(H.astype(np.complex64)), 0.045,
                            mod) < 0).to(torch.int8).numpy()
    want = np.zeros_like(got)
    for s in range(S):
        for n in range(N):
            best, bm = None, np.inf
            for i0 in range(M):
                for i1 in range(M):
                    cand = np.array([const[i0], const[i1]]) / np.sqrt(n_tx)
                    m = np.sum(np.abs(y[:, s, n] - H[:, :, n] @ cand) ** 2)
                    if m < bm:
                        bm, best = m, (i0, i1)
            for t in range(n_tx):
                want[t, s, n * bps:(n + 1) * bps] = [(best[t] >> (bps - 1 - j)) & 1
                                                     for j in range(bps)]
    np.testing.assert_array_equal(got, want)


def test_sic_noiseless_exact():
    """tests/test_mimo.py:336-356: with nv → 0 every slice is right."""
    rng = np.random.default_rng(21)
    n_tx, n_rx, S, N = 3, 4, 4, 8
    mod = Modulation.QAM16
    x = modulate(_t(rng.integers(0, 2, size=(n_tx, S, N * 4)).astype(np.int8)), mod)
    H = ((rng.normal(size=(n_rx, n_tx, N)) + 1j * rng.normal(size=(n_rx, n_tx, N)))
         / np.sqrt(2)).astype(np.complex64)
    y = torch.einsum("rtn,tsn->rsn", _t(H), x * n_tx ** -0.5)
    s, eff = mo.mux_detect_sic(y, _t(H), 1e-9, mod)
    np.testing.assert_allclose(s.numpy(), x.numpy(), rtol=2e-3, atol=2e-3)
    assert float(eff.max()) < 1e-6


# ---- link/ber.py's diversity curves ----------------------------------------------------

@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
                                 Modulation.QAM64])
def test_diversity_theory_matches_jax(mod):
    for e in (0.0, 5.0, 12.0, 20.0):
        for n in (1, 2, 4):
            assert abs(ber.ber_mrc_exact(mod, e, n) - jber.ber_mrc_exact(JMOD[mod], e, n)) <= 1e-12
            assert abs(ber.ber_alamouti_exact(mod, e, n)
                       - jber.ber_alamouti_exact(JMOD[mod], e, n)) <= 1e-12


def test_diversity_theory_reduces_and_orders():
    """tests/test_mimo.py:129-146 on the port's curves."""
    for mod in (Modulation.QPSK, Modulation.QAM16):
        for e in (0.0, 5.0, 10.0, 15.0):
            np.testing.assert_allclose(ber.ber_mrc_exact(mod, e, 1),
                                       ber.ber_rayleigh_exact(mod, e), rtol=1e-6)
    q = Modulation.QPSK
    siso, a21 = ber.ber_rayleigh_exact(q, 12.0), ber.ber_alamouti_exact(q, 12.0, 1)
    a22, mrc2 = ber.ber_alamouti_exact(q, 12.0, 2), ber.ber_mrc_exact(q, 12.0, 2)
    assert siso > a21 > a22 and a21 > mrc2 > a22
    assert ber.count_bit_errors(np.array([0, 1, 1, 0]), torch.tensor([0, 0, 1, 1])) == 2


# ---- the index-domain Alamouti layout ----------------------------------------------------

@pytest.mark.parametrize("mod", MODS, ids=[m.value for m in MODS])
def test_axis_msb_flip_is_conj_and_negated_conj(mod):
    """Flipping an axis MSB negates that axis of the square Gray point
    (level 2·gray_to_binary(g) − (L−1)): modulate(i ^ Q) = conj(x) and
    modulate(i ^ I) = −conj(x), exactly, for every index."""
    const = constellation(mod)
    idx = torch.arange(const.shape[0])
    f_i, f_q = pipeline._conj_flips(mod)
    assert torch.equal(const[idx ^ f_q], torch.conj(const[idx]).resolve_conj())
    assert torch.equal(const[idx ^ f_i], -torch.conj(const[idx]).resolve_conj())


@pytest.mark.parametrize("mod", MODS, ids=[m.value for m in MODS])
def test_alamouti_idx_is_the_layout(rng, mod):
    idx = _t(rng.integers(0, 1 << mod.bits_per_symbol, (3, 6, 8)).astype(np.int16))
    const = constellation(mod)
    got = const[pipeline.alamouti_idx(idx, mod).long()].reshape(3, 2, 6, 8)
    assert torch.equal(got, mo.alamouti_layout(const[idx.long()]).resolve_conj())


# ---- the link's halves against a JAX chain of the JAX ops --------------------------------

N, CP, S = 64, 16, 4
PDP3 = (1.0, 0.5, 0.25)


def _cfgs(mimo, model=jcfg.ChannelModel.RAYLEIGH_FLAT, mod=jcfg.Modulation.QAM16,
          ebno_db=10.0, n_channels=3, equalizer=jcfg.Equalizer.MMSE,
          estimator=jcfg.ChannelEstimator.LS, dft_spread=False, n_symbols=S, **channel):
    if model == jcfg.ChannelModel.MULTIPATH:
        channel.setdefault("pdp", PDP3)
    if model == jcfg.ChannelModel.RICIAN:
        channel.setdefault("k_factor", 4.0)
    ref = jcfg.LinkConfig(modulation=mod, ofdm=jcfg.OFDMConfig(N, CP),
                          channel=jcfg.ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=equalizer, estimator=estimator, n_symbols=n_symbols,
                          n_channels=n_channels, dft_spread=dft_spread,
                          mimo=jcfg.MIMOConfig(*mimo[:3], **mimo[3] if len(mimo) > 3 else {}))
    return ref, interop.link_config_from_reference(ref)


_A, _M, _X = jcfg.MIMOScheme.ALAMOUTI, jcfg.MIMOScheme.MRC, jcfg.MIMOScheme.SPATIAL_MUX
_MP, _RIC = jcfg.ChannelModel.MULTIPATH, jcfg.ChannelModel.RICIAN
_PRE = dict(csi="preamble")
_DFT = jcfg.ChannelEstimator.DFT
LINKS = {
    "alamouti_2x1": dict(mimo=(_A, 2, 1)),
    "alamouti_2x2": dict(mimo=(_A, 2, 2)),
    "mrc_1x2": dict(mimo=(_M, 1, 2)),
    "mrc_1x4_qpsk": dict(mimo=(_M, 1, 4), mod=jcfg.Modulation.QPSK),
    "mux_2x2_mmse": dict(mimo=(_X, 2, 2)),
    "mux_2x2_zf": dict(mimo=(_X, 2, 2), equalizer=jcfg.Equalizer.ZF),
    "mux_2x4_mmse": dict(mimo=(_X, 2, 4)),
    "mux_2x2_sic": dict(mimo=(_X, 2, 2, dict(detector="sic"))),
    "mux_3x4_sic_qpsk": dict(mimo=(_X, 3, 4, dict(detector="sic")), mod=jcfg.Modulation.QPSK),
    "mux_2x2_ml": dict(mimo=(_X, 2, 2, dict(detector="ml"))),
    "bpsk_mux_4x4_ml": dict(mimo=(_X, 4, 4, dict(detector="ml")), mod=jcfg.Modulation.BPSK),
    "rician_alamouti_2x2": dict(mimo=(_A, 2, 2), model=_RIC),
    "rician_mux_2x2_mmse": dict(mimo=(_X, 2, 2), model=_RIC),
    "multipath_alamouti_2x2": dict(mimo=(_A, 2, 2), model=_MP),
    "multipath_mrc_1x3": dict(mimo=(_M, 1, 3), model=_MP),
    "multipath_mux_2x3_ml": dict(mimo=(_X, 2, 3, dict(detector="ml")), model=_MP),
    "preamble_ls_alamouti_2x2": dict(mimo=(_A, 2, 2, _PRE)),
    "preamble_dft_alamouti_2x2_mp": dict(mimo=(_A, 2, 2, _PRE), model=_MP, estimator=_DFT),
    "preamble_ls_mrc_1x2": dict(mimo=(_M, 1, 2, _PRE)),
    "preamble_dft_mux_2x2_ml_mp": dict(mimo=(_X, 2, 2, dict(csi="preamble", detector="ml")),
                                       model=_MP, estimator=_DFT),
    "preamble_ls_mux_2x2_zf": dict(mimo=(_X, 2, 2, _PRE), equalizer=jcfg.Equalizer.ZF),
    "scfdma_alamouti_2x2": dict(mimo=(_A, 2, 2), dft_spread=True),
    "scfdma_mrc_1x2_pre": dict(mimo=(_M, 1, 2, _PRE), dft_spread=True),
    "scfdma_mux_2x2_mmse_mp": dict(mimo=(_X, 2, 2), model=_MP, dft_spread=True),
    "scfdma_mux_2x2_zf_pre": dict(mimo=(_X, 2, 2, _PRE), dft_spread=True,
                                  equalizer=jcfg.Equalizer.ZF),
    "pa_alamouti_2x2": dict(mimo=(_A, 2, 2, _PRE), pa_ibo_db=8.0),
    "pa_dpd_mux_2x2_sic": dict(mimo=(_X, 2, 2, dict(csi="preamble", detector="sic")),
                               pa_ibo_db=4.0, pa_dpd=True),
    "pa_mrc_1x2_mp": dict(mimo=(_M, 1, 2, _PRE), model=_MP, pa_ibo_db=6.0, estimator=_DFT),
    "pa_scfdma_alamouti_2x2": dict(mimo=(_A, 2, 2, _PRE), dft_spread=True, pa_ibo_db=3.0),
}


def _inputs(cfg, rng):
    """Injected bits (B, n_streams, S, N·bps), fading (gains or taps) and
    N(0, 1) noise planes (B, n_rx·S', L)."""
    mc = cfg.mimo
    B, bps = cfg.n_channels, cfg.modulation.bits_per_symbol
    bits = rng.integers(0, 2, (B, mc.n_streams, cfg.n_symbols, N * bps)).astype(np.int8)
    n_f = len(cfg.channel.pdp) if cfg.channel.model.name == "MULTIPATH" else 1
    fade = _cn(rng, (B, mc.n_rx, mc.n_tx, n_f))
    if n_f > 1:
        fade = fade * np.sqrt(np.asarray(cfg.channel.pdp, np.float32) / sum(cfg.channel.pdp))
        fade = fade.astype(np.complex64)
    sp = pipeline.n_preamble(cfg) + cfg.n_symbols
    noise = tuple(rng.standard_normal((B, mc.n_rx * sp, N + CP)).astype(np.float32)
                  for _ in range(2))
    return bits, fade, noise


def _jax_tx_channel(ref, bits, fade, noise):
    """pipeline.py:620-760 (frame-static, no midamble, aligned) over the
    batch, with the fading and the noise injected: rx (B, n_rx, S', L)."""
    mc = ref.mimo
    n_tx, n_rx = mc.n_tx, mc.n_rx
    B = bits.shape[0]
    points = jmodulate(jnp.asarray(bits), ref.modulation)  # (B, streams, S, N)
    if ref.dft_spread:
        points = (jnp.fft.fft(points, axis=-1) * jnp.float32(N ** -0.5)).astype(jnp.complex64)
    if mc.scheme == _A:
        ant = jmo.alamouti_encode(points[:, 0])
    elif mc.scheme == _M:
        ant = points
    else:
        ant = jmo.mux_encode(points)
    ant_pwr = 1.0 / n_tx if mc.scheme != _M else 1.0
    pre_ref = _jax_pre_ref(ref)
    if mc.csi == "preamble":
        pre = jnp.eye(n_tx, dtype=ant.dtype)[:, :, None] * pre_ref
        ant = jnp.concatenate([jnp.broadcast_to(pre, (B, n_tx, n_tx, N)), ant], axis=-2)
    sp = ant.shape[-2]
    tx_flat = jofdm_tx(ant, CP).reshape(B, n_tx, -1)
    if ref.channel.has_pa:
        tx_flat = jpa.apply_pa(tx_flat, ref.channel.pa_ibo_db, ant_pwr / N,
                               ref.channel.pa_smoothness, ref.channel.pa_dpd)
    nv = jchan.ebno_db_to_noise_var(ref.channel.ebno_db, ref.modulation.bits_per_symbol
                                    * mc.n_streams)
    f = jnp.asarray(fade)
    if ref.channel.model == _MP:
        rx_t = jnp.sum(jchan.apply_multipath(tx_flat[:, None], f), axis=2)
    else:
        rx_t = jnp.einsum("brt,btn->brn", f[..., 0], tx_flat)
    tvar = jchan.time_noise_var(nv, N)
    n = jnp.asarray(noise[0]) + 1j * jnp.asarray(noise[1])
    rx_t = rx_t + (n.reshape(B, n_rx, -1) * jnp.float32(2 ** -0.5)
                   * jnp.sqrt(jnp.asarray(tvar, jnp.float32)))
    return np.asarray(rx_t.reshape(B, n_rx, sp, N + CP)), nv


def _jax_pre_ref(ref):
    mc = ref.mimo
    ant_pwr = 1.0 / mc.n_tx if mc.scheme != _M else 1.0
    if ref.dft_spread:
        scale = ant_pwr ** 0.5 if ref.channel.has_pa else 1.0
        return jnp.asarray(jpil.zadoff_chu(N) * scale, jnp.complex64)
    if ref.channel.has_pa:
        return jnp.asarray(jpil.pn_preamble_grid(N) * ant_pwr ** 0.5, jnp.complex64)
    return jnp.asarray(jpil.PILOT_VALUE, jnp.complex64)


def _jax_rx(ref, rx, h, nv):
    """pipeline.py:907-1031 (no midamble) over the batch: LLRs (B,
    n_streams, S, N·bps), and the detector's (s, eff) when it has them."""
    mc = ref.mimo
    y = jofdm_rx(jnp.asarray(rx), CP)
    if mc.csi == "preamble":
        n_taps = min(CP + 1, N) if ref.estimator == _DFT else 0
        y_pre = y[:, :, :mc.n_tx] * (jnp.asarray(jpil.PILOT_VALUE, y.dtype) / _jax_pre_ref(ref))
        h = jpil.estimate_mimo_preamble(y_pre, n_taps)
        y = y[:, :, mc.n_tx:]
    h = jnp.asarray(h)
    nvf = jnp.maximum(jnp.asarray(nv, jnp.float32), 1e-12)
    if mc.scheme == _A:
        s, eff = jmo.alamouti_combine(y, h, nvf)
    elif mc.scheme == _M:
        s, eff = jmo.mrc_combine(y, h, nvf)
    elif mc.detector == "ml":
        return np.asarray(jmo.mux_detect_ml(y, h, nvf, ref.modulation)), None
    elif mc.detector == "sic":
        s, eff = jmo.mux_detect_sic(y, h, nvf, ref.modulation)
    elif ref.equalizer == jcfg.Equalizer.ZF:
        s, eff = jmo.mux_detect_zf(y, h, nvf)
    else:
        s, eff = jmo.mux_detect_mmse(y, h, nvf)
    if mc.scheme in (_A, _M):
        s, eff = s[:, None], eff[:, None]
    return np.asarray(jpipe._mimo_llrs(ref, s, eff)), (np.asarray(s), np.asarray(eff))


def _genie(ref, fade):
    if ref.channel.model == _MP:
        return np.asarray(jchan.freq_response(jnp.asarray(fade), N))
    return fade


@functools.lru_cache(maxsize=None)
def _link_case(name):
    """(ref, cfg, inputs, JAX rx, nv, JAX genie h) of one of ``LINKS``."""
    ref, cfg = _cfgs(**LINKS[name])
    inputs = _inputs(cfg, np.random.default_rng(sorted(LINKS).index(name)))
    rx, nv = _jax_tx_channel(ref, *inputs)
    return ref, cfg, inputs, rx, nv, _genie(ref, inputs[1])


def _idx_of(cfg, bits):
    bps = cfg.modulation.bits_per_symbol
    from sdr_tpu_torch.ops.modulation import _bits_to_ints
    return _bits_to_ints(_t(bits), bps).reshape(bits.shape[0], -1, N)


@pytest.mark.parametrize("name", sorted(LINKS))
def test_tx_and_channel_match_jax(name):
    """``mimo_tx`` then ``mimo_channel`` (the split in E's gains or taps, the
    PA at 1/N before it) against the JAX chain's received planes, abs 1e-5 /
    rel 1e-6; the genie response exactly the drawn gains or their
    ``freq_response`` (abs 1e-5 / rel 1e-6)."""
    ref, cfg, (bits, fade, noise), rx_j, _, h_j = _link_case(name)
    ids = torch.arange(cfg.n_channels, dtype=torch.int32)
    tx = pipeline.mimo_tx(cfg, _idx_of(cfg, bits))
    rx, h = pipeline.mimo_channel(cfg, SEED, ids, tx, fading=_t(fade),
                                  noise=tuple(map(_t, noise)))
    assert tuple(rx[0].shape) == rx_j.shape
    _close(torch.complex(*rx).numpy(), rx_j)
    _close(h.numpy(), h_j)


@pytest.mark.parametrize("name", sorted(LINKS))
def test_receive_matches_jax(name):
    """``mimo_rx`` on the JAX chain's received planes against the JAX
    receive: the LLR planes (module docstring's bounds; the whitened tail
    on kernel C's plain version), hard bits equal but where |LLR| is small."""
    ref, cfg, _, rx_j, nv, h_j = _link_case(name)
    want, soft = _jax_rx(ref, rx_j, h_j, nv)
    got = pipeline.mimo_rx(cfg, tuple(map(_t, (rx_j.real, rx_j.imag))), _t(h_j),
                           float(nv)).numpy()
    mc = cfg.mimo
    extra, sure = 0.0, 1e-3
    if soft is not None and mc.scheme.value == "mux":
        # The κ-bound of the linear solve, through the LLR's slope.
        s, eff = soft
        kappa = _kappa(h_j if mc.csi == "genie" else _preamble_h(ref, rx_j), float(nv),
                       cfg.equalizer.value == "zf" and mc.detector == "linear")
        levels = float(np.abs(constellation(cfg.modulation).numpy().real).max())
        extra = 64 * kappa * U * float(np.abs(s).max()) * 4 * levels / float(eff.min())
        sure = max(sure, 4 * extra)
    _assert_llrs_close(got, want, extra, sure)


def _preamble_h(ref, rx):
    y = jofdm_rx(jnp.asarray(rx), CP)
    n_taps = min(CP + 1, N) if ref.estimator == _DFT else 0
    y_pre = y[:, :, :ref.mimo.n_tx] * (jnp.asarray(jpil.PILOT_VALUE, y.dtype) / _jax_pre_ref(ref))
    return np.asarray(jpil.estimate_mimo_preamble(y_pre, n_taps))


def test_mimo_llr_link_is_the_three_stages():
    """``mimo_llr_link`` of bits = ``mimo_rx(mimo_channel(mimo_tx(·)))``,
    and the keyed link's LLRs are ``mimo_llr_link`` of A's bits."""
    _, cfg, (bits, fade, noise), *_ = _link_case("preamble_ls_alamouti_2x2")
    ids = torch.arange(cfg.n_channels, dtype=torch.int32)
    kw = dict(fading=_t(fade), noise=tuple(map(_t, noise)))
    rx, h = pipeline.mimo_channel(cfg, SEED, ids, pipeline.mimo_tx(cfg, _idx_of(cfg, bits)), **kw)
    want = pipeline.mimo_rx(cfg, rx, h, pipeline.mimo_noise_var(cfg))
    assert torch.equal(pipeline.mimo_llr_link(cfg, SEED, ids, _t(bits), **kw), want)
    res = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
    idx = pipeline.draw_mimo_idx(cfg, SEED, ids)
    a_bits = pipeline._ints_to_bits(idx, cfg.modulation.bits_per_symbol).reshape(bits.shape)
    assert torch.equal(res.llrs, pipeline.mimo_llr_link(cfg, SEED, ids, a_bits))


# ---- the keyed link ----------------------------------------------------------------------

def _keyed(name, n_channels=6, **kw):
    ref, _ = _cfgs(**{**LINKS[name], "n_channels": n_channels, **kw})
    return interop.link_config_from_reference(ref)


def test_mimo_draws_are_keyed_pairs():
    """The pair fading is ``ROLE_FADING`` at (channel, pair r·n_tx + t):
    pair 0 is the SISO draw of the same channel; the payload is A's grid
    over n_streams·S rows."""
    cfg = _keyed("mux_2x2_mmse")
    ids = torch.arange(4, dtype=torch.int32)
    g = pipeline.mimo_fading(cfg, SEED, ids)
    assert tuple(g.shape) == (4, 2, 2, 1)
    assert torch.equal(g[:, 0, 0, 0], fast.fading_params(
        dataclasses.replace(cfg, mimo=None), SEED, ids)[0][:, 0, 0])
    mp = _keyed("multipath_mux_2x3_ml")
    taps = pipeline.mimo_fading(mp, SEED, ids)
    assert tuple(taps.shape) == (4, 3, 2, 3)
    siso = dataclasses.replace(mp, mimo=None)
    assert torch.equal(taps[:, 0, 0], fast.fading_params(siso, SEED, ids)[1])
    idx = pipeline.draw_mimo_idx(cfg, SEED, ids)
    assert tuple(idx.shape) == (4, 2 * cfg.n_symbols, N)
    assert torch.equal(idx[:, cfg.n_symbols:], pipeline.payload_idx(
        cfg.n_symbols, N, 4, SEED, ids, cfg.n_symbols))


@pytest.mark.parametrize("name", ["alamouti_2x2", "mux_2x2_ml", "preamble_dft_mux_2x2_ml_mp",
                                  "scfdma_mux_2x2_zf_pre", "pa_alamouti_2x2"])
def test_keyed_link_split_passes_and_llrs(name, monkeypatch):
    """Channels [0, 2) alone count what they count in the full run; passes
    of ``CHUNK`` channels (2 here) equal one pass; ``want_llrs`` gives
    (B, n_streams, S, N·bps) whose hard bits the count counts."""
    cfg = _keyed(name)
    full = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
    B, mc = cfg.n_channels, cfg.mimo
    assert tuple(full.llrs.shape) == (B, mc.n_streams, S, N * cfg.modulation.bits_per_symbol)
    assert int(full.bits_counted[0]) == mc.n_streams * S * N * cfg.modulation.bits_per_symbol
    part, _, _ = pipeline.simulate_core(cfg, SEED, torch.arange(2, dtype=torch.int32))
    assert torch.equal(part, full.bit_errors[:2])
    idx = pipeline.draw_mimo_idx(cfg, SEED, torch.arange(B, dtype=torch.int32))
    bits = pipeline._ints_to_bits(idx, cfg.modulation.bits_per_symbol).reshape(full.llrs.shape)
    assert torch.equal(full.bit_errors, ((full.llrs < 0).to(torch.int8) != bits).sum(
        dim=(1, 2, 3), dtype=torch.int32))
    monkeypatch.setattr(pipeline, "CHUNK", 2)
    assert torch.equal(pipeline.simulate(cfg, SEED, device="cpu").bit_errors, full.bit_errors)
    assert torch.equal(pipeline.make_simulate_fn(cfg, device="cpu")(SEED).bit_errors,
                       full.bit_errors)
    assert torch.equal(make_sharded_simulate_fn(cfg, make_link_mesh(), device="cpu")(SEED)[0],
                       full.bit_errors)


# ---- what ran as item 11e-ii, and what the port refuses -----------------------------------

@pytest.mark.parametrize("kw,what", [
    (dict(model=jcfg.ChannelModel.RAYLEIGH_TIME, doppler_norm=0.02), "rayleigh_time"),
    (dict(model=jcfg.ChannelModel.MULTIPATH_TIME, doppler_norm=0.02, pdp=PDP3),
     "multipath_time"),
    (dict(model=jcfg.ChannelModel.RAYLEIGH_TIME, doppler_norm=0.02,
          mimo=(_M, 1, 2, dict(csi="preamble", midamble_period=2))), "midamble"),
    (dict(phase_noise_std=0.01, mimo=(_M, 1, 2, dict(csi="preamble", midamble_period=2))),
     "LO phase noise"),
    (dict(iq_gain=1.1, mimo=(_M, 1, 2, _PRE)), "I/Q imbalance"),
    (dict(cfo_subcarriers=1.3, timing_offset=37,
          mimo=(_M, 1, 2, dict(csi="preamble", midamble_period=2))), "acquisition"),
], ids=["rayleigh_time", "multipath_time", "midamble", "phase_noise", "iq", "acquisition"])
def test_item_11e_ii_raises(kw, what):
    """The MIMO configs item 11e-ii ported run in ``simulate``,
    ``make_simulate_fn`` and the sharded function with sane counts (every
    bit counted, BER below 0.2 at 10 dB on MRC 1 × 2, the sharded counts
    equal to ``simulate``'s); the blocked stream still refuses them, naming
    the pipeline. (The name is kept from when the pipeline raised for
    them.)"""
    kw = dict(kw)
    ref, cfg = _cfgs(**{"mimo": (_M, 1, 2), **kw})
    res = pipeline.simulate(cfg, 0, device="cpu")
    assert bool((res.bits_counted == S * N * cfg.modulation.bits_per_symbol).all()), what
    assert 0.0 <= float(res.ber.mean()) < 0.2, (what, res.ber)
    assert torch.equal(pipeline.make_simulate_fn(cfg, device="cpu")(0).bit_errors,
                       res.bit_errors)
    assert torch.equal(make_sharded_simulate_fn(cfg, make_link_mesh(), device="cpu")(0)[0],
                       res.bit_errors)
    with pytest.raises(NotImplementedError, match=r"link\.pipeline\.simulate"):
        stream.stream_simulate(cfg, 0, 2, device="cpu")


def test_siso_engines_refuse_mimo_naming_the_pipeline():
    """As the JAX engines (fast.py:550-554, stream.py:46-50,
    shard.py:88-92): the fast engine, the stream and the sharded fast path
    are SISO; the Monte-Carlo kernel does not take MIMO."""
    from sdr_tpu_torch.kernels.mc import supported

    cfg = _keyed("mrc_1x2")
    with pytest.raises(NotImplementedError, match=r"MIMO links run in link\.pipeline\.simulate"):
        fast.fast_simulate(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=r"MIMO links run in link\.pipeline\.simulate"):
        stream.stream_simulate(cfg, 0, 2, device="cpu")
    with pytest.raises(NotImplementedError, match=r"make_sharded_simulate_fn \(link\.pipeline\)"):
        make_sharded_fast_fn(cfg, make_link_mesh(), device="cpu")
    assert not supported(cfg)
