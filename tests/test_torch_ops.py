"""Port ops (sdr_tpu_torch.ops) against the JAX ops on the same numpy inputs.

Tolerances: time/frequency samples atol = rtol = 1e-5 (BASELINE.md's
reference bound); bits, indices and bytes exact; LLRs rtol = atol =
2e-3, the JAX suite's own bound for its fused demod
(tests/test_demod.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core.config import Modulation as JMod
from sdr_tpu.ops import channel as jchan
from sdr_tpu.ops import modulation as jmodu
from sdr_tpu.ops.demod import demod_chain_jnp
from sdr_tpu.ops.equalize import equalize_mmse as j_mmse, equalize_zf as j_zf
from sdr_tpu.ops.fft import fft as jfft, ifft as jifft
from sdr_tpu.ops.llr import llr_exact as j_llr_exact, llr_maxlog as j_llr
from sdr_tpu.ops.ofdm import ofdm_rx as j_ofdm_rx, ofdm_tx as j_ofdm_tx
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.ops import channel as tchan
from sdr_tpu_torch.ops import modulation as tmodu
from sdr_tpu_torch.ops.demod import demod_chain
from sdr_tpu_torch.ops.equalize import equalize_mmse, equalize_zf
from sdr_tpu_torch.ops.fft import fft, ifft
from sdr_tpu_torch.ops.llr import llr_exact, llr_maxlog, llr_to_hard_bits
from sdr_tpu_torch.ops.ofdm import ofdm_rx, ofdm_tx

torch.set_num_threads(1)

MODS = list(Modulation)
SAMPLE_TOL = dict(atol=1e-5, rtol=1e-5)
LLR_TOL = dict(atol=2e-3, rtol=2e-3)


def _jmod(mod):
    return JMod(mod.value)


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64
    )


@pytest.mark.parametrize("n", [2, 64, 256])
def test_fft_ifft_match_jax(rng, n):
    x = _cplx(rng, (3, 5, n))
    np.testing.assert_allclose(fft(torch.from_numpy(x)).numpy(),
                               np.asarray(jfft(jnp.asarray(x))), **SAMPLE_TOL)
    np.testing.assert_allclose(ifft(torch.from_numpy(x)).numpy(),
                               np.asarray(jifft(jnp.asarray(x))), **SAMPLE_TOL)


@pytest.mark.parametrize("n", [0, 3, 96])
def test_fft_rejects_non_power_of_two(n):
    with pytest.raises(ValueError, match="power of 2"):
        fft(torch.zeros((2, n), dtype=torch.complex64))
    with pytest.raises(ValueError, match="power of 2"):
        ifft(torch.zeros((2, n), dtype=torch.complex64))


@pytest.mark.parametrize("cp", [0, 16, 64])
def test_ofdm_tx_rx_match_jax(rng, cp):
    x = _cplx(rng, (2, 4, 64))
    got = ofdm_tx(torch.from_numpy(x), cp).numpy()
    ref = np.array(j_ofdm_tx(jnp.asarray(x), cp))
    np.testing.assert_allclose(got, ref, **SAMPLE_TOL)
    # CP contract: the last cp samples, placed first.
    if cp:
        np.testing.assert_array_equal(got[..., :cp], got[..., -cp:])
    np.testing.assert_allclose(ofdm_rx(torch.from_numpy(ref), cp).numpy(),
                               np.asarray(j_ofdm_rx(jnp.asarray(ref), cp)), **SAMPLE_TOL)


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_modulation_tables_match_jax(mod):
    np.testing.assert_array_equal(tmodu.constellation(mod).numpy(),
                                  np.asarray(jmodu.constellation(_jmod(mod))))
    np.testing.assert_array_equal(tmodu.pam_table(mod).numpy(),
                                  np.asarray(jmodu.pam_table(_jmod(mod))))


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_bits_ints_packing_match_jax(rng, mod):
    bps = mod.bits_per_symbol
    bits = rng.integers(0, 2, (3, 7 * bps)).astype(np.int8)
    ints = tmodu._bits_to_ints(torch.from_numpy(bits), bps)
    np.testing.assert_array_equal(ints.numpy(),
                                  np.asarray(jmodu._bits_to_ints(jnp.asarray(bits), bps)))
    np.testing.assert_array_equal(tmodu._ints_to_bits(ints, bps).numpy(), bits)


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_modulate_and_hard_demap_match_jax(rng, mod):
    bps = mod.bits_per_symbol
    bits = rng.integers(0, 2, (4, 32 * bps)).astype(np.int8)
    pts = tmodu.modulate(torch.from_numpy(bits), mod)
    np.testing.assert_array_equal(pts.numpy(),
                                  np.asarray(jmodu.modulate(jnp.asarray(bits), _jmod(mod))))
    noisy = pts.numpy() + _cplx(rng, pts.shape, 0.05)
    got = tmodu.nearest_symbol(torch.from_numpy(noisy), mod).numpy()
    ref = np.asarray(jmodu.nearest_symbol(jnp.asarray(noisy), _jmod(mod)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tmodu.demodulate_hard(pts, mod).numpy(), bits)


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_byte_api_round_trip_matches_jax(rng, mod):
    data = rng.integers(0, 256, (2, 15)).astype(np.uint8)  # 120 bits: every bps divides
    pts = tmodu.to_constl(torch.from_numpy(data), mod)
    np.testing.assert_array_equal(pts.numpy(),
                                  np.asarray(jmodu.to_constl(jnp.asarray(data), _jmod(mod))))
    back = tmodu.from_constl(pts, mod)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), data)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmodu.from_constl(jnp.asarray(pts.numpy()), _jmod(mod)))
    )


def test_equalizers_match_jax(rng):
    y = _cplx(rng, (3, 4, 16))
    h = _cplx(rng, (3, 1, 16))
    nv = 0.05
    for port, ref in ((equalize_zf, j_zf), (equalize_mmse, j_mmse)):
        s, eff = port(torch.from_numpy(y), torch.from_numpy(h), nv)
        rs, reff = ref(jnp.asarray(y), jnp.asarray(h), nv)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), **SAMPLE_TOL)
        np.testing.assert_allclose(eff.numpy(), np.asarray(reff), **SAMPLE_TOL)


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_llr_maxlog_matches_jax(rng, mod):
    pts = _cplx(rng, (3, 4, 32), 0.6)
    nv = (rng.uniform(0.01, 0.2, (3, 4, 32))).astype(np.float32)
    got = llr_maxlog(torch.from_numpy(pts), mod, torch.from_numpy(nv)).numpy()
    ref = np.asarray(j_llr(jnp.asarray(pts), _jmod(mod), jnp.asarray(nv)))
    assert got.shape == ref.shape == (3, 4, 32 * mod.bits_per_symbol)
    np.testing.assert_allclose(got, ref, **LLR_TOL)
    # Hard decisions from the LLRs are the hard demapper's bits.
    np.testing.assert_array_equal(
        llr_to_hard_bits(torch.from_numpy(got)).numpy(),
        tmodu.demodulate_hard(torch.from_numpy(pts), mod).numpy(),
    )


@pytest.mark.parametrize("nv", ["moderate", "near_zero"])
@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_llr_exact_matches_jax(rng, mod, nv):
    """The true-MAP LLRs against the JAX op, within BASELINE.md's float
    bound (abs 1e-5 / rel 1e-6), at per-point noise variances in
    [0.01, 0.2] and at a near-zero one (1e-6), where the log-sum-exp
    meets its max-log limit."""
    pts = _cplx(rng, (3, 4, 32), 0.6)
    if nv == "moderate":
        var = rng.uniform(0.01, 0.2, (3, 4, 32)).astype(np.float32)
    else:
        var = np.float32(1e-6)
    got = llr_exact(torch.from_numpy(pts), mod, torch.from_numpy(np.asarray(var))).numpy()
    ref = np.asarray(j_llr_exact(jnp.asarray(pts), _jmod(mod), jnp.asarray(var)))
    assert got.shape == ref.shape == (3, 4, 32 * mod.bits_per_symbol)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)
    if nv == "near_zero":
        # The max-log LLRs are its limit: the same hard decisions.
        ml = llr_maxlog(torch.from_numpy(pts), mod, torch.from_numpy(np.asarray(var)))
        np.testing.assert_array_equal(got < 0, ml.numpy() < 0)


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_demod_chain_matches_jax(rng, mod):
    """The plain LLR plane (kernel C's and D's plain versions) against
    the JAX jnp composition ofdm_rx → equalize_mmse → llr_maxlog."""
    B, S, N, cp = 3, 4, 64, 16
    re = (rng.standard_normal((B, S, N + cp)) * 0.1).astype(np.float32)
    im = (rng.standard_normal((B, S, N + cp)) * 0.1).astype(np.float32)
    hr = rng.standard_normal((B, 1, N)).astype(np.float32)
    hi = rng.standard_normal((B, 1, N)).astype(np.float32)
    nv = float(jchan.ebno_db_to_noise_var(10.0, mod.bits_per_symbol))
    got = demod_chain(*map(torch.from_numpy, (re, im, hr, hi)), cp, mod, nv).numpy()
    ref = np.asarray(demod_chain_jnp(*map(jnp.asarray, (re, im, hr, hi)), cp, _jmod(mod), nv))
    np.testing.assert_allclose(got, ref, **LLR_TOL)


@pytest.mark.parametrize("ebno_db", [-2.0, 6.0, 12.5])
@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.value)
def test_noise_calibration_matches_jax(mod, ebno_db):
    bps = mod.bits_per_symbol
    nv = tchan.ebno_db_to_noise_var(ebno_db, bps)
    assert nv.dtype == torch.float32
    np.testing.assert_allclose(float(nv), float(jchan.ebno_db_to_noise_var(ebno_db, bps)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tchan.time_noise_var(nv, 256)),
                               float(jchan.time_noise_var(float(nv), 256)), rtol=1e-6)


def test_keyed_awgn_is_per_channel_and_calibrated():
    """Noise is keyed by global channel id (a slice reproduces the full
    draw) and has the requested variance."""
    x = torch.zeros((64, 8, 80), dtype=torch.complex64)
    ids = torch.arange(64, dtype=torch.int32)
    y = tchan.awgn(x, 0.25, 99, ids)
    y_part = tchan.awgn(x[16:32], 0.25, 99, ids[16:32])
    torch.testing.assert_close(y[16:32], y_part, rtol=0, atol=0)
    var = float((y.abs() ** 2).mean())
    assert abs(var - 0.25) < 0.25 * 0.03
    assert abs(float(y.real.var()) - float(y.imag.var())) < 0.25 * 0.05


@pytest.mark.parametrize("k_factor", [0.0, 4.0, 10.0])
def test_flat_fading_unit_power_and_rician_limit(k_factor):
    ids = torch.arange(40000, dtype=torch.int32)
    h = tchan.rician_flat(5, ids, k_factor)
    assert h.shape == (40000, 1, 1) and h.dtype == torch.complex64
    assert abs(float((h.abs() ** 2).mean()) - 1.0) < 0.03
    # K-factor = LOS power / diffuse power: E|h|^4 = (2 + 4K + K^2)/(1+K)^2.
    m4 = float((h.abs() ** 4).mean())
    want = (2 + 4 * k_factor + k_factor ** 2) / (1 + k_factor) ** 2
    assert abs(m4 - want) < 0.06 * want
    r = tchan.rayleigh_flat(5, ids)
    assert abs(float((r.abs() ** 2).mean()) - 1.0) < 0.03
    assert abs(float((r.abs() ** 4).mean()) - 2.0) < 0.12
    assert not torch.equal(r, tchan.rayleigh_flat(6, ids))

