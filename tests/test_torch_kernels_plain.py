"""Each CUDA kernel's plain torch version against the JAX kernel it ports.

The JAX kernels run as the JAX suite runs them on a CPU: Pallas in
interpret mode with injected noise, or through their jnp twin where the
kernel has no interpret lowering (the channels-last kernel). Inputs are
made with numpy from a seed and handed to both.

Tolerances (stated before the comparison, from the JAX suite):
- sample planes atol = 2e-5 (tests/test_tx_pallas.py);
- error counts: equal, or differing by no more than the number of bits
  whose plain |LLR| < 1e-3 (decisions that float rounding may flip);
- LLR sums rtol = 1e-4 (float32 sums over ~1e4 terms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core.config import Modulation as JMod
from sdr_tpu.kernels.channel_pallas import fade_awgn_pallas
from sdr_tpu.kernels.demod_cl_pallas import demod_cl_jnp, dif_perm as j_dif_perm
from sdr_tpu.kernels.demod_pallas import demod_count_pallas
from sdr_tpu.kernels.tx_pallas import tx_chain_pallas
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import demod as kc
from sdr_tpu_torch.kernels import demod_cl as kd
from sdr_tpu_torch.kernels import tx as kb

torch.set_num_threads(1)

SAMPLE_ATOL = 2e-5


def _jmod(mod):
    return JMod(mod.value)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _idx(rng, mod, shape):
    return rng.integers(0, 1 << mod.bits_per_symbol, shape).astype(np.int32)


@pytest.mark.parametrize("fade", [True, False], ids=["rayleigh", "awgn"])
@pytest.mark.parametrize("mod", [Modulation.QAM16, Modulation.QPSK, Modulation.QAM64],
                         ids=lambda m: m.value)
def test_tx_plain_injected_matches_jax_tx_then_channel(rng, mod, fade):
    """Kernel B's plain version, injection mode, against the JAX
    composition tx_chain_pallas → fade_awgn_pallas(noise=...) (the
    staged route the fused TPU kernel replaced); B = 128 for the
    channel kernel's 128-row blocks."""
    B, S, N, cp = 128, 8, 128, 32
    idx = _idx(rng, mod, (B, S, N))
    hs = ((rng.standard_normal((B, 1)) + 1j * rng.standard_normal((B, 1))) / np.sqrt(2)).astype(
        np.complex64
    )
    n_re = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    n_im = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    tvar = 1.0 / (10 ** 0.6 * mod.bits_per_symbol) / N
    hr = np.real(hs).astype(np.float32) if fade else None
    hi = np.imag(hs).astype(np.float32) if fade else None

    jre, jim = tx_chain_pallas(jnp.asarray(idx), cp, _jmod(mod), interpret=True)
    jre, jim = fade_awgn_pallas(
        jre, jim, None if hr is None else jnp.asarray(hr), None if hi is None else jnp.asarray(hi),
        0, tvar, noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True,
    )
    gre, gim = kb.tx_channel_plain(
        *_t(idx), cp, mod,
        None if hr is None else torch.from_numpy(hr), None if hi is None else torch.from_numpy(hi),
        tvar, noise=_t(n_re, n_im),
    )
    assert gre.shape == (B, S, N + cp) and gre.dtype == torch.float32
    np.testing.assert_allclose(gre.numpy(), np.asarray(jre), atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(gim.numpy(), np.asarray(jim), atol=SAMPLE_ATOL, rtol=0)


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
def test_tx_plain_channel_off_matches_jax_tx_chain(rng, mod):
    B, S, N, cp = 4, 8, 128, 16
    idx = _idx(rng, mod, (B, S, N))
    jre, jim = tx_chain_pallas(jnp.asarray(idx), cp, _jmod(mod), interpret=True)
    for dt in (np.int32, np.int16) + ((np.int8,) if mod.bits_per_symbol <= 7 else ()):
        gre, gim = kb.tx_chain(*_t(idx.astype(dt)), cp, mod)
        np.testing.assert_allclose(gre.numpy(), np.asarray(jre), atol=SAMPLE_ATOL, rtol=0)
        np.testing.assert_allclose(gim.numpy(), np.asarray(jim), atol=SAMPLE_ATOL, rtol=0)


def test_tx_plain_keyed_noise_is_calibrated_and_per_channel():
    """Philox mode: σ = sqrt(tvar/2) per component over every sample,
    CP included, keyed by global channel id."""
    B, S, N, cp = 64, 8, 64, 16
    idx = torch.zeros((B, S, N), dtype=torch.int32)
    ids = torch.arange(100, 100 + B, dtype=torch.int32)
    tvar = 0.01
    clean = kb.tx_chain(idx, cp, Modulation.QPSK)
    re, im = kb.tx_channel(idx, cp, Modulation.QPSK, noise_var=tvar, seed=77, ch_ids=ids)
    nr, ni = re - clean[0], im - clean[1]
    for n in (nr, ni, nr[..., :cp]):
        assert abs(float(n.var()) - tvar / 2) < 0.05 * tvar / 2
    part = kb.tx_channel(idx[8:20], cp, Modulation.QPSK, noise_var=tvar, seed=77, ch_ids=ids[8:20])
    torch.testing.assert_close(part[0], re[8:20], rtol=0, atol=0)


def _noisy_rx(rng, mod, B, S, N, cp, ebno_db, h_syms=1):
    """A transmitted waveform through per-subcarrier fading and noise."""
    idx = _idx(rng, mod, (B, S, N))
    re, im = kb.tx_chain(*_t(idx), cp, mod)
    h = (rng.standard_normal((B, h_syms, N)) + 1j * rng.standard_normal((B, h_syms, N))) / np.sqrt(2)
    hfull = np.broadcast_to(h, (B, S, N))
    # Flat-per-symbol channel applied in frequency: y = ifft(h · fft(x)).
    x = re.numpy() + 1j * im.numpy()
    xf = np.fft.fft(x[..., cp:], axis=-1) * hfull
    y = np.fft.ifft(xf, axis=-1)
    y = np.concatenate([y[..., N - cp:], y], axis=-1)
    nv = 1.0 / (10 ** (ebno_db / 10) * mod.bits_per_symbol)
    y = y + np.sqrt(nv / N / 2) * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return (np.real(y).astype(np.float32), np.imag(y).astype(np.float32),
            np.real(h).astype(np.float32), np.imag(h).astype(np.float32), idx, nv)


def _assert_counts_agree(got, ref, llr):
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2)).numpy()
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert (diff <= margin).all(), (got, ref, margin)


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
def test_demod_count_plain_matches_jax_count_kernel(rng, mod):
    B, S, N, cp = 4, 8, 128, 32
    re, im, hr, hi, idx, nv = _noisy_rx(rng, mod, B, S, N, cp, ebno_db=4.0)
    ref = demod_count_pallas(*map(jnp.asarray, (re, im, hr, hi, idx)), cp, _jmod(mod), nv,
                             interpret=True)
    got = kc.demod_count(*_t(re, im, hr, hi, idx), cp, mod, nv)
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert int(got.sum()) > 0
    llr = kc.demod_chain(*_t(re, im, hr, hi), cp, mod, nv)
    _assert_counts_agree(got, ref, llr)
    # The narrow index planes count the same.
    for dt in (np.int16,) + ((np.int8,) if mod.bits_per_symbol <= 7 else ()):
        torch.testing.assert_close(kc.demod_count(*_t(re, im, hr, hi, idx.astype(dt)), cp, mod, nv),
                                   got, rtol=0, atol=0)


def test_demod_count_plain_per_symbol_channel_matches_jax(rng):
    mod = Modulation.QAM16
    B, S, N, cp = 4, 8, 128, 32
    re, im, hr, hi, idx, nv = _noisy_rx(rng, mod, B, S, N, cp, ebno_db=6.0, h_syms=S)
    ref = demod_count_pallas(*map(jnp.asarray, (re, im, hr, hi, idx)), cp, _jmod(mod), nv,
                             interpret=True)
    got = kc.demod_count(*_t(re, im, hr, hi, idx), cp, mod, nv)
    _assert_counts_agree(got, ref, kc.demod_chain(*_t(re, im, hr, hi), cp, mod, nv))


def _cl_inputs(rng, B, S, N, cp):
    """bench.py's synthetic channels-last inputs, drawn with numpy."""
    re = (rng.standard_normal((S * (N + cp), B)) / np.sqrt(2 * N)).astype(np.float32)
    im = (rng.standard_normal((S * (N + cp), B)) / np.sqrt(2 * N)).astype(np.float32)
    hr = (rng.standard_normal((N, B)) * np.sqrt(0.5)).astype(np.float32)
    hi = (rng.standard_normal((N, B)) * np.sqrt(0.5)).astype(np.float32)
    return re, im, hr, hi


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("n_fft", [128, 256])
def test_demod_sum_cl_plain_matches_jax_cl_twin(rng, mod, n_fft):
    B, S, cp = 32, 4, n_fft // 4
    re, im, hr, hi = _cl_inputs(rng, B, S, n_fft, cp)
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    ref = float(demod_cl_jnp(*map(jnp.asarray, (re, im, hr, hi)), cp, _jmod(mod), nv,
                             out_mode="sum"))
    got = kd.demod_sum_cl(*_t(re, im, hr, hi), cp, mod, nv)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), ref, rtol=1e-4)
    # h pre-permuted into the JAX kernel's DIF bin order, as bench.py passes it.
    perm = j_dif_perm(n_fft)
    np.testing.assert_array_equal(kd.dif_perm(n_fft), perm)
    got_dif = kd.demod_sum_cl(*_t(re, im, hr[perm], hi[perm]), cp, mod, nv, h_in_dif_order=True)
    assert float(got_dif) == float(got)


def test_demod_sum_cl_plain_equals_rows_plane_sum(rng):
    """The channels-last sum is the rows LLR plane of the transposed grid."""
    mod, B, S, N, cp = Modulation.QAM16, 8, 3, 64, 16
    re, im, hr, hi = _cl_inputs(rng, B, S, N, cp)
    nv = 0.02
    rows = lambda x: x.reshape(S, N + cp, B).transpose(2, 0, 1)  # noqa: E731
    plane = kc.demod_chain(*_t(rows(re), rows(im), hr.T[:, None, :], hi.T[:, None, :]), cp, mod, nv)
    got = kd.demod_sum_cl(*_t(re, im, hr, hi), cp, mod, nv)
    np.testing.assert_allclose(float(got), float(plane.double().sum()), rtol=1e-5)
