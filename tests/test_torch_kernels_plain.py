"""Each CUDA kernel's plain torch version against the JAX kernel it ports.

The JAX kernels run as the JAX suite runs them on a CPU: Pallas in
interpret mode with injected noise, or through their jnp twin where the
kernel has no interpret lowering (the channels-last kernel). Inputs are
made with numpy from a seed and handed to both.

Tolerances (stated before the comparison, from the JAX suite):
- sample planes atol = 2e-5 (tests/test_tx_pallas.py), for kernel B's
  gain and FIR modes against the JAX staged composition (TX kernel →
  apply_multipath → channel kernel) and for kernel E; kernel E's FIR mode
  against the JAX staged channel (apply_multipath → channel kernel) at
  the reference's float tolerance, atol = 1e-5, rtol = 1e-6;
- error counts: equal, or differing by no more than the number of bits
  whose plain |LLR| < 1e-3 (decisions that float rounding may flip);
- LLR sums rtol = 1e-4 (float32 sums over ~1e4 terms in another order);
- the SC-FDE equalizer's symbols atol = 1e-5, rtol = 1e-6 (float32
  transforms of unit-power symbols in another order);
- LLR planes atol = 1e-5, rtol = 1e-6 of the plane divided by its peak
  |LLR| (BASELINE.md:13-16's float tolerance, on the scale of the plane:
  an LLR is a sample error scaled by up to 4|h|²/nv, so raw LLRs of
  magnitude ~500 carry the transforms' float32 error times that scale;
  the JAX suite compares its planes the same way, at 2e-5,
  tests/test_demod_cl.py:105-107), with the JAX kernels' DFT matmuls at
  full float32 (SDR_TPU_MXU_PRECISION=highest); LLR-plane sums rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core.config import Modulation as JMod
from sdr_tpu.kernels.channel_pallas import fade_awgn_pallas
from sdr_tpu.kernels.demod_cl_pallas import demod_cl_jnp, dif_perm as j_dif_perm
from sdr_tpu.kernels.demod_pallas import demod_chain_pallas, demod_count_pallas
from sdr_tpu.kernels.tx_pallas import tx_chain_pallas
from sdr_tpu.ops import channel as jchan
from sdr_tpu.ops.equalize import equalize_mmse_fde as j_equalize_mmse_fde
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import channel as ke
from sdr_tpu_torch.kernels import demod as kc
from sdr_tpu_torch.kernels import demod_cl as kd
from sdr_tpu_torch.kernels import tx as kb
from sdr_tpu_torch.ops.equalize import equalize_mmse_fde

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


def _scfdma_rx(rng, mod, B, S, N, cp, ebno_db, h_syms=1):
    """A full-grid SC-FDMA waveform (the constellation sequence scaled by
    N^-1/2, with the CP) through a per-subcarrier channel and noise."""
    idx = _idx(rng, mod, (B, S, N))
    from sdr_tpu_torch.ops.modulation import constellation

    x = constellation(mod).numpy()[idx] / np.sqrt(N)
    h = (rng.standard_normal((B, h_syms, N)) + 1j * rng.standard_normal((B, h_syms, N))) / np.sqrt(2)
    y = np.fft.ifft(np.fft.fft(x, axis=-1) * h, axis=-1)
    y = np.concatenate([y[..., N - cp:], y], axis=-1)
    nv = 1.0 / (10 ** (ebno_db / 10) * mod.bits_per_symbol)
    y = y + np.sqrt(nv / N / 2) * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return (np.real(y).astype(np.float32), np.imag(y).astype(np.float32),
            np.real(h).astype(np.float32), np.imag(h).astype(np.float32), idx, nv)


@pytest.mark.parametrize("h_syms", [1, 4])
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64],
                         ids=lambda m: m.value)
def test_demod_count_despread_plain_matches_jax_count_kernel(rng, mod, h_syms):
    """Kernel C's despread mode, plain version, against the JAX count
    kernel with despread=True (interpret mode): the SC-FDE receive."""
    B, S, N, cp = 128, 4, 128, 32
    re, im, hr, hi, idx, nv = _scfdma_rx(rng, mod, B, S, N, cp, 8.0, h_syms)
    ref = demod_count_pallas(*map(jnp.asarray, (re, im, hr, hi, idx)), cp, _jmod(mod), nv,
                             interpret=True, despread=True)
    got = kc.demod_count(*_t(re, im, hr, hi, idx), cp, mod, nv, despread=True)
    assert got.dtype == torch.int32 and got.shape == (B,) and int(got.sum()) > 0
    _assert_counts_agree(got, ref, kc.demod_chain(*_t(re, im, hr, hi), cp, mod, nv,
                                                  despread=True))
    with pytest.raises(ValueError, match="despread"):
        kc.demod_count(*_t(re, im), None, None, *_t(idx), cp, mod, nv, despread=True,
                       taps=_t(hr[:, :, :3], hi[:, :, :3]))


@pytest.mark.parametrize("h_syms", [1, 8])
def test_equalize_mmse_fde_matches_jax(rng, h_syms):
    B, S, N = 3, 8, 64
    y = (rng.standard_normal((B, S, N)) + 1j * rng.standard_normal((B, S, N))).astype(np.complex64)
    h = ((rng.standard_normal((B, h_syms, N)) + 1j * rng.standard_normal((B, h_syms, N)))
         / np.sqrt(2)).astype(np.complex64)
    s_ref, eff_ref = j_equalize_mmse_fde(jnp.asarray(y), jnp.asarray(h), 0.05)
    s, eff = equalize_mmse_fde(torch.from_numpy(y), torch.from_numpy(h), 0.05)
    assert s.dtype == torch.complex64 and eff.shape == (B, S, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(eff.numpy(), np.asarray(eff_ref), atol=1e-5, rtol=1e-6)


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


def _tx_channel_state(rng, mod, B, S, N, cp):
    idx = _idx(rng, mod, (B, S, N))
    n_re = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    n_im = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    tvar = 1.0 / (10 ** 0.6 * mod.bits_per_symbol) / N
    return idx, n_re, n_im, tvar


@pytest.mark.parametrize("kind", ["static", "per_symbol"])
@pytest.mark.parametrize("L", [1, 4, 16])
def test_tx_plain_fir_matches_jax_staged_composition(rng, kind, L):
    """Kernel B's FIR mode (plain version, injected noise) against the JAX
    staged route: tx_chain_pallas → apply_multipath (over the stream for
    static taps; per symbol with symbol_history otherwise) →
    fade_awgn_pallas(noise=…)."""
    mod = Modulation.QAM16
    B, S, N, cp = 128, 8, 128, 32
    idx, n_re, n_im, tvar = _tx_channel_state(rng, mod, B, S, N, cp)
    shape = (B, L) if kind == "static" else (B, S, L)
    taps = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.4).astype(
        np.complex64)

    jre, jim = tx_chain_pallas(jnp.asarray(idx), cp, _jmod(mod), interpret=True)
    x = jre + 1j * jim
    if kind == "static":
        x = jchan.apply_multipath(x.reshape(B, -1), jnp.asarray(taps)).reshape(x.shape)
    else:
        x = jchan.apply_multipath(x, jnp.asarray(taps), history=jchan.symbol_history(x, L))
    jre, jim = fade_awgn_pallas(jnp.real(x), jnp.imag(x), None, None, 0, tvar,
                                noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True)
    tr, ti = _t(np.real(taps).astype(np.float32), np.imag(taps).astype(np.float32))
    gre, gim = kb.tx_channel_plain(*_t(idx), cp, mod, noise_var=tvar, noise=_t(n_re, n_im),
                                   taps_r=tr, taps_i=ti)
    np.testing.assert_allclose(gre.numpy(), np.asarray(jre), atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(gim.numpy(), np.asarray(jim), atol=SAMPLE_ATOL, rtol=0)


def test_tx_plain_per_symbol_gains_match_jax_staged_composition(rng):
    """Kernel B's per-symbol gains (B, S) against tx_chain_pallas →
    fade_awgn_pallas with a (B, S) gain plane."""
    mod = Modulation.QPSK
    B, S, N, cp = 128, 8, 128, 16
    idx, n_re, n_im, tvar = _tx_channel_state(rng, mod, B, S, N, cp)
    hs = ((rng.standard_normal((B, S)) + 1j * rng.standard_normal((B, S))) / np.sqrt(2)).astype(
        np.complex64)
    hr, hi = np.real(hs).astype(np.float32), np.imag(hs).astype(np.float32)
    jre, jim = tx_chain_pallas(jnp.asarray(idx), cp, _jmod(mod), interpret=True)
    jre, jim = fade_awgn_pallas(jre, jim, jnp.asarray(hr), jnp.asarray(hi), 0, tvar,
                                noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True)
    gre, gim = kb.tx_channel_plain(*_t(idx), cp, mod, *_t(hr, hi), tvar, noise=_t(n_re, n_im))
    np.testing.assert_allclose(gre.numpy(), np.asarray(jre), atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(gim.numpy(), np.asarray(jim), atol=SAMPLE_ATOL, rtol=0)


def test_tx_plain_fir_keyed_noise_is_the_flat_stream():
    """The FIR mode adds the same keyed noise as the other modes: with a
    single unit tap it is the AWGN-only waveform, bit for bit."""
    B, S, N, cp = 6, 4, 64, 16
    idx = torch.randint(0, 16, (B, S, N), generator=torch.Generator().manual_seed(3),
                        dtype=torch.int32)
    ids = torch.arange(50, 50 + B, dtype=torch.int32)
    one = (torch.ones((B, 1)), torch.zeros((B, 1)))
    a = kb.tx_channel(idx, cp, Modulation.QAM16, noise_var=0.01, seed=4, ch_ids=ids,
                      taps_r=one[0], taps_i=one[1])
    b = kb.tx_channel(idx, cp, Modulation.QAM16, noise_var=0.01, seed=4, ch_ids=ids)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("h_syms", [0, 1, 8], ids=["noise_only", "per_link", "per_symbol"])
def test_fade_awgn_plain_matches_jax_channel_kernel(rng, h_syms):
    B, S, L = 128, 8, 96
    re = rng.standard_normal((B, S, L)).astype(np.float32)
    im = rng.standard_normal((B, S, L)).astype(np.float32)
    n_re = rng.standard_normal((B, S, L)).astype(np.float32)
    n_im = rng.standard_normal((B, S, L)).astype(np.float32)
    hr = hi = None
    if h_syms:
        hr = rng.standard_normal((B, h_syms)).astype(np.float32)
        hi = rng.standard_normal((B, h_syms)).astype(np.float32)
    jre, jim = fade_awgn_pallas(
        jnp.asarray(re), jnp.asarray(im), None if hr is None else jnp.asarray(hr),
        None if hi is None else jnp.asarray(hi), 0, 0.02,
        noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True)
    gains = (None, None) if hr is None else _t(hr, hi)
    gre, gim = ke.fade_awgn(*_t(re, im), *gains, 0.02, noise=_t(n_re, n_im))
    np.testing.assert_allclose(gre.numpy(), np.asarray(jre), atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(gim.numpy(), np.asarray(jim), atol=SAMPLE_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["static", "per_symbol"])
@pytest.mark.parametrize("n_taps", [17, 33], ids=["17taps", "cp+1taps"])
def test_fade_awgn_plain_fir_matches_jax_staged_channel(rng, kind, n_taps):
    """Kernel E's FIR mode (plain version, injected noise) against the JAX
    staged channel: apply_multipath (over the stream for static taps; per
    symbol with symbol_history otherwise) → fade_awgn_pallas(noise=…) in
    interpret mode; B = 128 for the channel kernel's 128-row blocks. The
    reference's float tolerance, abs 1e-5 / rel 1e-6."""
    B, S, N, cp = 128, 3, 128, 32
    L = N + cp
    x = ((rng.standard_normal((B, S, L)) + 1j * rng.standard_normal((B, S, L)))
         / np.sqrt(2)).astype(np.complex64)
    shape = (B, n_taps) if kind == "static" else (B, S, n_taps)
    taps = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2 * n_taps)).astype(np.complex64)
    n_re = rng.standard_normal((B, S, L)).astype(np.float32)
    n_im = rng.standard_normal((B, S, L)).astype(np.float32)
    tvar = 0.02
    jx = jnp.asarray(x)
    if kind == "static":
        y = jchan.apply_multipath(jx.reshape(B, -1), jnp.asarray(taps)).reshape(jx.shape)
    else:
        y = jchan.apply_multipath(jx, jnp.asarray(taps), history=jchan.symbol_history(jx, n_taps))
    jre, jim = fade_awgn_pallas(jnp.real(y), jnp.imag(y), None, None, 0, tvar,
                                noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True)
    re, im = _t(np.real(x).astype(np.float32), np.imag(x).astype(np.float32))
    tr, ti = _t(np.real(taps).astype(np.float32), np.imag(taps).astype(np.float32))
    gre, gim = ke.fade_awgn_plain(re, im, noise_var=tvar, noise=_t(n_re, n_im), taps_r=tr,
                                  taps_i=ti)
    assert gre.shape == (B, S, L) and gre.dtype == torch.float32
    np.testing.assert_allclose(gre.numpy(), np.asarray(jre), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(gim.numpy(), np.asarray(jim), atol=1e-5, rtol=1e-6)


def test_fade_awgn_plain_keyed_noise_is_kernel_b_stream():
    """Kernel E's keyed noise is kernel B's: the staged channel over the
    clean waveform equals the fused one, bit for bit, on the CPU."""
    B, S, N, cp = 5, 4, 64, 16
    idx = torch.randint(0, 4, (B, S, N), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32)
    ids = torch.arange(7, 7 + B, dtype=torch.int32)
    hs = (torch.randn(B, S), torch.randn(B, S))
    fused = kb.tx_channel(idx, cp, Modulation.QPSK, *hs, 0.03, seed=11, ch_ids=ids)
    staged = ke.fade_awgn(*kb.tx_chain(idx, cp, Modulation.QPSK), *hs, 0.03, seed=11,
                          ch_ids=ids)
    for x, y in zip(fused, staged):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("s0", [1, 5])
@pytest.mark.parametrize("N", [6, 64])
def test_payload_plain_s0_is_the_frame_rows(N, s0):
    """Kernel A with a symbol offset: rows s0 … s0+S−1 of the whole
    frame's draw, bit for bit (a time block's payload)."""
    from sdr_tpu_torch.kernels.payload import payload_idx, payload_idx_plain

    ids = torch.tensor([3, 0, 2**31 - 1], dtype=torch.int32)
    full = payload_idx_plain(8, N, 4, 77, ids)
    got = payload_idx_plain(3, N, 4, 77, ids, s0=s0)
    torch.testing.assert_close(got, full[:, s0:s0 + 3], rtol=0, atol=0)
    torch.testing.assert_close(payload_idx(3, N, 4, 77, ids, s0=s0), got, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["static", "per_symbol"])
@pytest.mark.parametrize("n_taps", [2, 4, 17], ids=lambda n: f"{n}taps")
def test_fade_awgn_plain_history_matches_jax_halo(rng, kind, n_taps):
    """Kernel E's FIR with history planes (plain version, injected noise)
    against the JAX stream's block channel (link/stream.py:_block_rx):
    ``apply_multipath(stream, taps, history=halo)`` for static taps,
    ``apply_multipath`` per symbol with ``symbol_history`` whose row 0 is
    the halo for per-symbol taps; then the noise. abs 1e-5 / rel 1e-6."""
    B, S, L = 4, 3, 80
    x = ((rng.standard_normal((B, S, L)) + 1j * rng.standard_normal((B, S, L)))
         / np.sqrt(2)).astype(np.complex64)
    shape = (B, n_taps) if kind == "static" else (B, S, n_taps)
    taps = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2 * n_taps)).astype(np.complex64)
    halo = ((rng.standard_normal((B, n_taps - 1)) + 1j * rng.standard_normal((B, n_taps - 1)))
            / np.sqrt(2)).astype(np.complex64)
    n_re = rng.standard_normal((B, S, L)).astype(np.float32)
    n_im = rng.standard_normal((B, S, L)).astype(np.float32)
    tvar = 0.02
    jx, jt, jh = jnp.asarray(x), jnp.asarray(taps), jnp.asarray(halo)
    if kind == "static":
        y = jchan.apply_multipath(jx.reshape(B, -1), jt, history=jh).reshape(jx.shape)
    else:
        hist = jchan.symbol_history(jx, n_taps).at[:, 0].set(jh)
        y = jchan.apply_multipath(jx, jt, history=hist)
    y = np.asarray(y) + np.sqrt(tvar / 2) * (n_re + 1j * n_im)
    parts = lambda z: _t(np.real(z).astype(np.float32), np.imag(z).astype(np.float32))  # noqa: E731
    hr, hi = parts(halo)
    gre, gim = ke.fade_awgn_plain(*parts(x), noise_var=tvar, noise=_t(n_re, n_im),
                                  taps_r=parts(taps)[0], taps_i=parts(taps)[1], history_r=hr,
                                  history_i=hi)
    np.testing.assert_allclose(gre.numpy(), np.real(y), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(gim.numpy(), np.imag(y), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("kind", ["static", "per_symbol", "gains", "noise_only"])
def test_fade_awgn_plain_keyed_s0_is_the_frame_rows(kind):
    """Keyed E at s0 over rows [s0, S) of a frame, with the frame's tail
    before s0 as history, equals those rows of the whole frame's channel:
    the noise counter is (channel, s0 + s, u). Bit for bit, but for static
    taps, whose plain FIR runs over each channel's flat row: a shorter row
    puts a sample's complex products in other vector lanes of torch's CPU
    loop, so those rows agree to abs 1e-6 / rel 1e-6 (the kernel, which
    sums in one order, is held bit for bit on the card)."""
    B, S, L, s0, Lt = 3, 6, 21, 4, 5
    g = torch.Generator().manual_seed(3)
    re, im = (torch.randn((B, S, L), generator=g) for _ in range(2))
    ids = torch.tensor([9, 1, 40], dtype=torch.int32)
    kw_full, kw_part = {}, {}
    if kind == "gains":
        hr, hi = (torch.randn((B, S), generator=g) for _ in range(2))
        kw_full, kw_part = dict(hr_s=hr, hi_s=hi), dict(hr_s=hr[:, s0:].contiguous(),
                                                        hi_s=hi[:, s0:].contiguous())
    elif kind != "noise_only":
        shape = (B, Lt) if kind == "static" else (B, S, Lt)
        tr, ti = (torch.randn(shape, generator=g) for _ in range(2))
        kw_full = dict(taps_r=tr, taps_i=ti)
        kw_part = dict(taps_r=tr, taps_i=ti) if kind == "static" else dict(
            taps_r=tr[:, s0:].contiguous(), taps_i=ti[:, s0:].contiguous())
        kw_part.update(history_r=re[:, s0 - 1, -(Lt - 1):].contiguous(),
                       history_i=im[:, s0 - 1, -(Lt - 1):].contiguous())
    full = ke.fade_awgn(re, im, noise_var=0.1, seed=12, ch_ids=ids, **kw_full)
    part = ke.fade_awgn(re[:, s0:].contiguous(), im[:, s0:].contiguous(), noise_var=0.1,
                        seed=12, ch_ids=ids, s0=s0, **kw_part)
    tol = 1e-6 if kind == "static" else 0.0
    for a, b in zip(part, full):
        torch.testing.assert_close(a, b[:, s0:], rtol=tol, atol=tol)


def test_fade_awgn_history_is_checked():
    re = torch.zeros((2, 3, 8))
    taps = torch.ones((2, 4))
    with pytest.raises(ValueError, match="history planes go with the FIR"):
        ke.fade_awgn(re, re, history_r=torch.zeros(2, 3), history_i=torch.zeros(2, 3))
    with pytest.raises(ValueError, match=r"history planes must both be \(2, 3\)"):
        ke.fade_awgn(re, re, taps_r=taps, taps_i=taps, history_r=torch.zeros(2, 2),
                     history_i=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="s0 must be >= 0"):
        ke.fade_awgn(re, re, taps_r=taps, taps_i=taps, s0=-1)


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("mod", [Modulation.QAM16, Modulation.QAM256], ids=lambda m: m.value)
def test_demod_count_plain_taps_matches_jax_count_kernel(rng, mod, L):
    """Kernel C's taps= mode (per-symbol TDL taps, response built in the
    kernel) against demod_count_pallas(taps=…) in interpret mode."""
    B, S, N, cp = 4, 8, 128, 32
    idx = _idx(rng, mod, (B, S, N))
    re, im = kb.tx_chain(*_t(idx), cp, mod)
    taps = ((rng.standard_normal((B, S, L)) + 1j * rng.standard_normal((B, S, L)))
            / np.sqrt(2 * L)).astype(np.complex64)
    x = re.numpy() + 1j * im.numpy()
    y = np.asarray(jchan.apply_multipath(jnp.asarray(x), jnp.asarray(taps),
                                         history=jchan.symbol_history(jnp.asarray(x), L)))
    nv = 1.0 / (10 ** 1.0 * mod.bits_per_symbol)
    y = y + np.sqrt(nv / N / 2) * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    yr, yi = np.real(y).astype(np.float32), np.imag(y).astype(np.float32)
    tr, ti = np.real(taps).astype(np.float32), np.imag(taps).astype(np.float32)
    ref = demod_count_pallas(jnp.asarray(yr), jnp.asarray(yi), None, None, jnp.asarray(idx), cp,
                             _jmod(mod), nv, taps=(jnp.asarray(tr), jnp.asarray(ti)),
                             interpret=True)
    got = kc.demod_count(*_t(yr, yi), None, None, *_t(idx), cp, mod, nv, taps=_t(tr, ti))
    assert got.dtype == torch.int32 and got.shape == (B,) and int(got.sum()) > 0
    hr, hi = kc.taps_plane(_t(tr, ti), N)
    _assert_counts_agree(got, ref, kc.demod_chain(*_t(yr, yi), hr, hi, cp, mod, nv))


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
def test_demod_count_cl_plain_matches_jax_cl_twin(rng, mod):
    """Kernel F's plain version against demod_cl_jnp(out_mode="count")."""
    B, S, N, cp = 32, 4, 128, 32
    rows = lambda x: x.reshape(S, N + cp, B).transpose(2, 0, 1)  # noqa: E731
    idx = _idx(rng, mod, (B, S, N))
    re, im = kb.tx_chain(*_t(idx), cp, mod)
    nv = 1.0 / (10 ** 0.8 * mod.bits_per_symbol)
    h = (rng.standard_normal((N, B)) + 1j * rng.standard_normal((N, B))) / np.sqrt(2)
    hr, hi = np.real(h).astype(np.float32), np.imag(h).astype(np.float32)
    # Channels-last samples: y = ifft(h · fft(x)) per symbol, plus noise.
    x = (re.numpy() + 1j * im.numpy())[..., cp:]
    y = np.fft.ifft(np.fft.fft(x, axis=-1) * h.T[:, None, :], axis=-1)
    y = np.concatenate([y[..., N - cp:], y], axis=-1)
    y = y + np.sqrt(nv / N / 2) * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    cl = lambda a: np.ascontiguousarray(a.transpose(1, 2, 0).reshape(S * (N + cp), B))  # noqa: E731
    yr, yi = cl(np.real(y)).astype(np.float32), cl(np.imag(y)).astype(np.float32)
    idx_t = np.ascontiguousarray(idx.transpose(1, 2, 0).reshape(S * N, B))
    ref = demod_cl_jnp(*map(jnp.asarray, (yr, yi, hr, hi)), cp, _jmod(mod), nv,
                       out_mode="count", idx_t=jnp.asarray(idx_t))
    narrow = idx_t.astype(np.int8 if mod.bits_per_symbol <= 7 else np.int16)
    got = kd.demod_count_cl(*_t(yr, yi, hr, hi, narrow), cp, mod, nv)
    assert got.dtype == torch.int32 and got.shape == (B,) and int(got.sum()) > 0
    llr = kc.demod_chain(*_t(rows(yr), rows(yi)), *_t(hr.T[:, None, :], hi.T[:, None, :]), cp,
                         mod, nv)
    _assert_counts_agree(got, ref, llr)
    # The plain count equals the rows count of the transposed grid.
    rows_cnt = kc.count_errors(llr, torch.from_numpy(idx), mod.bits_per_symbol)
    torch.testing.assert_close(got, rows_cnt, rtol=0, atol=0)
    # h pre-permuted into the JAX kernel's DIF order gives the same counts.
    perm = j_dif_perm(N)
    got_dif = kd.demod_count_cl(*_t(yr, yi, hr[perm], hi[perm], narrow), cp, mod, nv,
                                h_in_dif_order=True)
    torch.testing.assert_close(got_dif, got, rtol=0, atol=0)


def _assert_planes_close(got, ref):
    """LLR planes within atol 1e-5 / rtol 1e-6 on the scale of the peak."""
    peak = float(np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(got, np.float32) / peak, np.asarray(ref) / peak,
                               atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("h_syms,despread", [(1, False), (8, False), (1, True), (8, True)],
                         ids=["per_link", "per_symbol", "despread", "despread_per_symbol"])
@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QAM16, Modulation.QAM256],
                         ids=lambda m: m.value)
def test_demod_llr_plain_matches_jax_chain_kernel(rng, monkeypatch, mod, h_syms, despread):
    """Kernel C's LLR-plane and sum modes (plain version) against
    demod_chain_pallas in interpret mode: per-link and per-symbol h, and
    the despread (SC-FDE) variant."""
    monkeypatch.setenv("SDR_TPU_MXU_PRECISION", "highest")
    B, S, N, cp = 4, 8, 128, 32
    re, im, hr, hi = (
        (rng.standard_normal((B, S, N + cp)) / np.sqrt(2 * N)).astype(np.float32),
        (rng.standard_normal((B, S, N + cp)) / np.sqrt(2 * N)).astype(np.float32),
        (rng.standard_normal((B, h_syms, N)) * np.sqrt(0.5)).astype(np.float32),
        (rng.standard_normal((B, h_syms, N)) * np.sqrt(0.5)).astype(np.float32),
    )
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    args = tuple(map(jnp.asarray, (re, im, hr, hi)))
    ref = demod_chain_pallas(*args, cp, _jmod(mod), nv, interpret=True, despread=despread)
    got = kc.demod_llr(*_t(re, im, hr, hi), cp, mod, nv, despread=despread)
    assert got.shape == (B, S, N * mod.bits_per_symbol) and got.dtype == torch.float32
    _assert_planes_close(got.numpy(), ref)
    ref_sum = demod_chain_pallas(*args, cp, _jmod(mod), nv, reduce_sum=True, interpret=True,
                                 despread=despread)
    got_sum = kc.demod_llr(*_t(re, im, hr, hi), cp, mod, nv, reduce_sum=True, despread=despread)
    assert got_sum.ndim == 0
    np.testing.assert_allclose(float(got_sum), float(ref_sum), rtol=1e-5)


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64],
                         ids=lambda m: m.value)
def test_demod_llr_cl_plain_matches_jax_cl_twin(rng, monkeypatch, mod):
    """Kernel F's LLR mode (plain version) against demod_cl_jnp
    (out_mode="llr") in the public form; the port's kernel-order plane,
    mapped through its documented order (row (s·bps + j)·N + k), equals
    its public form exactly; bf16 output is sign-identical to f32
    wherever |LLR| ≥ 1e-3."""
    from sdr_tpu_torch.ops.demod import demod_llr_chain_cl

    monkeypatch.setenv("SDR_TPU_MXU_PRECISION", "highest")
    B, S, N, cp = 16, 3, 128, 32
    re, im, hr, hi = _cl_inputs(rng, B, S, N, cp)
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    bps = mod.bits_per_symbol
    ref = demod_cl_jnp(*map(jnp.asarray, (re, im, hr, hi)), cp, _jmod(mod), nv, out_mode="llr")
    pub = demod_llr_chain_cl(*_t(re, im, hr, hi), cp, mod, nv)
    assert pub.shape == (B, S, N * bps)
    _assert_planes_close(pub.numpy(), ref)
    kern = demod_llr_chain_cl(*_t(re, im, hr, hi), cp, mod, nv, kernel_order=True)
    assert kern.shape == (S * bps * N, B)
    k4 = kern.reshape(S, bps, N, B)
    for s, j, k, b in ((0, 0, 0, 0), (2, bps - 1, N - 1, B - 1), (1, 1, 37, 5)):
        assert float(k4[s, j, k, b]) == float(pub[b, s, k * bps + j])
    torch.testing.assert_close(kd.kernel_to_public(kern, S, bps, N), pub, rtol=0, atol=0)
    half = demod_llr_chain_cl(*_t(re, im, hr, hi), cp, mod, nv, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    big = pub.abs() >= 1e-3
    assert torch.equal((half.float() < 0)[big], (pub < 0)[big])
    # The rows plane of the transposed grid is the same plane (torch's
    # FFT batches it another way: equal to float rounding).
    rows = lambda x: x.reshape(S, N + cp, B).transpose(2, 0, 1)  # noqa: E731
    plane = kc.demod_chain(*_t(rows(re), rows(im)), *_t(hr.T[:, None, :], hi.T[:, None, :]), cp,
                           mod, nv)
    _assert_planes_close(pub.numpy(), plane.numpy())


@pytest.mark.parametrize("out_mode", ["sum", "count", "llr"])
def test_cl_plain_on_bf16_samples_matches_jax_cl_twin(rng, monkeypatch, out_mode):
    """Kernels D and F on bfloat16 sample planes (the JAX bench's input):
    the plain versions cast to float32 first and match demod_cl_jnp fed
    the same bf16 planes. At N = 128 the JAX twin's transform takes the
    bf16 samples exactly (no DIF level, a HIGHEST matmul); from N = 256 on
    it rounds the transform's intermediate to bf16 (its leaf downcast),
    which the port does not copy: it computes in float32 throughout."""
    monkeypatch.setenv("SDR_TPU_MXU_PRECISION", "highest")
    mod, B, S, n_fft, cp = Modulation.QAM16, 16, 3, 128, 32
    re, im, hr, hi = _cl_inputs(rng, B, S, n_fft, cp)
    rb, ib = (torch.from_numpy(a).to(torch.bfloat16) for a in (re, im))
    jb = tuple(jnp.asarray(a, jnp.bfloat16) for a in (re, im))
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    hrt, hit = _t(hr, hi)
    if out_mode == "sum":
        ref = float(demod_cl_jnp(*jb, *map(jnp.asarray, (hr, hi)), cp, _jmod(mod), nv,
                                 out_mode="sum"))
        got = kd.demod_sum_cl(rb, ib, hrt, hit, cp, mod, nv)
        np.testing.assert_allclose(float(got), ref, rtol=1e-4)
    elif out_mode == "count":
        idx_t = _idx(rng, mod, (S * n_fft, B))
        ref = demod_cl_jnp(*jb, *map(jnp.asarray, (hr, hi)), cp, _jmod(mod), nv,
                           out_mode="count", idx_t=jnp.asarray(idx_t))
        got = kd.demod_count_cl(rb, ib, hrt, hit, torch.from_numpy(idx_t.astype(np.int8)), cp,
                                mod, nv)
        plane = kd.demod_llr_cl_plain(rb, ib, hrt, hit, cp, mod, nv)
        margin = (plane.abs() < 1e-3).sum(dim=0).numpy()
        assert int(got.sum()) > 0 and np.all(np.abs(got.numpy() - np.asarray(ref)) <= margin)
    else:
        ref = demod_cl_jnp(*jb, *map(jnp.asarray, (hr, hi)), cp, _jmod(mod), nv, out_mode="llr")
        got = kd.kernel_to_public(kd.demod_llr_cl(rb, ib, hrt, hit, cp, mod, nv), S,
                                  mod.bits_per_symbol, n_fft)
        _assert_planes_close(got.numpy(), ref)
    # The plain version is the float32 path on the widened samples.
    f32 = (rb.float(), ib.float(), hrt, hit)
    if out_mode == "sum":
        assert float(got) == float(kd.demod_sum_cl(*f32, cp, mod, nv))


def test_cl_sample_dtypes_are_checked(rng):
    re, im, hr, hi = _t(*_cl_inputs(rng, 8, 2, 64, 16))
    with pytest.raises(ValueError, match="must both be float32 or both bfloat16"):
        kd.demod_sum_cl(re, im.to(torch.bfloat16), hr, hi, 16, Modulation.QPSK, 0.1)
    with pytest.raises(ValueError, match="must both be float32 or both bfloat16"):
        kd.demod_llr_cl(re.half(), im.half(), hr, hi, 16, Modulation.QPSK, 0.1)
    with pytest.raises(ValueError, match="hr_t/hi_t must be float32"):
        kd.demod_count_cl(re, im, hr.to(torch.bfloat16), hi, torch.zeros((128, 8), dtype=torch.int8),
                          16, Modulation.QPSK, 0.1)


@pytest.mark.parametrize("n", [2, 256, 4096])
def test_twiddles_are_cached_per_size_and_device(n):
    """``_lib.twiddles`` builds each (n, device) table once: later calls
    return the same tensors, equal to e^{-2πik/n}, k < n/2, in float32."""
    from sdr_tpu_torch.kernels import _lib

    dev = torch.device("cpu")
    first, again = _lib.twiddles(n, dev), _lib.twiddles(n, dev)
    assert first[0] is again[0] and first[1] is again[1]
    fresh = _lib.twiddles.__wrapped__(n, dev)
    assert torch.equal(first[0], fresh[0]) and torch.equal(first[1], fresh[1])
    ang = -2.0 * np.pi * np.arange(max(n // 2, 1)) / n
    np.testing.assert_allclose(first[0].numpy(), np.cos(ang), atol=6e-8)
    np.testing.assert_allclose(first[1].numpy(), np.sin(ang), atol=6e-8)
