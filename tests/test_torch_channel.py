"""The port's channel ops (sdr_tpu_torch.ops.channel) against the JAX
package's, and the port's own keyed draws against their statistics.

The deterministic functions take the same numpy inputs in both packages
— Jakes state (θ, φ) and FIR taps carried across with
``interop.fading_state`` — and agree within the reference's float
tolerances, abs 1e-5 / rel 1e-6 (BASELINE.md). The keyed draws
(Philox, not JAX's threefry) are held to the JAX suite's statistical
tests: per-tap power (tests/test_channel_time.py:48) and the Jakes J0
autocorrelation (:59), at the same sizes and bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import channel as jchan
from sdr_tpu_torch import interop
from sdr_tpu_torch.ops import channel as chan

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-6
PDP = (1.0, 0.5, 0.25)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def _jakes_state(rng, shape):
    theta = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    return theta, phi


def _cplx(rng, shape, scale=1.0):
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
    return z.astype(np.complex64)


@pytest.mark.parametrize("fd", [0.0, 0.02, 0.3])
def test_jakes_eval_matches_jax(rng, fd):
    theta, phi = _jakes_state(rng, (4, 16))
    t = np.arange(64, dtype=np.float32)
    st = interop.fading_state(jakes=(theta, phi))
    got = chan.jakes_eval(*st["jakes"], torch.from_numpy(t), fd)
    want = jchan.jakes_eval(jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(t), fd)
    assert got.shape == (4, 64) and got.dtype == torch.complex64
    _close(got.numpy(), want)


def test_multipath_time_taps_at_matches_jax(rng):
    theta, phi = _jakes_state(rng, (4, 3, 16))
    amps = np.sqrt(np.asarray(PDP, np.float32) / np.float32(sum(PDP)))
    t = np.arange(5, 13, dtype=np.float32)  # an offset window of steps
    st = interop.fading_state(jakes=(theta, phi))
    got = chan.multipath_time_taps_at(*st["jakes"], torch.from_numpy(amps), torch.from_numpy(t),
                                      0.02)
    want = jchan.multipath_time_taps_at(jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(amps),
                                        jnp.asarray(t), 0.02)
    assert got.shape == (4, 8, 3)
    _close(got.numpy(), want)


@pytest.mark.parametrize("L", [1, 3, 8])
def test_apply_multipath_stream_matches_jax(rng, L):
    x = _cplx(rng, (4, 6 * 80))
    taps = _cplx(rng, (4, L), 0.5)
    st = interop.fading_state(taps=taps)
    got = chan.apply_multipath(torch.from_numpy(x), st["taps"])
    want = jchan.apply_multipath(jnp.asarray(x), jnp.asarray(taps))
    _close(got.numpy(), want)


@pytest.mark.parametrize("L", [1, 4, 16])
def test_apply_multipath_per_symbol_history_matches_jax(rng, L):
    x = _cplx(rng, (4, 6, 80))
    taps = _cplx(rng, (4, 6, L), 0.5)
    xt = torch.from_numpy(x)
    hist = chan.symbol_history(xt, L)
    jhist = jchan.symbol_history(jnp.asarray(x), L)
    if L == 1:
        assert hist is None and jhist is None
    else:
        _close(hist.numpy(), jhist)
    got = chan.apply_multipath(xt, interop.fading_state(taps=taps)["taps"], history=hist)
    want = jchan.apply_multipath(jnp.asarray(x), jnp.asarray(taps), history=jhist)
    _close(got.numpy(), want)


def test_zero_doppler_per_symbol_conv_equals_stream_conv(rng):
    """Constant taps through the per-symbol FIR with symbol_history are
    the serialised stream convolution (tests/test_channel_time.py:74)."""
    S, sym_len, L = 6, 80, 3
    x = torch.from_numpy(_cplx(rng, (S, sym_len)))
    taps1 = chan.multipath_taps(7, torch.tensor([0], dtype=torch.int32), PDP)[0]
    got = chan.apply_multipath(x, taps1.expand(S, L), history=chan.symbol_history(x, L))
    want = chan.apply_multipath(x.reshape(-1), taps1).reshape(S, sym_len)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L", [1, 5])
def test_grid_fir_is_the_engine_composition_of_jax_ops(rng, L):
    """Static taps: the stream convolution; per-symbol taps: the FIR with
    symbol_history — the two compositions of JAX fast.py:392-400."""
    x = _cplx(rng, (4, 6, 80))
    static, per_sym = _cplx(rng, (4, L), 0.5), _cplx(rng, (4, 6, L), 0.5)
    xt = torch.from_numpy(x)
    want_s = jchan.apply_multipath(jnp.asarray(x).reshape(4, -1), jnp.asarray(static))
    _close(chan.grid_fir(xt, torch.from_numpy(static)).numpy(),
           np.asarray(want_s).reshape(x.shape))
    jx = jnp.asarray(x)
    want_p = jchan.apply_multipath(jx, jnp.asarray(per_sym), history=jchan.symbol_history(jx, L))
    _close(chan.grid_fir(xt, torch.from_numpy(per_sym)).numpy(), want_p)


@pytest.mark.parametrize("shape", [(4, 3), (4, 6, 8)], ids=["static", "per_symbol"])
def test_freq_response_matches_jax(rng, shape):
    taps = _cplx(rng, shape, 0.5)
    got = chan.freq_response(interop.fading_state(taps=taps)["taps"], 64)
    want = jchan.freq_response(jnp.asarray(taps), 64)
    assert got.shape == shape[:-1] + (64,)
    _close(got.numpy(), want)


def test_keyed_jakes_gains_equal_eval_of_their_state():
    """jakes_gains = jakes_eval(jakes_params, arange): the split form a
    time-sharded run uses, and per-channel-id determinism."""
    ids = torch.arange(10, 26, dtype=torch.int32)
    g = chan.jakes_gains(5, ids, 32, 0.05)
    theta, phi = chan.jakes_params(5, ids)
    assert theta.shape == (16, 16) and float(theta.min()) > 0 and float(theta.max()) <= 2 * np.pi
    torch.testing.assert_close(g, chan.jakes_eval(theta, phi, torch.arange(32.0), 0.05),
                               rtol=0, atol=0)
    torch.testing.assert_close(chan.jakes_gains(5, ids[3:7], 32, 0.05), g[3:7], rtol=0, atol=0)
    late = chan.jakes_eval(theta, phi, torch.arange(20.0, 32.0), 0.05)
    torch.testing.assert_close(late, g[:, 20:], rtol=0, atol=0)


def test_keyed_taps_statistics():
    """Per-tap power follows the normalised PDP (test_channel_time.py:48),
    for the TDL and for the static taps."""
    ids = torch.arange(256, dtype=torch.int32)
    taps = chan.multipath_time_taps(0, ids, PDP, 64, 0.05, n_paths=32)
    assert taps.shape == (256, 64, 3) and taps.dtype == torch.complex64
    want = np.asarray(PDP) / np.sum(PDP)
    np.testing.assert_allclose((taps.abs() ** 2).mean(dim=(0, 1)).numpy(), want, rtol=0.1)
    static = chan.multipath_taps(0, torch.arange(4096, dtype=torch.int32), PDP)
    np.testing.assert_allclose((static.abs() ** 2).mean(dim=0).numpy(), want, rtol=0.1)


def test_keyed_taps_autocorrelation_is_jakes():
    """Autocorrelation of a keyed Jakes tap against J0(2π·fd·lag)
    (test_channel_time.py:59: 256 links × 400 steps, 64 paths, ±0.08)."""
    from scipy.special import j0

    fd = 0.05
    g = chan.multipath_time_taps(1, torch.arange(256, dtype=torch.int32), (1.0,), 400, fd,
                                 n_paths=64)[..., 0].numpy()
    power = np.mean(np.abs(g) ** 2)
    for lag in (1, 3, 6):
        rho = np.real(np.mean(np.conj(g[:, :-lag]) * g[:, lag:])) / power
        th = float(j0(2 * np.pi * fd * lag))
        assert abs(rho - th) < 0.08, (lag, rho, th)


def test_fading_state_carries_jax_shapes(rng):
    g = _cplx(rng, (4, 8))
    st = interop.fading_state(gains=g, taps=_cplx(rng, (4, 8, 3)))
    assert st["h"].shape == (4, 8, 1) and st["h"].dtype == torch.complex64
    assert st["taps"].shape == (4, 8, 3)
    np.testing.assert_array_equal(st["h"][:, :, 0].numpy(), g)
