"""Blind timing and CFO acquisition in the port (``sdr_tpu_torch.ops.sync``)
on the CPU, against ``sdr_tpu.ops.sync`` (vmapped per channel where the
JAX function takes one link) on planted streams (N 64, CP 16 or 0, a few
channels), made from a seed with numpy.

Tolerances (stated before each comparison, derived from float32
rounding, u = 2^-24):

- the preamble and its grids: the grids exactly; the time samples at abs
  1e-6 (the transform's rounding, about log2(N)·u of a unit-scale grid);
- P, R, M: the sliding sums are differences of float32 running sums of n
  terms, each within n·u·Σ|x| of exact in either package (recursive
  summation's bound), so P and R within 4·n·u·Σ|x| and M within what
  that moves |P|²/(R + δ)²; the fractional CFO within that angle over π;
- rotations (``apply_cfo``, the corrected stream, the residual-CFO
  derotation): the angle 2π·ε·n/N is formed in the same float32 order in
  both packages, and float32 sin/cos of an angle θ agree within 4 ulp(θ),
  so samples within |x|·(4 ulp(θmax) + the angle moved by the CFO
  estimate's own tolerance) + 2u|x|;
- decisions exactly — the timing index (on streams whose metric has a
  clear margin: the peak leads every other candidate, and every window
  value clears 0.9·max, by more than twice M's tolerance, checked on the
  JAX metric), the integer CFO, the fine-timing argmax and the payload
  start; ``torch.round`` and ``jnp.round`` both round half to even, and
  both argmaxes return the first maximum.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import sync as jsync
from sdr_tpu_torch.ops import sync

torch.set_num_threads(1)

U = 2.0 ** -24
N, CP = 64, 16
L = N + CP


def _cn(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * (scale / np.sqrt(2))).astype(np.complex64)


def _jit(fn, *static):
    """``fn`` jitted with its trailing static arguments bound (one XLA
    compile instead of one a primitive)."""
    return jax.jit(lambda *a: fn(*a, *static))


def _sum_bound(x):
    """A float32 running sum's error over the last axis, either package:
    n·u·Σ|x| (per leading index, kept as a trailing axis of 1)."""
    a = np.abs(np.asarray(x).astype(np.complex128))
    return a.shape[-1] * U * a.sum(axis=-1, keepdims=True)


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def _planted(rng, delays, cfos, n_fft=N, cp=CP, snr_db=25.0, taps=None, body_syms=2,
             tail=None):
    """Streams (B, n) complex64: zeros for the delay, the two-symbol
    preamble, ``body_syms`` symbols of Gaussian samples at the preamble's
    power, zeros; an optional FIR per channel, then the CFO (float64
    before the cast) and AWGN at ``snr_db`` over the signal's power."""
    pre = np.asarray(jsync.acquisition_preamble(n_fft, cp)).astype(np.complex128)
    sl = n_fft + cp
    tail = sl if tail is None else tail
    n = max(delays) + 2 * sl + body_syms * sl + tail
    out = []
    for b, (d, eps) in enumerate(zip(delays, cfos)):
        s = np.zeros(n, np.complex128)
        s[d:d + 2 * sl] = pre
        s[d + 2 * sl:d + 2 * sl + body_syms * sl] = _cn(rng, body_syms * sl, n_fft ** -0.5)
        if taps is not None:
            s = np.convolve(s, taps[b])[:n]
        s = s * np.exp(2j * np.pi * eps * np.arange(n) / n_fft)
        s = s + _cn(rng, n, np.sqrt(10 ** (-snr_db / 10) / n_fft))
        out.append(s)
    return np.stack(out).astype(np.complex64)


def _slide_tol(x, w):
    """The bound on a sliding sum of w terms taken as a difference of two
    float32 running sums, either package against exact: the running sum to
    sample k is within (k + 1)·u·Σ_{i≤k}|x_i| of exact, doubled for the
    two ends of the window and again for the two packages."""
    a = np.abs(np.asarray(x).astype(np.complex128))
    rb = np.arange(1, a.shape[-1] + 1) * U * np.cumsum(a, axis=-1)
    lag = np.concatenate([np.zeros_like(rb[..., :1]), rb[..., :-w]], axis=-1)
    return 4 * (rb[..., w - 1:] + lag)


def _metric_tols(rx, n_fft=N):
    """(tolP, tolR, tolM) elementwise for ``timing_metric`` of rx, from the
    JAX metric's values."""
    h = n_fft // 2
    a = np.conj(rx[..., :-h]).astype(np.complex128) * rx[..., h:]
    P, R, M = (np.asarray(t) for t in _jit(jsync.timing_metric, n_fft)(jnp.asarray(rx)))
    n_valid = P.shape[-1]
    tol_p = _slide_tol(a, h)[..., :n_valid]
    tol_e = _slide_tol(np.abs(rx) ** 2, h)
    tol_r = 0.5 * (tol_e[..., :n_valid] + tol_e[..., h:h + n_valid])
    Rd = R.astype(np.float64) + 0.05 * R.mean(axis=-1, keepdims=True)
    tol_d = 0.05 * (tol_r.mean(axis=-1, keepdims=True) + _sum_bound(R) / n_valid)
    tol_m = ((2 * np.abs(P) * tol_p + tol_p ** 2) / Rd ** 2
             + 2 * M * (tol_r + tol_d) / Rd + 4 * U * M)
    return tol_p, tol_r, tol_m, (P, R, M)


def _assert_clear_margin(M, tol_m, n_fft=N):
    """The decisions' precondition on the JAX metric: the peak leads every
    other candidate, and each value in the centroid's window clears
    0.9·max, by more than twice M's tolerance at the two positions."""
    for m, t in zip(M, tol_m):
        d0 = int(m.argmax())
        rest = m.copy()
        rest[d0] = -np.inf
        d1 = int(rest.argmax())
        assert m[d0] - m[d1] > 2 * (t[d0] + t[d1]), "planted stream without a clear peak"
        lo, hi = max(d0 - n_fft, 0), min(d0 + n_fft + 1, m.size)
        assert np.all(np.abs(m[lo:hi] - 0.9 * m[d0]) > 2 * (t[lo:hi] + t[d0])), (
            "a window value sits at the 0.9·max threshold")


# ---- the preamble ------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,cp", [(64, 16), (256, 64), (16, 0)])
def test_preamble_equals_jax(n_fft, cp):
    g = sync._preamble_grids(n_fft, sync.PREAMBLE_SEED)
    for a, b in zip(g, jsync._preamble_grids(n_fft, 0x5C)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(sync.schmidl_cox_preamble(n_fft, cp).numpy(),
                               np.asarray(jsync.schmidl_cox_preamble(n_fft, cp)), atol=1e-6)
    got = sync.acquisition_preamble(n_fft, cp)
    assert got.dtype == torch.complex64 and got.shape == (2 * (n_fft + cp),)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsync.acquisition_preamble(n_fft, cp)),
                               atol=1e-6)


# ---- the timing metric and the coarse estimate -------------------------------------

def test_timing_metric_matches_jax(rng):
    rx = _planted(rng, [23, 37, 5], [0.31, -2.3, 1.7])
    tol_p, tol_r, tol_m, (P, R, M) = _metric_tols(rx)
    gP, gR, gM = (t.numpy() for t in sync.timing_metric(torch.from_numpy(rx), N))
    assert gP.shape == P.shape == (3, rx.shape[-1] - N) and gM.dtype == np.float32
    assert np.all(np.abs(gP - P) <= tol_p)
    assert np.all(np.abs(gR - R) <= tol_r)
    assert np.all(np.abs(gM - M) <= tol_m)


@pytest.mark.parametrize("cp", [0, CP])
def test_estimate_timing_cfo_matches_jax(rng, cp):
    """The timing index exactly, the fractional CFO within the stated
    tolerance. CP 0 gives the metric a one-sample peak (no CP plateau);
    with CP 16 a two-tap channel reaching the CP end shortens it."""
    taps = None if cp == 0 else [np.array([1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.8])] * 3
    rx = _planted(rng, [23, 37, 5], [0.31, -0.77, 0.6], cp=cp, snr_db=30.0, taps=taps)
    tol_p, _, tol_m, (P, _, M) = _metric_tols(rx)
    _assert_clear_margin(M, tol_m)
    jd, jc = (np.asarray(t) for t in _jit(jsync.estimate_timing_cfo, N)(jnp.asarray(rx)))
    d, c = sync.estimate_timing_cfo(torch.from_numpy(rx), N)
    np.testing.assert_array_equal(d.numpy(), jd)
    p_at = np.take_along_axis(P, jd[:, None], -1)[:, 0]
    tol_c = np.take_along_axis(tol_p, jd[:, None], -1)[:, 0] / (np.pi * np.abs(p_at)) + 2 * U
    assert np.all(np.abs(c.numpy() - jc) <= tol_c)


# ---- rotations ---------------------------------------------------------------------

def test_apply_and_correct_cfo_match_jax(rng):
    """Per-channel CFOs over (B, n) samples, and one CFO for all."""
    x = _cn(rng, (4, 900), 0.125)
    eps = np.array([2.3, -4.9, 0.013, 0.0], np.float32)
    n = np.arange(900)
    theta = 2 * np.pi * np.abs(eps)[:, None] * n / N
    tol = np.abs(x) * (4 * _ulp(theta).max(axis=-1, keepdims=True) + 2 * U) + 1e-9
    want = np.asarray(jax.jit(jax.vmap(lambda s, e: jsync.apply_cfo(s, e, N)))(
        jnp.asarray(x), jnp.asarray(eps)))
    got = sync.apply_cfo(torch.from_numpy(x), torch.from_numpy(eps), N).numpy()
    assert np.all(np.abs(got - want) <= tol)
    want = np.asarray(_jit(jsync.correct_cfo, 2.3, N)(jnp.asarray(x)))
    got = sync.correct_cfo(torch.from_numpy(x), 2.3, N).numpy()
    assert np.all(np.abs(got - want) <= np.abs(x) * (4 * _ulp(theta[0]).max() + 2 * U) + 1e-9)


def test_corrected_slice_is_the_corrected_stream_sliced(rng):
    """The window rotated at its absolute indices: the angles of slicing the
    whole corrected stream (torch's vectorised and scalar CPU sin/cos may
    round them one ulp apart: 2u|x|), a start past n − size clamped as
    ``dynamic_slice`` clamps it (the JAX link passes starts ≥ 0 only)."""
    x = torch.from_numpy(_cn(rng, (3, 500), 0.125))
    eps = torch.tensor([1.3, -2.71, 0.4])
    start = torch.tensor([0, 100, 480])
    got = sync.corrected_slice(x, eps, start, 64, N)
    full = sync.correct_cfo(x, eps, N)
    want = torch.stack([full[b, s:s + 64] for b, s in enumerate((0, 100, 436))])
    xs = torch.stack([x[b, s:s + 64] for b, s in enumerate((0, 100, 436))])
    assert bool(((got - want).abs() <= 2 * U * xs.abs()).all())
    jwant = jax.jit(jax.vmap(lambda r, s: jax.lax.dynamic_slice_in_dim(r, s, 64)))(
        jnp.asarray(x.numpy()), jnp.asarray(start.numpy()))
    np.testing.assert_array_equal(sync.take(x, start, 64).numpy(), np.asarray(jwant))


# ---- fine timing and the integer CFO --------------------------------------------------

def test_fine_timing_matches_jax(rng):
    """The argmax exactly (a sharp matched-filter peak at the planted
    offset), with and without an antenna axis combined."""
    t = np.array(jsync.acquisition_preamble(N, CP))
    rx = _cn(rng, (3, 2, 400), 0.05)
    offs = [211, 3, 240]
    for b, o in enumerate(offs):
        rx[b, :, o:o + t.size] += t * np.exp(1j * np.array([[0.3], [2.0]]))
    got = sync.fine_timing(torch.from_numpy(rx), torch.from_numpy(t))
    want = np.asarray(_jit(jsync.fine_timing)(jnp.asarray(rx), jnp.asarray(t)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want == np.array(offs)[:, None])
    got = sync.fine_timing(torch.from_numpy(rx), torch.from_numpy(t), combine_axis=1)
    want = np.asarray(_jit(jsync.fine_timing, 1)(jnp.asarray(rx), jnp.asarray(t)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, offs)


@pytest.mark.parametrize("noncoherent", [False, True])
def test_integer_cfo_matches_jax(rng, noncoherent):
    """Each even shift in ±4 planted on the preamble's grids (a channel
    phase and noise per antenna): the estimate equals JAX's and the truth."""
    g1, g2 = jsync._preamble_grids(N, 0x5C)
    shifts = np.array([-4, -2, 0, 2, 4])
    ant = 2 if noncoherent else 1
    y1 = np.empty((5, ant, N), np.complex64)
    y2 = np.empty((5, ant, N), np.complex64)
    for i, g in enumerate(shifts):
        ph = np.exp(1j * rng.uniform(0, 2 * np.pi, (ant, 1)))
        y1[i] = np.roll(g1, g) * ph + _cn(rng, (ant, N), 0.1)
        y2[i] = np.roll(g2, g) * ph + _cn(rng, (ant, N), 0.1)
    axis = 1 if noncoherent else None
    if not noncoherent:
        y1, y2 = y1[:, 0], y2[:, 0]
    got = sync.estimate_integer_cfo(torch.from_numpy(y1), torch.from_numpy(y2), N,
                                    noncoherent_axis=axis)
    want = np.asarray(_jit(jsync.estimate_integer_cfo, N, 2, 0x5C, axis)(jnp.asarray(y1),
                                                                   jnp.asarray(y2)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, shifts)


# ---- acquire ------------------------------------------------------------------------

def _check_acquired(rx, start, total, corrected, jstart, jtotal, jcorr, tol_p, P, d):
    """start exact; the CFO within the fractional estimate's tolerance; the
    corrected stream within the rotation's."""
    np.testing.assert_array_equal(start, jstart)
    p_at = np.abs(np.take_along_axis(P, d[..., None], -1)[..., 0])
    tol_at = np.take_along_axis(tol_p, d[..., None], -1)[..., 0]
    tol_c = tol_at / (np.pi * p_at) + 2 * U * (np.abs(jtotal) + 1)
    assert np.all(np.abs(total - jtotal) <= tol_c)
    n = np.arange(rx.shape[-1])
    theta = 2 * np.pi * np.abs(jtotal)[..., None] * n / N
    dth = 2 * np.pi * tol_c[..., None] * n / N + 4 * _ulp(theta).max(axis=-1, keepdims=True)
    if rx.ndim == 3:
        dth = dth[:, None]
    assert np.all(np.abs(corrected - jcorr) <= np.abs(rx) * (dth + 2 * U) + 1e-9)


def test_acquire_matches_jax(rng):
    """Delays, CFOs of ±2.3 subcarriers and a two-tap channel per link; the
    coarse index (clear margin), the integer CFO and the start exactly."""
    taps = [np.array([1.0] + [0.0] * 15 + [0.5 * np.exp(1j * k)]) for k in range(4)]
    rx = _planted(rng, [23, 37, 5, 41], [2.3, -2.3, 0.6, 1.7], snr_db=30.0, taps=taps,
                  body_syms=3)
    tol_p, _, tol_m, (P, _, M) = _metric_tols(rx)
    _assert_clear_margin(M, tol_m)
    jd, _ = _jit(jsync.estimate_timing_cfo, N)(jnp.asarray(rx))
    jstart, jtotal, jcorr = (np.asarray(t) for t in jax.jit(jax.vmap(
        lambda s: jsync.acquire(s, N, CP)))(jnp.asarray(rx)))
    start, total, corrected = sync.acquire(torch.from_numpy(rx), N, CP)
    _check_acquired(rx, start.numpy(), total.numpy(), corrected.numpy(), jstart, jtotal, jcorr,
                    tol_p, P, np.asarray(jd))
    np.testing.assert_array_equal(jstart, np.array([23, 37, 5, 41]) + 2 * L)
    s2, t2 = sync.acquire_start(torch.from_numpy(rx), N, CP)
    assert torch.equal(s2, start) and torch.equal(t2, total)


def test_acquire_clamps_a_late_lock(rng):
    """A preamble near the stream's end: the fine-timing window's start
    clamps into the stream, as ``dynamic_slice`` clamps it, in both."""
    rx = _planted(rng, [200, 190], [0.4, -1.1], snr_db=30.0, body_syms=0, tail=30)
    jstart, jtotal, _ = (np.asarray(t) for t in jax.jit(jax.vmap(
        lambda s: jsync.acquire(s, N, CP)))(jnp.asarray(rx)))
    start, total = sync.acquire_start(torch.from_numpy(rx), N, CP)
    np.testing.assert_array_equal(start.numpy(), jstart)
    np.testing.assert_array_equal(jstart, [200 + 2 * L, 190 + 2 * L])
    assert np.all(np.abs(total.numpy() - jtotal) < 1e-3)


def test_acquire_array_matches_jax(rng):
    """Two antennas a link, each with its own two-tap channel and noise;
    the start exactly, the CFO and the corrected streams within tolerance."""
    B, n_rx = 3, 2
    delays, cfos = [23, 37, 11], [2.3, -0.77, 1.3]
    rows = []
    for a in range(n_rx):
        taps = [np.array([np.exp(1j * (a + b))] + [0.0] * 15 + [0.6]) for b in range(B)]
        rows.append(_planted(np.random.default_rng(a), delays, cfos, snr_db=30.0, taps=taps))
    rx = np.stack(rows, axis=1)
    jstart, jtotal, jcorr = (np.asarray(t) for t in jax.jit(jax.vmap(
        lambda s: jsync.acquire_array(s, N, CP)))(jnp.asarray(rx)))
    start, total, corrected = sync.acquire_array(torch.from_numpy(rx), N, CP)
    np.testing.assert_array_equal(start.numpy(), jstart)
    np.testing.assert_array_equal(jstart, np.array(delays) + 2 * L)
    # P summed over the antennas and the CP-wide window: its sums' bounds add.
    h = N // 2
    a = np.conj(rx[..., :-h]).astype(np.complex128) * rx[..., h:]
    tol_p = 4 * _sum_bound(a).sum(axis=1) * CP
    p_sum = np.abs(np.asarray(_jit(jsync.timing_metric, N)(jnp.asarray(rx))[0])).sum(axis=1).max(-1)
    tol_c = tol_p[:, 0] / (np.pi * p_sum * 0.5) + 2 * U * 4
    assert np.all(np.abs(total.numpy() - jtotal) <= tol_c)
    n = np.arange(rx.shape[-1])
    theta = 2 * np.pi * np.abs(jtotal)[:, None] * n / N
    dth = (2 * np.pi * tol_c[:, None] * n / N + 4 * _ulp(theta).max(-1, keepdims=True))[:, None]
    assert np.all(np.abs(corrected.numpy() - jcorr) <= np.abs(rx) * (dth + 2 * U) + 1e-9)


# ---- the residual CFO -----------------------------------------------------------------

def test_cp_residual_cfo_matches_jax(rng):
    """Aligned symbols (B, S, N+cp) with a residual offset each: ε within
    the CP correlation's sum bound over 2π|c|, the derotation within the
    rotation's tolerance."""
    eps = np.array([0.05, -0.21, 0.003], np.float32)
    body = _cn(rng, (3, 8, N), N ** -0.5)
    sym = np.concatenate([body[..., N - CP:], body], axis=-1).reshape(3, -1)
    t = np.arange(sym.shape[-1])
    pay = (sym * np.exp(2j * np.pi * eps[:, None] * t / N)).reshape(3, 8, L)
    pay = (pay + _cn(rng, pay.shape, 0.01)).astype(np.complex64)
    terms = (np.conj(pay[..., :CP]) * pay[..., N:]).reshape(3, -1)
    c = np.abs(terms.sum(-1))
    tol_e = _sum_bound(terms)[:, 0] / (2 * np.pi * c) + 2 * U
    want = np.asarray(_jit(jsync.cp_residual_cfo, N, CP)(jnp.asarray(pay)))
    got = sync.cp_residual_cfo(torch.from_numpy(pay), N, CP).numpy()
    assert np.all(np.abs(got - want) <= tol_e)
    assert np.all(np.abs(want - eps) < 0.01)
    theta = 2 * np.pi * np.abs(want) * t.max() / N
    dth = (2 * np.pi * tol_e * t.max() / N + 4 * _ulp(theta))[:, None, None]
    want = np.asarray(_jit(jsync.correct_residual_cfo, N, CP)(jnp.asarray(pay)))
    got = sync.correct_residual_cfo(torch.from_numpy(pay), N, CP).numpy()
    assert np.all(np.abs(got - want) <= np.abs(pay) * (dth + 2 * U) + 1e-9)
