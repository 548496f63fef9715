"""Kernel C on bfloat16 sample planes (rows #4, #8): the plain twin against
the JAX kernels fed the same bf16 planes, and the sample-type rule, on the
CPU. The CUDA kernel is held against its f32 run on the widened planes,
bit for bit, by ``tests/test_torch_kernels_cuda.py`` (marker ``gpu``).

The JAX side: ``demod_chain_pallas`` and ``demod_count_pallas`` in
interpret mode with ``SDR_TPU_MXU_PRECISION=highest``, where their bf16
mode (``x_bf16``) takes the samples into full-f32 DFT products — the
same function as the port's plain twin, which widens the planes first.

Tolerances (stated before the comparisons):
- LLR planes atol 1e-5 / rtol 1e-6 on the scale of the plane's peak
  (``tests/test_torch_kernels_plain.py``'s ``_assert_planes_close``);
  LLR sums rtol 1e-5;
- error counts equal, but for bits whose plain |LLR| < 1e-3;
- bf16 against f32 on the unrounded planes, the JAX test's bounds
  (``tests/test_demod.py:269-292``): within 2e-2 of the f32 peak, sign
  flips only where |LLR| < 5e-2 of the peak.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.kernels.demod_pallas import demod_chain_pallas, demod_count_pallas
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import demod as kc
from sdr_tpu_torch.ops import demod as od
from tests.test_torch_kernels_plain import (
    _assert_counts_agree,
    _assert_planes_close,
    _idx,
    _jmod,
    _noisy_rx,
    _scfdma_rx,
    _t,
)

torch.set_num_threads(1)

B, S, N, CP = 4, 8, 128, 32
BF = torch.bfloat16


def _bf16(re, im):
    """The planes rounded to bf16, as torch tensors and as JAX arrays."""
    tb = tuple(torch.from_numpy(a).to(BF) for a in (re, im))
    return tb, tuple(jnp.asarray(a, jnp.bfloat16) for a in (re, im))


def _planes(rng, h_syms):
    re, im = ((rng.standard_normal((B, S, N + CP)) / np.sqrt(2 * N)).astype(np.float32)
              for _ in range(2))
    hr, hi = ((rng.standard_normal((B, h_syms, N)) * np.sqrt(0.5)).astype(np.float32)
              for _ in range(2))
    return re, im, hr, hi


@pytest.mark.parametrize("h_syms,despread", [(1, False), (S, False), (1, True)],
                         ids=["per_link", "per_symbol", "despread"])
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM64], ids=lambda m: m.value)
def test_plain_plane_and_sum_on_bf16_match_jax_chain_kernel(rng, monkeypatch, mod, h_syms,
                                                           despread):
    """C's plane and sum (plain twin) on bf16 planes against
    demod_chain_pallas in its bf16 mode."""
    monkeypatch.setenv("SDR_TPU_MXU_PRECISION", "highest")
    re, im, hr, hi = _planes(rng, h_syms)
    (tre, tim), (jre, jim) = _bf16(re, im)
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    jh = tuple(map(jnp.asarray, (hr, hi)))
    ref = demod_chain_pallas(jre, jim, *jh, CP, _jmod(mod), nv, interpret=True, despread=despread)
    got = kc.demod_llr(tre, tim, *_t(hr, hi), CP, mod, nv, despread=despread)
    assert got.shape == (B, S, N * mod.bits_per_symbol) and got.dtype == torch.float32
    _assert_planes_close(got.numpy(), ref)
    ref_sum = demod_chain_pallas(jre, jim, *jh, CP, _jmod(mod), nv, reduce_sum=True,
                                 interpret=True, despread=despread)
    got_sum = od.demod_chain(tre, tim, *_t(hr, hi), CP, mod, nv, reduce_sum=True,
                             despread=despread)
    np.testing.assert_allclose(float(got_sum), float(ref_sum), rtol=1e-5)


@pytest.mark.parametrize("mode", ["per_link", "per_symbol", "despread", "taps"])
def test_plain_count_on_bf16_matches_jax_count_kernel(rng, monkeypatch, mode):
    """C's count (plain twin) on bf16 planes against demod_count_pallas in
    its bf16 mode: h per link or per symbol, the despread (SC-FDE) receive
    on an SC-FDMA waveform, and ``taps=`` (the response built from taps)."""
    monkeypatch.setenv("SDR_TPU_MXU_PRECISION", "highest")
    mod = Modulation.QAM16
    despread = mode == "despread"
    if despread:
        re, im, hr, hi, idx, nv = _scfdma_rx(rng, mod, B, S, N, CP, 8.0)
    else:
        re, im, hr, hi, idx, nv = _noisy_rx(rng, mod, B, S, N, CP, 6.0,
                                           h_syms=S if mode == "per_symbol" else 1)
    (tre, tim), (jre, jim) = _bf16(re, im)
    kw, jkw = {}, {}
    if mode == "taps":
        taps = ((rng.standard_normal((B, S, 3)) + 1j * rng.standard_normal((B, S, 3)))
                / np.sqrt(6)).astype(np.complex64)
        tr, ti = np.real(taps).astype(np.float32), np.imag(taps).astype(np.float32)
        kw, jkw = dict(taps=_t(tr, ti)), dict(taps=(jnp.asarray(tr), jnp.asarray(ti)))
        hr, hi = (a.numpy() for a in kc.taps_plane(_t(tr, ti), N))
    ref = demod_count_pallas(jre, jim, *map(jnp.asarray, (hr, hi, idx)), CP, _jmod(mod), nv,
                             interpret=True, despread=despread, **jkw)
    got = od.demod_count_chain(tre, tim, *((None, None) if kw else _t(hr, hi)), *_t(idx), CP,
                               mod, nv, despread=despread, **kw)
    assert got.dtype == torch.int32 and got.shape == (B,) and int(got.sum()) > 0
    _assert_counts_agree(got, ref, kc.demod_chain(tre, tim, *_t(hr, hi), CP, mod, nv,
                                                  despread=despread))


def test_bf16_against_f32_at_the_jax_tests_bounds(rng):
    """The bf16 run against the f32 run on the unrounded planes (the JAX
    test's shape, 16-QAM at 8 dB, N 256, CP 64): within 2e-2 of the f32
    peak, sign flips only where |LLR| < 5e-2 of the peak; the plain twin on
    bf16 is the f32 path on the widened planes exactly."""
    mod, n, cp = Modulation.QAM16, 256, 64
    re, im = (torch.from_numpy((rng.standard_normal((4, 8, n + cp)) / np.sqrt(2 * n))
                               .astype(np.float32)) for _ in range(2))
    hr, hi = (torch.from_numpy((rng.standard_normal((4, 1, n)) * np.sqrt(0.5)).astype(np.float32))
              for _ in range(2))
    nv = 1.0 / (10 ** 0.8 * mod.bits_per_symbol)
    l32 = kc.demod_llr(re, im, hr, hi, cp, mod, nv)
    l16 = kc.demod_llr(re.to(BF), im.to(BF), hr, hi, cp, mod, nv)
    peak = float(l32.abs().max())
    assert float((l16 - l32).abs().max()) < 2e-2 * peak
    flips = (l16 < 0) != (l32 < 0)
    assert float(l32[flips].abs().max()) < 5e-2 * peak if bool(flips.any()) else True
    assert torch.equal(l16, kc.demod_llr(re.to(BF).float(), im.to(BF).float(), hr, hi, cp, mod,
                                         nv))


def test_sample_dtype_rule(rng):
    """re/im both float32 or both bfloat16, the channel float32: a mixed
    pair, float16 planes or a bf16 channel raise in the kernels' wrappers
    and in their plain twins alike (checked before the device dispatch,
    so the card raises the same)."""
    mod, nv = Modulation.QPSK, 0.1
    re, im, hr, hi = _t(*_planes(rng, 1))
    idx = _t(_idx(rng, mod, (B, S, N)))[0]
    taps = (torch.zeros((B, S, 2)), torch.zeros((B, S, 2)))
    mixed = (re, im.to(BF))
    calls = [
        lambda r, i, h=(hr, hi): kc.demod_llr(r, i, *h, CP, mod, nv),
        lambda r, i, h=(hr, hi): kc.demod_llr(r, i, *h, CP, mod, nv, reduce_sum=True),
        lambda r, i, h=(hr, hi): kc.demod_chain(r, i, *h, CP, mod, nv),
        lambda r, i, h=(hr, hi): od.demod_chain(r, i, *h, CP, mod, nv, despread=True),
        lambda r, i, h=(hr, hi): od.demod_chain_plain(r, i, *h, CP, mod, nv),
        lambda r, i, h=(hr, hi): kc.demod_count(r, i, *h, idx, CP, mod, nv),
        lambda r, i, h=(hr, hi): kc.demod_count_plain(r, i, *h, idx, CP, mod, nv),
        lambda r, i, h=(hr, hi): od.demod_count_chain(r, i, *h, idx, CP, mod, nv),
    ]
    for call in calls:
        for planes in (mixed, (re.half(), im.half())):
            with pytest.raises(ValueError, match="must both be float32 or both bfloat16"):
                call(*planes)
        with pytest.raises(ValueError, match="hr/hi must be float32"):
            call(re.to(BF), im.to(BF), (hr.to(BF), hi))
    with pytest.raises(ValueError, match="hr/hi must be float32"):
        kc.demod_count(re.to(BF), im.to(BF), None, None, idx, CP, mod, nv,
                       taps=(taps[0].to(BF), taps[1]))
    # Both bf16 with a float32 channel is the mode itself.
    kc.demod_count(re.to(BF), im.to(BF), None, None, idx, CP, mod, nv, taps=taps)
    assert kc.counter("demod_sum", True) == "demod_sum_in_bf16"


def test_demod_chain_plain_is_the_plain_composition(rng):
    """``ops.demod.demod_chain_plain`` (the JAX ``demod_chain_jnp``'s
    counterpart) is kernel C's plain version on any device."""
    re, im, hr, hi = _t(*_planes(rng, S))
    for despread in (False, True):
        want = kc.demod_chain(re, im, hr, hi, CP, Modulation.QAM16, 0.05, despread=despread)
        got = od.demod_chain_plain(re, im, hr, hi, CP, Modulation.QAM16, 0.05, despread=despread)
        assert torch.equal(got, want)
