"""The port's convolutional FEC (sdr_tpu_torch.ops.fec) on the CPU, held
against the JAX ``sdr_tpu.ops.fec``.

- The trellis tables, the encoder, puncture/depuncture and the lengths
  are exactly the JAX module's.
- ``viterbi_decode`` gives the JAX decoder's decisions, bit for bit, on
  seeded noisy LLRs at every 802.11a rate (the depunctured zeros are
  exact ties of the branch metrics), for the K 7 (171, 133) code, a K 3
  (7, 5) code and a K 9 (561, 753) code, and on quantised LLRs (integers in [−2, 2]: ties in
  the path metrics); both decoders do the same float32 operations in the
  same order, so no tolerance is needed. The forward pass's runs of steps
  (``_RUN_BYTES``) do not change a decision.
- The decoder-level gates of the JAX ``tests/test_fec.py`` (:39-83,
  :102-140) on the port.

The JAX decoder is compiled once per (K, rate) shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import fec as jfec
from sdr_tpu_torch.ops import fec
from sdr_tpu_torch.ops.interleave import deinterleave, interleave

torch.set_num_threads(1)

# K 9 (561, 753): 256 states, four decision words a step.
CODES = {"k7": ((0o171, 0o133), 7), "k3": ((0o7, 0o5), 3), "k9": ((0o561, 0o753), 9)}
RATES = ("1/2", "2/3", "3/4")
N_INFO = 120


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _naive_encode(bits, polys=fec.DEFAULT_POLYS, K=fec.DEFAULT_K):
    """Independent reference encoder (same register convention)."""
    out = []
    s = 0
    for b in list(bits) + [0] * (K - 1):
        r = (int(b) << (K - 1)) | s
        for p in polys:
            out.append(bin(r & p).count("1") & 1)
        s = r >> 1
    return np.array(out, np.int8)


@pytest.mark.parametrize("code", list(CODES))
def test_tables_are_the_jax_tables(code):
    polys, K = CODES[code]
    for got, want in zip(fec._tables(polys, K), jfec._tables(polys, K)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", list(CODES))
def test_encoder_equals_jax(code):
    polys, K = CODES[code]
    bits = np.random.default_rng(1).integers(0, 2, (3, 5, 37)).astype(np.int8)
    got = fec.conv_encode(_t(bits), polys, K)
    assert got.dtype == torch.int8 and got.shape == (3, 5, fec.coded_len(37, polys, K))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfec.conv_encode(jnp.asarray(bits),
                                                                            polys, K)))


@pytest.mark.parametrize("rate", RATES)
def test_puncture_and_lengths_equal_jax(rate):
    for steps in (1, 2, 7, 106):
        np.testing.assert_array_equal(fec._puncture_indices(steps, rate),
                                      jfec._puncture_indices(steps, rate))
    for n in (1, 50, 994):
        assert fec.punctured_len(n, rate) == jfec.punctured_len(n, rate)
        assert fec.coded_len(n) == jfec.coded_len(n)
    x = np.random.default_rng(2).standard_normal((4, 2 * 53)).astype(np.float32)
    kept = fec.puncture(_t(x), rate)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jfec.puncture(jnp.asarray(x), rate)))
    np.testing.assert_array_equal(fec.depuncture(kept, rate, 53).numpy(),
                                  np.asarray(jfec.depuncture(jnp.asarray(kept.numpy()), rate,
                                                             53)))


@functools.lru_cache(maxsize=None)
def _jax_viterbi(n_info, polys, K):
    return jax.jit(lambda x: jfec.viterbi_decode(x, n_info, polys, K))


def _noisy_llrs(rng, info, polys, K, rate, sigma):
    """Punctured BPSK LLRs 2y/σ² of the encoded info, depunctured (zeros at
    the punctured positions)."""
    sent = fec.puncture(fec.conv_encode(_t(info), polys, K), rate, len(polys)).numpy()
    y = (1.0 - 2.0 * sent) + rng.normal(0.0, sigma, sent.shape)
    llr = _t((2.0 * y / sigma**2).astype(np.float32))
    return fec.depuncture(llr, rate, info.shape[-1] + K - 1, len(polys))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("code", list(CODES))
def test_viterbi_equals_jax(code, rate):
    """Decoded bits equal on noisy LLRs at σ 1 (below the waterfall: wrong
    decisions remain at every rate) with the depunctured zeros."""
    polys, K = CODES[code]
    rng = np.random.default_rng(len(rate) + K)
    info = rng.integers(0, 2, (6, N_INFO)).astype(np.int8)
    llr = _noisy_llrs(rng, info, polys, K, rate, 1.0)
    got = fec.viterbi_decode(llr, N_INFO, polys, K)
    want = np.asarray(_jax_viterbi(N_INFO, polys, K)(jnp.asarray(llr.numpy())))
    assert got.dtype == torch.int8 and got.shape == (6, N_INFO)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != info).any()  # the comparison covers wrong decisions too


@pytest.mark.parametrize("code", list(CODES))
def test_viterbi_equals_jax_on_ties(code):
    """Integer LLRs in [−2, 2]: equal path metrics everywhere; the strict
    comparison keeps slot 0 on both sides."""
    polys, K = CODES[code]
    llr = np.random.default_rng(4).integers(-2, 3, (8, 2 * (N_INFO + K - 1))).astype(np.float32)
    np.testing.assert_array_equal(
        fec.viterbi_decode(_t(llr), N_INFO, polys, K).numpy(),
        np.asarray(_jax_viterbi(N_INFO, polys, K)(jnp.asarray(llr))))


def test_viterbi_runs_do_not_change_decisions(monkeypatch):
    """The forward pass in runs of a few steps (branch metrics and packing
    per run) decodes what one run does; batch axes are kept."""
    rng = np.random.default_rng(6)
    info = rng.integers(0, 2, (2, 3, N_INFO)).astype(np.int8)
    llr = _noisy_llrs(rng, info.reshape(6, -1), fec.DEFAULT_POLYS, 7, "3/4", 0.8).reshape(
        2, 3, -1)
    whole = fec.viterbi_decode(llr, N_INFO)
    monkeypatch.setattr(fec, "_RUN_BYTES", 6 * 128 * 4 * 5)  # runs of 5 steps
    torch.testing.assert_close(fec.viterbi_decode(llr, N_INFO), whole, rtol=0, atol=0)
    assert whole.shape == (2, 3, N_INFO)
    with pytest.raises(ValueError, match="llr length"):
        fec.viterbi_decode(llr[..., 1:], N_INFO)


# ---- the JAX tests' decoder-level gates (tests/test_fec.py:39-83, :102-140) ---------------

def test_encoder_matches_naive(rng):
    bits = rng.integers(0, 2, 40).astype(np.int8)
    ours = fec.conv_encode(_t(bits)).numpy()
    assert ours.shape == (fec.coded_len(40),)
    np.testing.assert_array_equal(ours, _naive_encode(bits))


def test_encoder_batched(rng):
    bits = rng.integers(0, 2, (3, 5, 16)).astype(np.int8)
    out = fec.conv_encode(_t(bits)).numpy()
    assert out.shape == (3, 5, fec.coded_len(16))
    np.testing.assert_array_equal(out[1, 2], _naive_encode(bits[1, 2]))


def test_viterbi_clean_round_trip(rng):
    n_info = 64
    bits = rng.integers(0, 2, (4, n_info)).astype(np.int8)
    cw = fec.conv_encode(_t(bits))
    llr = (1.0 - 2.0 * cw.to(torch.float32)) * 8.0  # perfect LLRs
    np.testing.assert_array_equal(fec.viterbi_decode(llr, n_info).numpy(), bits)


def test_viterbi_corrects_bit_flips(rng):
    """Free distance 10: eight scattered sign flips decode exactly."""
    n_info = 128
    bits = rng.integers(0, 2, n_info).astype(np.int8)
    cw = fec.conv_encode(_t(bits)).numpy()
    llr = (1.0 - 2.0 * cw).astype(np.float32) * 4.0
    flip = rng.choice(len(llr), size=8, replace=False)
    llr[flip] *= -1.0
    np.testing.assert_array_equal(fec.viterbi_decode(_t(llr), n_info).numpy(), bits)


def test_interleave_round_trip(rng):
    x = _t(rng.standard_normal((2, 97)).astype(np.float32))
    torch.testing.assert_close(deinterleave(interleave(x)), x, rtol=0, atol=0)
    assert not torch.equal(interleave(x), x)


def test_puncture_depuncture_layout():
    """Kept positions follow the 802.11a patterns; depuncture re-seats the
    survivors and zeros the holes."""
    T = 6
    coded = torch.arange(1, T * 2 + 1, dtype=torch.float32)  # [A1,B1,A2,B2,...]
    np.testing.assert_array_equal(fec.puncture(coded, "2/3").numpy(),
                                  [1, 2, 3, 5, 6, 7, 9, 10, 11])
    kept34 = fec.puncture(coded, "3/4")
    np.testing.assert_array_equal(kept34.numpy(), [1, 2, 3, 6, 7, 8, 9, 12])
    expect = coded.clone()
    expect[[3, 4, 9, 10]] = 0.0  # B2, A3, B5, A6 punctured
    torch.testing.assert_close(fec.depuncture(kept34, "3/4", T), expect, rtol=0, atol=0)


def test_punctured_rates_effective():
    n = 994  # + 6 tail = 1000 steps
    assert fec.punctured_len(n, "1/2") == 2000
    assert fec.punctured_len(n, "2/3") == 1500
    assert fec.punctured_len(n, "3/4") == 1334


@pytest.mark.parametrize("rate", ["2/3", "3/4"])
def test_punctured_code_decodes_clean_channel(rate):
    rng = np.random.default_rng(5)
    n_info = 200
    info = _t(rng.integers(0, 2, n_info).astype(np.int8))
    sent = fec.puncture(fec.conv_encode(info), rate)
    llr = (1.0 - 2.0 * sent.to(torch.float32)) * 8.0
    dec = fec.viterbi_decode(fec.depuncture(llr, rate, n_info + 6), n_info)
    torch.testing.assert_close(dec, info, rtol=0, atol=0)
