"""The port's polar codes (sdr_tpu_torch.ops.polar) on the CPU, held
against the JAX ``sdr_tpu.ops.polar``.

- Both constructions, the CRC matrices, ``make_polar_code`` and the
  encoders are exactly the JAX module's.
- Decisions: the port's fast-SSCL decoder equals the JAX fast decoder at
  every (N, K, L, crc) case of the JAX ``tests/test_polar.py:373-404``
  (noisy LLRs, its seeds), and the port's bit-serial SCL and SC decoders
  equal the JAX ones at N 64 (the JAX scan decoders are compiled at N ≤ 64
  only: they dominate the JAX compile time); on every case the port's fast
  decoder equals its own scan decoder. Planted ties — integer LLRs in
  [−2, 2], so that path metrics tie exactly and inactive slots (BIG) tie
  with live candidates — give each port decoder the JAX decoder's
  decisions (the stable sort and the first-index argmin keep JAX's tie
  rule; the fast and scan decoders part there, in both packages).
- ``_rate0_penalty`` within float32 rounding of the JAX one: both sum the
  same W non-negative leaf terms in different orders, so they differ by at
  most 2(W−1)·2^-24 of the sum.
- The gates of the JAX ``tests/test_polar.py`` on the port: its decoder
  tests, and its links (:111-171) on the port's link with the JAX tests'
  key numbers as seeds.

Each JAX decoder is compiled once per (code, list) shape (a module-level
cache); its fast decoder at (1024, 512) L 8 is most of this file's time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import polar as jpolar
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.link.coded import make_polar_fn
from sdr_tpu_torch.ops import polar
from sdr_tpu_torch.ops.polar import (
    crc_matrices,
    make_polar_code,
    polar_construct,
    polar_construct_ga,
    polar_decode_sc,
    polar_decode_scl,
    polar_decode_scl_fast,
    polar_encode,
    polar_encode_info,
    polar_encode_payload,
)

torch.set_num_threads(1)

CASES = [(64, 32, 8, "crc11"), (256, 128, 8, "crc11"), (256, 128, 1, "crc11"),
         (128, 96, 4, None), (256, 64, 2, None), (1024, 512, 8, "crc11")]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@functools.lru_cache(maxsize=None)
def _jax_decoder(kind, N, K, L, crc):
    code = jpolar.make_polar_code(N, K, crc=crc)
    if kind == "fast":
        return jax.jit(lambda x: jpolar.polar_decode_scl_fast(x, code, list_size=L))
    if kind == "scan":
        return jax.jit(lambda x: jpolar.polar_decode_scl(x, code, list_size=L))
    return jax.jit(lambda x: jpolar.polar_decode_sc(x, N, K))


def _jax(kind, case, llr):
    return np.asarray(_jax_decoder(kind, *case)(jnp.asarray(llr)))


@functools.lru_cache(maxsize=None)
def _noisy(case):
    """The JAX parity test's inputs (its seed and noise): (payload, LLRs)."""
    N, K, L, crc = case
    code = make_polar_code(N, K, crc=crc)
    rng = np.random.default_rng(N + K + L)
    pay = rng.integers(0, 2, (16, code.payload_len)).astype(np.int8)
    cw = polar_encode_payload(_t(pay), code).numpy()
    sigma2 = 1.0 / (2.0 * code.rate * 10 ** 0.2)
    y = (1 - 2 * cw.astype(np.float64)) + rng.normal(0, np.sqrt(sigma2), cw.shape)
    return pay, (2 * y / sigma2).astype(np.float32)


def _ties(N):
    return np.random.default_rng(N).integers(-2, 3, (16, N)).astype(np.float32)


# ---- tables and encoders -------------------------------------------------------------------

@pytest.mark.parametrize("N,k", [(8, 4), (16, 8), (64, 32), (256, 139), (1024, 512)])
def test_constructions_equal_jax(N, k):
    for got, want in ((polar_construct(N, k), jpolar.polar_construct(N, k)),
                      (polar_construct_ga(N, k), jpolar.polar_construct_ga(N, k)),
                      (polar_construct_ga(N, k, 4.0), jpolar.polar_construct_ga(N, k, 4.0))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for crc in ("crc11", None):
        if k > 11:
            got, want = make_polar_code(N, k, crc=crc), jpolar.make_polar_code(N, k, crc=crc)
            assert (got.payload_len, got.rate) == (want.payload_len, want.rate)
            np.testing.assert_array_equal(got.info_idx, want.info_idx)


@pytest.mark.parametrize("crc", ["crc8", "crc11", "crc16"])
def test_crc_matrices_equal_jax(crc):
    for n in (1, 40, 117):
        for got, want in zip(crc_matrices(n, crc), jpolar.crc_matrices(n, crc)):
            np.testing.assert_array_equal(got, want)


def test_encoders_equal_jax():
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, (3, 4, 256)).astype(np.int8)
    np.testing.assert_array_equal(polar_encode(_t(u)).numpy(),
                                  np.asarray(jax.jit(jpolar.polar_encode)(jnp.asarray(u))))
    info = rng.integers(0, 2, (5, 96)).astype(np.int8)
    np.testing.assert_array_equal(
        polar_encode_info(_t(info), 128).numpy(),
        np.asarray(jax.jit(lambda x: jpolar.polar_encode_info(x, 128))(jnp.asarray(info))))
    for N, K, crc in ((256, 128, "crc11"), (64, 32, None), (128, 64, "crc16")):
        code, jcode = make_polar_code(N, K, crc=crc), jpolar.make_polar_code(N, K, crc=crc)
        pay = rng.integers(0, 2, (2, 3, code.payload_len)).astype(np.int8)
        got = polar_encode_payload(_t(pay), code)
        assert got.dtype == torch.int8 and got.shape == (2, 3, N)
        want = jax.jit(lambda x, c=jcode: jpolar.polar_encode_payload(x, c))(jnp.asarray(pay))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- decisions -------------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fast_decoder_equals_jax_and_the_scan_decoder(case):
    N, K, L, crc = case
    code = make_polar_code(N, K, crc=crc)
    pay, llr = _noisy(case)
    got = polar_decode_scl_fast(_t(llr), code, list_size=L)
    assert got.dtype == torch.int8 and got.shape == (16, code.payload_len)
    np.testing.assert_array_equal(got.numpy(), _jax("fast", case, llr))
    np.testing.assert_array_equal(polar_decode_scl(_t(llr), code, list_size=L).numpy(),
                                  got.numpy())
    if N <= 64:
        np.testing.assert_array_equal(polar_decode_scl(_t(llr), code, list_size=L).numpy(),
                                      _jax("scan", case, llr))


@pytest.mark.parametrize("case", [(64, 32, 8, "crc11"), (128, 96, 4, None)],
                         ids=lambda c: "-".join(map(str, c)))
def test_decoders_equal_jax_on_planted_ties(case):
    N, K, L, crc = case
    code = make_polar_code(N, K, crc=crc)
    llr = _ties(N)
    fast = polar_decode_scl_fast(_t(llr), code, list_size=L).numpy()
    np.testing.assert_array_equal(fast, _jax("fast", case, llr))
    if N <= 64:
        scan = polar_decode_scl(_t(llr), code, list_size=L).numpy()
        np.testing.assert_array_equal(scan, _jax("scan", case, llr))
        assert (scan != fast).any()  # the ties part the two decoders, in both packages
        np.testing.assert_array_equal(polar_decode_sc(_t(llr), N, K).numpy(),
                                      _jax("sc", (N, K, 1, None), llr))


def test_sc_equals_jax_on_noisy_llrs():
    case = (64, 32, 1, None)
    _, llr = _noisy((64, 32, 8, "crc11"))
    np.testing.assert_array_equal(polar_decode_sc(_t(llr), 64, 32).numpy(),
                                  _jax("sc", case, llr))


def test_rate0_penalty_within_rounding_of_jax():
    rng = np.random.default_rng(5)
    for W in (2, 4, 8, 16, 64):
        alpha = rng.standard_normal((5, 3, W)).astype(np.float32) * 4
        got = polar._rate0_penalty(_t(alpha)).numpy()
        want = np.asarray(jax.jit(jax.vmap(jpolar._rate0_penalty))(jnp.asarray(alpha)))
        # The leaf LLRs are the same floats in both (the same elementwise
        # cascade); the W non-negative terms are summed in different orders
        # (the port: a halving tree), each sum within (W−1)·u of the exact one.
        bound = 2 * (W - 1) * 2.0 ** -24 * want
        assert np.all(np.abs(got - want) <= bound)


# ---- the JAX tests' gates on the port (tests/test_polar.py) ------------------------------

def test_encoder_is_natural_order_kronecker_f():
    G = polar_encode(torch.eye(4, dtype=torch.int8)).numpy()
    expect = np.array([[1, 0, 0, 0], [1, 1, 0, 0], [1, 0, 1, 0], [1, 1, 1, 1]], np.int8)
    np.testing.assert_array_equal(G, expect)


def test_encoder_linearity():
    rng = np.random.default_rng(1)
    a = _t(rng.integers(0, 2, (64,)).astype(np.int8))
    b = _t(rng.integers(0, 2, (64,)).astype(np.int8))
    torch.testing.assert_close(polar_encode(a ^ b), polar_encode(a) ^ polar_encode(b),
                               rtol=0, atol=0)


def test_construction_orders_by_reliability():
    info_idx, frozen = polar_construct(256, 128)
    assert len(info_idx) == 128 and int(frozen.sum()) == 128
    assert 255 in info_idx and 0 not in info_idx
    for i in (127, 191, 223, 239, 247, 251, 253, 254):
        assert i in info_idx


def test_noiseless_round_trip_exact():
    N, K = 128, 64
    info = _t(np.random.default_rng(0).integers(0, 2, (8, K)).astype(np.int8))
    llr = (1.0 - 2.0 * polar_encode_info(info, N).to(torch.float32)) * 5.0
    torch.testing.assert_close(polar_decode_sc(llr, N, K), info, rtol=0, atol=0)


def _sc_reference(llr, frozen):
    """Independent recursive SC (same min-sum f/g), natural order
    x = (p ⊕ q, q). Returns the full u vector."""

    def rec(L, fr):
        n = len(L)
        if n == 1:
            u = 0 if fr[0] else int(L[0] < 0)
            return np.array([u]), np.array([u])
        a, b = L[: n // 2], L[n // 2:]
        Lf = np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
        u1, p = rec(Lf, fr[: n // 2])
        u2, q = rec(b + (1 - 2 * p) * a, fr[n // 2:])
        return np.concatenate([u1, u2]), np.concatenate([p ^ q, q])

    return rec(np.asarray(llr, np.float64), frozen)[0]


@pytest.mark.parametrize("N,K", [(64, 32), (128, 96)])
def test_sc_matches_recursive_reference(N, K):
    info_idx, frozen = polar_construct(N, K)
    rng = np.random.default_rng(7)
    for _ in range(20):
        info = rng.integers(0, 2, (K,)).astype(np.int8)
        cw = polar_encode_info(_t(info[None]), N).numpy()[0]
        y = (1.0 - 2.0 * cw.astype(np.float32)) + rng.normal(0, 0.9, (N,))
        llr = 2.0 * y / 0.81
        mine = polar_decode_sc(_t(llr[None].astype(np.float32)), N, K).numpy()[0]
        np.testing.assert_array_equal(mine, _sc_reference(llr, frozen)[info_idx])


def test_polar_guards():
    with pytest.raises(ValueError, match="power of 2"):
        polar_encode(torch.zeros((6,), dtype=torch.int8))
    with pytest.raises(ValueError, match="k must be"):
        polar_construct(64, 0)
    with pytest.raises(ValueError, match="last axis"):
        polar_decode_sc(torch.zeros((32,)), 64, 32)
    with pytest.raises(ValueError, match="payload"):
        make_polar_code(64, 8, crc="crc11")
    with pytest.raises(ValueError, match="list_size"):
        polar_decode_scl(torch.zeros((64,)), make_polar_code(64, 32), 0)
    with pytest.raises(ValueError, match="list_size"):
        polar_decode_scl_fast(torch.zeros((64,)), make_polar_code(64, 32), 0)


def test_construction_is_interleaved_classic_8_4():
    for idx in (polar_construct(8, 4)[0], polar_construct_ga(8, 4)[0]):
        assert set(int(i) for i in idx) == {3, 5, 6, 7}


def test_ga_matches_genie_error_order():
    assert set(map(int, polar_construct_ga(16, 8)[0])) == set(map(int, polar_construct(16, 8)[0]))


def test_crc_matrices_match_lfsr():
    gen, chk = crc_matrices(40, "crc11")
    taps = np.array([(0x621 >> (11 - 1 - j)) & 1 for j in range(11)], np.int8)
    rng = np.random.default_rng(3)
    for _ in range(5):
        p = rng.integers(0, 2, (40,)).astype(np.int8)
        reg = np.zeros(11, np.int8)
        for b in p:
            fb = reg[0] ^ b
            reg = np.concatenate([reg[1:], np.zeros(1, np.int8)])
            if fb:
                reg ^= taps
        np.testing.assert_array_equal((p @ gen) % 2, reg)
        assert not ((np.concatenate([p, reg]) @ chk) % 2).any()


def test_crc_detects_flips():
    gen, chk = crc_matrices(40, "crc11")
    p = np.random.default_rng(4).integers(0, 2, (40,)).astype(np.int8)
    word = np.concatenate([p, (p @ gen) % 2])
    for pos in (0, 17, 50):
        bad = word.copy()
        bad[pos] ^= 1
        assert ((bad @ chk) % 2).any()


def test_scl_list1_equals_sc():
    N, K = 128, 64
    code = make_polar_code(N, K, crc=None, construction="bhattacharyya")
    rng = np.random.default_rng(12)
    info = rng.integers(0, 2, (16, K)).astype(np.int8)
    cw = polar_encode_info(_t(info), N).numpy()
    y = (1.0 - 2.0 * cw.astype(np.float64)) + rng.normal(0, 0.8, cw.shape)
    llr = _t((2.0 * y / 0.64).astype(np.float32))
    torch.testing.assert_close(polar_decode_sc(llr, N, K), polar_decode_scl(llr, code, 1),
                               rtol=0, atol=0)


def test_scl_noiseless_round_trip_with_crc():
    code = make_polar_code(128, 64, crc="crc11")
    pay = _t(np.random.default_rng(0).integers(0, 2, (8, code.payload_len)).astype(np.int8))
    llr = (1.0 - 2.0 * polar_encode_payload(pay, code).to(torch.float32)) * 5.0
    torch.testing.assert_close(polar_decode_scl(llr, code, list_size=4), pay, rtol=0, atol=0)


def _scl_reference(llr, code, list_size):
    """Independent numpy CA-SCL: paths as explicit (u-prefix, metric)
    tuples, each bit's leaf LLR recomputed from scratch by the recursive
    formula."""

    def leaf_llr(L, decided):
        n = len(L)
        if n == 1:
            return L[0]
        half = n // 2
        a, b = L[:half], L[half:]
        if len(decided) < half:
            f = np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
            return leaf_llr(f, decided)
        left = decided[:half]
        s = left.astype(np.float64) if half == 1 else polar_encode(
            _t(left[None].astype(np.int8))).numpy()[0]
        return leaf_llr(b + (1.0 - 2.0 * s) * a, decided[half:])

    paths = [(np.zeros(0, np.int8), 0.0)]
    for i in range(code.block_len):
        cands = []
        for u, pm in paths:
            l_i = leaf_llr(np.asarray(llr, np.float64), u)
            cands.append((np.append(u, 0), pm + max(-l_i, 0.0)))
            if not code.frozen[i]:
                cands.append((np.append(u, 1), pm + max(l_i, 0.0)))
        cands.sort(key=lambda t: t[1])
        paths = cands[:list_size]
    _, chk = crc_matrices(code.payload_len, code.crc)
    best = None
    for u, pm in paths:
        info = u[code.info_idx]
        key = (bool(((info @ chk) % 2).any()), pm)
        if best is None or key < best[0]:
            best = (key, info[: code.payload_len])
    return best[1]


def test_scl_matches_independent_reference():
    code = make_polar_code(64, 32, crc="crc11")
    rng = np.random.default_rng(21)
    for trial in range(10):
        pay = rng.integers(0, 2, (code.payload_len,)).astype(np.int8)
        cw = polar_encode_payload(_t(pay[None]), code).numpy()[0]
        y = (1.0 - 2.0 * cw.astype(np.float64)) + rng.normal(0, 0.7, (64,))
        llr = 2.0 * y / 0.49
        mine = polar_decode_scl(_t(llr[None].astype(np.float32)), code, list_size=4).numpy()[0]
        np.testing.assert_array_equal(mine, _scl_reference(llr.astype(np.float32), code, 4),
                                      err_msg=f"trial {trial}")


def test_scl_beats_sc_at_low_snr():
    rng = np.random.default_rng(33)
    sigma2 = 1.0 / (2.0 * 10 ** 0.4)
    code = make_polar_code(256, 128, crc="crc11")
    pay = rng.integers(0, 2, (64, code.payload_len)).astype(np.int8)
    cw = polar_encode_payload(_t(pay), code).numpy()
    y = (1 - 2 * cw.astype(np.float64)) + rng.normal(0, np.sqrt(sigma2), cw.shape)
    dec = polar_decode_scl(_t((2 * y / sigma2).astype(np.float32)), code, list_size=8).numpy()
    assert (dec != pay).mean() < 1e-3


def test_fast_sscl_noiseless_round_trip():
    code = make_polar_code(256, 139, crc="crc11")
    pay = _t(np.random.default_rng(9).integers(0, 2, (8, code.payload_len)).astype(np.int8))
    llr = 10.0 * (1 - 2 * polar_encode_payload(pay, code).to(torch.float32))
    torch.testing.assert_close(polar_decode_scl_fast(llr, code, list_size=8), pay, rtol=0,
                               atol=0)


def _link_cfg(mod, ebno_db, n_symbols, n_channels, model=ChannelModel.AWGN, **kw):
    channel = ChannelConfig(model=model, ebno_db=ebno_db, **kw.pop("channel", {}))
    return LinkConfig(modulation=mod, ofdm=OFDMConfig(128, 16), channel=channel,
                      n_symbols=n_symbols, n_channels=n_channels, **kw)


def test_polar_coded_link_beats_uncoded():
    """(256, 128 incl. CRC-11) CA-SCL-8 over QPSK/AWGN at 4 dB (uncoded
    1.25e-2): under 2e-3, counting the payload bits."""
    cfg = _link_cfg(Modulation.QPSK, 4.0, 32, 8)
    errors, counted = make_polar_fn(cfg, rate="1/2", device="cpu")(0)
    e, t = int(errors.sum()), int(counted.sum())
    assert t == 8 * 32 * (128 * 2 // 256) * (128 - 11)
    assert e / t < 2e-3


@pytest.mark.parametrize("rate", ["2/3", "3/4"])
def test_polar_rates_run_and_decode(rate):
    errors, counted = make_polar_fn(_link_cfg(Modulation.QPSK, 7.0, 16, 4), rate=rate,
                                    device="cpu")(1)
    e, t = int(errors.sum()), int(counted.sum())
    assert t > 0 and e / t < 2e-3


def test_polar_composes_with_fading_and_pilots():
    cfg = _link_cfg(Modulation.QAM16, 16.0, 16, 8, model=ChannelModel.MULTIPATH,
                    channel=dict(pdp=(1.0, 0.4)), equalizer=Equalizer.MMSE, pilot_spacing=8)
    errors, counted = make_polar_fn(cfg, rate="1/2", device="cpu")(2)
    assert int(errors.sum()) / int(counted.sum()) < 5e-3
