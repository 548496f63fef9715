"""The port's QC-LDPC code, encoder, interleaver and kernel H's plain
versions against the JAX package.

Exact throughout: code bases, codewords, syndromes, permutations and the
decoders' hard decisions are compared bit for bit on the same numpy
inputs. The JAX decoders run as the JAX suite runs them on a CPU: the jnp
decoder, and the Pallas kernels in interpret mode, on the (8, 4, 128)
code with at most 256 codewords (tests/test_ldpc.py:141-208); the stock
rate-1/2 code is decoded against the jnp decoder on 8 codewords.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.kernels.ldpc_pallas import ldpc_decode_pallas, ldpc_decode_pallas_sublane
from sdr_tpu.link.coded import ldpc_code_for as j_code_for
from sdr_tpu.ops.interleave import _perm as j_perm
from sdr_tpu.ops.interleave import deinterleave as j_deinterleave
from sdr_tpu.ops.interleave import interleave as j_interleave
from sdr_tpu.ops import ldpc as jl
from sdr_tpu_torch import interop
from sdr_tpu_torch.kernels import ldpc as kh
from sdr_tpu_torch.link.coded import ldpc_code_for
from sdr_tpu_torch.ops import interleave as til
from sdr_tpu_torch.ops import ldpc as tl

torch.set_num_threads(1)

RATES = ["1/2", "2/3", "3/4"]


def _codes(rate):
    if rate == "8,4":
        return jl.make_qc_ldpc(8, 4, 128), tl.make_qc_ldpc(8, 4, 128)
    return j_code_for(rate), ldpc_code_for(rate)


def _noisy_llr(rng, code, n_cw, sigma):
    """(info, codeword, BPSK-over-AWGN LLRs) as numpy, LLR = 2y/σ²."""
    info = rng.integers(0, 2, (n_cw, code.k)).astype(np.int8)
    cw = tl.ldpc_encode(code, torch.from_numpy(info)).numpy()
    x = 1.0 - 2.0 * cw.astype(np.float32)
    y = x + rng.standard_normal(x.shape).astype(np.float32) * np.float32(sigma)
    return info, cw, (2.0 * y / np.float32(sigma) ** 2).astype(np.float32)


@pytest.mark.parametrize("rate", RATES + ["8,4"])
def test_code_construction_matches_jax(rate):
    jc, tc = _codes(rate)
    assert tc.base == jc.base and tc.z == jc.z
    assert (tc.n, tc.k, tc.mb, tc.nb) == (jc.n, jc.k, jc.mb, jc.nb)
    assert interop.ldpc_code_from_reference(jc) == tc
    assert kh.supported(tc)
    edges = kh.edge_lists(tc)[0]
    assert len(edges) <= 65 and kh.smem_bytes(tc) <= kh.SMEM_BYTES


@pytest.mark.parametrize("rate", ["1/2", "3/4", "8,4"])
def test_encode_and_syndrome_match_jax(rng, rate):
    jc, tc = _codes(rate)
    info = rng.integers(0, 2, (2, 3, tc.k)).astype(np.int8)
    want = np.asarray(jl.ldpc_encode(jc, jnp.asarray(info)))
    got = tl.ldpc_encode(tc, torch.from_numpy(info))
    assert got.dtype == torch.int8 and got.shape == (2, 3, tc.n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(tl.ldpc_syndrome(tc, got).any())
    bad = got.clone()
    bad[0, 0, 5] ^= 1
    syn = tl.ldpc_syndrome(tc, bad)
    want_syn = jl.ldpc_syndrome(jc, jnp.asarray(bad.numpy()))
    np.testing.assert_array_equal(syn.numpy(), np.asarray(want_syn))
    assert int(syn[0, 0].sum()) == 3  # an information column has weight 3


@pytest.mark.parametrize("n", [7, 3072, 16384])
def test_interleave_matches_jax_and_round_trips(rng, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    np.testing.assert_array_equal(til._perm(n, til.SEED)[0], j_perm(n, 0x1EAF)[0])
    got = til.interleave(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_interleave(jnp.asarray(x))))
    np.testing.assert_array_equal(til.deinterleave(got).numpy(), x)
    np.testing.assert_array_equal(til.deinterleave(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_deinterleave(jnp.asarray(x))))


def test_flooding_plain_matches_jax_jnp_stock_code(rng):
    """Stock rate-1/2 code, 8 codewords, 15 iterations, at an operating
    point with residual errors."""
    jc, tc = _codes("1/2")
    _, cw, llr = _noisy_llr(rng, tc, 8, 0.8)
    want = np.asarray(jl.ldpc_decode(jc, jnp.asarray(llr), iters=15, backend="jnp"))
    got = tl.ldpc_decode(tc, torch.from_numpy(llr), iters=15)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != cw).any() and (want == cw).all(axis=1).any()


def test_flooding_plain_matches_sublane_kernel(rng):
    jc, tc = _codes("8,4")
    _, cw, llr = _noisy_llr(rng, tc, 128, 0.8)
    want = np.asarray(ldpc_decode_pallas_sublane(jc, jnp.asarray(llr), iters=15, interpret=True))
    got = kh.decode_flooding_plain(tc, torch.from_numpy(llr), 15, 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != cw).any()


def test_flooding_plain_matches_lane_kernel(rng):
    jc, tc = _codes("8,4")
    _, _, llr = _noisy_llr(rng, tc, 8, 0.8)
    want = np.asarray(ldpc_decode_pallas(jc, jnp.asarray(llr), iters=15, interpret=True))
    np.testing.assert_array_equal(tl.ldpc_decode(tc, torch.from_numpy(llr), iters=15).numpy(),
                                  want)


def test_layered_plain_matches_sublane_kernel(rng):
    jc, tc = _codes("8,4")
    _, cw, llr = _noisy_llr(rng, tc, 128, 0.8)
    want = np.asarray(ldpc_decode_pallas_sublane(jc, jnp.asarray(llr), iters=8,
                                                 schedule="layered", interpret=True))
    got = tl.ldpc_decode(tc, torch.from_numpy(llr), iters=8, schedule="layered")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != cw).any()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_transposed_layout_equals_rows(rng, schedule):
    tc = ldpc_code_for("2/3")
    _, _, llr = _noisy_llr(rng, tc, 5, 0.7)
    rows = tl.ldpc_decode(tc, torch.from_numpy(llr), iters=6, schedule=schedule)
    t = tl.ldpc_decode_t(tc, torch.from_numpy(np.ascontiguousarray(llr.T)), iters=6,
                         schedule=schedule)
    assert t.shape == (tc.n, 5)
    torch.testing.assert_close(t.T, rows, rtol=0, atol=0)
    # Batch shape (..., n) decodes codeword by codeword.
    nd = tl.ldpc_decode(tc, torch.from_numpy(llr.reshape(5, 1, tc.n)), iters=6,
                        schedule=schedule)
    torch.testing.assert_close(nd.reshape(5, tc.n), rows, rtol=0, atol=0)


def test_layered_schedule_waterfall(rng):
    """Layered at about half the iterations matches the flooding waterfall
    (the JAX gate, tests/test_ldpc.py:169-208, on the plain versions):
    info-bit errors within 30 % (or 20 bits), and clean codewords decode
    exactly."""
    tc = tl.make_qc_ldpc(8, 4, 128)
    esno = 10 ** (2.0 / 10.0) * tc.rate
    sigma = float(np.sqrt(1.0 / (2.0 * esno)))
    info, cw, llr = _noisy_llr(rng, tc, 256, sigma)
    flood = tl.ldpc_decode(tc, torch.from_numpy(llr), iters=24).numpy()
    lay = tl.ldpc_decode(tc, torch.from_numpy(llr), iters=12, schedule="layered").numpy()
    be_f = int((flood[:, :tc.k] != info).sum())
    be_l = int((lay[:, :tc.k] != info).sum())
    assert be_f > 0
    assert abs(be_l - be_f) <= max(0.3 * be_f, 20)
    clean = torch.from_numpy(2.0 * (1.0 - 2.0 * cw.astype(np.float32)) * 50.0)
    out = tl.ldpc_decode(tc, clean, iters=4, schedule="layered")
    np.testing.assert_array_equal(out.numpy(), cw)


def test_decode_rejects_bad_inputs(rng):
    tc = ldpc_code_for("1/2")
    with pytest.raises(ValueError, match="llr length"):
        tl.ldpc_decode(tc, torch.zeros((2, tc.n - 1)))
    with pytest.raises(ValueError, match="schedule"):
        tl.ldpc_decode(tc, torch.zeros((2, tc.n)), schedule="serial")
    with pytest.raises(ValueError, match="expected"):
        tl.ldpc_decode_t(tc, torch.zeros((2, tc.n)))
    with pytest.raises(ValueError):
        tl.ldpc_encode(tc, torch.zeros((2, tc.k + 1), dtype=torch.int8))
    with pytest.raises(ValueError):
        tl.make_qc_ldpc(4, 4, 128)


def test_edge_tables_describe_the_code():
    """The kernel's by-value tables (``code_tables``, byte offsets into a
    block's shared memory): each base row's degree and first edge, each
    edge's shift and its total and message planes, each column's plane,
    degree and edges in e_by_col order."""
    tc = tl.make_qc_ldpc(8, 4, 128)
    edges, e_by_row, e_by_col = kh.edge_lists(tc)
    n_e, z = len(edges), tc.z
    t = list(kh.code_tables(tc))
    plane = 4 * z
    assert t[:4] == [tc.nb, tc.mb, n_e, z]
    rows, t = t[4:4 + 2 * kh.MAX_MB], t[4 + 2 * kh.MAX_MB:]
    assert [tuple(rows[2 * i:2 * i + 2]) for i in range(tc.mb)] == [
        (len(r), r[0]) for r in e_by_row]
    etab, t = t[:4 * kh.MAX_E], t[4 * kh.MAX_E:]
    for e, (_, j, s) in enumerate(edges):
        assert etab[4 * e:4 * e + 4] == [4 * s, (n_e + j) * plane, e * plane, 0]
    ctab, t = t[:2 * kh.MAX_NB], t[2 * kh.MAX_NB:]
    assert [tuple(ctab[2 * j:2 * j + 2]) for j in range(tc.nb)] == [
        ((n_e + j) * plane, len(col)) for j, col in enumerate(e_by_col)]
    assert len(t) == kh.MAX_NB * kh.MAX_COL_DEG
    assert [[v // plane for v in t[3 * j:3 * j + len(col)]] for j, col in
            enumerate(e_by_col)] == e_by_col
    assert 4 * len(kh.code_tables(tc)) == 2960  # sizeof(LdpcCode) in csrc/ldpc.cu


def _code_with(base, z=8):
    return tl.QcLdpcCode(tuple(tuple(r) for r in base), z)


@pytest.mark.parametrize("case,limit", [
    ("column degree", "column degree 4 > 3"),
    ("row degree", "row degree 17 > 16"),
    ("z", "Z = 2048 outside 1..1024"),
    ("nb", "nb = 33 > 32 base columns"),
    ("state", "bytes of state per codeword"),
])
def test_kernel_limits_are_named(case, limit):
    """Codes beyond kernel H's tables, unrolled loops or shared memory are
    refused by name (``unsupported``); the plain decoder takes them all."""
    if case == "column degree":
        code = _code_with([[0, 0, -1], [1, -1, 0], [2, 0, -1], [3, -1, 0]])
    elif case == "row degree":
        code = _code_with([[0] * 17 + [-1], [-1] * 17 + [0]])
    elif case == "z":
        code = tl.make_qc_ldpc(8, 4, 2048)
    elif case == "nb":
        code = _code_with([[0] * 16 + [-1] * 17, [-1] * 16 + [0] * 17])
    else:
        code = tl.make_qc_ldpc(24, 12, 1024)
    why = kh.unsupported(code)
    assert why is not None and limit in why and not kh.supported(code)
    llr = torch.ones((2, code.n))
    assert torch.equal(kh.ldpc_decode(code, llr, 1, 0.5), torch.zeros((2, code.n), dtype=torch.int8))


@pytest.mark.parametrize("rate", RATES + ["8,4", "z100"])
def test_launch_configurations_fit(rate):
    """The kernel's launch (one codeword a block, a thread per lifted row)
    fits every stock code, a code with Z not a multiple of 32 and the
    widest Z: the block's state, (E + nb)·Z floats, within shared memory."""
    code = tl.make_qc_ldpc(8, 4, 100) if rate == "z100" else _codes(rate)[1]
    n_e = len(kh.edge_lists(code)[0])
    assert kh.supported(code) and code.z <= kh.MAX_Z
    assert kh.smem_bytes(code) == 4 * (n_e + code.nb) * code.z <= kh.SMEM_BYTES
    wide = tl.make_qc_ldpc(8, 4, kh.MAX_Z)
    assert kh.supported(wide) and kh.smem_bytes(wide) <= kh.SMEM_BYTES
