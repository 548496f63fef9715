"""The port's coded fast engine (sdr_tpu_torch.link.fast_coded).

- The seam identity: the port's composed row permutation applied to a
  kernel-order LLR plane equals the deinterleave of the public plane,
  exactly (the JAX package's tests/test_fast_coded.py:46-59, on the
  port's own kernel order).
- The slice against JAX on injected state: the same info bits, channel
  gains and N(0, 1) noise planes through the port's ``ldpc_fast_core``
  (CPU, staged seam) and through a JAX chain built here (ldpc_encode →
  interleave → _frame_to_idx → tx_chain_pallas and fade_awgn_pallas in
  interpret mode → demod_chain_jnp → deinterleave → ldpc_decode): per-
  channel info-bit errors equal, a difference allowed only in a channel
  whose codewords hold an LLR with |LLR| < 1e-3 on either side.
- Engine behaviour (the JAX tests/test_fast_coded.py): the seams agree
  within max(8, 1 %) of errors at RAYLEIGH_FLAT 9 dB, split == full,
  coded BER < uncoded/3 at AWGN 6 dB, layered runs, every rate runs,
  pilots, MIMO and SC-FDMA raise, the entry points default to the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.kernels.channel_pallas import fade_awgn_pallas
from sdr_tpu.kernels.tx_pallas import tx_chain_pallas
from sdr_tpu.link.coded import ldpc_code_for as j_code_for
from sdr_tpu.link.fast_coded import _frame_to_idx as j_frame_to_idx
from sdr_tpu.ops.demod import demod_chain_jnp
from sdr_tpu.ops.interleave import deinterleave as j_deinterleave
from sdr_tpu.ops.interleave import interleave as j_interleave
from sdr_tpu.ops.ldpc import ldpc_decode as j_decode
from sdr_tpu.ops.ldpc import ldpc_encode as j_encode
from sdr_tpu_torch import interop
from sdr_tpu_torch.core import prng
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.kernels import demod_cl as kd
from sdr_tpu_torch.kernels.demod import demod_chain
from sdr_tpu_torch.link import fast
from sdr_tpu_torch.link import fast_coded as fc
from sdr_tpu_torch.ops.interleave import deinterleave

torch.set_num_threads(1)


def _cfg(model=ChannelModel.RAYLEIGH_FLAT, ebno=9.0, n_ch=128, n_syms=6, n_fft=128, **kw):
    return LinkConfig(
        ofdm=OFDMConfig(n_fft=n_fft, cp_len=n_fft // 4), modulation=Modulation.QAM16,
        channel=ChannelConfig(model=model, ebno_db=ebno), equalizer=Equalizer.MMSE,
        n_channels=n_ch, n_symbols=n_syms, **kw,
    )


def test_fused_rowperm_is_deinterleave_of_public(rng):
    """The composed permutation == deinterleave ∘ public-order restore of
    the port's kernel order (exact: a layout identity)."""
    N, S, bps, sent = 128, 4, 4, 3072
    rp = fc._fused_rowperm(N, S, bps, sent, 0x1EAF)
    plane = torch.from_numpy(rng.standard_normal((S * bps * N, 8)).astype(np.float32))
    pub = kd.kernel_to_public(plane, S, bps, N).reshape(8, S * N * bps)
    want = deinterleave(pub)[:, :sent].T
    torch.testing.assert_close(plane[torch.from_numpy(rp)], want, rtol=0, atol=0)


def test_frame_to_idx_matches_jax(rng):
    bits = rng.integers(0, 2, (3, 12 * 64)).astype(np.int8)
    for bps in (1, 2, 4, 6, 8, 10):
        want = np.asarray(j_frame_to_idx(jnp.asarray(bits[:, : (bits.shape[1] // bps) * bps]),
                                         bps))
        got = fc._frame_to_idx(torch.from_numpy(bits[:, : (bits.shape[1] // bps) * bps]), bps)
        np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


@pytest.mark.parametrize("model,ebno", [(ChannelModel.AWGN, 3.0),
                                        (ChannelModel.RAYLEIGH_FLAT, 8.0)],
                         ids=["awgn", "rayleigh_flat"])
def test_slice_on_injected_state_matches_jax_chain(rng, model, ebno):
    B, S, N, cp, iters = 128, 12, 128, 32, 25
    cfg = _cfg(model, ebno, B, S, N)
    mod = cfg.modulation
    bps = mod.bits_per_symbol
    jc = j_code_for("1/2")
    n_cw = S * N * bps // jc.n
    sent = n_cw * jc.n
    nv = 1.0 / (10 ** (ebno / 10) * bps)
    info = rng.integers(0, 2, (B, n_cw, jc.k)).astype(np.int8)
    h = ((rng.standard_normal(B) + 1j * rng.standard_normal(B)) / np.sqrt(2)).astype(np.complex64)
    fade = model == ChannelModel.RAYLEIGH_FLAT
    n_re = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    n_im = rng.standard_normal((B, S, N + cp)).astype(np.float32)

    # JAX: encode → interleave → indices → TX kernel → channel kernel
    # (injected noise) → jnp demod → deinterleave → jnp decoder.
    jm = jcfg.Modulation(mod.value)
    cw = np.asarray(j_encode(jc, jnp.asarray(info))).reshape(B, sent)
    frame = np.zeros((B, S * N * bps), np.int8)
    frame[:, :sent] = cw
    idx = j_frame_to_idx(j_interleave(jnp.asarray(frame)), bps).reshape(B, S, N)
    jre, jim = tx_chain_pallas(idx, cp, jm, interpret=True)
    hr_s = np.real(h)[:, None].astype(np.float32)
    hi_s = np.imag(h)[:, None].astype(np.float32)
    jre, jim = fade_awgn_pallas(
        jre, jim, jnp.asarray(hr_s) if fade else None, jnp.asarray(hi_s) if fade else None,
        0, nv / N, noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True,
    )
    hb_r = np.broadcast_to(hr_s[:, :, None] if fade else np.ones((B, 1, 1), np.float32),
                           (B, 1, N)).astype(np.float32)
    hb_i = np.broadcast_to(hi_s[:, :, None] if fade else np.zeros((B, 1, 1), np.float32),
                           (B, 1, N)).astype(np.float32)
    j_llr = demod_chain_jnp(jre, jim, jnp.asarray(hb_r), jnp.asarray(hb_i), cp, jm, nv)
    j_llr_cw = j_deinterleave(j_llr.reshape(B, -1))[:, :sent].reshape(B * n_cw, jc.n)
    j_dec = np.asarray(j_decode(jc, j_llr_cw, iters=iters)).reshape(B, n_cw, jc.n)
    want = (j_dec[:, :, :jc.k] != info).sum(axis=(1, 2))

    # Port: the same state through the engine's own core.
    st = interop.channel_state(h=h if fade else None, noise=(n_re, n_im))
    ids = torch.arange(B, dtype=torch.int32)
    errors, counted = fc.ldpc_fast_core(cfg, 0, ids, iters=iters, seam="staged",
                                        info=torch.from_numpy(info), noise=st["noise"],
                                        h=st.get("h"))
    assert errors.dtype == torch.int32 and int(counted[0]) == n_cw * jc.k
    assert 0 < int(want.sum()) and (want == 0).any()

    # Channels with a near-zero LLR (|LLR| < 1e-3) on either side.
    re, im = fast.tx_with_channel(cfg, 0, ids, torch.as_tensor(np.array(idx)), h=st.get("h"),
                                  noise=st["noise"])
    llr = demod_chain(re, im, *interop.planes(hb_r, hb_i), cp, mod, nv).reshape(B, -1)
    near = ((llr.abs() < 1e-3).numpy() | (np.abs(np.asarray(j_llr).reshape(B, -1)) < 1e-3))
    near_ch = near.any(axis=1)
    diff = errors.numpy() != want
    assert not (diff & ~near_ch).any(), (errors.numpy()[diff], want[diff], near_ch.sum())
    assert int(diff.sum()) == 0, f"{int(diff.sum())} channels differ ({int(near_ch.sum())} near zero)"


def test_seams_agree_and_split_equals_full():
    cfg = _cfg()
    e_s, c = fc.ldpc_fast_simulate(cfg, 1, seam="staged", device="cpu")
    e_f, _ = fc.ldpc_fast_simulate(cfg, 1, seam="fused", device="cpu")
    tot = int(c.sum())
    ds, df = int(e_s.sum()), int(e_f.sum())
    assert 0 < ds < tot // 10
    assert abs(ds - df) <= max(8, ds // 100)
    lo, _ = fc.ldpc_fast_core(cfg, 1, torch.arange(0, 64, dtype=torch.int32), seam="staged")
    hi, _ = fc.ldpc_fast_core(cfg, 1, torch.arange(64, 128, dtype=torch.int32), seam="staged")
    torch.testing.assert_close(torch.cat([lo, hi]), e_s, rtol=0, atol=0)
    part, _ = fc.ldpc_fast_core(cfg, 1, torch.arange(5, 7, dtype=torch.int32), seam="fused")
    torch.testing.assert_close(part, e_f[5:7], rtol=0, atol=0)


def test_coded_beats_uncoded():
    """AWGN at 6 dB: the coded info-bit BER is far below the uncoded
    fast link's (per-link flat fading erases whole codewords)."""
    cfg = _cfg(ChannelModel.AWGN, 6.0)
    e_c, c_c = fc.ldpc_fast_simulate(cfg, 2, device="cpu")
    e_u, c_u = fast.fast_simulate(cfg, 2, device="cpu")
    ber_c = int(e_c.sum()) / int(c_c.sum())
    ber_u = int(e_u.sum()) / int(c_u.sum())
    assert ber_u > 0 and ber_c < ber_u / 3


def test_layered_schedule_runs():
    cfg = _cfg()
    e, c = fc.make_ldpc_fast_fn(cfg, iters=13, schedule="layered", device="cpu")(4)
    assert 0 < int(e.sum()) < int(c.sum()) // 8


@pytest.mark.parametrize("rate,n_cw", [("2/3", 2), ("3/4", 2)])
def test_other_rates_run(rate, n_cw):
    cfg = _cfg(ChannelModel.AWGN, 8.0, n_ch=8, n_syms=12)
    e, c = fc.ldpc_fast_simulate(cfg, 3, rate=rate, device="cpu")
    k = {"2/3": 2048, "3/4": 2304}[rate]
    assert int(c[0]) == n_cw * k and int(e.sum()) < int(c.sum()) // 100


@pytest.mark.parametrize(
    "kw", [dict(dft_spread=True), dict(pilot_spacing=4), dict(mimo=True)],
    ids=["dft_spread", "pilots", "mimo"],
)
def test_unsupported_configs_raise(kw):
    kw = dict(kw)
    if kw.pop("mimo", False):
        kw["mimo"] = MIMOConfig()
    cfg = _cfg(n_ch=4, **kw)
    with pytest.raises(NotImplementedError, match=r"run in link\.coded"):
        fc.ldpc_fast_simulate(cfg, 0, device="cpu")


def test_seam_rules():
    """Fused takes a per-link channel plane only; auto picks staged (the
    faster seam on the H100); the entry points default to the card and
    raise without one."""
    timevar = LinkConfig(
        ofdm=OFDMConfig(n_fft=128, cp_len=32), modulation=Modulation.QAM16,
        channel=ChannelConfig(model=ChannelModel.RAYLEIGH_TIME, ebno_db=9.0, doppler_norm=0.02),
        n_channels=4, n_symbols=6,
    )
    with pytest.raises(NotImplementedError, match="per-link"):
        fc.ldpc_fast_simulate(timevar, 0, seam="fused", device="cpu")
    e, _ = fc.ldpc_fast_simulate(timevar, 0, device="cpu")  # auto: staged
    assert e.shape == (4,)
    auto, _ = fc.ldpc_fast_simulate(_cfg(n_ch=4), 0, device="cpu")
    staged, _ = fc.ldpc_fast_simulate(_cfg(n_ch=4), 0, seam="staged", device="cpu")
    torch.testing.assert_close(auto, staged, rtol=0, atol=0)
    with pytest.raises(ValueError, match="seam"):
        fc.ldpc_fast_simulate(_cfg(n_ch=4), 0, seam="rows", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fc.ldpc_fast_simulate(_cfg(n_ch=4), 0)


def test_info_bits_keyed_and_balanced():
    """Bernoulli(0.5) info bits: a pure function of (seed, channel id,
    codeword, bit), independent of the payload draw's lane."""
    ids = torch.arange(40, 72, dtype=torch.int32)
    full = prng.info_bits(7, ids, 3, 1536)
    assert full.dtype == torch.int8 and full.shape == (32, 3, 1536)
    torch.testing.assert_close(prng.info_bits(7, ids[10:12], 3, 1536), full[10:12], rtol=0,
                               atol=0)
    assert abs(float(full.float().mean()) - 0.5) < 0.01
    short = prng.info_bits(7, ids[:2], 2, 100)
    torch.testing.assert_close(short, full[:2, :2, :100], rtol=0, atol=0)
    assert not torch.equal(prng.info_bits(8, ids, 3, 1536), full)
