"""The port's coded links (sdr_tpu_torch.link.coded) on the CPU, held
against the JAX ``sdr_tpu.link.coded``.

- Each family's link (conv, LDPC, polar) on each channel's own JAX
  draws gives the JAX link's decoded information bits, bit for bit. The
  draws are regenerated from each channel's key ``fold_in(PRNGKey(seed),
  c)`` as the JAX link makes them — the info bits (``bernoulli`` of the
  ``ROLE_PAYLOAD`` key), the fading and the noise (``ROLE_FADING``,
  ``ROLE_NOISE``; ``mimo_llr_link``'s for the MIMO link) — and injected
  into the port (``info=``, ``fading=``, ``noise=``). The JAX side is the
  JAX link's own code path, ``_frame_llrs`` per channel, then its
  deinterleave and decoders (the decoders compiled once over padded
  batches); for each family one case also holds that path's per-channel
  errors equal to the JAX ``_coded_one`` / ``_ldpc_one`` / ``_polar_one``
  themselves. Cases: AWGN, RAYLEIGH_FLAT, MULTIPATH with comb pilots and
  the DFT estimate, block-pilot SC-FDMA on MULTIPATH, Alamouti 2 × 2 with
  preamble CSI. The two packages' LLRs differ by float32 rounding (the
  noise is scaled in another order); no decoder decision sits that close
  to a tie on these draws, which the equality checks.
- The JAX coded-link gates (``tests/test_fec.py:84-100`` and :144-172,
  ``tests/test_ldpc.py:86-95``, ``tests/test_obs.py:65-91``,
  ``tests/test_scfdma.py:328-380``, ``tests/test_mimo.py:931-994``) on the
  port's own keyed draws at the JAX tests' sizes, with the JAX tests' key
  numbers as seeds.
- Frame fit, the family dispatch, the polar decode passes and the scan
  decoder switch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.core import prng as jprng
from sdr_tpu.link import coded as jcoded
from sdr_tpu.ops import channel as jchan
from sdr_tpu.ops import fec as jfec
from sdr_tpu.ops.interleave import deinterleave as j_deinterleave
from sdr_tpu.ops.interleave import interleave as j_interleave
from sdr_tpu.ops import ldpc as jldpc
from sdr_tpu.ops import polar as jpolar
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelEstimator,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOConfig,
    MIMOScheme,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.link import coded, pipeline
from sdr_tpu_torch.link.ber import ber_awgn_exact
from sdr_tpu_torch.obs.sweep import ebno_sweep

torch.set_num_threads(1)

SEED = 23
JM = jcfg.ChannelModel


def _t(a):
    return torch.from_numpy(np.array(a))


def _jcfg(model=JM.AWGN, mod=jcfg.Modulation.QPSK, ebno_db=0.0, n_symbols=16, n_channels=3,
          n_fft=128, equalizer=jcfg.Equalizer.MMSE, mimo=None, **kw):
    channel = {k: kw.pop(k) for k in ("pdp",) if k in kw}
    return jcfg.LinkConfig(modulation=mod, ofdm=jcfg.OFDMConfig(n_fft, 16),
                           channel=jcfg.ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                           equalizer=equalizer, n_symbols=n_symbols, n_channels=n_channels,
                           mimo=mimo, **kw)


# Each case near its waterfall, so that every family decodes wrong bits on
# some channel and the comparison covers wrong decisions.
CASES = {
    "awgn": _jcfg(ebno_db=-2.0, equalizer=jcfg.Equalizer.NONE),
    "rayleigh_flat": _jcfg(JM.RAYLEIGH_FLAT, ebno_db=2.0, n_channels=4),
    "multipath_comb_dft": _jcfg(JM.MULTIPATH, jcfg.Modulation.QAM16, 5.0, pdp=(1.0, 0.4),
                                pilot_spacing=8, estimator=jcfg.ChannelEstimator.DFT),
    "scfdma_block": _jcfg(JM.MULTIPATH, ebno_db=1.0, n_symbols=32, pdp=(1.0, 0.3),
                          pilot_spacing=8, dft_spread=True),
    "alamouti_preamble": _jcfg(JM.RAYLEIGH_FLAT, ebno_db=0.0, n_channels=4,
                               mimo=jcfg.MIMOConfig(jcfg.MIMOScheme.ALAMOUTI, 2, 2,
                                                    csi="preamble")),
}
FAMILIES = ("conv", "ldpc", "polar")
LDPC_ITERS = 25
POLAR_LIST = 8


def _keys(ref):
    return jax.vmap(lambda c: jax.random.fold_in(jax.random.PRNGKey(SEED), c))(
        jnp.arange(ref.n_channels))


@functools.lru_cache(maxsize=None)
def _draws(name):
    """(port cfg, the channels' JAX fading and noise in the port's injection
    forms)."""
    ref = CASES[name]
    cfg = interop.link_config_from_reference(ref)
    L = ref.ofdm.n_fft + ref.ofdm.cp_len
    ch = ref.channel

    if ref.mimo is not None:
        mc = ref.mimo
        n = pipeline.n_tx_symbols(cfg) * L

        def one(key):
            f = jchan.rayleigh_flat(jprng.role_key(key, jprng.ROLE_FADING),
                                    (mc.n_rx, mc.n_tx))[..., None]
            kr, ki = jax.random.split(jprng.role_key(key, jprng.ROLE_NOISE))
            return f, jax.random.normal(kr, (mc.n_rx, n)), jax.random.normal(ki, (mc.n_rx, n))

        f, nre, nim = (np.asarray(t) for t in jax.jit(jax.vmap(one))(_keys(ref)))
        B = ref.n_channels
        noise = tuple(_t(t.reshape(B, -1, L)) for t in (nre, nim))
        return cfg, dict(fading=_t(f), noise=noise)

    def one(key):
        kf = jprng.role_key(key, jprng.ROLE_FADING)
        if ch.model == JM.RAYLEIGH_FLAT:
            fade = jchan.rayleigh_flat(kf, ())
        elif ch.model == JM.MULTIPATH:
            fade = jchan.multipath_taps(kf, ch.pdp)
        else:
            fade = jnp.zeros((), jnp.complex64)
        kr, ki = jax.random.split(jprng.role_key(key, jprng.ROLE_NOISE))
        shape = (ref.n_symbols, L)
        return fade, jax.random.normal(kr, shape), jax.random.normal(ki, shape)

    fade, nre, nim = (np.asarray(t) for t in jax.jit(jax.vmap(one))(_keys(ref)))
    B = ref.n_channels
    fading = None
    if ch.model == JM.RAYLEIGH_FLAT:
        fading = (_t(fade.reshape(B, 1, 1)), None)
    elif ch.model == JM.MULTIPATH:
        fading = (None, _t(fade))
    return cfg, dict(fading=fading, noise=(_t(nre), _t(nim)))


def _jax_info(ref, shape):
    """Each channel's info bits as the JAX link draws them."""
    return np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        jprng.role_key(k, jprng.ROLE_PAYLOAD), 0.5, shape).astype(jnp.int8))(_keys(ref)))


@functools.lru_cache(maxsize=None)
def _jax_link_llrs(name, family):
    """The JAX link's code path per channel up to the decoder: (info, the
    deinterleaved LLRs of the sent bits (B, sent))."""
    ref = CASES[name]
    fb = ref.n_data_symbols * ref.bits_per_ofdm_symbol
    if family == "conv":
        n_info = jcoded.info_bits_per_channel(ref)
        info = _jax_info(ref, (n_info,))
        cw = jax.jit(jax.vmap(lambda i: jfec.puncture(jfec.conv_encode(i), "1/2")))(info)
    elif family == "ldpc":
        code = jcoded.ldpc_code_for("1/2")
        n_cw = jcoded.ldpc_codewords_per_channel(ref, code)
        info = _jax_info(ref, (n_cw, code.k))
        cw = jax.jit(jax.vmap(lambda i: jldpc.ldpc_encode(code, i).reshape(-1)))(info)
    else:
        code = jcoded.polar_code_for("1/2")
        n_cw = jcoded.polar_codewords_per_channel(ref, code.block_len)
        info = _jax_info(ref, (n_cw, code.payload_len))
        cw = jax.jit(jax.vmap(lambda i: jpolar.polar_encode_payload(i, code).reshape(-1)))(info)
    sent = cw.shape[-1]

    def one(key, c):
        frame = j_interleave(jnp.zeros((fb,), jnp.int8).at[:sent].set(c))
        return j_deinterleave(jcoded._frame_llrs(ref, key, frame))[:sent]

    return np.asarray(info), np.asarray(jax.jit(jax.vmap(one))(_keys(ref), cw))


@functools.lru_cache(maxsize=None)
def _jax_decoder(family, n):
    """The JAX link's decoder over a padded batch, compiled once per family
    (and per n_info for Viterbi)."""
    if family == "conv":
        return jax.jit(jax.vmap(lambda x: jfec.viterbi_decode(jfec.depuncture(x, "1/2", n + 6),
                                                              n)))
    if family == "ldpc":
        code = jcoded.ldpc_code_for("1/2")
        return jax.jit(lambda x: jldpc.ldpc_decode(code, x, iters=LDPC_ITERS))
    code = jcoded.polar_code_for("1/2")
    return jax.jit(lambda x: jpolar.polar_decode_scl_fast(x, code, list_size=POLAR_LIST))


def _pad_rows(x, rows):
    return np.concatenate([x, np.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)])


def _jax_decoded(name, family):
    """(info, the JAX link's decoded bits) per channel."""
    info, llr = _jax_link_llrs(name, family)
    B = info.shape[0]
    if family == "conv":
        return info, np.asarray(_jax_decoder("conv", info.shape[-1])(llr))
    if family == "ldpc":
        code = jcoded.ldpc_code_for("1/2")
        flat = llr.reshape(-1, code.n)
        dec = np.asarray(_jax_decoder("ldpc", 0)(jnp.asarray(_pad_rows(flat, 16))))
        return info, dec[:flat.shape[0], :code.k].reshape(info.shape)
    flat = llr.reshape(-1, 256)
    dec = np.asarray(_jax_decoder("polar", 0)(jnp.asarray(_pad_rows(flat, 128))))
    return info, dec[:flat.shape[0]].reshape(B, -1, info.shape[-1])


def _port_link(cfg, family, info, draws):
    ids = torch.arange(cfg.n_channels, dtype=torch.int32)
    if family == "conv":
        return coded.conv_link(cfg, SEED, ids, info=_t(info), **draws)
    if family == "ldpc":
        return coded.ldpc_link(cfg, SEED, ids, iters=LDPC_ITERS, info=_t(info), **draws)
    return coded.polar_link(cfg, SEED, ids, list_size=POLAR_LIST, info=_t(info), **draws)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(CASES))
def test_link_decodes_what_the_jax_link_decodes(name, family):
    cfg, draws = _draws(name)
    info, want = _jax_decoded(name, family)
    got, sent = _port_link(cfg, family, info, draws)
    assert torch.equal(sent, _t(info))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != info).any()  # the comparison covers wrong decisions


_JAX_ONE = {
    "conv": lambda ref: functools.partial(jcoded._coded_one, ref,
                                          n_info=jcoded.info_bits_per_channel(ref),
                                          polys=jfec.DEFAULT_POLYS, K=jfec.DEFAULT_K,
                                          rate="1/2"),
    "ldpc": lambda ref: functools.partial(
        jcoded._ldpc_one, ref, code=jcoded.ldpc_code_for("1/2"),
        n_cw=jcoded.ldpc_codewords_per_channel(ref, jcoded.ldpc_code_for("1/2")),
        iters=LDPC_ITERS),
    "polar": lambda ref: functools.partial(
        jcoded._polar_one, ref, code=jcoded.polar_code_for("1/2"),
        n_cw=jcoded.polar_codewords_per_channel(ref, 256), list_size=POLAR_LIST),
}


@pytest.mark.parametrize("family,name", [("conv", "awgn"), ("ldpc", "rayleigh_flat"),
                                         ("polar", "scfdma_block")])
def test_jax_code_path_is_the_jax_link(family, name):
    """The JAX side of the parity test counts the errors of the JAX
    ``_coded_one`` / ``_ldpc_one`` / ``_polar_one`` per channel."""
    ref = CASES[name]
    info, dec = _jax_decoded(name, family)
    errors, counted = jax.jit(jax.vmap(_JAX_ONE[family](ref)))(_keys(ref))
    np.testing.assert_array_equal(np.asarray(errors),
                                  (dec != info).reshape(info.shape[0], -1).sum(1))
    assert int(np.asarray(errors).sum()) > 0
    assert np.all(np.asarray(counted) == info[0].size)


# ---- the JAX tests' link gates on the port's draws --------------------------------------

def _cfg(mod=Modulation.QPSK, n_fft=64, ebno_db=4.0, n_symbols=64, n_channels=16,
         model=ChannelModel.AWGN, **kw):
    """A JAX test's link (its equalizer only where it names one)."""
    channel = ChannelConfig(model=model, ebno_db=ebno_db, **kw.pop("channel", {}))
    return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=n_fft, cp_len=16), channel=channel,
                      n_symbols=n_symbols, n_channels=n_channels, **kw)


def _ber(e, c):
    return int(e.sum()) / int(c.sum())


def test_coded_link_beats_uncoded_awgn():
    """tests/test_fec.py:84-100: rate 1/2 K 7 over QPSK/AWGN at 4 dB, at
    least 10× under the uncoded 1.25e-2 on information bits."""
    cfg = _cfg()
    assert coded.info_bits_per_channel(cfg) == 64 * 64 * 2 // 2 - 6
    ber = _ber(*coded.make_coded_fn(cfg, device="cpu")(3))
    assert ber < ber_awgn_exact(Modulation.QPSK, 4.0) / 10.0


def test_coded_link_rate_ordering():
    """tests/test_fec.py:144-172: BER(1/2) ≤ BER(2/3) ≤ BER(3/4) at 3 dB,
    rate 1/2 under 5e-3."""
    cfg = _cfg(ebno_db=3.0, n_symbols=32)
    bers = {rate: _ber(*coded.simulate_coded(cfg, 2, device="cpu", rate=rate))
            for rate in ("1/2", "2/3", "3/4")}
    assert bers["1/2"] <= bers["2/3"] <= bers["3/4"]
    assert bers["1/2"] < 5e-3


def test_ldpc_link_beats_uncoded():
    """tests/test_ldpc.py:86-95: no info-bit error at 4 dB AWGN where the
    uncoded link errs over a hundred times."""
    cfg = _cfg(n_fft=128, n_symbols=16, n_channels=8, equalizer=Equalizer.NONE)
    err, cnt = coded.make_ldpc_fn(cfg, device="cpu")(0)
    assert int(err.sum()) == 0
    assert int(cnt.sum()) == 8 * 1536
    assert int(pipeline.simulate(cfg, 0, device="cpu").bit_errors.sum()) > 100


def test_sweep_coded_families():
    """tests/test_obs.py:65-91: each family's point at 5 dB under uncoded
    theory, one checkpoint summary per family, the fast engine refused."""
    cfg = _cfg(n_fft=128, ebno_db=5.0, n_symbols=16, n_channels=4)
    summaries = set()
    for fam in ("conv", "polar"):
        res = ebno_sweep(cfg, [5.0], seed=1, target_errors=1, max_bits=10_000, code=fam,
                         device="cpu")
        summaries.add(res.config_summary)
        assert res.config_summary.endswith(f"/{fam}-1/2/torch")
        assert res.points[0].ber < res.theory(Modulation.QPSK)[0]
    assert len(summaries) == 2
    with pytest.raises(ValueError, match="pipeline"):
        ebno_sweep(cfg, [5.0], seed=1, code="conv", engine="fast", device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_scfdma_coded_families(family):
    """tests/test_scfdma.py:328-355: every family through the block-pilot
    SC-FDMA receiver; at least 6 of 8 channels error-free."""
    base = _cfg(n_fft=128, ebno_db=14.0, n_symbols=32, n_channels=8,
                model=ChannelModel.MULTIPATH, channel=dict(pdp=(1.0, 0.3)),
                equalizer=Equalizer.MMSE, pilot_spacing=8, dft_spread=True)
    e, _ = coded.make_family_fn(base, family, device="cpu")(2)
    assert int((e == 0).sum()) >= 6, e.tolist()


def test_polar_composes_with_mimo():
    """tests/test_scfdma.py:358-380: (256, 128) over Alamouti 2 × 2 with
    preamble CSI at 10 dB, at most 10 payload errors."""
    cfg = _cfg(n_fft=128, ebno_db=10.0, n_symbols=16, n_channels=8,
               model=ChannelModel.RAYLEIGH_FLAT, equalizer=Equalizer.MMSE,
               mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"))
    e, t = coded.make_polar_fn(cfg, list_size=4, device="cpu")(1)
    assert int(t.sum()) > 0
    assert int(e.sum()) <= 10


_MIMO_BASE = dict(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                  channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=5.0),
                  equalizer=Equalizer.MMSE, n_symbols=16, n_channels=2048)


def test_coded_mimo_frame_capacity():
    """tests/test_mimo.py:931-946: the mux frame carries about twice the
    SISO/diversity payload."""
    div = coded.info_bits_per_channel(LinkConfig(**_MIMO_BASE,
                                                 mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2)))
    mux = coded.info_bits_per_channel(LinkConfig(**_MIMO_BASE,
                                                 mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2)))
    siso = coded.info_bits_per_channel(LinkConfig(**_MIMO_BASE))
    assert div == siso
    assert mux > 1.9 * siso


@pytest.mark.parametrize("mimo", [MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2),
                                  MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml")],
                         ids=["alamouti", "mux_ml"])
def test_coded_mimo_waterfall(mimo):
    """tests/test_mimo.py:949-970: conv-coded MIMO at 8 dB, 64 channels,
    under a tenth of the uncoded BER (seed 0 for both)."""
    cfg = LinkConfig(**{**_MIMO_BASE,
                        "channel": dataclasses.replace(_MIMO_BASE["channel"], ebno_db=8.0),
                        "n_channels": 64}, mimo=mimo)
    coded_ber = _ber(*coded.make_coded_fn(cfg, device="cpu")(0))
    res = pipeline.simulate(cfg, 0, device="cpu")
    uncoded_ber = _ber(res.bit_errors, res.bits_counted)
    assert coded_ber < 0.1 * max(uncoded_ber, 1e-9), (coded_ber, uncoded_ber)


def test_ldpc_mimo_runs():
    """tests/test_mimo.py:973-994: LDPC over 2 × 2 spatial mux with ML
    detection on the preamble's DFT estimate, 10 dB, under 5e-3."""
    cfg = LinkConfig(**{**_MIMO_BASE,
                        "channel": dataclasses.replace(_MIMO_BASE["channel"], ebno_db=10.0),
                        "n_channels": 16, "n_symbols": 48,
                        "estimator": ChannelEstimator.DFT},
                     mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble",
                                     detector="ml"))
    ber = _ber(*coded.make_ldpc_fn(cfg, rate="1/2", iters=20, device="cpu")(1))
    assert ber < 5e-3, ber


# ---- structure -----------------------------------------------------------------------------

def test_frame_fit_and_dispatch():
    small = _cfg(n_fft=64, n_symbols=2, n_channels=2)  # 256 bits a frame
    with pytest.raises(ValueError, match="cannot fit an n=3072"):
        coded.make_family_fn(small, "ldpc", device="cpu")
    with pytest.raises(ValueError, match="N=512"):
        coded.make_family_fn(small, "polar", block_len=512, device="cpu")
    with pytest.raises(ValueError, match="family must be"):
        coded.make_family_fn(small, "turbo", device="cpu")
    with pytest.raises(ValueError, match="family must be"):
        coded.family_info_rate("turbo", "1/2")
    for fam, rate in (("conv", "2/3"), ("ldpc", "3/4"), ("polar", "1/2"), ("polar", "3/4")):
        assert coded.family_info_rate(fam, rate) == jcoded.family_info_rate(fam, rate)
    assert coded.polar_params("2/3") == jcoded.polar_params("2/3")
    assert coded.CODE_FAMILIES == jcoded.CODE_FAMILIES
    e, c = coded.make_family_fn(small, "conv", rate="3/4", device="cpu")(5)
    want = coded.simulate_coded(small, 5, device="cpu", rate="3/4")
    assert torch.equal(e, want[0]) and torch.equal(c, want[1])


@pytest.mark.parametrize("family", FAMILIES)
def test_split_equals_full(family):
    """Keyed by (seed, global channel id): channels [2, 5) alone count what
    they count in the whole run."""
    cfg = _cfg(n_fft=128, ebno_db=-2.0, n_symbols=16, n_channels=6, equalizer=Equalizer.NONE)
    core = coded.family_core(cfg, family)
    full = core(SEED, torch.arange(6, dtype=torch.int32))
    part = core(SEED, torch.arange(2, 5, dtype=torch.int32))
    assert torch.equal(part[0], full[0][2:5]) and torch.equal(part[1], full[1][2:5])
    assert int(full[0].sum()) > 0


def test_polar_passes_and_the_scan_switch(monkeypatch):
    """The decode in passes of one channel, and the bit-serial decoder
    under SDR_TPU_POLAR_DECODER=scan, decode what one fast pass does."""
    cfg = _cfg(n_fft=128, ebno_db=-2.0, n_symbols=8, n_channels=3, equalizer=Equalizer.NONE)
    whole = coded.simulate_polar(cfg, SEED, device="cpu", list_size=4)
    assert coded.polar_pass_channels(coded.polar_code_for(), 8, 4) > 3
    monkeypatch.setattr(coded, "POLAR_PASS_ELEMS", 1)
    assert coded.polar_pass_channels(coded.polar_code_for(), 8, 4) == 1
    for a, b in zip(coded.simulate_polar(cfg, SEED, device="cpu", list_size=4), whole):
        assert torch.equal(a, b)
    monkeypatch.setenv("SDR_TPU_POLAR_DECODER", "scan")
    assert coded.polar_decoder() is coded.polar_decode_scl
    for a, b in zip(coded.simulate_polar(cfg, SEED, device="cpu", list_size=4), whole):
        assert torch.equal(a, b)
    assert int(whole[0].sum()) > 0


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (coded.simulate_coded, coded.simulate_ldpc, coded.simulate_polar,
               coded.make_coded_fn, coded.make_ldpc_fn, coded.make_polar_fn,
               coded.make_family_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            coded.make_family_fn(_cfg(n_symbols=2, n_channels=2), "conv")(0)
