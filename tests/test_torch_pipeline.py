"""The port's link pipeline (``sdr_tpu_torch.link.pipeline``) and blocked
stream (``sdr_tpu_torch.link.stream``) on the CPU, against the JAX
package's pipeline at ``__graft_entry__.entry()``'s scale (B ≤ 8, S ≤ 8,
N 64, CP 16).

- ``tx_chain``, ``apply_channel`` (injected fading and noise, all seven
  channel models, with and without a block's halo) and ``rx_chain``
  (MMSE, ZF, NONE, SC-FDE MMSE and the ZF despread, over every shape of
  h) against the JAX functions on the same numpy inputs;
- ``simulate`` against ``link.fast.fast_simulate`` on the same seed (the
  payload is kernel A's stream in both), split against full;
- ``stream_simulate`` against ``simulate`` for n_blocks 1, 2 and 4;
- what the pipeline refuses, naming its ROADMAP item (pilots run, the
  stream refuses them; ``tests/test_torch_pilots.py`` holds the pilot
  branches against JAX).

Tolerances (stated before the comparison): samples and equalised
responses at the reference's float tolerance, abs 1e-5 / rel 1e-6
(BASELINE.md:13-16); LLR planes at abs 1e-5 / rel 1e-6 of the plane
divided by its peak |LLR| (an LLR is a sample error scaled by up to
4|h|²/nv, the convention of ``tests/test_torch_kernels_plain.py``), with
hard bits equal but where the JAX |LLR| < 1e-3; error counts equal, or
differing per channel by no more than the bits whose plain |LLR| < 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.link import pipeline as jpipe
from sdr_tpu.ops import channel as jchan
from sdr_tpu_torch import interop
from sdr_tpu_torch.link import fast, pipeline, stream
from sdr_tpu_torch.ops.modulation import constellation, modulate

torch.set_num_threads(1)

B, S, N, CP = 4, 8, 64, 16
L = N + CP
PDP4 = (1.0, 0.5, 0.25, 0.125)  # __graft_entry__.entry()'s profile
PDP17 = tuple(0.8 ** k for k in range(CP + 1))  # cp + 1 taps: the staged route's widest
SEED = 18


def _cfgs(model=jcfg.ChannelModel.AWGN, mod=jcfg.Modulation.QAM16,
          equalizer=jcfg.Equalizer.MMSE, ebno_db=8.0, n_channels=B, n_symbols=S, **kw):
    """The same link in both packages: (JAX LinkConfig, the port's)."""
    channel = {k: kw.pop(k) for k in ("pdp", "doppler_norm", "k_factor") if k in kw}
    ref = jcfg.LinkConfig(modulation=mod, ofdm=jcfg.OFDMConfig(n_fft=N, cp_len=CP),
                          channel=jcfg.ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=equalizer, n_symbols=n_symbols, n_channels=n_channels, **kw)
    return ref, interop.link_config_from_reference(ref)


def _cn(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * (scale / np.sqrt(2))).astype(np.complex64)


def _planar(z):
    return (torch.from_numpy(np.ascontiguousarray(np.real(z)).astype(np.float32)),
            torch.from_numpy(np.ascontiguousarray(np.imag(z)).astype(np.float32)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-6)


def _assert_llrs_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got / peak, want / peak, atol=1e-5, rtol=1e-6)
    sure = np.abs(want) >= 1e-3
    np.testing.assert_array_equal((got < 0)[sure], (want < 0)[sure])


def _assert_counts_within(got, want, llrs):
    margin = (llrs.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((got - want).abs() <= margin).all()), (got, want, margin)


# ---- tx_chain ------------------------------------------------------------------

@pytest.mark.parametrize("dft_spread", [False, True], ids=["ofdm", "scfdma"])
@pytest.mark.parametrize("mod", [jcfg.Modulation.QPSK, jcfg.Modulation.QAM16],
                         ids=lambda m: m.value)
def test_tx_chain_matches_jax(rng, mod, dft_spread):
    ref, cfg = _cfgs(mod=mod, dft_spread=dft_spread)
    bits = rng.integers(0, 2, (B, S, cfg.bits_per_ofdm_symbol)).astype(np.int8)
    want = np.asarray(jpipe.tx_chain(ref, jnp.asarray(bits)))
    re, im = pipeline.tx_chain(cfg, torch.from_numpy(bits))
    assert re.shape == (B, S, L) and re.dtype == torch.float32
    _close(re, want.real)
    _close(im, want.imag)


def test_generate_bits_are_kernel_a_indices_in_modulate_order():
    """The bits map back to kernel A's indices: ``modulate`` of the bits is
    the constellation at A's indices, and the waveform of the bits is the
    waveform of the indices, for the whole frame and for a block."""
    _, cfg = _cfgs()
    ids = torch.arange(3, 3 + B, dtype=torch.int32)
    bits = pipeline.generate_bits(cfg, SEED, ids)
    idx = pipeline.draw_idx(cfg, SEED, ids)
    assert bits.shape == (B, S, N * 4) and bits.dtype == torch.int8
    torch.testing.assert_close(modulate(bits, cfg.modulation),
                               constellation(cfg.modulation)[idx.to(torch.int64)], rtol=0,
                               atol=0)
    for a, b in zip(pipeline.tx_chain(cfg, bits), pipeline.tx_idx(cfg, idx)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    block = pipeline.generate_bits(cfg, SEED, ids, s0=4, n_symbols=2)
    torch.testing.assert_close(block, bits[:, 4:6], rtol=0, atol=0)


# ---- apply_channel -------------------------------------------------------------

_MODELS = {
    "identity": (jcfg.ChannelModel.IDENTITY, {}),
    "awgn": (jcfg.ChannelModel.AWGN, {}),
    "rayleigh_flat": (jcfg.ChannelModel.RAYLEIGH_FLAT, {}),
    "rician": (jcfg.ChannelModel.RICIAN, dict(k_factor=2.5)),
    "rayleigh_time": (jcfg.ChannelModel.RAYLEIGH_TIME, dict(doppler_norm=0.03)),
    "multipath": (jcfg.ChannelModel.MULTIPATH, dict(pdp=PDP4)),
    "multipath_time": (jcfg.ChannelModel.MULTIPATH_TIME, dict(pdp=PDP4, doppler_norm=0.03)),
    "multipath_halo": (jcfg.ChannelModel.MULTIPATH, dict(pdp=PDP4)),
    "multipath_time_halo": (jcfg.ChannelModel.MULTIPATH_TIME,
                            dict(pdp=PDP4, doppler_norm=0.03)),
}


@pytest.mark.parametrize("case", list(_MODELS))
def test_apply_channel_matches_jax_composition(rng, case):
    """Injected fading and noise against the JAX channel models' own
    composition: tx·h + σ·n for the flat ones, ``apply_multipath`` over
    the serialised stream (with the block's halo as history) for
    MULTIPATH, ``apply_multipath`` per symbol with ``symbol_history`` (its
    row 0 the halo) for MULTIPATH_TIME, and ``freq_response`` of the taps
    as the response."""
    model, kw = _MODELS[case]
    halo = case.endswith("_halo")
    ref, cfg = _cfgs(model, **kw)
    tx = _cn(rng, (B, S, L), N ** -0.5)
    noise = rng.standard_normal((2, B, S, L)).astype(np.float32)
    nv = jchan.ebno_db_to_noise_var(ref.channel.ebno_db, ref.modulation.bits_per_symbol)
    tvar = jchan.time_noise_var(nv, N)
    jn = jnp.asarray(noise[0] + 1j * noise[1]) * jnp.sqrt(jnp.float32(0.5)) * jnp.sqrt(tvar)
    jtx = jnp.asarray(tx)
    h = taps = hist = None
    want_h = None
    if model in (jcfg.ChannelModel.RAYLEIGH_FLAT, jcfg.ChannelModel.RICIAN):
        h = _cn(rng, (B, 1, 1))
        faded, want_h = jtx * h, h
    elif model == jcfg.ChannelModel.RAYLEIGH_TIME:
        h = _cn(rng, (B, S, 1))
        faded, want_h = jtx * h, h
    elif model == jcfg.ChannelModel.MULTIPATH:
        taps = _cn(rng, (B, len(PDP4)), 0.5)
        hist = _cn(rng, (B, len(PDP4) - 1), N ** -0.5) if halo else None
        faded = jchan.apply_multipath(jtx.reshape(B, -1), jnp.asarray(taps),
                                      history=None if hist is None else jnp.asarray(hist))
        faded = faded.reshape(B, S, L)
        want_h = np.asarray(jchan.freq_response(jnp.asarray(taps), N))[:, None, :]
    elif model == jcfg.ChannelModel.MULTIPATH_TIME:
        taps = _cn(rng, (B, S, len(PDP4)), 0.5)
        jh = jchan.symbol_history(jtx, len(PDP4))
        if halo:
            hist = _cn(rng, (B, len(PDP4) - 1), N ** -0.5)
            jh = jh.at[:, 0].set(jnp.asarray(hist))
        faded = jchan.apply_multipath(jtx, jnp.asarray(taps), history=jh)
        want_h = np.asarray(jchan.freq_response(jnp.asarray(taps), N))
    else:
        faded = jtx
    want = faded if model == jcfg.ChannelModel.IDENTITY else faded + jn
    fading = (None if h is None else torch.from_numpy(h),
              None if taps is None else torch.from_numpy(taps))
    (re, im), h_freq, got_nv = pipeline.apply_channel(
        cfg, SEED, torch.arange(B, dtype=torch.int32), _planar(tx), fading=fading,
        noise=tuple(torch.from_numpy(n) for n in noise),
        history=None if hist is None else _planar(hist))
    _close(re, np.real(want))
    _close(im, np.imag(want))
    if want_h is None:
        assert h_freq is None
    else:
        _close(h_freq.real, np.real(want_h))
        _close(h_freq.imag, np.imag(want_h))
    want_nv = 0.0 if model == jcfg.ChannelModel.IDENTITY else float(nv)
    assert got_nv == pytest.approx(want_nv, rel=1e-6)


@pytest.mark.parametrize("case", ["rayleigh_time", "multipath_time"])
def test_apply_channel_keyed_block_is_the_frame_rows(case):
    """Keyed draws at s0: the rows [4, 8) of a frame equal a block of 4
    symbols from s0 = 4 with the frame's row 3 tail as its halo (the
    Jakes state at absolute symbols, the noise at (channel, s0 + s, u))."""
    model, kw = _MODELS[case]
    _, cfg = _cfgs(model, **kw)
    ids = torch.arange(2, 2 + B, dtype=torch.int32)
    tx = pipeline.tx_idx(cfg, pipeline.draw_idx(cfg, SEED, ids))
    full, h_full, _ = pipeline.apply_channel(cfg, SEED, ids, tx)
    block_tx = tuple(t[:, 4:].contiguous() for t in tx)
    halo = stream.tail(tuple(t[:, :4] for t in tx), len(PDP4) - 1)
    part, h_part, _ = pipeline.apply_channel(cfg, SEED, ids, block_tx, s0=4, history=halo)
    for a, b in zip(part, full):
        torch.testing.assert_close(a, b[:, 4:], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h_part, h_full[:, 4:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["rayleigh_flat", "rayleigh_time", "multipath",
                                  "multipath_time"])
def test_fading_at_s0_is_the_frame_rows(case):
    """The fading state is drawn once and evaluated at absolute symbols:
    ``fading_at`` symbols [4, 6) is rows [4, 6) of ``fade_state``'s frame
    (the static models' state as drawn, bit for bit; the Jakes models'
    evaluation to float32 rounding)."""
    model, kw = _MODELS[case]
    _, cfg = _cfgs(model, **kw)
    ids = torch.arange(5, 5 + B, dtype=torch.int32)
    got = fast.fading_at(cfg, fast.fading_params(cfg, SEED, ids), 4, 2)
    want = fast.fade_state(cfg, SEED, ids, plane=False)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if b.ndim == 3 and b.shape[1] == S:
            torch.testing.assert_close(a, b[:, 4:6], rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a, b)


# ---- rx_chain ------------------------------------------------------------------

_RX = {
    "mmse": (jcfg.Equalizer.MMSE, False),
    "zf": (jcfg.Equalizer.ZF, False),
    "none": (jcfg.Equalizer.NONE, False),
    "scfde_mmse": (jcfg.Equalizer.MMSE, True),
    "zf_despread": (jcfg.Equalizer.ZF, True),
}
_H = {"none": None, "flat": (1, 1), "per_symbol": (S, 1), "tones": (1, N), "grid": (S, N)}


def _despread_rtol(h, nv):
    """The SC-FDE LLRs' relative tolerance per (B, S) symbol: 1e-6 plus
    the conditioning of its SINR b/(1 − b), where b is the tone mean of
    |h|²/(|h|² + nv) (a float32 sum of N terms, in another order in each
    package): 8 float32 ulps of b over 1 − b."""
    h2 = np.abs(np.broadcast_to(h, (B, S, N)).astype(np.complex128)) ** 2
    b = (h2 / (h2 + nv)).mean(axis=-1)
    return 1e-6 + 2.0 ** -20 / (1.0 - b)


@pytest.mark.parametrize("h_case", list(_H))
@pytest.mark.parametrize("rx_case", list(_RX))
def test_rx_chain_matches_jax(rng, rx_case, h_case):
    """The genie receive branches against the JAX ``rx_chain`` (h per
    channel of JAX shape (), (S, 1), (N,), (S, N), or None). All but the
    ZF despread on h run kernel C's LLR mode's plain version (SC-FDMA:
    its despread mode): OFDM ZF as MMSE's one-tap tail, with a unit h
    where the JAX skips the equaliser (and for NONE). The SC-FDE MMSE
    LLRs of a symbol scale with its SINR b/(1 − b), so their relative
    tolerance adds that ratio's conditioning (``_despread_rtol``)."""
    equalizer, dft_spread = _RX[rx_case]
    ref, cfg = _cfgs(equalizer=equalizer, dft_spread=dft_spread)
    shape = _H[h_case]
    h = None if shape is None else _cn(rng, (B,) + shape)
    tx = _cn(rng, (B, S, L), N ** -0.5)
    rx = tx + _cn(rng, (B, S, L), 0.05)
    nv = 0.05
    jh = None if h is None else jnp.asarray(h)
    want, want_hard = jpipe.rx_chain(ref, jnp.asarray(rx), jh, jnp.float32(nv))
    got, hard = pipeline.rx_chain(cfg, _planar(rx), None if h is None else torch.from_numpy(h),
                                  nv)
    if rx_case == "scfde_mmse" and h is not None:
        want = np.asarray(want)
        rtol = np.repeat(_despread_rtol(h, nv)[..., None], want.shape[-1], axis=-1)
        peak = float(np.abs(want).max())
        assert bool(np.all(np.abs(got.numpy() - want) <= 1e-5 * peak + rtol * np.abs(want)))
    else:
        _assert_llrs_close(got.numpy(), want)
    sure = np.abs(np.asarray(want)) >= 1e-3
    np.testing.assert_array_equal(hard.numpy()[sure], np.asarray(want_hard)[sure])


@pytest.mark.parametrize("dft_spread", [False, True], ids=["ofdm", "scfdma"])
def test_identity_llrs_keep_their_signs(dft_spread):
    """IDENTITY passes nv = 0, floored to 1e-12: LLRs of about 1e12, finite,
    with the JAX receiver's signs, and no bit error — OFDM through kernel
    C's clamp, SC-FDMA through the plain despread (C's despread does not
    resolve an SINR of 1e12)."""
    ref, cfg = _cfgs(jcfg.ChannelModel.IDENTITY, dft_spread=dft_spread)
    res = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
    llrs = res.llrs
    assert bool(torch.isfinite(llrs).all()) and float(llrs.abs().min()) > 1e9
    assert int(res.bit_errors.sum()) == 0 and int(res.bits_counted[0]) == S * N * 4
    ids = torch.arange(B, dtype=torch.int32)
    re, im = pipeline.tx_idx(cfg, pipeline.draw_idx(cfg, SEED, ids))
    want, _ = jpipe.rx_chain(ref, jnp.asarray((re + 1j * im).numpy()), None, jnp.float32(0.0))
    _assert_llrs_close(llrs.numpy(), want)
    np.testing.assert_array_equal((llrs < 0).numpy(), np.asarray(want) < 0)


# ---- simulate --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["awgn", "rayleigh_flat", "multipath"])
def test_simulate_equals_fast_simulate(case):
    """MMSE links: the same payload (kernel A's stream), fading and noise
    as the fast engine, so the same counts; channels [0, 2) alone give
    the counts of the full run."""
    model, kw = _MODELS[case]
    _, cfg = _cfgs(model, **kw)
    res = pipeline.simulate(cfg, SEED, device="cpu")
    want, counted = fast.fast_simulate(cfg, SEED, device="cpu")
    torch.testing.assert_close(res.bit_errors, want, rtol=0, atol=0)
    torch.testing.assert_close(res.bits_counted, counted, rtol=0, atol=0)
    assert int(res.bit_errors.sum()) > 0 and res.llrs is None
    part, _, _ = pipeline.simulate_core(cfg, SEED, torch.arange(2, dtype=torch.int32))
    torch.testing.assert_close(part, res.bit_errors[:2], rtol=0, atol=0)
    torch.testing.assert_close(res.ber, want.float() / counted.float())


@pytest.mark.parametrize("case", [
    ("mmse_multipath", jcfg.Equalizer.MMSE, False, "multipath"),
    ("none_awgn", jcfg.Equalizer.NONE, False, "awgn"),
    ("zf_multipath_time", jcfg.Equalizer.ZF, False, "multipath_time"),
    ("scfde_awgn", jcfg.Equalizer.MMSE, True, "awgn"),
    ("scfde_rayleigh_time", jcfg.Equalizer.MMSE, True, "rayleigh_time"),
    ("zf_despread_multipath", jcfg.Equalizer.ZF, True, "multipath"),
], ids=lambda c: c[0])
def test_count_equals_the_llr_plane(case):
    """Without LLRs the link counts through kernel C's count mode (the ZF
    despread through its plane); with them it counts the plane's hard bits. Both
    agree but for bits whose |LLR| < 1e-3, and the plane is (B, S, N·bps)."""
    _, equalizer, dft_spread, model_case = case
    model, kw = _MODELS[model_case]
    _, cfg = _cfgs(model, equalizer=equalizer, dft_spread=dft_spread, **kw)
    count = pipeline.simulate(cfg, SEED, device="cpu")
    plane = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
    assert plane.llrs.shape == (B, S, N * 4) and plane.llrs.dtype == torch.float32
    _assert_counts_within(count.bit_errors, plane.bit_errors, plane.llrs)
    torch.testing.assert_close(plane.bits_counted, count.bits_counted, rtol=0, atol=0)


# ---- stream --------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 2, 4])
@pytest.mark.parametrize("case", [
    ("multipath_4", jcfg.ChannelModel.MULTIPATH, dict(pdp=PDP4)),
    ("multipath_cp+1", jcfg.ChannelModel.MULTIPATH, dict(pdp=PDP17)),
    ("multipath_time", jcfg.ChannelModel.MULTIPATH_TIME, dict(pdp=PDP4, doppler_norm=0.03)),
], ids=lambda c: c[0])
def test_stream_equals_simulate(case, n_blocks):
    """Every draw is keyed by absolute position, so the blocked stream is
    the whole frame for any n_blocks: bit for bit on static taps, and on
    MULTIPATH_TIME but for bits whose |LLR| < 1e-3, where a block's Jakes
    evaluation may round apart (``stream.exact_at_seams``)."""
    _, model, kw = case
    _, cfg = _cfgs(model, ebno_db=6.0, **kw)
    errors, counted = stream.stream_simulate(cfg, SEED, n_blocks, device="cpu")
    ref = pipeline.simulate(cfg, SEED, device="cpu")
    assert stream.exact_at_seams(cfg) == (model == jcfg.ChannelModel.MULTIPATH)
    if stream.exact_at_seams(cfg):
        torch.testing.assert_close(errors, ref.bit_errors, rtol=0, atol=0)
    else:
        res = pipeline.simulate(cfg, SEED, device="cpu", want_llrs=True)
        _assert_counts_within(errors, ref.bit_errors, res.llrs)
    torch.testing.assert_close(counted, ref.bits_counted, rtol=0, atol=0)
    assert int(errors.sum()) > 0


# ---- what the pipeline refuses ---------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    (dict(pilot_spacing=4), None),
    (dict(pilot_spacing=4, channel_kw=dict(model=jcfg.ChannelModel.RAYLEIGH_FLAT,
                                           pa_ibo_db=4.0)), "11d"),
    (dict(mimo=jcfg.MIMOConfig(), channel_kw=dict(model=jcfg.ChannelModel.RAYLEIGH_TIME,
                                                  doppler_norm=0.02)), "mimo"),
], ids=["pilots", "pa", "mimo"])
def test_unported_options_raise(kw, item):
    """Pilots (item 11c), front-end impairments (item 11d) and MIMO on a
    time-varying channel (item 11e) run in ``simulate`` and
    ``make_simulate_fn``; the stream refuses pilots and MIMO as the JAX
    module does, naming ``link.pipeline``, and impairments naming item
    11d."""
    kw = dict(kw)
    channel_kw = kw.pop("channel_kw", {})
    ref = jcfg.LinkConfig(modulation=jcfg.Modulation.QPSK,
                          ofdm=jcfg.OFDMConfig(n_fft=N, cp_len=CP),
                          channel=jcfg.ChannelConfig(**channel_kw),
                          equalizer=jcfg.Equalizer.MMSE, n_symbols=S, n_channels=B, **kw)
    cfg = interop.link_config_from_reference(ref)
    calls = (lambda: pipeline.simulate(cfg, 0, device="cpu"),
             lambda: pipeline.make_simulate_fn(cfg, device="cpu")(0))
    for call in calls:
        res = call()
        assert int(res.bits_counted[0]) == S * cfg.bits_per_ofdm_symbol
    with pytest.raises(NotImplementedError, match=r"link\.pipeline"):
        stream.stream_simulate(cfg, 0, 2, device="cpu")
    if item == "11d":
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            stream.stream_simulate(cfg, 0, 2, device="cpu")


def test_stream_blocking_and_defaults():
    import inspect

    _, cfg = _cfgs(jcfg.ChannelModel.MULTIPATH, pdp=PDP4)
    with pytest.raises(ValueError, match="not divisible by n_blocks=3"):
        stream.stream_simulate(cfg, 0, 3, device="cpu")
    assert stream._halo_len(cfg) == 3
    assert stream._halo_len(_cfgs(jcfg.ChannelModel.RAYLEIGH_FLAT)[1]) == 0
    for fn in (pipeline.simulate, pipeline.make_simulate_fn, stream.stream_simulate):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
