"""The port's keyed fast link (sdr_tpu_torch.link.fast) as a whole.

- The slice on explicit inputs (indices, gains, injected noise) through
  the port's tx_with_channel → rx_count_core, against the JAX
  interpret-mode composition of the same three kernels: counts equal,
  or differing by no more than the bits whose plain |LLR| < 1e-3.
- The same for the selective and time-varying models, with the fading
  state (taps, per-symbol gains) carried across through ``interop``.
- The keyed engine's BER against exact theory (flat models) and against
  the semi-analytic BER of the channel each run drew (selective and
  time-varying models); split == full for every model and layout; the
  staged channel route equals the fused one; the channels-last layout
  counts as the rows layout.
- Full-grid SC-FDMA (``dft_spread``): split == full, BER against exact
  theory, the slice on explicit inputs against the JAX count kernel's
  despread mode; the entry points default to the card.
- The package never imports JAX; pilots and MIMO raise.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.kernels.channel_pallas import fade_awgn_pallas
from sdr_tpu.kernels.demod_pallas import demod_count_pallas
from sdr_tpu.kernels.tx_pallas import tx_chain_pallas
from sdr_tpu.link import ber as jber
from sdr_tpu.ops import channel as jchan
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOConfig,
    Modulation,
    OFDMConfig,
    link_config_to_dict,
)
from sdr_tpu_torch.kernels.channel import fade_awgn_plain
from sdr_tpu_torch.kernels.demod import demod_chain
from sdr_tpu_torch.kernels.tx import tx_chain
from sdr_tpu_torch.link import fast
from sdr_tpu_torch.link.ber import ber_awgn_exact, ber_rayleigh_exact, ber_rician_exact
from sdr_tpu_torch.ops import channel as chan

torch.set_num_threads(1)


def _cfg(model=ChannelModel.AWGN, ebno_db=6.0, mod=Modulation.QAM16, n_fft=256, cp=64,
         n_symbols=64, n_channels=16, **kw):
    return LinkConfig(
        modulation=mod, ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
        channel=ChannelConfig(model=model, ebno_db=ebno_db), n_symbols=n_symbols,
        n_channels=n_channels, **kw,
    )


@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT],
                         ids=lambda m: m.value)
@pytest.mark.parametrize("mod", [Modulation.QAM16, Modulation.QPSK], ids=lambda m: m.value)
def test_slice_on_explicit_inputs_matches_jax_kernels(rng, model, mod):
    B, S, N, cp, ebno = 128, 8, 128, 32, 6.0
    cfg = _cfg(model, ebno, mod, N, cp, S, B)
    idx = rng.integers(0, 1 << mod.bits_per_symbol, (B, S, N)).astype(np.int32)
    h = ((rng.standard_normal(B) + 1j * rng.standard_normal(B)) / np.sqrt(2)).astype(np.complex64)
    if model == ChannelModel.AWGN:
        h = np.ones(B, np.complex64)
    n_re = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    n_im = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    nv = 1.0 / (10 ** (ebno / 10) * mod.bits_per_symbol)

    # JAX: TX kernel → channel kernel (injected noise) → count kernel.
    jm = jcfg.Modulation(mod.value)
    jre, jim = tx_chain_pallas(jnp.asarray(idx), cp, jm, interpret=True)
    hr_s = np.real(h)[:, None].astype(np.float32)
    hi_s = np.imag(h)[:, None].astype(np.float32)
    fade = model != ChannelModel.AWGN
    jre, jim = fade_awgn_pallas(
        jre, jim, jnp.asarray(hr_s) if fade else None, jnp.asarray(hi_s) if fade else None,
        0, nv / N, noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True,
    )
    hb_r = np.broadcast_to(hr_s[:, :, None], (B, 1, N)).astype(np.float32)
    hb_i = np.broadcast_to(hi_s[:, :, None], (B, 1, N)).astype(np.float32)
    ref = demod_count_pallas(jre, jim, jnp.asarray(hb_r), jnp.asarray(hb_i), jnp.asarray(idx),
                             cp, jm, nv, interpret=True)

    # Port: the same state through the engine's own entry points.
    st = interop.channel_state(idx=idx, h=h if fade else None, noise=(n_re, n_im))
    ids = torch.arange(B, dtype=torch.int32)
    re, im = fast.tx_with_channel(cfg, 0, ids, st["idx"], h=st.get("h"), noise=st["noise"])
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-5, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-5, rtol=0)
    errors, counted = fast.rx_count_core(cfg, 0, ids, re, im, h=st.get("h"), idx=st["idx"])
    assert int(counted[0]) == S * N * mod.bits_per_symbol
    assert int(errors.sum()) > 0
    llr = demod_chain(re, im, *interop.planes(hb_r, hb_i), cp, mod, nv)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2)).numpy()
    assert (np.abs(errors.numpy() - np.asarray(ref)) <= margin).all()


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
def test_ber_theory_matches_reference(mod):
    jm = jcfg.Modulation(mod.value)
    for ebno in (0.0, 7.5, 15.0):
        assert ber_awgn_exact(mod, ebno) == jber.ber_awgn_exact(jm, ebno)
        assert ber_rayleigh_exact(mod, ebno) == jber.ber_rayleigh_exact(jm, ebno)
        assert ber_rician_exact(mod, ebno, 3.0) == jber.ber_rician_exact(jm, ebno, 3.0)
    # K = 0 is Rayleigh.
    np.testing.assert_allclose(ber_rician_exact(mod, 9.0, 0.0), ber_rayleigh_exact(mod, 9.0),
                               rtol=1e-9)


def test_fast_simulate_awgn_ber_matches_theory():
    cfg = _cfg(ChannelModel.AWGN, 6.0, n_channels=16, n_symbols=64)
    errors, counted = fast.fast_simulate(cfg, seed=2024, device="cpu")
    ber = int(errors.sum()) / int(counted.sum())
    theory = ber_awgn_exact(Modulation.QAM16, 6.0)
    assert abs(ber / theory - 1.0) < 0.15, (ber, theory)


def test_fast_simulate_rayleigh_ber_matches_theory():
    """Many short links, so that fade realisations average out."""
    cfg = _cfg(ChannelModel.RAYLEIGH_FLAT, 10.0, Modulation.QPSK, 16, 4, 4, 16384)
    errors, counted = fast.make_fast_fn(cfg, device="cpu")(5)
    ber = int(errors.sum()) / int(counted.sum())
    theory = ber_rayleigh_exact(Modulation.QPSK, 10.0)
    assert abs(ber / theory - 1.0) < 0.15, (ber, theory)


def test_identity_channel_is_error_free():
    cfg = _cfg(ChannelModel.IDENTITY, mod=Modulation.QAM1024, n_fft=64, cp=16, n_symbols=4,
               n_channels=8)
    errors, counted = fast.fast_simulate(cfg, seed=1, device="cpu")
    assert int(errors.sum()) == 0 and int(counted.sum()) == 8 * 4 * 64 * 10


@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.RICIAN],
                         ids=lambda m: m.value)
def test_split_equals_full(model):
    """Channels [0, k) alone give the same counts as in the full run."""
    cfg = _cfg(model, 4.0, n_fft=64, cp=16, n_symbols=8, n_channels=48)
    full, _ = fast.fast_simulate(cfg, seed=9, device="cpu")
    part, _ = fast.fast_core(cfg, 9, torch.arange(0, 20, dtype=torch.int32))
    rest, _ = fast.fast_core(cfg, 9, torch.arange(20, 48, dtype=torch.int32))
    torch.testing.assert_close(torch.cat([part, rest]), full, rtol=0, atol=0)
    assert int(full.sum()) > 0


def test_package_imports_no_jax():
    code = (
        "import sys; import sdr_tpu_torch, sdr_tpu_torch.link.fast, sdr_tpu_torch.interop, "
        "sdr_tpu_torch.ops.demod, sdr_tpu_torch.kernels.demod_cl, sdr_tpu_torch.link.mc, "
        "sdr_tpu_torch.obs.sweep, sdr_tpu_torch.link.fast_coded, sdr_tpu_torch.link.coded, "
        "sdr_tpu_torch.ops.ldpc, sdr_tpu_torch.ops.interleave, sdr_tpu_torch.kernels.ldpc, "
        "sdr_tpu_torch.kernels.demod, sdr_tpu_torch.kernels.tx, sdr_tpu_torch.ops.llr, "
        "sdr_tpu_torch.parallel, sdr_tpu_torch.parallel.dryrun, sdr_tpu_torch.link.pipeline, "
        "sdr_tpu_torch.link.stream, sdr_tpu_torch.ops.pilots, sdr_tpu_torch.ops.pa, "
        "sdr_tpu_torch.ops.sync, sdr_tpu_torch.ops.mimo, sdr_tpu_torch.ops.channel, "
        "sdr_tpu_torch.parallel.shard, sdr_tpu_torch.ops.fec, sdr_tpu_torch.ops.polar, "
        "sdr_tpu_torch.link.packet, sdr_tpu_torch.link.adapt, sdr_tpu_torch.app.baseline_configs, "
        "sdr_tpu_torch.app.demo, sdr_tpu_torch.obs.waveform, sdr_tpu_torch.obs.metrics, "
        "sdr_tpu_torch.utils.sliding_buffer, sdr_tpu_torch.core.precision, "
        "sdr_tpu_torch.app.cli, sdr_tpu_torch.native, sdr_tpu_torch.native.host, "
        "sdr_tpu_torch.native.iq, sdr_tpu_torch.obs.health, sdr_tpu_torch.obs.roofline, "
        "sdr_tpu_torch.obs.profile, sdr_tpu_torch.obs.autotune, sdr_tpu_torch.obs.scaling, "
        "sdr_tpu_torch.obs.plot, sdr_tpu_torch.ops.fft_matmul; "
        "from sdr_tpu_torch.ops.fft import Backend, set_default_backend, set_matmul_min_n; "
        "from sdr_tpu_torch.obs.autotune import TunePoint, tune_fft, recommend_crossover; "
        "from sdr_tpu_torch.ops.demod import demod_chain_plain; "
        "from sdr_tpu_torch.link import simulate_coded, info_bits_per_channel; "
        "from sdr_tpu_torch.utils import SlidingBuffer, ring_push; "
        "from sdr_tpu_torch.obs import Metrics, ebno_sweep, trace, probe_device, demod_roofline; "
        "from sdr_tpu_torch.core import Precision, LinkConfig; "
        "from sdr_tpu_torch.interop import packet_config_from_reference; "
        "from sdr_tpu_torch.ops import conv_encode, viterbi_decode; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'; "
        "assert not any(m == 'sdr_tpu' or m.startswith('sdr_tpu.') for m in sys.modules)"
    )
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize(
    "kw",
    [
        dict(dft_spread=True),
        dict(pilot_spacing=4, equalizer=Equalizer.MMSE),
        dict(mimo=True),
    ],
    ids=["dft_spread", "pilots", "mimo"],
)
def test_unported_paths_raise(kw):
    """Pilots and MIMO raise, naming ``link.pipeline.simulate``, where they
    run (as the JAX engine says). SC-FDMA raised
    until this engine ported it; its case now runs: channels [0, 2) alone
    give the counts of the full run."""
    kw = dict(kw)
    model = kw.pop("model", ChannelModel.RAYLEIGH_FLAT)
    if kw.pop("mimo", False):
        kw["mimo"] = MIMOConfig()
    cfg = _cfg(model, n_fft=64, cp=16, n_symbols=4, n_channels=4, **kw)
    if cfg.dft_spread:
        full, counted = fast.fast_simulate(cfg, seed=0, device="cpu")
        part, _ = fast.fast_core(cfg, 0, torch.arange(2, dtype=torch.int32))
        torch.testing.assert_close(part, full[:2], rtol=0, atol=0)
        assert int(counted[0]) == 4 * 64 * 4
        return
    with pytest.raises(NotImplementedError, match=r"link\.pipeline\.simulate"):
        fast.fast_simulate(cfg, seed=0, device="cpu")


@pytest.mark.parametrize(
    "model,theory",
    [(ChannelModel.AWGN, ber_awgn_exact), (ChannelModel.RAYLEIGH_FLAT, ber_rayleigh_exact)],
    ids=["awgn", "rayleigh_flat"],
)
def test_scfdma_ber_matches_theory(model, theory):
    """Full-grid SC-FDMA over a flat channel: the post-despread SINR is
    |h|²/nv, as for OFDM, so the BER sits on the same exact curve."""
    cfg = _cfg(model, 8.0, Modulation.QPSK, n_fft=64, cp=16, n_symbols=4, n_channels=4096,
               dft_spread=True)
    errors, counted = fast.fast_simulate(cfg, seed=13, device="cpu")
    ber = int(errors.sum()) / int(counted.sum())
    assert abs(ber / theory(Modulation.QPSK, 8.0) - 1.0) < 0.15, ber


def test_scfdma_slice_on_explicit_inputs_matches_jax_kernels(rng):
    """SC-FDMA with the same indices, taps and noise through the JAX
    composition (SC-FDMA TX → apply_multipath → channel kernel → count
    kernel with despread) and through the port's tx_with_channel →
    rx_count_core (kernel E, kernel C's despread mode)."""
    B, S, N, cp, ebno = 128, 4, 128, 32, 10.0
    mod = Modulation.QAM16
    jm = jcfg.Modulation(mod.value)
    cfg = dataclasses.replace(_sel_cfg(ChannelModel.MULTIPATH, PDP4, ebno, mod, N, cp, S, B),
                              dft_spread=True)
    idx = rng.integers(0, 16, (B, S, N)).astype(np.int32)
    n_re = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    n_im = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    taps = ((rng.standard_normal((B, 4)) + 1j * rng.standard_normal((B, 4))) / np.sqrt(2)
            * np.sqrt(np.asarray(PDP4) / sum(PDP4))).astype(np.complex64)
    nv = 1.0 / (10 ** (ebno / 10) * mod.bits_per_symbol)
    x = fast.scfdma_tx(cfg, torch.from_numpy(idx))
    x = jnp.asarray(x[0].numpy()) + 1j * jnp.asarray(x[1].numpy())
    x = jchan.apply_multipath(x.reshape(B, -1), jnp.asarray(taps)).reshape(x.shape)
    jre, jim = fade_awgn_pallas(jnp.real(x), jnp.imag(x), None, None, 0, nv / N,
                                noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True)
    h_plane = np.asarray(jchan.freq_response(jnp.asarray(taps), N))[:, None, :]
    ref = demod_count_pallas(jre, jim, jnp.asarray(np.real(h_plane).astype(np.float32)),
                             jnp.asarray(np.imag(h_plane).astype(np.float32)), jnp.asarray(idx),
                             cp, jm, nv, interpret=True, despread=True)

    st = interop.channel_state(idx=idx, noise=(n_re, n_im))
    state = interop.fading_state(taps=taps)
    ids = torch.arange(B, dtype=torch.int32)
    re, im = fast.tx_with_channel(cfg, 0, ids, st["idx"], taps=state["taps"], noise=st["noise"])
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-5, rtol=0)
    errors, _ = fast.rx_count_core(cfg, 0, ids, re, im, taps=state["taps"], idx=st["idx"])
    assert int(errors.sum()) > 0
    llr = demod_chain(re, im, *interop.planes(np.real(h_plane), np.imag(h_plane)), cp, mod, nv,
                      despread=True)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2)).numpy()
    assert (np.abs(errors.numpy() - np.asarray(ref)) <= margin).all()


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (fast.fast_simulate, fast.make_fast_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(NotImplementedError, match="rows layout"):
        fast.fast_simulate(_cfg(n_fft=64, cp=16, n_symbols=4, n_channels=4, dft_spread=True),
                           seed=0, device="cpu", layout="cl")
    assert not fast.layout_supported_cl(_cfg(dft_spread=True), 16)


PDP4 = (1.0, 0.5, 0.25, 0.125)  # BASELINE config 4's power-delay profile
PDP3 = (1.0, 0.5, 0.25)  # scripts/bench_link.py's TDL profile
PDP24 = tuple(0.8 ** l for l in range(24))  # beyond the fused FIR: the staged route


def _sel_cfg(model, pdp=PDP3, ebno_db=14.0, mod=Modulation.QAM16, n_fft=64, cp=32, n_symbols=8,
             n_channels=48, doppler_norm=0.02):
    return LinkConfig(
        modulation=mod, ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
        channel=ChannelConfig(model=model, ebno_db=ebno_db, pdp=pdp, doppler_norm=doppler_norm),
        n_symbols=n_symbols, n_channels=n_channels,
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(model=ChannelModel.MULTIPATH),
        dict(model=ChannelModel.MULTIPATH_TIME),
        dict(model=ChannelModel.RAYLEIGH_TIME),
        dict(layout="cl"),
        dict(model=ChannelModel.MULTIPATH, layout="cl"),
        dict(model=ChannelModel.MULTIPATH, pdp=PDP24),
        dict(model=ChannelModel.MULTIPATH_TIME, pdp=PDP24),
        dict(model=ChannelModel.MULTIPATH_TIME, pdp=tuple(0.7 ** l for l in range(12))),
    ],
    ids=["multipath", "multipath_time", "rayleigh_time", "cl", "multipath_cl",
         "multipath_staged", "multipath_time_staged", "multipath_time_12taps"],
)
def test_selective_and_cl_paths_split_equals_full(kw):
    """Every channel model and layout runs, and channels [0, k) alone give
    the same counts as in the full run."""
    kw = dict(kw)
    layout = kw.pop("layout", "auto")
    model = kw.pop("model", ChannelModel.RAYLEIGH_FLAT)
    cfg = _sel_cfg(model, ebno_db=8.0, **kw)
    full, counted = fast.fast_simulate(cfg, seed=9, device="cpu", layout=layout)
    part, _ = fast.fast_core(cfg, 9, torch.arange(0, 20, dtype=torch.int32), layout=layout)
    rest, _ = fast.fast_core(cfg, 9, torch.arange(20, 48, dtype=torch.int32), layout=layout)
    torch.testing.assert_close(torch.cat([part, rest]), full, rtol=0, atol=0)
    assert int(full.sum()) > 0 and int(counted[0]) == 8 * 64 * 4


@pytest.mark.parametrize("model", [ChannelModel.RAYLEIGH_TIME, ChannelModel.MULTIPATH_TIME],
                         ids=lambda m: m.value)
def test_per_symbol_models_raise_under_cl(model):
    with pytest.raises(NotImplementedError, match="per-link channel plane"):
        fast.fast_simulate(_sel_cfg(model), seed=0, device="cpu", layout="cl")
    assert not fast.layout_supported_cl(_sel_cfg(model), 48)
    assert fast.layout_supported_cl(_sel_cfg(ChannelModel.MULTIPATH), 48)
    assert fast.select_layout(_sel_cfg(ChannelModel.MULTIPATH), 48) == "rows"


def _ber_given_gain(mod, ebno_db, g2):
    """Exact Gray-QAM AWGN BER at Eb/N0·|H|², averaged over the gains
    ``g2`` — the BER of the drawn channel (with CP ≥ L−1 every subcarrier
    is an AWGN channel at its own |H|², and the one-tap equaliser with
    max-log decisions is exact per axis)."""
    from scipy.special import erfc

    L, m = mod.levels_per_axis, mod.bits_per_axis
    arg = mod.unit_energy_scale * np.sqrt(2.0 * mod.bits_per_symbol * 10 ** (ebno_db / 10)
                                          * np.asarray(g2, np.float64))
    total = 0.0
    for k in range(1, m + 1):
        half = 1 << (k - 1)
        for i in range(int((1.0 - 2.0 ** (-k)) * L)):
            sign = -1.0 if ((i * half) // L) % 2 else 1.0
            weight = half - np.floor(i * half / L + 0.5)
            total = total + sign * weight * erfc((2 * i + 1) * arg / np.sqrt(2.0)) / L
    return float(np.mean(total) / m)


def test_ber_given_gain_reduces_to_awgn_theory():
    for mod in (Modulation.QPSK, Modulation.QAM16, Modulation.QAM64):
        np.testing.assert_allclose(_ber_given_gain(mod, 7.0, np.ones(3)),
                                   ber_awgn_exact(mod, 7.0), rtol=1e-12)


@pytest.mark.parametrize(
    "model,pdp",
    [(ChannelModel.MULTIPATH, PDP4), (ChannelModel.RAYLEIGH_TIME, PDP3),
     (ChannelModel.MULTIPATH_TIME, PDP3), (ChannelModel.MULTIPATH, PDP24)],
    ids=["multipath", "rayleigh_time", "multipath_time", "multipath_staged"],
)
def test_selective_ber_matches_ber_of_the_drawn_channel(model, pdp):
    """BER over ~1e6 bits against the semi-analytic BER of the channel the
    run drew (fade_state recomputes it from the keys). The errors are
    ~1e4, so the noise-only spread is ~1 %: the gate is 5 %."""
    cfg = _sel_cfg(model, pdp, ebno_db=12.0, n_symbols=16, n_channels=256, cp=32)
    errors, counted = fast.fast_simulate(cfg, seed=21, device="cpu")
    ber = int(errors.sum()) / int(counted.sum())
    h, _ = fast.fade_state(cfg, 21, torch.arange(256, dtype=torch.int32))
    g2 = torch.broadcast_to(h.abs() ** 2, (256, 16, 64)).numpy()
    want = _ber_given_gain(cfg.modulation, 12.0, g2)
    assert abs(ber / want - 1.0) < 0.05, (ber, want)
    # Averaged over the fading, MULTIPATH and RAYLEIGH_TIME are Rayleigh per
    # subcarrier; the drawn channel's BER sits near that theory.
    assert abs(want / ber_rayleigh_exact(cfg.modulation, 12.0) - 1.0) < 0.3


def test_staged_route_equals_fused_route():
    """apply_channel_fast over kernel B's clean waveform (plain FIR, then
    kernel E) equals the fused FIR of kernel B: both draw the noise from
    one counter."""
    for model in (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME,
                  ChannelModel.RAYLEIGH_TIME):
        cfg = _sel_cfg(model, PDP4, n_channels=6)
        ids = torch.arange(100, 106, dtype=torch.int32)
        idx = fast.draw_idx(cfg, 5, ids)
        fused = fast.tx_with_channel(cfg, 5, ids, idx)
        staged = fast.apply_channel_fast(cfg, 5, ids, *tx_chain(idx, cfg.ofdm.cp_len,
                                                                 cfg.modulation))
        for a, b in zip(fused, staged):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", [ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME],
                         ids=lambda m: m.value)
def test_staged_route_hands_the_fir_to_kernel_e(model, monkeypatch):
    """The staged route passes the selective model's taps to kernel E (one
    call, taps and no gains), whose plain version is the FIR then the
    noise: the same bits as ``grid_fir`` followed by E's noise alone."""
    cfg = _sel_cfg(model, PDP24, n_channels=5)
    ids = torch.arange(40, 45, dtype=torch.int32)
    clean = tx_chain(fast.draw_idx(cfg, 9, ids), cfg.ofdm.cp_len, cfg.modulation)
    calls = []

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return fade_awgn_plain(*args, **kwargs)

    monkeypatch.setattr(fast, "fade_awgn", recording)
    got = fast.apply_channel_fast(cfg, 9, ids, *clean)
    assert len(calls) == 1
    args, kwargs = calls[0]
    assert args[2] is None and kwargs["taps_r"].shape[-1] == len(PDP24)
    _, taps = fast.fade_state(cfg, 9, ids, plane=False)
    y = chan.grid_fir(torch.complex(*clean), taps)
    want = fade_awgn_plain(y.real.contiguous(), y.imag.contiguous(), None, None, args[4],
                           seed=9, ch_ids=ids)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT,
                                   ChannelModel.MULTIPATH], ids=lambda m: m.value)
def test_cl_layout_counts_equal_rows(model):
    """Both layouts see the same samples and channel; per-channel counts
    are equal, or differ by no more than the bits whose |LLR| < 1e-3."""
    cfg = _sel_cfg(model, PDP4, ebno_db=6.0, n_channels=40)
    rows, _ = fast.fast_simulate(cfg, seed=3, device="cpu", layout="rows")
    cl, _ = fast.fast_simulate(cfg, seed=3, device="cpu", layout="cl")
    assert int(rows.sum()) > 0
    torch.testing.assert_close(cl, rows, rtol=0, atol=0)
    re_t, im_t = fast.tx_channel_core(cfg, 3, torch.arange(40, dtype=torch.int32), layout="cl")
    assert re_t.shape == (8 * (64 + 32), 40) and re_t.is_contiguous()


@pytest.mark.parametrize(
    "model,pdp,jax_taps",
    [(ChannelModel.MULTIPATH, PDP4, False), (ChannelModel.MULTIPATH_TIME, PDP3, True),
     (ChannelModel.RAYLEIGH_TIME, None, False)],
    ids=["multipath", "multipath_time", "rayleigh_time"],
)
def test_selective_slice_on_explicit_inputs_matches_jax_kernels(rng, model, pdp, jax_taps):
    """The same indices, fading state and noise through the JAX staged
    composition (TX kernel → apply_multipath → channel kernel → count
    kernel, with taps= for the TDL) and through the port's
    tx_with_channel → rx_count_core."""
    B, S, N, cp, ebno = 128, 8, 128, 32, 8.0
    mod = Modulation.QAM16
    jm = jcfg.Modulation(mod.value)
    idx = rng.integers(0, 16, (B, S, N)).astype(np.int32)
    n_re = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    n_im = rng.standard_normal((B, S, N + cp)).astype(np.float32)
    nv = 1.0 / (10 ** (ebno / 10) * mod.bits_per_symbol)
    cfg = _sel_cfg(model, pdp or (1.0,), ebno, mod, N, cp, S, B)
    cplx = lambda *sh: ((rng.standard_normal(sh) + 1j * rng.standard_normal(sh))  # noqa: E731
                        / np.sqrt(2)).astype(np.complex64)
    jre, jim = tx_chain_pallas(jnp.asarray(idx), cp, jm, interpret=True)
    x = jre + 1j * jim
    hs = None
    if model == ChannelModel.MULTIPATH:
        taps = cplx(B, len(pdp)) * np.sqrt(np.asarray(pdp, np.float32) / sum(pdp))
        x = jchan.apply_multipath(x.reshape(B, -1), jnp.asarray(taps)).reshape(x.shape)
        state = interop.fading_state(taps=taps)
        h_plane = np.asarray(jchan.freq_response(jnp.asarray(taps), N))[:, None, :]
    elif model == ChannelModel.MULTIPATH_TIME:
        taps = cplx(B, S, len(pdp)) * np.sqrt(np.asarray(pdp, np.float32) / sum(pdp))
        x = jchan.apply_multipath(x, jnp.asarray(taps),
                                  history=jchan.symbol_history(x, len(pdp)))
        state = interop.fading_state(taps=taps)
        h_plane = np.asarray(jchan.freq_response(jnp.asarray(taps), N))
    else:
        gains = cplx(B, S)
        hs = (jnp.asarray(np.real(gains)), jnp.asarray(np.imag(gains)))
        state = interop.fading_state(gains=gains)
        h_plane = np.broadcast_to(gains[:, :, None], (B, S, N))
    jre, jim = fade_awgn_pallas(jnp.real(x), jnp.imag(x), *(hs or (None, None)), 0, nv / N,
                                noise=(jnp.asarray(n_re), jnp.asarray(n_im)), interpret=True)
    if jax_taps:
        ref = demod_count_pallas(jre, jim, None, None, jnp.asarray(idx), cp, jm, nv,
                                 taps=(jnp.asarray(np.real(taps)), jnp.asarray(np.imag(taps))),
                                 interpret=True)
    else:
        hb = np.ascontiguousarray(h_plane)
        ref = demod_count_pallas(jre, jim, jnp.asarray(np.real(hb).astype(np.float32)),
                                 jnp.asarray(np.imag(hb).astype(np.float32)), jnp.asarray(idx),
                                 cp, jm, nv, interpret=True)

    st = interop.channel_state(idx=idx, noise=(n_re, n_im))
    ids = torch.arange(B, dtype=torch.int32)
    re, im = fast.tx_with_channel(cfg, 0, ids, st["idx"], h=state.get("h"),
                                  taps=state.get("taps"), noise=st["noise"])
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-5, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-5, rtol=0)
    errors, _ = fast.rx_count_core(cfg, 0, ids, re, im, h=state.get("h"),
                                   taps=state.get("taps"), idx=st["idx"])
    assert int(errors.sum()) > 0
    hp = np.ascontiguousarray(h_plane)
    llr = demod_chain(re, im, *interop.planes(np.real(hp), np.imag(hp)), cp, mod, nv)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2)).numpy()
    assert (np.abs(errors.numpy() - np.asarray(ref)) <= margin).all()


def test_fade_state_shapes():
    ids = torch.arange(5, dtype=torch.int32)
    cases = {
        ChannelModel.AWGN: (None, None),
        ChannelModel.RAYLEIGH_TIME: ((5, 8, 1), None),
        ChannelModel.MULTIPATH: ((5, 1, 64), (5, 3)),
        ChannelModel.MULTIPATH_TIME: ((5, 8, 64), (5, 8, 3)),
    }
    for model, (h_shape, t_shape) in cases.items():
        h, taps = fast.fade_state(_sel_cfg(model), 2, ids)
        assert (None if h is None else tuple(h.shape)) == h_shape
        assert (None if taps is None else tuple(taps.shape)) == t_shape
        h2, taps2 = fast.fade_state(_sel_cfg(model), 2, ids, plane=False)
        if taps is not None:
            assert h2 is None
            torch.testing.assert_close(fast.rx_plane(taps2, 64), h, rtol=0, atol=0)


@pytest.mark.parametrize(
    "cfg",
    [
        jcfg.LinkConfig(),
        jcfg.LinkConfig(
            modulation=jcfg.Modulation.QAM16, ofdm=jcfg.OFDMConfig(256, 64),
            channel=jcfg.ChannelConfig(model=jcfg.ChannelModel.RICIAN, ebno_db=12.5,
                                       k_factor=2.0),
            n_symbols=64, n_channels=8192,
        ),
        jcfg.LinkConfig(
            modulation=jcfg.Modulation.QAM64, ofdm=jcfg.OFDMConfig(128, 32),
            channel=jcfg.ChannelConfig(model=jcfg.ChannelModel.MULTIPATH, pdp=(1.0, 0.5, 0.25)),
            equalizer=jcfg.Equalizer.MMSE, pilot_spacing=8,
            estimator=jcfg.ChannelEstimator.DFT,
        ),
        jcfg.LinkConfig(
            modulation=jcfg.Modulation.QPSK,
            channel=jcfg.ChannelConfig(model=jcfg.ChannelModel.RAYLEIGH_FLAT),
            mimo=jcfg.MIMOConfig(scheme=jcfg.MIMOScheme.ALAMOUTI, n_tx=2, n_rx=2),
        ),
    ],
    ids=["default", "config2_rician", "pilots", "mimo"],
)
def test_config_crosses_over_from_reference(cfg):
    port = interop.link_config_from_reference(cfg)
    assert isinstance(port, LinkConfig)
    assert link_config_to_dict(port) == jcfg.link_config_to_dict(cfg)
    assert port.modulation.bits_per_symbol == cfg.modulation.bits_per_symbol
    assert port.bits_total == cfg.bits_total


def test_port_config_validates_like_reference():
    with pytest.raises(ValueError, match="power of 2"):
        OFDMConfig(n_fft=96)
    with pytest.raises(ValueError, match="delay spread"):
        LinkConfig(ofdm=OFDMConfig(16, 2),
                   channel=ChannelConfig(model=ChannelModel.MULTIPATH, pdp=(1, 1, 1, 1)))
