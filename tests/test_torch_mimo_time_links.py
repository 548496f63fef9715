"""The JAX tests' time-varying and impaired MIMO link gates on the port's
keyed draws (ROADMAP item 11e-ii), on the CPU at the JAX tests' sizes:
``tests/test_mimo.py:577-923`` (Jakes MIMO, the Doppler floor, midamble
tracking, blind array acquisition, the LO walk, I/Q imbalance),
``tests/test_channel_time.py:243-290`` (MIMO on the per-tap-Jakes TDL) and
``tests/test_scfdma.py:298-330`` (SC-FDMA MIMO acquisition). Each gate has
the JAX test's form and bounds; the JAX tests' key numbers are the seeds
(``_run_ber(cfg, n_seeds)`` sums seeds 0 … n_seeds−1). A link that two
gates share runs once (``_run`` is cached).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

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
    link_config_from_dict,
    link_config_to_dict,
)
from sdr_tpu_torch.link import pipeline
from sdr_tpu_torch.link.ber import ber_alamouti_exact, ber_mrc_exact

torch.set_num_threads(1)

_A, _M, _X = MIMOScheme.ALAMOUTI, MIMOScheme.MRC, MIMOScheme.SPATIAL_MUX
_BASE = dict(
    modulation=Modulation.QPSK,
    ofdm=OFDMConfig(n_fft=64, cp_len=16),
    channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=5.0),
    equalizer=Equalizer.MMSE,
    n_symbols=16,
    n_channels=2048,
)


@functools.lru_cache(maxsize=None)
def _run(cfg: LinkConfig, seed: int):
    """(bit errors (B,), bits counted (B,)) of ``pipeline.simulate``."""
    r = pipeline.simulate(cfg, seed, device="cpu")
    return r.bit_errors.numpy(), r.bits_counted.numpy()


def _run_ber(cfg: LinkConfig, n_seeds: int = 2) -> float:
    e = b = 0
    for seed in range(n_seeds):
        err, cnt = _run(cfg, seed)
        e += int(err.sum())
        b += int(cnt.sum())
    return e / b


def _jakes_cfg(doppler, mimo, ebno=5.0, n_channels=2048, **over):
    base = dict(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                channel=ChannelConfig(model=ChannelModel.RAYLEIGH_TIME, ebno_db=ebno,
                                      doppler_norm=doppler),
                equalizer=Equalizer.MMSE, n_symbols=16, n_channels=n_channels)
    base.update(over)
    return LinkConfig(**base, mimo=mimo)


@pytest.mark.parametrize("mimo,theory", [
    (MIMOConfig(_A, 2, 1), lambda: ber_alamouti_exact(Modulation.QPSK, 5.0, 1)),
    (MIMOConfig(_M, 1, 2), lambda: ber_mrc_exact(Modulation.QPSK, 5.0, 2)),
], ids=["alamouti_2x1", "mrc_1x2"])
def test_jakes_mimo_slow_fading_matches_flat_theory(mimo, theory):
    """tests/test_mimo.py:577-587: at fd 1e-5 per-symbol Jakes is
    frame-constant Rayleigh: within 15 % of the flat diversity theory, two
    seeds of 2048 channels."""
    b = _run_ber(_jakes_cfg(1e-5, mimo))
    assert theory() * 0.85 < b < theory() * 1.15, (b, theory())


def test_jakes_mimo_mux_per_symbol_genie():
    """tests/test_mimo.py:590-611: ML with per-symbol genie CSI at fd 0.2
    within (0.6, 1.4) × the flat link; SIC at fd 0.2 runs (0 < BER < 0.5)."""
    flat = LinkConfig(**{**_BASE, "n_channels": 1024},
                      mimo=MIMOConfig(_X, 2, 2, detector="ml"))
    fast = _jakes_cfg(0.2, MIMOConfig(_X, 2, 2, detector="ml"), n_channels=1024)
    b_flat, b_fast = _run_ber(flat, 1), _run_ber(fast, 1)
    assert 0.6 < b_fast / b_flat < 1.4, (b_fast, b_flat)
    b_sic = _run_ber(_jakes_cfg(0.2, MIMOConfig(_X, 2, 2, detector="sic"), n_channels=512), 1)
    assert 0 < b_sic < 0.5


def test_jakes_alamouti_doppler_floor():
    """tests/test_mimo.py:614-625: Alamouti 2 × 2 at 20 dB, fd 0.3 above 5 ×
    max(fd 1e-4, 1e-6)."""
    slow = _run_ber(_jakes_cfg(1e-4, MIMOConfig(_A, 2, 2), ebno=20.0), 1)
    fast = _run_ber(_jakes_cfg(0.3, MIMOConfig(_A, 2, 2), ebno=20.0), 1)
    assert fast > 5 * max(slow, 1e-6), (fast, slow)


def test_jakes_mimo_head_preamble_rejected():
    """tests/test_mimo.py:628-641: the port's config refuses a head preamble
    under Doppler, a midamble without the preamble, and S not a multiple of
    the period."""
    with pytest.raises(ValueError):
        _jakes_cfg(0.05, MIMOConfig(_M, 1, 2, csi="preamble"))
    with pytest.raises(ValueError):
        MIMOConfig(_M, 1, 2, midamble_period=8)
    with pytest.raises(ValueError):
        _jakes_cfg(0.05, MIMOConfig(_M, 1, 2, csi="preamble", midamble_period=5))


def test_jakes_mimo_midamble_tracks_channel():
    """tests/test_mimo.py:644-661: K 4 tracked < 2 × genie at fd 0.005; at
    fd 0.08 and 15 dB K 2 < 0.7 × K 16."""
    def mk(dop, period, **kw):
        return _jakes_cfg(dop, MIMOConfig(_M, 1, 2, csi="preamble", midamble_period=period),
                          **kw)

    genie = _run_ber(_jakes_cfg(0.005, MIMOConfig(_M, 1, 2)), 1)
    tracked = _run_ber(mk(0.005, 4), 1)
    assert tracked < 2.0 * genie, (tracked, genie)
    tight = _run_ber(mk(0.08, 2, ebno=15.0), 1)
    loose = _run_ber(mk(0.08, 16, ebno=15.0), 1)
    assert tight < 0.7 * loose, (tight, loose)


def test_midamble_config_roundtrip():
    """tests/test_mimo.py:664-680: the midamble config round-trips; the mux
    ML detector on the tracked estimates runs (BER in [0, 0.5) on 256
    channels); a midamble on a frame-static link is refused."""
    cfg = _jakes_cfg(0.02, MIMOConfig(_X, 2, 2, csi="preamble", detector="ml",
                                      midamble_period=8))
    assert link_config_from_dict(link_config_to_dict(cfg)) == cfg
    assert 0 <= _run_ber(dataclasses.replace(cfg, n_channels=256), 1) < 0.5
    with pytest.raises(ValueError):
        LinkConfig(**_BASE, mimo=MIMOConfig(_M, 1, 2, csi="preamble", midamble_period=4))


def _acq_pair():
    base = LinkConfig(**{**_BASE, "estimator": ChannelEstimator.DFT,
                         "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0),
                         "n_channels": 1024},
                      mimo=MIMOConfig(_A, 2, 2, csi="preamble"))
    acq = dataclasses.replace(
        base, channel=dataclasses.replace(base.channel, cfo_subcarriers=1.3, timing_offset=37),
        mimo=MIMOConfig(_A, 2, 2, csi="preamble", midamble_period=4))
    return base, acq


def test_mimo_acquisition_blind():
    """tests/test_mimo.py:683-752: Alamouti 2 × 2 with CFO 1.3 and offset 37
    (K 4, DFT, 8 dB, 1024 channels, seed 0): outage (per-channel BER >
    0.25) < 5 %, in-lock mean < 3 × max(aligned mean, 5e-4); mux ML through
    the same front end 0 < BER < 0.2 (256 channels); the config refuses the
    head preamble alone and genie CSI with a CFO."""
    base, acq = _acq_pair()
    ea, ca = _run(base, 0)
    eq, cq = _run(acq, 0)
    ba, bq = ea / ca, eq / cq
    outage = float((bq > 0.25).mean())
    assert outage < 0.05, outage
    in_lock = bq[bq <= 0.25]
    assert in_lock.mean() < 3.0 * max(ba.mean(), 5e-4), (in_lock.mean(), ba.mean())
    mux = dataclasses.replace(acq, mimo=MIMOConfig(_X, 2, 2, csi="preamble", detector="ml",
                                                   midamble_period=4), n_channels=256)
    assert 0 < _run_ber(mux, 1) < 0.2
    with pytest.raises(ValueError):
        dataclasses.replace(acq, mimo=MIMOConfig(_A, 2, 2, csi="preamble"))
    with pytest.raises(ValueError):
        LinkConfig(**{**_BASE, "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT,
                                                        ebno_db=8.0, cfo_subcarriers=1.0)},
                   mimo=MIMOConfig(_A, 2, 2))


def test_mimo_acquisition_composes_with_mixer_impairments():
    """tests/test_mimo.py:755-791: acquisition + LO walk 2e-3 + I/Q (1.05,
    0.03), Alamouti 2 × 2 K 4, 32 symbols, 256 channels, seed 1: below 1.5
    × the clean-mixer acquired link."""
    def mk(pn=0.0, iqg=1.0, iqp=0.0):
        return LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(64, 16),
                          channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0,
                                                cfo_subcarriers=1.3, timing_offset=37,
                                                phase_noise_std=pn, iq_gain=iqg,
                                                iq_phase_rad=iqp),
                          mimo=MIMOConfig(_A, 2, 2, csi="preamble", midamble_period=4),
                          equalizer=Equalizer.MMSE, n_symbols=32, n_channels=256)

    def ber(cfg):
        err, cnt = _run(cfg, 1)
        return int(err.sum()) / int(cnt.sum())

    b_clean = ber(mk())
    b_full = ber(mk(pn=2e-3, iqg=1.05, iqp=0.03))
    assert b_full < 1.5 * b_clean, (b_full, b_clean)


def test_mimo_acquisition_composes_with_jakes():
    """tests/test_mimo.py:794-839: MRC 1 × 2 under Jakes fd 0.02 (5 dB, 32
    symbols, 64 channels, seed 3): acquired (CFO 1.7, offset 21, K 4)
    outages ≤ 3, in-lock mean ≤ 2 × max(genie mean, 1), in-lock sum ≤ 1.5 ×
    the aligned midamble link's."""
    def cfg(csi, cfo=0.0, to=0, midamble=0):
        return _jakes_cfg(0.02, MIMOConfig(_M, 1, 2, csi=csi, midamble_period=midamble),
                          n_channels=64, n_symbols=32,
                          channel=ChannelConfig(model=ChannelModel.RAYLEIGH_TIME, ebno_db=5.0,
                                                doppler_norm=0.02, cfo_subcarriers=cfo,
                                                timing_offset=to))

    e_g, c_g = _run(cfg("genie"), 3)
    e_m, _ = _run(cfg("preamble", midamble=4), 3)
    e_a, _ = _run(cfg("preamble", 1.7, 21, midamble=4), 3)
    t = float(c_g[0])
    in_lock = e_a[e_a / t <= 0.25]
    outages = int((e_a / t > 0.25).sum())
    assert outages <= 3, outages
    assert in_lock.mean() <= 2.0 * max(e_g.mean(), 1.0), (in_lock.mean(), e_g.mean())
    assert in_lock.sum() <= 1.5 * e_m.sum(), (in_lock.sum(), e_m.sum())


def test_mimo_phase_noise_midamble_tracked():
    """tests/test_mimo.py:842-899: the walk (2e-3) with K 4 below 1.8 × the
    clean head-preamble link (1024 channels, 8 dB); genie CSI and the head
    preamble alone are refused; MULTIPATH (1, .5) + the walk, mux ML on the
    DFT midamble estimates at 14 dB: 0 < BER < 0.1 (256 channels)."""
    base = LinkConfig(**{**_BASE, "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT,
                                                           ebno_db=8.0),
                         "n_channels": 1024},
                      mimo=MIMOConfig(_A, 2, 2, csi="preamble"))
    pn = dataclasses.replace(base, channel=dataclasses.replace(base.channel,
                                                               phase_noise_std=2e-3),
                             mimo=dataclasses.replace(base.mimo, midamble_period=4))
    b_clean, b_pn = _run_ber(base, 1), _run_ber(pn, 1)
    assert b_pn < 1.8 * b_clean, (b_pn, b_clean)
    walk = ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0, phase_noise_std=2e-3)
    with pytest.raises(ValueError):
        LinkConfig(**{**_BASE, "channel": walk}, mimo=MIMOConfig(_A, 2, 2))
    with pytest.raises(ValueError):
        LinkConfig(**{**_BASE, "channel": walk}, mimo=MIMOConfig(_A, 2, 2, csi="preamble"))
    sel = LinkConfig(**{**_BASE, "channel": ChannelConfig(model=ChannelModel.MULTIPATH,
                                                          ebno_db=14.0, pdp=(1.0, 0.5),
                                                          phase_noise_std=2e-3),
                        "estimator": ChannelEstimator.DFT, "n_channels": 256},
                     mimo=MIMOConfig(_X, 2, 2, detector="ml", csi="preamble",
                                     midamble_period=4))
    assert 0 < _run_ber(sel, 1) < 0.1


def test_mimo_iq_imbalance_compensated():
    """tests/test_mimo.py:902-923: per-antenna I/Q (1.05, 0.03) with blind
    compensation and the DFT preamble estimate below 1.6 × the matched
    mixer (2048 channels, 8 dB); genie CSI with I/Q is refused."""
    base = LinkConfig(**{**_BASE, "estimator": ChannelEstimator.DFT,
                         "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0)},
                      mimo=MIMOConfig(_A, 2, 2, csi="preamble"))
    imb = dataclasses.replace(base, channel=dataclasses.replace(base.channel, iq_gain=1.05,
                                                                iq_phase_rad=0.03))
    b_clean, b_imb = _run_ber(base, 1), _run_ber(imb, 1)
    assert b_imb < 1.6 * b_clean, (b_imb, b_clean)
    with pytest.raises(ValueError):
        LinkConfig(**{**_BASE, "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT,
                                                        ebno_db=8.0, iq_gain=1.05)},
                   mimo=MIMOConfig(_A, 2, 2))


def test_mimo_multipath_time_diversity():
    """tests/test_channel_time.py:243-290: over the per-tap-Jakes TDL (PDP
    (1, .5, .25), fd 0.02, 16-QAM 16 dB, 64 channels) Alamouti 2 × 2 <
    MRC 1 × 2 < SISO (seeds 0, 1, 0); the K 4 midamble Alamouti link below
    0.05 and its DFT twin below it (seed 2)."""
    pdp = (1.0, 0.5, 0.25)

    def mk(scheme=None, ntx=1, nrx=1, mid=0, estimator=ChannelEstimator.LS):
        mimo = None if scheme is None else MIMOConfig(
            scheme=scheme, n_tx=ntx, n_rx=nrx, csi="preamble" if mid else "genie",
            midamble_period=mid)
        return LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                          channel=ChannelConfig(model=ChannelModel.MULTIPATH_TIME, ebno_db=16.0,
                                                pdp=pdp, doppler_norm=0.02),
                          equalizer=Equalizer.MMSE, estimator=estimator, mimo=mimo,
                          n_symbols=16, n_channels=64)

    def mean_ber(cfg, seed):
        err, cnt = _run(cfg, seed)
        return float((err / cnt).mean())

    b_siso = mean_ber(mk(), 0)
    b_alam = mean_ber(mk(_A, 2, 2), 0)
    b_mrc = mean_ber(mk(_M, 1, 2), 1)
    assert b_alam < b_mrc < b_siso, (b_alam, b_mrc, b_siso)
    b_mid = mean_ber(mk(_A, 2, 2, mid=4), 2)
    assert b_mid < 0.05, b_mid
    b_dft = mean_ber(mk(_A, 2, 2, mid=4, estimator=ChannelEstimator.DFT), 2)
    assert b_dft < b_mid, (b_dft, b_mid)


def test_scfdma_mimo_acquisition():
    """tests/test_scfdma.py:298-330: SC-FDMA Alamouti 2 × 2 with CFO 1.3 and
    offset 37 (K 4, 8 dB, 32 symbols, 256 channels, seed 1): outage < 5 %,
    in-lock mean < 2.5 × max(aligned mean, 1)."""
    def mk(cfo, to):
        return LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(64, 16),
                          channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0,
                                                cfo_subcarriers=cfo, timing_offset=to),
                          mimo=MIMOConfig(_A, 2, 2, csi="preamble",
                                          midamble_period=4 if cfo else 0),
                          equalizer=Equalizer.MMSE, n_symbols=32, n_channels=256,
                          dft_spread=True)

    e_al, _ = _run(mk(0.0, 0), 1)
    e_acq, _ = _run(mk(1.3, 37), 1)
    t = 32 * 64 * 2
    assert (e_acq / t > 0.25).mean() < 0.05
    in_lock = e_acq[e_acq / t <= 0.25]
    assert in_lock.mean() < 2.5 * max(e_al.mean(), 1.0), (in_lock.mean(), e_al.mean())
    assert np.all(np.isfinite(e_acq))
