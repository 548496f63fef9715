"""The port's mirror of ``tests/test_config_space.py``: every config of its
sample of the config space either runs in the port's pipeline on the CPU
with finite, sane statistics, or the port's config rejects it — exactly
where the JAX config does. There is no third state (a config both accept
that the pipeline refuses or cannot run fails here).

The sample is the JAX test's ``_sample_space`` (every channel model × a
rotating draw of the other axes, MIMO variants, the MMSE sweep and the
SC-FDMA sweep), built here from either package's config classes.
"""

import itertools

import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu_torch.core import config as tcfg
from sdr_tpu_torch.link import pipeline

torch.set_num_threads(1)


def _sample_space(m):
    """tests/test_config_space.py's sample, of config module ``m``'s
    classes: a list of LinkConfig keyword dicts."""
    mods = [m.Modulation.BPSK, m.Modulation.QPSK, m.Modulation.QAM16, m.Modulation.QAM64]
    eqs = [m.Equalizer.NONE, m.Equalizer.ZF, m.Equalizer.MMSE]
    pilots = [0, 4, 8]
    ests = [m.ChannelEstimator.LS, m.ChannelEstimator.DFT]
    CM, CC = m.ChannelModel, m.ChannelConfig
    chans = [
        CC(model=CM.IDENTITY),
        CC(model=CM.AWGN, ebno_db=8.0),
        CC(model=CM.RAYLEIGH_FLAT, ebno_db=10.0),
        CC(model=CM.RICIAN, ebno_db=8.0, k_factor=5.0),
        CC(model=CM.MULTIPATH, ebno_db=12.0, pdp=(1.0, 0.5)),
        CC(model=CM.RAYLEIGH_TIME, ebno_db=10.0, doppler_norm=0.03),
        CC(model=CM.AWGN, ebno_db=12.0, cfo_subcarriers=0.8, timing_offset=11),
        CC(model=CM.AWGN, ebno_db=12.0, phase_noise_std=2e-3),
        CC(model=CM.MULTIPATH, ebno_db=14.0, pdp=(1.0, 0.3), iq_gain=1.05, iq_phase_rad=0.02),
    ]
    MC, MS = m.MIMOConfig, m.MIMOScheme
    mimos = [
        None,
        MC(MS.ALAMOUTI, 2, 2),
        MC(MS.MRC, 1, 2, csi="preamble"),
        MC(MS.SPATIAL_MUX, 2, 2, detector="ml"),
        MC(MS.SPATIAL_MUX, 2, 3, detector="sic", csi="preamble"),
        MC(MS.MRC, 1, 2, csi="preamble", midamble_period=4),
    ]
    common = dict(ofdm=m.OFDMConfig(n_fft=32, cp_len=8), n_symbols=8, n_channels=2)
    cases = []
    for i, (ch, mimo) in enumerate(itertools.product(chans, mimos)):
        cases.append(dict(modulation=mods[i % len(mods)], channel=ch, equalizer=eqs[i % len(eqs)],
                          estimator=ests[i % len(ests)], pilot_spacing=pilots[i % len(pilots)],
                          mimo=mimo, **common))
    for sweep, spread in ((1, False), (2, True)):
        for i, (ch, mimo) in enumerate(itertools.product(chans, mimos)):
            needs_pilots = bool(ch.impaired or ch.phase_noise_std or ch.iq_imbalanced)
            spacing = 0 if mimo is not None else (4 if needs_pilots else [0, 4][i % 2])
            cases.append(dict(modulation=mods[(i + sweep) % len(mods)], channel=ch,
                              equalizer=m.Equalizer.MMSE, estimator=ests[i % len(ests)],
                              pilot_spacing=spacing, mimo=mimo, dft_spread=spread, **common))
    return cases


CASES = list(zip(_sample_space(jcfg), _sample_space(tcfg)))


def _build(m, kw):
    try:
        return m.LinkConfig(**kw)
    except (ValueError, NotImplementedError):
        return None


def test_the_sample_exercises_both_outcomes():
    """As the JAX test: at least 15 configs built and 15 rejected."""
    built = sum(_build(tcfg, kw) is not None for _, kw in CASES)
    assert built >= 15 and len(CASES) - built >= 15, built


@pytest.mark.parametrize("i", range(len(CASES)))
def test_every_constructible_config_runs(i):
    """Config i is rejected by both packages' configs, or built by both and
    run by the port's pipeline: finite counts, every bit counted, BER in
    [0, 0.55] (1.0 for an unequalised fading link, whose π-rotated fade
    flips every bit), and the config round-trips its dict form."""
    jkw, kw = CASES[i]
    ref, cfg = _build(jcfg, jkw), _build(tcfg, kw)
    assert (ref is None) == (cfg is None), (i, kw)
    if cfg is None:
        return
    r = pipeline.simulate(cfg, 0, device="cpu")
    err, cnt = r.bit_errors.numpy(), r.bits_counted.numpy()
    assert np.all(np.isfinite(err)) and np.all(cnt > 0), cfg
    assert np.all(cnt == cfg.n_data_symbols * cfg.bits_per_ofdm_symbol)
    ber = err.sum() / cnt.sum()
    unequalized_fading = cfg.equalizer == tcfg.Equalizer.NONE and (
        cfg.channel.model not in (tcfg.ChannelModel.IDENTITY, tcfg.ChannelModel.AWGN))
    assert 0.0 <= ber <= (1.0 if unequalized_fading else 0.55), (ber, cfg)
    assert tcfg.link_config_from_dict(tcfg.link_config_to_dict(cfg)) == cfg


def test_noiseless_configs_are_error_free():
    """tests/test_config_space.py:164-177: every IDENTITY config the port
    builds decodes with zero errors (seed 1)."""
    n = 0
    for _, kw in CASES:
        if kw["channel"].model != tcfg.ChannelModel.IDENTITY:
            continue
        cfg = _build(tcfg, kw)
        if cfg is None:
            continue
        n += 1
        assert int(pipeline.simulate(cfg, 1, device="cpu").bit_errors.sum()) == 0, cfg
    assert n > 0
