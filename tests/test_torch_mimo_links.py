"""The JAX tests' MIMO link gates on the port's keyed draws (ROADMAP item
11e-i), on the CPU at the JAX tests' sizes: ``tests/test_mimo.py:153-500``
(the diversity theory, spatial mux, multipath, Rician, ML, SIC, the head
preamble), ``tests/test_scfdma.py:240-296`` (SC-FDMA MIMO) and
``tests/test_pa.py:265-326`` (the PA with MIMO). Each gate has the JAX
test's form and bounds; the JAX tests' key numbers are the seeds
(``_run_ber(cfg, n_seeds)`` sums seeds 0 … n_seeds−1). A link that two
gates share runs once (``_ber`` is cached).
"""

import dataclasses
import functools

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
_AT10 = {**_BASE, "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0)}


@functools.lru_cache(maxsize=None)
def _ber(cfg: LinkConfig, n_seeds: int = 1) -> float:
    e = b = 0
    for seed in range(n_seeds):
        r = pipeline.simulate(cfg, seed, device="cpu")
        e += int(r.bit_errors.sum())
        b += int(r.bits_counted.sum())
    return e / b


@pytest.mark.parametrize("mimo,theory", [
    (MIMOConfig(_A, 2, 1), lambda: ber_alamouti_exact(Modulation.QPSK, 5.0, 1)),
    (MIMOConfig(_A, 2, 2), lambda: ber_alamouti_exact(Modulation.QPSK, 5.0, 2)),
    (MIMOConfig(_M, 1, 2), lambda: ber_mrc_exact(Modulation.QPSK, 5.0, 2)),
], ids=["alamouti_2x1", "alamouti_2x2", "mrc_1x2"])
def test_mimo_ber_vs_exact_theory(mimo, theory):
    """tests/test_mimo.py:189-195: within 10 % of the exact MGF-averaged
    theory, two seeds of 2048 channels."""
    ber = _ber(LinkConfig(**_BASE, mimo=mimo), 2)
    assert theory() * 0.90 < ber < theory() * 1.10, (ber, theory())


def test_mux_ber_sane():
    """tests/test_mimo.py:198-208: 2 × 4 below a quarter of 2 × 2 (MMSE), and
    the counted bits double the SISO frame."""
    cfg22 = LinkConfig(**_BASE, mimo=MIMOConfig(_X, 2, 2))
    b22, b24 = _ber(cfg22), _ber(LinkConfig(**_BASE, mimo=MIMOConfig(_X, 2, 4)))
    assert b24 < b22 * 0.25, (b24, b22)
    r = pipeline.simulate(dataclasses.replace(cfg22, n_channels=4), 0, device="cpu")
    assert int(r.bits_counted[0]) == 2 * 16 * 64 * 2


def test_mimo_multipath_frequency_selective():
    """tests/test_mimo.py:211-236: Alamouti 2 × 2 over per-pair multipath at
    30 dB below 1e-4; spatial mux 2 × 4 below 1e-3."""
    cfg = LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                     channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=30.0,
                                           pdp=(1.0, 0.5, 0.25)),
                     equalizer=Equalizer.MMSE, n_symbols=16, n_channels=256,
                     mimo=MIMOConfig(_A, 2, 2))
    assert _ber(cfg) < 1e-4
    assert _ber(dataclasses.replace(cfg, mimo=MIMOConfig(_X, 2, 4))) < 1e-3


def test_mimo_rician():
    """tests/test_mimo.py:239-248: Rician (K 10) Alamouti 2 × 1 beats Rayleigh."""
    ray = LinkConfig(**_BASE, mimo=MIMOConfig(_A, 2, 1))
    ric = LinkConfig(**{**_BASE, "channel": ChannelConfig(model=ChannelModel.RICIAN,
                                                          ebno_db=5.0, k_factor=10.0)},
                     mimo=MIMOConfig(_A, 2, 1))
    assert _ber(ric) < _ber(ray)


def test_ml_beats_linear_mmse():
    """tests/test_mimo.py:304-313: 2 × 2 ML below half of linear MMSE at 10 dB."""
    b_lin = _ber(LinkConfig(**_AT10, mimo=MIMOConfig(_X, 2, 2)))
    b_ml = _ber(LinkConfig(**_AT10, mimo=MIMOConfig(_X, 2, 2, detector="ml")))
    assert b_ml < 0.5 * b_lin, (b_ml, b_lin)


def test_ml_multipath_high_snr_error_free():
    """tests/test_mimo.py:316-329: 16-QAM 2 × 3 ML over multipath at 35 dB."""
    cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                     channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=35.0,
                                           pdp=(1.0, 0.5)),
                     equalizer=Equalizer.MMSE, n_symbols=8, n_channels=64,
                     mimo=MIMOConfig(_X, 2, 3, detector="ml"))
    assert _ber(cfg) < 1e-3


def test_detector_ladder_mmse_sic_ml():
    """tests/test_mimo.py:359-370: ML < SIC < linear MMSE, SIC < 0.8 × MMSE."""
    b = {d: _ber(LinkConfig(**_AT10, mimo=MIMOConfig(_X, 2, 2, detector=d)))
         for d in ("linear", "sic", "ml")}
    assert b["ml"] < b["sic"] < b["linear"], b
    assert b["sic"] < 0.8 * b["linear"], b


def test_sic_4x4_64qam_beyond_ml_budget():
    """tests/test_mimo.py:373-403: 4 × 4 64-QAM ML is refused by the config;
    SIC below 0.8 × linear at 22 dB."""
    base = dict(modulation=Modulation.QAM64, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=22.0),
                equalizer=Equalizer.MMSE, n_symbols=8, n_channels=512)
    with pytest.raises(ValueError):
        LinkConfig(**base, mimo=MIMOConfig(_X, 4, 4, detector="ml"))
    b_sic = _ber(LinkConfig(**base, mimo=MIMOConfig(_X, 4, 4, detector="sic")))
    b_lin = _ber(LinkConfig(**base, mimo=MIMOConfig(_X, 4, 4)))
    assert b_sic < 0.8 * b_lin, (b_sic, b_lin)


@pytest.mark.parametrize("mimo", [
    MIMOConfig(_A, 2, 2, csi="preamble"),
    MIMOConfig(_M, 1, 2, csi="preamble"),
    MIMOConfig(_X, 2, 2, csi="preamble", detector="ml"),
], ids=["alamouti_2x2", "mrc_1x2", "mux_2x2_ml"])
def test_preamble_ber_near_genie(mimo):
    """tests/test_mimo.py:449-469: the DFT estimate within (0.8, 3) × genie,
    LS within (0.8, 12) × genie, DFT below LS, at 5 dB."""
    genie = _ber(LinkConfig(**_BASE, mimo=dataclasses.replace(mimo, csi="genie")))
    est_ls = _ber(LinkConfig(**_BASE, mimo=mimo))
    est_dft = _ber(LinkConfig(**{**_BASE, "estimator": ChannelEstimator.DFT}, mimo=mimo))
    assert genie * 0.8 < est_dft < 3.0 * genie, (est_dft, genie)
    assert genie * 0.8 < est_ls < 12.0 * genie, (est_ls, genie)
    assert est_dft < est_ls, (est_dft, est_ls)


def test_preamble_dft_beats_ls_end_to_end():
    """tests/test_mimo.py:472-492: multipath Alamouti 2 × 2, 16-QAM 9 dB."""
    base = dict(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=9.0,
                                      pdp=(1.0, 0.6, 0.3)),
                equalizer=Equalizer.MMSE, n_symbols=16, n_channels=1024,
                mimo=MIMOConfig(_A, 2, 2, csi="preamble"))
    b_ls = _ber(LinkConfig(**base))
    b_dft = _ber(LinkConfig(**{**base, "estimator": ChannelEstimator.DFT}))
    assert b_dft < b_ls, (b_dft, b_ls)


def _scfdma(dft, scheme=_A, ntx=2, nrx=2, model=ChannelModel.RAYLEIGH_FLAT, ibo=None, **ch):
    return LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(64, 16),
                      channel=ChannelConfig(model=model, ebno_db=10.0, pa_ibo_db=ibo, **ch),
                      mimo=MIMOConfig(scheme=scheme, n_tx=ntx, n_rx=nrx, csi="preamble"),
                      equalizer=Equalizer.MMSE, n_symbols=16, n_channels=512, dft_spread=dft)


def _ber2(cfg):
    """tests/test_scfdma.py's ``_ber(cfg, key=2)``."""
    r = pipeline.simulate(cfg, 2, device="cpu")
    return int(r.bit_errors.sum()) / int(r.bits_counted.sum())


@pytest.mark.parametrize("scheme,ntx,nrx", [(_A, 2, 2), (_M, 1, 2), (_X, 2, 2)],
                         ids=["alamouti", "mrc", "mux"])
def test_scfdma_mimo_within_twice_ofdm(scheme, ntx, nrx):
    """tests/test_scfdma.py:270-276: SC-FDMA MIMO below 2 × its OFDM twin."""
    o, s = _ber2(_scfdma(False, scheme, ntx, nrx)), _ber2(_scfdma(True, scheme, ntx, nrx))
    assert s < 2.0 * o, (s, o)


def test_scfdma_mimo_multipath_and_pa():
    """tests/test_scfdma.py:277-284: under MULTIPATH (1, .3) and under a PA at
    3 dB backoff SC-FDMA beats OFDM; ML is refused with SC-FDMA."""
    mp = dict(model=ChannelModel.MULTIPATH, pdp=(1.0, 0.3))
    assert _ber2(_scfdma(True, **mp)) < _ber2(_scfdma(False, **mp))
    assert _ber2(_scfdma(True, ibo=3.0)) < _ber2(_scfdma(False, ibo=3.0))
    _scfdma(True, _X)
    with pytest.raises(ValueError, match="LINEAR"):
        LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(64, 16),
                   channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0),
                   mimo=MIMOConfig(_X, 2, 2, csi="preamble", detector="ml"), n_symbols=16,
                   dft_spread=True)


def test_pa_composes_with_mimo():
    """tests/test_pa.py:265-318: Alamouti 2 × 2 with the preamble, the PA at
    8 dB backoff below 6 × max(linear, 1e-4), DPD at 4 dB below 8 × it;
    genie CSI with a PA is refused."""
    def mk(ibo=None, dpd=False):
        return LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(64, 16),
                          channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0,
                                                pa_ibo_db=ibo, pa_dpd=dpd),
                          mimo=MIMOConfig(_A, 2, 2, csi="preamble"), equalizer=Equalizer.MMSE,
                          n_symbols=16, n_channels=512)

    b_lin = _ber2(mk())
    assert _ber2(mk(8.0)) < 6.0 * max(b_lin, 1e-4)
    assert _ber2(mk(4.0, True)) < 8.0 * max(b_lin, 1e-4)
    with pytest.raises(ValueError, match="preamble"):
        LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(64, 16),
                   channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0,
                                         pa_ibo_db=6.0),
                   mimo=MIMOConfig(_A, 2, 2, csi="genie"), n_symbols=16)
