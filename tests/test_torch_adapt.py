"""The port's link adaptation (sdr_tpu_torch.link.adapt) on the CPU, held
against the JAX ``sdr_tpu.link.adapt``.

- The ladder functions exactly: ``DEFAULT_LADDER``, ``_norm_rung``,
  ``waveform_ladder``, ``efficiency`` (the realized rates, polar's CRC
  counted), ``esno_from_ebno`` / ``ebno_from_esno``; ``select_mcs`` picks
  the JAX entry on random tables, SNRs and margins.
- ``calibrate``'s binary search, its infeasible-rung skip and realized
  efficiency, and ``simulate_adaptive``'s grouping by (rung, SNR bin),
  exactly: the same deterministic coded-link stub (``_stub_counts``, a BER
  curve per family and rate, raising ValueError where an LDPC codeword
  does not fit the frame) monkeypatched into both packages — the JAX
  ``link.coded.make_family_fn`` and the port's ``link.coded.family_core``
  — so no coded link runs; the tables, the stub's call sequences and the
  adaptive results compared entry for entry.
- The JAX ``tests/test_adapt.py`` gates on the port's own coded links
  (CPU, keyed draws) at the JAX tests' sizes (``_BASE``, ``_LADDER``,
  ``_MIXED_BASE``, the dense rungs, the PA waveform flip), the JAX tests'
  key numbers as seeds. The JAX ``_pin_precision`` test has no
  counterpart: the port has no TPU matmul mode to pin.
"""

import dataclasses
import inspect
import math

import jax
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.link import adapt as jadapt
from sdr_tpu.link import coded as jcoded
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelEstimator,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.link import adapt, coded

torch.set_num_threads(1)

J_BASE = jcfg.LinkConfig(modulation=jcfg.Modulation.QPSK, ofdm=jcfg.OFDMConfig(64, 16),
                         channel=jcfg.ChannelConfig(model=jcfg.ChannelModel.AWGN, ebno_db=10.0),
                         equalizer=jcfg.Equalizer.NONE, n_symbols=16, n_channels=8)
BASE = interop.link_config_from_reference(J_BASE)
LADDER = ((Modulation.QPSK, "1/2"), (Modulation.QPSK, "3/4"), (Modulation.QAM16, "1/2"),
          (Modulation.QAM16, "3/4"))
MIXED_BASE = dataclasses.replace(BASE, ofdm=OFDMConfig(n_fft=128, cp_len=16), n_channels=4)


def _rung_values(rung):
    return tuple(x.value if hasattr(x, "value") else x for x in rung)


# ---- the ladder functions and selection -------------------------------------------------------

def test_ladder_functions_equal_jax():
    assert [_rung_values(r) for r in adapt.DEFAULT_LADDER] == [
        _rung_values(r) for r in jadapt.DEFAULT_LADDER]
    rungs = adapt.DEFAULT_LADDER + LADDER + ((Modulation.QAM16, "ldpc", "3/4", "scfdma"),)
    j_rungs = jadapt.DEFAULT_LADDER + tuple(
        (jcfg.Modulation(r[0].value), *r[1:]) for r in rungs[len(adapt.DEFAULT_LADDER):])
    for rung, j_rung in zip(rungs, j_rungs):
        assert _rung_values(adapt._norm_rung(rung)) == _rung_values(jadapt._norm_rung(j_rung))
    assert [_rung_values(r) for r in adapt.waveform_ladder()] == [
        _rung_values(r) for r in jadapt.waveform_ladder()]
    for mod, family, rate in adapt.DEFAULT_LADDER:
        jmod = jcfg.Modulation(mod.value)
        assert adapt.efficiency(mod, rate, family) == jadapt.efficiency(jmod, rate, family)
        for db in (-3.0, 7.0, 21.5):
            e = adapt.esno_from_ebno(db, mod, rate, family)
            assert e == jadapt.esno_from_ebno(db, jmod, rate, family)
            assert adapt.ebno_from_esno(db, mod, rate, family) == jadapt.ebno_from_esno(
                db, jmod, rate, family)
            assert math.isclose(adapt.ebno_from_esno(e, mod, rate, family), db, abs_tol=1e-12)
    assert adapt.efficiency(Modulation.QAM16, "3/4") == 3.0


def _random_table(rng, n):
    mods = list(jcfg.Modulation)
    return [jadapt.MCSThreshold(mods[rng.integers(len(mods))], ("1/2", "2/3", "3/4")[i % 3],
                                float(rng.choice([0.5, 1.0, 1.5, 2.0, 3.0])),
                                float(rng.integers(-2, 30)), 1e-4,
                                ("conv", "ldpc", "polar")[rng.integers(3)],
                                ("ofdm", "scfdma")[i % 2])
            for i in range(n)]


def test_select_mcs_equals_jax():
    rng = np.random.default_rng(24)
    for _ in range(20):
        j_table = _random_table(rng, 12)
        table = interop.mcs_table_from_reference(j_table)
        for snr in rng.uniform(-5.0, 35.0, 10):
            for margin in (0.0, 3.0):
                want = jadapt.select_mcs(float(snr), j_table, margin)
                got = adapt.select_mcs(float(snr), table, margin)
                assert (got is None) == (want is None)
                if want is not None:
                    assert table.index(got) == j_table.index(want)


# ---- calibrate and simulate_adaptive on the same stub --------------------------------------------

def _stub_counts(cfg, family, rate):
    """Deterministic per-channel (errors, counted) int64 of a config: a BER
    curve in Eb/N0 per family and rate, the counts spread over the group's
    channels by their index in it. Raises ValueError where an LDPC
    codeword does not fit the frame (the families' eager check)."""
    bps = cfg.modulation.bits_per_symbol
    frame = cfg.n_symbols * cfg.ofdm.n_fft * bps
    if family == "ldpc" and frame < 3072:
        raise ValueError("frame cannot fit an n=3072 codeword")
    n = cfg.n_channels
    nominal = int(rate[0]) / int(rate[2])
    counted = np.full(n, int(frame * nominal) - (11 if family == "polar" else 0), np.int64)
    gain = {"conv": 1.0, "ldpc": 1.4, "polar": 1.25}[family] * (1.0 + 0.2 * cfg.dft_spread)
    snr = 10.0 ** (cfg.channel.ebno_db / 10.0) * gain / nominal / math.log2(max(bps, 2))
    ber = 0.5 * math.erfc(math.sqrt(snr))
    errors = np.floor(ber * counted * (1.0 + 0.25 * (np.arange(n) % 3))).astype(np.int64)
    return errors, counted


def _install_stubs(monkeypatch):
    """The stub into both packages; returns the two call logs."""
    j_calls, calls = [], []

    def j_make_family_fn(cfg, family, rate="1/2", **kw):
        errors, counted = _stub_counts(cfg, family, rate)
        j_calls.append((cfg.modulation.value, family, rate, cfg.channel.ebno_db, cfg.n_channels,
                        cfg.dft_spread))
        return lambda key: (errors, counted)

    def family_core(cfg, family, rate="1/2", **kw):
        errors, counted = _stub_counts(cfg, family, rate)

        def fn(seed, ids):
            assert ids.shape == (cfg.n_channels,)
            calls.append((cfg.modulation.value, family, rate, cfg.channel.ebno_db,
                          cfg.n_channels, cfg.dft_spread))
            return torch.from_numpy(errors), torch.from_numpy(counted)

        return fn

    monkeypatch.setattr(jcoded, "make_family_fn", j_make_family_fn)
    monkeypatch.setattr(coded, "family_core", family_core)
    return j_calls, calls


STUB_GRID = np.arange(-2.0, 37.0, 2.0)


@pytest.mark.parametrize("waveforms", [False, True], ids=["default", "waveform"])
def test_calibrate_and_adaptive_equal_jax_on_a_stub(monkeypatch, waveforms):
    j_calls, calls = _install_stubs(monkeypatch)
    ladder = adapt.waveform_ladder() if waveforms else adapt.DEFAULT_LADDER
    j_ladder = jadapt.waveform_ladder() if waveforms else jadapt.DEFAULT_LADDER
    j_base = dataclasses.replace(J_BASE, n_symbols=8)  # 1024-bit BPSK frames: LDPC skips
    base = interop.link_config_from_reference(j_base)
    j_table = jadapt.calibrate(j_base, jax.random.PRNGKey(0), 1e-3, STUB_GRID, j_ladder)
    table = adapt.calibrate(base, 0, 1e-3, STUB_GRID, ladder, device="cpu")
    assert table == interop.mcs_table_from_reference(j_table)
    assert calls == j_calls
    assert 0 < len(table) < len(ladder)  # infeasible rungs skipped on both sides
    profile = np.random.default_rng(7).normal(14.0, 9.0, 64)
    for margin, quantum in ((0.0, 1.0), (2.0, 3.0)):
        del j_calls[:], calls[:]
        want = jadapt.simulate_adaptive(j_base, jax.random.PRNGKey(1), profile, j_table,
                                        margin, quantum)
        got = adapt.simulate_adaptive(base, 1, profile, table, margin, quantum, device="cpu")
        assert calls == j_calls and len(calls) > 3
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k], k


def test_calibrate_propagates_an_error_of_the_links_run(monkeypatch):
    """Only ``family_core``'s frame-fit check marks a rung infeasible: a
    ValueError raised while the link runs (a kernel wrapper refusing its
    operands) leaves ``calibrate`` instead of silently dropping the rung."""
    def family_core(cfg, family, rate="1/2", **kw):
        def fn(seed, ids):
            raise ValueError("ldpc_decode: operands must be contiguous")

        return fn

    monkeypatch.setattr(coded, "family_core", family_core)
    with pytest.raises(ValueError, match="contiguous"):
        adapt.calibrate(BASE, 0, 1e-3, STUB_GRID, LADDER[:1], device="cpu")


# ---- the JAX tests' gates on the port's coded links --------------------------------------------

@pytest.fixture(scope="module")
def table():
    return adapt.calibrate(BASE, 0, target_ber=1e-3, esno_grid=np.arange(-2.0, 20.0, 2.0),
                           ladder=LADDER, device="cpu")


def test_calibrated_thresholds_monotone(table):
    """More efficient rungs need more SNR; every rung met the target
    (tests/test_adapt.py:68-77)."""
    assert len(table) == len(LADDER)
    effs = [t.efficiency for t in table]
    ths = [t.esno_db for t in table]
    assert effs == sorted(effs)
    for a, b in zip(ths, ths[1:]):
        assert b >= a, ths
    for t in table:
        assert t.measured_ber <= 1e-3


def test_select_mcs_greedy(table):
    """tests/test_adapt.py:80-92."""
    top = max(t.efficiency for t in table)
    assert adapt.select_mcs(30.0, table).efficiency == top
    lowest = table[0]
    assert adapt.select_mcs(lowest.esno_db, table) is not None
    assert adapt.select_mcs(lowest.esno_db - 0.1, table) is None
    mid = table[-1].esno_db
    no_m = adapt.select_mcs(mid, table)
    with_m = adapt.select_mcs(mid, table, margin_db=6.0)
    assert with_m is None or with_m.efficiency <= no_m.efficiency


def test_adaptive_link_tracks_profile(table):
    """tests/test_adapt.py:95-118, seeds 1 and 2."""
    lo = adapt.simulate_adaptive(BASE, 1, np.full(8, 4.0), table, device="cpu")
    hi = adapt.simulate_adaptive(BASE, 1, np.full(8, 18.0), table, device="cpu")
    assert hi["achieved_efficiency"] > 2.0 * lo["achieved_efficiency"]
    mixed = adapt.simulate_adaptive(BASE, 2, np.array([-6.0, 2.0, 6.0, 10.0, 14.0, 18.0, 18.0,
                                                       2.0]), table, device="cpu")
    eff = mixed["efficiency_per_channel"]
    assert eff[0] == 0.0
    assert eff[5] >= eff[3] >= eff[1]
    total_ber = mixed["bit_errors"].sum() / max(mixed["info_bits"].sum(), 1)
    assert total_ber < 5e-3, total_ber


@pytest.fixture(scope="module")
def mixed_table():
    return adapt.calibrate(MIXED_BASE, 3, target_ber=1e-3, esno_grid=np.arange(-2.0, 14.0, 1.0),
                           ladder=((Modulation.QPSK, "conv", "1/2"),
                                   (Modulation.QPSK, "ldpc", "1/2"),
                                   (Modulation.QPSK, "polar", "1/2")), device="cpu")


def test_mixed_family_calibration(mixed_table):
    """tests/test_adapt.py:149-156."""
    fams = {t.family: t for t in mixed_table}
    assert set(fams) == {"conv", "ldpc", "polar"}
    assert fams["ldpc"].esno_db <= fams["conv"].esno_db
    assert fams["polar"].esno_db <= fams["conv"].esno_db + 1.0


def test_select_prefers_stronger_family_on_tie():
    """tests/test_adapt.py:159-168."""
    t_conv = adapt.MCSThreshold(Modulation.QPSK, "1/2", 1.0, 4.0, 1e-4, "conv")
    t_ldpc = adapt.MCSThreshold(Modulation.QPSK, "1/2", 1.0, 2.0, 1e-4, "ldpc")
    assert adapt.select_mcs(10.0, [t_conv, t_ldpc]).family == "ldpc"
    assert adapt.select_mcs(1.0, [t_conv, t_ldpc]) is None


def test_adaptive_uses_block_codes_where_they_win(mixed_table):
    """tests/test_adapt.py:171-185, seed 4: between the block-code and conv
    thresholds the adaptive link transmits with the stronger family."""
    ordered = sorted(mixed_table, key=lambda t: t.esno_db)
    best, runner_up = ordered[0], ordered[1]
    assert best.family != "conv" and best.esno_db < runner_up.esno_db, ordered
    snr = (best.esno_db + runner_up.esno_db) / 2.0
    res = adapt.simulate_adaptive(MIXED_BASE, 4, np.full(4, snr), mixed_table, device="cpu")
    assert set(res["family_per_channel"]) == {best.family}


def test_dense_rungs_calibrate_and_extend_staircase():
    """tests/test_adapt.py:188-220, seed 1."""
    mods = {r[0] for r in adapt.DEFAULT_LADDER}
    assert Modulation.QAM256 in mods and Modulation.QAM1024 in mods
    dense = ((Modulation.QAM64, "conv", "3/4"), (Modulation.QAM256, "ldpc", "3/4"),
             (Modulation.QAM1024, "ldpc", "3/4"))
    tab = adapt.calibrate(dataclasses.replace(BASE, n_symbols=32), 1, target_ber=1e-3,
                          esno_grid=np.arange(14.0, 37.0, 2.0), ladder=dense, device="cpu")
    by_mod = {t.modulation: t for t in tab}
    assert Modulation.QAM256 in by_mod and Modulation.QAM1024 in by_mod
    q64, q256, q1024 = (by_mod[m] for m in (Modulation.QAM64, Modulation.QAM256,
                                             Modulation.QAM1024))
    assert q64.esno_db < q256.esno_db < q1024.esno_db
    assert q64.efficiency < q256.efficiency < q1024.efficiency


def test_waveform_dimension_flips_under_pa():
    """tests/test_adapt.py:242-279, seed 2: under a low-backoff PA the
    SC-FDMA twin calibrates lower than OFDM, and selection picks it."""
    base = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=128, cp_len=16),
                      channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0,
                                            pa_ibo_db=2.0),
                      equalizer=Equalizer.MMSE, pilot_spacing=8,
                      estimator=ChannelEstimator.DFT, n_symbols=32, n_channels=16)
    ladder = adapt.waveform_ladder(((Modulation.QAM16, "conv", "1/2"),))
    assert ladder == ((Modulation.QAM16, "conv", "1/2", "ofdm"),
                      (Modulation.QAM16, "conv", "1/2", "scfdma"))
    tab = adapt.calibrate(base, 2, target_ber=1e-3, esno_grid=np.arange(5.0, 30.0, 1.0),
                          ladder=ladder, device="cpu")
    by_wave = {t.waveform: t for t in tab}
    assert "scfdma" in by_wave, tab
    if "ofdm" in by_wave:
        assert by_wave["scfdma"].esno_db < by_wave["ofdm"].esno_db, tab
    assert adapt.select_mcs(30.0, tab).waveform == "scfdma"


def test_entry_points_default_to_the_card():
    for fn in (adapt.calibrate, adapt.simulate_adaptive):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            adapt.calibrate(BASE, 0, ladder=LADDER[:1], esno_grid=[0.0])
