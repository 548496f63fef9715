"""The port's Eb/N0 sweep (sdr_tpu_torch.obs.sweep) on the CPU.

The three engines (pipeline, fast, mc) at a tiny size: checkpoint resume (no invocation), top-up
under a larger ``target_errors`` (the same point as a fresh sweep to
that target: the seeds of the resumed batches are not replayed), a
checkpoint without the ``/torch`` suffix is recomputed, and ``theory()``
gives the JAX ``SweepResult.theory`` values.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.obs.sweep import SweepPoint as JSweepPoint
from sdr_tpu.obs.sweep import SweepResult as JSweepResult
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOConfig,
    MIMOScheme,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.link.ber import ber_awgn_exact
from sdr_tpu_torch.obs import sweep

torch.set_num_threads(1)

GRID = (0.0, 3.0, 6.0)


def _cfg(model=ChannelModel.AWGN, **kw):
    return LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=128, cp_len=16),
                      channel=ChannelConfig(model=model), n_symbols=2, n_channels=8, **kw)


def _run(path, engine, target_errors=100, **kw):
    done = []
    res = sweep.ebno_sweep(_cfg(), GRID, seed=11, target_errors=target_errors,
                           max_bits=200_000, checkpoint_path=str(path), progress=done.append,
                           engine=engine, mc_iters=2, device="cpu", **kw)
    return res, done


@pytest.mark.parametrize("engine", ["pipeline", "fast", "mc"])
def test_sweep_resumes_from_checkpoint(tmp_path, engine):
    path = tmp_path / "ck.json"
    first, done = _run(path, engine)
    assert len(done) == len(GRID)
    assert all(p.bit_errors >= 100 or p.bits_counted >= 200_000 for p in first.points)
    suffix = "/torch" if engine == "pipeline" else f"/{engine}/torch"
    assert first.config_summary == sweep._cfg_summary(_cfg()) + suffix
    np.testing.assert_allclose(first.bers()[0], ber_awgn_exact(Modulation.QPSK, 0.0), rtol=0.2)
    again, done = _run(path, engine)
    assert done == [] and again.points == first.points


@pytest.mark.parametrize("engine", ["pipeline", "fast", "mc"])
def test_sweep_tops_up_under_a_larger_target(tmp_path, engine):
    _run(tmp_path / "ck.json", engine, target_errors=100)
    topped, done = _run(tmp_path / "ck.json", engine, target_errors=400)
    assert done and all(p.batches > 1 for p in done)
    fresh, _ = _run(tmp_path / "fresh.json", engine, target_errors=400)
    assert topped.points == fresh.points
    assert all(p.bit_errors >= 400 for p in topped.points)


def test_checkpoint_without_torch_suffix_is_not_resumed(tmp_path):
    path = tmp_path / "ck.json"
    jax_summary = sweep._cfg_summary(_cfg()) + "/fast"
    path.write_text(json.dumps({"config_summary": jax_summary, "points": [
        {"ebno_db": e, "bit_errors": 10**6, "bits_counted": 10**9, "batches": 5} for e in GRID]}))
    res, done = _run(path, "fast")
    assert len(done) == len(GRID) and all(p.bit_errors < 10**6 for p in res.points)
    assert json.loads(path.read_text())["config_summary"] == jax_summary + "/torch"


@pytest.mark.parametrize(
    "model,k_factor",
    [(None, 4.0), (ChannelModel.AWGN, 4.0), (ChannelModel.RAYLEIGH_FLAT, 4.0),
     (ChannelModel.RAYLEIGH_TIME, 4.0), (ChannelModel.RICIAN, 2.5)],
    ids=["default", "awgn", "rayleigh_flat", "rayleigh_time", "rician"],
)
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM64], ids=lambda m: m.value)
def test_theory_matches_reference(model, k_factor, mod):
    pts = [dict(ebno_db=e, bit_errors=1, bits_counted=10) for e in (0.0, 4.5, 9.0, 20.0)]
    got = sweep.SweepResult([sweep.SweepPoint(**p) for p in pts], "s").theory(
        mod, None if model is None else model, k_factor=k_factor)
    want = JSweepResult([JSweepPoint(**p) for p in pts], "s").theory(
        jcfg.Modulation(mod.value), None if model is None else jcfg.ChannelModel(model.value),
        k_factor=k_factor)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_unported_engines_and_options_raise(tmp_path):
    pilots = sweep.ebno_sweep(_cfg(pilot_spacing=4, equalizer=Equalizer.MMSE), GRID[:2],
                              engine="pipeline", target_errors=1, max_bits=1, device="cpu")
    assert [p.ebno_db for p in pilots.points] == list(GRID[:2])
    assert all(p.batches == 1 and p.bits_counted > 0 for p in pilots.points)
    assert "/pilots4:ls" in pilots.config_summary
    coded = sweep.ebno_sweep(dataclasses.replace(_cfg(), n_symbols=16), GRID[:1],
                             engine="pipeline", code="ldpc", target_errors=1, max_bits=1,
                             device="cpu")
    assert coded.config_summary.endswith("/ldpc-1/2/torch")
    assert coded.points[0].batches == 1 and coded.points[0].bits_counted == 8 * 1536
    with pytest.raises(ValueError, match="cannot fit an n=3072 codeword"):
        sweep.ebno_sweep(_cfg(), GRID, engine="pipeline", code="ldpc", device="cpu")
    with pytest.raises(ValueError, match="pipeline engine"):
        sweep.ebno_sweep(_cfg(), GRID, engine="mc", code="ldpc", device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        sweep.ebno_sweep(_cfg(), GRID, engine="xla", device="cpu")
    res = sweep.SweepResult([sweep.SweepPoint(e, 1, 10) for e in (3.0, 9.0)], "s")
    want = JSweepResult([JSweepPoint(e, 1, 10) for e in (3.0, 9.0)], "s")
    for mimo, j_mimo in ((MIMOConfig(), jcfg.MIMOConfig()),
                         (MIMOConfig(MIMOScheme.MRC, 1, 4), jcfg.MIMOConfig(
                             jcfg.MIMOScheme.MRC, 1, 4)),
                         (MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2), jcfg.MIMOConfig(
                             jcfg.MIMOScheme.SPATIAL_MUX, 2, 2))):
        np.testing.assert_allclose(
            res.theory(Modulation.QPSK, ChannelModel.RAYLEIGH_FLAT, mimo=mimo),
            want.theory(jcfg.Modulation.QPSK, jcfg.ChannelModel.RAYLEIGH_FLAT, mimo=j_mimo),
            rtol=0, atol=1e-12)
    assert inspect.signature(sweep.ebno_sweep).parameters["device"].default == "cuda"


def test_default_engine_is_the_pipeline(tmp_path):
    """As in the JAX sweep, the default engine is ``"pipeline"``: its points
    are the pipeline's, and its checkpoint summary carries no engine
    suffix before ``/torch``."""
    assert inspect.signature(sweep.ebno_sweep).parameters["engine"].default == "pipeline"
    res = sweep.ebno_sweep(_cfg(), GRID[:1], seed=3, target_errors=50, max_bits=50_000,
                           device="cpu")
    want, _ = _run(tmp_path / "ck.json", "pipeline", target_errors=50)
    assert res.config_summary == want.config_summary
    seed0 = sweep.invocation_seed(3, 0, 0)
    from sdr_tpu_torch.link.pipeline import simulate

    first = simulate(_cfg(), seed0, device="cpu")
    assert res.points[0].bit_errors >= int(first.bit_errors.sum())


def test_invocation_seeds_are_unique_and_mixed_with_the_seed():
    seeds = {sweep.invocation_seed(5, i, b) for i in range(40) for b in range(300)}
    assert len(seeds) == 40 * 300 and all(0 <= s < 2**31 for s in seeds)
    assert sweep.invocation_seed(5, 0, 0) != sweep.invocation_seed(6, 0, 0)
    assert sweep.invocation_seed(5, 2146, 1_000_002) < 2**31
    for i, b in ((2147, 0), (0, 1_000_003), (-1, 0)):
        with pytest.raises(ValueError):
            sweep.invocation_seed(5, i, b)
