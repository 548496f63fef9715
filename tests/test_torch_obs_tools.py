"""The port's observability tools on the CPU: the demod roofline against
the JAX model, the health probe, the profiler hook, weak scaling, the BER
figure and the demod route autotuner.

The roofline's traffic model is the JAX module's, so ``bytes_per_sample``
equals the JAX value exactly on every shape and mode. Its operation model
is the port's (kernel C's radix FFT, 5·N·log2 N, plus the JAX module's
tail), so the flops and the bound may differ from the JAX package's (its
MXU matmul-DFT count); the tests hold the port's to its own formula.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.obs import autotune, health, plot, roofline, scaling
from sdr_tpu_torch.obs.profile import TRACE_FILE, trace
from sdr_tpu_torch.obs.sweep import SweepPoint, SweepResult

torch.set_num_threads(1)


@pytest.mark.parametrize("n_fft", [64, 256, 1024, 4096])
def test_roofline_traffic_equals_jax(n_fft):
    from sdr_tpu.core.config import Modulation as JMod
    from sdr_tpu.obs.roofline import demod_roofline as j_roofline

    cp = n_fft // 4
    for mod in (Modulation.QPSK, Modulation.QAM16, Modulation.QAM1024):
        for fused in (True, False):
            for write_llrs in (False, True):
                for nbytes in (4, 2):
                    kw = dict(fused=fused, write_llrs=write_llrs,
                              input_bytes_per_component=nbytes)
                    mine = roofline.demod_roofline(n_fft, cp, mod, **kw)
                    ref = j_roofline(n_fft, cp, JMod(mod.value), **kw)
                    assert mine.bytes_per_sample == ref.bytes_per_sample


@pytest.mark.parametrize("n_fft,cp", [(64, 16), (256, 64), (4096, 512)])
def test_roofline_operations_follow_the_ports_model(n_fft, cp):
    mod = Modulation.QAM16
    chip = roofline.ChipProfile("test", 3350.0, 3000.0, 67.0)
    for fused in (True, False):
        r = roofline.demod_roofline(n_fft, cp, mod, chip=chip, fused=fused,
                                    measured_samples_per_s=1e9)
        want = (5.0 * n_fft * math.log2(n_fft) + n_fft * (10 + 4 * mod.levels_per_axis))
        assert r.flops_per_sample == pytest.approx(want / (n_fft + cp), rel=1e-12)
        t_mem = r.bytes_per_sample / 3000e9
        t_cmp = r.flops_per_sample / 67e12
        assert r.bound == ("memory" if t_mem >= t_cmp else "compute")
        assert r.sol_samples_per_s == pytest.approx(1.0 / max(t_mem, t_cmp), rel=1e-12)
        assert r.sol_samples_per_s_datasheet >= r.sol_samples_per_s
        assert r.efficiency == pytest.approx(1e9 / r.sol_samples_per_s, rel=1e-12)
    assert roofline.demod_roofline(n_fft, cp, mod, chip=chip).efficiency is None


def test_h100_profile_is_the_cards():
    chip = roofline.ChipProfile.h100()
    assert chip.hbm_gbps == 3350.0 and chip.f32_tflops == 67.0
    assert 0 < chip.hbm_gbps_measured <= chip.hbm_gbps
    # The fused receive streams 8 B a sample; the FFT's 5·N·log2 N leaves it
    # memory-bound on the card at N 256.
    assert roofline.demod_roofline(256, 64, Modulation.QAM16).bound == "memory"


def test_probe_device_cpu_is_healthy():
    rep = health.probe_device(timeout_s=30.0, device="cpu")
    assert rep.healthy and rep.backend == "cpu" and rep.error is None
    assert rep.latency_s is not None and rep.latency_s >= 0.0


def test_probe_device_reports_a_failing_dispatch():
    rep = health.probe_device(timeout_s=30.0, device="meta")
    assert not rep.healthy and rep.error


def test_hbm_bandwidth_cpu_counts_read_and_write():
    gbps = health.hbm_bandwidth_gbps(n_floats=1 << 16, iters=2, device="cpu")
    assert math.isfinite(gbps) and gbps > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones((64, 64))
    with trace(str(tmp_path), annotate="sdr-test-block") as prof:
        (x @ x).sum()
    path = tmp_path / TRACE_FILE
    assert path.stat().st_size > 1000
    assert "sdr-test-block" in path.read_text()
    assert prof.key_averages()


def test_weak_scaling_one_rank():
    cfg = LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=64, cp_len=16),
                     channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=6.0),
                     equalizer=Equalizer.MMSE, n_symbols=4, n_channels=4)
    pts = scaling.weak_scaling(cfg, iters=2, reps=1, device="cpu")
    assert [p.n_devices for p in pts] == [1]
    assert pts[0].n_channels == 4 and pts[0].samples_per_s > 0.0
    assert pts[0].efficiency == 1.0
    with pytest.raises(ValueError, match="exceed"):
        scaling.weak_scaling(cfg, device_counts=[2], iters=1, reps=1, device="cpu")


def test_plot_sweep_writes_a_figure_with_a_zero_point(tmp_path):
    res = SweepResult(points=[SweepPoint(0.0, 1000, 10000, 1), SweepPoint(4.0, 100, 10000, 1),
                              SweepPoint(8.0, 0, 10000, 1)],
                      config_summary="qpsk/64sc/cp16/awgn/eq=none/torch")
    path = str(tmp_path / "ber.png")
    assert plot.plot_sweep(res, Modulation.QPSK, path, channel_model=ChannelModel.AWGN) == path
    assert os.path.getsize(path) > 5000
    with pytest.raises(ValueError, match="at most"):
        plot.plot_ber_curves([("c", [0], [1])] * 7, str(tmp_path / "x.png"))


def test_tune_demod_cpu_returns_a_point_per_route():
    pts = autotune.tune_demod(n_fft=64, cp_len=16, batch=4, n_syms=2, iters=1, reps=1,
                              device="cpu")
    assert [p.backend for p in pts] == list(autotune.ROUTES)
    assert all(p.error is None and p.gs_per_s > 0 for p in pts)
    bad = autotune.tune_demod(n_fft=48, cp_len=16, batch=4, n_syms=2, iters=1, reps=1,
                              backends=("fused", "cl"), device="cpu")
    assert all(p.error and p.gs_per_s == 0.0 for p in bad)
    with pytest.raises(ValueError, match="unknown demod route"):
        autotune.tune_demod(n_fft=64, cp_len=16, batch=4, n_syms=2, backends=("pallas",),
                            device="cpu")


def test_tune_demod_routes_agree_on_the_sum():
    """Every route computes the same LLR sum on the same inputs."""
    planes = autotune._inputs(64, 16, 4, 2, "cpu")
    nv = 0.05
    acc = torch.zeros(())
    sums = [float(autotune._route_fn(r, planes, 16, Modulation.QAM16, nv)(acc))
            for r in ("fused", "hybrid", "cl")]
    np.testing.assert_allclose(sums, sums[0], rtol=1e-4)
