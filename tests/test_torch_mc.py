"""The port's Monte-Carlo engine (kernels/mc.py, link/mc.py) on the CPU.

- The plain twin of kernel G against the JAX MC kernels in interpret
  mode (``mc_count_pallas`` for n_fft ≤ 512 and SC-FDMA, its four-step
  form at 1024) on one injected draw (numpy, fixed seed), at the JAX
  test's shapes (tests/test_mc.py). Tolerance: the JAX test's own,
  max(2, 0.02·max + 1) errors per channel — the two sides decide bits
  through different float paths (the TPU kernel's matmul transforms in
  interpret mode against torch's FFTs).
- A keyed pass against the port's fast engine on the same seed: equal
  per channel but for bits whose plain |LLR| < 1e-3.
- ``mc_simulate``: passes and their seeds, the int32 overflow guard,
  ``supported``, the wideband SC-FDMA route, configs that raise.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.kernels.mc_pallas import mc_count_pallas
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.kernels import mc as kg
from sdr_tpu_torch.kernels.demod import count_errors
from sdr_tpu_torch.link import fast, mc
from sdr_tpu_torch.link.ber import ber_awgn_exact

torch.set_num_threads(1)

ALL_MODELS = [ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT, ChannelModel.MULTIPATH,
              ChannelModel.IDENTITY, ChannelModel.RAYLEIGH_TIME, ChannelModel.RICIAN,
              ChannelModel.MULTIPATH_TIME]
_TIME_VARYING = (ChannelModel.RAYLEIGH_TIME, ChannelModel.MULTIPATH_TIME)


def _jcfg(model, n_fft=256, cp=64, n_symbols=8, n_channels=4, ebno=6.0, dft_spread=False):
    """A JAX-package config (tests/test_mc.py's _cfg) and the port's copy."""
    ch = dict(model=jcfg.ChannelModel(model.value), ebno_db=ebno)
    if model in (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME):
        ch["pdp"] = (1.0, 0.5, 0.25)
    if model in _TIME_VARYING:
        ch["doppler_norm"] = 0.02
    ref = jcfg.LinkConfig(modulation=jcfg.Modulation.QAM16,
                          ofdm=jcfg.OFDMConfig(n_fft=n_fft, cp_len=cp),
                          channel=jcfg.ChannelConfig(**ch), n_symbols=n_symbols,
                          n_channels=n_channels, dft_spread=dft_spread)
    return ref, interop.link_config_from_reference(ref)


def _draw(rng, cfg):
    B, S, N = cfg.n_channels, cfg.n_symbols, cfg.ofdm.n_fft
    hs = kg.h_syms(cfg)
    return (rng.integers(0, 1 << cfg.modulation.bits_per_symbol, (B, S, N)).astype(np.int32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, hs, N)).astype(np.float32),
            rng.standard_normal((B, hs, N)).astype(np.float32))


def _assert_tracks_jax(ref_cfg, cfg, draw):
    want = np.asarray(mc_count_pallas(ref_cfg, 0, interpret=True,
                                      rand_inputs=tuple(map(jnp.asarray, draw))))
    ids = torch.arange(cfg.n_channels, dtype=torch.int32)
    got = kg.mc_count(cfg, 0, ids, rand_inputs=interop.mc_rand_inputs_from_reference(*draw))
    assert got.dtype == torch.int32 and got.shape == (cfg.n_channels,)
    assert np.abs(got.numpy() - want).max() <= max(2, int(0.02 * want.max() + 1)), (got, want)
    return got


@pytest.mark.parametrize("model", ALL_MODELS, ids=lambda m: m.value)
def test_mc_plain_inject_matches_jax_kernel(rng, model):
    ref_cfg, cfg = _jcfg(model)
    got = _assert_tracks_jax(ref_cfg, cfg, _draw(rng, cfg))
    assert (int(got.sum()) == 0) == (model == ChannelModel.IDENTITY)


@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT,
                                   ChannelModel.MULTIPATH], ids=lambda m: m.value)
def test_mc_plain_scfdma_inject_matches_jax_kernel(rng, model):
    ref_cfg, cfg = _jcfg(model, dft_spread=True)
    draw = _draw(rng, cfg)
    _assert_tracks_jax(ref_cfg, cfg, draw)


@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.MULTIPATH,
                                   ChannelModel.MULTIPATH_TIME], ids=lambda m: m.value)
def test_mc_plain_wideband_inject_matches_jax_fourstep_kernel(rng, model):
    ref_cfg, cfg = _jcfg(model, n_fft=1024, cp=256, n_symbols=4, n_channels=2)
    _assert_tracks_jax(ref_cfg, cfg, _draw(rng, cfg))


@pytest.mark.parametrize("dft_spread", [False, True], ids=["ofdm", "scfdma"])
@pytest.mark.parametrize("model", ALL_MODELS, ids=lambda m: m.value)
def test_keyed_mc_pass_equals_fast_engine(model, dft_spread):
    """A keyed pass draws the fast engine's payload, fading and noise, and
    its per-subcarrier channel is the fast engine's FIR after the CP
    strip: the same link, through other float paths."""
    cfg = _jcfg(model, n_fft=128, cp=32, n_symbols=6, n_channels=24, ebno=8.0,
                dft_spread=dft_spread)[1]
    ids = torch.arange(24, dtype=torch.int32)
    got = kg.mc_count(cfg, 2024, ids)
    want, counted = fast.fast_simulate(cfg, 2024, device="cpu")
    llr, idx = kg.mc_llr_plain(cfg, 2024, ids)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((got - want).abs() <= margin).all()), (got, want)
    torch.testing.assert_close(count_errors(llr, idx, 4), got, rtol=0, atol=0)
    assert (int(want.sum()) == 0) == (model == ChannelModel.IDENTITY)
    assert int(counted[0]) == mc.bits_per_pass(cfg)


def test_mc_simulate_passes_and_seeds():
    cfg = _jcfg(ChannelModel.RAYLEIGH_FLAT, n_fft=128, cp=32, n_symbols=4, n_channels=16)[1]
    errs, counted = mc.mc_simulate(cfg, seed=-7, iters=3, device="cpu")
    ids = torch.arange(16, dtype=torch.int32)
    want = sum(kg.mc_count(cfg, mc.pass_seed(-7, i), ids) for i in range(3))
    torch.testing.assert_close(errs, want, rtol=0, atol=0)
    assert errs.dtype == torch.int32 and int(counted[0]) == 3 * 4 * 128 * 4
    assert mc.pass_seed(-7, 0) == -7
    assert mc.pass_seed(2**31 - 1, 1) == ((2**31 - 1 + (0x9E3779B9 & 0x7FFFFFFF)) & 0xFFFFFFFF
                                          ) - 2**32
    fn = mc.make_mc_fn(cfg, iters=3, device="cpu")
    torch.testing.assert_close(fn(-7)[0], errs, rtol=0, atol=0)


def test_mc_simulate_awgn_ber_matches_theory():
    cfg = _jcfg(ChannelModel.AWGN, n_fft=128, cp=32, n_symbols=8, n_channels=64, ebno=6.0)[1]
    errs, counted = mc.mc_simulate(cfg, seed=3, iters=2, device="cpu")
    ber = int(errs.sum()) / int(counted.sum())
    assert abs(ber / ber_awgn_exact(Modulation.QAM16, 6.0) - 1.0) < 0.08, ber


def test_mc_simulate_wideband_scfdma_staged_route():
    """n_fft ≥ 1024 SC-FDMA: the fast engine per pass (kernel C's
    despread on the card); AWGN BER on exact theory (tests/test_mc.py's
    8 % gate)."""
    cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=1024, cp_len=256),
                     channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=8.0),
                     equalizer=Equalizer.MMSE, dft_spread=True, n_symbols=4, n_channels=16)
    assert not mc.supported(cfg) and mc._fde_mc_supported(cfg)
    errs, counted = mc.mc_simulate(cfg, seed=3, iters=2, device="cpu")
    ber = int(errs.sum()) / int(counted.sum())
    assert abs(ber / ber_awgn_exact(Modulation.QAM16, 8.0) - 1.0) < 0.08, ber
    ids = torch.arange(16, dtype=torch.int32)
    want = sum(fast.fast_core(cfg, (3 * 1_000_003 + i) & 0x7FFFFFFF, ids)[0] for i in range(2))
    torch.testing.assert_close(errs, want, rtol=0, atol=0)


def test_overflow_guard():
    cfg = _jcfg(ChannelModel.AWGN)[1]  # 8 · 256 · 4 bits per pass
    ok = (2**31 - 1) // mc.bits_per_pass(cfg)
    with pytest.raises(ValueError, match="overflows"):
        mc.mc_simulate(cfg, iters=ok + 1, device="cpu")
    wide = dataclasses.replace(_jcfg(ChannelModel.AWGN, n_fft=1024, cp=256)[1], dft_spread=True)
    with pytest.raises(ValueError, match="overflows"):
        mc.mc_simulate(wide, iters=(2**31 - 1) // mc.bits_per_pass(wide) + 1, device="cpu")


def test_supported_and_unsupported_configs_raise():
    base = _jcfg(ChannelModel.AWGN)[1]
    for n in (128, 512, 1024, 4096):
        assert mc.supported(dataclasses.replace(base, ofdm=OFDMConfig(n, n // 4)))
    assert mc.supported(_jcfg(ChannelModel.RAYLEIGH_TIME)[1])
    assert mc.supported(dataclasses.replace(base, dft_spread=True))
    unsupported = [
        dataclasses.replace(base, ofdm=OFDMConfig(64, 16)),  # below the kernels' range
        dataclasses.replace(base, ofdm=OFDMConfig(8192, 64)),  # above it
        dataclasses.replace(base, ofdm=OFDMConfig(512, 64), dft_spread=True),
        dataclasses.replace(base, pilot_spacing=8, equalizer=Equalizer.MMSE),
        dataclasses.replace(base, pilot_spacing=8, equalizer=Equalizer.MMSE,
                            channel=ChannelConfig(model=ChannelModel.AWGN, cfo_subcarriers=0.3)),
        LinkConfig(modulation=Modulation.QPSK, channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_FLAT), mimo=MIMOConfig()),
    ]
    for cfg in unsupported:
        assert not mc.supported(cfg) and not mc._fde_mc_supported(cfg)
        with pytest.raises(ValueError, match="does not support"):
            mc.mc_simulate(cfg, device="cpu")
    rand = interop.mc_rand_inputs_from_reference(*_draw(np.random.default_rng(1), base))
    with pytest.raises(ValueError, match="one pass"):
        mc.mc_simulate(base, iters=2, device="cpu", rand_inputs=rand)
    for fn in (mc.mc_simulate, mc.make_mc_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_keyed_pass_is_per_channel():
    """Channels [0, k) alone give the counts of the full pass."""
    cfg = _jcfg(ChannelModel.MULTIPATH_TIME, n_fft=128, cp=32, n_symbols=4, n_channels=20)[1]
    full = kg.mc_count(cfg, 5, torch.arange(20, dtype=torch.int32))
    part = kg.mc_count(cfg, 5, torch.arange(7, dtype=torch.int32))
    torch.testing.assert_close(part, full[:7], rtol=0, atol=0)


def test_kernel_params_match_the_c_struct():
    """``_lib.McParams`` (ctypes, passed by value) lists the fields of
    csrc/mc.cuh's ``struct McParams`` in order and with their C types: a
    field renamed or moved on one side only would shift every later one."""
    import ctypes
    import re

    from sdr_tpu_torch.kernels import _lib

    src = (_lib.CSRC / "mc.cuh").read_text()
    body = re.search(r"struct McParams \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    want = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        if "*" in decl:
            ctype, names = ctypes.c_void_p, decl.split("*", 1)[1]
        else:
            base, names = decl.split(None, 1)
            ctype = {"int": ctypes.c_int, "unsigned": ctypes.c_uint, "float": ctypes.c_float}[base]
        want += [(name.strip(), ctype) for name in names.split(",")]
    assert [(n, t) for n, t in _lib.McParams._fields_] == want
