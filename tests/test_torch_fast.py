"""The port's keyed fast link (sdr_tpu_torch.link.fast) as a whole.

- The slice on explicit inputs (indices, gains, injected noise) through
  the port's tx_with_channel → rx_count_core, against the JAX
  interpret-mode composition of the same three kernels: counts equal,
  or differing by no more than the bits whose plain |LLR| < 1e-3.
- The keyed engine's BER against exact theory, and split == full.
- The package never imports JAX; unported models raise.
"""

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
from sdr_tpu_torch.kernels.demod import demod_chain
from sdr_tpu_torch.link import fast
from sdr_tpu_torch.link.ber import ber_awgn_exact, ber_rayleigh_exact, ber_rician_exact

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
    errors, counted = fast.fast_simulate(cfg, seed=2024)
    ber = int(errors.sum()) / int(counted.sum())
    theory = ber_awgn_exact(Modulation.QAM16, 6.0)
    assert abs(ber / theory - 1.0) < 0.15, (ber, theory)


def test_fast_simulate_rayleigh_ber_matches_theory():
    """Many short links, so that fade realisations average out."""
    cfg = _cfg(ChannelModel.RAYLEIGH_FLAT, 10.0, Modulation.QPSK, 16, 4, 4, 16384)
    errors, counted = fast.make_fast_fn(cfg)(5)
    ber = int(errors.sum()) / int(counted.sum())
    theory = ber_rayleigh_exact(Modulation.QPSK, 10.0)
    assert abs(ber / theory - 1.0) < 0.15, (ber, theory)


def test_identity_channel_is_error_free():
    cfg = _cfg(ChannelModel.IDENTITY, mod=Modulation.QAM1024, n_fft=64, cp=16, n_symbols=4,
               n_channels=8)
    errors, counted = fast.fast_simulate(cfg, seed=1)
    assert int(errors.sum()) == 0 and int(counted.sum()) == 8 * 4 * 64 * 10


@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.RICIAN],
                         ids=lambda m: m.value)
def test_split_equals_full(model):
    """Channels [0, k) alone give the same counts as in the full run."""
    cfg = _cfg(model, 4.0, n_fft=64, cp=16, n_symbols=8, n_channels=48)
    full, _ = fast.fast_simulate(cfg, seed=9)
    part, _ = fast.fast_core(cfg, 9, torch.arange(0, 20, dtype=torch.int32))
    rest, _ = fast.fast_core(cfg, 9, torch.arange(20, 48, dtype=torch.int32))
    torch.testing.assert_close(torch.cat([part, rest]), full, rtol=0, atol=0)
    assert int(full.sum()) > 0


def test_package_imports_no_jax():
    code = (
        "import sys; import sdr_tpu_torch, sdr_tpu_torch.link.fast, sdr_tpu_torch.interop, "
        "sdr_tpu_torch.ops.demod, sdr_tpu_torch.kernels.demod_cl; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert not any(m == 'sdr_tpu' or m.startswith('sdr_tpu.') for m in sys.modules)"
    )
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize(
    "kw",
    [
        dict(model=ChannelModel.MULTIPATH),
        dict(model=ChannelModel.MULTIPATH_TIME),
        dict(model=ChannelModel.RAYLEIGH_TIME),
        dict(dft_spread=True),
        dict(pilot_spacing=4, equalizer=Equalizer.MMSE),
        dict(mimo=True),
        dict(layout="cl"),
    ],
    ids=["multipath", "multipath_time", "rayleigh_time", "dft_spread", "pilots", "mimo", "cl"],
)
def test_unported_paths_raise(kw):
    kw = dict(kw)
    layout = kw.pop("layout", "auto")
    model = kw.pop("model", ChannelModel.RAYLEIGH_FLAT)
    if kw.pop("mimo", False):
        kw["mimo"] = MIMOConfig()
    cfg = _cfg(model, n_fft=64, cp=16, n_symbols=4, n_channels=4, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fast.fast_simulate(cfg, seed=0, layout=layout)


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
