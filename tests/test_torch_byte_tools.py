"""The port's byte-demo tools on the CPU, held against the JAX package:
the waveform statistics (``obs/waveform.py``), the sliding buffers
(``utils/sliding_buffer.py``), the loopback demo (``app/demo.py``), the
baseline cases (``app/baseline_configs.py``), the structured metrics
(``obs/metrics.py``) and the precision policy (``core/precision.py``).

- Waveform: ``papr_db``, ``papr_ccdf``, ``evm_rms`` (aided and blind) and
  ``psd_welch`` within 1e-5 (relative; float32 reductions and FFTs in
  other orders) of the JAX functions on the same numpy inputs, the CCDF
  theory exactly; then the JAX ``tests/test_waveform.py`` gates on the
  port (torch draws from fixed generators).
- Buffers: the reference's nine ``SlidingBuffer`` scenarios and the JAX
  tests' extensions (``tests/test_sliding_buffer.py``) on the port's host
  buffer; the tensor ring equals the host buffer and the JAX ring push by
  push, and its read, window and capacity check.
- Demo: ``make_frame_fn``'s decoded bytes exactly and its waveform and
  points within 1e-5 of the JAX frame's — the identity channel, and AWGN
  on the JAX frame's own noise regenerated from its key and injected; then
  the JAX ``tests/test_app.py`` demo tests on the port.
- Baseline cases: the five cases' configs equal the JAX ones; the JAX
  test's gates. Metrics and precision: the JAX module's behaviour.
"""

import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.app import baseline_configs as jbase
from sdr_tpu.app import demo as jdemo
from sdr_tpu.core import config as jcfg
from sdr_tpu.core.precision import default_precision as j_default_precision
from sdr_tpu.obs import waveform as jwave
from sdr_tpu.utils import sliding_buffer as jsb
from sdr_tpu_torch import interop
from sdr_tpu_torch.app import baseline_configs, demo
from sdr_tpu_torch.core import Precision, default_precision
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.obs import Metrics, waveform
from sdr_tpu_torch.ops.modulation import modulate
from sdr_tpu_torch.ops.ofdm import ofdm_tx
from sdr_tpu_torch.utils import (
    RingState,
    SlidingBuffer,
    ring_new,
    ring_push,
    ring_read,
    ring_window,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def _close(got, want, rtol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# ---- waveform statistics -----------------------------------------------------------------------

def test_waveform_functions_equal_jax():
    rng = np.random.default_rng(24)
    x = _cplx(rng, (6, 320))
    for axis in (-1, 0):
        _close(waveform.papr_db(_t(x), axis=axis), jwave.papr_db(jnp.asarray(x), axis=axis))
    p = np.asarray(jwave.papr_db(jnp.asarray(x)))
    grid = np.linspace(2.0, 12.0, 11).astype(np.float32)
    _close(waveform.papr_ccdf(_t(p), _t(grid)), jwave.papr_ccdf(jnp.asarray(p), jnp.asarray(grid)))
    np.testing.assert_array_equal(waveform.papr_ccdf_theory(256)(grid),
                                  jwave.papr_ccdf_theory(256)(grid))
    for mod in (Modulation.QPSK, Modulation.QAM16, Modulation.QAM64):
        jmod = jcfg.Modulation(mod.value)
        bits = rng.integers(0, 2, (4096 * mod.bits_per_symbol,)).astype(np.int8)
        ref = modulate(_t(bits), mod).numpy()
        rx = ref + _cplx(rng, ref.shape, 0.1)
        _close(waveform.evm_rms(_t(rx), mod), jwave.evm_rms(jnp.asarray(rx), jmod))
        _close(waveform.evm_rms(_t(rx), mod, _t(ref)),
               jwave.evm_rms(jnp.asarray(rx), jmod, jnp.asarray(ref)))
    y = _cplx(rng, (3, 2000))
    for nperseg, overlap in ((256, 128), (64, 0), (100, 37)):
        _close(waveform.psd_welch(_t(y), nperseg, overlap),
               jwave.psd_welch(jnp.asarray(y), nperseg, overlap))


def test_papr_constant_envelope_and_known_value():
    ph = torch.linspace(0.0, 6.0, 128)
    assert abs(float(waveform.papr_db(torch.polar(torch.ones_like(ph), ph)))) < 1e-5
    x = torch.tensor([3.0, 1, 1, 1, 1, 1, 1, 1], dtype=torch.complex64)
    np.testing.assert_allclose(float(waveform.papr_db(x)), 10 * np.log10(9.0 / 2.0), rtol=1e-6)


def test_ofdm_papr_ccdf_matches_gaussian_theory():
    """tests/test_waveform.py:42-59 at its sizes (4096 symbols of 256 QPSK
    tones): the measured CCDF tracks 1 − (1 − e^−x)^N within rtol 0.6."""
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, (4096, 512), generator=g, dtype=torch.int8)
    p = waveform.papr_db(ofdm_tx(modulate(bits, Modulation.QPSK), 0))
    grid = torch.tensor([6.0, 8.0])
    meas = waveform.papr_ccdf(p, grid).numpy()
    theo = waveform.papr_ccdf_theory(256)(grid.numpy())
    assert np.all(meas < 1.0) and np.all(meas > 0.0)
    np.testing.assert_allclose(meas, theo, rtol=0.6)
    assert meas[1] <= meas[0]


def test_evm_equals_sqrt_noise_var():
    """tests/test_waveform.py:62-75: EVM² → nv on 16-QAM at nv 0.02."""
    g = torch.Generator().manual_seed(1)
    x = modulate(torch.randint(0, 2, (1 << 18,), generator=g, dtype=torch.int8),
                 Modulation.QAM16)
    nv = 0.02
    noise = torch.complex(torch.randn(x.shape, generator=g), torch.randn(x.shape, generator=g))
    rx = x + noise * (nv / 2) ** 0.5
    aided = float(waveform.evm_rms(rx, Modulation.QAM16, ref_points=x))
    np.testing.assert_allclose(aided, nv ** 0.5, rtol=0.02)
    np.testing.assert_allclose(float(waveform.evm_rms(rx, Modulation.QAM16)), aided, rtol=0.05)


def test_psd_parseval_band_shape_and_segmenting():
    """tests/test_waveform.py:78-112."""
    g = torch.Generator().manual_seed(2)
    x = torch.complex(torch.randn(1 << 14, generator=g), torch.randn(1 << 14, generator=g))
    psd = waveform.psd_welch(x, nperseg=256, overlap=128)
    np.testing.assert_allclose(float(psd.mean()), float((x.abs() ** 2).mean()), rtol=0.05)
    grid = torch.zeros((512, 256), dtype=torch.complex64)
    grid[:, :128] = torch.complex(torch.randn(512, 128, generator=g),
                                  torch.randn(512, 128, generator=g)) * 2 ** -0.5
    psd = waveform.psd_welch(ofdm_tx(grid, 16).reshape(-1), nperseg=256, overlap=128).numpy()
    assert psd[129:255].mean() / psd[1:120].mean() > 10 ** 1.5
    assert psd[140:240].max() / psd[140:240].min() < 4.0
    with pytest.raises(ValueError):
        waveform.psd_welch(x[:64], nperseg=128, overlap=64)
    with pytest.raises(ValueError):
        waveform.psd_welch(x[:64], nperseg=32, overlap=32)


# ---- the sliding buffers -------------------------------------------------------------------------

def _logical(cb):
    return [cb[i] for i in range(cb.size())]


def test_sliding_buffer_reference_scenarios():
    """sliding_buffer_test.cpp:11-154 one for one, and the JAX tests'
    extensions (tests/test_sliding_buffer.py:25-109)."""
    assert SlidingBuffer(5).size() == 5
    with pytest.raises(IndexError, match="exceeds size"):
        SlidingBuffer(3).at(3)
    cb = SlidingBuffer(4)
    cb.push_back(42)
    assert cb.at(3) == 42
    cb = SlidingBuffer(5)
    cb.push_back([1, 2, 3])
    assert [cb[2], cb[3], cb[4]] == [1, 2, 3]
    cb = SlidingBuffer(4)
    cb.push_back([10, 20, 30, 40])
    assert _logical(cb) == [10, 20, 30, 40]
    cb = SlidingBuffer(5)
    cb.push_back([1, 2, 3, 4])
    cb.push_back([5, 6, 7])
    assert _logical(cb) == [3, 4, 5, 6, 7]
    cb = SlidingBuffer(3)
    cb.push_back([1, 2, 3, 4, 5])
    assert _logical(cb) == [3, 4, 5]
    cb = SlidingBuffer(4)
    for v in (1, 2, 3, 4, 5):
        cb.push_back(v)
    assert _logical(cb) == [2, 3, 4, 5]
    cb = SlidingBuffer(3)
    for v in (10, 20, 30, 40):
        cb.push_back(v)
    assert _logical(cb) == [20, 30, 40]
    cb = SlidingBuffer(4)
    cb.push_back([1, 2, 3, 4, 5, 6])
    assert cb.tolist() == _logical(cb)
    with pytest.raises(ValueError, match="overflows"):
        SlidingBuffer(3).push_back(list(range(7)))
    with pytest.raises(ValueError):
        SlidingBuffer(0)


def test_ring_equals_host_buffer_and_jax_ring():
    rng = np.random.default_rng(0x5D12)
    cap = 7
    host = SlidingBuffer(cap)
    ring = ring_new(cap, torch.int32, device="cpu")
    j_ring = jsb.ring_new(cap, jnp.int32)
    j_push = jax.jit(jsb.ring_push)
    for _ in range(20):
        n = int(rng.integers(1, cap + 1))
        vals = rng.integers(0, 1000, n)
        host.push_back(list(vals))
        old = ring.data.clone()
        pushed = ring_push(ring, _t(vals.astype(np.int32)))
        assert torch.equal(ring.data, old)  # functional: the old state is left as it was
        ring = pushed
        j_ring = j_push(j_ring, jnp.asarray(vals, jnp.int32))
        np.testing.assert_array_equal(ring_window(ring).numpy(), np.array(host.tolist()))
        np.testing.assert_array_equal(ring.data.numpy(), np.asarray(j_ring.data))
        assert int(ring.cur) == int(j_ring.cur) and ring.cur.dtype == torch.int32
        for pos in (0, 3, cap - 1, cap + 2):
            assert int(ring_read(ring, pos)) == int(jsb.ring_read(j_ring, pos))


def test_ring_read_window_and_capacity():
    """tests/test_sliding_buffer.py:128-145 (the scan case as a loop)."""
    ring = ring_new(3, torch.int32, device="cpu")
    for v in (10, 20, 30, 40):
        ring = ring_push(ring, torch.tensor([v], dtype=torch.int32))
    assert [int(ring_read(ring, i)) for i in range(3)] == [20, 30, 40]
    with pytest.raises(ValueError, match="exceeds capacity"):
        ring_push(ring_new(3, device="cpu"), torch.zeros(4))
    with pytest.raises(ValueError):
        ring_new(0, device="cpu")
    state = ring_new(4, torch.float32, item_shape=(2,), device="cpu")
    assert isinstance(state, RingState) and state.data.shape == (4, 2)
    for x in range(6):
        state = ring_push(state, torch.full((1, 2), float(x)))
    np.testing.assert_array_equal(ring_window(state)[:, 0].numpy(), [2.0, 3.0, 4.0, 5.0])


# ---- the demo ----------------------------------------------------------------------------------

@pytest.mark.parametrize("ebno_db", [None, 12.0], ids=["identity", "awgn"])
def test_demo_frame_equals_jax(ebno_db):
    cfg = demo.DemoConfig(ebno_db=ebno_db)
    j_cfg = jdemo.DemoConfig(ebno_db=ebno_db)
    frame, bpf = demo.make_frame_fn(cfg, device="cpu")
    j_frame, j_bpf = jdemo.make_frame_fn(j_cfg)
    assert bpf == j_bpf == 4
    L = cfg.n_fft + cfg.cp_len
    for fi in range(6):
        chunk = np.frombuffer(demo.PAYLOAD[4 * fi:4 * fi + 4], np.uint8).copy()
        key = jax.random.fold_in(jax.random.PRNGKey(0), fi)
        want = [np.asarray(t) for t in j_frame(jnp.asarray(chunk), key)]
        kr, ki = jax.random.split(key)  # the JAX frame's awgn draw (cgauss)
        noise = (np.asarray(jax.random.normal(kr, (L,))), np.asarray(jax.random.normal(ki, (L,))))
        got = frame(chunk, fi, noise=noise)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        for g, w in zip(got[1:], want[1:]):
            _close(g, w)
    assert demo.PAYLOAD == jdemo.PAYLOAD


def test_demo_identity_loopback_decodes_payload():
    """tests/test_app.py:17-30."""
    out = io.StringIO()
    text = demo.run_demo(demo.DemoConfig(), frames=30, interval_ms=0, render=True, out=out,
                         device="cpu")
    assert len(text) == 50
    assert text in (demo.PAYLOAD + demo.PAYLOAD).decode()
    assert "constellation" in out.getvalue()


def test_demo_awgn_runs_and_keys():
    """tests/test_app.py:33-37 and :296-328: AWGN runs; '-', '-', 'q'
    stops on frame 3; '+' clamps the interval at 1 ms."""
    assert len(demo.run_demo(demo.DemoConfig(ebno_db=20.0), frames=5, interval_ms=0,
                             render=False, device="cpu")) == 50
    out = io.StringIO()
    text = demo.run_demo(demo.DemoConfig(), frames=50, interval_ms=0.0, render=True, out=out,
                         keys=["-", "-", "q"], device="cpu")
    assert "interval" in out.getvalue() and len(text) == 50
    assert out.getvalue().count("[frame") == 3
    out = io.StringIO()
    demo.run_demo(demo.DemoConfig(), frames=6, interval_ms=2.0, render=True, out=out,
                  keys=["+"] * 5, device="cpu")
    assert "interval 1 ms" in out.getvalue()


def test_demo_snapshot_figure(tmp_path):
    """tests/test_app.py:221-230 (matplotlib imported only here)."""
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "snap.png")
    demo.run_demo(demo.DemoConfig(ebno_db=14.0), frames=5, interval_ms=0, render=False,
                  snapshot=png, device="cpu")
    assert os.path.getsize(png) > 10000


def test_demo_defaults_to_the_card():
    import inspect

    for fn in (demo.run_demo, demo.make_frame_fn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        frame, _ = demo.make_frame_fn(demo.DemoConfig())
        with pytest.raises((RuntimeError, AssertionError)):
            frame(np.zeros(4, np.uint8), 0)


# ---- baseline cases, metrics, precision ----------------------------------------------------------

def test_baseline_cases_equal_jax():
    cases, j_cases = baseline_configs.baseline_cases(), jbase.baseline_cases()
    assert len(cases) == len(j_cases) == 5
    for c, j in zip(cases, j_cases):
        assert (c.name, c.description, c.ebno_sweep_db, c.sharded) == (
            j.name, j.description, j.ebno_sweep_db, j.sharded)
        assert c.cfg == interop.link_config_from_reference(j.cfg)
    # tests/test_app.py:40-53
    assert cases[0].cfg.modulation is Modulation.QPSK and cases[0].cfg.ofdm.n_fft == 64
    assert cases[0].cfg.bits_total >= 1_000_000
    assert cases[1].cfg.ofdm.n_fft == 256 and cases[1].ebno_sweep_db
    assert cases[2].cfg.modulation is Modulation.QAM64
    assert cases[3].cfg.n_channels == 64 and cases[3].sharded
    assert cases[4].cfg.ofdm.n_fft == 4096 and cases[4].cfg.n_channels == 256
    assert baseline_configs.get_case("2").name == "qam64-1024"
    assert baseline_configs.get_case("qam64-1024") is cases[2] or (
        baseline_configs.get_case("qam64-1024") == cases[2])
    with pytest.raises(KeyError):
        baseline_configs.get_case("nope")


def test_metrics_counters_and_jsonl(tmp_path):
    """tests/test_obs.py:189-204, and the sink."""
    path = str(tmp_path / "m.jsonl")
    sink = io.StringIO()
    m = Metrics(sink=sink, path=path)
    m.count("frames")
    m.count("frames", 2)
    m.gauge("samples_per_s", 1.3e10)
    rec = m.emit("bench_done", case="qam16-256-llr")
    assert rec["counters"]["frames"] == 3 and rec["gauges"]["samples_per_s"] == 1.3e10
    lines = [json.loads(line) for line in open(path)]
    assert lines[-1]["event"] == "bench_done" and lines[-1]["case"] == "qam16-256-llr"
    assert json.loads(sink.getvalue()) == lines[-1]
    from sdr_tpu_torch.obs import global_metrics

    assert global_metrics() is global_metrics()


def test_precision_policy():
    p, j = default_precision(), j_default_precision()
    assert p == Precision()
    assert (p.complex_dtype, p.real_dtype, p.llr_dtype) == (torch.complex64, torch.float32,
                                                            torch.float32)
    assert p.bytes_per_complex == j.bytes_per_complex == 8
    assert dataclasses.replace(p, llr_dtype=torch.bfloat16).llr_dtype == torch.bfloat16
