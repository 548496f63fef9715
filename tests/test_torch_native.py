"""The port's native host runtime (sdr_tpu_torch.native) against the JAX
package's bindings (sdr_tpu.native), on the CPU.

- The port builds ``native/*.cpp`` with g++ into ``sdr_tpu_torch/_build/
  native/<source hash>/``, never into ``native/``.
- Its bindings give the JAX bindings' bytes and arrays for bit packing,
  CRC-32, the FFT, the QAM map and hard demap, OFDM TX/RX and the ring.
- An SC16 file written by either reads back identically through the
  other (``read_iq``, ``IQReader``), byte for byte on disk.
- The port's ``ops.modulation`` and ``ops.ofdm`` match the C++ oracle,
  as ``tests/test_native.py`` holds the JAX ops.

The JAX bindings are built here from a private copy of ``native/`` (their
loader's ``native/`` directory and library path are redirected for this
module), so no other test's build of ``native/libsdr_host.so`` races
this one.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_tpu_torch import native as tnative
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.native import host as thost
from sdr_tpu_torch.native import iq as tiq

ROOT = Path(__file__).resolve().parent.parent
MODS = [
    (Modulation.BPSK, 1),
    (Modulation.QPSK, 2),
    (Modulation.QAM16, 4),
    (Modulation.QAM64, 6),
    (Modulation.QAM256, 8),
    (Modulation.QAM1024, 10),
]


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    """The JAX package's native bindings, built from a private copy."""
    from sdr_tpu import native as jn
    from sdr_tpu.native import host as jh

    d = tmp_path_factory.mktemp("jax_native")
    for name in ("Makefile", "sdr_host.cpp", "iq_file.cpp"):
        shutil.copy(ROOT / "native" / name, d / name)
    saved = (jh._NATIVE_DIR, jh._SO, jh._lib, jh._err)
    jh._NATIVE_DIR, jh._SO, jh._lib, jh._err = str(d), str(d / "libsdr_host.so"), None, None
    try:
        assert jh.available(), jh._err
        yield jn
    finally:
        jh._NATIVE_DIR, jh._SO, jh._lib, jh._err = saved


@pytest.fixture
def rng():
    return np.random.default_rng(20261018)


def test_port_builds_into_its_own_build_directory():
    so = thost.build()
    assert so == thost.library_path() and so.exists()
    assert so.parent.parent == ROOT / "sdr_tpu_torch" / "_build" / "native"
    assert tnative.available()
    assert thost.build() == so  # cached by source hash: no rebuild


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(thost, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises((RuntimeError, OSError)):
        thost.build()


def test_packing_and_crc_equal_jax(jnative, rng):
    data = rng.integers(0, 256, 257).astype(np.uint8)
    bits = tnative.unpack_bits(data)
    np.testing.assert_array_equal(bits, jnative.unpack_bits(data))
    np.testing.assert_array_equal(tnative.pack_bits(bits), jnative.pack_bits(bits))
    np.testing.assert_array_equal(tnative.pack_bits(bits), data)
    assert tnative.crc32(data) == jnative.crc32(data)
    assert tnative.crc32(np.frombuffer(b"123456789", np.uint8)) == 0xCBF43926


def test_fft_equals_jax(jnative, rng):
    for n in (8, 64, 256):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_array_equal(tnative.native_fft(x), jnative.native_fft(x))
        np.testing.assert_array_equal(tnative.native_ifft(x), jnative.native_ifft(x))
    with pytest.raises(ValueError, match="power of 2"):
        tnative.native_fft(np.zeros(12, np.complex128))


@pytest.mark.parametrize("mod,bps", MODS, ids=[m.value for m, _ in MODS])
def test_qam_map_and_demap_equal_jax(jnative, rng, mod, bps):
    bits = rng.integers(0, 2, 32 * bps).astype(np.uint8)
    pts = tnative.qam_map(bits, bps)
    np.testing.assert_array_equal(pts, jnative.qam_map(bits, bps))
    noisy = pts + 0.05 * (rng.standard_normal(32) + 1j * rng.standard_normal(32))
    np.testing.assert_array_equal(tnative.qam_demap_hard(noisy, bps),
                                  jnative.qam_demap_hard(noisy, bps))


def test_ofdm_and_ring_equal_jax(jnative, rng):
    pts = (rng.standard_normal(64) + 1j * rng.standard_normal(64)) / np.sqrt(2)
    tx = tnative.native_ofdm_tx(pts, 16)
    np.testing.assert_array_equal(tx, jnative.native_ofdm_tx(pts, 16))
    np.testing.assert_array_equal(tnative.native_ofdm_rx(tx, 16), jnative.native_ofdm_rx(tx, 16))
    r_t, r_j = tnative.NativeRing(7), jnative.NativeRing(7)
    for _ in range(12):
        vals = rng.standard_normal(int(rng.integers(1, 8))).astype(np.float32)
        r_t.push(vals)
        r_j.push(vals)
        np.testing.assert_array_equal(r_t.window(), r_j.window())
    with pytest.raises(ValueError, match="overflows"):
        tnative.NativeRing(3).push(np.zeros(7, np.float32))


def test_iq_files_interchange_with_jax(jnative, tmp_path, rng):
    from sdr_tpu.native import iq as jiq

    x = ((rng.standard_normal(1000) + 1j * rng.standard_normal(1000)) * 0.3).astype(np.complex64)
    x[0] = 9.0 + 9.0j  # saturates at full scale in both
    pt, pj = str(tmp_path / "port.sc16"), str(tmp_path / "jax.sc16")
    assert tiq.write_iq(pt, x) == jiq.write_iq(pj, x) == 1000
    assert Path(pt).read_bytes() == Path(pj).read_bytes()
    assert tiq.iq_info(pj) == jiq.iq_info(pt) == 1000
    np.testing.assert_array_equal(jiq.read_iq(pt), tiq.read_iq(pt))
    np.testing.assert_array_equal(tiq.read_iq(pj, offset=100, count=300),
                                  jiq.read_iq(pj, offset=100, count=300))
    with tiq.IQReader(pj, frame=300) as rt, jiq.IQReader(pt, frame=300) as rj:
        got_t, got_j = list(rt), list(rj)
    assert len(got_t) == len(got_j) == 3
    for a, b in zip(got_t, got_j):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(OSError, match="no such IQ file"):
        tiq.IQReader(str(tmp_path / "missing.sc16"), frame=8)


@pytest.mark.parametrize("mod,bps", MODS, ids=[m.value for m, _ in MODS])
def test_port_modulation_matches_native_oracle(rng, mod, bps):
    """ops.modulation equals the independent C++ mapper."""
    from sdr_tpu_torch.ops.modulation import demodulate_hard, modulate

    bits = rng.integers(0, 2, 32 * bps).astype(np.uint8)
    ours = modulate(torch.as_tensor(bits, dtype=torch.int8), mod).numpy()
    oracle = tnative.qam_map(bits, bps)
    np.testing.assert_allclose(ours, oracle.astype(np.complex64), rtol=1e-6, atol=1e-6)

    noisy = oracle + 0.01 * (rng.standard_normal(32) + 1j * rng.standard_normal(32))
    ours_bits = demodulate_hard(torch.as_tensor(noisy, dtype=torch.complex64), mod).numpy()
    np.testing.assert_array_equal(ours_bits, tnative.qam_demap_hard(noisy, bps))


def test_port_ofdm_matches_native_oracle(rng):
    """ofdm_tx/rx against the C++ oracle: same CP layout, same FFT scaling."""
    from sdr_tpu_torch.ops.ofdm import ofdm_rx, ofdm_tx

    n_fft, cp = 64, 16
    pts = (rng.standard_normal(n_fft) + 1j * rng.standard_normal(n_fft)) / np.sqrt(2)
    ours_tx = ofdm_tx(torch.as_tensor(pts, dtype=torch.complex64), cp).numpy()
    oracle_tx = tnative.native_ofdm_tx(pts, cp)
    np.testing.assert_allclose(ours_tx, oracle_tx, atol=1e-6)

    ours_rx = ofdm_rx(torch.as_tensor(oracle_tx, dtype=torch.complex64), cp).numpy()
    np.testing.assert_allclose(ours_rx, tnative.native_ofdm_rx(oracle_tx, cp), atol=1e-5)
