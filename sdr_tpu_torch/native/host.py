"""ctypes bindings for the native host runtime (port of
``sdr_tpu/native/host.py``).

The C++ sources are the repository's own (``native/sdr_host.cpp``,
``native/iq_file.cpp``). This module compiles them with ``g++`` and the
flags of ``native/Makefile`` into ``sdr_tpu_torch/_build/native/<hash of
the sources, the flags and the CPU model>/libsdr_host.so`` (git-ignored)
on first use, never into ``native/``: the JAX package's loader owns
``native/libsdr_host.so``.
A build writes a temporary file beside its target and renames it into
place, so concurrent processes never load a half-written library.

Every entry point raises ``RuntimeError`` if the library cannot be
built; ``available()`` says whether it can. No path of the port falls
back to Python when it cannot.

Roles:
- NativeRing: the C++ ring buffer (reference sliding_buffer semantics)
  for host-side streaming.
- pack/unpack bits, crc32: the host framing data path.
- native fft/ifft, qam_map/demap, ofdm_tx/rx: an independent C++ oracle
  of the reference PHY contract, which the port's ops are tested against
  (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_NATIVE_DIR = _PKG.parent / "native"
_SOURCES = ("sdr_host.cpp", "iq_file.cpp")
# native/Makefile's CXXFLAGS and link line.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
BUILD_ROOT = _PKG / "_build" / "native"

_lock = threading.Lock()
_lib = None
_err: str | None = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _cpu_model() -> str:
    """This host's CPU model: ``-march=native`` builds for it, so a
    checkout shared between hosts keeps one library per model."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def library_path() -> Path:
    """Where the library for the current sources, flags and CPU model is
    (or will be) built."""
    h = hashlib.sha256(" ".join((_compiler(), _cpu_model()) + CXXFLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_NATIVE_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsdr_host.so"


def build() -> Path:
    """Compile the library if this source hash has not been built yet;
    returns its path, or raises ``RuntimeError`` with the compiler's
    output."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [_compiler(), *CXXFLAGS, "-shared", "-o", tmp,
               *(str(_NATIVE_DIR / name) for name in _SOURCES), "-lpthread"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f4p = ctypes.POINTER(ctypes.c_float)
    f8p = ctypes.POINTER(ctypes.c_double)
    sz = ctypes.c_size_t

    lib.sdr_ring_create.restype = ctypes.c_void_p
    lib.sdr_ring_create.argtypes = [sz]
    lib.sdr_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.sdr_ring_size.restype = sz
    lib.sdr_ring_size.argtypes = [ctypes.c_void_p]
    lib.sdr_ring_push.restype = ctypes.c_int
    lib.sdr_ring_push.argtypes = [ctypes.c_void_p, f4p, sz]
    lib.sdr_ring_window.argtypes = [ctypes.c_void_p, f4p]
    lib.sdr_unpack_bits.argtypes = [u8p, sz, u8p]
    lib.sdr_pack_bits.argtypes = [u8p, sz, u8p]
    lib.sdr_crc32.restype = ctypes.c_uint32
    lib.sdr_crc32.argtypes = [u8p, sz]
    lib.sdr_fft.restype = ctypes.c_int
    lib.sdr_fft.argtypes = [f8p, f8p, sz, ctypes.c_int]
    lib.sdr_qam_map.restype = ctypes.c_int
    lib.sdr_qam_map.argtypes = [u8p, sz, ctypes.c_int, f8p, f8p]
    lib.sdr_qam_demap_hard.restype = ctypes.c_int
    lib.sdr_qam_demap_hard.argtypes = [f8p, f8p, sz, ctypes.c_int, u8p]
    lib.sdr_ofdm_tx.restype = ctypes.c_int
    lib.sdr_ofdm_tx.argtypes = [f8p, f8p, sz, sz, f8p, f8p]
    lib.sdr_ofdm_rx.restype = ctypes.c_int
    lib.sdr_ofdm_rx.argtypes = [f8p, f8p, sz, sz, f8p, f8p]
    lib.sdr_iq_write.restype = ctypes.c_longlong
    lib.sdr_iq_write.argtypes = [ctypes.c_char_p, f4p, sz, ctypes.c_float]
    lib.sdr_iq_info.restype = ctypes.c_longlong
    lib.sdr_iq_info.argtypes = [ctypes.c_char_p]
    lib.sdr_iq_read.restype = ctypes.c_longlong
    lib.sdr_iq_read.argtypes = [ctypes.c_char_p, sz, sz, f4p, ctypes.c_float]
    lib.sdr_iq_reader_open.restype = ctypes.c_void_p
    lib.sdr_iq_reader_open.argtypes = [ctypes.c_char_p, sz, ctypes.c_float, ctypes.c_int, sz]
    lib.sdr_iq_reader_next.restype = ctypes.c_int
    lib.sdr_iq_reader_next.argtypes = [ctypes.c_void_p, f4p]
    lib.sdr_iq_reader_close.argtypes = [ctypes.c_void_p]


def _load():
    global _lib, _err
    with _lock:
        if _lib is not None or _err is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as e:
            _err = str(e)
            return None
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(_err or "native library unavailable")
    return lib


def _f8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeRing:
    """C++ ring buffer with reference sliding_buffer semantics."""

    def __init__(self, size: int):
        self._lib = _lib_or_raise()
        self._h = self._lib.sdr_ring_create(size)
        self._size = size

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sdr_ring_destroy(self._h)
            self._h = None

    def size(self) -> int:
        return self._size

    def push(self, values) -> None:
        v = np.ascontiguousarray(values, dtype=np.float32).ravel()
        rc = self._lib.sdr_ring_push(self._h, _ptr(v, ctypes.c_float), v.size)
        if rc != 0:
            raise ValueError(f"push of {v.size} overflows capacity {self._size}")

    def window(self) -> np.ndarray:
        out = np.empty(self._size, np.float32)
        self._lib.sdr_ring_window(self._h, _ptr(out, ctypes.c_float))
        return out


def unpack_bits(data) -> np.ndarray:
    lib = _lib_or_raise()
    b = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    out = np.empty(b.size * 8, np.uint8)
    lib.sdr_unpack_bits(_ptr(b, ctypes.c_uint8), b.size, _ptr(out, ctypes.c_uint8))
    return out


def pack_bits(bits) -> np.ndarray:
    lib = _lib_or_raise()
    b = np.ascontiguousarray(bits, dtype=np.uint8).ravel()
    out = np.empty(b.size // 8, np.uint8)
    lib.sdr_pack_bits(_ptr(b, ctypes.c_uint8), b.size, _ptr(out, ctypes.c_uint8))
    return out


def crc32(data) -> int:
    lib = _lib_or_raise()
    b = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    return int(lib.sdr_crc32(_ptr(b, ctypes.c_uint8), b.size))


def _fft_impl(x, inverse: bool) -> np.ndarray:
    lib = _lib_or_raise()
    x = np.asarray(x, dtype=np.complex128)
    re = _f8(x.real.copy())
    im = _f8(x.imag.copy())
    rc = lib.sdr_fft(
        _ptr(re, ctypes.c_double), _ptr(im, ctypes.c_double), re.size, int(inverse)
    )
    if rc != 0:
        raise ValueError(f"The sequence size must be a power of 2, got {re.size}")
    return re + 1j * im


def fft(x) -> np.ndarray:
    """Forward unscaled DFT (reference fft::fft2 conventions)."""
    return _fft_impl(x, inverse=False)


def ifft(x) -> np.ndarray:
    """Inverse DFT with 1/N scaling (reference fft::ifft2)."""
    return _fft_impl(x, inverse=True)


def qam_map(bits, bits_per_symbol: int) -> np.ndarray:
    lib = _lib_or_raise()
    b = np.ascontiguousarray(bits, dtype=np.uint8).ravel()
    n_sym = b.size // bits_per_symbol
    re = np.empty(n_sym, np.float64)
    im = np.empty(n_sym, np.float64)
    rc = lib.sdr_qam_map(
        _ptr(b, ctypes.c_uint8), b.size, bits_per_symbol,
        _ptr(re, ctypes.c_double), _ptr(im, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(f"bad map: n_bits={b.size}, bps={bits_per_symbol}")
    return re + 1j * im


def qam_demap_hard(points, bits_per_symbol: int) -> np.ndarray:
    lib = _lib_or_raise()
    p = np.asarray(points, np.complex128).ravel()
    re = _f8(p.real.copy())
    im = _f8(p.imag.copy())
    out = np.empty(p.size * bits_per_symbol, np.uint8)
    rc = lib.sdr_qam_demap_hard(
        _ptr(re, ctypes.c_double), _ptr(im, ctypes.c_double), p.size,
        bits_per_symbol, _ptr(out, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError(f"bad demap: bps={bits_per_symbol}")
    return out


def ofdm_tx(points, cp_len: int) -> np.ndarray:
    lib = _lib_or_raise()
    p = np.asarray(points, np.complex128).ravel()
    re_in, im_in = _f8(p.real.copy()), _f8(p.imag.copy())
    n = p.size
    re = np.empty(n + cp_len, np.float64)
    im = np.empty(n + cp_len, np.float64)
    rc = lib.sdr_ofdm_tx(
        _ptr(re_in, ctypes.c_double), _ptr(im_in, ctypes.c_double), n, cp_len,
        _ptr(re, ctypes.c_double), _ptr(im, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(f"ofdm_tx failed: n={n}, cp={cp_len}")
    return re + 1j * im


def ofdm_rx(samples, cp_len: int) -> np.ndarray:
    lib = _lib_or_raise()
    s = np.asarray(samples, np.complex128).ravel()
    re_in, im_in = _f8(s.real.copy()), _f8(s.imag.copy())
    n = s.size - cp_len
    re = np.empty(n, np.float64)
    im = np.empty(n, np.float64)
    rc = lib.sdr_ofdm_rx(
        _ptr(re_in, ctypes.c_double), _ptr(im_in, ctypes.c_double), s.size, cp_len,
        _ptr(re, ctypes.c_double), _ptr(im, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(f"ofdm_rx failed: n_total={s.size}, cp={cp_len}")
    return re + 1j * im
