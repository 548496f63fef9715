"""IQ capture and replay over the native runtime (port of
``sdr_tpu/native/iq.py``, on ``native/iq_file.cpp``).

Raw interleaved int16 IQ ("SC16") is the capture format of the
USRP/rtl-sdr/PlutoSDR toolchains; these wrappers keep the per-sample
int16<->float conversion and disk IO in C++ and expose numpy at the
boundary. Waveforms are float32 complex; the one knob is ``scale`` —
the int16 full-scale value that a waveform amplitude of 1.0 maps to
(headroom vs quantization-noise trade; 8192 leaves 12 dB of PAPR
headroom and ~70 dB of quantization SNR for unit-power OFDM). The files
are the JAX package's, byte for byte.

``IQReader`` is the streaming data loader: a C++ producer thread reads
and converts the next frames while the caller processes the current
one.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from sdr_tpu_torch.native.host import _lib_or_raise, _ptr

DEFAULT_SCALE = 8192.0


def write_iq(path: str, samples: np.ndarray, scale: float = DEFAULT_SCALE) -> int:
    """Write complex64 samples as SC16. Returns samples written."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(samples, dtype=np.complex64).ravel()
    iq = x.view(np.float32)  # interleaved re/im, no copy
    n = lib.sdr_iq_write(
        path.encode(), _ptr(iq, ctypes.c_float), x.size, ctypes.c_float(scale)
    )
    if n < 0:
        raise OSError(f"sdr_iq_write failed for {path!r}")
    return int(n)


def iq_info(path: str) -> int:
    """Complex-sample count of an SC16 file."""
    lib = _lib_or_raise()
    n = lib.sdr_iq_info(path.encode())
    if n < 0:
        raise OSError(f"cannot stat {path!r}")
    return int(n)


def read_iq(
    path: str, offset: int = 0, count: int = -1, scale: float = DEFAULT_SCALE
) -> np.ndarray:
    """Read complex64 samples back (count=-1: to EOF)."""
    lib = _lib_or_raise()
    total = iq_info(path)
    if count < 0:
        count = max(total - offset, 0)
    out = np.empty(2 * count, np.float32)
    got = lib.sdr_iq_read(
        path.encode(), offset, count, _ptr(out, ctypes.c_float),
        ctypes.c_float(1.0 / scale),
    )
    if got < 0:
        raise OSError(f"sdr_iq_read failed for {path!r}")
    return out[: 2 * int(got)].view(np.complex64)


class IQReader:
    """Streaming frame reader with C++ prefetch (see module docstring).

    Iterating yields complex64 frames of ``frame`` samples until EOF
    (or forever with ``loop=True``). ``next_real()`` returns the
    (re, im) float32 pair of the next frame.
    """

    def __init__(
        self,
        path: str,
        frame: int,
        scale: float = DEFAULT_SCALE,
        loop: bool = False,
        depth: int = 4,
    ):
        if not os.path.isfile(path):
            # The C++ worker thread only discovers a bad path as EOF;
            # fail loudly at construction instead.
            raise OSError(f"no such IQ file: {path!r}")
        self._lib = _lib_or_raise()
        self._frame = int(frame)
        self._h = self._lib.sdr_iq_reader_open(
            path.encode(), self._frame, ctypes.c_float(1.0 / scale),
            int(loop), int(depth),
        )
        if not self._h:
            raise OSError(f"cannot open IQ reader on {path!r}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sdr_iq_reader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def next_real(self):
        """(re, im) float32 arrays of the next frame, or None at EOF."""
        out = np.empty(2 * self._frame, np.float32)
        if not self._lib.sdr_iq_reader_next(self._h, _ptr(out, ctypes.c_float)):
            return None
        iq = out.reshape(self._frame, 2)
        return np.ascontiguousarray(iq[:, 0]), np.ascontiguousarray(iq[:, 1])

    def __iter__(self):
        while True:
            nxt = self.next_real()
            if nxt is None:
                return
            yield (nxt[0] + 1j * nxt[1]).astype(np.complex64)
