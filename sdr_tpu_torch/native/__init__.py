"""The native host runtime of the port: ctypes bindings to the repository's
C++ sources (``native/``), built by ``g++`` into ``sdr_tpu_torch/_build``
on first use (``native/host.py``), and SC16 IQ files (``native/iq.py``)."""

from sdr_tpu_torch.native.host import (  # noqa: F401
    NativeRing,
    available,
    crc32,
    fft as native_fft,
    ifft as native_ifft,
    ofdm_rx as native_ofdm_rx,
    ofdm_tx as native_ofdm_tx,
    pack_bits,
    qam_demap_hard,
    qam_map,
    unpack_bits,
)
