"""The coded link's code family (port of the LDPC part of
``sdr_tpu/link/coded.py`` that the coded fast engine needs).

``ldpc_code_for`` gives the stock QC-LDPC family (nb = 24, Z = 128;
rates 1/2, 2/3, 3/4), ``ldpc_codewords_per_channel`` the whole codewords
a frame holds. ``simulate_ldpc`` and the convolutional and polar
families run through ``link.pipeline`` and are ROADMAP queue 1, item
11f.
"""

from __future__ import annotations

from sdr_tpu_torch.core.config import LinkConfig
from sdr_tpu_torch.ops.ldpc import QcLdpcCode, make_qc_ldpc

_LDPC_MB = {"1/2": 12, "2/3": 8, "3/4": 6}  # nb = 24 base, rate = (nb − mb)/nb


def ldpc_code_for(rate: str = "1/2", z: int = 128) -> QcLdpcCode:
    """The stock QC-LDPC code family (nb = 24, Z = 128)."""
    if rate not in _LDPC_MB:
        raise ValueError(f"LDPC rate must be one of {sorted(_LDPC_MB)}")
    return make_qc_ldpc(nb=24, mb=_LDPC_MB[rate], z=z)


def ldpc_codewords_per_channel(cfg: LinkConfig, code: QcLdpcCode) -> int:
    """Whole codewords per frame (the rest of the frame is zero padding —
    known bits the receiver never counts)."""
    frame_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    n_cw = frame_bits // code.n
    if n_cw < 1:
        raise ValueError(f"frame of {frame_bits} bits cannot fit an n={code.n} codeword")
    return n_cw
