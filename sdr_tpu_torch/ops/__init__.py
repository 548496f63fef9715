"""Reference-contract signal ops of the port, on torch tensors.

The names the JAX package's ``sdr_tpu.ops`` exports resolve here on first
use (PEP 562), so importing the package imports no op module — but for
``fft`` and ``interleave``, which name this package's submodules (an
attribute lookup must keep giving the module).
"""

import importlib

_EXPORTS = {
    "fft": ("ifft",),
    "ofdm": ("cp_insert", "cp_remove", "ofdm_tx", "ofdm_rx"),
    "modulation": ("constellation", "modulate", "demodulate_hard", "nearest_symbol",
                   "bits_to_bytes", "bytes_to_bits", "to_constl", "from_constl"),
    "channel": ("awgn", "rayleigh_flat", "multipath_taps", "apply_multipath"),
    "equalize": ("equalize_zf", "equalize_mmse"),
    "llr": ("llr_maxlog", "llr_exact", "llr_to_hard_bits"),
    "fec": ("conv_encode", "viterbi_decode", "coded_len"),
    "interleave": ("deinterleave",),
    "pilots": ("estimate_ls_comb", "insert_pilots", "extract_data"),
    "demod": ("demod_chain",),
    "sync": ("apply_cfo", "correct_cfo", "estimate_timing_cfo", "schmidl_cox_preamble",
             "timing_metric"),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
