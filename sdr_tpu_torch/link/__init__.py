"""Link engines of the port: the link pipeline and its coded links, the
packet modem (``packet``) and link adaptation (``adapt``), the keyed fast
engine, the blocked stream, the Monte-Carlo engine and BER theory.

The names the JAX package's ``sdr_tpu.link`` exports resolve here on first
use (PEP 562), so importing the package imports no engine.
"""

import importlib

_EXPORTS = {
    "pipeline": ("LinkResult", "generate_bits", "tx_chain", "apply_channel", "rx_chain",
                 "simulate", "make_simulate_fn"),
    "ber": ("qfunc", "ber_awgn_exact", "count_bit_errors"),
    "coded": ("info_bits_per_channel", "make_coded_fn", "simulate_coded"),
    "fast": ("fast_simulate", "make_fast_fn"),
    "stream": ("stream_simulate",),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
