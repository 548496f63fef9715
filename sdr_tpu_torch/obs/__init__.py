"""Observability of the port: the Eb/N0 sweep (``obs/sweep.py``), the
structured metrics (``obs/metrics.py``) and the waveform statistics
(``obs/waveform.py``).

The names the JAX package's ``sdr_tpu.obs`` exports resolve here on first
use (PEP 562), for the modules the port has.
"""

import importlib

_EXPORTS = {
    "sweep": ("SweepPoint", "SweepResult", "ebno_sweep"),
    "metrics": ("Metrics", "global_metrics"),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
