"""Observability of the port: the Eb/N0 sweep (``obs/sweep.py``), the
structured metrics (``obs/metrics.py``), the waveform statistics
(``obs/waveform.py``), the demod roofline (``obs/roofline.py``), the
profiler hook (``obs/profile.py``), the demod route autotuner
(``obs/autotune.py``), the health probe (``obs/health.py``), weak scaling
(``obs/scaling.py``) and the BER figures (``obs/plot.py``).

The names the JAX package's ``sdr_tpu.obs`` exports resolve here on first
use (PEP 562), but for the FFT backend autotuner (``TunePoint``,
``recommend_crossover``, ``tune_fft``), which the port has no counterpart
for.
"""

import importlib

_EXPORTS = {
    "sweep": ("SweepPoint", "SweepResult", "ebno_sweep"),
    "roofline": ("RooflineReport", "demod_roofline"),
    "profile": ("trace",),
    "metrics": ("Metrics", "global_metrics"),
    "health": ("HealthReport", "probe_device"),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
