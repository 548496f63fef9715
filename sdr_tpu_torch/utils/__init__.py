"""Utilities of the port: the sliding buffers (``utils/sliding_buffer.py``).

The names the JAX package's ``sdr_tpu.utils`` exports resolve here on
first use (PEP 562).
"""

import importlib

_EXPORTS = {
    "sliding_buffer": ("RingState", "SlidingBuffer", "ring_new", "ring_push", "ring_read",
                       "ring_window"),
}
_WHERE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    if name in _WHERE:
        return getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
