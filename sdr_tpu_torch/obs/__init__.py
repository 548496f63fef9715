"""Observability: the Eb/N0 sweep (``obs/sweep.py``)."""
