"""The app layer of the port: the baseline cases (``app/baseline_configs.py``)
and the terminal loopback demo (``app/demo.py``)."""
