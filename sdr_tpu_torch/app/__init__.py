"""The app layer of the port: the command line (``app/cli.py``, run as
``python -m sdr_tpu_torch``), the baseline cases (``app/baseline_configs.py``)
and the terminal loopback demo (``app/demo.py``)."""
