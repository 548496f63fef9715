"""sdr_tpu_torch — the PyTorch/CUDA port of ``sdr_tpu``.

A second package beside the JAX/Pallas ``sdr_tpu``, which stays the
reference each part of the port is held against. Its layout mirrors
``sdr_tpu`` so every module has an obvious counterpart:

- ``sdr_tpu_torch.core``    — configs (a stdlib-only copy), the precision
  policy and keyed Philox randomness;
- ``sdr_tpu_torch.ops``     — reference-contract ops on ``torch``: FFT,
  OFDM cyclic prefix, Gray QAM, equalizers, max-log LLR, the flat
  channels, the demod terminals;
- ``sdr_tpu_torch.kernels`` — hand-written CUDA C++ kernels for Hopper
  (sources in ``sdr_tpu_torch/csrc``), each with its plain torch
  version beside it;
- ``sdr_tpu_torch.link``    — the link pipeline, the coded links, the
  packet modem and link adaptation, the keyed fast link engine, the
  Monte-Carlo engine and BER theory;
- ``sdr_tpu_torch.obs``     — the Eb/N0 sweep, structured metrics, the
  waveform statistics (PAPR, EVM, PSD), the demod roofline, the profiler
  hook, the health probe, the demod route autotuner, weak scaling and the
  BER figures;
- ``sdr_tpu_torch.app``     — the command line (``python -m
  sdr_tpu_torch``), the baseline cases and the terminal loopback demo;
- ``sdr_tpu_torch.native``  — ctypes bindings to the repository's C++ host
  runtime (``native/``): SC16 IQ files, the ring, the C++ PHY oracle;
- ``sdr_tpu_torch.utils``   — the sliding buffers;
- ``sdr_tpu_torch.interop`` — configs and numpy state carried across
  from the JAX package.

The package imports torch, numpy and the standard library only — never
JAX. Importing it builds nothing: the kernel library is compiled by
``nvcc`` on the first launch on a CUDA tensor, the native host library by
``g++`` on its first use.
"""

__version__ = "0.1.0"
