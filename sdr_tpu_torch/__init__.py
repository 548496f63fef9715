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
- ``sdr_tpu_torch.obs``     — the Eb/N0 sweep, structured metrics and the
  waveform statistics (PAPR, EVM, PSD);
- ``sdr_tpu_torch.app``     — the baseline cases and the terminal
  loopback demo;
- ``sdr_tpu_torch.utils``   — the sliding buffers;
- ``sdr_tpu_torch.interop`` — configs and numpy state carried across
  from the JAX package.

The package imports torch, numpy and the standard library only — never
JAX. Importing it builds nothing: the kernel library is compiled by
``nvcc`` on the first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
