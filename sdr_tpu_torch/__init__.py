"""sdr_tpu_torch — the PyTorch/CUDA port of ``sdr_tpu``.

A second package beside the JAX/Pallas ``sdr_tpu``, which stays the
reference each part of the port is held against. Its layout mirrors
``sdr_tpu`` so every module has an obvious counterpart:

- ``sdr_tpu_torch.core``    — configs (a stdlib-only copy) and keyed
  Philox randomness;
- ``sdr_tpu_torch.ops``     — reference-contract ops on ``torch``: FFT,
  OFDM cyclic prefix, Gray QAM, equalizers, max-log LLR, the flat
  channels, the demod terminals;
- ``sdr_tpu_torch.kernels`` — hand-written CUDA C++ kernels for Hopper
  (sources in ``sdr_tpu_torch/csrc``), each with its plain torch
  version beside it;
- ``sdr_tpu_torch.link``    — the keyed fast link engine, the
  Monte-Carlo engine and BER theory;
- ``sdr_tpu_torch.obs``     — the Eb/N0 sweep;
- ``sdr_tpu_torch.interop`` — configs and numpy state carried across
  from the JAX package.

The package imports torch, numpy and the standard library only — never
JAX. Importing it builds nothing: the kernel library is compiled by
``nvcc`` on the first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
