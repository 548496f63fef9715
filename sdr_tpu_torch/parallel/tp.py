"""Tensor parallelism: one OFDM transform split across ranks (port of
``sdr_tpu/parallel/tp.py``).

The demod runs with the SUBCARRIER axis of one FFT sharded over a mesh
axis: the distributed-FFT transpose algorithm. Factor N = N1·N2
(Cooley–Tukey):

    x[n1·N2 + n2]                                   (n1 chunk, n2 lane)
    G[k1, n2] = FFT_{N1} over n1                    — stage 1
    T[k1, n2] = G[k1, n2] · W_N^{n2·k1}             — twiddle
    X[k1 + N1·k2] = DFT_{N2} over n2                — stage 2

Each rank runs stage 1 and the twiddle on its block of N2/D lanes
(torch's FFT: the JAX package computes it in XLA, outside any kernel).
ONE ``all_to_all`` moves the data from lane split to chunk split (the
lane blocks are contiguous per rank, so the send buffer is chunk-major
and concatenating what arrives in peer order restores natural lanes);
then stage 2 with the MMSE equaliser and the max-log LLRs runs on the
rank's digit block in kernel C's TP mode (``kernels.demod.tp_stage2_llr``,
the port of ``_stage2_llr_pallas``), which reads the noise variance from
device memory. One ``all_gather`` of the LLR blocks and
``digit_restore_llrs`` give every rank the public-order plane.

Differences from the JAX function, deliberate: there is no ``backend=``
(the rank's device picks the kernel or its plain version, as everywhere
in the port), no build-time ``noise_var=`` (the noise variance is the
returned function's runtime argument), and no n2 ≤ 512, n2 % 128 == 0
cap (a VMEM and MXU limit of the TPU kernel; the port's kernel takes
n2 from 2 to 4096).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import demod as _kc
from sdr_tpu_torch.parallel import _comm
from sdr_tpu_torch.parallel.distributed import resolve_device
from sdr_tpu_torch.parallel.mesh import LinkMesh


def tp_split(n_fft: int, n_dev: int) -> tuple[int, int]:
    """Pick N = N1·N2 with D | N1 (chunk shards) and D | N2 (lane shards):
    N1 = D. Requires D² | N."""
    if n_fft % (n_dev * n_dev) != 0:
        raise ValueError(
            f"subcarrier-split demod needs n_dev^2 | n_fft "
            f"(got n_fft={n_fft}, n_dev={n_dev})"
        )
    return n_dev, n_fft // n_dev


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int):
    """tw[k1, n2] = W_N^{n2·k1} as planar float32 (N = N1·N2)."""
    kk = np.outer(np.arange(n1), np.arange(n2)).astype(np.float64)
    w = np.exp(-2j * np.pi * kk / (n1 * n2))
    return np.real(w).astype(np.float32), np.imag(w).astype(np.float32)


def digit_permute_h(h: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Natural-order (..., N) channel plane → digit-major (..., n1, n2):
    digit (k1, k2) carries subcarrier k1 + N1·k2."""
    lead = h.shape[:-1]
    return h.reshape(lead + (n2, n1)).transpose(-1, -2)


def digit_restore_llrs(llr4: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Digit-major LLRs (B, S, n1, n2·bps) → public (B, S, N·bps)."""
    b, s, n1, _ = llr4.shape
    bps = mod.bits_per_symbol
    n2 = llr4.shape[-1] // bps
    out = llr4.reshape(b, s, n1, n2, bps).permute(0, 1, 3, 2, 4)
    return out.reshape(b, s, n1 * n2 * bps)


def make_tp_demod_fn(n_fft: int, cp_len: int, mod: Modulation, mesh: LinkMesh,
                     axis: str = "time", device="cuda"):
    """Subcarrier-sharded demod over ``mesh[axis]``, SPMD: every rank of
    the axis calls the returned ``fn(re, im, hr, hi, noise_var)`` with the
    GLOBAL planar samples (B, S, n_fft + cp_len) and natural-order channel
    (B, 1 | S, n_fft), and gets the public-order (B, S, n_fft·bps) float32
    LLR plane (``ops.demod.demod_chain``'s contract). ``noise_var`` is a
    float or a 0-d tensor, read at run time. Runs on ``device`` (the card
    unless the caller asks for the CPU)."""
    if not isinstance(mesh, LinkMesh):
        raise TypeError(f"make_tp_demod_fn takes a LinkMesh, got {type(mesh).__name__!r}")
    dev = resolve_device(device)
    n_dev = mesh.shape[axis]
    n1, n2 = tp_split(n_fft, n_dev)
    d = mesh.coord(axis)
    group = mesh.group(axis)
    n1d, n2l = n1 // n_dev, n2 // n_dev
    lanes = slice(d * n2l, (d + 1) * n2l)
    digits = slice(d * n1d, (d + 1) * n1d)
    twr, twi = (torch.as_tensor(a[:, lanes], device=dev) for a in _twiddle_np(n1, n2))
    tw = torch.complex(twr, twi)  # this rank's lane block of the twiddle (n1, n2/D)

    def fn(re, im, hr, hi, noise_var):
        re, im, hr, hi = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                          for a in (re, im, hr, hi))
        b, s, sym_len = re.shape
        if sym_len - cp_len != n_fft:
            raise ValueError(f"expected sym_len={n_fft + cp_len}, got {sym_len}")
        h_syms = hr.shape[1]
        if tuple(hr.shape) != (b, h_syms, n_fft) or h_syms not in (1, s) or hi.shape != hr.shape:
            raise ValueError(f"unsupported channel shape {tuple(hr.shape)}")
        x = torch.complex(re[..., cp_len:].reshape(b, s, n1, n2)[..., lanes],
                          im[..., cp_len:].reshape(b, s, n1, n2)[..., lanes])
        t = torch.fft.fft(x, dim=2) * tw  # stage 1 and twiddle on this rank's lanes
        # Lane split → chunk split: chunk block j goes to rank j; what
        # arrives, in peer order, is this rank's digit block over all lanes.
        send = torch.view_as_real(t.reshape(b, s, n_dev, n1d, n2l).permute(2, 0, 1, 3, 4))
        recv = torch.view_as_complex(_comm.all_to_all(send.contiguous(), group))
        t = recv.permute(1, 2, 3, 0, 4).reshape(b, s, n1d, n2)
        hr4 = digit_permute_h(hr, n1, n2)[:, :, digits].contiguous()
        hi4 = digit_permute_h(hi, n1, n2)[:, :, digits].contiguous()
        nv = torch.as_tensor(noise_var, dtype=torch.float32, device=dev).reshape(())
        llr = _kc.tp_stage2_llr(t.real.contiguous(), t.imag.contiguous(), hr4, hi4, nv, mod)
        blocks = _comm.all_gather(llr, group)  # (D, B, S, n1d, n2·bps)
        llr4 = blocks.permute(1, 2, 0, 3, 4).reshape(b, s, n1, n2 * mod.bits_per_symbol)
        return digit_restore_llrs(llr4, mod)

    return fn
