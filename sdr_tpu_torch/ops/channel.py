"""Channel models the fast link uses: AWGN, flat Rayleigh, flat Rician.

Port of the subset of ``sdr_tpu/ops/channel.py`` on the slice's path.
The JAX functions take a ``jax.random`` key per channel; here every
draw is keyed Philox (``sdr_tpu_torch.core.prng``): a pure function of
(seed, role, global channel id, position), so a channel's fading and
noise do not depend on the batch it is computed in.

Noise calibration (as in the JAX package): constellations have unit
average power per subcarrier. With the unscaled forward / 1/N inverse
FFT a unit-power subcarrier symbol is a time signal of power 1/N, and
the RX forward FFT multiplies noise power by N, so ``time_noise_var``
divides the subcarrier variance by n_fft. Es/N0 = bits_per_symbol·Eb/N0.
"""

from __future__ import annotations

import math

import torch

from sdr_tpu_torch.core import prng


def ebno_db_to_noise_var(ebno_db, bits_per_symbol: int) -> torch.Tensor:
    """Eb/N0 [dB] → complex noise variance N0 at the subcarrier (Es = 1),
    computed in float32 like the JAX function."""
    ebno = torch.as_tensor(ebno_db, dtype=torch.float32)
    esno = 10.0 ** (ebno / 10.0) * bits_per_symbol
    return 1.0 / esno


def time_noise_var(noise_var, n_fft: int) -> torch.Tensor:
    """Subcarrier noise variance → time-domain (pre-FFT) variance."""
    return torch.as_tensor(noise_var, dtype=torch.float32) / n_fft


def cgauss(seed: int, role: int, ch_ids: torch.Tensor, shape, var=1.0,
           lane: int = 0) -> torch.Tensor:
    """CN(0, var) complex64 (B, *shape) for a per-channel 2-D ``shape``:
    Box–Muller on words 0 and 1 of Philox(seed ^ role, (ch, i, j, lane))."""
    g1, g2 = prng.normal_pair(seed, role, ch_ids, shape, lane)
    std = math.sqrt(float(var) * 0.5)
    return torch.complex(g1 * std, g2 * std)


def awgn(x: torch.Tensor, noise_var, seed: int, ch_ids: torch.Tensor) -> torch.Tensor:
    """y = x + CN(0, noise_var) for x (B, S, L), the noise keyed by
    (seed ^ ROLE_NOISE, ch_ids[b], s, l) — the fused TX kernel's stream."""
    if x.ndim != 3:
        raise ValueError(f"awgn takes (B, S, L) samples, got {tuple(x.shape)}")
    n = cgauss(seed, prng.ROLE_NOISE, ch_ids, x.shape[1:])
    return x + n * math.sqrt(float(noise_var))


def rayleigh_flat(seed: int, ch_ids: torch.Tensor) -> torch.Tensor:
    """Per-channel flat Rayleigh gain h ~ CN(0, 1), (B, 1, 1) complex64."""
    return cgauss(seed, prng.ROLE_FADING, ch_ids, (1, 1))


def rician_flat(seed: int, ch_ids: torch.Tensor, k_factor: float) -> torch.Tensor:
    """Per-channel flat Rician gain with linear K-factor, E|h|² = 1:
    h = √(K/(K+1))·e^{jφ} + √(1/(K+1))·CN(0, 1), φ ~ U[0, 2π) drawn on
    lane 1 of the fading stream. (B, 1, 1) complex64."""
    K = float(k_factor)
    phase = prng.uniform_plane(seed, prng.ROLE_FADING, ch_ids, (1, 1), lane=1)
    phase = phase * (2.0 * math.pi)
    los = math.sqrt(K / (K + 1.0)) * torch.complex(torch.cos(phase), torch.sin(phase))
    return los + cgauss(seed, prng.ROLE_FADING, ch_ids, (1, 1), var=1.0 / (K + 1.0))
