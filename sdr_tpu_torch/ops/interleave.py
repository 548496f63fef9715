"""Bit interleaving between the encoder and the mapper.

Port of ``sdr_tpu/ops/interleave.py``: a static seeded permutation of
the last axis (numpy ``default_rng(seed).permutation``, the same
permutation element for element as the JAX package's), applied as one
gather; its inverse is precomputed with it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SEED = 0x1EAF


@functools.lru_cache(maxsize=None)
def _perm(n: int, seed: int):
    """(perm, inverse) as int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(n).astype(np.int32)
    inv = np.empty_like(p)
    inv[p] = np.arange(n, dtype=np.int32)
    return p, inv


@functools.lru_cache(maxsize=None)
def _perm_tensor(n: int, seed: int, inverse: bool, device: str) -> torch.Tensor:
    return torch.as_tensor(_perm(n, seed)[int(inverse)], dtype=torch.int64, device=device)


def interleave(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """Permute the last axis with the seeded static permutation."""
    return x[..., _perm_tensor(x.shape[-1], seed, False, str(x.device))]


def deinterleave(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """Inverse of ``interleave`` (same seed, same length)."""
    return x[..., _perm_tensor(x.shape[-1], seed, True, str(x.device))]
