"""Max-log LLR soft demapper (port of ``sdr_tpu/ops/llr.py``).

For Gray-coded square constellations the 2-D max-log metric separates
into two PAM problems (I bits from Re, Q bits from Im):

    LLR(b) = ( min_{a: b=1} (y−a)² − min_{a: b=0} (y−a)² ) / noise_var

Positive LLR ⇒ bit 0 more likely; hard bit = (LLR < 0). Bit order
matches ``modulate``: per symbol, MSB first, I-axis bits then Q-axis.
``llr_exact`` gives the true-MAP LLRs (log-sum-exp over each level set)
with the same signature and order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.ops.modulation import _tables


@functools.lru_cache(maxsize=None)
def _axis_bit_masks(mod: Modulation) -> np.ndarray:
    """bool (m, L): mask[j, g] = bit j (MSB-first) of Gray index g."""
    m = mod.bits_per_axis
    g = np.arange(mod.levels_per_axis)
    return np.stack([((g >> (m - 1 - j)) & 1).astype(bool) for j in range(m)])


def axis_metric(y: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Per-axis max-log metric differences
    min_{b=1} (y−a)² − min_{b=0} (y−a)²: y (...,) real normalised →
    (..., m), MSB first. LLR = metric / noise_var."""
    _, pam, norm, _ = _tables(mod)
    levels = torch.as_tensor(pam, device=y.device) * float(norm)
    d2 = (y[..., None] - levels) ** 2
    masks = torch.as_tensor(_axis_bit_masks(mod), device=y.device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=y.device)
    outs = []
    for j in range(mod.bits_per_axis):
        d1 = torch.where(masks[j], d2, inf).amin(dim=-1)
        d0 = torch.where(masks[j], inf, d2).amin(dim=-1)
        outs.append(d1 - d0)
    return torch.stack(outs, dim=-1)


def _axis_llr(y: torch.Tensor, mod: Modulation, noise_var: torch.Tensor) -> torch.Tensor:
    """Per-axis max-log LLRs: y (...,) real normalised → (..., m)."""
    return axis_metric(y, mod) / noise_var[..., None]


def llr_maxlog(points: torch.Tensor, mod: Modulation, noise_var) -> torch.Tensor:
    """Max-log LLRs for (..., n_sym) normalised complex points.

    ``noise_var`` broadcasts against ``points`` (pass the equalizer's
    per-subcarrier effective variance). Returns float32
    (..., n_sym · bits_per_symbol), MSB-first per symbol.
    """
    nv = torch.broadcast_to(
        torch.as_tensor(noise_var, dtype=torch.float32, device=points.device),
        points.shape,
    )
    if mod is Modulation.BPSK:
        return _axis_llr(points.real, mod, nv).reshape(points.shape)
    llr = torch.cat(
        [_axis_llr(points.real, mod, nv), _axis_llr(points.imag, mod, nv)], dim=-1
    )
    return llr.reshape(*points.shape[:-1], points.shape[-1] * mod.bits_per_symbol)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log Σ exp over the last axis, as ``jax.nn.logsumexp`` forms it:
    the max, plus the log of the sum of exp(x − max)."""
    m = x.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)) + m)[..., 0]


def _axis_llr_exact(y: torch.Tensor, mod: Modulation, noise_var: torch.Tensor) -> torch.Tensor:
    """Exact per-axis LLRs by log-sum-exp over each bit's level set:
    y (...,) real normalised → (..., m), MSB first."""
    _, pam, norm, _ = _tables(mod)
    levels = torch.as_tensor(pam, device=y.device) * float(norm)
    ll = -((y[..., None] - levels) ** 2) / noise_var[..., None]
    masks = torch.as_tensor(_axis_bit_masks(mod), device=y.device)
    neg = torch.tensor(-3.4e38, dtype=torch.float32, device=y.device)
    outs = []
    for j in range(mod.bits_per_axis):
        lse0 = _logsumexp(torch.where(masks[j], neg, ll))
        lse1 = _logsumexp(torch.where(masks[j], ll, neg))
        outs.append(lse0 - lse1)
    return torch.stack(outs, dim=-1)


def llr_exact(points: torch.Tensor, mod: Modulation, noise_var) -> torch.Tensor:
    """Exact (true-MAP) LLRs, port of ``sdr_tpu/ops/llr.py::llr_exact``:
    the signature and bit order of ``llr_maxlog``, with a log-sum-exp
    over each bit's level set in place of the max-log min. Both agree as
    noise_var → 0."""
    nv = torch.broadcast_to(
        torch.as_tensor(noise_var, dtype=torch.float32, device=points.device),
        points.shape,
    )
    if mod is Modulation.BPSK:
        return _axis_llr_exact(points.real, mod, nv).reshape(points.shape)
    llr = torch.cat(
        [_axis_llr_exact(points.real, mod, nv), _axis_llr_exact(points.imag, mod, nv)], dim=-1
    )
    return llr.reshape(*points.shape[:-1], points.shape[-1] * mod.bits_per_symbol)


def llr_to_hard_bits(llr: torch.Tensor) -> torch.Tensor:
    """Hard decisions from LLRs: bit = 1 iff LLR < 0."""
    return (llr < 0).to(torch.int8)
