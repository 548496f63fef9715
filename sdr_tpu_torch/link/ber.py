"""BER utilities: error counting and exact AWGN theory curves.

The reference asserts only exact loopback equality (ofdm_test.cpp:
28-36); a statistical simulator needs theory to validate against. For
Gray-coded square QAM over AWGN the exact bit error probability is the
Cho–Yoon closed form (per-axis PAM decomposition — the same
decomposition the LLR demapper exploits), implemented host-side in
numpy for test oracles and plot overlays.

A numpy copy of the AWGN, flat-Rayleigh and flat-Rician curves and the
MIMO diversity curves (``ber_mrc_exact``, ``ber_alamouti_exact``) of
``sdr_tpu/link/ber.py`` (importing that package pulls in JAX), its
``count_bit_errors``, and ``ber_given_gain``: the exact BER over a
channel a run drew, the gate of the selective and time-varying links.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sdr_tpu_torch.core.config import Modulation


def qfunc(x):
    """Gaussian tail Q(x) = 0.5 erfc(x / sqrt(2)). Scalar or ndarray."""
    return 0.5 * np.vectorize(math.erfc)(np.asarray(x, np.float64) / math.sqrt(2.0))


def _pam_bit_error(L: int, k: int, arg_base: float, q=qfunc) -> float:
    """Exact Gray L-PAM error probability of axis-bit position k (1-based).

    Cho & Yoon (2002): with a = (2i+1) * arg_base, arg_base being the
    normalized half-spacing over the per-real-dimension noise sigma,

      P(k) = (1/L) * sum_{i=0}^{(1-2^-k)L - 1}
             (-1)^floor(i 2^(k-1)/L) * (2^(k-1) - floor(i 2^(k-1)/L + 1/2))
             * 2 Q((2i+1) * arg_base)

    ``q`` substitutes a fading-averaged tail function (the terms are
    linear in Q, so averaging over a fading distribution commutes with
    the sum — how ber_rayleigh_exact reuses the same weights).
    """
    total = 0.0
    half = 1 << (k - 1)
    for i in range(int((1.0 - 2.0 ** (-k)) * L)):
        sign = -1.0 if ((i * half) // L) % 2 else 1.0
        weight = half - math.floor(i * half / L + 0.5)
        total += sign * weight * 2.0 * float(q((2 * i + 1) * arg_base))
    return total / L


def ber_awgn_exact(mod: Modulation, ebno_db: float) -> float:
    """Exact AWGN BER for Gray square QAM / BPSK (Cho–Yoon 2002).

    Derivation of arg_base: constellations are unit-Es normalized
    (sdr_tpu.ops.modulation), so adjacent levels sit 2*norm apart and a
    decision boundary is norm away; per-real-dim noise sigma_d =
    sqrt(N0/2) with N0 = 1/(k_total * gamma_b). Hence
    arg_base = norm * sqrt(2 * k_total * gamma_b).
    """
    gamma_b = 10.0 ** (ebno_db / 10.0)
    L = mod.levels_per_axis
    m = mod.bits_per_axis
    arg_base = mod.unit_energy_scale * math.sqrt(2.0 * mod.bits_per_symbol * gamma_b)
    per_axis_bits = [_pam_bit_error(L, k, arg_base) for k in range(1, m + 1)]
    # Square schemes: both axes identical; BPSK: single axis. Either
    # way the average over all bits equals the per-axis-bit average.
    return float(np.mean(per_axis_bits))


def _rayleigh_q(c):
    """E_h[Q(c·|h|)] for |h|² ~ Exp(1) (unit-power Rayleigh fading):
    the standard closed form ½(1 − c/√(2+c²))."""
    c = np.asarray(c, np.float64)
    return 0.5 * (1.0 - c / np.sqrt(2.0 + c * c))


def ber_rayleigh_exact(mod: Modulation, ebno_db: float) -> float:
    """Exact average BER over flat Rayleigh fading with genie one-tap
    equalization (instantaneous γ_b = |h|²·γ̄_b, |h|² ~ Exp(1)).

    The Cho–Yoon expansion is linear in Q, so averaging each term
    analytically gives the exact fading BER with the same weights —
    the validation reference for the RAYLEIGH_FLAT Monte-Carlo paths,
    where empirical-vs-empirical comparisons are dominated by the
    fade-realization variance at high Eb/N0."""
    gamma_b = 10.0 ** (ebno_db / 10.0)
    L = mod.levels_per_axis
    m = mod.bits_per_axis
    arg_base = mod.unit_energy_scale * math.sqrt(2.0 * mod.bits_per_symbol * gamma_b)
    per_axis_bits = [
        _pam_bit_error(L, k, arg_base, q=_rayleigh_q) for k in range(1, m + 1)
    ]
    return float(np.mean(per_axis_bits))


def _rician_q(c, k_factor: float, n_nodes: int = 96):
    """E_h[Q(c·|h|)] for flat Rician fading with E|h|² = 1.

    MGF method: Q(x) = (1/π)∫₀^{π/2} exp(−x²/(2sin²θ))dθ (Craig), so
    E[Q(c|h|)] = (1/π)∫₀^{π/2} M(−c²/(2sin²θ))dθ with the Rician power
    MGF M(s) = (1+K)/(1+K−s) · exp(K·s/(1+K−s)). Gauss–Legendre
    quadrature on θ — exact to well below test tolerances at 96 nodes
    (the integrand is smooth and bounded). K = 0 reproduces the
    Rayleigh closed form (_rayleigh_q), asserted in tests.
    """
    K = float(k_factor)
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    theta = (x + 1.0) * (math.pi / 4.0)  # map [-1,1] → [0, π/2]
    s2 = np.sin(theta) ** 2
    c = np.asarray(c, np.float64)
    s = -(c * c) / (2.0 * s2)
    mgf = (1.0 + K) / (1.0 + K - s) * np.exp(K * s / (1.0 + K - s))
    return float(np.sum(w * mgf) * (math.pi / 4.0) / math.pi)


def ber_rician_exact(mod: Modulation, ebno_db: float, k_factor: float) -> float:
    """Exact average BER over flat Rician fading with genie one-tap
    equalization — Cho–Yoon weights with each Q term averaged over the
    noncentral fade power via the MGF integral (_rician_q)."""
    gamma_b = 10.0 ** (ebno_db / 10.0)
    L = mod.levels_per_axis
    m = mod.bits_per_axis
    arg_base = mod.unit_energy_scale * math.sqrt(2.0 * mod.bits_per_symbol * gamma_b)
    per_axis_bits = [
        _pam_bit_error(L, k, arg_base, q=lambda c: _rician_q(c, k_factor))
        for k in range(1, m + 1)
    ]
    return float(np.mean(per_axis_bits))


def _mrc_q(c, branches: int, branch_scale: float = 1.0, n_nodes: int = 96):
    """E_g[Q(c·√(a·g))] for g = Σ_L |h_i|², h_i ~ CN(0, 1) i.i.d. (L-branch
    Rayleigh MRC, g ~ Gamma(L, 1)), a = ``branch_scale``: Craig's form with
    the MGF (1 − s)^−L, (1/π)∫₀^{π/2} (1 + a·c²/(2sin²θ))^−L dθ by
    Gauss–Legendre on θ, as ``_rician_q``."""
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    theta = (x + 1.0) * (math.pi / 4.0)
    s2 = np.sin(theta) ** 2
    c = np.asarray(c, np.float64)
    integ = (1.0 + branch_scale * c * c / (2.0 * s2)) ** (-float(branches))
    return float(np.sum(w * integ) * (math.pi / 4.0) / math.pi)


def _diversity_exact(mod: Modulation, ebno_db: float, branches: int,
                     branch_scale: float) -> float:
    gamma_b = 10.0 ** (ebno_db / 10.0)
    L = mod.levels_per_axis
    m = mod.bits_per_axis
    arg_base = mod.unit_energy_scale * math.sqrt(2.0 * mod.bits_per_symbol * gamma_b)
    per_axis_bits = [
        _pam_bit_error(L, k, arg_base, q=lambda c: _mrc_q(c, branches, branch_scale))
        for k in range(1, m + 1)
    ]
    return float(np.mean(per_axis_bits))


def ber_mrc_exact(mod: Modulation, ebno_db: float, n_rx: int) -> float:
    """Exact average BER of 1 × n_rx receive MRC over i.i.d. flat Rayleigh
    branches with genie CSI (g ~ Gamma(n_rx, 1) at the full per-branch
    SNR); n_rx = 1 is ``ber_rayleigh_exact``."""
    return _diversity_exact(mod, ebno_db, n_rx, 1.0)


def ber_alamouti_exact(mod: Modulation, ebno_db: float, n_rx: int = 1) -> float:
    """Exact average BER of Alamouti 2 × n_rx over i.i.d. flat Rayleigh with
    genie CSI: 2·n_rx MRC branches at half the per-branch SNR (the TX
    power split)."""
    return _diversity_exact(mod, ebno_db, 2 * n_rx, 0.5)


def count_bit_errors(tx_bits, rx_bits) -> int:
    """The number of positions where two bit arrays differ."""
    return int((torch.as_tensor(tx_bits) != torch.as_tensor(rx_bits)).sum())


def ber_given_gain(mod, ebno_db: float, g2) -> float:
    """Exact Gray-QAM AWGN BER at Eb/N0·|H|², averaged over the channel
    gains ``g2`` (a float64 tensor, one element per equally weighted
    subcarrier group): the BER of the channel a run drew. With CP ≥ L−1
    each subcarrier is an AWGN channel at its own |H|², and the one-tap
    equaliser's max-log decisions are exact per axis (the Cho–Yoon
    weights of ``_pam_bit_error``)."""
    L, m = mod.levels_per_axis, mod.bits_per_axis
    gamma = 2.0 * mod.bits_per_symbol * 10.0 ** (ebno_db / 10.0)
    total = 0.0
    for part in torch.split(g2.reshape(-1), 1 << 24):
        arg = mod.unit_energy_scale * torch.sqrt(gamma * part) / math.sqrt(2.0)
        acc = torch.zeros_like(arg)
        for k in range(1, m + 1):
            half = 1 << (k - 1)
            for i in range(int((1.0 - 2.0 ** (-k)) * L)):
                sign = -1.0 if ((i * half) // L) % 2 else 1.0
                weight = half - math.floor(i * half / L + 0.5)
                acc += (sign * weight / L) * torch.special.erfc((2 * i + 1) * arg)
        total += float(acc.sum())
    return total / g2.numel() / m
