"""The plain reference of the OFDM link, in torch and float32.

Recomputes, from a seed and global channel ids, what the simulator's
engines compute: the keyed payload, the Gray QAM map, the 1/N inverse
DFT and the cyclic prefix, the channel (flat gain or a causal FIR over
each channel's whole stream), the keyed AWGN, the CP strip, the DFT, the
one-tap equaliser and the max-log decisions or LLRs. It uses torch's
FFT and elementwise ops only, and nothing of the simulator.

``precision="bf16"`` is the control: every plane between two stages is
rounded to bfloat16 (the TX waveform, the received samples, the
subcarriers, the equalised points and the LLRs), the step a cheaper
implementation would take.

Keyed draws (``philox.py``): payload index n of (channel, symbol s) is
word n mod 4 of counter (channel, s, n div 4, 0) on ROLE_PAYLOAD, masked
to its bits; the noise of time sample u of symbol s is Box–Muller on
words 0 and 1 of counter (channel, s, u, 0) on ROLE_NOISE, σ = √(nv/N/2)
with nv = 1/(Eb/N0 · bits per symbol); a flat gain is CN(0, 1) at
(channel, 0, 0, 0) on ROLE_FADING, tap l of a multipath profile
CN(0, 1)·√(p_l/Σp) at (channel, 0, l, 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from linkbench.reference import philox

BITS = {"qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8, "1024qam": 10}


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision != "bf16":
        raise ValueError(f"precision must be float32 or bf16, got {precision!r}")
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).float(), x.imag.to(torch.bfloat16).float())
    return x.to(torch.bfloat16).float()


def levels(bits_per_symbol: int) -> np.ndarray:
    """Normalised axis levels by binary level index: (2i − (L−1))·√(3/(2(L²−1)))."""
    m = bits_per_symbol // 2
    L = 1 << m
    return (2.0 * np.arange(L) - (L - 1)) / math.sqrt(2.0 * (L * L - 1) / 3.0)


def noise_var(bits_per_symbol: int, ebno_db: float) -> float:
    return 1.0 / (10.0 ** (ebno_db / 10.0) * bits_per_symbol)


def payload(seed: int, ch_ids: torch.Tensor, n_symbols: int, n_fft: int, bps: int):
    """Symbol indices (B, S, N) int64."""
    dev = ch_ids.device
    w = philox.words(seed, philox.ROLE_PAYLOAD, ch_ids, torch.arange(n_symbols, device=dev),
                     torch.arange(-(-n_fft // 4), device=dev))
    idx = torch.stack(w, dim=-1).reshape(ch_ids.shape[0], n_symbols, -1)[..., :n_fft]
    return idx & ((1 << bps) - 1)


def gray_axes(idx: torch.Tensor, bps: int):
    """Symbol index → (I, Q) Gray indices: idx = (I << m) | Q."""
    m = bps // 2
    return idx >> m, idx & ((1 << m) - 1)


def _gray_to_level(g: torch.Tensor) -> torch.Tensor:
    b = g.clone()
    shift = 1
    while shift < 16:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def modulate(idx: torch.Tensor, bps: int) -> torch.Tensor:
    lev = torch.as_tensor(levels(bps), dtype=torch.float64, device=idx.device)
    gi, gq = gray_axes(idx, bps)
    return torch.complex(lev[_gray_to_level(gi)], lev[_gray_to_level(gq)]).to(torch.complex64)


def fading(seed: int, ch_ids: torch.Tensor, channel: dict):
    """(kind, value): ("flat", h (B,)), ("taps", taps (B, L)) or ("none", None)."""
    model = channel["model"]
    if model == "awgn":
        return "none", None
    if model == "rayleigh_flat":
        return "flat", philox.complex_gauss(seed, philox.ROLE_FADING, ch_ids, 1)[:, 0]
    if model == "multipath":
        p = torch.as_tensor(channel["pdp"], dtype=torch.float32, device=ch_ids.device)
        amps = torch.sqrt(p / torch.sum(p))
        return "taps", philox.complex_gauss(seed, philox.ROLE_FADING, ch_ids, len(p)) * amps
    raise ValueError(f"the reference has no channel model {model!r}")


def received(cfg: dict, channel: dict, seed: int, ch_ids: torch.Tensor, idx: torch.Tensor,
             precision: str = "float32"):
    """The subcarriers after the receiver's DFT, (B, S, N) complex64, and
    the channel's response (B, 1 | N) complex64 (ones for AWGN)."""
    S, N, cp = cfg["n_symbols"], cfg["n_fft"], cfg["cp_len"]
    B, dev = ch_ids.shape[0], ch_ids.device
    bps = cfg["bits_per_symbol"]
    x = _round(torch.fft.ifft(modulate(idx, bps), dim=-1), precision)
    x = torch.cat([x[..., N - cp:], x], dim=-1)  # (B, S, N + cp)
    kind, value = fading(seed, ch_ids, channel)
    if kind == "flat":
        y = x * value[:, None, None]
        resp = value[:, None]
    elif kind == "taps":
        stream = x.reshape(B, S * (N + cp))
        y = torch.zeros_like(stream)
        for l in range(value.shape[1]):
            y[:, l:] += value[:, l:l + 1] * stream[:, :stream.shape[1] - l]
        y = y.reshape(B, S, N + cp)
        pad = torch.zeros((B, N), dtype=torch.complex64, device=dev)
        pad[:, :value.shape[1]] = value
        resp = torch.fft.fft(pad, dim=-1)
    else:
        y = x
        resp = torch.ones((B, 1), dtype=torch.complex64, device=dev)
    y = y[..., cp:]
    nv = noise_var(bps, channel["ebno_db"])
    w0, w1, _, _ = philox.words(seed, philox.ROLE_NOISE, ch_ids, torch.arange(S, device=dev),
                                torch.arange(cp, cp + N, device=dev))
    n_re, n_im = philox.gauss_pair(w0, w1)
    sigma = math.sqrt(nv / N / 2.0)
    y = _round(y + torch.complex(sigma * n_re, sigma * n_im), precision)
    return _round(torch.fft.fft(y, dim=-1), precision), resp


def equalise(Y: torch.Tensor, resp: torch.Tensor, precision: str):
    """One-tap equaliser: z = Y·conj(H)/|H|² and |H|² (B, 1, 1 | N)."""
    h = resp[:, None, :]
    h2 = (h.real * h.real + h.imag * h.imag).clamp_min(1e-12)
    return _round(Y * h.conj() / h2, precision), h2


def _hard_axis(u: torch.Tensor, bps: int) -> torch.Tensor:
    """Normalised axis value → Gray index of the nearest level."""
    m = bps // 2
    L = 1 << m
    scale = math.sqrt(2.0 * (L * L - 1) / 3.0)
    i = torch.clamp(torch.floor((u * scale + L) / 2.0), 0, L - 1).to(torch.int64)
    return i ^ (i >> 1)


def _popcount(v: torch.Tensor) -> torch.Tensor:
    c = torch.zeros_like(v)
    while bool((v != 0).any()):
        c += v & 1
        v = v >> 1
    return c


def uncoded_errors(cfg: dict, channel: dict, seed: int, ch_ids: torch.Tensor,
                   precision: str = "float32") -> torch.Tensor:
    """Per-channel bit errors (B,) int64 of one uncoded link call."""
    bps = cfg["bits_per_symbol"]
    idx = payload(seed, ch_ids, cfg["n_symbols"], cfg["n_fft"], bps)
    Y, resp = received(cfg, channel, seed, ch_ids, idx, precision)
    z, _ = equalise(Y, resp, precision)
    gi, gq = gray_axes(idx, bps)
    wrong = (_popcount(_hard_axis(z.real, bps) ^ gi) + _popcount(_hard_axis(z.imag, bps) ^ gq))
    return wrong.sum(dim=(1, 2))


def llr_plane(cfg: dict, channel: dict, seed: int, ch_ids: torch.Tensor, idx: torch.Tensor,
              precision: str = "float32") -> torch.Tensor:
    """Max-log LLRs (B, S·N·bps) float32, positive for bit 0: per
    subcarrier the I-axis bits then the Q-axis bits, MSB first, each
    (min over levels with the bit 1 − min over levels with it 0) of the
    squared distance, times |H|²/nv."""
    bps = cfg["bits_per_symbol"]
    m = bps // 2
    Y, resp = received(cfg, channel, seed, ch_ids, idx, precision)
    z, h2 = equalise(Y, resp, precision)
    scale = h2 / max(noise_var(bps, channel["ebno_db"]), 1e-12)
    lev = torch.as_tensor(levels(bps), dtype=torch.float32, device=Y.device)
    gray = torch.arange(1 << m, device=Y.device)
    gray = gray ^ (gray >> 1)  # Gray index of each binary level index
    out = []
    for axis in (z.real, z.imag):
        d2 = (axis[..., None] - lev) ** 2  # (B, S, N, L)
        for j in range(m):
            has = ((gray >> (m - 1 - j)) & 1).bool()
            d1 = d2[..., has].amin(dim=-1)
            d0 = d2[..., ~has].amin(dim=-1)
            out.append((d1 - d0) * scale)
    llr = torch.stack(out, dim=-1)  # (B, S, N, bps)
    return _round(llr, precision).reshape(ch_ids.shape[0], -1)


def pass_seed(seed: int, i: int) -> int:
    """The Monte-Carlo engine's pass seed: seed + i·0x1E3779B9, wrapped to int32."""
    v = (int(seed) + i * (0x9E3779B9 & 0x7FFFFFFF)) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def mc_errors(cfg: dict, channel: dict, seed: int, passes: int, ch_ids: torch.Tensor,
              precision: str = "float32") -> torch.Tensor:
    """Per-channel bit errors summed over the passes of one Monte-Carlo call."""
    return sum(uncoded_errors(cfg, channel, pass_seed(seed, i), ch_ids, precision)
               for i in range(passes))
