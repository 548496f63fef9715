"""The yardstick's arithmetic: the H100's published peaks and the work of
each stage of the link, counted from its shapes.

A bound is the least time the card could take: the larger of the bytes
(each input read once, each output written once) over the memory rate,
the f32 operations over the f32 peak and the 32-bit integer multiplies
over the integer-multiply rate. A keyed draw costs 40 multiplies a
Philox-4x32-10 call. Transcendentals are not counted, so every bound is
a lower bound, and a share of it cannot pass 1.
"""

from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM data sheet, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# 32-bit integer multiplies: 64 per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), 132
# SMs at the 1.98 GHz boost clock.
IMUL_PER_S = 132 * 64 * 1.98e9
PHILOX_IMUL = 40  # ten rounds of two 32-bit multiply-high/low pairs


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved, f32 operations and 32-bit integer multiplies."""

    bytes: float = 0.0
    flops: float = 0.0
    imul: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops, self.imul + other.imul)

    def __mul__(self, k: float) -> "Work":
        return Work(self.bytes * k, self.flops * k, self.imul * k)


def bound_ms(w: Work) -> float:
    t_bytes = w.bytes / HBM_BYTES_PER_S
    t_ops = max(w.flops / F32_FLOPS, w.imul / IMUL_PER_S)
    return max(t_bytes, t_ops) * 1e3


def fft_flops(n: int) -> float:
    """Real operations of one radix-2 complex FFT of n points."""
    return 5.0 * n * math.log2(n)


def tail_flops(bits_per_symbol: int) -> float:
    """Per tone: the one-tap equalisation (12) and the max-log LLRs (per
    axis 3 per level and 2 per bit for the level scan, L ≤ 4; 12 per bit
    for the Gray fold above)."""
    m = max(bits_per_symbol // 2, 1)
    L = 1 << m
    axes = 1 if bits_per_symbol == 1 else 2
    return 12.0 + axes * (3 * L + 2 * m if L <= 4 else 12 * m)


def idx_bytes(bits_per_symbol: int) -> int:
    """The index plane's element: int8 to 7 bits, int16 above."""
    return 1 if bits_per_symbol <= 7 else 2


def tx(B: int, S: int, N: int, cp: int, bps: int, n_taps: int = 0, gains: bool = False,
       keyed: bool = True) -> Work:
    """Kernel B: the indices in, the two CP'd sample planes out, the
    channel's taps or gains in; the inverse FFT, per sample the FIR (8 a
    tap and 4 for the noise) or the gain (10), a Philox call a sample."""
    rows, L = B * S, N + cp
    chan_bytes = 8 * B * n_taps if n_taps else (8 * B if gains else 0)
    sample_ops = 8 * n_taps + 4 if n_taps else (10 if gains else 4)
    ids_bytes = 4 * B if keyed else 0
    return Work(bytes=rows * N * idx_bytes(bps) + 8 * rows * L + chan_bytes + ids_bytes,
                flops=rows * (fft_flops(N) + sample_ops * L),
                imul=rows * L * PHILOX_IMUL if keyed else 0.0)


def demod_count(B: int, S: int, N: int, bps: int, h_rows: int = 1) -> Work:
    """Kernel C's count: the S·N kept samples and the h plane in, the
    indices in, the counts out; a forward FFT and the tail a tone."""
    rows = B * S
    return Work(bytes=8 * rows * N + 8 * B * h_rows * N + rows * N * idx_bytes(bps) + 4 * B,
                flops=rows * (fft_flops(N) + N * tail_flops(bps)))


def demod_plane(B: int, S: int, N: int, bps: int, h_rows: int = 1) -> Work:
    """Kernel C's LLR plane: the kept samples and h in, float32 LLRs out."""
    rows = B * S
    return Work(bytes=8 * rows * N + 8 * B * h_rows * N + 4 * rows * N * bps,
                flops=rows * (fft_flops(N) + N * tail_flops(bps)))


def mc_pass(B: int, S: int, N: int, bps: int, n_taps: int = 0, fading_calls: int = 0,
            noise: bool = True) -> Work:
    """Kernel G's keyed pass: the ids in and the counts out; two FFTs, the
    channel, noise and tail a tone, 8·L a tone to build H once a channel;
    a Philox call a payload sample for the noise, a quarter for the index,
    and the fading calls a channel."""
    rows = B * S
    return Work(bytes=8 * B,
                flops=rows * (2 * fft_flops(N) + N * (10 + tail_flops(bps))) + B * 8 * n_taps * N,
                imul=rows * N * ((PHILOX_IMUL if noise else 0) + PHILOX_IMUL / 4)
                + B * fading_calls * PHILOX_IMUL)


def ldpc_decode(n_codewords: int, n: int, n_edges_lifted: int, iters: int) -> Work:
    """Kernel H: n float32 LLRs in and n bytes out a codeword; 10
    operations an edge an iteration."""
    return Work(bytes=n_codewords * n * 5, flops=n_codewords * n_edges_lifted * iters * 10.0)


def link(B: int, S: int, N: int, bps: int, n_taps: int = 0, fading_calls: int = 0,
         payload_calls: float | None = None, extra: Work = Work()) -> Work:
    """The least work one uncoded link call's counts depend on: the
    payload draw (a quarter Philox call an index, or ``payload_calls``),
    the noise on the S·N samples the receiver keeps (a call each), the
    fading draws, the two transforms, the channel on each tone (6) and
    the noise add (2), H built once a channel from its taps (8·L a tone),
    the tail; as bytes only the counts written."""
    rows = B * S
    calls = rows * N / 4 if payload_calls is None else payload_calls
    base = Work(bytes=8 * B,
                flops=rows * (2 * fft_flops(N) + N * (8 + tail_flops(bps))) + B * 8 * n_taps * N,
                imul=(calls + rows * N + B * fading_calls) * PHILOX_IMUL)
    return base + extra
