"""Keyed randomness: Philox-4x32-10 as a pure function of its inputs.

Every random draw of the port is a pure function of
(seed, role, global channel id, position). The draw for a channel
therefore does not depend on which batch, slice or device computes it:
channels [0, 4096) run alone give bit-identical payloads, noise and
fading to the same channels inside a full run (the determinism contract
of ``sdr_tpu.link.fast``, which the JAX package kept with ``fold_in``
keys and per-channel-id kernel seeds).

A ``torch.Generator`` is stateful: what it returns depends on how many
numbers were drawn before, so it cannot give per-channel-id
determinism, and no generator is used on the link path.

Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11) maps a 128-bit counter and a 64-bit key to 128 random
bits. It is implemented twice, with the same bits:

- here, in plain torch integer ops (int64 holding uint32 values, every
  product split so that nothing overflows), which the CPU path, the
  tests and every kernel's plain version use;
- in ``sdr_tpu_torch/csrc/philox.cuh`` for the CUDA kernels.

Keying: ``key = seed ^ role`` as a 64-bit word (low half k0, high half
k1); counter = (global channel id, symbol, position, lane). The stream
is not the JAX package's threefry stream, nor its TPU kernels' on-core
stream; each engine is validated against BER theory, and the port's
kernels against the plain versions here, bit for bit.

The payload (``ROLE_PAYLOAD``, lane 0) takes all four words of a call:
symbol index n of (channel, symbol s) is word n mod 4 of counter
(channel, s, n div 4, 0) (``kernels/payload.py``). It took word 0 of
counter (channel, s, n, 0) before, one call per index; payloads, and so
the BER figures of the fast, MC and coded engines, drawn before and
after that change are different draws of the same distribution. The
coded engine's info bits stay on lane 1 (``info_bits``), so their
counters never meet the payload's.
"""

from __future__ import annotations

import torch

# Role constants — the JAX package's values (sdr_tpu/core/prng.py);
# stable across versions, never renumber.
ROLE_PAYLOAD = 0x0B175  # source symbols
ROLE_NOISE = 0x4015E  # AWGN draws
ROLE_FADING = 0xFAD1E  # channel gain draws
ROLE_MISC = 0x3E71A
ROLE_PHASE = 0x9A5E0  # RX-LO Wiener phase-noise walk

MASK32 = 0xFFFFFFFF
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
TWO_PI_F32 = 6.2831855  # float32(2π), the Box–Muller angle scale


def split_key(seed: int, role: int) -> tuple[int, int]:
    """(k0, k1): the 64-bit word ``seed ^ role`` as two uint32 halves."""
    s = (int(seed) ^ int(role)) & 0xFFFFFFFFFFFFFFFF
    return s & MASK32, s >> 32


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m·x for uint32 m and x (int64 tensor),
    without forming the 64-bit product: x is split into 16-bit halves."""
    xl = x & 0xFFFF
    xh = x >> 16
    a = m * xl  # < 2^48
    b = m * xh  # < 2^48
    t = a + ((b & 0xFFFF) << 16)  # < 2^49
    return (b >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox-4x32 on broadcastable int64 counter words holding uint32
    values. Returns the four output words as int64 tensors in
    [0, 2^32)."""
    words = (c0, c1, c2, c3)
    dev = next((c.device for c in words if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) for c in words)
    )
    for r in range(rounds):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = (
            hi1 ^ c1 ^ ((k0 + r * _W0) & MASK32),
            lo1,
            hi0 ^ c3 ^ ((k1 + r * _W1) & MASK32),
            lo0,
        )
    return c0, c1, c2, c3


def keyed_words(seed: int, role: int, ch_ids: torch.Tensor, shape, lane: int = 0,
                i0: int = 0):
    """The four Philox words for every (channel, i, j) of a per-channel
    (n_i, n_j) grid: counter = (ch_ids[b], i0 + i, j, lane). Each
    returned word has shape (B, n_i, n_j); ``i0`` starts the grid at row
    i0 of a longer one (a time block's first symbol)."""
    n_i, n_j = shape
    dev = ch_ids.device
    c0 = ch_ids.to(torch.int64).reshape(-1, 1, 1) & MASK32
    c1 = torch.arange(i0, i0 + n_i, dtype=torch.int64, device=dev).reshape(1, -1, 1)
    c2 = torch.arange(n_j, dtype=torch.int64, device=dev).reshape(1, 1, -1)
    k0, k1 = split_key(seed, role)
    return philox4x32(c0, c1, c2, lane, k0, k1)


def uniform_01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words → float32 uniform in (0, 1]: 24 bits, offset half an
    ulp so that log() never sees 0 (the JAX package's TPU recipe,
    sdr_tpu/kernels/mc_pallas.py::_uniform_01)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)


def box_muller(b1: torch.Tensor, b2: torch.Tensor):
    """Two uint32 word planes → two independent N(0, 1) float32 planes."""
    u1 = uniform_01(b1)
    u2 = uniform_01(b2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = TWO_PI_F32 * u2
    return r * torch.cos(t), r * torch.sin(t)


def normal_pair(seed: int, role: int, ch_ids: torch.Tensor, shape, lane: int = 0,
                i0: int = 0):
    """Two independent N(0, 1) planes (B, n_i, n_j) from words 0 and 1
    of the keyed Philox stream (rows from ``i0``) — the draw the fused TX
    kernel makes for the re/im noise of each sample."""
    w0, w1, _, _ = keyed_words(seed, role, ch_ids, shape, lane, i0)
    return box_muller(w0, w1)


def uniform_plane(seed: int, role: int, ch_ids: torch.Tensor, shape, lane: int = 0):
    """U(0, 1) plane (B, n_i, n_j) from word 0 of the keyed stream."""
    w0, _, _, _ = keyed_words(seed, role, ch_ids, shape, lane)
    return uniform_01(w0)


INFO_LANE = 1  # ROLE_PAYLOAD lane of the coded engine's info bits (symbol indices: lane 0)


def info_bits(seed: int, ch_ids: torch.Tensor, n_cw: int, k: int) -> torch.Tensor:
    """Bernoulli(0.5) information bits (B, n_cw, k) int8 on ``ch_ids``'
    device: bit t of word w of Philox(seed ^ ROLE_PAYLOAD, (ch_ids[b], cw,
    i, INFO_LANE)) is bit i·128 + w·32 + t of codeword cw — one 128-bit
    draw per 128 bits, a pure function of (seed, global channel id,
    codeword, bit). Plain torch on every device (the JAX engine's draw is
    XLA ``bernoulli`` outside any kernel)."""
    n_blk = -(-k // 128)
    words = keyed_words(seed, ROLE_PAYLOAD, ch_ids, (n_cw, n_blk), INFO_LANE)
    w = torch.stack(words, dim=-1)
    w = (w - ((w >> 31) << 32)).to(torch.int32)  # the same 32 bits, in int32's range
    shifts = torch.arange(32, dtype=torch.int32, device=ch_ids.device)
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(ch_ids.shape[0], n_cw, n_blk * 128)[:, :, :k].to(torch.int8)


__all__ = [
    "ROLE_PAYLOAD", "ROLE_NOISE", "ROLE_FADING", "ROLE_MISC", "ROLE_PHASE",
    "split_key", "philox4x32", "keyed_words", "uniform_01", "box_muller",
    "normal_pair", "uniform_plane", "TWO_PI_F32", "INFO_LANE", "info_bits",
]
