"""Kernel A: the keyed payload draw (port of
``sdr_tpu/kernels/channel_pallas.py::payload_idx_pallas``).

``payload_idx`` returns (B, S, N) uniform symbol indices,

    idx[b, s, n] = word (n mod 4) of Philox4x32-10(seed ^ ROLE_PAYLOAD,
                   (ch_ids[b], s0 + s, n div 4, 0)) & (2^bps − 1),

words in the order (x, y, z, w), the last call's extra words dropped
when N is not a multiple of 4; int8 for bps ≤ 7 and int16 otherwise (the
JAX rule). One Philox call gives four indices. Each index is a pure
function of (seed, role, global channel id, s, n), so any slice of
channels reproduces the full run bit for bit, and ``s0`` — the first
symbol of a time block — gives rows s0 … s0+S−1 of the whole frame's
draw (``link.stream``).

The layout changed from one call per index (word x of counter
(ch_ids[b], s, n, 0)) to four indices per call: payloads, and so the
BER figures of every engine, drawn before and after that change are
different draws of the same distribution.

On a CPU tensor the plain version (``payload_idx_plain``) runs; on a
CUDA tensor the CUDA kernel (``csrc/payload.cu``) runs, or the call
raises.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.kernels import _lib


def out_dtype(bps: int) -> torch.dtype:
    """int8 holds bps ≤ 7 (values < 128); int16 the rest."""
    return torch.int8 if bps <= 7 else torch.int16


def supported(N: int, bps: int) -> bool:
    """What the CUDA kernel takes: N a power of two, 1 ≤ bps ≤ 10."""
    return N >= 1 and (N & (N - 1)) == 0 and 1 <= bps <= 10


def payload_idx_plain(S: int, N: int, bps: int, seed: int, ch_ids: torch.Tensor,
                      s0: int = 0) -> torch.Tensor:
    """Plain torch version: the same bits as the kernel, all four words of
    each keyed Philox call over (S, ceil(N/4)) quads from symbol s0."""
    words = prng.keyed_words(seed, prng.ROLE_PAYLOAD, ch_ids, (S, -(-N // 4)), i0=s0)
    w = torch.stack(words, dim=-1).reshape(ch_ids.shape[0], S, -1)[..., :N]
    return (w & ((1 << bps) - 1)).to(out_dtype(bps))


def payload_idx(S: int, N: int, bps: int, seed: int, ch_ids: torch.Tensor,
                s0: int = 0) -> torch.Tensor:
    """(B, S, N) symbol indices of symbols s0 … s0+S−1 for the global
    channel ids ``ch_ids`` (B,) int32, on ``ch_ids``' device."""
    if ch_ids.ndim != 1:
        raise ValueError(f"ch_ids must be 1-D, got {tuple(ch_ids.shape)}")
    if s0 < 0:
        raise ValueError(f"payload: s0 must be >= 0, got {s0}")
    if ch_ids.device.type == "cpu":
        return payload_idx_plain(S, N, bps, seed, ch_ids, s0)
    B = ch_ids.shape[0]
    if not supported(N, bps) or s0 + S > 2**31 - 1:
        raise ValueError(f"payload kernel: unsupported shape ({B},{S},{N}) bps={bps} s0={s0}")
    if ch_ids.dtype != torch.int32:
        raise ValueError(f"payload kernel: ch_ids must be int32, got {ch_ids.dtype}")
    _lib.require_cuda("payload", ch_ids)
    dt = out_dtype(bps)
    out = torch.empty((B, S, N), dtype=dt, device=ch_ids.device)
    k0, k1 = prng.split_key(seed, prng.ROLE_PAYLOAD)
    rc = _lib.lib().sdr_payload(
        out.data_ptr(), out.element_size(), ch_ids.data_ptr(), B, S,
        _lib.log2_exact(N), bps, s0, k0, k1, _lib.stream(),
    )
    _lib.check(rc, "payload")
    _lib.LAUNCHES["payload"] += 1
    return out
