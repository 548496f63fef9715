"""Coded fast engine: the batched LDPC link on the fast engine's kernels.

Port of ``sdr_tpu/link/fast_coded.py``. The whole batch runs

    info bits (keyed Philox) → QC-LDPC encode → zero-pad and interleave
    the frame → Gray map indices (MSB first) → TX + channel (kernel B, or
    the staged route with kernel E) → LLR demod → deinterleave → min-sum
    decode (kernel H) → per-channel info-bit errors

with the demod→decoder seam in one of two forms, which decode the same
bits but for LLRs near zero:

- ``seam="staged"``: the public-order LLR plane (B, S, N·bps) of kernel
  C's LLR mode → the deinterleave gather → the rows-major decoder.
- ``seam="fused"``: the channels-last plane of kernel F's LLR mode in its
  kernel order (S·bps·N, B) → ONE row gather with the composed
  permutation ``_fused_rowperm`` (deinterleave ∘ the kernel's bit-major,
  natural-bin row order; computed once on the host, so the public order
  never exists on the card) → the transposed decoder (codewords already
  on the minor axis). Per-link channel planes only, as in JAX.

``seam="auto"`` is a fixed alias of "staged", on every device and for
every shape: it chooses nothing. The JAX rule took the fused seam on a
TPU wherever the channels-last kernel fit; on the H100 the staged seam
measured faster at every schedule (``chip_smoke.py`` phase 3g; root
PERF.md §6): the fused seam's channels-last relayout and the transposed
decoder's strided column reads cost more than the public-order gather
they replace. ``seam="fused"`` stays an explicit choice, as
``layout="cl"`` does in ``link.fast``; it is the only caller of kernel
F's LLR mode on the engine's path.

Randomness: the info bits are Philox on ``ROLE_PAYLOAD`` (``core.prng.
info_bits``), the channel the fast engine's keyed draws; everything is a
pure function of (seed, global channel id), so any slice of channels
reproduces the full run. It is a different stream from the JAX
package's threefry ``bernoulli``; the parity tests inject the info bits
and the noise.

Pilots, MIMO and SC-FDMA raise ``NotImplementedError``, as in JAX:
coded links with those run in ``link.coded`` through ``link.pipeline``.
The entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.core.config import LinkConfig
from sdr_tpu_torch.kernels.payload import out_dtype
from sdr_tpu_torch.link import fast
from sdr_tpu_torch.link.coded import ldpc_code_for, ldpc_codewords_per_channel
from sdr_tpu_torch.ops.demod import demod_chain, demod_llr_chain_cl
from sdr_tpu_torch.ops.interleave import SEED as IL_SEED
from sdr_tpu_torch.ops.interleave import _perm as _il_perm
from sdr_tpu_torch.ops.interleave import _perm_tensor
from sdr_tpu_torch.ops.interleave import interleave
from sdr_tpu_torch.ops.ldpc import ldpc_decode, ldpc_decode_t, ldpc_encode

SEAMS = ("auto", "staged", "fused")


def check_supported(cfg: LinkConfig, seam: str = "auto", schedule: str = "flooding") -> None:
    """Raise for what the engine does not run: pilots, MIMO and SC-FDMA
    (``NotImplementedError``, as the JAX engine), a per-symbol channel
    plane on the fused seam, unknown seams and schedules."""
    if cfg.pilot_spacing or cfg.mimo is not None or cfg.dft_spread:
        raise NotImplementedError(
            "the coded fast engine runs full-grid SISO OFDM; pilots/MIMO/SC-FDMA coded links "
            "run in link.coded"
        )
    if seam not in SEAMS:
        raise ValueError(f"seam must be one of {SEAMS}, got {seam!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if seam == "fused" and cfg.channel.model in fast._PER_SYMBOL:
        raise NotImplementedError("fused seam takes a per-link channel plane")


def _frame_to_idx(frame_bits: torch.Tensor, bps: int) -> torch.Tensor:
    """(B, S·N·bps) int8 coded bits → (B, S·N) symbol indices, MSB first
    per symbol (the convention the TX kernel decodes); int8 for bps ≤ 7,
    int16 above."""
    B, total = frame_bits.shape
    b = frame_bits.reshape(B, total // bps, bps).to(torch.int16)
    idx = b[..., 0]
    for j in range(1, bps):
        idx = (idx << 1) | b[..., j]
    return idx.to(out_dtype(bps))


@functools.lru_cache(maxsize=None)
def _fused_rowperm(n_fft: int, n_syms: int, bps: int, sent: int, seed: int) -> np.ndarray:
    """Composed gather: kernel-order LLR plane row → deinterleaved
    coded-bit position, as ONE static permutation.

    Kernel F's row (s, j, k) = s·bps·N + j·N + k holds the LLR of public
    position p = s·(N·bps) + k·bps + j (natural bin order — the port's
    kernel emits no DIF permutation); deinterleave(x) = x[inv], so coded
    position t reads public position inv[t]. Returns the row for each of
    the first ``sent`` coded positions (int64 numpy)."""
    frame = n_syms * n_fft * bps
    _p, inv = _il_perm(frame, seed)
    rows = np.arange(frame)
    s = rows // (bps * n_fft)
    j = (rows // n_fft) % bps
    k = rows % n_fft
    pub = s * (n_fft * bps) + k * bps + j
    by_pub = np.empty(frame, np.int64)
    by_pub[pub] = rows
    return by_pub[inv[:sent]]


@functools.lru_cache(maxsize=None)
def _rowperm_tensor(n_fft: int, n_syms: int, bps: int, sent: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_fused_rowperm(n_fft, n_syms, bps, sent, IL_SEED), device=device)


def ldpc_fast_core(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, rate: str = "1/2",
                   iters: int = 25, schedule: str = "flooding", seam: str = "auto",
                   info: torch.Tensor | None = None, noise=None, h: torch.Tensor | None = None):
    """The coded link over explicit GLOBAL channel ids (B,) int32 on the
    target device. Returns per-channel (info_bit_errors,
    info_bits_counted), both (B,) int32.

    ``info`` (B, n_cw, k) int8 injects the information bits, ``noise``
    (n_re, n_im) N(0, 1) planes (B, S, N+cp) the noise, and ``h`` the
    channel (``fast.fade_state``'s h: (B, 1, 1) flat gains, for
    instance) in place of the keyed draws — the injection form of the
    parity tests."""
    check_supported(cfg, seam, schedule)
    dev = ch_ids.device
    B = ch_ids.shape[0]
    S, N, cp = cfg.n_symbols, cfg.ofdm.n_fft, cfg.ofdm.cp_len
    mod = cfg.modulation
    bps = mod.bits_per_symbol
    code = ldpc_code_for(rate)
    n_cw = ldpc_codewords_per_channel(cfg, code)
    frame_bits = S * N * bps
    sent = n_cw * code.n
    nv = max(fast.noise_var(cfg), 1e-12)
    if seam == "auto":
        seam = "staged"  # a fixed alias: the faster seam on the H100 (module docstring)

    # --- TX side -----------------------------------------------------------
    if info is None:
        info = prng.info_bits(seed, ch_ids, n_cw, code.k)
    frame = torch.zeros((B, frame_bits), dtype=torch.int8, device=dev)
    frame[:, :sent] = ldpc_encode(code, info).reshape(B, sent)
    idx = _frame_to_idx(interleave(frame, IL_SEED), bps).reshape(B, S, N)
    del frame
    taps = None
    if h is None:
        h, taps = fast.fade_state(cfg, seed, ch_ids, plane=False)
    re, im = fast.tx_with_channel(cfg, seed, ch_ids, idx, h=h, taps=taps, noise=noise,
                                  layout="cl" if seam == "fused" else "rows")
    del idx
    if h is None and taps is not None:
        h = fast.rx_plane(taps, N)

    # --- RX side -----------------------------------------------------------
    if seam == "fused":
        if h is None:
            hr_t = torch.ones((N, B), dtype=torch.float32, device=dev)
            hi_t = torch.zeros((N, B), dtype=torch.float32, device=dev)
        else:
            hr_t, hi_t = fast._planar(h[:, 0, :].to(torch.complex64).expand(B, N).T)
        plane = demod_llr_chain_cl(re, im, hr_t, hi_t, cp, mod, nv, kernel_order=True)
        del re, im
        llr_t = plane[_rowperm_tensor(N, S, bps, sent, str(dev))]  # (sent, B)
        del plane
        llr_cw_t = llr_t.reshape(n_cw, code.n, B).permute(1, 0, 2).reshape(code.n, n_cw * B)
        hard_t = ldpc_decode_t(code, llr_cw_t.contiguous(), iters, schedule=schedule)
        decoded = hard_t.reshape(code.n, n_cw, B).permute(2, 1, 0)  # (B, n_cw, n)
    else:
        if h is None:
            hr = torch.ones((B, 1, N), dtype=torch.float32, device=dev)
            hi = torch.zeros((B, 1, N), dtype=torch.float32, device=dev)
        else:
            hr, hi = fast._planar(h.to(torch.complex64).expand(B, h.shape[1], N))
        llr = demod_chain(re, im, hr, hi, cp, mod, nv).reshape(B, frame_bits)
        del re, im
        # deinterleave(llr)[:, :sent] as one gather of the sent positions.
        inv = _perm_tensor(frame_bits, IL_SEED, True, str(dev))[:sent]
        llr_cw = llr[:, inv].reshape(B * n_cw, code.n)
        del llr
        decoded = ldpc_decode(code, llr_cw, iters, schedule=schedule).reshape(B, n_cw, code.n)
    errors = (decoded[:, :, :code.k] != info).sum(dim=(1, 2), dtype=torch.int32)
    counted = torch.full((B,), n_cw * code.k, dtype=torch.int32, device=dev)
    return errors, counted


def ldpc_fast_simulate(cfg: LinkConfig, seed: int, rate: str = "1/2", iters: int = 25,
                       schedule: str = "flooding", seam: str = "auto", device="cuda"):
    """Batched LDPC-coded link over cfg.n_channels on ``device`` (the
    card unless the caller asks for the CPU); returns per-channel
    (info_bit_errors, info_bits_counted), both (n_channels,) int32.
    ``seam`` is "staged", "fused" or "auto" (the same as "staged")."""
    check_supported(cfg, seam, schedule)
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    return ldpc_fast_core(cfg, seed, ch_ids, rate=rate, iters=iters, schedule=schedule,
                          seam=seam)


def make_ldpc_fast_fn(cfg: LinkConfig, rate: str = "1/2", iters: int = 25,
                      schedule: str = "flooding", seam: str = "auto", device="cuda"):
    """ldpc_fast_simulate with cfg and the options bound: fn(seed)."""
    check_supported(cfg, seam, schedule)
    return functools.partial(ldpc_fast_simulate, cfg, rate=rate, iters=iters, schedule=schedule,
                             seam=seam, device=device)
