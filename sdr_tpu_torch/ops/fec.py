"""Convolutional FEC: encoder, 802.11a puncturing and the soft-input
max-log Viterbi decoder (port of ``sdr_tpu/ops/fec.py``).

Default code: the K = 7, rate-1/2 (171, 133)_octal code of 802.11a,
punctured to 2/3 and 3/4 by the 802.11a patterns.

Register convention (shared by the encoder and the decoder's tables):

    r_t = (b_t << (K-1)) | s_{t-1}      (s = previous K-1 bits)
    out_j = popcount(r_t & poly_j) & 1
    s_t = r_t >> 1                       (MSB of s_t is b_t)

- ``conv_encode``: the code is linear and time-invariant, so output j at
  step t is the XOR of the zero-tailed input at the lags m whose bit
  (K-1-m) poly_j sets — K shifted XORs over the whole sequence, no loop
  over steps; the same bits as the JAX scan.
- ``viterbi_decode``: the JAX decoder's arithmetic in the same order —
  branch metric Σ_r (L_r/2)·(1 − 2c_r) per (state, predecessor slot),
  ``cand = pm[prev_state] + bm``, ``take1 = cand1 > cand0`` (strict),
  ``npm = where(take1, cand1, cand0)``, start 0 at state 0 and −1e30
  elsewhere, traceback from state 0 — so its decisions are the JAX
  decoder's bit for bit. The whole batch runs in one forward pass on a
  (codewords, 2^(K-1)) float32 front; the branch metrics of a run of
  steps are one op before that run's loop; the decisions are packed one
  bit a state (int64 words) per run. Plain torch on every device (the JAX
  decoder is XLA outside any kernel); its serial step count, T = n_info +
  K − 1 forward steps and T traceback steps of a few launches each, is
  what its time on the card is made of.

LLR convention: positive ⇒ bit 0 (``ops.llr``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_POLYS = (0o171, 0o133)
DEFAULT_K = 7

# 802.11a puncturing patterns: per encoder step, which of the (A, B) =
# (171, 133) outputs survive, cycling over the period.
PUNCTURE_PATTERNS = {
    "1/2": ((1, 1),),
    "2/3": ((1, 1), (1, 0)),
    "3/4": ((1, 1), (1, 0), (0, 1)),
}

NEG = -1e30  # the start metric of every state but 0

# Branch-metric temporaries of one run of steps: (steps, codewords, 2S)
# float32 stays near this many bytes.
_RUN_BYTES = 1 << 28


def coded_len(n_info: int, polys=DEFAULT_POLYS, K: int = DEFAULT_K) -> int:
    """Coded bits for n_info information bits with zero-tail termination."""
    return (n_info + K - 1) * len(polys)


@functools.lru_cache(maxsize=None)
def _puncture_indices(n_steps: int, rate: str, R: int = 2):
    """Static kept-bit indices into the (n_steps·R,) coded stream."""
    pattern = PUNCTURE_PATTERNS[rate]
    mask = np.array(
        [pattern[t % len(pattern)][j] for t in range(n_steps) for j in range(R)],
        bool,
    )
    return np.where(mask)[0].astype(np.int32)


def punctured_len(n_info: int, rate: str, polys=DEFAULT_POLYS, K: int = DEFAULT_K) -> int:
    """Transmitted bits after puncturing a terminated codeword."""
    steps = n_info + K - 1
    return len(_puncture_indices(steps, rate, len(polys)))


@functools.lru_cache(maxsize=None)
def _index_tensor(n_steps: int, rate: str, R: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_puncture_indices(n_steps, rate, R), dtype=torch.int64,
                           device=device)


def puncture(coded: torch.Tensor, rate: str, R: int = 2) -> torch.Tensor:
    """Drop the pattern's zero positions: (..., T·R) → (..., kept)."""
    return coded[..., _index_tensor(coded.shape[-1] // R, rate, R, str(coded.device))]


def depuncture(llrs: torch.Tensor, rate: str, n_steps: int, R: int = 2) -> torch.Tensor:
    """Re-expand received LLRs to the full (..., n_steps·R) lattice;
    punctured positions get LLR 0 ("no information", the neutral metric
    of max-log Viterbi)."""
    idx = _index_tensor(n_steps, rate, R, str(llrs.device))
    full = torch.zeros(llrs.shape[:-1] + (n_steps * R,), dtype=llrs.dtype, device=llrs.device)
    full[..., idx] = llrs
    return full


@functools.lru_cache(maxsize=None)
def _tables(polys: tuple, K: int):
    """Static trellis tables over S = 2^(K-1) states.

    Returns (prev_state (S,2), prev_bit (S,2), prev_out (S,2,R),
    enc_out (S,2,R), next_state (S,2)): for each state, its two
    predecessors (decoder view) and its two successors (encoder view).
    The slot order (predecessors in ascending state order) fixes which
    candidate a tie keeps.
    """
    S = 1 << (K - 1)
    R = len(polys)
    next_state = np.zeros((S, 2), np.int32)
    enc_out = np.zeros((S, 2, R), np.int32)
    for s in range(S):
        for b in (0, 1):
            r = (b << (K - 1)) | s
            next_state[s, b] = r >> 1
            for j, p in enumerate(polys):
                enc_out[s, b, j] = bin(r & p).count("1") & 1
    prev_state = np.zeros((S, 2), np.int32)
    prev_bit = np.zeros((S, 2), np.int32)
    prev_out = np.zeros((S, 2, R), np.int32)
    fill = np.zeros(S, np.int32)
    for s in range(S):
        for b in (0, 1):
            ns = next_state[s, b]
            k = fill[ns]
            prev_state[ns, k] = s
            prev_bit[ns, k] = b
            prev_out[ns, k] = enc_out[s, b]
            fill[ns] += 1
    assert (fill == 2).all()
    return prev_state, prev_bit, prev_out, enc_out, next_state


def conv_encode(bits: torch.Tensor, polys=DEFAULT_POLYS, K: int = DEFAULT_K) -> torch.Tensor:
    """Zero-tail-terminated rate-1/R encode.

    bits: (..., n_info) in {0,1}. Returns (..., (n_info+K-1)·R) int8,
    per-step outputs [c_0 .. c_{R-1}] in polynomial order.
    """
    n_info = bits.shape[-1]
    T = n_info + K - 1
    lead = bits.shape[:-1]
    # x[t + K-1 - m] = b_{t-m}: K-1 zeros ahead (the register's start), K-1
    # behind (the tail).
    x = torch.zeros(lead + (T + K - 1,), dtype=torch.int8, device=bits.device)
    x[..., K - 1:K - 1 + n_info] = bits.to(torch.int8)
    outs = []
    for p in polys:
        acc = torch.zeros(lead + (T,), dtype=torch.int8, device=bits.device)
        for m in range(K):
            if (p >> (K - 1 - m)) & 1:
                acc ^= x[..., K - 1 - m:K - 1 - m + T]
        outs.append(acc)
    return torch.stack(outs, dim=-1).reshape(lead + (T * len(polys),))


@functools.lru_cache(maxsize=None)
def _trellis(polys: tuple, K: int, device: str):
    """The decoder's device tables: the branch signs per coded bit r over
    the flattened (next state, slot) axis, (R, 2S) float32 ±1; and the
    bit weights that pack a step's S decisions into int64 words."""
    prev_state, prev_bit, prev_out, _, _ = _tables(polys, K)
    S = 1 << (K - 1)
    # The register convention's predecessors: state ns is reached from
    # 2·(ns mod S/2) + slot with input bit ns >> (K-2). The forward pass
    # reads pm through that structure (a broadcast, not a gather), the
    # traceback through its arithmetic.
    ns = np.arange(S)[:, None]
    assert (prev_state == 2 * (ns % (S // 2)) + np.arange(2)[None, :]).all()
    assert (prev_bit == (ns >> (K - 2))).all()
    sign = torch.as_tensor(1.0 - 2.0 * prev_out.reshape(2 * S, -1).T, dtype=torch.float32,
                           device=device)
    weights = torch.as_tensor(np.left_shift(np.int64(1), np.arange(64, dtype=np.int64)),
                              device=device)
    return sign, weights


def viterbi_decode(llrs: torch.Tensor, n_info: int, polys=DEFAULT_POLYS,
                   K: int = DEFAULT_K) -> torch.Tensor:
    """Soft-input max-log Viterbi decode of zero-tail-terminated LLRs.

    llrs: (..., (n_info+K-1)·R) float32 with the framework's sign
    convention (positive ⇒ bit 0 more likely). Returns the decoded
    information bits (..., n_info) int8.
    """
    polys = tuple(polys)
    R = len(polys)
    S = 1 << (K - 1)
    T = n_info + K - 1
    if llrs.shape[-1] != T * R:
        raise ValueError(f"llr length {llrs.shape[-1]} != (n_info + K - 1)·R = {T * R}")
    if K < 2:
        raise ValueError(f"constraint length must be >= 2, got {K}")
    dev = llrs.device
    batch_shape = llrs.shape[:-1]
    half = (0.5 * llrs.reshape(-1, T, R).to(torch.float32)).transpose(0, 1)  # (T, Bn, R)
    Bn = half.shape[1]
    sign, weights = _trellis(polys, K, str(dev))
    n_words = -(-S // 64)
    run = max(1, min(T, _RUN_BYTES // max(1, Bn * 2 * S * 4)))

    pm = torch.full((Bn, S), NEG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    # pm viewed as (Bn, 1, S/2, 2): predecessor slot k of state h·S/2 + j
    # is pm[2j + k] for either half h.
    pm_prev = pm.view(Bn, 1, S // 2, 2)
    pm_next = pm.view(Bn, 2, S // 2)  # state h·S/2 + j at [h, j]
    packed = torch.empty((T, Bn, n_words), dtype=torch.int64, device=dev)
    dec = torch.empty((run, Bn, 2, S // 2), dtype=torch.bool, device=dev)
    for t0 in range(0, T, run):
        n = min(run, T - t0)
        # Branch metrics of the run, (n, Bn, 2S) over (state, slot): the
        # JAX einsum's terms in r order (exact products by ±1, one rounding
        # an added term).
        h = half[t0:t0 + n]
        bm = h[..., 0:1] * sign[0]
        for r in range(1, R):
            bm = bm + h[..., r:r + 1] * sign[r]
        bm = bm.view(n, Bn, 2, S // 2, 2)
        for j in range(n):
            cand = pm_prev + bm[j]  # (Bn, 2, S/2, 2)
            c0, c1 = cand[..., 0], cand[..., 1]
            torch.gt(c1, c0, out=dec[j])
            torch.where(dec[j], c1, c0, out=pm_next)
        d = dec[:n].reshape(n, Bn, S)
        if S < 64 * n_words:
            d = torch.nn.functional.pad(d, (0, 64 * n_words - S))
        packed[t0:t0 + n] = (d.view(n, Bn, n_words, 64).to(torch.int64)
                             * weights).sum(dim=-1)
    del dec, half
    state = torch.zeros(Bn, dtype=torch.int64, device=dev)
    path = torch.empty((T, Bn), dtype=torch.uint8 if S <= 256 else torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        path[t] = state
        word = packed[t, :, 0] if n_words == 1 else packed[t].gather(
            1, (state >> 6).unsqueeze(1)).squeeze(1)
        slot = (word >> (state & 63)) & 1
        state = ((state << 1) & (S - 1)) | slot
    bits = (path[:n_info] >> (K - 2)).to(torch.int8).T
    return bits.reshape(batch_shape + (n_info,))
