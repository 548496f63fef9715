"""MIMO processing: Alamouti STBC, receive MRC, spatial-mux detection.

Port of ``sdr_tpu/ops/mimo.py`` (ROADMAP queue 1, item 11e-i), on torch
tensors with the same axis contracts: antenna axes are leading axes of
the post-FFT grids — y (..., n_rx, S, N) in, estimates (..., n_tx, S, N)
and effective noise variances (..., n_tx, 1, N') out, N' = 1 for a flat
h (..., n_rx, n_tx, 1) and N for a per-subcarrier one — and the small
(n_rx, n_tx) matrices batch per subcarrier through ``torch.einsum``.
The 2 × 2 (and 1 × 1) Hermitian inverses are closed forms, larger ones
``torch.linalg.inv`` (the JAX ``jnp.linalg.inv``).

Power convention (as in the JAX module): the total transmitted energy
per subcarrier per symbol period is 1 whatever n_tx, the per-antenna
amplitude 1/√n_tx; the detectors fold that split into the effective
channel A = H/√n_tx themselves.

Max-log ML (``mux_detect_ml``) takes the same per-bit minima of the
candidate metric q_c − 2·Re(zᴴ s_c) as the JAX function, but never holds
the (..., N', S, C) metric: it runs over blocks of candidates that fix
the leading streams and span the last ones, keeping per stream and
constellation point the running minimum over the candidates that carry
that point, and takes each bit's two minima from those. The minima are
the JAX function's (each a minimum over the same candidate set); only
the rounding of each candidate's metric differs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.ops.modulation import _tables, constellation, nearest_symbol


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real ** 2 + x.imag ** 2


# ---- Alamouti space-time block code (G2), per subcarrier across symbol pairs ----------

def alamouti_layout(x: torch.Tensor) -> torch.Tensor:
    """The G2 antenna grids of one stream without the power split:
    (..., S, N), S even → (..., 2, S, N), antenna 0 sending [x0, −conj(x1)]
    and antenna 1 [x1, conj(x0)] for each symbol pair (x0, x1)."""
    s = x.shape[-2]
    if s % 2:
        raise ValueError(f"Alamouti needs an even symbol count, got {s}")
    n = x.shape[-1]
    xp = x.reshape(*x.shape[:-2], s // 2, 2, n)
    x0, x1 = xp[..., 0, :], xp[..., 1, :]
    ant0 = torch.stack([x0, -torch.conj(x1)], dim=-2)  # (..., P, 2, N)
    ant1 = torch.stack([x1, torch.conj(x0)], dim=-2)
    out = torch.stack([ant0, ant1], dim=-4)  # (..., 2, P, 2, N)
    return out.reshape(*x.shape[:-2], 2, s, n)


def alamouti_encode(x: torch.Tensor) -> torch.Tensor:
    """G2 STBC encode one stream onto two TX antennas: ``alamouti_layout``
    scaled by 2^-½, so the total radiated energy per subcarrier per period
    stays 1 (Alamouti 1998)."""
    return (alamouti_layout(x) * 2.0 ** -0.5).to(x.dtype)


def alamouti_combine(y: torch.Tensor, h: torch.Tensor, noise_var):
    """Alamouti maximum-ratio combiner.

    y: (..., n_rx, S, N) post-FFT observations; h: (..., n_rx, 2, N) or
    (..., n_rx, 2, 1), static over each symbol pair. Returns (s, eff_var):
    the unbiased estimates (..., S, N) and eff_var = 2·nv/g (..., 1, N'),
    g = Σ|h_rt|² floored at 1e-12."""
    s = y.shape[-2]
    n = y.shape[-1]
    yp = y.reshape(*y.shape[:-2], s // 2, 2, n)
    r0, r1 = yp[..., 0, :], yp[..., 1, :]  # (..., n_rx, P, N)
    h0 = h[..., 0, :][..., None, :]  # (..., n_rx, 1, N')
    h1 = h[..., 1, :][..., None, :]
    x0 = torch.sum(torch.conj(h0) * r0 + h1 * torch.conj(r1), dim=-3)
    x1 = torch.sum(torch.conj(h1) * r0 - h0 * torch.conj(r1), dim=-3)
    g = torch.sum(_abs2(h), dim=-3)  # (..., 2, N') summed over rx
    g = torch.sum(g, dim=-2)[..., None, :]  # (..., 1, N') summed over tx
    g = torch.clamp(g, min=1e-12)
    scale = 2.0 ** 0.5 / g
    est = torch.stack([x0 * scale, x1 * scale], dim=-2)  # (..., P, 2, N)
    est = est.reshape(*y.shape[:-3], s, n)
    eff_var = 2.0 * torch.as_tensor(noise_var, dtype=torch.float32, device=g.device) / g
    return est, torch.broadcast_to(eff_var, (*est.shape[:-2], 1, eff_var.shape[-1]))


# ---- receive MRC (1 × n_rx) ----------------------------------------------------------

def mrc_combine(y: torch.Tensor, h: torch.Tensor, noise_var):
    """Maximum-ratio combining across receive antennas (n_tx = 1).

    y: (..., n_rx, S, N); h: (..., n_rx, 1, N) or (..., n_rx, 1, 1).
    s = Σ_r conj(h_r)·y_r / g, g = Σ|h_r|² floored at 1e-12; eff_var =
    nv/g (..., 1, N')."""
    hh = h[..., 0, :][..., None, :]  # (..., n_rx, 1, N')
    num = torch.sum(torch.conj(hh) * y, dim=-3)  # (..., S, N)
    g = torch.clamp(torch.sum(_abs2(hh), dim=-3), min=1e-12)  # (..., 1, N')
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=g.device)
    return num / g, nv / g


# ---- spatial multiplexing (V-BLAST): linear MMSE / ZF detection ----------------------

def mux_encode(x: torch.Tensor) -> torch.Tensor:
    """Scale n_tx streams (..., n_tx, S, N) to total unit power (× n_tx^-½)."""
    n_tx = x.shape[-3]
    return (x * n_tx ** -0.5).to(x.dtype)


def _inv_hermitian(m: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small Hermitian positive-definite (..., k, k)
    matrices: closed forms for k = 1, 2, ``torch.linalg.inv`` above."""
    k = m.shape[-1]
    if k == 1:
        return 1.0 / m
    if k == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, d = m[..., 1, 0], m[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
        return inv / det[..., None, None]
    return torch.linalg.inv(m)


def _effective(h: torch.Tensor):
    """A = H/√n_tx per subcarrier: (..., N', n_rx, n_tx) complex64."""
    n_tx = h.shape[-2]
    return (h * n_tx ** -0.5).to(torch.complex64).movedim(-1, -3)


def _per_tone(y: torch.Tensor) -> torch.Tensor:
    """y (..., n_rx, S, N) → (..., N, S, n_rx)."""
    return y.movedim(-3, -1).transpose(-3, -2)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.complex64, device=device)


def _mux_detect(y: torch.Tensor, h: torch.Tensor, noise_var, zf: bool):
    n_tx = h.shape[-2]
    nv = float(noise_var)
    am = _effective(h)
    gram = torch.einsum("...rt,...rs->...ts", torch.conj(am), am)
    reg = 1e-12 if zf else nv
    w = _inv_hermitian(gram + reg * _eye(n_tx, h.device))  # (..., N', n_tx, n_tx)
    z = torch.einsum("...rt,...sr->...st", torch.conj(am), _per_tone(y))  # (..., N, S, n_tx)
    xb = torch.einsum("...ts,...is->...it", w, z)  # biased estimates (..., N, S, n_tx)
    wkk = torch.diagonal(w, dim1=-2, dim2=-1).real  # (..., N', n_tx)
    if zf:
        est, eff = xb, nv * wkk
    else:
        bias = torch.clamp(1.0 - nv * wkk, min=1e-12)
        est, eff = xb / bias[..., None, :], nv * wkk / bias
    est = est.movedim(-1, -3).movedim(-1, -2)  # (..., n_tx, S, N)
    return est, eff.movedim(-1, -2)[..., None, :]  # (..., n_tx, 1, N')


def mux_detect_mmse(y: torch.Tensor, h: torch.Tensor, noise_var):
    """Unbiased linear MMSE detection of n_tx spatially multiplexed streams:
    y (..., n_rx, S, N), h (..., n_rx, n_tx, N | 1) → (s (..., n_tx, S, N),
    eff_var (..., n_tx, 1, N')), the per-stream 1/SINR of the unbiased
    MMSE filter (bias floored at 1e-12)."""
    return _mux_detect(y, h, noise_var, zf=False)


def mux_detect_zf(y: torch.Tensor, h: torch.Tensor, noise_var):
    """Zero forcing (n_rx ≥ n_tx): eff_var_k = nv·[(AᴴA + 1e-12·I)⁻¹]_kk."""
    return _mux_detect(y, h, noise_var, zf=True)


# ---- spatial multiplexing: ordered MMSE-SIC (V-BLAST) -------------------------------

def mux_detect_sic(y: torch.Tensor, h: torch.Tensor, noise_var, mod: Modulation):
    """Ordered MMSE successive interference cancellation: n_tx rounds of
    {MMSE filter on the still-active streams, pick the highest post-SINR
    one (``torch.argmax``: the first index on ties, as ``jnp.argmax``),
    slice it to the nearest point, subtract it}. Interface of the linear
    detectors; each stream's estimate and eff_var are those of its round."""
    n_tx = h.shape[-2]
    nv = float(noise_var)
    am = _effective(h)  # (..., N', n_rx, n_tx)
    const = constellation(mod, y.device)
    active = torch.ones((*am.shape[:-2], n_tx), dtype=torch.float32, device=y.device)
    resid = _per_tone(y)  # (..., N, S, n_rx)
    est = torch.zeros((*resid.shape[:-1], n_tx), dtype=torch.complex64, device=y.device)
    effv = torch.zeros(active.shape, dtype=torch.float32, device=y.device)
    eye = _eye(n_tx, y.device)
    for _ in range(n_tx):
        a_act = am * active[..., None, :]
        gram = torch.einsum("...rt,...rs->...ts", torch.conj(a_act), a_act)
        # Inactive streams get a unit diagonal so the inverse exists; the
        # selection masks them out.
        pad = torch.einsum("...t,ts->...ts", (1.0 - active).to(torch.complex64), eye)
        w = _inv_hermitian(gram + nv * eye + pad)
        wkk = torch.diagonal(w, dim1=-2, dim2=-1).real  # (..., N', n_tx)
        sinr = 1.0 / torch.clamp(nv * wkk, min=1e-12) - 1.0
        sinr = torch.where(active > 0.5, sinr, -torch.inf)
        onehot = torch.nn.functional.one_hot(torch.argmax(sinr, dim=-1), n_tx).to(torch.float32)
        z = torch.einsum("...rt,...sr->...st", torch.conj(a_act), resid)
        xb = torch.einsum("...ts,...is->...it", w, z)  # (..., N, S, n_tx)
        wkk_p = torch.sum(wkk * onehot, dim=-1)  # (..., N')
        bias = torch.clamp(1.0 - nv * wkk_p, min=1e-12)[..., None]
        x_p = torch.sum(xb * onehot[..., None, :], dim=-1) / bias  # (..., N, S)
        s_hard = const[nearest_symbol(x_p, mod).to(torch.int64)]
        a_p = torch.sum(am * onehot[..., None, :], dim=-1)  # (..., N', n_rx)
        resid = resid - s_hard[..., None] * a_p[..., None, :]
        est = est + x_p[..., None] * onehot[..., None, :]
        effv = effv + (nv * wkk_p / bias[..., 0])[..., None] * onehot
        active = active - onehot
    est = est.movedim(-1, -3).movedim(-1, -2)  # (..., n_tx, S, N)
    return est, effv.movedim(-1, -2)[..., None, :]  # (..., n_tx, 1, N')


# ---- spatial multiplexing: max-log ML joint detection (soft output) -----------------

ML_MAX_CANDIDATES = 4096  # n_tx = 2 up to 64-QAM; the joint-search budget
ML_BLOCK = 16  # candidates a block of the running minimum spans, at least


@functools.lru_cache(maxsize=None)
def _ml_tables(mod: Modulation, n_tx: int):
    """(cand (C, n_tx) complex64, bit_masks (n_tx·bps, C) bool), C = M^n_tx:
    candidate c is the tuple of per-stream points whose MSB-first bits,
    stream 0 first, are column c of bit_masks (``modulate``'s order)."""
    const, _, _, _ = _tables(mod)
    M = const.shape[0]
    bps = mod.bits_per_symbol
    if M ** n_tx > ML_MAX_CANDIDATES:
        raise ValueError(
            f"ML joint search over {M}^{n_tx} candidates exceeds the "
            f"{ML_MAX_CANDIDATES}-candidate budget"
        )
    idx = np.indices((M,) * n_tx).reshape(n_tx, -1)  # (n_tx, C)
    cand = const[idx.T]  # (C, n_tx)
    masks = np.concatenate(
        [((idx[t][None, :] >> np.arange(bps - 1, -1, -1)[:, None]) & 1) for t in range(n_tx)],
        axis=0,
    ).astype(bool)  # (n_tx·bps, C)
    return cand.astype(np.complex64), masks


def _ml_span(M: int, n_tx: int) -> int:
    """Streams a block spans: the fewest trailing streams whose M^k
    candidates reach ``ML_BLOCK`` (all of them when C is smaller)."""
    k = 1
    while k < n_tx and M ** k < ML_BLOCK:
        k += 1
    return k


def mux_detect_ml(y: torch.Tensor, h: torch.Tensor, noise_var, mod: Modulation):
    """Max-log ML joint detection of spatially multiplexed streams.

    For every resource element the metric of candidate s_c is
    q_c − 2·Re(zᴴ s_c), z = Aᴴy, q_c = s_cᴴ G s_c (G = AᴴA, A = H/√n_tx);
    bit j's LLR is (min over candidates with the bit set − min over the
    others)/nv. The candidates run in blocks (module docstring): the
    leading n_tx − k streams fixed, the last k (``_ml_span``) spanned, so
    a block's metric plane is (..., N, S, M^k).

    y (..., n_rx, S, N); h (..., n_rx, n_tx, N | 1); noise_var a scalar.
    Returns float32 LLRs (..., n_tx, S, N·bps), positive ⇒ bit 0, in
    ``modulate``'s per-subcarrier bit order."""
    n_tx = h.shape[-2]
    bps = mod.bits_per_symbol
    cand_np, _ = _ml_tables(mod, n_tx)
    dev = y.device
    const = constellation(mod, dev)
    M = const.shape[0]
    k = _ml_span(M, n_tx)
    lead, span = n_tx - k, M ** k
    cand = torch.as_tensor(cand_np, device=dev)  # (C, n_tx), stream 0 most significant
    am = _effective(h)  # (..., N', n_rx, n_tx)
    gram = torch.einsum("...rt,...rs->...ts", torch.conj(am), am)
    z = torch.einsum("...rt,...sr->...st", torch.conj(am), _per_tone(y))  # (..., N, S, n_tx)
    # Re(z_t·conj(p_i)) per stream t and point i: (..., N, S, M) each.
    cross = [(z[..., t, None] * torch.conj(const)).real for t in range(n_tx)]
    big = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    best = [torch.full(cross[0].shape, float("inf"), dtype=torch.float32, device=dev)
            for _ in range(n_tx)]  # per stream and point: the minimum over its candidates
    for p in range(M ** lead):
        c0 = p * span
        cb = cand[c0:c0 + span]  # (span, n_tx)
        q = torch.einsum("ct,...tu,cu->...c", torch.conj(cb), gram, cb).real  # (..., N', span)
        lead_idx = [(p // M ** (lead - 1 - t)) % M for t in range(lead)]
        spanned = cross[lead]  # (..., N, S, M^k), stream `lead` most significant
        for t in range(lead + 1, n_tx):
            spanned = (spanned[..., :, None] + cross[t][..., None, :]).flatten(-2)
        # q − 2·(the leading streams' terms + the spanned ones), one plane in place.
        metric = spanned * -2.0  # (..., N, S, span)
        for t, i in enumerate(lead_idx):
            metric.add_(cross[t][..., i, None], alpha=-2.0)
        metric.add_(q[..., None, :])
        blk = metric.view(*metric.shape[:-1], *([M] * k))
        for t, i in enumerate(lead_idx):
            best[t][..., i] = torch.minimum(best[t][..., i], metric.amin(dim=-1))
        for j, t in enumerate(range(lead, n_tx)):
            others = tuple(-k + a for a in range(k) if a != j)
            torch.minimum(best[t], blk.amin(dim=others) if others else blk, out=best[t])
        del metric, blk
    shifts = torch.arange(bps - 1, -1, -1, device=dev)
    has = ((torch.arange(M, device=dev)[None, :] >> shifts[:, None]) & 1).bool()  # (bps, M)
    llrs = []
    for t in range(n_tx):
        b = best[t][..., None, :]  # (..., N, S, 1, M)
        d1 = torch.where(has, b, big).amin(dim=-1)
        d0 = torch.where(has, big, b).amin(dim=-1)
        llrs.append(d1 - d0)  # (..., N, S, bps)
    llr = torch.stack(llrs, dim=-2) / float(noise_var)  # (..., N, S, n_tx, bps)
    n_sc = llr.shape[-4]
    llr = llr.movedim(-2, -4).transpose(-3, -2)  # (..., n_tx, S, N, bps)
    return llr.reshape(*llr.shape[:-2], n_sc * bps)
