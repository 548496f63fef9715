"""Link adaptation: calibrated MCS thresholds and per-channel selection
(port of ``sdr_tpu/link/adapt.py``).

The reference transmits one fixed 16-QAM waveform forever
(modulation.hpp:80 hard-constrains the roster to e16QAM); a deployable
link picks its modulation-and-coding scheme (MCS) from the channel
quality. This module provides the standard machinery:

- an MCS ladder across ALL THREE code families (modulation x
  {conv, ldpc, polar} x rate, ordered by spectral efficiency in info
  bits / subcarrier use); legacy 2-tuple rungs (mod, rate) mean conv;
- ``calibrate``: measure each rung's coded-BER waterfall on the port's
  coded links (``link.coded``, the chain the data uses) and extract the
  lowest Es/N0 meeting a target info-BER, by binary search over the grid;
- ``select_mcs``: the greedy rule — the highest-efficiency rung whose
  calibrated threshold clears the reported SNR (with a backoff margin);
  equal-efficiency ties go to the LOWER threshold (the stronger family);
- ``simulate_adaptive``: per-channel SNR profile → per-channel MCS →
  coded links grouped by (rung, SNR bin) → delivered info bits and BER.

Each coded link runs through ``coded.family_core(cfg, family, rate)(seed,
ids)`` on GLOBAL channel ids: a calibration point on channels 0 …
n_channels−1, an adaptive group on its own channels' ids, so every
channel's draws are a function of (seed, role, channel id) alone (the
JAX module keys a group by ``fold_in(key, first channel)`` instead). The
JAX module's ``_pin_precision`` (a TPU matmul mode for the dense rungs)
has no counterpart: the port has no such mode. A ``key`` argument of the
JAX functions is ``seed: int`` here; the links run on ``device``, the
card unless the caller asks for the CPU.

SNR convention: Es/N0 per subcarrier use in dB (modulation-independent,
unlike Eb/N0): esno_db = ebno_db + 10·log10(bits_per_symbol · rate).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sdr_tpu_torch.core.config import LinkConfig, Modulation
from sdr_tpu_torch.link import coded


#: The default ladder: efficiency-ordered rungs over all three code
#: families. Same-efficiency rungs from different families coexist —
#: calibration measures each, selection tie-breaks to the lower
#: threshold, so the adaptive link picks the stronger family per SNR.
#: LDPC rungs need frames >= 3072 bits (one nb=24/Z=128 codeword);
#: calibrate() drops rungs the frame can't fit.
DEFAULT_LADDER: tuple = (
    (Modulation.BPSK, "conv", "1/2"),
    (Modulation.QPSK, "conv", "1/2"),
    (Modulation.QPSK, "ldpc", "1/2"),
    (Modulation.QPSK, "polar", "1/2"),
    (Modulation.QPSK, "conv", "3/4"),
    (Modulation.QPSK, "ldpc", "3/4"),
    (Modulation.QAM16, "conv", "1/2"),
    (Modulation.QAM16, "ldpc", "1/2"),
    (Modulation.QAM16, "polar", "1/2"),
    (Modulation.QAM16, "conv", "3/4"),
    (Modulation.QAM16, "ldpc", "3/4"),
    (Modulation.QAM64, "conv", "2/3"),
    (Modulation.QAM64, "ldpc", "2/3"),
    (Modulation.QAM64, "conv", "3/4"),
    (Modulation.QAM64, "ldpc", "3/4"),
    # Round-4 v3 rungs: the full reference roster (modulation.hpp:13-14,
    # 70-72 names 256/1024-QAM as "5G" tags).
    (Modulation.QAM256, "ldpc", "2/3"),
    (Modulation.QAM256, "conv", "3/4"),
    (Modulation.QAM256, "ldpc", "3/4"),
    (Modulation.QAM1024, "ldpc", "2/3"),
    (Modulation.QAM1024, "ldpc", "3/4"),
)


def _norm_rung(rung) -> tuple:
    """Rung spellings: (mod, rate) legacy pairs mean conv/OFDM;
    (mod, family, rate) means OFDM; 4-tuples add the WAVEFORM
    dimension (mod, family, rate, "ofdm"|"scfdma") — round 4: under a
    PA the waveform choice IS a link-adaptation decision (SC-FDMA's
    constant modulus buys threshold at low backoff; docs/RESULTS.md
    round 2e/3)."""
    if len(rung) == 2:
        return rung[0], "conv", rung[1], "ofdm"
    if len(rung) == 3:
        return rung[0], rung[1], rung[2], "ofdm"
    return tuple(rung)


def waveform_ladder(ladder=DEFAULT_LADDER) -> tuple:
    """Duplicate every rung across the waveform dimension (OFDM +
    SC-FDMA). Same (mod, family, rate) ⇒ same efficiency, so selection
    tie-breaks to the lower calibrated threshold — the waveform flip
    at low IBO falls out of the existing greedy rule."""
    out = []
    for rung in ladder:
        mod, family, rate, _ = _norm_rung(rung)
        out.append((mod, family, rate, "ofdm"))
        out.append((mod, family, rate, "scfdma"))
    return tuple(out)


def efficiency(mod: Modulation, rate: str, family: str = "conv") -> float:
    """Info bits per subcarrier use, using the REALIZED code rate
    (polar's CRC-11 overhead counts against it)."""
    return mod.bits_per_symbol * coded.family_info_rate(family, rate)


def esno_from_ebno(
    ebno_db: float, mod: Modulation, rate: str, family: str = "conv"
) -> float:
    return ebno_db + 10.0 * math.log10(efficiency(mod, rate, family))


def ebno_from_esno(
    esno_db: float, mod: Modulation, rate: str, family: str = "conv"
) -> float:
    return esno_db - 10.0 * math.log10(efficiency(mod, rate, family))


@dataclasses.dataclass(frozen=True)
class MCSThreshold:
    modulation: Modulation
    rate: str
    #: REALIZED info bits per subcarrier use for the calibration
    #: frame geometry — counted from the simulator itself, so block
    #: codes pay their codeword-quantization waste here (an LDPC rung
    #: whose 3072-bit codewords fill only 6144 of an 8192-bit frame
    #: ranks at its true 2.25, not the nominal 3.0 — ranking by
    #: nominal made selection pick rungs that DELIVER less).
    efficiency: float
    esno_db: float  # lowest calibrated Es/N0 meeting the target
    measured_ber: float  # info-BER measured AT the threshold point
    family: str = "conv"
    waveform: str = "ofdm"  # round 4: the ladder's waveform dimension


def _link_counts(core, seed: int, ch_ids: np.ndarray, device):
    """One coded link (a ``coded.family_core``) over GLOBAL channel ids:
    per-channel (errors, counted) int64 numpy."""
    ids = torch.as_tensor(np.asarray(ch_ids, np.int32), device=device)
    errors, counted = core(seed, ids)
    return (errors.cpu().numpy().astype(np.int64), counted.cpu().numpy().astype(np.int64))


def calibrate(
    base: LinkConfig,
    seed: int,
    target_ber: float = 1e-4,
    esno_grid=None,
    ladder=DEFAULT_LADDER,
    device="cuda",
) -> list:
    """Measure each rung's waterfall and extract its Es/N0 threshold.

    base: numerology/channel template (its modulation and ebno are
    overridden per point); each point is the rung's coded link over
    channels 0 … base.n_channels − 1 on ``device``. Rungs that never meet
    the target on the grid — or whose codeword does not fit the frame
    (LDPC's 3072-bit codeword in a small frame) — are omitted; selection
    then simply cannot pick them. Returns MCSThreshold list in ladder
    order."""
    if esno_grid is None:
        # Extends to 36 dB so the 1024-QAM rungs can calibrate.
        esno_grid = np.arange(-2.0, 37.0, 2.0)
    esno_grid = list(esno_grid)
    ids = np.arange(base.n_channels)
    out = []
    for rung in ladder:
        mod, family, rate, waveform = _norm_rung(rung)

        def measure(esno):
            """(ber, counted_sum, n_channels) at one grid point, or
            None for a frame-infeasible rung (esno-independent)."""
            cfg = dataclasses.replace(
                base,
                modulation=mod,
                dft_spread=(waveform == "scfdma"),
                channel=dataclasses.replace(
                    base.channel,
                    ebno_db=float(ebno_from_esno(float(esno), mod, rate, family)),
                ),
            )
            # Only the eager frame-fit check marks a rung infeasible; an
            # error of the link's run (a kernel's launch) propagates.
            try:
                core = coded.family_core(cfg, family, rate)
            except ValueError:
                return None
            errors, counted = _link_counts(core, seed, ids, device)
            ber = float(errors.sum()) / float(counted.sum())
            return ber, float(counted.sum()), cfg.n_channels

        # The smallest passing grid point is binary-searched in
        # O(log |grid|) simulations instead of a linear walk. This ASSUMES
        # the measured pass/fail predicate is monotone in Es/N0 (the
        # waterfall). The true BER is monotone, but a Monte-Carlo estimate
        # near the target can flicker: on such a draw the search may return
        # a neighbouring grid point where a linear scan would have caught
        # the first flicker — both within the estimator's own noise; the
        # fixed seed keeps the result deterministic.
        top = measure(esno_grid[-1])
        if top is None or top[0] > target_ber:
            continue  # infeasible, or never meets target on this grid
        lo, hi = 0, len(esno_grid) - 1
        best = (esno_grid[hi],) + top
        while lo < hi:
            mid = (lo + hi) // 2
            r = measure(esno_grid[mid])
            if r is not None and r[0] <= target_ber:
                hi = mid
                best = (esno_grid[mid],) + r
            else:
                lo = mid + 1
        esno, ber, counted_sum, n_ch = best
        # Realized efficiency, from the simulator's own count: info bits
        # actually delivered per frame over the frame's subcarrier uses
        # (block codes pay their codeword-quantization waste; conv pays
        # its tail).
        uses = base.n_symbols * base.ofdm.n_fft
        real_eff = counted_sum / n_ch / uses
        out.append(MCSThreshold(mod, rate, real_eff, float(esno), ber, family, waveform))
    return out


def select_mcs(esno_db: float, table: list, margin_db: float = 0.0):
    """Highest-efficiency rung whose threshold clears esno - margin;
    equal efficiency goes to the LOWER threshold (stronger family).

    Returns an MCSThreshold, or None when even the most robust rung
    doesn't fit (the link should stay silent / repeat-request)."""
    best = None
    for t in table:
        if t.esno_db <= esno_db - margin_db:
            if best is None or t.efficiency > best.efficiency or (
                t.efficiency == best.efficiency and t.esno_db < best.esno_db
            ):
                best = t
    return best


def simulate_adaptive(
    base: LinkConfig,
    seed: int,
    esno_profile_db,
    table: list,
    margin_db: float = 0.0,
    snr_quantum_db: float = 1.0,
    device="cuda",
):
    """Adaptive coded link over a per-channel SNR profile on ``device``.

    esno_profile_db: (n_channels,) per-link SNRs (e.g. a shadowing draw),
    QUANTIZED to ``snr_quantum_db`` before simulation — each distinct
    (rung, SNR-bin) pair is one coded link over its channels' global ids
    (selection itself uses the unquantized values). Channels with no
    feasible rung transmit nothing.

    Returns a dict: per-channel selected efficiency (0 = silent),
    per-channel selected family and waveform, per-channel bit errors and
    info bits, and the aggregate spectral efficiency actually achieved
    (delivered-correct info bits per subcarrier use, counting silent
    channels' wasted uses)."""
    esno = np.asarray(esno_profile_db, np.float64)
    n_ch = esno.shape[0]
    picks = [select_mcs(float(e), table, margin_db) for e in esno]
    eff = np.array([0.0 if p is None else p.efficiency for p in picks])
    fams = ["" if p is None else p.family for p in picks]
    waves = ["" if p is None else p.waveform for p in picks]
    errors = np.zeros(n_ch, np.int64)
    counted = np.zeros(n_ch, np.int64)
    esno_q = np.round(esno / snr_quantum_db) * snr_quantum_db
    for t in {id(p): p for p in picks if p is not None}.values():
        idxs = np.nonzero(np.array([p is t for p in picks]))[0]
        for e_val in np.unique(esno_q[idxs]):
            sub = idxs[esno_q[idxs] == e_val]
            c = dataclasses.replace(
                base,
                modulation=t.modulation,
                n_channels=int(sub.size),
                dft_spread=(t.waveform == "scfdma"),
                channel=dataclasses.replace(
                    base.channel,
                    ebno_db=float(ebno_from_esno(float(e_val), t.modulation, t.rate, t.family)),
                ),
            )
            errors[sub], counted[sub] = _link_counts(
                coded.family_core(c, t.family, t.rate), seed, sub, device)
    uses = base.n_symbols * base.ofdm.n_fft  # subcarrier uses per frame
    delivered = counted - errors
    return {
        "efficiency_per_channel": eff,
        "family_per_channel": fams,
        "waveform_per_channel": waves,
        "bit_errors": errors,
        "info_bits": counted,
        "achieved_efficiency": float(delivered.sum()) / float(uses * n_ch),
        "silent_channels": int((eff == 0).sum()),
    }
