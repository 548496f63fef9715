"""The comparison that decides ``correct``.

Once the window has closed, the reservoir's calls (drawn from the seed)
and, in each, a sample of channels (drawn from the seed) are recomputed
by the plain reference from the same call seed and channel ids, and the
port's per-channel error counts are set beside the reference's. The
number compared is the gap: Σ|port − reference| over the sampled channels
per million bits counted there. A sound port differs from the reference
only where a bit's decision statistic sits within rounding of a decision
boundary; the control (the reference in bfloat16) and each planted fault
differ by far more. Each limit is in the cell's ``checks`` file.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_channels(seed: int, call_index: int, n_channels: int, count: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
                                 call_index, 0xC4E])
    return np.sort(rng.choice(n_channels, size=min(count, n_channels), replace=False))


def gap_ppm(got: np.ndarray, want: np.ndarray, bits: int) -> float:
    return float(np.abs(got.astype(np.int64) - want.astype(np.int64)).sum()) / bits * 1e6


def samples(engine, kept: dict, seed: int, channels: int, device):
    """[(call seed, channel ids tensor, the port's errors there)] for the kept calls."""
    out = []
    for index in sorted(kept):
        call_seed, errs = kept[index]
        chans = sample_channels(seed, index, engine.n_channels, channels)
        ids = torch.as_tensor(chans, dtype=torch.int32, device=device)
        out.append((call_seed, ids, errs[chans]))
    return out


def reference_gap(engine, picked, precision: str = "float32", against=None) -> float:
    """The gap between the port's errors (or ``against``'s, per sample)
    and the reference's, over the picked samples."""
    got, want, bits = [], [], 0
    for i, (call_seed, ids, port) in enumerate(picked):
        ref = engine.reference(call_seed, ids, precision).cpu().numpy()
        got.append(port if against is None else against[i])
        want.append(ref)
        bits += engine.bits_per_channel * len(ids)
    if not bits:
        return float("inf")
    return gap_ppm(np.concatenate(got), np.concatenate(want), bits)


def judge(engine, window, checks: dict, seed: int, device) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for one run's window."""
    picked = samples(engine, window.kept, seed, checks["channels"], device)
    limits = checks["limits"]
    numbers = {
        "err_gap_ppm": {"value": reference_gap(engine, picked) if picked else float("inf"),
                        "limit": limits["err_gap_ppm"]},
        "failed_calls": {"value": window.failed, "limit": 0},
        "checked_calls": {"value": len(picked), "limit": checks["calls"]},
    }
    ok = (numbers["err_gap_ppm"]["value"] <= limits["err_gap_ppm"]
          and window.failed == 0 and len(picked) >= checks["calls"])
    return ok, numbers
