"""Eb/N0 sweep with checkpoint/resume (port of ``sdr_tpu/obs/sweep.py``).

BER curves over an Eb/N0 grid: per point, link invocations accumulate
bit errors until ``target_errors`` (confidence ~1/√errors) or
``max_bits``, whichever first; every completed point rewrites an atomic
JSON checkpoint, so a long sweep survives interruption and a rerun
resumes after the completed points (or tops a point up under larger
targets).

Engines: ``"pipeline"`` (``link.pipeline``, the default, as in the JAX
sweep: uncoded links, genie CSI or pilot- or preamble-estimated, MIMO
among them), ``"fast"``
(``link.fast``) and ``"mc"`` (``link.mc``, kernel G, ``mc_iters`` passes
per invocation) run on ``device`` — the card unless the caller asks for
the CPU. Impaired configs run on the pipeline engine (item 11d). A coded
sweep (``code=`` one of ``link.coded.CODE_FAMILIES``, ``code_rate=``) runs
each point through ``link.coded.make_family_fn`` on the pipeline engine and
counts decoded information bits; its summary carries ``/{code}-{code_rate}``.

Seeds: the JAX ``key`` becomes an int ``seed``. Invocation ``batch`` of
point ``i`` runs with

    seed_ib = ((seed · 0x9E3779B1) + i · 1_000_003 + batch) mod 2^31,

a bijection of i · 1_000_003 + batch for each seed, so no two
invocations of one sweep share a seed while batch < 1_000_003 and
i < 2147 (both enforced). The checkpoint's config summary carries a
``/torch`` suffix: the JAX package's checkpoints hold points drawn from
another stream, and this sweep never resumes them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from sdr_tpu_torch.core.config import ChannelModel, LinkConfig, MIMOScheme
from sdr_tpu_torch.link.ber import (
    ber_alamouti_exact,
    ber_awgn_exact,
    ber_mrc_exact,
    ber_rayleigh_exact,
    ber_rician_exact,
)

ENGINES = ("pipeline", "fast", "mc")
_POINT_STRIDE = 1_000_003  # the JAX sweep's per-point stride (sweep.py:220)
_SEED_MIX = 0x9E3779B1
_MAX_POINTS = (1 << 31) // _POINT_STRIDE  # i · stride + batch stays below 2^31


@dataclasses.dataclass
class SweepPoint:
    ebno_db: float
    bit_errors: int
    bits_counted: int
    # Invocations consumed (seeds of batches 0..batches-1); persisted so a
    # resumed top-up never replays a seed.
    batches: int = 0

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.bits_counted, 1)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SweepResult:
    points: list  # list[SweepPoint], in grid order
    config_summary: str

    def bers(self) -> np.ndarray:
        return np.array([p.ber for p in self.points])

    def ebnos(self) -> np.ndarray:
        return np.array([p.ebno_db for p in self.points])

    def theory(self, mod, channel_model=None, k_factor: float = 4.0, mimo=None) -> np.ndarray:
        """Exact reference curve: AWGN by default; flat Rayleigh for
        RAYLEIGH_FLAT and RAYLEIGH_TIME (the Jakes marginal is the same
        exponential fade); flat Rician at ``k_factor`` for RICIAN; the exact
        diversity curves (``ber_alamouti_exact``, ``ber_mrc_exact``) for
        Alamouti and MRC over flat Rayleigh (spatial mux has no simple
        closed form: it falls through to the channel model's curve)."""
        if (mimo is not None and channel_model == ChannelModel.RAYLEIGH_FLAT
                and mimo.scheme in (MIMOScheme.ALAMOUTI, MIMOScheme.MRC)):
            base = ber_alamouti_exact if mimo.scheme == MIMOScheme.ALAMOUTI else ber_mrc_exact
            fn = lambda m, e: base(m, e, mimo.n_rx)  # noqa: E731
        elif channel_model == ChannelModel.RICIAN:
            fn = lambda m, e: ber_rician_exact(m, e, k_factor)  # noqa: E731
        elif channel_model in (ChannelModel.RAYLEIGH_FLAT, ChannelModel.RAYLEIGH_TIME):
            fn = ber_rayleigh_exact
        else:
            fn = ber_awgn_exact
        return np.array([fn(mod, e) for e in self.ebnos()])


def _cfg_summary(cfg: LinkConfig) -> str:
    s = (
        f"{cfg.modulation.value}/{cfg.ofdm.n_fft}sc/cp{cfg.ofdm.cp_len}/"
        f"{cfg.channel.model.value}/eq={cfg.equalizer.value}"
    )
    if cfg.dft_spread:
        # The waveform keys the checkpoint match too: an SC-FDMA sweep
        # must never reuse an OFDM sweep's points.
        s += "/scfdma"
    if cfg.pilot_spacing:
        s += f"/pilots{cfg.pilot_spacing}:{cfg.estimator.value}"
    if cfg.mimo is not None:
        m = cfg.mimo
        s += f"/{m.scheme.value}{m.n_tx}x{m.n_rx}:{m.csi}:{m.detector}"
    return s


def _atomic_write(path: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def invocation_seed(seed: int, i: int, batch: int) -> int:
    """The seed of invocation ``batch`` of grid point ``i`` (module docstring)."""
    if not 0 <= i < _MAX_POINTS or not 0 <= batch < _POINT_STRIDE:
        raise ValueError(f"sweep seeds are unique for < {_MAX_POINTS} points and "
                         f"< {_POINT_STRIDE} invocations per point; got point {i}, batch {batch}")
    return (int(seed) * _SEED_MIX + i * _POINT_STRIDE + batch) & 0x7FFFFFFF


def _invoker(engine: str, pt_cfg: LinkConfig, mc_iters: int, device, code=None,
             code_rate: str = "1/2"):
    """fn(seed) → (bit errors, bits counted) summed over the channels."""
    if code is not None:
        from sdr_tpu_torch.link.coded import make_family_fn

        fn = make_family_fn(pt_cfg, code, rate=code_rate, device=device)
    elif engine == "mc":
        from sdr_tpu_torch.link.mc import make_mc_fn

        fn = make_mc_fn(pt_cfg, iters=mc_iters, device=device)
    elif engine == "fast":
        from sdr_tpu_torch.link.fast import make_fast_fn

        fn = make_fast_fn(pt_cfg, device=device)
    else:
        from sdr_tpu_torch.link.pipeline import make_simulate_fn

        sim = make_simulate_fn(pt_cfg, device=device)

        def fn(seed: int):
            res = sim(seed)
            return res.bit_errors, res.bits_counted

    def invoke(seed: int):
        e, c = fn(seed)
        return int(e.sum(dtype=torch.int64)), int(c.sum(dtype=torch.int64))

    return invoke


def ebno_sweep(
    cfg: LinkConfig,
    ebno_grid_db: Sequence[float],
    seed: int = 0,
    target_errors: int = 500,
    max_bits: int = 20_000_000,
    checkpoint_path: Optional[str] = None,
    progress=None,
    engine: str = "pipeline",
    mc_iters: int = 16,
    code: Optional[str] = None,
    code_rate: str = "1/2",
    device="cuda",
) -> SweepResult:
    """BER over an Eb/N0 grid with stop-at-target-errors accumulation.

    Each invocation adds ``cfg.n_channels`` links of ``cfg.n_symbols``
    symbols (``mc_iters`` such passes with ``engine="mc"``). If
    ``checkpoint_path`` exists and matches this sweep's config summary,
    its points are loaded: complete ones (under the current targets) are
    reused, incomplete ones topped up from their next batch. Checkpoints
    record the engine, so sweeps of different engines never share state.
    The default engine is ``"pipeline"``, as in the JAX sweep; ``code``
    (with ``code_rate``) sweeps a coded family on it."""
    if engine not in ENGINES:
        raise ValueError(f"unknown sweep engine {engine!r}")
    if code is not None and engine != "pipeline":
        raise ValueError(
            "coded sweeps run on the pipeline engine (the fast/mc engines count "
            "channel bits, not decoded info bits)"
        )
    if engine == "fast" and (cfg.pilot_spacing or cfg.channel.impaired):
        raise ValueError(
            "engine='fast' needs a full-grid config (no pilots or timing/CFO impairments)"
        )
    suffix = {"pipeline": "", "fast": "/fast", "mc": "/mc"}[engine]
    summary = _cfg_summary(cfg) + suffix
    if code is not None:
        summary += f"/{code}-{code_rate}"
    summary += "/torch"
    done: dict[float, SweepPoint] = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            ck = json.load(f)
        if ck.get("config_summary") == summary:
            for p in ck.get("points", []):
                pt = SweepPoint(**p)
                done[float(pt.ebno_db)] = pt

    points: list[SweepPoint] = []
    for i, ebno in enumerate(ebno_grid_db):
        ebno = float(ebno)
        prev = done.get(ebno)
        if prev is not None and (prev.bit_errors >= target_errors
                                 or prev.bits_counted >= max_bits):
            # Complete under the current targets; larger targets top the
            # point up instead of reusing a less-converged result.
            points.append(prev)
            continue
        pt_cfg = dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel, ebno_db=ebno))
        invoke = _invoker(engine, pt_cfg, mc_iters, device, code, code_rate)
        errors = prev.bit_errors if prev else 0
        bits = prev.bits_counted if prev else 0
        batch = prev.batches if prev else 0
        while errors < target_errors and bits < max_bits:
            e, c = invoke(invocation_seed(seed, i, batch))
            errors += e
            bits += c
            batch += 1
        pt = SweepPoint(ebno_db=ebno, bit_errors=errors, bits_counted=bits, batches=batch)
        points.append(pt)
        done[ebno] = pt
        if progress is not None:
            progress(pt)
        if checkpoint_path:
            _atomic_write(checkpoint_path, {
                "config_summary": summary,
                "points": [p.to_json() for p in sorted(done.values(), key=lambda q: q.ebno_db)],
            })
    return SweepResult(points=points, config_summary=summary)
