#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sdr_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository on a machine with a Hopper card:

    python3 chip_smoke.py

It builds the kernel library from ``sdr_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit), torch's
   version and the kernels' build time;
2. runs each kernel A–F and each mode (B's per-symbol gains and FIR,
   C's taps=) against its plain torch version on the card at the
   slice's shapes and prints both times (CUDA events, after a warm-up,
   in turns plain, kernel, kernel, plain); then holds the staged channel
   route (plain FIR + kernel E) against the fused one (kernel B's FIR);
3. drives the keyed fast link (``fast_simulate``) at BASELINE config-2
   numerology (16-QAM, N = 256, CP = 64) with 8192 channels × 64
   symbols: AWGN at 10 dB against exact theory (within 5 %), flat
   Rayleigh at 12 dB (within 10 %), and channels [0, 4096) alone against
   the full run (identical counts);
   3b. the selective and time-varying channels at the same size —
   MULTIPATH with BASELINE config 4's PDP, RAYLEIGH_TIME and
   MULTIPATH_TIME at doppler 0.02, MULTIPATH with 24 taps (the staged
   route) — each BER within 2 % of the exact BER over the channel the
   run drew, and split == full for MULTIPATH_TIME;
   3c. ``layout="cl"`` for AWGN and flat Rayleigh: counts equal to the
   rows run's (but for bits with plain |LLR| < 1e-3), the same BER
   gates, and both layouts' end-to-end times;
4. times the channels-last demod-sum terminal at the headline bench's
   shape (32768 channels × 64 symbols) through ``demod_sum_chain_cl``;
5. checks that phases 3–4 launched every kernel and mode (the launch
   counters are zeroed just before phase 3) and prints one JSON line
   per kernel set, then ``{"ok": true, "device": {...}}`` as the last
   line.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits 1 before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def _fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


def ber_given_gain(mod, ebno_db: float, g2) -> float:
    """Exact Gray-QAM AWGN BER at Eb/N0·|H|², averaged over the channel
    gains ``g2`` (a float64 tensor, one element per equally weighted
    subcarrier group): the BER of the channel a run drew. With CP ≥ L−1
    each subcarrier is an AWGN channel at its own |H|², and the one-tap
    equaliser's max-log decisions are exact per axis (Cho–Yoon weights,
    as ``link/ber.py``)."""
    import torch

    L, m = mod.levels_per_axis, mod.bits_per_axis
    gamma = 2.0 * mod.bits_per_symbol * 10.0 ** (ebno_db / 10.0)
    total = 0.0
    for part in torch.split(g2.reshape(-1), 1 << 24):
        arg = mod.unit_energy_scale * torch.sqrt(gamma * part) / math.sqrt(2.0)
        acc = torch.zeros_like(arg)
        for k in range(1, m + 1):
            half = 1 << (k - 1)
            for i in range(int((1.0 - 2.0 ** (-k)) * L)):
                sign = -1.0 if ((i * half) // L) % 2 else 1.0
                weight = half - math.floor(i * half / L + 0.5)
                acc += (sign * weight / L) * torch.special.erfc((2 * i + 1) * arg)
        total += float(acc.sum())
    return total / g2.numel() / m


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    return smoke(torch.device("cuda"))


def smoke(dev, B: int = 8192, BD: int = 32768) -> int:
    """The phases on ``dev`` with B link channels and BD terminal channels."""
    import torch

    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelModel,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )
    from sdr_tpu_torch.kernels import _lib
    from sdr_tpu_torch.kernels import channel as ke
    from sdr_tpu_torch.kernels import demod as kc
    from sdr_tpu_torch.kernels import demod_cl as kd
    from sdr_tpu_torch.kernels import payload as ka
    from sdr_tpu_torch.kernels import tx as kb
    from sdr_tpu_torch.link import fast
    from sdr_tpu_torch.link.ber import ber_awgn_exact, ber_rayleigh_exact
    from sdr_tpu_torch.ops import channel as chan
    from sdr_tpu_torch.ops.demod import demod_sum_chain_cl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: the card, torch, the build ---------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = smi
    prebuilt = _lib.library_path().exists()
    t0 = time.perf_counter()
    _lib.lib()
    print(smi)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernel library {_lib.source_hash()} "
          f"{'found prebuilt, loaded' if prebuilt else 'built from source and loaded'} "
          f"in {time.perf_counter() - t0:.1f} s")

    def timed(fn, reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def compare_times(kernel_fn, plain_fn, reps=3):
        """Warm up both, then time in turns plain, kernel, kernel, plain."""
        kernel_fn()
        plain_fn()
        p1 = timed(plain_fn, reps)
        k1 = timed(kernel_fn, reps)
        k2 = timed(kernel_fn, reps)
        p2 = timed(plain_fn, reps)
        return (k1 + k2) / 2, (p1 + p2) / 2

    mod = Modulation.QAM16
    N, CP, S = 256, 64, 64
    bps = mod.bits_per_symbol
    seed = 20261016
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    report = {}

    # ---- phase 2: each kernel against its plain version ------------------
    # A: payload draw, exact.
    idx = ka.payload_idx(S, N, bps, seed, ids)
    idx_plain = ka.payload_idx_plain(S, N, bps, seed, ids)
    _check(torch.equal(idx, idx_plain), "kernel A differs from its plain version")
    del idx_plain
    ms, pms = compare_times(lambda: ka.payload_idx(S, N, bps, seed, ids),
                            lambda: ka.payload_idx_plain(S, N, bps, seed, ids))
    report["payload"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms)
    print(f"phase 2 A payload ({B}x{S}x{N} int8): exact; kernel {ms:.3f} ms, plain {pms:.3f} ms")

    # B: fused TX + flat channel.
    nv10 = 1.0 / (10.0 ** 1.0 * bps)
    tvar = nv10 / N
    h = chan.rayleigh_flat(seed, ids)
    hs_r = h.real.reshape(-1).contiguous()
    hs_i = h.imag.reshape(-1).contiguous()
    noise = (torch.randn((B, S, N + CP), device=dev), torch.randn((B, S, N + CP), device=dev))
    got = kb.tx_channel(idx, CP, mod, hs_r, hs_i, tvar, noise=noise)
    want = kb.tx_channel_plain(idx, CP, mod, hs_r, hs_i, tvar, noise=noise)
    inj_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    _check(inj_err <= 1e-4, f"kernel B (injected noise) max abs diff {inj_err:g} > 1e-4")
    del noise, got, want
    got = kb.tx_channel(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids)
    want = kb.tx_channel_plain(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids)
    key_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    peak = max(float(b.abs().max()) for b in want)
    _check(key_err <= 1e-5 * peak, f"kernel B (keyed noise) max abs diff {key_err:g} > 1e-5 of {peak:g}")
    del got, want
    ms, pms = compare_times(
        lambda: kb.tx_channel(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids),
        lambda: kb.tx_channel_plain(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids),
    )
    report["tx"] = dict(max_abs_err=key_err, ms=ms, plain_ms=pms)
    print(f"phase 2 B tx+channel ({B}x{S}x{N + CP}): injected-noise max abs diff {inj_err:.3g}, "
          f"keyed-noise max abs diff {key_err:.3g} (peak {peak:.3g}); "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms")

    # C: rows demod + error count on the AWGN 10 dB waveform.
    re, im = kb.tx_channel(idx, CP, mod, noise_var=tvar, seed=seed, ch_ids=ids)
    hr = torch.ones((B, 1, N), device=dev)
    hi = torch.zeros((B, 1, N), device=dev)
    cnt = kc.demod_count(re, im, hr, hi, idx, CP, mod, nv10)
    llr = kc.demod_chain(re, im, hr, hi, CP, mod, nv10)
    cnt_plain = kc.count_errors(llr, idx, bps)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    del llr
    diff = (cnt - cnt_plain).abs()
    _check(bool((diff <= margin).all()), "kernel C counts differ beyond the |LLR| < 1e-3 bits")
    ms, pms = compare_times(
        lambda: kc.demod_count(re, im, hr, hi, idx, CP, mod, nv10),
        lambda: kc.demod_count_plain(re, im, hr, hi, idx, CP, mod, nv10),
    )
    report["demod_count"] = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=pms)
    print(f"phase 2 C demod+count ({B}x{S}x{N + CP}): {int(cnt.sum())} errors, plain "
          f"{int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} "
          f"(allowed {int(margin.max())}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
    del re, im, hr, hi, cnt, cnt_plain

    def plane_err(got, want):
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    def plane_peak(planes):
        return max(float(b.abs().max()) for b in planes)

    def check_modes(label, kernel_fn, plain_fn, noise_shape):
        """Injected noise, then keyed: max abs diff ≤ 1e-5 of the peak;
        times in the keyed mode."""
        noise_i = (torch.randn(noise_shape, device=dev), torch.randn(noise_shape, device=dev))
        want = plain_fn(noise=noise_i)
        e_inj = plane_err(kernel_fn(noise=noise_i), want)
        p_inj = plane_peak(want)
        del noise_i, want
        want = plain_fn(seed=seed, ch_ids=ids)
        e_key = plane_err(kernel_fn(seed=seed, ch_ids=ids), want)
        p_key = plane_peak(want)
        del want
        _check(e_inj <= 1e-5 * p_inj, f"{label} (injected noise) max abs diff {e_inj:g}")
        _check(e_key <= 1e-5 * p_key, f"{label} (keyed noise) max abs diff {e_key:g}")
        ms, pms = compare_times(lambda: kernel_fn(seed=seed, ch_ids=ids),
                                lambda: plain_fn(seed=seed, ch_ids=ids), reps=1)
        print(f"phase 2 {label}: max abs diff injected {e_inj:.3g}, keyed {e_key:.3g} "
              f"(peak {p_key:.3g}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
        return dict(max_abs_err=max(e_inj, e_key), ms=ms, plain_ms=pms)

    def count_margin(llr):
        return (llr.abs() < 1e-3).sum(dim=(1, 2))

    # B: per-symbol gains, static 4 taps, per-symbol 3 taps.
    pdp4 = (1.0, 0.5, 0.25, 0.125)
    pdp3 = (1.0, 0.5, 0.25)
    tx_shape = (B, S, N + CP)
    g_sym = chan.jakes_gains(seed, ids, S, 0.02)
    gs_r, gs_i = g_sym.real.contiguous(), g_sym.imag.contiguous()
    check_modes(f"B tx+channel per-symbol gains ({B}x{S}x{N + CP})",
                lambda **kw: kb.tx_channel(idx, CP, mod, gs_r, gs_i, tvar, **kw),
                lambda **kw: kb.tx_channel_plain(idx, CP, mod, gs_r, gs_i, tvar, **kw), tx_shape)
    t4_r = torch.tensor(pdp4, device=dev).expand(B, 4).contiguous()
    t4_i = torch.zeros_like(t4_r)
    check_modes("B tx+FIR static 4 taps",
                lambda **kw: kb.tx_channel(idx, CP, mod, noise_var=tvar, taps_r=t4_r,
                                           taps_i=t4_i, **kw),
                lambda **kw: kb.tx_channel_plain(idx, CP, mod, noise_var=tvar, taps_r=t4_r,
                                                 taps_i=t4_i, **kw), tx_shape)
    taps3 = chan.multipath_time_taps(seed, ids, pdp3, S, 0.02)
    t3_r, t3_i = taps3.real.contiguous(), taps3.imag.contiguous()
    report["tx_taps"] = check_modes(
        "B tx+FIR per-symbol 3 taps",
        lambda **kw: kb.tx_channel(idx, CP, mod, noise_var=tvar, taps_r=t3_r, taps_i=t3_i, **kw),
        lambda **kw: kb.tx_channel_plain(idx, CP, mod, noise_var=tvar, taps_r=t3_r, taps_i=t3_i,
                                         **kw), tx_shape)

    # C: taps= (3 taps per symbol) on the TDL waveform at 12 dB.
    nv12 = 1.0 / (10.0 ** 1.2 * bps)
    re, im = kb.tx_channel(idx, CP, mod, noise_var=nv12 / N, seed=seed, ch_ids=ids,
                           taps_r=t3_r, taps_i=t3_i)
    taps_pair = (t3_r, t3_i)
    cnt = kc.demod_count(re, im, None, None, idx, CP, mod, nv12, taps=taps_pair)
    llr = kc.demod_chain(re, im, *kc.taps_plane(taps_pair, N), CP, mod, nv12)
    cnt_plain = kc.count_errors(llr, idx, bps)
    margin = count_margin(llr)
    del llr
    diff = (cnt - cnt_plain).abs()
    _check(bool((diff <= margin).all()),
           "kernel C (taps=) counts differ beyond the |LLR| < 1e-3 bits")
    ms, pms = compare_times(
        lambda: kc.demod_count(re, im, None, None, idx, CP, mod, nv12, taps=taps_pair),
        lambda: kc.demod_count_plain(re, im, None, None, idx, CP, mod, nv12, taps=taps_pair),
        reps=1)
    report["demod_count_taps"] = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=pms)
    print(f"phase 2 C demod+count taps= (3 per symbol): {int(cnt.sum())} errors, plain "
          f"{int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} (allowed "
          f"{int(margin.max())}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
    del re, im, cnt, cnt_plain

    # E: per-link gains, per-symbol gains, noise only, over the clean waveform.
    clean = kb.tx_chain(idx, CP, mod)
    for label, gains in (("per-link gains", (hs_r[:, None], hs_i[:, None])),
                         ("per-symbol gains", (gs_r, gs_i)), ("noise only", (None, None))):
        rep = check_modes(f"E fade+awgn {label} ({B}x{S}x{N + CP})",
                          lambda **kw: ke.fade_awgn(*clean, *gains, tvar, **kw),
                          lambda **kw: ke.fade_awgn_plain(*clean, *gains, tvar, **kw), tx_shape)
        if label == "per-symbol gains":
            report["fade_awgn"] = rep
    del clean

    # Route cross-check: staged (plain FIR + E) against fused (B's FIR).
    cfg_mp = LinkConfig(modulation=mod, ofdm=OFDMConfig(N, CP),
                        channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=14.0,
                                              pdp=pdp4),
                        n_symbols=S, n_channels=B)
    fused = fast.tx_with_channel(cfg_mp, seed, ids, idx)
    staged = fast.apply_channel_fast(cfg_mp, seed, ids, *kb.tx_chain(idx, CP, mod))
    r_err, r_peak = plane_err(staged, fused), plane_peak(fused)
    _check(r_err <= 1e-5 * r_peak, f"staged route differs from the fused route by {r_err:g}")
    print(f"phase 2 route cross-check MULTIPATH 4 taps: staged (FIR + E) vs fused (B) max abs "
          f"diff {r_err:.3g} (peak {r_peak:.3g})")
    del staged

    # F: channels-last count on the 4-tap MULTIPATH waveform at 14 dB.
    nv14 = 1.0 / (10.0 ** 1.4 * bps)
    re_t, im_t = fast._to_cl(*fused)
    del fused
    h_mp = fast.rx_plane(fast.fade_state(cfg_mp, seed, ids, plane=False)[1], N)[:, 0, :].T
    hr_c, hi_c = h_mp.real.contiguous(), h_mp.imag.contiguous()
    idx_t = idx.permute(1, 2, 0).reshape(S * N, B).contiguous()
    cnt = kd.demod_count_cl(re_t, im_t, hr_c, hi_c, idx_t, CP, mod, nv14)
    cnt_plain = torch.zeros_like(cnt)
    margin = torch.zeros_like(cnt)
    hr_rows, hi_rows = hr_c.T[:, None, :], hi_c.T[:, None, :]
    for s in range(S):
        rows = slice(s * (N + CP) + CP, (s + 1) * (N + CP))
        llr = kc.demod_chain(re_t[rows].T[:, None, :], im_t[rows].T[:, None, :], hr_rows, hi_rows,
                             0, mod, nv14)
        cnt_plain += kc.count_errors(llr, idx_t[s * N:(s + 1) * N].T[:, None, :], bps)
        margin += count_margin(llr).to(torch.int32)
    diff = (cnt - cnt_plain).abs()
    _check(bool((diff <= margin).all()), "kernel F counts differ beyond the |LLR| < 1e-3 bits")
    ms, pms = compare_times(
        lambda: kd.demod_count_cl(re_t, im_t, hr_c, hi_c, idx_t, CP, mod, nv14),
        lambda: kd.demod_count_cl_plain(re_t, im_t, hr_c, hi_c, idx_t, CP, mod, nv14), reps=1)
    report["demod_count_cl"] = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=pms)
    print(f"phase 2 F demod+count channels-last ({S * (N + CP)}x{B}): {int(cnt.sum())} errors, "
          f"plain {int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} (allowed "
          f"{int(margin.max())}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
    del re_t, im_t, idx_t, cnt, cnt_plain, llr, idx, h, hs_r, hs_i, g_sym, gs_r, gs_i, taps3
    torch.cuda.empty_cache()

    # D: channels-last demod-sum at the headline bench's shape (bench.py's
    # synthetic inputs: noise-like samples, Rayleigh h, 16-QAM at 12 dB).
    gen = torch.Generator(device=dev).manual_seed(seed)
    re_t = torch.randn((S * (N + CP), BD), device=dev, generator=gen) * (1.0 / (2 * N) ** 0.5)
    im_t = torch.randn((S * (N + CP), BD), device=dev, generator=gen) * (1.0 / (2 * N) ** 0.5)
    hr_t = torch.randn((N, BD), device=dev, generator=gen) * 0.5 ** 0.5
    hi_t = torch.randn((N, BD), device=dev, generator=gen) * 0.5 ** 0.5
    tot = kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, CP, mod, nv12)
    tot_plain = kd.demod_sum_cl_plain(re_t, im_t, hr_t, hi_t, CP, mod, nv12)
    d_err = abs(float(tot) - float(tot_plain))
    _check(d_err <= 1e-4 * abs(float(tot_plain)),
           f"kernel D sum {float(tot)!r} vs plain {float(tot_plain)!r}")
    _check(float(kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, CP, mod, nv12)) == float(tot),
           "kernel D is not deterministic")
    ms, pms = compare_times(
        lambda: kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, CP, mod, nv12),
        lambda: kd.demod_sum_cl_plain(re_t, im_t, hr_t, hi_t, CP, mod, nv12),
        reps=2,
    )
    report["demod_sum_cl"] = dict(max_abs_err=d_err, ms=ms, plain_ms=pms)
    print(f"phase 2 D demod-sum channels-last ({S * (N + CP)}x{BD}): sum {float(tot):.9g}, "
          f"plain {float(tot_plain):.9g}, rel diff {d_err / abs(float(tot_plain)):.3g}; "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms")

    # ---- phase 3: the slice, counters zeroed just before ------------------
    _lib.reset_launches()

    def link_cfg(model, ebno_db, n_channels=B, **channel):
        return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=N, cp_len=CP),
                          channel=ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          n_symbols=S, n_channels=n_channels)

    def run_link(model, ebno_db, n_channels=B, ch=None, layout="auto", **channel):
        cfg = link_cfg(model, ebno_db, n_channels, **channel)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if ch is None:
            errors, counted = fast.fast_simulate(cfg, seed, device=dev, layout=layout)
        else:
            errors, counted = fast.fast_core(cfg, seed, ch, layout=layout)
        torch.cuda.synchronize()
        return errors, counted, time.perf_counter() - t

    fast.fast_simulate(LinkConfig(modulation=mod, ofdm=OFDMConfig(N, CP), n_symbols=S,
                                  n_channels=128), seed, device=dev)  # warm-up
    errors, counted, t_awgn = run_link(ChannelModel.AWGN, 10.0)
    ber = int(errors.sum()) / int(counted.sum())
    th = ber_awgn_exact(mod, 10.0)
    _check(abs(ber / th - 1) <= 0.05, f"AWGN BER {ber:g} vs theory {th:g}")
    half = B // 2
    part, _, _ = run_link(ChannelModel.AWGN, 10.0, ch=ids[:half])
    _check(torch.equal(part, errors[:half]), "split run differs from the full run")
    errors_r, counted_r, t_ray = run_link(ChannelModel.RAYLEIGH_FLAT, 12.0)
    ber_r = int(errors_r.sum()) / int(counted_r.sum())
    th_r = ber_rayleigh_exact(mod, 12.0)
    _check(abs(ber_r / th_r - 1) <= 0.10, f"Rayleigh BER {ber_r:g} vs theory {th_r:g}")
    samples = B * S * (N + CP)
    print(f"phase 3 fast_simulate {B}x{S} config 2: AWGN 10 dB BER {ber:.6g} (theory {th:.6g}, "
          f"{int(counted.sum())} bits) in {t_awgn * 1e3:.1f} ms; Rayleigh 12 dB BER {ber_r:.6g} "
          f"(theory {th_r:.6g}) in {t_ray * 1e3:.1f} ms; split [0, {half}) == full; "
          f"{samples / t_awgn / 1e9:.3f} GS/s end to end (AWGN) on {card}")
    del part

    # ---- phase 3b: selective and time-varying channels -------------------
    pdp24 = tuple(0.8 ** l for l in range(24))
    for label, model, ebno_db, channel in (
        ("MULTIPATH config-4 PDP (4 taps)", ChannelModel.MULTIPATH, 14.0, dict(pdp=pdp4)),
        ("RAYLEIGH_TIME doppler 0.02", ChannelModel.RAYLEIGH_TIME, 12.0,
         dict(doppler_norm=0.02)),
        ("MULTIPATH_TIME PDP (1, .5, .25) doppler 0.02", ChannelModel.MULTIPATH_TIME, 12.0,
         dict(pdp=pdp3, doppler_norm=0.02)),
        ("MULTIPATH 24 taps 0.8^l (staged route)", ChannelModel.MULTIPATH, 14.0,
         dict(pdp=pdp24)),
    ):
        run_link(model, ebno_db, **channel)  # warm-up at full size: the time below is warm
        errors_s, counted_s, t_s = run_link(model, ebno_db, **channel)
        ber_s = int(errors_s.sum()) / int(counted_s.sum())
        h_s, _ = fast.fade_state(link_cfg(model, ebno_db, **channel), seed, ids)
        want = ber_given_gain(mod, ebno_db, (h_s.abs() ** 2).to(torch.float64))
        del h_s
        _check(abs(ber_s / want - 1) <= 0.02,
               f"{label}: BER {ber_s:g} vs {want:g} over the drawn channel")
        extra = ""
        if model == ChannelModel.MULTIPATH_TIME:
            part, _, _ = run_link(model, ebno_db, ch=ids[:half], **channel)
            _check(torch.equal(part, errors_s[:half]), f"{label}: split run differs from full")
            extra = f"; split [0, {half}) == full"
        print(f"phase 3b fast_simulate {B}x{S} config 2 {label} at {ebno_db:g} dB: BER "
              f"{ber_s:.6g}, over the drawn channel {want:.6g} "
              f"(ratio {ber_s / want:.5f}; Rayleigh theory {ber_rayleigh_exact(mod, ebno_db):.6g})"
              f" in {t_s * 1e3:.1f} ms{extra}")
    del errors_s, counted_s

    # ---- phase 3c: the channels-last layout against rows ---------------------
    for label, model, ebno_db, rows_errors, th_c, tol in (
        ("AWGN 10 dB", ChannelModel.AWGN, 10.0, errors, th, 0.05),
        ("RAYLEIGH_FLAT 12 dB", ChannelModel.RAYLEIGH_FLAT, 12.0, errors_r, th_r, 0.10),
    ):
        errors_c, counted_c, _ = run_link(model, ebno_db, layout="cl")
        ber_c = int(errors_c.sum()) / int(counted_c.sum())
        _check(abs(ber_c / th_c - 1) <= tol, f"cl {label} BER {ber_c:g} vs theory {th_c:g}")
        cfg_c = link_cfg(model, ebno_db)
        re, im = fast.tx_channel_core(cfg_c, seed, ids)
        h_c, _ = fast.fade_state(cfg_c, seed, ids)
        hb = torch.ones((B, 1, 1), dtype=torch.complex64, device=dev) if h_c is None else h_c
        hb = hb.expand(B, 1, N)
        llr = kc.demod_chain(re, im, hb.real, hb.imag, CP, mod, fast.noise_var(cfg_c))
        margin = count_margin(llr)
        del llr, re, im
        diff = (errors_c - rows_errors).abs()
        _check(bool((diff <= margin).all()), f"cl {label}: counts differ from rows beyond margin")
        times = {"rows": [], "cl": []}
        for layout in ("rows", "cl", "cl", "rows", "rows", "cl"):
            times[layout].append(run_link(model, ebno_db, layout=layout)[2])
        t_rows, t_cl = sorted(times["rows"])[1], sorted(times["cl"])[1]
        print(f"phase 3c layout='cl' {B}x{S} config 2 {label}: BER {ber_c:.6g} (theory "
              f"{th_c:.6g}); per-channel counts vs rows max diff {int(diff.max())} (allowed "
              f"{int(margin.max())}); end to end rows {t_rows * 1e3:.3f} ms, cl "
              f"{t_cl * 1e3:.3f} ms (median of 3 each, in turns) on {card}")
    del errors, counted, errors_r, counted_r, errors_c
    torch.cuda.empty_cache()

    # ---- phase 4: the headline terminal at the bench's shape ----------------
    perm = torch.as_tensor(kd.dif_perm(N), device=dev)
    hr_d = hr_t[perm].contiguous()
    hi_d = hi_t[perm].contiguous()
    val = demod_sum_chain_cl(re_t, im_t, hr_d, hi_d, CP, mod, nv12, h_in_dif_order=True)
    _check(torch.isfinite(val).item() and float(val) == float(tot),
           "terminal with DIF-ordered h differs from natural order")
    iters = 10
    ms_term = timed(lambda: demod_sum_chain_cl(re_t, im_t, hr_d, hi_d, CP, mod, nv12,
                                               h_in_dif_order=True), iters)
    rate = S * (N + CP) * BD / (ms_term * 1e-3)
    print(f"phase 4 demod_sum_chain_cl {BD}x{S} f32: {ms_term:.3f} ms per call, "
          f"{rate / 1e9:.3f} GS/s ({rate:.6g} samples/s) on {card}")

    # ---- counters and result ------------------------------------------------
    launches = dict(_lib.LAUNCHES)
    for name, n in launches.items():
        _check(n > 0, f"kernel {name} was not launched on the main path")
    sources = {
        "payload": ("sdr_tpu_torch/csrc/payload.cu", "sdr_tpu/kernels/channel_pallas.py:233"),
        "tx": ("sdr_tpu_torch/csrc/tx.cu", "sdr_tpu/kernels/tx_pallas.py:329"),
        "tx_taps": ("sdr_tpu_torch/csrc/tx.cu", "sdr_tpu/kernels/tx_pallas.py:329"),
        "demod_count": ("sdr_tpu_torch/csrc/demod.cu", "sdr_tpu/kernels/demod_pallas.py:500"),
        "demod_count_taps": ("sdr_tpu_torch/csrc/demod.cu",
                             "sdr_tpu/kernels/demod_pallas.py:500"),
        "demod_sum_cl": ("sdr_tpu_torch/csrc/demod_cl.cu",
                         "sdr_tpu/kernels/demod_cl_pallas.py:727"),
        "fade_awgn": ("sdr_tpu_torch/csrc/channel.cu", "sdr_tpu/kernels/channel_pallas.py:80"),
        "demod_count_cl": ("sdr_tpu_torch/csrc/demod_cl.cu",
                           "sdr_tpu/kernels/demod_cl_pallas.py:741"),
    }
    kernels = [
        dict(name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
             launches=launches[name], **report[name])
        for name in sources
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
