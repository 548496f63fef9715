#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sdr_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository on a machine with a Hopper card:

    python3 chip_smoke.py

It builds the kernel library from ``sdr_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit), torch's
   version and the kernels' build time;
2. runs each kernel A–D against its plain torch version on the card at
   the slice's shapes and prints both times (CUDA events, after a
   warm-up, in turns plain, kernel, kernel, plain);
3. drives the keyed fast link (``fast_simulate``) at BASELINE config-2
   numerology (16-QAM, N = 256, CP = 64) with 8192 channels × 64
   symbols: AWGN at 10 dB against exact theory (within 5 %), flat
   Rayleigh at 12 dB (within 10 %), and channels [0, 4096) alone against
   the full run (identical counts);
4. times the channels-last demod-sum terminal at the headline bench's
   shape (32768 channels × 64 symbols) through ``demod_sum_chain_cl``;
5. checks that phases 3–4 launched every kernel (the launch counters are
   zeroed just before phase 3) and prints one JSON line per kernel set,
   then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits 1 before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


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
    del re, im, hr, hi, cnt, cnt_plain, idx, h, hs_r, hs_i
    torch.cuda.empty_cache()

    # D: channels-last demod-sum at the headline bench's shape (bench.py's
    # synthetic inputs: noise-like samples, Rayleigh h, 16-QAM at 12 dB).
    nv12 = 1.0 / (10.0 ** 1.2 * bps)
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

    def run_link(model, ebno_db, n_channels=B, ch=None):
        cfg = LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=N, cp_len=CP),
                         channel=ChannelConfig(model=model, ebno_db=ebno_db),
                         n_symbols=S, n_channels=n_channels)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if ch is None:
            errors, counted = fast.fast_simulate(cfg, seed, device=dev)
        else:
            errors, counted = fast.fast_core(cfg, seed, ch)
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
    del errors, counted, errors_r, counted_r, part

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
        "demod_count": ("sdr_tpu_torch/csrc/demod.cu", "sdr_tpu/kernels/demod_pallas.py:500"),
        "demod_sum_cl": ("sdr_tpu_torch/csrc/demod_cl.cu",
                         "sdr_tpu/kernels/demod_cl_pallas.py:727"),
    }
    kernels = [
        dict(name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
             launches=launches[name], **report[name])
        for name in ("payload", "tx", "demod_count", "demod_sum_cl")
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
