"""Command-line interface — the port's executable entry point (port of
``sdr_tpu/app/cli.py``).

  python -m sdr_tpu_torch demo      # terminal loopback demo (the GUI analog)
  python -m sdr_tpu_torch bench     # run a BASELINE.json config by name/index
  python -m sdr_tpu_torch sweep     # Eb/N0 BER sweep with checkpoint/resume
  python -m sdr_tpu_torch packet    # packet-modem campaign, IQ record/replay
  python -m sdr_tpu_torch adapt     # MCS calibration and an adaptive link
  python -m sdr_tpu_torch waveform  # PAPR/EVM/PSD report
  python -m sdr_tpu_torch autotune  # FFT backend crossover (--demod: the demod routes)
  python -m sdr_tpu_torch scale     # weak scaling over the ranks
  python -m sdr_tpu_torch info      # devices, versions, component inventory

Every subcommand takes ``--device {cuda,cpu}``: the card by default, the
CPU (the kernels' plain versions) only when asked. Without a card a
command fails unless ``--device cpu`` is given; nothing falls back.

The subcommands, flags, defaults, guards and JSON keys are the JAX
package's. The differences: a seed (``--seed``) keys the port's Philox
draws where the JAX cli builds a ``PRNGKey``; ``packet --record`` sends
its bursts as one batch and ``--replay`` decodes the frames as one batch;
``info`` reports torch's version, CUDA and the cards in place of the JAX
backend; ``autotune --demod`` times the port's demod routes. Under
``torchrun`` (more than one rank) ``bench --fast`` and ``bench`` on a
sharded case run over the ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _dev(args) -> str:
    return getattr(args, "device", "cuda")


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _cmd_demo(args) -> int:
    from sdr_tpu_torch.app.demo import DemoConfig, run_demo
    from sdr_tpu_torch.core.config import Modulation

    cfg = DemoConfig(
        n_fft=args.n_fft,
        cp_len=args.cp,
        modulation=Modulation(args.mod),
        ebno_db=args.ebno,
    )
    run_demo(
        cfg,
        frames=args.frames,
        interval_ms=args.interval,
        snapshot=getattr(args, "snapshot", None),
        device=_dev(args),
    )
    return 0


def _apply_mimo_flag(case, args):
    """Apply --mimo/--ntx/--nrx to a benchmark case (bench and sweep).

    Per-scheme antenna defaults; non-fading cases switch to flat
    Rayleigh (a MIMO channel needs an (n_rx, n_tx) matrix) and a NONE
    equalizer becomes MMSE (spatial mux needs a linear detector)."""
    if not getattr(args, "mimo", None):
        return case
    import dataclasses

    from sdr_tpu_torch.core.config import (
        ChannelModel as _CM,
        Equalizer as _Eq2,
        MIMOConfig,
        MIMOScheme,
    )

    scheme = MIMOScheme(args.mimo)
    n_tx = args.ntx if args.ntx else (1 if scheme == MIMOScheme.MRC else 2)
    n_rx = args.nrx if args.nrx else (
        2 if scheme == MIMOScheme.MRC
        else n_tx if scheme == MIMOScheme.SPATIAL_MUX
        else 1
    )
    ch = case.cfg.channel
    if ch.model in (_CM.AWGN, _CM.IDENTITY):
        ch = dataclasses.replace(ch, model=_CM.RAYLEIGH_FLAT)
    csi = getattr(args, "csi", "genie")
    detector = getattr(args, "detector", "linear")
    tag = f"+{scheme.value}{n_tx}x{n_rx}"
    if csi != "genie":
        tag += f"+{csi}"
    if detector != "linear":
        tag += f"+{detector}"
    return dataclasses.replace(
        case,
        name=case.name + tag,
        cfg=dataclasses.replace(
            case.cfg,
            channel=ch,
            mimo=MIMOConfig(
                scheme=scheme, n_tx=n_tx, n_rx=n_rx,
                csi=csi, detector=detector,
            ),
            equalizer=(
                case.cfg.equalizer
                if case.cfg.equalizer != _Eq2.NONE
                else _Eq2.MMSE
            ),
        ),
    )


def _run_sanity(args) -> int:
    """Replay the measurement-methodology checks as an automatic check:

    1. BATCH-AXIS SCAN before model fitting — measure the same kernel
       at batch B and 4B; if throughput has genuinely saturated the
       ratio is ~1, but a ratio well above 1 means any
       "asymptote"/serialization model fitted at B was a small-batch
       artifact.
    2. PROBE = WINDOW LABEL, NOT KERNEL BOUND — compare the kernel's
       implied streaming bandwidth (GS/s x 8 B/sample) against the
       memory probe (``obs.health.hbm_bandwidth_gbps``).

    The kernel is the ``fused`` demod route (kernel C's sum mode) at N
    256, CP 64. Prints ONE JSON line with both measurements and the two
    boolean lessons; exits 0 if the kernel still scales sanely with
    batch.
    """
    from sdr_tpu_torch.obs.autotune import tune_demod
    from sdr_tpu_torch.obs.health import hbm_bandwidth_gbps

    dev = _dev(args)
    b = int(getattr(args, "sanity_batch", 0) or 2048)
    n_syms = 64 if b >= 512 else 8
    backend = "fused"
    small = tune_demod(256, 64, batch=b, n_syms=n_syms, iters=4,
                       reps=2, backends=(backend,), device=dev)[0]
    large = tune_demod(256, 64, batch=4 * b, n_syms=n_syms, iters=4,
                       reps=2, backends=(backend,), device=dev)[0]
    if small.error or large.error:
        print(f"error: sanity bench failed: {small.error or large.error}",
              file=sys.stderr)
        return 2
    scaling = large.gs_per_s / max(small.gs_per_s, 1e-12)
    if scaling <= 0.8:
        # One retry before declaring a regression: a loaded host can
        # starve one of the two measurements; a REAL batch-scaling
        # regression reproduces.
        small2 = tune_demod(256, 64, batch=b, n_syms=n_syms, iters=4,
                            reps=2, backends=(backend,), device=dev)[0]
        large2 = tune_demod(256, 64, batch=4 * b, n_syms=n_syms, iters=4,
                            reps=2, backends=(backend,), device=dev)[0]
        if not (small2.error or large2.error):
            scaling2 = large2.gs_per_s / max(small2.gs_per_s, 1e-12)
            if scaling2 > scaling:
                small, large, scaling = small2, large2, scaling2
    try:
        probe = float(hbm_bandwidth_gbps(device=dev))
    except RuntimeError:
        # On the card a failed probe is a device fault: it propagates.
        if dev != "cpu":
            raise
        probe = -1.0
    implied_gbps = large.gs_per_s * 8.0
    out = {
        "sanity": True,
        "backend": backend,
        "batch_pair": [b, 4 * b],
        "gs_per_s": [small.gs_per_s, large.gs_per_s],
        "batch_scaling": scaling,
        # Lesson 1: if this is visibly > 1 the smaller batch was NOT
        # the asymptote — never fit ceilings without a batch scan.
        "small_batch_was_asymptote": scaling < 1.1,
        "hbm_probe_gbps": probe,
        "implied_stream_gbps": implied_gbps,
        # Lesson 2: kernel bandwidth above the probe == the probe is a
        # window label, not a bound on compute-path kernels.
        "probe_is_window_label_not_bound": implied_gbps > probe > 0,
    }
    print(json.dumps(out))
    # The hard gate: throughput must not REGRESS with batch (a real
    # regression, not window noise — 20% slack).
    return 0 if scaling > 0.8 else 1


def _counts(errors, counted):
    return errors.cpu().numpy(), counted.cpu().numpy()


def _cmd_bench(args) -> int:
    from sdr_tpu_torch.app.baseline_configs import baseline_cases, get_case
    from sdr_tpu_torch.link.ber import ber_awgn_exact
    from sdr_tpu_torch.core.config import ChannelModel, Equalizer

    if getattr(args, "sanity", False):
        return _run_sanity(args)

    if args.list:
        for i, c in enumerate(baseline_cases()):
            print(f"[{i}] {c.name}: {c.description}")
        return 0

    dev = _dev(args)
    if getattr(args, "config_file", None):
        from sdr_tpu_torch.app.baseline_configs import BaselineCase
        from sdr_tpu_torch.core.config import link_config_from_dict

        with open(args.config_file) as f:
            case = BaselineCase(
                name=args.config_file,
                description="user config file",
                cfg=link_config_from_dict(json.load(f)),
            )
    else:
        case = get_case(args.config)
    impaired = bool(getattr(args, "cfo", 0.0) or getattr(args, "timing_offset", 0))
    if impaired and args.coded:
        print(
            "error: --coded cannot be combined with --cfo/--timing-offset "
            "(the coded link has no acquisition front-end yet)",
            file=sys.stderr,
        )
        return 2
    pn = getattr(args, "phase_noise", 0.0)
    iq_gain = getattr(args, "iq_gain", 1.0)
    iq_phase = getattr(args, "iq_phase", 0.0)
    front_end = bool(pn) or iq_gain != 1.0 or iq_phase != 0.0
    if front_end:
        import dataclasses

        from sdr_tpu_torch.core.config import Equalizer as _Eq

        # Mixer impairments force pilot estimation (the LO's random
        # common phase and the compensator's residual direct gain are
        # unknowable to genie CSI) — same promotion as acquisition.
        tag = ("+pn" if pn else "") + (
            "+iq" if iq_gain != 1.0 or iq_phase != 0.0 else ""
        )
        case = dataclasses.replace(
            case,
            name=case.name + tag,
            cfg=dataclasses.replace(
                case.cfg,
                channel=dataclasses.replace(
                    case.cfg.channel,
                    phase_noise_std=pn,
                    iq_gain=iq_gain,
                    iq_phase_rad=iq_phase,
                ),
                pilot_spacing=case.cfg.pilot_spacing or 8,
                equalizer=(
                    case.cfg.equalizer
                    if case.cfg.equalizer != _Eq.NONE
                    else _Eq.MMSE
                ),
            ),
        )
    if impaired:
        import dataclasses

        # Acquisition mode: impairments force the blind S&C receiver
        # (link.pipeline's acquired link) and pilot estimation.
        case = dataclasses.replace(
            case,
            name=case.name + "+acquire",
            cfg=dataclasses.replace(
                case.cfg,
                channel=dataclasses.replace(
                    case.cfg.channel,
                    cfo_subcarriers=args.cfo,
                    timing_offset=args.timing_offset,
                ),
                pilot_spacing=case.cfg.pilot_spacing or 8,
                equalizer=(
                    case.cfg.equalizer
                    if case.cfg.equalizer != Equalizer.NONE
                    else Equalizer.MMSE
                ),
            ),
        )
    if getattr(args, "estimator", None):
        import dataclasses

        from sdr_tpu_torch.core.config import ChannelEstimator

        case = dataclasses.replace(
            case,
            cfg=dataclasses.replace(
                case.cfg, estimator=ChannelEstimator(args.estimator)
            ),
        )
    pa_ibo = getattr(args, "pa_ibo", None)
    spread = getattr(args, "dft_spread", False)
    if pa_ibo is not None or spread:
        import dataclasses

        try:
            cfg = case.cfg
            if spread:
                # An earlier acquisition/mixer promotion may have set a
                # COMB spacing; under dft_spread the spacing becomes a
                # pilot-SYMBOL period and must divide n_symbols.
                spacing = cfg.pilot_spacing
                while spacing > 1 and cfg.n_symbols % spacing:
                    spacing //= 2
                if cfg.pilot_spacing and spacing < 2:
                    print(
                        "error: no pilot-symbol period divides "
                        f"n_symbols={cfg.n_symbols}",
                        file=sys.stderr,
                    )
                    return 2
                cfg = dataclasses.replace(
                    cfg, dft_spread=True, pilot_spacing=spacing
                )
            if pa_ibo is not None:
                # The PA needs pilot estimation (Bussgang gain); promote
                # the case like the mixer impairments above. With
                # dft_spread the spacing is a SYMBOL period and must
                # divide n_symbols.
                spacing = cfg.pilot_spacing or 8
                if cfg.dft_spread:
                    while spacing > 1 and cfg.n_symbols % spacing:
                        spacing //= 2
                    if spacing < 2:
                        print(
                            "error: no pilot-symbol period divides "
                            f"n_symbols={cfg.n_symbols}",
                            file=sys.stderr,
                        )
                        return 2
                cfg = dataclasses.replace(
                    cfg,
                    channel=dataclasses.replace(
                        cfg.channel,
                        pa_ibo_db=pa_ibo,
                        pa_smoothness=getattr(args, "pa_p", 2.0),
                        pa_dpd=getattr(args, "pa_dpd", False),
                    ),
                    pilot_spacing=spacing,
                    equalizer=(
                        cfg.equalizer
                        if cfg.equalizer != Equalizer.NONE
                        else Equalizer.MMSE
                    ),
                )
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        tag = ("+scfdma" if spread else "") + (
            f"+pa{pa_ibo:g}dB" if pa_ibo is not None else ""
        )
        case = dataclasses.replace(case, name=case.name + tag, cfg=cfg)
    try:
        case = _apply_mimo_flag(case, args)
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    seed = args.seed
    world = _world()
    if getattr(args, "mc", 0):
        from sdr_tpu_torch.kernels.mc import supported as mc_ok
        from sdr_tpu_torch.link.mc import make_mc_fn

        if impaired or not mc_ok(case.cfg):
            print(
                "error: --mc needs an MC-supported config (pow2 n_fft >= 128, "
                "AWGN/Rayleigh/Rician/multipath/Jakes channel, no "
                "pilots/impairments)",
                file=sys.stderr,
            )
            return 2
        errors, counted = _counts(*make_mc_fn(case.cfg, iters=args.mc, device=dev)(seed))
        print(
            json.dumps(
                {
                    "case": case.name + "+mc",
                    "path": "fused Monte-Carlo kernel (keyed Philox)",
                    "iters": args.mc,
                    "bits": int(counted.sum()),
                    "bit_errors": int(errors.sum()),
                    "ber": float(errors.sum()) / float(counted.sum()),
                }
            )
        )
        return 0
    if getattr(args, "fast", False):
        if impaired or case.cfg.pilot_spacing or case.cfg.mimo is not None:
            print("error: --fast is the full-grid SISO throughput path "
                  "(no pilots, acquisition, or MIMO)", file=sys.stderr)
            return 2
        if world > 1 and case.cfg.n_channels % world == 0:
            from sdr_tpu_torch.parallel import make_link_mesh, make_sharded_fast_fn

            mesh = make_link_mesh(1, world)
            errors, counted = make_sharded_fast_fn(case.cfg, mesh, device=dev)(seed)
        else:
            from sdr_tpu_torch.link.fast import make_fast_fn

            errors, counted = make_fast_fn(case.cfg, device=dev)(seed)
        errors, counted = _counts(errors, counted)
        print(
            json.dumps(
                {
                    "case": case.name + "+fast",
                    "path": "fused-kernel fast link",
                    "bits": int(counted.sum()),
                    "bit_errors": int(errors.sum()),
                    "ber": float(errors.sum()) / float(counted.sum()),
                }
            )
        )
        return 0
    if args.coded:
        rate = getattr(args, "rate", "1/2")
        if getattr(args, "code", "conv") == "ldpc":
            from sdr_tpu_torch.link.coded import make_ldpc_fn

            errors, counted = make_ldpc_fn(
                case.cfg, rate=rate, iters=args.ldpc_iters, device=dev
            )(seed)
            code_desc = (
                f"QC-LDPC nb=24 Z=128 rate {rate}, offset min-sum "
                f"x{args.ldpc_iters} + interleaver"
            )
        elif getattr(args, "code", "conv") == "polar":
            from sdr_tpu_torch.link.coded import make_polar_fn, polar_code_for

            N_pc = getattr(args, "polar_n", 256)
            L_pc = getattr(args, "polar_list", 8)
            pc = polar_code_for(rate, N_pc)
            errors, counted = make_polar_fn(
                case.cfg, rate=rate, block_len=N_pc, list_size=L_pc, device=dev
            )(seed)
            code_desc = (
                f"polar ({N_pc},{pc.k}) GA construction, CA-SCL-{L_pc} "
                f"+ CRC-11 + interleaver (payload {pc.payload_len}/cw)"
            )
        else:
            from sdr_tpu_torch.link.coded import make_coded_fn

            errors, counted = make_coded_fn(case.cfg, rate=rate, device=dev)(seed)
            code_desc = f"conv K=7 (171,133) rate {rate} + interleaver"
        errors, counted = _counts(errors, counted)
        print(
            json.dumps(
                {
                    "case": case.name + "+fec",
                    "code": code_desc,
                    "info_bits": int(counted.sum()),
                    "bit_errors": int(errors.sum()),
                    "ber": float(errors.sum()) / float(counted.sum()),
                }
            )
        )
        return 0
    mesh_shape = _stream_mesh(case.cfg, world) if case.sharded and not impaired else None
    if mesh_shape is not None:
        # Acquisition mode lives in the per-channel pipeline; impaired
        # runs take the unsharded path below.
        from sdr_tpu_torch.parallel import make_link_mesh, make_sharded_stream_fn

        mesh = make_link_mesh(*mesh_shape)
        errors, counted = make_sharded_stream_fn(case.cfg, mesh, device=dev)(seed)
    else:
        from sdr_tpu_torch.link.pipeline import make_simulate_fn

        res = make_simulate_fn(case.cfg, device=dev)(seed)
        errors, counted = res.bit_errors, res.bits_counted
    errors, counted = _counts(errors, counted)
    ber = float(errors.sum()) / float(counted.sum())
    out = {
        "case": case.name,
        "bits": int(counted.sum()),
        "bit_errors": int(errors.sum()),
        "ber": ber,
        "per_channel_ber": (errors / np.maximum(counted, 1)).tolist()
        if args.per_channel
        else None,
    }
    if case.cfg.channel.model == ChannelModel.AWGN:
        out["ber_theory_awgn"] = ber_awgn_exact(
            case.cfg.modulation, case.cfg.channel.ebno_db
        )
    if (
        case.cfg.mimo is not None
        and case.cfg.channel.model == ChannelModel.RAYLEIGH_FLAT
    ):
        from sdr_tpu_torch.core.config import MIMOScheme
        from sdr_tpu_torch.link.ber import ber_alamouti_exact, ber_mrc_exact

        if case.cfg.mimo.scheme == MIMOScheme.ALAMOUTI:
            out["ber_theory_alamouti"] = ber_alamouti_exact(
                case.cfg.modulation, case.cfg.channel.ebno_db, case.cfg.mimo.n_rx
            )
        elif case.cfg.mimo.scheme == MIMOScheme.MRC:
            out["ber_theory_mrc"] = ber_mrc_exact(
                case.cfg.modulation, case.cfg.channel.ebno_db, case.cfg.mimo.n_rx
            )
    print(json.dumps(out))
    return 0


def _stream_mesh(cfg, n: int):
    """The (time, channel) mesh of a sharded case over ``n`` ranks, as the
    JAX cli shapes it (two time blocks where the rank count and the
    symbols allow, the largest channel axis that divides the channels),
    or None: one rank, or a shape that leaves ranks out (an awkward rank
    count: the JAX cli runs on a subset of devices, the port's meshes
    cover every rank, so every rank runs the unsharded link, whose keyed
    draws give the same counts)."""
    if n <= 1:
        return None
    n_time = 2 if n % 2 == 0 and cfg.n_symbols % 2 == 0 else 1
    cdev = max(d for d in range(1, n // n_time + 1) if cfg.n_channels % d == 0)
    return (n_time, cdev) if n_time * cdev == n else None


def _cmd_sweep(args) -> int:
    from sdr_tpu_torch.app.baseline_configs import get_case
    from sdr_tpu_torch.obs.sweep import ebno_sweep

    case = get_case(args.config)
    try:
        case = _apply_mimo_flag(case, args)
        if getattr(args, "dft_spread", False):
            import dataclasses

            case = dataclasses.replace(
                case,
                name=case.name + "+scfdma",
                cfg=dataclasses.replace(case.cfg, dft_spread=True),
            )
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    engine = getattr(args, "engine", "pipeline")
    if engine == "mc":
        from sdr_tpu_torch.kernels.mc import supported as mc_ok
        from sdr_tpu_torch.link.mc import _fde_mc_supported

        # Wideband SC-FDMA rides the fast engine per pass
        # (link.mc's wideband route) — same engine contract.
        if not (mc_ok(case.cfg) or _fde_mc_supported(case.cfg)):
            print(
                "error: --engine mc needs an MC-supported config "
                "(pow2 n_fft >= 128, AWGN/Rayleigh/multipath/Jakes, no pilots)",
                file=sys.stderr,
            )
            return 2
    if engine == "fast" and (
        case.cfg.pilot_spacing
        or case.cfg.channel.impaired
        or case.cfg.mimo is not None
    ):
        print(
            "error: --engine fast needs a full-grid SISO config "
            "(no pilots, timing/CFO impairments, or MIMO)",
            file=sys.stderr,
        )
        return 2
    grid = (
        [float(x) for x in args.ebno_grid.split(",")]
        if args.ebno_grid
        else list(case.ebno_sweep_db) or [0, 2, 4, 6, 8, 10]
    )
    code = getattr(args, "code", None)
    if code is not None and engine != "pipeline":
        print(
            "error: --code sweeps use the pipeline engine",
            file=sys.stderr,
        )
        return 2
    res = ebno_sweep(
        case.cfg,
        grid,
        args.seed,
        target_errors=args.target_errors,
        max_bits=args.max_bits,
        checkpoint_path=args.checkpoint,
        engine=engine,
        mc_iters=getattr(args, "mc_iters", 16),
        code=code,
        code_rate=getattr(args, "rate", "1/2"),
        progress=lambda p: print(
            f"# ebno={p.ebno_db:5.1f} dB  ber={p.ber:.3e}  "
            f"({p.bit_errors}/{p.bits_counted})",
            file=sys.stderr,
        ),
        device=_dev(args),
    )
    model = case.cfg.channel.model
    kf = case.cfg.channel.k_factor
    theory = res.theory(
        case.cfg.modulation, model, k_factor=kf, mimo=case.cfg.mimo
    )
    from sdr_tpu_torch.core.config import ChannelModel as _CM2, MIMOScheme as _MS

    if case.cfg.mimo is not None and case.cfg.mimo.scheme in (
        _MS.ALAMOUTI,
        _MS.MRC,
    ) and model == _CM2.RAYLEIGH_FLAT:
        theory_key = f"ber_theory_{case.cfg.mimo.scheme.value}"
    elif model.value.startswith("rayleigh"):
        theory_key = "ber_theory_rayleigh"
    elif model.value == "rician":
        theory_key = "ber_theory_rician"
    else:
        theory_key = "ber_theory_awgn"
    print(
        json.dumps(
            {
                "case": case.name,
                "config": res.config_summary,
                "ebno_db": res.ebnos().tolist(),
                "ber": res.bers().tolist(),
                theory_key: theory.tolist(),
            }
        )
    )
    if getattr(args, "plot", None):
        # After the results JSON — a plotting failure must never cost
        # the sweep's computed data.
        from sdr_tpu_torch.obs.plot import plot_sweep

        plot_sweep(res, case.cfg.modulation, args.plot,
                   channel_model=model, k_factor=kf, mimo=case.cfg.mimo)
        print(f"# BER curve written to {args.plot}", file=sys.stderr)
    return 0


def _cmd_autotune(args) -> int:
    from sdr_tpu_torch.obs.autotune import recommend_crossover, tune_fft

    if getattr(args, "demod", False):
        import dataclasses as _dc

        from sdr_tpu_torch.obs.autotune import tune_demod

        pts = tune_demod(
            n_fft=args.demod_nfft, cp_len=args.demod_cp, iters=args.iters, device=_dev(args)
        )
        ok = [p for p in pts if p.error is None]
        winner = max(ok, key=lambda p: p.gs_per_s).backend if ok else None
        print(json.dumps({
            "recommended_demod_route": winner,
            "points": [_dc.asdict(p) for p in pts],
        }))
        return 0

    sizes = [int(s) for s in args.sizes.split(",")]
    points = tune_fft(sizes=sizes, iters=args.iters, device=_dev(args))
    for p in points:
        print(
            f"# n={p.n:6d}  xla={p.xla_gelems:7.1f}  matmul={p.matmul_gelems:7.1f} "
            f"Gelem/s  -> {p.winner}",
            file=sys.stderr,
        )
    cross = recommend_crossover(points)
    print(
        json.dumps(
            {
                "matmul_min_n": cross,
                "points": [
                    {"n": p.n, "xla": p.xla_gelems, "matmul": p.matmul_gelems}
                    for p in points
                ],
            }
        )
    )
    return 0


def _cmd_scale(args) -> int:
    import dataclasses

    from sdr_tpu_torch.app.baseline_configs import get_case
    from sdr_tpu_torch.obs.scaling import weak_scaling

    case = get_case(args.config)
    counts = [int(x) for x in args.devices.split(",")] if args.devices else None
    # Per-rank channel count: shrink the case's channels to one shard.
    per_dev = max(case.cfg.n_channels // max(_world(), 1), 1)
    cfg = dataclasses.replace(case.cfg, n_channels=per_dev)
    points = weak_scaling(cfg, device_counts=counts, iters=args.iters, device=_dev(args))
    print(
        json.dumps(
            {
                "case": case.name,
                "points": [dataclasses.asdict(p) for p in points],
            }
        )
    )
    return 0


def _cmd_waveform(args) -> int:
    """Waveform-domain report for a case: PAPR percentiles + CCDF,
    aided/blind EVM at the case's Eb/N0, Welch-PSD in-band flatness.
    The bits and the noise are keyed Philox draws on the device (symbol
    i is channel id i)."""
    import torch

    from sdr_tpu_torch.app.baseline_configs import get_case
    from sdr_tpu_torch.core import prng
    from sdr_tpu_torch.obs.waveform import (
        evm_rms,
        papr_ccdf,
        papr_ccdf_theory,
        papr_db,
        psd_welch,
    )
    from sdr_tpu_torch.ops import channel as chan
    from sdr_tpu_torch.ops.modulation import modulate
    from sdr_tpu_torch.ops.ofdm import ofdm_tx

    dev = torch.device(_dev(args))
    case = get_case(args.config)
    cfg = case.cfg
    n_fft, cp = cfg.ofdm.n_fft, cfg.ofdm.cp_len
    bps = cfg.modulation.bits_per_symbol
    n_sym = args.symbols
    grid = torch.arange(4.0, 13.0, 0.5, dtype=torch.float32, device=dev)
    nv = float(chan.ebno_db_to_noise_var(cfg.channel.ebno_db, bps))
    nseg = min(n_fft, 512)

    ids = torch.arange(n_sym, dtype=torch.int32, device=dev)
    bits = prng.info_bits(args.seed, ids, 1, n_fft * bps)[:, 0]
    points = modulate(bits, cfg.modulation)
    tx = ofdm_tx(points, cp)
    p = papr_db(tx)
    rx = points + chan.cgauss(args.seed, prng.ROLE_NOISE, ids, (1, n_fft), var=nv)[:, 0]
    ccdf = papr_ccdf(p, grid).cpu().numpy()
    evm_aided = float(evm_rms(rx, cfg.modulation, ref_points=points))
    evm_blind = float(evm_rms(rx, cfg.modulation))
    psd = psd_welch(tx.reshape(-1), nperseg=nseg, overlap=nseg // 2).cpu().numpy()
    p = p.cpu().numpy()
    qs = np.percentile(p, [50.0, 99.0, 99.9])
    mid = psd[len(psd) // 10: -len(psd) // 10]
    g = grid.cpu().numpy()
    out = {
        "case": case.name,
        "n_symbols": n_sym,
        "papr_db": {"p50": float(qs[0]), "p99": float(qs[1]),
                    "p99.9": float(qs[2])},
        "evm_rms_pct": {"data_aided": 100 * evm_aided, "blind": 100 * evm_blind},
        "evm_theory_pct": 100 * float(nv) ** 0.5,
        "psd_inband_flatness_db": float(10 * np.log10(mid.max() / mid.min())),
        "ccdf_grid_db": [float(x) for x in g],
        "ccdf": [float(c) for c in ccdf],
    }
    if args.plot:
        from sdr_tpu_torch.obs.plot import plot_ber_curves

        plot_ber_curves(
            [(f"{case.name} measured ({n_sym} symbols)", g, ccdf)],
            args.plot,
            title=f"PAPR CCDF — {cfg.modulation.value}/{n_fft}sc OFDM",
            theory=(
                f"Gaussian theory 1-(1-e^-x)^{n_fft}",
                g,
                papr_ccdf_theory(n_fft)(g),
            ),
            xlabel="PAPR [dB]",
            ylabel="Pr[PAPR > x]",
        )
        print(f"# CCDF figure written to {args.plot}", file=sys.stderr)
    print(json.dumps(out))
    return 0


def _cmd_adapt(args) -> int:
    """Calibrate the MCS ladder on this device and (optionally) run an
    adaptive link over a shadowed SNR profile."""
    import dataclasses as _dc

    from sdr_tpu_torch.app.baseline_configs import get_case
    from sdr_tpu_torch.core.config import ChannelEstimator
    from sdr_tpu_torch.link.adapt import (
        DEFAULT_LADDER,
        calibrate,
        simulate_adaptive,
        waveform_ladder,
    )

    dev = _dev(args)
    case = get_case(args.config)
    cfg = case.cfg
    ladder = DEFAULT_LADDER
    ibo = getattr(args, "pa_ibo", None)
    if ibo is not None:
        # PA mode: the waveform becomes a ladder dimension — every rung
        # calibrates in OFDM and SC-FDMA twins under the configured
        # backoff (PA needs estimated CSI: pilots added).
        spacing = 8 if not cfg.n_symbols % 8 else 4
        cfg = _dc.replace(
            cfg,
            pilot_spacing=spacing,
            estimator=ChannelEstimator.DFT,
            channel=_dc.replace(cfg.channel, pa_ibo_db=float(ibo)),
        )
        ladder = waveform_ladder(DEFAULT_LADDER)
    table = calibrate(cfg, args.seed, target_ber=args.target_ber, ladder=ladder, device=dev)
    out = {
        "case": case.name,
        "target_ber": args.target_ber,
        "pa_ibo_db": ibo,
        "table": [
            {
                "modulation": t.modulation.value,
                "family": t.family,
                "rate": t.rate,
                "waveform": t.waveform,
                "efficiency_bits_per_use": t.efficiency,
                "esno_threshold_db": t.esno_db,
                "measured_ber_at_threshold": t.measured_ber,
            }
            for t in table
        ],
    }
    if args.profile:
        rng = np.random.default_rng(args.seed)
        profile = args.mean_snr + args.shadowing_std * rng.standard_normal(
            cfg.n_channels
        )
        res = simulate_adaptive(cfg, args.seed, profile, table,
                                margin_db=args.margin, device=dev)
        out["adaptive"] = {
            "mean_esno_db": args.mean_snr,
            "shadowing_std_db": args.shadowing_std,
            "achieved_efficiency": res["achieved_efficiency"],
            "silent_channels": res["silent_channels"],
            "families_used": sorted(
                {f for f in res["family_per_channel"] if f}
            ),
            "waveforms_used": sorted(
                {w for w in res.get("waveform_per_channel", []) if w}
            ),
            "info_ber": float(res["bit_errors"].sum())
            / max(int(res["info_bits"].sum()), 1),
        }
    print(json.dumps(out))
    return 0


def _cmd_packet(args) -> int:
    """Packet-modem campaign: keyed payloads over an impaired channel
    through the blind receiver; reports PER and CRC statistics. With
    ``--record`` the n bursts go over the channel as one batch and each
    frame (delay + burst + one symbol) is written to an SC16 file in
    packet order, then decoded back from disk; ``--replay`` decodes a
    recorded file. Either way the frames decode as one batch and are
    held against the same keyed payloads."""
    import torch

    from sdr_tpu_torch.core.config import ChannelConfig, ChannelModel, Modulation, OFDMConfig
    from sdr_tpu_torch.link.packet import PacketConfig, simulate_packets

    dev = _dev(args)
    try:
        pcfg = PacketConfig(
            payload_bytes=args.payload,
            modulation=Modulation(args.mod),
            ofdm=OFDMConfig(n_fft=args.n_fft, cp_len=args.cp),
            rate=args.rate,
            pilot_spacing=args.pilots,
            fec=getattr(args, "code", "conv"),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    ch = ChannelConfig(
        model=ChannelModel(args.channel),
        ebno_db=args.ebno,
        pdp=(
            (1.0, 0.5)
            if args.channel in ("multipath", "multipath_time")
            else (1.0,)
        ),
        doppler_norm=getattr(args, "doppler", 0.01),
        cfo_subcarriers=args.cfo,
        timing_offset=args.timing_offset,
    )
    source = None
    if getattr(args, "record", None) or getattr(args, "replay", None):
        from sdr_tpu_torch.link.packet import (
            decode_packet,
            draw_payload,
            encode_packet,
            noise_var,
            transmit_over_channel,
        )
        from sdr_tpu_torch.native.iq import IQReader, write_iq

        frame = ch.timing_offset + pcfg.burst_len + pcfg.ofdm.symbol_len
        nv = noise_var(pcfg, ch)
        ids = torch.arange(args.n, dtype=torch.int32, device=dev)
        payload = draw_payload(pcfg, args.seed, ids)
        if args.record:
            stream, _ = transmit_over_channel(
                pcfg, ch, args.seed, encode_packet(pcfg, payload), ids
            )
            write_iq(args.record, stream.cpu().numpy().reshape(-1))
            del stream
            print(f"# recorded {args.n} bursts ({frame} samples each) "
                  f"to {args.record}", file=sys.stderr)
        path = args.replay or args.record
        try:
            rd = IQReader(path, frame=frame)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        frames = []
        with rd:
            for _ in range(args.n):
                nxt = rd.next_real()
                if nxt is None:
                    break
                frames.append(nxt)
        if not frames:
            print(
                f"error: no {frame}-sample frames in {path} (wrong file, "
                "or recorded with different packet/channel settings)",
                file=sys.stderr,
            )
            return 2
        rx_stream = torch.complex(
            *(torch.from_numpy(np.stack([f[k] for f in frames])) for k in (0, 1))
        ).to(dev)
        rx, ok = decode_packet(pcfg, rx_stream, nv)
        byte_errs = (rx != payload[: len(frames)]).sum(dim=1).cpu().numpy()
        crc_ok = ok.cpu().numpy()
        source = f"iq_file:{path}"
        args.n = len(frames)
    else:
        byte_errs, crc_ok = simulate_packets(pcfg, ch, args.seed, args.n, device=dev)
        byte_errs = byte_errs.cpu().numpy()
        crc_ok = crc_ok.cpu().numpy()
    print(json.dumps({
        "source": source or "simulated",
        "payload_bytes": pcfg.payload_bytes,
        "modulation": pcfg.modulation.value,
        "rate": pcfg.rate,
        "n_symbols": pcfg.n_symbols,
        "burst_samples": pcfg.burst_len,
        "channel": ch.model.value,
        "ebno_db": ch.ebno_db,
        "cfo_subcarriers": ch.cfo_subcarriers,
        "timing_offset": ch.timing_offset,
        "packets": int(args.n),
        "per": float((byte_errs > 0).mean()),
        "crc_ok_rate": float(crc_ok.mean()),
        "crc_verdicts_consistent": bool(
            (crc_ok == (byte_errs == 0)).all()
        ),
        "byte_error_rate": float(byte_errs.sum())
        / float(args.n * pcfg.payload_bytes),
    }))
    return 0


def _cmd_info(args) -> int:
    import torch

    from sdr_tpu_torch import __version__
    from sdr_tpu_torch.core.config import Modulation
    from sdr_tpu_torch.ops.fft import get_default_backend

    cards = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
             if _dev(args) == "cuda" else [])
    info = {
        "version": __version__,
        "torch_version": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": cards or ["cpu"],
        "fft_backend": get_default_backend(),
        "modulations": [m.value for m in Modulation],
        "demod_backends": ["fused (kernel C)", "fused:bf16 (bf16 sample planes)",
                           "hybrid (torch FFT + kernel C post-FFT)",
                           "cl (kernel D/F, channels-last)", "cl:bf16 (bf16 sample planes)"],
        "channels": ["identity", "awgn", "rayleigh_flat", "rician (K-factor)",
                     "multipath", "rayleigh_time (Jakes)", "multipath_time (TDL)",
                     "rx LO phase noise (Wiener walk)"],
        "receiver": ["ZF/MMSE equalizers", "max-log LLR",
                     "comb pilots (LS / per-symbol / phase-tracked / "
                     "DFT-subspace)",
                     "blind acquisition (S&C + integer CFO + fine timing)",
                     "blind I/Q-image cancellation (properization)"],
        "mimo": ["Alamouti G2 STBC", "receive MRC",
                 "spatial mux (ZF / MMSE / SIC / max-log joint ML)",
                 "genie or time-orthogonal-preamble CSI",
                 "composes with FEC and channel DP"],
        "waveforms": ["CP-OFDM",
                      "SC-FDMA / DFT-spread (block ZC pilots, SC-FDE "
                      "on every engine, composes with all impairments "
                      "and MIMO)"],
        "fec": ["conv K=7 (171,133)", "rates 1/2, 2/3, 3/4 (802.11a "
                "puncturing)", "soft Viterbi", "block interleaver",
                "QC-LDPC (nb=24, Z=128) + offset min-sum (kernel H)",
                "CA-polar (GA construction, CRC-11, SC-list decode)",
                "mixed-family adaptive MCS ladder",
                "packet modem carries any family"],
        "parallelism": ["channel DP", "time-block SP (halo send/recv)",
                        "subcarrier TP (all_to_all)",
                        "2-stage PP (microbatched)",
                        "kernels on every rank",
                        "multi-process torch.distributed (nccl / gloo)"],
        "observability": ["JSONL metrics", "profiler traces", "health probe",
                          "checkpointed sweeps + BER figures",
                          "waveform PAPR/EVM/PSD report",
                          "demod roofline", "demod route autotune"],
    }
    print(json.dumps(info, indent=2))
    return 0


def _add_device(parser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the command runs: the card (default), or the CPU's plain "
        "versions of the kernels",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sdr_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="terminal loopback demo")
    d.add_argument("--frames", type=int, default=100)
    d.add_argument("--interval", type=float, default=50.0, help="ms per frame")
    d.add_argument("--n-fft", type=int, default=8)
    d.add_argument("--cp", type=int, default=8)
    d.add_argument("--mod", default="16qam")
    d.add_argument("--ebno", type=float, default=None, help="AWGN Eb/N0 dB (default: identity loopback)")
    d.add_argument("--snapshot", default=None,
                   help="write the final time/constellation views to a figure (PNG/SVG)")
    _add_device(d)
    d.set_defaults(fn=_cmd_demo)

    b = sub.add_parser("bench", help="run a BASELINE config")
    b.add_argument("--config", default="0", help="case name or index 0-4")
    b.add_argument("--config-file", default=None,
                   help="JSON LinkConfig file (overrides --config)")
    b.add_argument("--list", action="store_true")
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--per-channel", action="store_true")
    b.add_argument(
        "--cfo", type=float, default=0.0,
        help="carrier frequency offset in subcarrier spacings (enables "
        "blind acquisition: S&C preamble + CFO recovery + fine timing)",
    )
    b.add_argument(
        "--timing-offset", type=int, default=0,
        help="unknown frame delay in samples (enables blind acquisition)",
    )
    b.add_argument(
        "--phase-noise", type=float, default=0.0, metavar="STD",
        help="RX-LO Wiener phase noise, per-sample increment std in rad "
        "(enables comb pilots with per-symbol phase tracking)",
    )
    b.add_argument(
        "--iq-gain", type=float, default=1.0, metavar="G",
        help="RX I/Q amplitude mismatch ratio (1 = matched; enables the "
        "blind properization compensator + comb pilots)",
    )
    b.add_argument(
        "--iq-phase", type=float, default=0.0, metavar="RAD",
        help="RX I/Q phase skew in radians (0 = matched)",
    )
    b.add_argument(
        "--estimator", default=None, choices=["ls", "dft"],
        help="pilot channel-estimation backend (dft = CP-subspace "
        "denoising; only meaningful with a pilot config)",
    )
    b.add_argument(
        "--mimo", default=None, choices=["alamouti", "mrc", "mux"],
        help="multi-antenna mode (ops.mimo): Alamouti 2-TX STBC, "
        "receive MRC, or spatial multiplexing with linear ZF/MMSE; "
        "non-fading cases switch to flat Rayleigh (genie CSI)",
    )
    b.add_argument(
        "--ntx", type=int, default=0, metavar="N",
        help="TX antennas (default: per-scheme — 2 STBC/mux, 1 MRC)",
    )
    b.add_argument(
        "--nrx", type=int, default=0, metavar="N",
        help="RX antennas (default: per-scheme — 1 STBC, 2 MRC, ntx mux)",
    )
    b.add_argument(
        "--csi", default="genie", choices=["genie", "preamble"],
        help="MIMO receiver CSI: perfect, or estimated from n_tx "
        "time-orthogonal pilot symbols (LS; --estimator dft denoises)",
    )
    b.add_argument(
        "--detector", default="linear", choices=["linear", "sic", "ml"],
        help="spatial-mux detector: linear (ZF/MMSE per the case "
        "equalizer) or max-log joint ML (optimal, full diversity)",
    )
    b.add_argument(
        "--coded", action="store_true",
        help="run the FEC-coded link (conv K=7 + soft Viterbi) over the case",
    )
    b.add_argument(
        "--rate", default="1/2", choices=["1/2", "2/3", "3/4"],
        help="FEC code rate via 802.11a puncturing (with --coded)",
    )
    b.add_argument(
        "--code", default="conv", choices=["conv", "ldpc", "polar"],
        help="FEC family for --coded: convolutional+Viterbi, "
             "QC-LDPC+min-sum, or polar+CA-SCL (rates via --rate on any)",
    )
    b.add_argument(
        "--ldpc-iters", type=int, default=25,
        help="min-sum iterations for --code ldpc",
    )
    b.add_argument(
        "--polar-n", type=int, default=256,
        help="polar block length (power of 2, with --code polar)",
    )
    b.add_argument(
        "--polar-list", type=int, default=8,
        help="CA-SCL list size (with --code polar)",
    )
    b.add_argument(
        "--sanity", action="store_true",
        help="replay the measurement-methodology checks (batch-axis "
        "scaling + probe-vs-kernel bandwidth) and print one JSON line",
    )
    b.add_argument(
        "--sanity-batch", type=int, default=0,
        help="base batch for --sanity (default 2048; the check runs "
        "the pair [B, 4B])",
    )
    b.add_argument(
        "--pa-ibo", type=float, default=None, metavar="DB",
        help="TX Rapp PA input backoff in dB (promotes the case to "
        "pilot estimation — the estimate absorbs the Bussgang gain)",
    )
    b.add_argument(
        "--pa-p", type=float, default=2.0,
        help="Rapp smoothness p (with --pa-ibo; large p = hard limiter)",
    )
    b.add_argument(
        "--pa-dpd", action="store_true",
        help="ideal digital predistortion ahead of the PA (with --pa-ibo)",
    )
    b.add_argument(
        "--dft-spread", action="store_true",
        help="SC-FDMA waveform: DFT-precode the data (low-PAPR, the "
        "PA-friendly uplink choice); pilots become time-multiplexed "
        "Zadoff-Chu symbols",
    )
    b.add_argument(
        "--fast", action="store_true",
        help="run the fused-kernel throughput path (link.fast; sharded "
        "over all ranks when the channel count divides)",
    )
    b.add_argument(
        "--mc", type=int, default=0, metavar="ITERS",
        help="run ITERS passes of the one-kernel Monte-Carlo link "
        "(kernel G, keyed Philox; statistical path)",
    )
    _add_device(b)
    b.set_defaults(fn=_cmd_bench)

    s = sub.add_parser("sweep", help="Eb/N0 BER sweep")
    s.add_argument("--config", default="1")
    s.add_argument("--ebno-grid", default=None, help="comma-separated dB list")
    s.add_argument("--target-errors", type=int, default=500)
    s.add_argument("--max-bits", type=int, default=20_000_000)
    s.add_argument("--checkpoint", default=None, help="JSON checkpoint path (resume)")
    s.add_argument("--plot", default=None, help="write a BER-curve figure (PNG/SVG path)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument(
        "--engine", default="pipeline", choices=["pipeline", "fast", "mc"],
        help="fast = fused-kernel link (full-grid configs); mc = the "
        "one-kernel Monte-Carlo link (kernel G; orders faster per bit)",
    )
    s.add_argument(
        "--dft-spread", action="store_true",
        help="sweep the SC-FDMA waveform (full-grid on fast/mc "
        "engines — SC-FDE receive; block pilots on pipeline)",
    )
    s.add_argument(
        "--code", default=None, choices=["conv", "ldpc", "polar"],
        help="CODED BER sweep: count decoded info bits through the "
        "chosen FEC family (pipeline engine only)",
    )
    s.add_argument(
        "--rate", default="1/2", choices=["1/2", "2/3", "3/4"],
        help="FEC rate for --code",
    )
    s.add_argument(
        "--mimo", default=None, choices=["alamouti", "mrc", "mux"],
        help="multi-antenna sweep (exact diversity theory overlay for "
        "alamouti/mrc over flat Rayleigh)",
    )
    s.add_argument("--ntx", type=int, default=0, metavar="N")
    s.add_argument("--nrx", type=int, default=0, metavar="N")
    s.add_argument("--csi", default="genie", choices=["genie", "preamble"])
    s.add_argument("--detector", default="linear", choices=["linear", "sic", "ml"])
    s.add_argument("--mc-iters", type=int, default=16,
                   help="MC kernel passes per sweep invocation")
    _add_device(s)
    s.set_defaults(fn=_cmd_sweep)

    i = sub.add_parser("info", help="environment and inventory")
    _add_device(i)
    i.set_defaults(fn=_cmd_info)

    ad = sub.add_parser(
        "adapt", help="calibrate MCS thresholds; optional adaptive run"
    )
    ad.add_argument("--config", default="0", help="numerology template case")
    ad.add_argument("--target-ber", type=float, default=1e-4)
    ad.add_argument("--seed", type=int, default=0)
    ad.add_argument("--profile", action="store_true",
                    help="also run an adaptive link over a lognormal-"
                    "shadowed SNR profile")
    ad.add_argument("--mean-snr", type=float, default=12.0, metavar="DB")
    ad.add_argument("--pa-ibo", type=float, default=None, metavar="DB",
                    help="enable a Rapp PA at this input backoff; the "
                         "ladder gains the OFDM/SC-FDMA waveform "
                         "dimension")
    ad.add_argument("--shadowing-std", type=float, default=6.0, metavar="DB")
    ad.add_argument("--margin", type=float, default=0.0,
                    help="selection backoff margin in dB")
    _add_device(ad)
    ad.set_defaults(fn=_cmd_adapt)

    pk = sub.add_parser(
        "packet", help="bytes-over-the-air packet modem campaign (PER)"
    )
    pk.add_argument("--payload", type=int, default=64, help="bytes per packet")
    pk.add_argument("--mod", default="qpsk")
    pk.add_argument("--n-fft", type=int, default=64)
    pk.add_argument("--cp", type=int, default=16)
    pk.add_argument("--rate", default="1/2", choices=["1/2", "2/3", "3/4"])
    pk.add_argument(
        "--code", default="conv", choices=["conv", "ldpc", "polar"],
        help="packet FEC family (LDPC bursts quantize up to the "
        "3072-bit codeword)",
    )
    pk.add_argument("--pilots", type=int, default=8, help="comb pilot spacing")
    pk.add_argument(
        "--channel", default="multipath",
        choices=["awgn", "rayleigh_flat", "rician", "multipath",
                 "multipath_time"],
    )
    pk.add_argument("--doppler", type=float, default=0.01,
                    help="normalized Doppler fd*T_sym (multipath_time)")
    pk.add_argument("--ebno", type=float, default=14.0)
    pk.add_argument("--cfo", type=float, default=1.3,
                    help="carrier offset in subcarriers (blind-recovered)")
    pk.add_argument("--timing-offset", type=int, default=37,
                    help="unknown burst delay in samples")
    pk.add_argument("--n", type=int, default=100, help="packets to send")
    pk.add_argument("--seed", type=int, default=0)
    pk.add_argument(
        "--record", default=None, metavar="FILE.sc16",
        help="record the impaired bursts to a raw int16 IQ file via the "
        "native runtime, then decode them back from disk",
    )
    pk.add_argument(
        "--replay", default=None, metavar="FILE.sc16",
        help="decode packets from a previously recorded IQ file "
        "(same --seed/--n regenerate the expected payloads)",
    )
    _add_device(pk)
    pk.set_defaults(fn=_cmd_packet)

    wf = sub.add_parser(
        "waveform", help="PAPR/EVM/PSD waveform report for a case"
    )
    wf.add_argument("--config", default="2", help="case name or index 0-4")
    wf.add_argument("--symbols", type=int, default=4096)
    wf.add_argument("--seed", type=int, default=0)
    wf.add_argument("--plot", default=None,
                    help="write a PAPR-CCDF figure (PNG/SVG path)")
    _add_device(wf)
    wf.set_defaults(fn=_cmd_waveform)

    a = sub.add_parser("autotune", help="measure FFT backend crossover on this device")
    a.add_argument("--sizes", default="128,256,512,1024,2048,4096,8192,16384")
    a.add_argument("--iters", type=int, default=20)
    a.add_argument("--demod", action="store_true",
                   help="A/B the demod routes instead of the FFT backends")
    a.add_argument("--demod-nfft", type=int, default=4096)
    a.add_argument("--demod-cp", type=int, default=512)
    _add_device(a)
    a.set_defaults(fn=_cmd_autotune)

    w = sub.add_parser("scale", help="weak-scaling samples/s over the ranks")
    w.add_argument("--config", default="3")
    w.add_argument("--devices", default=None, help="comma list, e.g. 1,2,4,8")
    w.add_argument("--iters", type=int, default=10)
    _add_device(w)
    w.set_defaults(fn=_cmd_scale)
    return p


def _init_ranks(device: str) -> None:
    """Under ``torchrun`` (WORLD_SIZE > 1 in the environment) join the
    process group: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        from sdr_tpu_torch.parallel import init_multihost

        init_multihost("nccl" if device == "cuda" else "gloo")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if _dev(args) == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: no CUDA card is available; the command runs on the card unless "
                  "--device cpu is given", file=sys.stderr)
            return 1
    _init_ranks(_dev(args))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
