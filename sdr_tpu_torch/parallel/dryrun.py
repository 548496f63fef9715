"""The parallel layer run end to end: a launcher and ``dryrun_multichip``
(port of ``__graft_entry__.py::dryrun_multichip``).

``spawn(world, fn, args)`` starts ``world`` rank processes by the
``spawn`` start method (never fork: a parent that has touched CUDA
cannot fork), joins them into one process group over a rendezvous file
in a fresh temporary directory, runs ``fn(rank, world, *args)`` on each
and returns the per-rank results. A rank that fails or hangs past
``timeout`` ends the whole group: every rank is killed, and the call
raises. ``fn`` must be importable from this package: a spawned child
imports ``torch`` and ``sdr_tpu_torch`` only.

``run_cases(rank, world, device, cases)`` is the rank function of the
dryrun and of the CPU tests: each case is a dict naming a sharded entry
point, its configuration, its mesh (n_time, n_channel) and its inputs.
Rank 0 holds each sharded result against the unsharded port on the same
device (bit-exact for the data-parallel, pipelined and stream rows; LLRs
within 1e-4 of their peak with equal signs for TP; a stream also against
``pipeline.simulate``, equal, under Jakes fading but for bits whose
|LLR| < 1e-3). Every
rank returns what it got (counts, and a checksum of TP planes), so that
the caller can check that all ranks hold the same result, and each row's
wall time (host clock between two barriers, after one warm-up call when
``warm``).

``dryrun_multichip(world, device)`` runs the rows of BASELINE configs 4
and 5 at full width over ``world`` gloo ranks and prints one line per
row, as the JAX function does — the time-block stream with its halo, the
TDL stream and the 2 × 2 ML MIMO link among them. Ranks that share one card measure nothing
about scaling: their wall times are marked so.
"""

from __future__ import annotations

import math
import multiprocessing as _mp
import os
import queue as _queue
import tempfile
import time
import traceback

import numpy as np
import torch

from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelEstimator,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOConfig,
    MIMOScheme,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.kernels import demod as _kc
from sdr_tpu_torch.link import coded, fast, fast_coded, pipeline
from sdr_tpu_torch.link.stream import exact_at_seams, stream_simulate
from sdr_tpu_torch.link.ber import ber_awgn_exact, ber_given_gain
from sdr_tpu_torch.link.mc import mc_simulate
from sdr_tpu_torch.parallel import _comm
from sdr_tpu_torch.parallel.distributed import init_multihost, resolve_device
from sdr_tpu_torch.parallel.mesh import make_link_mesh
from sdr_tpu_torch.parallel.pp import make_pipelined_fast_fn
from sdr_tpu_torch.parallel.shard import (
    coded_family_kw,
    make_sharded_coded_fast_fn,
    make_sharded_coded_fn,
    make_sharded_fast_fn,
    make_sharded_mc_fn,
    make_sharded_mc_inject_fn,
    make_sharded_simulate_fn,
    make_sharded_stream_fn,
)
from sdr_tpu_torch.parallel.tp import make_tp_demod_fn

SHARED_CARD = "ranks sharing one card, gloo through the host: not a scaling figure"


# ---- the launcher ------------------------------------------------------------

def _rank_main(rank, world, backend, init_method, fn, args, results):
    try:
        torch.set_num_threads(1)
        init_multihost(backend, init_method, world_size=world, rank=rank)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn, args=(), backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    ``backend`` group; returns the results in rank order. Raises if a
    rank raises, dies or the group outlives ``timeout`` seconds; every
    rank process has ended when this returns or raises."""
    ctx = _mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="sdr_rdv_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, init_method, fn, args, results),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: ranks {sorted(set(range(world)) - set(got))} "
                                       f"did not finish within {timeout:g} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except _queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode]
                    if dead:
                        raise RuntimeError(f"spawn: rank(s) {dead} died with exit codes "
                                           f"{[procs[r].exitcode for r in dead]}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
                got[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == world else 0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world)]


# ---- the cases ---------------------------------------------------------------

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(call, dev, mesh, warm: bool, launches: dict):
    """(result, wall ms) of ``call()`` between two barriers of the mesh;
    the kernel launches of the call (and of its warm-up) are added to
    ``launches``, and no others: rank 0's references run outside."""
    _lib.reset_launches()
    if warm:
        call()
    _sync(dev)
    _comm.barrier(mesh.world_group)
    t0 = time.perf_counter()
    out = call()
    _sync(dev)
    _comm.barrier(mesh.world_group)
    ms = (time.perf_counter() - t0) * 1e3
    for k, v in _lib.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    return out, ms


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _counts(case, mesh, dev, sharded, reference):
    """A row whose result is a per-channel (errors, counted) pair."""
    launches = {}
    (errors, counted), ms = _timed(sharded, dev, mesh, case.get("warm", False), launches)
    res = dict(errors=_np(errors), counted=_np(counted), ms=ms, launches=launches)
    if mesh.rank == 0 and reference is not None:
        ref_e, ref_c = reference()
        res["exact"] = bool(torch.equal(errors, ref_e) and torch.equal(counted, ref_c))
    return res


def _fast(case, mesh, dev):
    cfg, seed, layout = case["cfg"], case["seed"], case.get("layout", "auto")
    fn = make_sharded_fast_fn(cfg, mesh, layout=layout, device=dev)
    return _counts(case, mesh, dev, lambda: fn(seed),
                   lambda: fast.fast_simulate(cfg, seed, device=dev, layout=layout))


def _simulate(case, mesh, dev):
    cfg, seed = case["cfg"], case["seed"]
    fn = make_sharded_simulate_fn(cfg, mesh, device=dev)

    def reference():
        res = pipeline.simulate(cfg, seed, device=dev)
        return res.bit_errors, res.bits_counted

    return _counts(case, mesh, dev, lambda: fn(seed), reference)


def _stream(case, mesh, dev):
    """The sharded stream against the unsharded one (``exact``) and, on
    rank 0, against ``pipeline.simulate``: per channel equal, but for the
    bits whose |LLR| < 1e-3 under Jakes fading (``vs_simulate``,
    ``allowed``; ``link.stream.exact_at_seams``)."""
    cfg, seed, n_blocks = case["cfg"], case["seed"], case["n_blocks"]
    fn = make_sharded_stream_fn(cfg, mesh, n_blocks=n_blocks, device=dev)
    res = _counts(case, mesh, dev, lambda: fn(seed),
                  lambda: stream_simulate(cfg, seed, n_blocks, device=dev))
    if mesh.rank == 0:
        errors = pipeline.simulate(cfg, seed, device=dev).bit_errors
        if exact_at_seams(cfg):
            margin = torch.zeros_like(errors)
        else:
            llrs = pipeline.simulate(cfg, seed, device=dev, want_llrs=True).llrs
            margin = (llrs.abs() < 1e-3).sum(dim=(1, 2))
            del llrs
        diff = (torch.as_tensor(res["errors"], device=dev) - errors).abs()
        res["vs_simulate"] = int(diff.max())
        res["allowed"] = int(margin.max())
        res["within"] = bool((diff <= margin).all())
    return res


def _pp(case, mesh, dev):
    cfg, seed = case["cfg"], case["seed"]
    fn = make_pipelined_fast_fn(cfg, mesh, n_micro=case["n_micro"], device=dev)
    return _counts(case, mesh, dev, lambda: fn(seed),
                   lambda: fast.fast_simulate(cfg, seed, device=dev))


def _coded_fast(case, mesh, dev):
    cfg, seed = case["cfg"], case["seed"]
    kw = dict(rate=case.get("rate", "1/2"), schedule=case.get("schedule", "flooding"),
              seam=case.get("seam", "auto"))
    fn = make_sharded_coded_fast_fn(cfg, mesh, ldpc_iters=case.get("iters", 25), device=dev,
                                    **kw)
    return _counts(case, mesh, dev, lambda: fn(seed),
                   lambda: fast_coded.ldpc_fast_simulate(cfg, seed, iters=case.get("iters", 25),
                                                         device=dev, **kw))


def _coded(case, mesh, dev):
    """A coded link of ``link.coded`` (``code``: conv, ldpc or polar)
    against the family's unsharded link."""
    cfg, seed, code, rate = case["cfg"], case["seed"], case["code"], case.get("rate", "1/2")
    kw = dict(ldpc_iters=case.get("iters", 25), polar_n=case.get("polar_n", 256),
              polar_list=case.get("polar_list", 8))
    fn = make_sharded_coded_fn(cfg, mesh, code=code, rate=rate, device=dev, **kw)
    return _counts(case, mesh, dev, lambda: fn(seed),
                   lambda: coded.make_family_fn(cfg, code, rate=rate, device=dev,
                                                **coded_family_kw(code, **kw))(seed))


def _mc(case, mesh, dev):
    fn = make_sharded_mc_fn(case["cfg"], mesh, iters=case.get("iters", 1), device=dev)
    return _counts(case, mesh, dev, lambda: fn(case["seed"]), None)


def _inject_draws(cfg: LinkConfig, seed: int, device):
    """Monte-Carlo ``rand_inputs`` (idx, nr, ni, hr, hi) for ``cfg``,
    drawn by a torch generator on ``device`` from ``seed`` (the same on
    every rank): indices, N(0, 1) noise planes and a Rayleigh response
    per link and tone."""
    B, S, N = cfg.n_channels, cfg.n_symbols, cfg.ofdm.n_fft
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, 1 << cfg.modulation.bits_per_symbol, (B, S, N), generator=gen,
                        device=device, dtype=torch.int32)
    nr, ni = (torch.randn((B, S, N), generator=gen, device=device) for _ in range(2))
    hr, hi = (torch.randn((B, 1, N), generator=gen, device=device) * math.sqrt(0.5)
              for _ in range(2))
    return idx, nr, ni, hr, hi


def _mc_inject(case, mesh, dev):
    cfg = case["cfg"]
    if "rand" in case:
        rand = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in case["rand"])
        rand = (rand[0].to(torch.int32),) + tuple(a.to(torch.float32) for a in rand[1:])
    else:
        rand = _inject_draws(cfg, case["rand_seed"], dev)
    fn = make_sharded_mc_inject_fn(cfg, mesh, device=dev)
    return _counts(case, mesh, dev, lambda: fn(*rand),
                   lambda: mc_simulate(cfg, 0, iters=1, device=dev, rand_inputs=rand))


def _tp(case, mesh, dev):
    """TP demod on explicit planes (``planes``, ``noise_vars``) or on a
    real link (``cfg``, ``seed``: ``tx_channel_core`` and the channel
    plane of its taps)."""
    cfg = case.get("cfg")
    if cfg is not None:
        n_fft, cp, mod = cfg.ofdm.n_fft, cfg.ofdm.cp_len, cfg.modulation
        ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=dev)
        re, im = fast.tx_channel_core(cfg, case["seed"], ids)
        h, _ = fast.fade_state(cfg, case["seed"], ids)
        h = h.to(torch.complex64).expand(cfg.n_channels, h.shape[1], n_fft)
        hr, hi = h.real.contiguous(), h.imag.contiguous()
        nvs = [fast.noise_var(cfg)]
    else:
        n_fft, cp, mod = case["n_fft"], case["cp"], case["mod"]
        re, im, hr, hi = (torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                          device=dev) for a in case["planes"])
        nvs = case["noise_vars"]
    fn = make_tp_demod_fn(n_fft, cp, mod, mesh, axis=case.get("axis", "time"), device=dev)
    res = dict(ms=[], digest=[], llr=[], max_err=[], peak=[], sign_diff=[], launches={})
    for nv in nvs:
        llr, ms = _timed(lambda: fn(re, im, hr, hi, nv), dev, mesh, case.get("warm", False),
                         res["launches"])
        res["ms"].append(ms)
        res["digest"].append(float(llr.double().sum()))
        if case.get("return_output"):
            res["llr"].append(_np(llr))
        if mesh.rank == 0:
            ref = _kc.demod_llr(re, im, hr, hi, cp, mod, nv)  # kernel C, unsharded
            res["max_err"].append(float((llr - ref).abs().max()))
            res["peak"].append(float(ref.abs().max()))
            big = ref.abs() >= 1e-3
            res["sign_diff"].append(int(((llr < 0) != (ref < 0))[big].sum()))
            del ref
        if mesh.rank == 0 and cfg is not None:
            idx = fast.draw_idx(cfg, case["seed"], ids)
            errors = _kc.count_errors(llr, idx, mod.bits_per_symbol)
            res["ber"] = int(errors.sum()) / (cfg.n_channels * cfg.n_symbols * n_fft
                                              * mod.bits_per_symbol)
            res["ber_drawn"] = ber_given_gain(mod, cfg.channel.ebno_db,
                                              (h[:, :1].abs() ** 2).to(torch.float64))
        del llr
    return res


_KINDS = {"tp": _tp, "fast": _fast, "pp": _pp, "coded_fast": _coded_fast, "coded": _coded,
          "mc": _mc,
          "mc_inject": _mc_inject, "simulate": _simulate, "stream": _stream}


def run_cases(rank: int, world: int, device, cases: list) -> list:
    """Rank function: run each case on its mesh (built once per mesh
    shape, in case order on every rank) and return this rank's results."""
    dev = resolve_device(device)
    meshes = {}
    out = []
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_link_mesh(*shape)
        out.append(_KINDS[case["kind"]](case, meshes[shape], dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# ---- the dryrun --------------------------------------------------------------

def _cfg(model, ebno_db, n_channels, n_symbols, n_fft=256, cp=64, mod=Modulation.QAM16,
         **kw):
    channel = {k: kw.pop(k) for k in ("pdp", "doppler_norm", "cfo_subcarriers", "timing_offset",
                                      "pa_ibo_db", "phase_noise_std", "iq_gain", "iq_phase_rad")
               if k in kw}
    return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
                      channel=ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                      n_symbols=n_symbols, n_channels=n_channels, **kw)


PDP4 = (1.0, 0.5, 0.25, 0.125)  # BASELINE config 4's power-delay profile
PDP5 = (1.0, 0.6, 0.3, 0.1, 0.05)  # config 5's


SEED = 20261016


def mimo_cfg(world: int) -> LinkConfig:
    """The dryrun's MIMO row (``__graft_entry__.py``'s): ``entry()``'s link
    (config 2, MULTIPATH PDP (1, .5, .25, .125), MMSE, 12 dB) at 2·world
    channels × 4 symbols, as a 2 × 2 spatial-mux link with the ML detector
    on the head preamble's DFT estimate."""
    return _cfg(ChannelModel.MULTIPATH, 12.0, 2 * world, 4, pdp=PDP4, equalizer=Equalizer.MMSE,
                estimator=ChannelEstimator.DFT,
                mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble", detector="ml"))


def dryrun_cases(world: int) -> list:
    """The dryrun's rows at full width over ``world`` ranks (world² must
    divide 4096 and world be even): TP at BASELINE config 5 (256 × 64,
    N 4096, CP 512, a MULTIPATH 14 dB link); DP fast at config 5's shape
    (4096 × 16), config 2 (8192 × 64 AWGN) and config 4 (64 links,
    MULTIPATH 12 dB) in both layouts; DP MC keyed (config 2, AWGN 8 dB,
    8192 × 64) and injected (1024 × 64); DP coded-fast staged rate 1/2
    (1024 × 64, RAYLEIGH_FLAT 6 dB); DP SC-FDMA at N 1024 (2048 × 16,
    MULTIPATH config 4's PDP 14 dB); PP 2 stages × world/2 channel
    shards, n_micro 2, config 2 at 2048 × 64; the time-block stream with
    its halo on 2 time × world/2 channel ranks, n_blocks 4 (a seam
    exchanged between ranks and one inside each rank), 1024 × 64 at
    ``__graft_entry__.entry()``'s link (config 2, MULTIPATH PDP (1, .5,
    .25, .125), MMSE, 12 dB) and as the TDL (MULTIPATH_TIME, fd 0.03); the
    MIMO link of ``mimo_cfg`` on 1 × world ranks; the polar row of
    ``__graft_entry__.py`` — the CA-SCL (256, 128) CRC-11 link, list 2, at
    ``entry()``'s link — at 64·world channels × 4 symbols (16 codewords a
    channel) on 1 × world ranks."""
    dp = (1, world)
    c5 = dict(n_fft=4096, cp=512, pdp=PDP5)
    seed = SEED
    rows = [dict(name="TP config 5", kind="tp", mesh=(world, 1), seed=seed,
                 cfg=_cfg(ChannelModel.MULTIPATH, 14.0, 256, 64, **c5))]
    for label, cfg in (
        ("config 5 shape MULTIPATH", _cfg(ChannelModel.MULTIPATH, 14.0, 4096, 16, **c5)),
        ("config 2 AWGN", _cfg(ChannelModel.AWGN, 10.0, 8192, 64)),
        ("config 4 (64 links) MULTIPATH", _cfg(ChannelModel.MULTIPATH, 12.0, 64, 64, pdp=PDP4)),
    ):
        for layout in ("rows", "cl"):
            rows.append(dict(name=f"DP fast {layout} {label}", kind="fast", mesh=dp, seed=seed,
                             cfg=cfg, layout=layout))
    rows += [
        dict(name="DP MC keyed config 2 AWGN 8 dB", kind="mc", mesh=dp, seed=seed,
             cfg=_cfg(ChannelModel.AWGN, 8.0, 8192, 64)),
        dict(name="DP MC inject config 2", kind="mc_inject", mesh=dp, rand_seed=seed,
             cfg=_cfg(ChannelModel.AWGN, 8.0, 1024, 64)),
        dict(name="DP coded-fast staged rate 1/2", kind="coded_fast", mesh=dp, seed=seed,
             seam="staged", cfg=_cfg(ChannelModel.RAYLEIGH_FLAT, 6.0, 1024, 64)),
        dict(name="DP SC-FDMA N 1024", kind="fast", mesh=dp, seed=seed,
             cfg=_cfg(ChannelModel.MULTIPATH, 14.0, 2048, 16, n_fft=1024, cp=128, pdp=PDP4,
                      dft_spread=True)),
        dict(name="PP 2 stages config 2", kind="pp", mesh=(2, world // 2), seed=seed,
             n_micro=2, cfg=_cfg(ChannelModel.AWGN, 10.0, 2048, 64)),
        dict(name="stream (time-block SP, halo)", kind="stream", mesh=(2, world // 2),
             seed=seed, n_blocks=4,
             cfg=_cfg(ChannelModel.MULTIPATH, 12.0, 1024, 64, pdp=PDP4,
                      equalizer=Equalizer.MMSE)),
        dict(name="TDL stream", kind="stream", mesh=(2, world // 2), seed=seed, n_blocks=4,
             cfg=_cfg(ChannelModel.MULTIPATH_TIME, 12.0, 1024, 64, pdp=PDP4,
                      doppler_norm=0.03, equalizer=Equalizer.MMSE)),
        dict(name="MIMO 2x2 spatial-mux ML, preamble CSI (DFT)", kind="simulate", mesh=dp,
             seed=seed, cfg=mimo_cfg(world)),
        dict(name="polar CA-SCL coded link (256, 128) CRC-11, L 2", kind="coded", code="polar",
             polar_list=2, mesh=dp, seed=seed,
             cfg=_cfg(ChannelModel.MULTIPATH, 12.0, 64 * world, 4, pdp=PDP4,
                      equalizer=Equalizer.MMSE)),
    ]
    for row in rows:
        row["warm"] = True
    return rows


def check_rows(cases: list, per_rank: list) -> list:
    """Hold each row's results to its gate; returns one dict per row
    (name, ok, ms, line, and the kernel launches of its sharded calls
    summed over the ranks) and raises nothing."""
    out = []
    for i, case in enumerate(cases):
        res = [r[i] for r in per_rank]
        r0 = res[0]
        ms = r0["ms"][0] if isinstance(r0["ms"], list) else r0["ms"]
        if case["kind"] == "tp":
            same = all(r["digest"] == r0["digest"] for r in res)
            err = max(e / p for e, p in zip(r0["max_err"], r0["peak"]))
            signs = sum(r0["sign_diff"])
            ok = same and err <= 1e-4 and signs == 0
            detail = (f"LLRs vs kernel C unsharded max diff {err:.3g} of the peak (allowed "
                      f"1e-4), sign differences {signs}")
            if "ber" in r0:
                ratio = r0["ber"] / r0["ber_drawn"]
                ok = ok and abs(ratio - 1) <= 0.02
                detail += (f"; BER {r0['ber']:.6g} vs drawn channel {r0['ber_drawn']:.6g} "
                           f"(ratio {ratio:.5f}, allowed 2 %)")
            detail += f"; all ranks equal {same}"
        else:
            same = all(np.array_equal(r["errors"], r0["errors"]) for r in res)
            errors, counted = int(r0["errors"].sum()), int(r0["counted"].sum())
            if case["kind"] == "mc":
                th = ber_awgn_exact(case["cfg"].modulation, case["cfg"].channel.ebno_db)
                ok = same and abs(errors / counted / th - 1) <= 0.01
                detail = f"BER {errors / counted:.6g} vs theory {th:.6g} (allowed 1 %)"
            elif case["kind"] == "stream":
                ok = same and r0.get("exact", False) and r0.get("within", False)
                detail = (f"n_blocks {case['n_blocks']}; sharded == unsharded stream "
                          f"(bit-exact) {r0.get('exact', False)}; vs pipeline.simulate max "
                          f"per-channel diff {r0.get('vs_simulate')} (allowed "
                          f"{r0.get('allowed')}: 0, or under Jakes fading the bits with "
                          f"|LLR| < 1e-3)")
            else:
                ok = same and r0.get("exact", False)
                detail = f"sharded == unsharded (bit-exact) {r0.get('exact', False)}"
            detail = f"errors={errors}/{counted} bits; {detail}; all ranks equal {same}"
        line = (f"dryrun_multichip {case['name']} {'OK' if ok else 'FAILED'}: mesh "
                f"{case['mesh'][0]}x{case['mesh'][1]}, {detail}; wall {ms:.3f} ms")
        launches = {}
        for r in res:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        out.append(dict(name=case["name"], ok=ok, ms=ms, line=line, launches=launches))
    return out


def dryrun_multichip(world: int = 4, device="cuda", timeout: float = 600.0) -> list:
    """Run ``dryrun_cases(world)`` over ``world`` spawned ranks, print one
    line per row and return the rows; every row's wall time is from ranks
    that may share one card."""
    resolve_device(device)
    cases = dryrun_cases(world)
    per_rank = spawn(world, run_cases, (str(device), cases), timeout=timeout)
    rows = check_rows(cases, per_rank)
    for row in rows:
        print(f"{row['line']} ({world} {SHARED_CARD})", flush=True)
    return rows
