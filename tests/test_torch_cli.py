"""The port's command line (sdr_tpu_torch.app.cli) against the JAX cli
(sdr_tpu.app.cli), on the CPU.

No JAX link is compiled: the JAX side is its parser, its ``_cmd_*``
functions with their simulation entry points replaced by stubs that
record what they are given, and its ``_run_sanity`` on stubbed timings.

(a) Parser parity: the same subcommands, and for each the same option
    strings, defaults and choices, but ``--device`` (the port's, on every
    subcommand).
(b) Case parity: on each argv of ``CASES`` the port's cli hands its entry
    point the LinkConfig (or PacketConfig and ChannelConfig) that the JAX
    cli hands its own, field by field (enums by value), with the same
    options, and prints the same JSON from the same stubbed counts (but
    the MC path's description).
(c) Guard parity: the same exit code 2 on the flag combinations the JAX
    cli refuses.
(d) ``bench --sanity``: the same JSON (but ``backend``) and exit code on
    the same stubbed timings, the retry included; on the card a failed
    bandwidth probe raises.
(e) End to end with ``--device cpu`` at tiny sizes (the baseline cases cut
    to 4 × 16, as ``tests/test_app.py`` cuts the JAX ones).
(f) Without ``--device`` and without a card the command fails, naming the
    card.
"""

import argparse
import contextlib
import dataclasses
import enum
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_tpu_torch.app import cli as tcli

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _plain(obj):
    """Dataclasses as dicts, enums by value, tuples as lists."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    return obj


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


# ---- (a) parser parity ---------------------------------------------------------------------

def _options(parser):
    sub = next(a for a in parser._actions if isinstance(a, type(parser._subparsers._group_actions[0])))
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {
            tuple(a.option_strings): (a.default, None if a.choices is None else list(a.choices))
            for a in sp._actions if a.option_strings and a.dest != "help"
        }
    return out


def test_parser_parity():
    from sdr_tpu.app.cli import build_parser as j_build_parser

    mine, ref = _options(tcli.build_parser()), _options(j_build_parser())
    assert sorted(mine) == sorted(ref)
    for cmd in ref:
        assert mine[cmd].pop(("--device",)) == ("cuda", ["cuda", "cpu"])
    assert mine == ref


# ---- (b) case parity -----------------------------------------------------------------------

def _jax_stubs(monkeypatch, seen):
    """Replace the JAX cli's entry points by recorders; each returns
    per-channel counts (channel i: i % 3 errors of 1000 bits). The JAX cli
    sees one device, as the port one rank (the sharded branches are held
    on ranks in ``tests/test_torch_parallel.py``)."""
    import jax

    import sdr_tpu.link.adapt as j_adapt
    import sdr_tpu.link.coded as j_coded
    import sdr_tpu.link.fast as j_fast
    import sdr_tpu.link.mc as j_mc
    import sdr_tpu.link.packet as j_packet
    import sdr_tpu.link.pipeline as j_pipeline
    import sdr_tpu.obs.sweep as j_sweep

    def counts(cfg):
        n = cfg.n_channels
        return np.arange(n, dtype=np.int32) % 3, np.full(n, 1000, np.int32)

    def maker(name, wrap=lambda e, c: (e, c)):
        def make(cfg, **kw):
            seen.append((name, _plain(cfg), kw))
            return lambda key: wrap(*counts(cfg))
        return make

    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: one)
    monkeypatch.setattr(j_pipeline, "make_simulate_fn", maker(
        "simulate", lambda e, c: types.SimpleNamespace(bit_errors=e, bits_counted=c)))
    monkeypatch.setattr(j_fast, "make_fast_fn", maker("fast"))
    monkeypatch.setattr(j_mc, "make_mc_fn", maker("mc"))
    for name in ("make_coded_fn", "make_ldpc_fn", "make_polar_fn"):
        monkeypatch.setattr(j_coded, name, maker(name))

    def sweep(cfg, grid, key, **kw):
        seen.append(("sweep", _plain(cfg), {k: kw[k] for k in ("engine", "code", "code_rate",
                                                               "mc_iters")}))
        return j_sweep.SweepResult(points=[j_sweep.SweepPoint(float(e), 7, 1000, 1)
                                           for e in grid], config_summary="stub")

    monkeypatch.setattr(j_sweep, "ebno_sweep", sweep)

    def packets(pcfg, ch, key, n):
        seen.append(("packet", _plain(pcfg), _plain(ch)))
        return np.arange(n) % 2, np.arange(n) % 2 == 0

    monkeypatch.setattr(j_packet, "simulate_packets", packets)

    def calibrate(cfg, key, target_ber, ladder):
        seen.append(("calibrate", _plain(cfg), {"ladder": _plain(ladder),
                                                "target_ber": target_ber}))
        return [j_adapt.MCSThreshold(*_TABLE_ROW(j_adapt))]

    def adaptive(cfg, key, profile, table, margin_db):
        seen.append(("adaptive", _plain(cfg), {"profile": list(profile), "margin": margin_db}))
        return _ADAPTIVE

    monkeypatch.setattr(j_adapt, "calibrate", calibrate)
    monkeypatch.setattr(j_adapt, "simulate_adaptive", adaptive)


def _port_stubs(monkeypatch, seen):
    """The port's entry points, replaced by the same recorders."""
    import sdr_tpu_torch.link.adapt as t_adapt
    import sdr_tpu_torch.link.coded as t_coded
    import sdr_tpu_torch.link.fast as t_fast
    import sdr_tpu_torch.link.mc as t_mc
    import sdr_tpu_torch.link.packet as t_packet
    import sdr_tpu_torch.link.pipeline as t_pipeline
    import sdr_tpu_torch.obs.sweep as t_sweep

    def counts(cfg):
        n = cfg.n_channels
        return (torch.arange(n, dtype=torch.int32) % 3,
                torch.full((n,), 1000, dtype=torch.int32))

    def maker(name, wrap=lambda e, c: (e, c)):
        def make(cfg, device="cuda", **kw):
            assert device == "cpu"
            seen.append((name, _plain(cfg), kw))
            return lambda seed: wrap(*counts(cfg))
        return make

    monkeypatch.setattr(t_pipeline, "make_simulate_fn", maker(
        "simulate", lambda e, c: types.SimpleNamespace(bit_errors=e, bits_counted=c)))
    monkeypatch.setattr(t_fast, "make_fast_fn", maker("fast"))
    monkeypatch.setattr(t_mc, "make_mc_fn", maker("mc"))
    for name in ("make_coded_fn", "make_ldpc_fn", "make_polar_fn"):
        monkeypatch.setattr(t_coded, name, maker(name))

    def sweep(cfg, grid, seed, device="cuda", **kw):
        assert device == "cpu" and kw["progress"] is not None
        seen.append(("sweep", _plain(cfg), {k: kw[k] for k in ("engine", "code", "code_rate",
                                                               "mc_iters")}))
        return t_sweep.SweepResult(points=[t_sweep.SweepPoint(float(e), 7, 1000, 1)
                                           for e in grid], config_summary="stub")

    monkeypatch.setattr(t_sweep, "ebno_sweep", sweep)

    def packets(pcfg, ch, seed, n, device="cuda"):
        assert device == "cpu"
        seen.append(("packet", _plain(pcfg), _plain(ch)))
        return torch.arange(n) % 2, torch.arange(n) % 2 == 0

    monkeypatch.setattr(t_packet, "simulate_packets", packets)

    def calibrate(cfg, seed, target_ber, ladder, device="cuda"):
        assert device == "cpu"
        seen.append(("calibrate", _plain(cfg), {"ladder": _plain(ladder),
                                                "target_ber": target_ber}))
        return [t_adapt.MCSThreshold(*_TABLE_ROW(t_adapt))]

    def adaptive(cfg, seed, profile, table, margin_db, device="cuda"):
        seen.append(("adaptive", _plain(cfg), {"profile": list(profile), "margin": margin_db}))
        return _ADAPTIVE

    monkeypatch.setattr(t_adapt, "calibrate", calibrate)
    monkeypatch.setattr(t_adapt, "simulate_adaptive", adaptive)


def _TABLE_ROW(adapt_mod):
    mod = type(adapt_mod.DEFAULT_LADDER[0][0])
    return (mod.QPSK, "1/2", 0.9, 1.5, 2e-5, "conv", "ofdm")


_ADAPTIVE = {
    "efficiency_per_channel": np.array([0.9, 0.0]),
    "family_per_channel": ["conv", ""],
    "waveform_per_channel": ["ofdm", ""],
    "bit_errors": np.array([3, 0]),
    "info_bits": np.array([1000, 0]),
    "achieved_efficiency": 0.45,
    "silent_channels": 1,
}

CONFIG_FILE = {
    "modulation": "16qam", "ofdm": {"n_fft": 128, "cp_len": 32},
    "channel": {"model": "rayleigh_time", "ebno_db": 12.0, "doppler_norm": 0.02},
    "equalizer": "mmse", "n_symbols": 12, "n_channels": 6, "pilot_spacing": 4,
}

CASES = {
    "config0": ["bench", "--config", "0"],
    "acquire": ["bench", "--config", "0", "--cfo", "2.3", "--timing-offset", "37"],
    "phase_noise": ["bench", "--config", "1", "--phase-noise", "0.002"],
    "iq": ["bench", "--config", "3", "--iq-gain", "1.05", "--iq-phase", "0.03"],
    "estimator_acquire": ["bench", "--config", "3", "--estimator", "dft", "--cfo", "1.0"],
    "pa": ["bench", "--config", "1", "--pa-ibo", "3", "--pa-p", "3", "--pa-dpd"],
    "pa_scfdma": ["bench", "--config", "2", "--pa-ibo", "3", "--dft-spread"],
    "scfdma": ["bench", "--config", "1", "--dft-spread"],
    "scfdma_acquire": ["bench", "--config", "0", "--cfo", "1.0", "--dft-spread"],
    "alamouti": ["bench", "--config", "0", "--mimo", "alamouti", "--per-channel"],
    "mrc_preamble": ["bench", "--config", "1", "--mimo", "mrc", "--csi", "preamble"],
    "mux_ml": ["bench", "--config", "3", "--mimo", "mux", "--detector", "ml", "--csi",
               "preamble", "--estimator", "dft"],
    "mux_2x4_sic": ["bench", "--config", "1", "--mimo", "mux", "--nrx", "4", "--detector",
                    "sic"],
    "config_file": ["bench", "--config-file", "CONFIG_FILE", "--seed", "5"],
    "fast": ["bench", "--config", "1", "--fast"],
    "mc": ["bench", "--config", "2", "--mc", "4"],
    "coded_conv": ["bench", "--config", "1", "--coded", "--rate", "2/3"],
    "coded_ldpc": ["bench", "--config", "1", "--coded", "--code", "ldpc", "--rate", "3/4",
                   "--ldpc-iters", "9"],
    "coded_polar": ["bench", "--config", "1", "--coded", "--code", "polar", "--polar-list", "4"],
    "sweep_mimo": ["sweep", "--config", "1", "--mimo", "alamouti", "--ebno-grid", "0,6"],
    "sweep_scfdma_mc": ["sweep", "--config", "2", "--dft-spread", "--engine", "fast"],
    "sweep_code": ["sweep", "--config", "1", "--code", "ldpc", "--rate", "2/3",
                   "--mc-iters", "3"],
    "packet": ["packet"],
    "packet_ldpc": ["packet", "--code", "ldpc", "--channel", "multipath_time", "--doppler",
                    "0.02", "--cfo", "0.5", "--n", "6", "--payload", "40", "--mod", "16qam"],
    "adapt_pa": ["adapt", "--config", "3", "--pa-ibo", "2", "--profile", "--margin", "1"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_case_parity(name, monkeypatch, tmp_path):
    from sdr_tpu.app import cli as jcli

    argv = list(CASES[name])
    if "CONFIG_FILE" in argv:
        path = tmp_path / "link.json"
        path.write_text(json.dumps(CONFIG_FILE))
        argv[argv.index("CONFIG_FILE")] = str(path)
    seen_j, seen_t = [], []
    _jax_stubs(monkeypatch, seen_j)
    _port_stubs(monkeypatch, seen_t)
    rc_j, out_j, err_j = _run(jcli.main, argv)
    rc_t, out_t, err_t = _run(tcli.main, argv + ["--device", "cpu"])
    assert rc_j == rc_t == 0, (err_j, err_t)
    assert seen_t == seen_j
    js_j, js_t = _last_json(out_j), _last_json(out_t)
    js_j.pop("path", None), js_t.pop("path", None)
    assert js_t == js_j


# ---- (c) guard parity ----------------------------------------------------------------------

GUARDS = {
    "acquire_mux": ["bench", "--config", "0", "--cfo", "1.0", "--mimo", "mux"],
    "mux_fast": ["bench", "--config", "0", "--mimo", "mux", "--fast"],
    "packet_no_pilots": ["packet", "--pilots", "0", "--n", "1"],
    "replay_missing": ["packet", "--n", "2", "--replay", "MISSING"],
    "coded_cfo": ["bench", "--config", "1", "--coded", "--cfo", "1.0"],
    "mc_unsupported": ["bench", "--config", "0", "--mc", "2"],
    "mc_acquire": ["bench", "--config", "1", "--mc", "2", "--timing-offset", "5"],
    "fast_pilots": ["bench", "--config", "1", "--fast", "--phase-noise", "0.01"],
    "sweep_code_fast": ["sweep", "--config", "1", "--code", "conv", "--engine", "fast"],
    "sweep_mc_unsupported": ["sweep", "--config", "0", "--engine", "mc"],
    "sweep_fast_mimo": ["sweep", "--config", "1", "--mimo", "mrc", "--engine", "fast"],
    "scfdma_no_period": ["bench", "--config-file", "ODD", "--dft-spread"],
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_guard_parity(name, monkeypatch, tmp_path):
    from sdr_tpu.app import cli as jcli

    argv = list(GUARDS[name])
    if "MISSING" in argv:
        argv[argv.index("MISSING")] = str(tmp_path / "nope.sc16")
    if "ODD" in argv:
        path = tmp_path / "odd.json"
        path.write_text(json.dumps(dict(CONFIG_FILE, n_symbols=9, pilot_spacing=4,
                                        channel={"model": "awgn", "ebno_db": 10.0})))
        argv[argv.index("ODD")] = str(path)
    _jax_stubs(monkeypatch, [])
    _port_stubs(monkeypatch, [])
    rc_j, _, err_j = _run(jcli.main, argv)
    rc_t, _, err_t = _run(tcli.main, argv + ["--device", "cpu"])
    assert rc_j == rc_t == 2, (err_j, err_t)
    assert err_t.startswith("error: ")


def test_autotune_fft_crossover_json(monkeypatch):
    """``autotune`` without ``--demod`` measures the FFT backends and
    prints the JAX cli's JSON: on the same planted points both clis print
    the same stdout and stderr; a real run on the CPU (its batch cut to
    2^12 elements) has a positive rate per size and backend."""
    import sdr_tpu.obs.autotune as j_auto
    import sdr_tpu_torch.obs.autotune as t_auto
    from sdr_tpu.app import cli as jcli

    planted = [(64, 2.0, 1.0), (128, 1.0, 3.0)]
    monkeypatch.setattr(j_auto, "tune_fft",
                        lambda sizes, iters: [j_auto.TunePoint(*p) for p in planted])
    monkeypatch.setattr(t_auto, "tune_fft",
                        lambda sizes, iters, device: [t_auto.TunePoint(*p) for p in planted])
    argv = ["autotune", "--sizes", "64,128", "--iters", "1"]
    rc_j, out_j, err_j = _run(jcli.main, argv)
    rc_t, out_t, err_t = _run(tcli.main, argv + ["--device", "cpu"])
    assert rc_j == rc_t == 0 and out_t == out_j and err_t == err_j
    assert _last_json(out_t)["matmul_min_n"] == 128
    monkeypatch.undo()
    real = t_auto._time_backend
    monkeypatch.setattr(t_auto, "_time_backend",
                        lambda backend, n, _elems, iters, reps, dev:
                        real(backend, n, 1 << 12, iters, reps, dev))
    out = _last_json(_cpu(argv)[0])
    assert set(out) == set(_last_json(out_j)) == {"matmul_min_n", "points"}
    assert [p["n"] for p in out["points"]] == [64, 128]
    assert all(set(p) == {"n", "xla", "matmul"} and p["xla"] > 0 and p["matmul"] > 0
               for p in out["points"])


# ---- (d) bench --sanity --------------------------------------------------------------------

def _sanity_stubs(monkeypatch, rates, probe):
    """Both clis' tune_demod and hbm_bandwidth_gbps replaced: ``rates``
    maps each call in turn to a rate by batch size (small, large)."""
    import sdr_tpu.obs.autotune as j_auto
    import sdr_tpu.obs.health as j_health
    import sdr_tpu_torch.obs.autotune as t_auto
    import sdr_tpu_torch.obs.health as t_health

    for auto, health, point in ((j_auto, j_health, j_auto.DemodTunePoint),
                                (t_auto, t_health, t_auto.DemodTunePoint)):
        calls = iter(rates)

        def tune(n_fft, cp_len, batch, n_syms, iters, reps, backends, _calls=calls, _pt=point,
                 device="cuda", **kw):
            return [_pt(backend=backends[0], gs_per_s=next(_calls))]

        def bw(*a, device="cuda", **kw):
            if probe is None:
                raise RuntimeError("probe failed")
            return probe

        monkeypatch.setattr(auto, "tune_demod", tune)
        monkeypatch.setattr(health, "hbm_bandwidth_gbps", bw)


@pytest.mark.parametrize("rates,probe,rc", [
    ((10.0, 30.0), 2000.0, 0),          # scales with batch
    ((10.0, 5.0, 10.0, 9.5), 50.0, 0),  # a starved first pair, the retry scales
    ((10.0, 5.0, 10.0, 4.0), None, 1),  # a real regression; the probe fails
], ids=["scales", "retry", "regression"])
def test_sanity_parity(monkeypatch, rates, probe, rc):
    from sdr_tpu.app import cli as jcli

    _sanity_stubs(monkeypatch, rates, probe)
    argv = ["bench", "--sanity", "--sanity-batch", "64"]
    rc_j, out_j, _ = _run(jcli.main, argv)
    rc_t, out_t, _ = _run(tcli.main, argv + ["--device", "cpu"])
    assert rc_j == rc_t == rc
    js_j, js_t = json.loads(out_j), json.loads(out_t)
    assert js_t.pop("backend") == "fused"
    js_j.pop("backend")
    assert js_t == js_j


def test_sanity_probe_failure_on_the_card_propagates(monkeypatch):
    """A failed bandwidth probe reads -1 on the CPU (the parity case
    above) but raises on the card: a device fault never exits 0."""
    _sanity_stubs(monkeypatch, (10.0, 30.0), None)
    args = argparse.Namespace(device="cuda", sanity_batch=64)
    with pytest.raises(RuntimeError, match="probe failed"):
        tcli._run_sanity(args)


# ---- (e) end to end on the CPU -------------------------------------------------------------

@pytest.fixture
def small_cases(monkeypatch):
    import sdr_tpu_torch.app.baseline_configs as bc

    orig = bc.baseline_cases

    def small():
        return [dataclasses.replace(c, cfg=dataclasses.replace(c.cfg, n_channels=4,
                                                                n_symbols=16))
                for c in orig()]

    monkeypatch.setattr(bc, "baseline_cases", small)


def _cpu(argv):
    rc, out, err = _run(tcli.main, argv + ["--device", "cpu"])
    assert rc == 0, err
    return out, err


def test_info_and_list_on_cpu():
    from sdr_tpu.app import cli as jcli

    info = json.loads(_cpu(["info"])[0])
    assert info["devices"] == ["cpu"] and info["torch_version"] == torch.__version__
    assert "16qam" in info["modulations"]
    rc_j, text_j, _ = _run(jcli.main, ["info"])
    keys_j = set(json.loads(text_j)) - {"jax_backend"}
    assert set(info) == keys_j | {"torch_version", "cuda"}
    assert info["fft_backend"] == json.loads(text_j)["fft_backend"] == "auto"
    rc_j, list_j, _ = _run(jcli.main, ["bench", "--list"])
    assert rc_j == 0 and _cpu(["bench", "--list"])[0] == list_j


def test_bench_config0_and_fast(small_cases):
    out = _last_json(_cpu(["bench", "--config", "0"])[0])
    assert out["bits"] == 4 * 16 * 64 * 2 and out["ber"] < 1e-2
    assert "ber_theory_awgn" in out
    fast = _last_json(_cpu(["bench", "--config", "1", "--fast"])[0])
    assert fast["case"].endswith("+fast") and fast["bits"] == 4 * 16 * 256 * 4


@pytest.mark.parametrize("code", ["conv", "ldpc", "polar"])
def test_bench_coded(small_cases, code):
    out = _last_json(_cpu(["bench", "--config", "1", "--coded", "--code", code])[0])
    assert out["case"].endswith("+fec") and out["info_bits"] > 0 and out["ber"] < 1e-2


def test_sweep_checkpoint_resume(small_cases, tmp_path):
    ck = str(tmp_path / "sweep.json")
    argv = ["sweep", "--config", "1", "--ebno-grid", "2,4", "--target-errors", "50",
            "--max-bits", "200000", "--checkpoint", ck, "--plot", str(tmp_path / "s.png")]
    first = _last_json(_cpu(argv)[0])
    assert len(json.load(open(ck))["points"]) == 2
    assert os.path.getsize(tmp_path / "s.png") > 5000
    again = _last_json(_cpu(argv)[0])
    assert again == first


def test_packet_and_record_replay(tmp_path):
    out = _last_json(_cpu(["packet", "--payload", "24", "--n", "8", "--ebno", "16"])[0])
    assert out["crc_verdicts_consistent"] and out["per"] <= 0.25 and out["packets"] == 8
    path = str(tmp_path / "bursts.sc16")
    argv = ["packet", "--payload", "24", "--n", "8", "--ebno", "16", "--seed", "3"]
    rec = _last_json(_cpu(argv + ["--record", path])[0])
    assert rec["source"] == f"iq_file:{path}" and rec["packets"] == 8
    frame = 37 + rec["burst_samples"] + 80
    from sdr_tpu.native.iq import iq_info

    assert iq_info(path) == 8 * frame
    rep = _last_json(_cpu(argv + ["--replay", path])[0])
    assert rep == rec and rep["crc_verdicts_consistent"] and rep["per"] <= 0.25
    # A file shorter than one frame holds none.
    short = tmp_path / "short.sc16"
    short.write_bytes(Path(path).read_bytes()[:4 * (frame - 1)])
    rc, _, err = _run(tcli.main, argv + ["--replay", str(short), "--device", "cpu"])
    assert rc == 2 and "frames" in err


def test_waveform_report(small_cases, tmp_path):
    png = str(tmp_path / "ccdf.png")
    out = _last_json(_cpu(["waveform", "--config", "0", "--symbols", "512", "--plot", png])[0])
    assert 5.0 < out["papr_db"]["p99"] < 13.0
    aided = out["evm_rms_pct"]["data_aided"]
    assert abs(aided / out["evm_theory_pct"] - 1) < 0.05
    assert out["psd_inband_flatness_db"] < 2.0
    assert len(out["ccdf"]) == len(out["ccdf_grid_db"]) == 18
    assert os.path.getsize(png) > 5000


def test_adapt_keys_equal_jax(small_cases, monkeypatch):
    """A stubbed calibrate (the JAX one too, with its adaptive run); the
    port's adaptive run is real on the tiny case."""
    import sdr_tpu_torch.link.adapt as t_adapt
    from sdr_tpu.app import cli as jcli

    seen = []
    _jax_stubs(monkeypatch, seen)
    monkeypatch.setattr(t_adapt, "calibrate", lambda cfg, seed, target_ber, ladder, device:
                        [t_adapt.MCSThreshold(*_TABLE_ROW(t_adapt))])
    argv = ["adapt", "--config", "0", "--profile", "--mean-snr", "14"]
    out = _last_json(_cpu(argv)[0])
    rc, out_j, _ = _run(jcli.main, argv)
    ref = _last_json(out_j)
    assert rc == 0 and set(out) == set(ref)
    assert set(out["adaptive"]) == set(ref["adaptive"])
    assert out["table"] == ref["table"]
    assert out["adaptive"]["families_used"] == ["conv"]
    assert out["adaptive"]["achieved_efficiency"] > 0


def test_scale_and_autotune(small_cases):
    out = _last_json(_cpu(["scale", "--config", "3", "--iters", "2"])[0])
    assert [p["n_devices"] for p in out["points"]] == [1]
    assert out["points"][0]["n_channels"] == 4 and out["points"][0]["efficiency"] == 1.0
    tune = _last_json(_cpu(["autotune", "--demod", "--demod-nfft", "256", "--demod-cp", "64",
                            "--iters", "1"])[0])
    routes = ["fused", "fused:bf16", "hybrid", "cl", "cl:bf16"]
    assert [p["backend"] for p in tune["points"]] == routes
    assert tune["recommended_demod_route"] in routes


# ---- (f) the card by default ---------------------------------------------------------------

def test_without_a_card_the_default_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    rc, out, err = _run(tcli.main, ["info"])
    assert rc != 0 and out == "" and "CUDA card" in err


def test_module_entry_imports_no_jax():
    """``python -m sdr_tpu_torch info --device cpu`` loads no jax, sdr_tpu or
    matplotlib module."""
    code = (
        "import runpy, sys; sys.argv = ['sdr_tpu_torch', 'info', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('sdr_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "assert not any(m == 'sdr_tpu' or m.startswith('sdr_tpu.') for m in sys.modules)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["devices"] == ["cpu"]
