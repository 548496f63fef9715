"""The port's data- and pipeline-parallel layer (sdr_tpu_torch.parallel)
on the CPU, over 4 gloo ranks spawned once for the module.

- Sharded fast links (rows and cl; AWGN, MULTIPATH, MULTIPATH_TIME;
  SC-FDMA), the coded fast engine (staged seam), the Monte-Carlo inject
  mode and the 2-stage pipeline (n_micro 1 and 2) are bit-exact against
  the port's unsharded runs, on every rank, for several meshes.
- The keyed sharded Monte-Carlo run equals the unsharded engine run
  shard by shard with the per-shard seeds (seed + shard·0x5BD1E995,
  wrapped to int32, as the JAX module).
- The sharded MC inject run against JAX ``make_sharded_mc_inject_fn`` on
  4 virtual CPU devices: equal per-channel counts but for bits whose
  plain |LLR| < 1e-3 (port and JAX draw from different streams, so the
  comparison injects the same numpy draws into both).
- The sharded pipeline (channel DP, 1 × 4; a genie and a comb-pilot DFT
  link, the dryrun's 2 × 2 ML MIMO link on the preamble's DFT estimate,
  an acquired Alamouti 2 × 2 midamble link with the LO walk and I/Q
  imbalance, and an Alamouti 2 × 2 link on 2 × 2 ranks) and the time-block stream
  with its halo exchange (2 × 2, n_blocks 4: one seam between ranks and
  one inside each rank; static MULTIPATH and the TDL) are bit-exact
  against the unsharded ``simulate`` and ``stream_simulate``, and each
  stream equals ``simulate``: the static one bit for bit, the TDL but for
  bits whose |LLR| < 1e-3.
- The sharded coded links of ``link.coded`` (conv, LDPC 10 iterations,
  polar L 4; the JAX ``tests/test_parallel.py`` cell, QPSK N 128, 8 × 16,
  at AWGN −1 dB, where every family still errs, instead of 3 dB, where
  none does) on 1 × 4 ranks are bit-exact against the unsharded
  families.
- What the layer refuses: shapes that do not divide, a pipeline mesh
  without two stages, an unknown code family, and pilots in the stream
  and fast builders (the simulate builder runs them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.parallel import make_link_mesh as j_make_link_mesh
from sdr_tpu.parallel.shard import make_sharded_mc_inject_fn as j_sharded_mc_inject
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import (
    ChannelEstimator,
    ChannelModel,
    Equalizer,
    MIMOConfig,
    MIMOScheme,
    Modulation,
)
from sdr_tpu_torch.link.coded import simulate_coded
from sdr_tpu_torch.link import pipeline as pipe
from sdr_tpu_torch.link.stream import exact_at_seams, stream_simulate
from sdr_tpu_torch.kernels.mc import mc_llr_plain
from sdr_tpu_torch.link import mc
from sdr_tpu_torch.link.mc import _wrap_i32
from sdr_tpu_torch.parallel import (
    dryrun,
    make_link_mesh,
    make_pipelined_fast_fn,
    make_sharded_coded_fast_fn,
    make_sharded_coded_fn,
    make_sharded_fast_fn,
    make_sharded_simulate_fn,
    make_sharded_stream_fn,
)
from sdr_tpu_torch.parallel.shard import make_sharded_mc_fn

torch.set_num_threads(1)

WORLD = 4
SEED = 11
_cfg = dryrun._cfg
PDP3 = (1.0, 0.5, 0.25)


def _small(model, n_channels=16, n_fft=64, cp=16, n_symbols=4, **kw):
    return _cfg(model, 8.0, n_channels, n_symbols, n_fft=n_fft, cp=cp, **kw)


def _mc_jcfg():
    """The inject cell in both packages (JAX tests/test_mc.py's shape)."""
    ref = jcfg.LinkConfig(modulation=jcfg.Modulation.QAM16, ofdm=jcfg.OFDMConfig(256, 64),
                          channel=jcfg.ChannelConfig(model=jcfg.ChannelModel.MULTIPATH,
                                                     ebno_db=6.0, pdp=PDP3),
                          n_symbols=4, n_channels=8)
    return ref, interop.link_config_from_reference(ref)


def _mc_draw(cfg):
    rng = np.random.default_rng(5)
    B, S, N = cfg.n_channels, cfg.n_symbols, cfg.ofdm.n_fft
    return (rng.integers(0, 1 << cfg.modulation.bits_per_symbol, (B, S, N)).astype(np.int32),
            *(rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, S, N), (B, S, N), (B, 1, N), (B, 1, N))))


# name → case (kind, mesh, config, inputs); rank 0 holds each against the
# unsharded port (``exact``).
CASES = {
    "fast_rows_awgn": dict(kind="fast", mesh=(1, 4), cfg=_small(ChannelModel.AWGN),
                           layout="rows"),
    "fast_rows_multipath": dict(kind="fast", mesh=(1, 4),
                                cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3), layout="rows"),
    "fast_rows_multipath_time": dict(kind="fast", mesh=(1, 4),
                                     cfg=_small(ChannelModel.MULTIPATH_TIME, pdp=PDP3,
                                                doppler_norm=0.02), layout="rows"),
    "fast_rows_multipath_mesh2x2": dict(kind="fast", mesh=(2, 2),
                                        cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3),
                                        layout="rows"),
    "fast_cl_awgn": dict(kind="fast", mesh=(1, 4), cfg=_small(ChannelModel.AWGN), layout="cl"),
    "fast_cl_multipath": dict(kind="fast", mesh=(2, 2),
                              cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3), layout="cl"),
    "fast_scfdma": dict(kind="fast", mesh=(1, 4),
                        cfg=_small(ChannelModel.RAYLEIGH_FLAT, dft_spread=True)),
    "coded_fast_staged": dict(kind="coded_fast", mesh=(1, 4), seam="staged", iters=8,
                              cfg=_cfg(ChannelModel.RAYLEIGH_FLAT, 6.0, 8, 8)),
    "mc_inject": dict(kind="mc_inject", mesh=(1, 4), cfg=_mc_jcfg()[1],
                      rand=_mc_draw(_mc_jcfg()[1])),
    "mc_inject_mesh2x2": dict(kind="mc_inject", mesh=(2, 2), cfg=_mc_jcfg()[1],
                              rand=_mc_draw(_mc_jcfg()[1])),
    "pp_n_micro_1": dict(kind="pp", mesh=(2, 2), n_micro=1, cfg=_small(ChannelModel.AWGN)),
    "pp_n_micro_2": dict(kind="pp", mesh=(2, 2), n_micro=2,
                         cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3)),
    "mc_keyed": dict(kind="mc", mesh=(2, 2), iters=2,
                     cfg=_small(ChannelModel.AWGN, n_channels=8, n_fft=128)),
    "simulate_dp": dict(kind="simulate", mesh=(1, 4),
                        cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3, equalizer=Equalizer.MMSE)),
    "simulate_dp_pilots": dict(kind="simulate", mesh=(1, 4),
                               cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3, n_symbols=8,
                                          equalizer=Equalizer.MMSE, pilot_spacing=4,
                                          estimator=ChannelEstimator.DFT)),
    "simulate_dp_acquired": dict(kind="simulate", mesh=(1, 4),
                                 cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3, n_symbols=8,
                                            equalizer=Equalizer.MMSE, pilot_spacing=4,
                                            cfo_subcarriers=1.3, timing_offset=37,
                                            pa_ibo_db=6.0, phase_noise_std=0.002,
                                            iq_gain=1.05, iq_phase_rad=0.03)),
    "simulate_dp_mimo": dict(kind="simulate", mesh=(1, 4),
                             cfg=_small(ChannelModel.MULTIPATH, pdp=PDP3, equalizer=Equalizer.MMSE,
                                        estimator=ChannelEstimator.DFT,
                                        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2,
                                                        csi="preamble", detector="ml"))),
    "simulate_dp_mimo_alamouti": dict(kind="simulate", mesh=(2, 2),
                                      cfg=_small(ChannelModel.RAYLEIGH_FLAT,
                                                 mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2))),
    "simulate_dp_mimo_acquired": dict(kind="simulate", mesh=(1, 4),
                                      cfg=_small(ChannelModel.RAYLEIGH_FLAT, n_symbols=8,
                                                 cfo_subcarriers=1.3, timing_offset=37,
                                                 phase_noise_std=0.002, iq_gain=1.05,
                                                 iq_phase_rad=0.03,
                                                 mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2,
                                                                 csi="preamble",
                                                                 midamble_period=4))),
    **{f"coded_dp_{code}": dict(kind="coded", code=code, mesh=(1, 4), iters=10, polar_list=4,
                                cfg=_cfg(ChannelModel.AWGN, -1.0, 8, 16, n_fft=128,
                                         mod=Modulation.QPSK, equalizer=Equalizer.NONE))
       for code in ("conv", "ldpc", "polar")},
    "stream": dict(kind="stream", mesh=(2, 2), n_blocks=4,
                   cfg=_small(ChannelModel.MULTIPATH, n_symbols=8, pdp=PDP3,
                              equalizer=Equalizer.MMSE)),
    "stream_tdl": dict(kind="stream", mesh=(2, 2), n_blocks=4,
                       cfg=_small(ChannelModel.MULTIPATH_TIME, n_symbols=8, pdp=PDP3,
                                  doppler_norm=0.03, equalizer=Equalizer.MMSE)),
}
EXACT = [name for name, c in CASES.items() if c["kind"] != "mc"]


@pytest.fixture(scope="module")
def ranks():
    """Every case once on 4 gloo ranks; name → per-rank results."""
    cases = [dict(name=name, seed=SEED, **case) for name, case in CASES.items()]
    per_rank = dryrun.spawn(WORLD, dryrun.run_cases, ("cpu", cases), timeout=240)
    return {c["name"]: [r[i] for r in per_rank] for i, c in enumerate(cases)}


@pytest.mark.parametrize("name", EXACT)
def test_sharded_equals_unsharded_on_every_rank(ranks, name):
    res = ranks[name]
    assert res[0]["exact"] is True
    cfg = CASES[name]["cfg"]
    assert res[0]["errors"].shape == (cfg.n_channels,) and res[0]["errors"].sum() > 0
    for r in res[1:]:
        np.testing.assert_array_equal(r["errors"], res[0]["errors"])
        np.testing.assert_array_equal(r["counted"], res[0]["counted"])


@pytest.mark.parametrize("name", ["stream", "stream_tdl"])
def test_sharded_stream_equals_simulate(ranks, name):
    """The halo exchange gives every seam the whole frame's history: the
    sharded stream equals ``simulate`` (bit for bit on static taps, under
    Jakes fading but for bits whose |LLR| < 1e-3) and the unsharded stream
    on the CPU, for every n_blocks."""
    res = ranks[name][0]
    cfg = CASES[name]["cfg"]
    assert res["within"] is True and res["vs_simulate"] <= res["allowed"]
    assert exact_at_seams(cfg) == (name == "stream")
    if exact_at_seams(cfg):
        assert res["allowed"] == 0 and res["vs_simulate"] == 0
    for n_blocks in (1, 2, 8):
        errors, _ = stream_simulate(cfg, SEED, n_blocks, device="cpu")
        np.testing.assert_array_equal(errors.numpy(), res["errors"])


def test_sharded_mc_keyed_uses_the_per_shard_seeds(ranks):
    """Shard c runs ``mc_simulate`` on its n_channels / shards links with
    seed + c·(0x5BD1E995 & 0x7FFFFFFF) wrapped to int32; the "time" rows
    repeat the work."""
    case = CASES["mc_keyed"]
    cfg, n_c = case["cfg"], case["mesh"][1]
    local = dataclasses.replace(cfg, n_channels=cfg.n_channels // n_c)
    want = np.concatenate([
        mc.mc_simulate(local, _wrap_i32(SEED + c * (0x5BD1E995 & 0x7FFFFFFF)),
                       iters=case["iters"], device="cpu")[0].numpy()
        for c in range(n_c)])
    for r in ranks["mc_keyed"]:
        np.testing.assert_array_equal(r["errors"], want)
        assert int(r["counted"][0]) == case["iters"] * mc.bits_per_pass(cfg)


def test_sharded_mc_inject_matches_jax(ranks):
    """Equal per-channel counts with JAX's sharded inject run on 4 CPU
    devices, but for bits whose plain |LLR| < 1e-3."""
    ref_cfg, cfg = _mc_jcfg()
    draw = _mc_draw(cfg)
    jmesh = j_make_link_mesh(1, WORLD, devices=jax.devices()[:WORLD])
    assert interop.mesh_shape_from_reference(jmesh) == CASES["mc_inject"]["mesh"]
    want, counted = j_sharded_mc_inject(ref_cfg, jmesh)(*map(jnp.asarray, draw))
    got = ranks["mc_inject"][0]["errors"]
    llr, _ = mc_llr_plain(cfg, 0, torch.arange(cfg.n_channels, dtype=torch.int32),
                          interop.mc_rand_inputs_from_reference(*draw))
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2)).numpy()
    assert np.all(np.abs(got - np.asarray(want)) <= margin)
    np.testing.assert_array_equal(ranks["mc_inject"][0]["counted"], np.asarray(counted))


def test_layer_refuses_what_it_does_not_run():
    mesh = make_link_mesh()  # one process: 1 × 1
    with pytest.raises(ValueError, match='"time" axis == 2'):
        make_pipelined_fast_fn(_small(ChannelModel.AWGN), mesh, device="cpu")
    coded_cfg = _cfg(ChannelModel.AWGN, -1.0, 8, 16, n_fft=128, mod=Modulation.QPSK,
                     equalizer=Equalizer.NONE)
    errors, counted = make_sharded_coded_fn(coded_cfg, mesh, code="conv", device="cpu")(SEED)
    want = simulate_coded(coded_cfg, SEED, device="cpu")
    assert torch.equal(errors, want[0]) and torch.equal(counted, want[1])
    with pytest.raises(ValueError, match="code must be"):
        make_sharded_coded_fn(coded_cfg, mesh, code="turbo", device="cpu")
    pilots = _small(ChannelModel.AWGN, pilot_spacing=4, equalizer=Equalizer.MMSE)
    errors, counted = make_sharded_simulate_fn(pilots, mesh, device="cpu")(SEED)
    assert torch.equal(errors, pipe.simulate(pilots, SEED, device="cpu").bit_errors)
    assert int(counted[0]) == pilots.n_data_symbols * pilots.bits_per_ofdm_symbol
    with pytest.raises(NotImplementedError, match=r"link\.pipeline"):
        make_sharded_stream_fn(pilots, mesh, device="cpu")
    with pytest.raises(ValueError, match="not divisible by time axis 2"):
        make_sharded_stream_fn(_small(ChannelModel.AWGN),
                               dataclasses.replace(mesh, n_time=2, n_channel=1), n_blocks=3,
                               device="cpu")
    with pytest.raises(NotImplementedError):
        make_sharded_fast_fn(_small(ChannelModel.AWGN, pilot_spacing=4, equalizer=Equalizer.MMSE),
                             mesh, device="cpu")
    with pytest.raises(NotImplementedError):
        make_sharded_coded_fast_fn(_small(ChannelModel.AWGN, dft_spread=True), mesh,
                                   device="cpu")


def test_shard_divisibility_raises_on_every_rank_count():
    """The checks the builders make from the mesh shape alone: a 3-rank
    mesh does not divide 16 channels, a 2 × 3 pipeline does not divide
    16 into 3 shards × 2 microbatches."""
    from sdr_tpu_torch.parallel.mesh import LinkMesh

    groups = {"time": None, "channel": None}
    with pytest.raises(ValueError, match="not divisible by device count 3"):
        make_sharded_fast_fn(_small(ChannelModel.AWGN), LinkMesh(1, 3, 0, groups),
                             device="cpu")
    with pytest.raises(ValueError, match="channel-axis size 3"):
        make_sharded_mc_fn(_small(ChannelModel.AWGN, n_fft=128), LinkMesh(1, 3, 0, groups),
                           device="cpu")
    with pytest.raises(ValueError, match="3×2"):
        make_pipelined_fast_fn(_small(ChannelModel.AWGN), LinkMesh(2, 3, 0, groups),
                               device="cpu")


def test_one_process_dp_equals_the_engine():
    """Without a process group the layer runs on a 1 × 1 mesh."""
    from sdr_tpu_torch.link.fast import fast_simulate

    cfg = _small(ChannelModel.MULTIPATH, pdp=PDP3)
    got = make_sharded_fast_fn(cfg, make_link_mesh(), device="cpu")(SEED)
    want = fast_simulate(cfg, SEED, device="cpu")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("model", [ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME])
def test_one_process_simulate_and_stream_equal_the_engines(model):
    """On a 1 × 1 mesh the sharded pipeline is ``simulate`` and the sharded
    stream (one time rank, n_blocks 2: its seam inside the rank) is
    ``stream_simulate``."""
    cfg = _small(model, n_symbols=8, pdp=PDP3, doppler_norm=0.03, equalizer=Equalizer.MMSE)
    mesh = make_link_mesh()
    got = make_sharded_simulate_fn(cfg, mesh, device="cpu")(SEED)
    want = pipe.simulate(cfg, SEED, device="cpu")
    torch.testing.assert_close(got[0], want.bit_errors, rtol=0, atol=0)
    torch.testing.assert_close(got[1], want.bits_counted, rtol=0, atol=0)
    got = make_sharded_stream_fn(cfg, mesh, n_blocks=2, device="cpu")(SEED)
    for a, b in zip(got, stream_simulate(cfg, SEED, 2, device="cpu")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_default_to_the_card():
    import inspect

    for builder in (make_sharded_fast_fn, make_sharded_coded_fast_fn, make_pipelined_fast_fn,
                    make_sharded_mc_fn, make_sharded_simulate_fn, make_sharded_stream_fn,
                    make_sharded_coded_fn):
        assert inspect.signature(builder).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_sharded_fast_fn(_small(ChannelModel.AWGN), make_link_mesh())


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match=r"rank \d failed"):
        dryrun.spawn(2, dryrun.run_cases, ("cpu", [dict(kind="fast", mesh=(3, 1))]),
                     timeout=120)
