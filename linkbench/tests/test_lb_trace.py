"""The trace reader and each per-layer metric's reader, on a synthetic
profiler event list."""

import time
import types

import pytest
import torch

from linkbench.harness import layers, spec
from linkbench.harness import trace as tr
from linkbench.harness.workmodel import bound_ms, demod_count, tx

E = tr.Event


def _events():
    """Two engine calls of 1000 us each; a call's kernels: A 50 us, B 400,
    a torch kernel 100, C 200, the counts' copy 10."""
    ev = []
    for k in range(2):
        t = k * 1000.0
        ev.append(E("engine.call", False, t, t + 300))
        ev.append(E("host.read_counts", False, t + 300, t + 900))
        ev.append(E("void payload_kernel<signed char>(signed char*, int const*, int)", True,
                    t + 100, t + 150))
        ev.append(E("void (anonymous namespace)::tx_rows_kernel<2, false, 8, 1, true>(TxArgs)",
                    True, t + 150, t + 550))
        ev.append(E("void at::native::vectorized_elementwise_kernel<4>(int)", True, t + 550,
                    t + 650))
        ev.append(E("void (anonymous namespace)::demod_rows_kernel<float, 2, false>(RowsArgs, "
                    "sdr::AxisTables)", True, t + 650, t + 850))
        ev.append(E("Memcpy DtoH (Device -> Pinned)", True, t + 850, t + 860))
        ev.append(E("engine.call", True, t, t + 300))  # a device-side annotation: not work
    ev.append(E("aten::add", False, 5.0, 6.0))
    return ev


STAGES = {"tx": tx(8192, 64, 256, 64, 4, 4), "demod": demod_count(8192, 64, 256, 4)}


def _calls(n, period_s):
    return [types.SimpleNamespace(index=k, t_start=k * period_s, failed=False) for k in range(n)]


def _ctx(trace, cell_name="fast-config2-multipath", calls=None):
    """The fast engine's stages, whose link work is B's; a window of 40
    calls at 1 ms a call unless given."""
    cell = spec.cell(cell_name)
    engine = types.SimpleNamespace(stage_work=STAGES.get,
                                   link_work=lambda: tx(8192, 64, 256, 64, 4))
    return types.SimpleNamespace(
        cell=cell, engine=engine, trace=trace,
        window=types.SimpleNamespace(calls=_calls(40, 1e-3) if calls is None else calls))


def test_build_window_busy_and_gaps():
    t = tr.build(_events())
    assert t.calls == 2
    assert (t.t0, t.t1) == (0.0, 1900.0)
    assert len(t.kernels()) == 8
    assert t.busy_us() == pytest.approx(2 * 760)
    gaps = t.idle_gaps()
    assert gaps[0] == (0.0, 100.0) and gaps[-1] == (1860.0, 1900.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["tx_rows_kernel", pytest.approx(800e-6)]
    assert dict(b["idle_gaps"]) == pytest.approx({"engine.call": 100e-6,
                                                  "host.read_counts": 280e-6})


def test_short_and_base_names():
    assert tr.short_name("void sdr::tx_rows_kernel<4, 1, true>(TxArgs)") == "sdr::tx_rows_kernel"
    assert tr.short_name("void (anonymous namespace)::mc_kernel<3, false>(McParams)") == "mc_kernel"
    assert tr.short_name("at::native::vectorized_elementwise_kernel<4, F>(int, F)") == \
        "at::native::vectorized_elementwise_kernel"
    assert layers.base_name("void sdr::tx_rows_kernel<4>(A)") == "tx_rows_kernel"
    assert tr.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def test_readers_on_the_trace():
    ctx = _ctx(tr.build(_events()))

    def read(name):
        return spec.load_module("metrics", name).read(ctx)

    assert read("kernels_per_call") == 4
    assert read("torch_ms_per_call") == pytest.approx(0.1)
    # 760 us busy a traced call against the window's 1 ms a call.
    assert read("device_idle") == pytest.approx(100 * (1 - 0.76))
    assert read("tx_roofline") == pytest.approx(100 * bound_ms(tx(8192, 64, 256, 64, 4, 4)) / 0.4)
    assert read("demod_roofline") == pytest.approx(
        100 * bound_ms(demod_count(8192, 64, 256, 4)) / 0.2)
    assert read("link_mfu") == pytest.approx(100 * bound_ms(tx(8192, 64, 256, 64, 4)) / 1.0)
    # Stages the engine does not run read nothing, not 0.
    assert read("mc_roofline") is None
    assert read("ldpc_roofline") is None


def test_a_stage_the_engine_runs_but_the_trace_lacks_reads_nothing():
    ctx = _ctx(tr.build(_events()))
    ctx.engine.stage_work = {"mc": tx(8192, 64, 256, 64, 4)}.get
    assert spec.load_module("metrics", "mc_roofline").read(ctx) is None


def test_the_demod_share_takes_the_mode_the_engine_declares():
    """The reader holds C's time to whichever work the engine names: the
    plane's bound where an engine runs the plane, with no edit to it."""
    from linkbench.harness.workmodel import demod_plane

    ctx = _ctx(tr.build(_events()))
    plane = demod_plane(8192, 64, 256, 4)
    ctx.engine.stage_work = {"demod": plane}.get
    assert spec.load_module("metrics", "demod_roofline").read(ctx) == pytest.approx(
        100 * bound_ms(plane) / 0.2)


def test_readers_without_a_trace_read_nothing():
    ctx = _ctx(None)
    for m in spec.manifest()["per_layer"]:
        if m["source"] == "device_trace":
            assert spec.load_module("metrics", m["name"]).read(ctx) is None


def test_host_clock_readers():
    calls = [types.SimpleNamespace(index=0, t_start=0.0, t_return=0.002, t_done=0.010,
                                   failed=False),
             types.SimpleNamespace(index=1, t_start=1.0, t_return=1.004, t_done=1.020,
                                   failed=False),
             types.SimpleNamespace(index=2, t_start=2.0, t_return=9.0, t_done=9.0, failed=True)]
    ctx = types.SimpleNamespace(window=types.SimpleNamespace(calls=calls))
    assert spec.load_module("metrics", "host_ms_per_call").read(ctx) == pytest.approx(3.0)


def test_the_period_skips_the_first_calls_and_needs_two():
    ctx = _ctx(tr.build(_events()),
               calls=[types.SimpleNamespace(index=k, t_start=0.1 * k * k, failed=False)
                      for k in range(5)])
    # calls 2..4 start at 0.4, 0.9 and 1.6 s: 600 ms a call.
    assert layers.period_ms(ctx) == pytest.approx(600.0)
    ctx.window.calls = ctx.window.calls[:3]
    assert layers.period_ms(ctx) is None
    assert spec.load_module("metrics", "link_mfu").read(ctx) is None
    assert spec.load_module("metrics", "device_idle").read(ctx) is None


def test_the_tracer_covers_the_calls_it_names():
    """The profiler runs over the calls after the window, each its own
    span, with grid point 2's seeds; the window's calls run before it."""
    from torch.profiler import ProfilerActivity

    from linkbench.harness import runner
    from linkbench.harness.window import Spans, invocation_seed

    seeds = []

    def call(seed):
        seeds.append(seed)
        time.sleep(0.002)
        return torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)

    engine = types.SimpleNamespace(n_channels=2, bits_per_channel=1)
    prof = runner._trace(call, engine, 9, 2, torch.device("cpu"), Spans(annotate=True),
                         activities=[ProfilerActivity.CPU])
    spans = [e for e in tr.from_profiler(prof) if e.name == "engine.call"]
    assert 10 <= len(spans) == len(seeds)
    assert seeds == [invocation_seed(9, runner.TRACE_POINT, k) for k in range(len(seeds))]


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(ValueError):
        tr.build([E("engine.call", False, 0.0, 1.0)])
