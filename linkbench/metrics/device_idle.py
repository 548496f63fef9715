"""device_idle: 100 · (1 − the device-busy time a traced call ÷ the
window's period a call), in %. The busy time is the union of the
device's busy intervals over the trace, divided by the engine calls
there; the period is the window's, which runs without the profiler,
because the profiler's own host work slows the calls it traces. Where
the device paces the calls it reads about 0, and a little below where
the two clocks differ by their noise. Layer: device. Moves link_gsps."""

from linkbench.harness import layers


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    period = layers.period_ms(ctx)
    if period is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / 1e3 / ctx.trace.calls / period)
