"""link_mfu: the whole call's share of the chip's peak, in %: the least
time the card needs for the work a call's counts depend on (the engine's
``link_work``: draws, transforms, channel, tail, decoder; the counts as
bytes) ÷ the window's period a call (the window runs without the
profiler). It bounds every kernel's gain: a later change that removes or
fuses a kernel still shows here. Layer: device. Moves link_gsps."""

from linkbench.harness import layers, workmodel


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    return layers.share_pct(workmodel.bound_ms(ctx.engine.link_work()),
                            layers.period_ms(ctx))
