"""Helpers of the per-layer metrics' readers: a stage's device time a
call, from the kernels its metric file names; its share of the bound of
the work the cell's engine declares for it; the window's period a call."""

from __future__ import annotations

from linkbench.harness import trace as tr
from linkbench.harness import workmodel


def base_name(name: str) -> str:
    """A kernel's function name without namespace, templates and parameters."""
    return tr.short_name(name).split("::")[-1]


def stage_ms_per_call(trace, kernels) -> float | None:
    """Device ms a call of the kernels named ``kernels``; None when the
    trace holds none of them or no call."""
    wanted = set(kernels)
    us = sum(e.end - e.start for e in trace.kernels() if base_name(e.name) in wanted)
    if us <= 0 or trace.calls == 0:
        return None
    return us / 1e3 / trace.calls


def share_pct(bound_ms: float, ms: float | None) -> float | None:
    """100 · bound / measured time; None when nothing was measured."""
    if ms is None or ms <= 0:
        return None
    return 100.0 * bound_ms / ms


def stage_share(ctx, stage: str, kernels) -> float | None:
    """The share, in %, of the bound of ``ctx.engine.stage_work(stage)``
    that the kernels named ``kernels`` reach in the trace; None where the
    engine runs no such stage or the trace holds none of the kernels."""
    if ctx.trace is None:
        return None
    work = ctx.engine.stage_work(stage)
    if work is None:
        return None
    return share_pct(workmodel.bound_ms(work), stage_ms_per_call(ctx.trace, kernels))


def period_ms(ctx, skip: int = 2) -> float | None:
    """The window's period a call, from the start of call ``skip`` to the
    start of the last; None with fewer than two such calls."""
    calls = [c for c in ctx.window.calls if c.index >= skip and not c.failed]
    if len(calls) < 2:
        return None
    return (calls[-1].t_start - calls[0].t_start) * 1e3 / (len(calls) - 1)
