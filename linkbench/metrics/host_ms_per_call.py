"""host_ms_per_call: the mean host time from the start of an engine call
to its return, its counts still on the device (the benchmark's host
clock, over the window's calls). Layer: engine. Moves link_gsps."""


def read(ctx):
    times = [(c.t_return - c.t_start) * 1e3 for c in ctx.window.calls if not c.failed]
    return sum(times) / len(times) if times else None
