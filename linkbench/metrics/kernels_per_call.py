"""kernels_per_call: device kernels (the port's and torch's, not the
copies) in the traced window, divided by the engine calls there. Layer:
engine. Moves link_gsps."""


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    return len(ctx.trace.kernels()) / ctx.trace.calls
