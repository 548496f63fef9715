"""mc_roofline: kernel G (kernels/mc.py → csrc/mc.cuh) against its bound
at the cell's shapes, in %: each keyed pass's ids in and counts out, two
FFTs and the tail a tone, a Philox call a noise sample and a quarter an
index, times the passes a call (the engine's ``stage_work("mc")``).
Layer: kernel G. Moves link_gsps."""

from linkbench.harness import layers

KERNELS = ("mc_kernel",)


def read(ctx):
    return layers.stage_share(ctx, "mc", KERNELS)
