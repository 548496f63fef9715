"""demod_roofline: kernel C (kernels/demod.py → csrc/demod_rows.cuh,
demod_*.cu) against its bound at the cell's shapes, in %, in the mode the
cell's engine declares (``stage_work("demod")``: the count on the fast
link, the LLR plane on the coded link's staged seam); S·N sample rows
read (C never loads the CP), one h row a channel. Layer: kernel C.
Moves link_gsps."""

from linkbench.harness import layers

KERNELS = ("demod_rows_kernel", "demod_count_kernel", "demod_llr_kernel")


def read(ctx):
    return layers.stage_share(ctx, "demod", KERNELS)
