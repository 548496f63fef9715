"""ldpc_roofline: kernel H (kernels/ldpc.py → csrc/ldpc.cu) against its
bound at the cell's shapes, in %: n float32 LLRs in and n bytes out a
codeword, 10 operations a lifted edge an iteration (the engine's
``stage_work("ldpc")``). Layer: kernel H. Moves link_gsps."""

from linkbench.harness import layers

KERNELS = ("ldpc_minsum_kernel",)


def read(ctx):
    return layers.stage_share(ctx, "ldpc", KERNELS)
