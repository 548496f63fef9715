"""tx_roofline: kernel B (kernels/tx.py → csrc/tx_rows.cuh, tx.cu,
tx_fir.cu) against its bound at the cell's shapes, in %. B's work, as the
cell's engine declares it (``stage_work("tx")``): the indices in, the
CP'd planes out, the taps or gains in, the inverse FFT, per sample the
FIR or gain and the keyed noise. Layer: kernel B. Moves link_gsps."""

from linkbench.harness import layers

KERNELS = ("tx_rows_kernel", "tx_kernel", "tx_fir_kernel")


def read(ctx):
    return layers.stage_share(ctx, "tx", KERNELS)
