"""torch_ms_per_call: device ms a call of the kernels that are not the
port's own CUDA kernels (torch's draws, FFTs, gathers, elementwise and
reductions). Layer: torch ops. Moves link_gsps."""

from linkbench.harness import layers

# Every __global__ function of the port's CUDA sources.
PORT_KERNELS = (
    "payload_kernel", "tx_rows_kernel", "tx_kernel", "tx_fir_kernel", "demod_rows_kernel",
    "demod_count_kernel", "demod_llr_kernel", "demod_sum_cl_kernel", "demod_count_cl_kernel",
    "demod_llr_cl_kernel", "sum_partials_kernel", "llr_chain_kernel", "mc_kernel",
    "ldpc_minsum_kernel", "fade_stream_kernel", "fade_fir_kernel",
)


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    port = set(PORT_KERNELS)
    us = sum(e.end - e.start for e in ctx.trace.kernels()
             if layers.base_name(e.name) not in port)
    return us / 1e3 / ctx.trace.calls
