"""Roofline accounting for the demod chain (port of
``sdr_tpu/obs/roofline.py``).

Computes the analytic traffic and operation model of the receive chain
(CP strip → FFT → equalize → LLR) and turns a measured throughput into a
fraction of the speed of light, so bench output is judged against the
card's limits.

The traffic model is the JAX module's. The operation model is the
port's: kernel C runs its own radix FFT, 5·N·log2(N) real operations a
symbol (``chip_smoke.fft_flops``), where the TPU kernels ran the DFT as
an 8·N² matmul on the MXU; the equalize + LLR tail is the JAX module's
estimate. So the port's ``bound`` can differ from the JAX package's for
the same shape.
"""

from __future__ import annotations

import dataclasses
import math

from sdr_tpu_torch.core.config import Modulation

# ``obs.health.hbm_bandwidth_gbps()`` (its defaults: 32 Mi floats, 12
# chained read+write passes, one kernel a pass, CUDA events) on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit, chip_smoke.py phase 3z; a
# device copy of the same buffer read 2899.6 in the same run.
HBM_GBPS_MEASURED_H100 = 2880.3


@dataclasses.dataclass(frozen=True)
class ChipProfile:
    name: str
    hbm_gbps: float           # datasheet memory bandwidth
    hbm_gbps_measured: float  # sustained, measured by ``obs.health.hbm_bandwidth_gbps``
    f32_tflops: float         # f32 peak

    @classmethod
    def h100(cls) -> "ChipProfile":
        # H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s f32 (the
        # figures of chip_smoke.HBM_BYTES_PER_S and F32_FLOPS).
        return cls("nvidia-h100-sxm", 3350.0, HBM_GBPS_MEASURED_H100, 67.0)


@dataclasses.dataclass
class RooflineReport:
    bytes_per_sample: float
    flops_per_sample: float
    bound: str                    # "memory" | "compute"
    sol_samples_per_s: float      # speed-of-light on measured bandwidth
    sol_samples_per_s_datasheet: float
    achieved_samples_per_s: float | None = None

    @property
    def efficiency(self) -> float | None:
        if self.achieved_samples_per_s is None:
            return None
        return self.achieved_samples_per_s / self.sol_samples_per_s


def demod_flops_per_symbol(n_fft: int, mod: Modulation) -> float:
    """Real operations of one symbol's receive: the radix FFT
    (5·N·log2 N) and the equalize + LLR tail (N·(10 + 4·levels))."""
    return 5.0 * n_fft * math.log2(n_fft) + n_fft * (10 + 4 * mod.levels_per_axis)


def demod_roofline(
    n_fft: int,
    cp_len: int,
    mod: Modulation,
    chip: ChipProfile | None = None,
    fused: bool = True,
    write_llrs: bool = False,
    measured_samples_per_s: float | None = None,
    input_bytes_per_component: int = 4,
) -> RooflineReport:
    """Roofline for CP-strip → FFT → equalize → LLR, per input sample.

    ``fused``: the single-kernel path (memory traffic = planar input read
    + optional LLR write; everything else on chip). Non-fused models the
    composition that materialises the FFT's input and output. A "sample"
    is one complex time sample entering the chain (CP included).

    ``input_bytes_per_component``: 4 for float32 planes, 2 for bfloat16
    sample planes (kernel D's bf16 input) — halves the memory speed of
    light's denominator.
    """
    chip = chip or ChipProfile.h100()
    sym = n_fft + cp_len
    bps = mod.bits_per_symbol

    # planar re+im per complex sample
    in_bytes = sym * 2 * input_bytes_per_component
    llr_bytes = n_fft * bps * 4
    if fused:
        b = in_bytes + (llr_bytes if write_llrs else 0)
    else:
        # input read + FFT in/out materialization + equalize/LLR read
        # (+ LLR write).
        b = in_bytes + 3 * n_fft * 8 + (llr_bytes if write_llrs else 0)
    bytes_per_sample = b / sym
    flops_per_sample = demod_flops_per_symbol(n_fft, mod) / sym

    t_mem = bytes_per_sample / (chip.hbm_gbps_measured * 1e9)
    t_cmp = flops_per_sample / (chip.f32_tflops * 1e12)
    bound = "memory" if t_mem >= t_cmp else "compute"
    sol = 1.0 / max(t_mem, t_cmp)
    t_mem_ds = bytes_per_sample / (chip.hbm_gbps * 1e9)
    sol_ds = 1.0 / max(t_mem_ds, t_cmp)

    return RooflineReport(
        bytes_per_sample=bytes_per_sample,
        flops_per_sample=flops_per_sample,
        bound=bound,
        sol_samples_per_s=sol,
        sol_samples_per_s_datasheet=sol_ds,
        achieved_samples_per_s=measured_samples_per_s,
    )
