"""Build, load and bind the port's CUDA kernels; launch counters.

All kernels live in one shared library built from
``sdr_tpu_torch/csrc/*.cu`` by ``nvcc`` for ``sm_90a`` (Hopper) at first
use, with a plain C interface bound through ``ctypes`` — seconds to
build, against minutes for an extension that includes PyTorch's
headers. Each source compiles in its own ``nvcc`` process, all started
together, and one more links the objects. The library goes to
``sdr_tpu_torch/_build/<source hash>/`` (git-ignored) and is rebuilt
when a source or the flags change.

Nothing is built or loaded at import: ``lib()`` does it on the first
kernel launch. The module keeps the only global state of the package:
the library handle and the per-kernel launch counters, which each
wrapper bumps exactly where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from sdr_tpu_torch.core.config import Modulation

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Launch counters, one per kernel and mode: "tx_taps" is kernel B's FIR
# mode, "tx_off" its channel-off mode (no gain, no FIR, no noise),
# "tx_comb" any of its modes with the pilot comb, "demod_count_comb"
# kernel C's count skipping the comb's tones,
# "fade_awgn_fir" kernel E's FIR mode ("fade_awgn" its gains and noise),
# "demod_count_taps" and "demod_count_despread" kernel C's taps= and
# despread modes, "demod_llr"/"demod_sum" (and their "_despread"
# forms) C's LLR-plane and sum modes, "demod_llr_cl"/"demod_llr_cl_bf16"
# F's LLR mode, "*_in_bf16" D's and F's modes on bf16 sample planes
# (one per output type of F's plane), "mc_count" kernel G, "ldpc_minsum"
# kernel H (rows layout, flooding; "_t" transposed, "_layered" the layered
# schedule), "llr_chain"/"llr_chain_sum" C's post-FFT mode,
# "tp_stage2_llr" C's tensor-parallel stage-2 mode.
LAUNCHES = {"payload": 0, "tx": 0, "tx_taps": 0, "tx_off": 0, "demod_count": 0, "demod_count_taps": 0,
            "demod_count_despread": 0, "demod_sum_cl": 0, "fade_awgn": 0,
            "fade_awgn_fir": 0, "demod_count_cl": 0, "mc_count": 0, "demod_llr": 0, "demod_sum": 0,
            "demod_llr_despread": 0, "demod_sum_despread": 0, "demod_llr_cl": 0,
            "demod_llr_cl_bf16": 0, "ldpc_minsum": 0, "ldpc_minsum_layered": 0,
            "ldpc_minsum_t": 0, "ldpc_minsum_t_layered": 0, "llr_chain": 0,
            "llr_chain_sum": 0, "demod_sum_cl_in_bf16": 0, "demod_count_cl_in_bf16": 0,
            "demod_llr_cl_in_bf16": 0, "demod_llr_cl_bf16_in_bf16": 0, "tp_stage2_llr": 0,
            "tx_comb": 0, "demod_count_comb": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    return BUILD_ROOT / source_hash() / "libsdr_torch_kernels.so"


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the output of each that
    failed. Every process has ended when this returns or raises."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"({proc.returncode}) {' '.join(cmd)}\n{out}\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the library if this source hash has not been built yet;
    returns its path. Concurrent builds race safely: each works in its
    own temporary directory and renames the library into place."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for obj, src in zip(objs, srcs)])
        lib_tmp = os.path.join(tmp, so.name)
        _run_all([[nvcc, "-shared", "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, so)
    return so


class AxisTables(ctypes.Structure):
    """Per-modulation constants passed by value (csrc/common.cuh)."""

    _fields_ = [
        ("lev", ctypes.c_float * 32),
        ("lev2", ctypes.c_float * 32),
        ("two_abs", ctypes.c_float * 32),
        ("norm2", ctypes.c_float),
        ("inorm", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def axis_tables(mod: Modulation) -> AxisTables:
    """Level tables in the JAX kernels' rounding order: each level is
    pam·norm in float64 (norm itself float32), rounded once to float32."""
    from sdr_tpu_torch.ops.modulation import _tables

    _, pam, norm, inorm = _tables(mod)
    t = AxisTables()
    for g, a in enumerate(pam):
        lev = float(a) * float(norm)
        t.lev[g] = lev
        t.lev2[g] = lev * lev
        t.two_abs[g] = 2.0 * abs(lev)
    t.norm2 = float(norm) * float(norm)
    t.inorm = float(inorm)
    return t


_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_LL = ctypes.c_longlong


class McParams(ctypes.Structure):
    """Kernel G's launch parameters, passed by value (csrc/mc.cu)."""

    _fields_ = [
        *((name, _P) for name in ("ch_ids", "out", "idx_in", "n_re", "n_im", "h_re", "h_im",
                                  "amps", "twr", "twi")),
        *((name, _I) for name in ("B", "S", "log_n", "cp", "spc", "n_chunks", "kind",
                                  "n_taps", "h_syms", "noise")),
        *((name, _U) for name in ("kp0", "kp1", "kn0", "kn1", "kf0", "kf1")),
        ("idx_mask", _I),
        *((name, _F) for name in ("sigma", "nv", "inv_nv", "tx_scale", "spread_scale", "a_los",
                                  "s_dif", "jakes_w")),
    ]

_SIGNATURES = {
    "sdr_payload": [_P, _I, _P, _I, _I, _I, _I, _I, _U, _U, _P],
    "sdr_tx": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _I,
               _I, _P, _P, _P, _U, _U, _F, _I, _F, _F, _P],
    "sdr_tx_fir": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _I, _I,
                   _I, _P, _P, _P, _U, _U, _F, _P],
    "sdr_fade_awgn": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I,
                      _P, _P, _P, _U, _U, _F, _P],
    "sdr_demod_count": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                        _I, AxisTables, _F, _F, _I, _I, _P, _P, _P],
    "sdr_demod_sum_cl_partials": [_I, _I, _I],
    "sdr_demod_sum_cl": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         AxisTables, _F, _P, _P, _P],
    "sdr_demod_count_cl": [_P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                           AxisTables, _F, _P, _P, _P],
    "sdr_mc_count": [McParams, _I, _I, _I, AxisTables, _P],
    "sdr_demod_llr_partials": [_I, _I, _I],
    "sdr_demod_llr": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, AxisTables, _F, _F,
                      _I, _I, _P, _P, _P],
    "sdr_demod_llr_cl": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, AxisTables, _F,
                         _P, _P, _P],
    "sdr_ldpc_minsum": [_P, _P, _P, _I, _I, _F, _I, _LL, _LL, _LL, _P],
    "sdr_llr_chain_partials": [_I, _I, _I],
    "sdr_llr_chain": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, AxisTables, _F, _I, _P],
    "sdr_tp_stage2_llr": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, AxisTables, _P,
                          _P, _P],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def twiddles(n: int, device: torch.device):
    """Forward twiddles e^{-2πik/n}, k < n/2, computed in float64 on the
    device and rounded once, as (re, im) float32 tensors; built once per
    (n, device) and shared by every later call (the kernels only read
    them)."""
    ang = torch.arange(max(n // 2, 1), dtype=torch.float64, device=device) * (-2.0 * math.pi / n)
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def log2_exact(n: int) -> int:
    lg = int(math.log2(n)) if n > 0 else -1
    if n <= 0 or (1 << lg) != n:
        raise ValueError(f"{n} is not a power of two")
    return lg


def require_aligned(name: str, align: int, *tensors: torch.Tensor) -> None:
    """Every operand's first byte on an ``align``-byte boundary."""
    if any(t.data_ptr() % align for t in tensors):
        raise ValueError(f"{name}: operands must start on {align}-byte boundaries")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
