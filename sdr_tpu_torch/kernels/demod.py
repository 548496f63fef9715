"""Kernel C: rows-layout demod + per-channel error count (port of
``sdr_tpu/kernels/demod_pallas.py::demod_count_pallas`` with its
``taps=`` and ``despread`` modes).

Planar samples (B, S, N+cp) → CP strip → forward unscaled DFT →
one-tap unbiased equalisation s = conj(h)·y / max(|h|², 1e-12) with
LLRs scaled by |h|²/nv (so h → 0 fades LLRs to zero instead of
dividing by ~0) → max-log LLR, I bits then Q bits, MSB first → hard
decision (LLR < 0) against the transmitted indices → per-channel
(B,) int32 bit-error count. Noise variance is clamped at 1e-12.

The channel is a plane h (B, 1 | S, N), or, with ``taps=(taps_r,
taps_i)``, per-symbol FIR taps (B, S, L ≤ 8) whose response
H[k] = Σ_l t_l·e^{−2πikl/N} the kernel builds per bin, so the (B, S, N)
plane never exists in device memory; that mode counts its launches
under ``demod_count_taps``.

``pilot_spacing`` (in [2, N], not with ``despread``; 0 off) counts the
data tones of the OFDM pilot comb alone: tone k with k % pilot_spacing
== 0 carries ``ops.pilots.PILOT_VALUE``, no payload, and is skipped, so
the count is the JAX count over ``ops.pilots.data_indices``. That mode
counts its launches under ``demod_count_comb``.

``despread=True`` is the SC-FDE receive of full-grid SC-FDMA
(``ops.equalize.equalize_mmse_fde``): per tone the biased MMSE
conj(h)·y/(|h|² + nv), per symbol the tone mean b = max(mean(|h|²/(|h|² +
nv)), 1e-9), an N-point inverse DFT scaled by 1/√N, division by b, LLRs
at SINR b/(1 − b), counted against the TIME-domain indices. It takes the
h plane (not taps) and counts its launches under
``demod_count_despread``.

The LLR-plane and sum modes (``demod_llr``, port of
``demod_pallas.py::demod_chain_pallas``, with ``despread``) run the same
transform and tail over an h plane and store the (B, S, N·bps) float32
plane in the public order, or sum it deterministically; they count their
launches under ``demod_llr``, ``demod_sum``, ``demod_llr_despread`` and
``demod_sum_despread``. Their plain version is the plain LLR plane,
``demod_chain``, which the count's plain version, the channels-last plain
versions (``kernels/demod_cl.py``) and the tests reuse.

The post-FFT mode (``llr_chain``, port of
``sdr_tpu/kernels/llr_pallas.py::llr_chain_pallas``) takes the
frequency-domain grid (B, S, N), transformed outside the kernel, as two
planes or as one interleaved complex64 plane read in place, and runs the
same equaliser and LLR tail, storing the plane or summing it (counters
``llr_chain`` and ``llr_chain_sum``); its plain version is
``demod_chain`` minus the FFT.

At N = 1024 to 4096 every mode here also serves the JAX package's
wideband four-step kernels (``fourstep_split_pallas.py``,
``fourstep_pallas.py``): one transform per symbol replaces their N1·N2
matmul split, which existed because dense DFT operands outgrew VMEM.

Three forms run on the card. The count (h plane and ``taps=``), the LLR
plane and the sum, each with or without ``despread``, and the TP stage-2
mode at N = 128 to 4096 take the warp-group form (``csrc/demod_rows.cuh``;
built from ``demod_count.cu``, ``demod_llr.cu``, ``demod_despread_*.cu``
and ``demod_tp.cu``): a group of 1–8 warps holds one symbol
in registers (4, 8, 16 points a lane to N 512, then 2, 4, 8 warps of 16),
loaded straight from the sample planes in the transform's time layout,
transformed by shuffles across lanes and register DFTs (kernel G's
transform, ``csrc/warpfft.cuh``), its tones then taken in natural order
through one shared-memory pass; a block takes a run of 32 symbols of one
channel and stages h (one row a channel) or the W_N^k table of the
``taps=`` mode once. The ``despread`` modes run a second transform, the
inverse, from the tones to the time samples, with the MMSE weights and
the bias built once a block for one h row a channel, or per symbol in one
shared-memory pass for one a symbol. The TP mode is the plane over
digit rows (b, k1) with no CP and the noise variance read on the card.
N = 2 to 64 of every mode stays on the shared-memory tile
(``csrc/demod.cu``): a block's symbols bit-reversed in shared memory and
radix-2 stages a barrier each. The post-FFT mode has no transform and its
own streaming form (``csrc/llr_chain.cu``): a block takes a run of
symbols of one channel, a thread four consecutive tones of a row at the
same k in every symbol, so h and its gains are loaded and built once a
run (one h row a channel); y comes in as 16-byte vectors, the LLRs leave
as 16-byte runs, the sum in a fixed order.

The tensor-parallel stage-2 mode (``tp_stage2_llr``, port of
``sdr_tpu/parallel/tp.py::_stage2_llr_pallas``) takes one rank's digit
block of the distributed four-step transform: the twiddled stage-1
output t (B, S, n1d, n2) after the all_to_all and the digit-major
channel (B, 1 | S, n1d, n2), runs the n2-point forward DFT, the
equaliser and the LLR tail, and stores (B, S, n1d, n2·bps)
subcarrier-major; the noise variance is a 0-d float32 tensor on the
card, read by the kernel (counter ``tp_stage2_llr``). Its plain version
is ``stage2_llr_plain``: torch's FFT, then ``post_fft_llr``.

On a CPU tensor the plain version runs; on a CUDA tensor the CUDA
kernel runs, or the call raises. GPU tests of the post-FFT and TP modes:
``python -m pytest tests/test_torch_kernels_cuda.py -m gpu -q
--noconftest -k "llr_chain or tp_stage2"``.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.ops.channel import freq_response
from sdr_tpu_torch.ops.equalize import equalize_mmse_fde
from sdr_tpu_torch.ops.fft import fft
from sdr_tpu_torch.ops.llr import axis_metric
from sdr_tpu_torch.ops.modulation import _ints_to_bits
from sdr_tpu_torch.ops.ofdm import ofdm_rx
from sdr_tpu_torch.ops.pilots import data_tones

_IDX_DTYPES = (torch.int8, torch.int16, torch.int32)
MAX_N_FFT = 4096  # the warp-group form's widest: 8 warps of 16 points a lane
MAX_TAPS = 8  # the taps= mode's budget (demod_pallas.py:541)


def inv_noise_var(noise_var: float) -> float:
    """1/max(nv, 1e-12), the clamp every demod terminal applies."""
    return 1.0 / max(float(noise_var), 1e-12)


def demod_chain(re, im, hr, hi, cp_len: int, mod: Modulation, noise_var: float,
                reduce_sum: bool = False, despread: bool = False):
    """Plain LLR plane over (..., S, N+cp) planar samples; hr/hi broadcast
    against the post-FFT grid (..., S, N). Returns (..., S, N·bps)
    float32 in the public order (per subcarrier, or per time symbol with
    ``despread``; I bits then Q bits, MSB first), or its float32 sum when
    ``reduce_sum``. ``despread``: the SC-FDE receive
    (``equalize_mmse_fde``), as the JAX package's ``demod_chain_jnp``."""
    y = ofdm_rx(torch.complex(re.to(torch.float32), im.to(torch.float32)), cp_len)
    return post_fft_llr(y, hr, hi, mod, noise_var, reduce_sum, despread)


def post_fft_llr(y, hr, hi, mod: Modulation, noise_var: float, reduce_sum: bool = False,
                 despread: bool = False):
    """``demod_chain`` after its FFT: the complex post-FFT grid (..., S, N)
    through the equaliser and the max-log LLRs."""
    hr = hr.to(torch.float32)
    hi = hi.to(torch.float32)
    if despread:
        s, eff = equalize_mmse_fde(y, torch.complex(hr, hi), max(float(noise_var), 1e-12))
        sr, si, inv_eff = s.real, s.imag, (1.0 / eff)[..., None]
    else:
        h2 = hr * hr + hi * hi
        inv_h2 = 1.0 / torch.clamp(h2, min=1e-12)
        sr = (hr * y.real + hi * y.imag) * inv_h2
        si = (hr * y.imag - hi * y.real) * inv_h2
        inv_eff = (h2 * inv_noise_var(noise_var))[..., None]
    axes = [axis_metric(torch.broadcast_to(sr, y.shape), mod) * inv_eff]
    if mod is not Modulation.BPSK:
        axes.append(axis_metric(torch.broadcast_to(si, y.shape), mod) * inv_eff)
    llr = torch.cat(axes, dim=-1)
    llr = llr.reshape(*y.shape[:-1], y.shape[-1] * mod.bits_per_symbol)
    if reduce_sum:
        return llr.sum(dtype=torch.float32)
    return llr


def count_errors(llr: torch.Tensor, idx: torch.Tensor, bps: int) -> torch.Tensor:
    """Per-channel (B,) int32 count of hard decisions (LLR < 0) that
    differ from the bits of the transmitted indices (B, S, N)."""
    bits = _ints_to_bits(idx, bps)
    return ((llr < 0).to(torch.int8) != bits).sum(dim=(1, 2), dtype=torch.int32)


def supported(shape, h_shape, idx_shape, cp_len: int) -> bool:
    """(B, S, N+cp) samples, N a power of two in [2, 4096], h (B, 1|S, N)
    or taps (B, S, L ≤ 8), idx (B, S, N)."""
    if len(shape) != 3:
        return False
    B, S, sym_len = shape
    n = sym_len - cp_len
    if not (2 <= n <= MAX_N_FFT and (n & (n - 1)) == 0 and 0 <= cp_len):
        return False
    h_shape = tuple(h_shape)
    h_ok = h_shape in ((B, 1, n), (B, S, n)) or (
        len(h_shape) == 3 and h_shape[:2] == (B, S) and 1 <= h_shape[2] <= MAX_TAPS
    )
    return h_ok and tuple(idx_shape) == (B, S, n)


def taps_plane(taps, n_fft: int):
    """(taps_r, taps_i) (B, S, L) → the (hr, hi) planes (B, S, N) they
    stand for: the plain version of the taps= mode's in-kernel H."""
    h = freq_response(torch.complex(taps[0].to(torch.float32), taps[1].to(torch.float32)), n_fft)
    return h.real.contiguous(), h.imag.contiguous()


def _check_comb(pilot_spacing: int, n_fft: int, despread: bool) -> None:
    if pilot_spacing and not 2 <= pilot_spacing <= n_fft:
        raise ValueError(f"demod count: pilot_spacing must be 0 or in [2, {n_fft}], got "
                         f"{pilot_spacing}")
    if pilot_spacing and despread:
        raise ValueError("demod count: the pilot comb is an OFDM grid; despread takes none")


def demod_count_plain(re, im, hr, hi, idx, cp_len: int, mod: Modulation, noise_var: float,
                      taps=None, despread: bool = False, pilot_spacing: int = 0):
    """Plain torch version of the count."""
    _check_comb(pilot_spacing, idx.shape[-1], despread)
    if taps is not None:
        hr, hi = taps_plane(taps, idx.shape[-1])
    llr = demod_chain(re, im, hr, hi, cp_len, mod, noise_var, despread=despread)
    if pilot_spacing:
        llr = data_tones(llr, pilot_spacing, mod.bits_per_symbol)
        idx = data_tones(idx, pilot_spacing)
    return count_errors(llr, idx, mod.bits_per_symbol)


def demod_count(re, im, hr, hi, idx, cp_len: int, mod: Modulation, noise_var: float,
                taps=None, despread: bool = False, pilot_spacing: int = 0):
    """Per-channel (B,) int32 bit-error counts.

    re/im (B, S, N+cp) float32; hr/hi (B, 1, N) or (B, S, N) float32, or
    None with ``taps=(taps_r, taps_i)`` float32 (B, S, L ≤ 8); idx
    (B, S, N) int8/int16/int32 transmitted symbol indices (time-domain
    symbols with ``despread``, which takes the h plane, not taps);
    ``pilot_spacing``: count the data tones of the comb alone."""
    if despread and taps is not None:
        raise ValueError("demod count: despread takes the h plane, not taps=")
    if re.device.type == "cpu":
        return demod_count_plain(re, im, hr, hi, idx, cp_len, mod, noise_var, taps, despread,
                                 pilot_spacing)
    chan = (hr, hi) if taps is None else tuple(taps)
    if not supported(re.shape, chan[0].shape, idx.shape, cp_len):
        raise ValueError(
            f"demod count kernel: unsupported shapes re {tuple(re.shape)}, "
            f"channel {tuple(chan[0].shape)}, idx {tuple(idx.shape)}, cp {cp_len}"
        )
    if taps is None and hr.shape[-1] != re.shape[-1] - cp_len:
        raise ValueError("demod count kernel: h must be (B, 1 | S, N) without taps=")
    if (any(t.dtype != torch.float32 for t in (re, im, *chan))
            or chan[1].shape != chan[0].shape or im.shape != re.shape):
        raise ValueError("demod count kernel: sample and channel planes must be float32 pairs")
    if idx.dtype not in _IDX_DTYPES:
        raise ValueError(f"demod count kernel: indices must be int8/16/32, got {idx.dtype}")
    _check_comb(pilot_spacing, idx.shape[-1], despread)
    _lib.require_cuda("demod_count", re, im, *chan, idx)
    B, S, sym_len = re.shape
    N = sym_len - cp_len
    out = torch.zeros((B,), dtype=torch.int32, device=re.device)
    twr, twi = _lib.twiddles(N, re.device)
    if taps is None:
        h_args = (hr.data_ptr(), hi.data_ptr(), hr.shape[1], None, None, 0)
    else:
        h_args = (None, None, 0, chan[0].data_ptr(), chan[1].data_ptr(), chan[0].shape[2])
    rc = _lib.lib().sdr_demod_count(
        re.data_ptr(), im.data_ptr(), *h_args,
        idx.data_ptr(), idx.element_size(), out.data_ptr(), B, S, _lib.log2_exact(N),
        cp_len, mod.bits_per_axis, int(mod is Modulation.BPSK), _lib.axis_tables(mod),
        inv_noise_var(noise_var), max(float(noise_var), 1e-12), int(despread),
        pilot_spacing, twr.data_ptr(), twi.data_ptr(), _lib.stream(),
    )
    name = "demod_count_comb" if pilot_spacing else "demod_count_taps" if taps is not None else (
        "demod_count_despread" if despread else "demod_count")
    _lib.check(rc, name)
    _lib.LAUNCHES[name] += 1
    return out


def llr_chain_plain(yr, yi, hr, hi, mod: Modulation, noise_var: float,
                    reduce_sum: bool = False):
    """Plain version of the post-FFT mode: ``demod_chain`` minus the FFT.
    ``yi=None``: ``yr`` is the interleaved (B, S, N, 2) plane."""
    if yi is None:
        y = torch.view_as_complex(yr.to(torch.float32).contiguous())
    else:
        y = torch.complex(yr.to(torch.float32), yi.to(torch.float32))
    return post_fft_llr(y, hr, hi, mod, noise_var, reduce_sum)


def llr_chain(yr, yi, hr, hi, mod: Modulation, noise_var: float, reduce_sum: bool = False):
    """The post-FFT mode (port of ``llr_pallas.py::llr_chain_pallas``):
    equalise + max-log LLRs over a frequency-domain grid.

    yr/yi (B, S, N) float32, N a power of two; or ``yi=None`` and yr the
    interleaved (B, S, N, 2) float32 plane (``torch.view_as_real`` of a
    complex64 grid, read in place); hr/hi (B, 1 | S, N) float32. Returns
    the (B, S, N·bps) float32 plane in the public order, or its float32 sum
    (0-d, deterministic, the same bits in either y layout) with
    ``reduce_sum``. Counters ``llr_chain`` and ``llr_chain_sum``."""
    if yr.device.type == "cpu":
        return llr_chain_plain(yr, yi, hr, hi, mod, noise_var, reduce_sum)
    planes = (yr,) if yi is None else (yr, yi)
    if yr.ndim != (4 if yi is None else 3) or hr is None or hr.ndim != 3:
        raise ValueError("llr_chain kernel: y (B, S, N) planes or one (B, S, N, 2) plane, and "
                         "h (B, 1 | S, N) planes")
    B, S, N = yr.shape[:3]
    if (N < 2 or N & (N - 1) or tuple(hr.shape) not in ((B, 1, N), (B, S, N))
            or (yi is None and yr.shape[3] != 2) or (yi is not None and yi.shape != yr.shape)
            or hi.shape != hr.shape):
        raise ValueError(f"llr_chain kernel: unsupported shapes y {tuple(yr.shape)}, "
                         f"h {tuple(hr.shape)}")
    if any(t.dtype != torch.float32 for t in (*planes, hr, hi)):
        raise ValueError("llr_chain kernel: y and h planes must be float32")
    _lib.require_cuda("llr_chain", *planes, hr, hi)
    # The kernel moves y, h and the plane as 16-byte vectors (the planes
    # and h as 8-byte ones at N = 2; the interleaved plane as 16 at every N).
    _lib.require_aligned("llr_chain", 16 if N > 2 or yi is None else 8, *planes)
    _lib.require_aligned("llr_chain", 16 if N > 2 else 8, hr, hi)
    lib = _lib.lib()
    log_n = _lib.log2_exact(N)
    if reduce_sum:
        partials = torch.empty((lib.sdr_llr_chain_partials(B, S, log_n),), dtype=torch.float32,
                               device=yr.device)
        out = torch.empty((1,), dtype=torch.float32, device=yr.device)
    else:
        partials = None
        out = torch.empty((B, S, N * mod.bits_per_symbol), dtype=torch.float32, device=yr.device)
    rc = lib.sdr_llr_chain(
        yr.data_ptr(), _lib.ptr(yi), hr.data_ptr(), hi.data_ptr(), hr.shape[1], out.data_ptr(),
        _lib.ptr(partials), B, S, log_n, mod.bits_per_axis, int(mod is Modulation.BPSK),
        _lib.axis_tables(mod), inv_noise_var(noise_var), int(reduce_sum), _lib.stream(),
    )
    name = "llr_chain_sum" if reduce_sum else "llr_chain"
    _lib.check(rc, name)
    _lib.LAUNCHES[name] += 1
    return out[0] if reduce_sum else out


def llr_counter(reduce_sum: bool, despread: bool) -> str:
    return ("demod_sum" if reduce_sum else "demod_llr") + ("_despread" if despread else "")


def demod_llr(re, im, hr, hi, cp_len: int, mod: Modulation, noise_var: float,
              reduce_sum: bool = False, despread: bool = False):
    """The LLR plane (B, S, N·bps) float32 in the public order, or its
    float32 sum (0-d) with ``reduce_sum`` (port of ``demod_chain_pallas``).

    re/im (B, S, N+cp) float32; hr/hi (B, 1, N) or (B, S, N) float32.
    ``despread``: the SC-FDE receive (LLRs per time symbol). The plain
    version is ``demod_chain``; on a CUDA tensor kernel C's LLR or sum
    mode runs (the sum deterministic: per-block partials added in a fixed
    order), or the call raises."""
    if re.device.type == "cpu":
        return demod_chain(re, im, hr, hi, cp_len, mod, noise_var, reduce_sum, despread)
    if re.ndim != 3 or hr is None or hr.ndim != 3:
        raise ValueError("demod llr kernel: samples (B, S, N+cp) and h (B, 1 | S, N) planes")
    B, S, sym_len = re.shape
    N = sym_len - cp_len
    if not supported(re.shape, hr.shape, (B, S, N), cp_len) or hr.shape[-1] != N:
        raise ValueError(
            f"demod llr kernel: unsupported shapes re {tuple(re.shape)}, h {tuple(hr.shape)}, "
            f"cp {cp_len}"
        )
    if (any(t.dtype != torch.float32 for t in (re, im, hr, hi))
            or hi.shape != hr.shape or im.shape != re.shape):
        raise ValueError("demod llr kernel: sample and channel planes must be float32 pairs")
    _lib.require_cuda("demod_llr", re, im, hr, hi)
    lib = _lib.lib()
    log_n = _lib.log2_exact(N)
    bps = mod.bits_per_symbol
    if reduce_sum:
        partials = torch.empty((lib.sdr_demod_llr_partials(B, S, log_n),),
                               dtype=torch.float32, device=re.device)
        out = torch.empty((1,), dtype=torch.float32, device=re.device)
    else:
        partials = None
        out = torch.empty((B, S, N * bps), dtype=torch.float32, device=re.device)
    twr, twi = _lib.twiddles(N, re.device)
    rc = lib.sdr_demod_llr(
        re.data_ptr(), im.data_ptr(), hr.data_ptr(), hi.data_ptr(), hr.shape[1], out.data_ptr(),
        _lib.ptr(partials), B, S, log_n, cp_len, mod.bits_per_axis, int(mod is Modulation.BPSK),
        _lib.axis_tables(mod), inv_noise_var(noise_var), max(float(noise_var), 1e-12),
        int(despread), int(reduce_sum), twr.data_ptr(), twi.data_ptr(), _lib.stream(),
    )
    name = llr_counter(reduce_sum, despread)
    _lib.check(rc, name)
    _lib.LAUNCHES[name] += 1
    return out[0] if reduce_sum else out


def stage2_llr_plain(t_r, t_i, hr4, hi4, noise_var, mod: Modulation):
    """Plain version of the TP stage-2 mode: the n2-point forward DFT of
    each (b, s, k1) row of t (torch's FFT), then ``post_fft_llr`` against
    h (B, 1 | S, n1d, n2). ``noise_var`` a float or a 0-d tensor."""
    y = fft(torch.complex(t_r.to(torch.float32), t_i.to(torch.float32)))
    return post_fft_llr(y, hr4, hi4, mod, float(noise_var))


def _stage2_shapes_ok(t_shape, h_shape) -> bool:
    if len(t_shape) != 4 or len(h_shape) != 4:
        return False
    B, S, n1d, n2 = t_shape
    return (2 <= n2 <= MAX_N_FFT and n2 & (n2 - 1) == 0 and min(B, S, n1d) > 0
            and tuple(h_shape) in ((B, 1, n1d, n2), (B, S, n1d, n2)))


def tp_stage2_llr(t_r, t_i, hr4, hi4, noise_var, mod: Modulation):
    """The TP stage-2 mode: t_r/t_i (B, S, n1d, n2) float32, n2 a power
    of two in [2, 4096]; hr4/hi4 (B, 1 | S, n1d, n2) float32;
    ``noise_var`` a 0-d float32 tensor on the card (a float is moved
    there). Returns (B, S, n1d, n2·bps) float32 LLRs, subcarrier-major
    ([k·bps + j], I bits then Q bits, MSB first)."""
    if t_r.device.type == "cpu":
        return stage2_llr_plain(t_r, t_i, hr4, hi4, noise_var, mod)
    if not _stage2_shapes_ok(t_r.shape, hr4.shape) or t_i.shape != t_r.shape or (
            hi4.shape != hr4.shape):
        raise ValueError(f"tp_stage2_llr kernel: unsupported shapes t {tuple(t_r.shape)}, "
                         f"h {tuple(hr4.shape)}")
    if any(t.dtype != torch.float32 for t in (t_r, t_i, hr4, hi4)):
        raise ValueError("tp_stage2_llr kernel: t and h planes must be float32")
    if not isinstance(noise_var, torch.Tensor):
        noise_var = torch.tensor(float(noise_var), dtype=torch.float32, device=t_r.device)
    if noise_var.numel() != 1 or noise_var.dtype != torch.float32:
        raise ValueError("tp_stage2_llr kernel: noise_var must be one float32")
    _lib.require_cuda("tp_stage2_llr", t_r, t_i, hr4, hi4, noise_var)
    B, S, n1d, n2 = t_r.shape
    if n2 >= 128:  # the warp-group form copies h rows by 16-byte cp.async
        _lib.require_aligned("tp_stage2_llr", 16, t_r, t_i, hr4, hi4)
    out = torch.empty((B, S, n1d, n2 * mod.bits_per_symbol), dtype=torch.float32,
                      device=t_r.device)
    twr, twi = _lib.twiddles(n2, t_r.device)
    rc = _lib.lib().sdr_tp_stage2_llr(
        t_r.data_ptr(), t_i.data_ptr(), hr4.data_ptr(), hi4.data_ptr(), hr4.shape[1],
        noise_var.data_ptr(), out.data_ptr(), B, S, n1d, _lib.log2_exact(n2), mod.bits_per_axis,
        int(mod is Modulation.BPSK), _lib.axis_tables(mod), twr.data_ptr(), twi.data_ptr(),
        _lib.stream(),
    )
    _lib.check(rc, "tp_stage2_llr")
    _lib.LAUNCHES["tp_stage2_llr"] += 1
    return out
