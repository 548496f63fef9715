"""Kernel H: QC-LDPC offset min-sum decode, all iterations in one kernel
(port of ``sdr_tpu/kernels/ldpc_pallas.py``: ``ldpc_decode_pallas``,
``ldpc_decode_pallas_sublane`` and ``ldpc_decode_sublane_t``).

Channel LLRs (float32, positive = bit 0) in one of two layouts, rows-
major (batch, n) or transposed (n, batch), → int8 hard bits (1 where the
posterior is < 0) in the same layout. Schedules:

- ``"flooding"``: every check row reads the totals of the previous
  iteration; the plain version ``decode_flooding_plain`` keeps the JAX
  decoder's op order exactly (``ops/ldpc.py:242-299``): totals are the
  channel LLR plus the check-to-variable messages in ``e_by_col`` order,
  min1/min2 start at 3.4e38, ``excl = where(a == min1, min2, min1)``,
  then ``max(excl − offset, 0)``.
- ``"layered"``: rows update the totals one after another (half the
  iterations for the same waterfall); ``decode_layered_plain`` is the
  sublane kernel's layered body (``ldpc_pallas.py:300-323``): messages in
  check alignment, sign transport on the bit patterns.

The kernel's decisions equal the plain version's bit for bit in both
schedules: it does the same float operations in the same order (adds,
subtractions, min/max, no products), and its bitwise sign transport
differs from the ``where``-sign form only in the sign of zeros, which no
decision reads.

The JAX package had two kernels (lane-major Z and sublane-major Z) only
because Mosaic lowered lane rotates and sublane concatenations so
differently; on the GPU the two layouts differ only in how a block stages
its codewords, and one kernel serves both, with the base matrix taken at
run time: its tables (``code_tables``) are a by-value kernel parameter,
read from the constant bank. A block decodes one codeword, a thread
per lifted row.

On a CPU tensor the plain version runs; on a CUDA tensor the CUDA kernel
(``csrc/ldpc.cu``) runs, or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sdr_tpu_torch.kernels import _lib

SCHEDULES = ("flooding", "layered")
# The kernel's limits (csrc/ldpc.cu): base columns held in registers, base
# rows and edges in its by-value tables, the unrolled row and column loops,
# lifted rows (one thread each).
MAX_NB, MAX_MB, MAX_E, MAX_ROW_DEG, MAX_COL_DEG = 32, 32, 128, 16, 3
MAX_Z = 1024
SMEM_BYTES = 232448  # what one block may use on Hopper (227 KB)
_SIGNBIT = -0x80000000  # int32 bit pattern 0x80000000
_MAGMASK = 0x7FFFFFFF


@functools.lru_cache(maxsize=None)
def edge_lists(code):
    """(edges, e_by_row, e_by_col): edges [(row, col, shift)] in row
    order, and the edge indices of each base row and each base column,
    ascending (the JAX decoder's enumeration)."""
    edges = [(i, j, s) for i in range(code.mb) for j, s in code.row_edges(i)]
    e_by_row = [[e for e, (i, _, _) in enumerate(edges) if i == r] for r in range(code.mb)]
    e_by_col = [[e for e, (_, j, _) in enumerate(edges) if j == c] for c in range(code.nb)]
    return edges, e_by_row, e_by_col


def _rot(v: torch.Tensor, s: int, z: int) -> torch.Tensor:
    """Check-aligned view of a variable block: out[r] = v[(r+s) mod Z]."""
    s %= z
    if s == 0:
        return v
    return torch.cat([v[..., s:], v[..., :s]], dim=-1)


def decode_flooding_plain(code, llr: torch.Tensor, iters: int, offset: float) -> torch.Tensor:
    """Flooding offset min-sum over (batch, n) LLRs → (batch, n) int8, in
    the JAX decoder's op order. Messages are (batch, Z) planes in
    variable alignment."""
    z, nb = code.z, code.nb
    ch = llr.reshape(llr.shape[0], nb, z).to(torch.float32)
    edges, e_by_row, e_by_col = edge_lists(code)

    def totals(c2v):
        out = []
        for j in range(nb):
            t = ch[:, j, :]
            for e in e_by_col[j]:
                t = t + c2v[e]
            out.append(t)
        return out

    c2v = [torch.zeros_like(ch[:, 0, :]) for _ in edges]
    for _ in range(iters):
        tot = totals(c2v)
        new = [None] * len(edges)
        for row in e_by_row:
            ms = [_rot(tot[edges[e][1]] - c2v[e], edges[e][2], z) for e in row]
            sign = min1 = min2 = None
            for m in ms:
                a = m.abs()
                sg = torch.where(m < 0, -1.0, 1.0)
                sign = sg if sign is None else sign * sg
                if min1 is None:
                    min1, min2 = a, torch.full_like(a, 3.4e38)
                else:
                    min2 = torch.minimum(min2, torch.maximum(min1, a))
                    min1 = torch.minimum(min1, a)
            for m, e in zip(ms, row):
                a = m.abs()
                sg = torch.where(m < 0, -1.0, 1.0)
                excl = torch.where(a == min1, min2, min1)
                mag = torch.clamp_min(excl - offset, 0.0)
                new[e] = _rot(sign * sg * mag, -edges[e][2], z)
        c2v = new
    hard = [(t < 0).to(torch.int8) for t in totals(c2v)]
    return torch.cat(hard, dim=-1)


def _row_update(ms, offset: float):
    """Min-sum row core on the bit patterns (the sublane kernel's
    ``_row_update``): new check-to-variable values for a row's
    check-aligned inputs."""
    bits = [m.view(torch.int32) for m in ms]
    sgs = [b & _SIGNBIT for b in bits]
    abss = [(b & _MAGMASK).view(torch.float32) for b in bits]
    rsign = None
    for sg in sgs:
        rsign = sg if rsign is None else rsign ^ sg
    min1 = min2 = None
    for a in abss:
        if min1 is None:
            min1, min2 = a, torch.full_like(a, 3.4e38)
        else:
            min2 = torch.minimum(min2, torch.maximum(min1, a))
            min1 = torch.minimum(min1, a)
    out = []
    for a, sg in zip(abss, sgs):
        excl = torch.where(a == min1, min2, min1)
        mag = torch.clamp_min(excl - offset, 0.0)
        out.append((mag.view(torch.int32) | (rsign ^ sg)).view(torch.float32))
    return out


def decode_layered_plain(code, llr: torch.Tensor, iters: int, offset: float) -> torch.Tensor:
    """Layered offset min-sum over (batch, n) LLRs → (batch, n) int8:
    messages in check alignment, the totals updated row by row."""
    z, nb = code.z, code.nb
    ch = llr.reshape(llr.shape[0], nb, z).to(torch.float32)
    edges, e_by_row, _ = edge_lists(code)
    tot = [ch[:, j, :] for j in range(nb)]
    c2v = [torch.zeros_like(ch[:, 0, :]) for _ in edges]
    for _ in range(iters):
        for row in e_by_row:
            ms = [_rot(tot[edges[e][1]], edges[e][2], z) - c2v[e] for e in row]
            for v, e in zip(_row_update(ms, offset), row):
                _, j, s = edges[e]
                tot[j] = tot[j] + _rot(v - c2v[e], -s, z)
                c2v[e] = v
    return torch.cat([(t < 0).to(torch.int8) for t in tot], dim=-1)


def ldpc_decode_plain(code, llr: torch.Tensor, iters: int = 25, offset: float = 0.5,
                      schedule: str = "flooding", transposed: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel, either layout."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    fn = decode_flooding_plain if schedule == "flooding" else decode_layered_plain
    if transposed:
        return fn(code, llr.T, iters, offset).T.contiguous()
    return fn(code, llr, iters, offset)


def smem_bytes(code) -> int:
    """Shared memory of a block (one codeword): the messages (E·Z) and
    the totals (nb·Z), 4 bytes each."""
    n_e = len(edge_lists(code)[0])
    return 4 * (n_e + code.nb) * code.z


def unsupported(code) -> str | None:
    """Why the kernel does not take ``code``, or None when it does. The
    limits are the sizes of the kernel's by-value tables and of the unrolled
    loops (csrc/ldpc.cu) and one codeword's state within a block's shared
    memory (any code ``make_qc_ldpc`` builds at Z = 128 fits)."""
    edges, e_by_row, e_by_col = edge_lists(code)
    checks = (
        (1 <= code.z <= MAX_Z, f"Z = {code.z} outside 1..{MAX_Z}"),
        (code.nb <= MAX_NB, f"nb = {code.nb} > {MAX_NB} base columns"),
        (code.mb <= MAX_MB, f"mb = {code.mb} > {MAX_MB} base rows"),
        (len(edges) <= MAX_E, f"{len(edges)} edges > {MAX_E}"),
        (max(map(len, e_by_row)) <= MAX_ROW_DEG,
         f"row degree {max(map(len, e_by_row))} > {MAX_ROW_DEG}"),
        (max(map(len, e_by_col)) <= MAX_COL_DEG,
         f"column degree {max(map(len, e_by_col))} > {MAX_COL_DEG}"),
        (smem_bytes(code) <= SMEM_BYTES,
         f"{smem_bytes(code)} bytes of state per codeword > {SMEM_BYTES}"),
    )
    return next((why for ok, why in checks if not ok), None)


def supported(code) -> bool:
    """Codes the kernel takes (``unsupported`` says why not)."""
    return unsupported(code) is None


@functools.lru_cache(maxsize=None)
def code_tables(code) -> tuple[int, ...]:
    """The int32 tables the kernel takes as a by-value parameter, in
    ``csrc/ldpc.cu``'s ``LdpcCode`` layout. Offsets are bytes into the
    block's shared memory, which holds E message planes and then nb total
    planes of Z floats: nb, mb, E, Z; per base row (degree, first edge);
    per edge in row order (s·4, its total plane, its message plane, 0);
    per base column (total plane, degree); per column, its edges' message
    planes in ``e_by_col`` order. Unused entries are 0."""
    edges, e_by_row, e_by_col = edge_lists(code)
    z, n_e = code.z, len(edges)
    plane = 4 * z

    def padded(items, size):
        vals = [v for item in items for v in item]
        return vals + [0] * (size - len(vals))

    out = [code.nb, code.mb, n_e, z]
    out += padded([(len(row), row[0] if row else 0) for row in e_by_row], 2 * MAX_MB)
    out += padded([(4 * (s % z), (n_e + j) * plane, e * plane, 0)
                   for e, (_, j, s) in enumerate(edges)], 4 * MAX_E)
    out += padded([((n_e + j) * plane, len(col)) for j, col in enumerate(e_by_col)], 2 * MAX_NB)
    out += padded([padded([(e * plane,) for e in col], MAX_COL_DEG) for col in e_by_col],
                  MAX_NB * MAX_COL_DEG)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _c_tables(code):
    """``code_tables`` as a C int array, kept for the process."""
    t = code_tables(code)
    return (ctypes.c_int * len(t))(*t)


def counter_name(schedule: str, transposed: bool) -> str:
    return "ldpc_minsum" + ("_t" if transposed else "") + (
        "_layered" if schedule == "layered" else "")


def ldpc_decode(code, llr: torch.Tensor, iters: int = 25, offset: float = 0.5,
                schedule: str = "flooding", transposed: bool = False) -> torch.Tensor:
    """Hard bits (int8) of ``llr``: (batch, n), or (n, batch) with
    ``transposed``; any batch."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    want = (code.n, None) if transposed else (None, code.n)
    if llr.ndim != 2 or llr.shape[1 - int(transposed)] != code.n:
        raise ValueError(f"expected {want} LLRs, got {tuple(llr.shape)}")
    if llr.device.type == "cpu":
        return ldpc_decode_plain(code, llr, iters, offset, schedule, transposed)
    if llr.dtype != torch.float32:
        raise ValueError(f"ldpc kernel takes float32 LLRs, got {llr.dtype}")
    why = unsupported(code)
    if why is not None:
        raise ValueError(f"ldpc kernel: unsupported code nb={code.nb} mb={code.mb} "
                         f"z={code.z}: {why}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    _lib.require_cuda("ldpc_decode", llr)
    batch = llr.shape[int(transposed)]
    out = torch.empty(llr.shape, dtype=torch.int8, device=llr.device)
    if batch == 0:
        return out
    cw_stride, pos_stride = (1, batch) if transposed else (code.n, 1)
    tables = _c_tables(code)
    with torch.cuda.device(llr.device):
        rc = _lib.lib().sdr_ldpc_minsum(
            llr.data_ptr(), out.data_ptr(), ctypes.addressof(tables), len(tables), iters,
            float(offset), int(schedule == "layered"), batch, cw_stride, pos_stride,
            _lib.stream(),
        )
    name = counter_name(schedule, transposed)
    _lib.check(rc, name)
    _lib.LAUNCHES[name] += 1
    return out
