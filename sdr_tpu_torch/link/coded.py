"""Coded link: FEC → interleave → OFDM link → LLR → soft decode (port of
``sdr_tpu/link/coded.py``).

Three code families over the link pipeline (``link.pipeline``):

- ``conv``: the K = 7 (171, 133) convolutional code with 802.11a
  puncturing and the max-log Viterbi decoder (``ops/fec.py``);
- ``ldpc``: the QC-LDPC family (nb = 24, Z = 128) with the offset
  min-sum decoder (``ops/ldpc.py``, kernel H on the card);
- ``polar``: the CA-polar family (N 256, CRC-11 inside the k info
  positions) with the fast-SSCL list decoder (``ops/polar.py``;
  ``SDR_TPU_POLAR_DECODER=scan`` takes the bit-serial decoder, as in JAX).

Each channel's coded bits are padded to the frame, the whole frame is
interleaved with the one permutation (``ops.interleave``), carried over
the link — SISO through ``pipeline.tx_chain`` → ``apply_channel`` →
``rx_chain`` (B off or its comb, E, C's LLR plane; SC-FDMA C's despread
plane), MIMO through ``pipeline.mimo_llr_link`` (C's post-FFT mode) in
passes of ``pipeline.CHUNK`` channels — and the deinterleaved LLRs of the
sent bits drive the decoder. The link is the JAX ``_frame_llrs`` branch,
not ``simulate_core``'s routes: a timing offset or CFO is not acquired
here, as in JAX. Errors are counted on INFORMATION bits (polar: the
payload, without the CRC).

The whole batch runs at once, keyed as the pipeline is: the info bits
are ``core.prng.info_bits`` (Philox on ``ROLE_PAYLOAD``, lane 1, at
(channel, codeword, bit)), the channel's draws the pipeline's, all by
(seed, global channel id) — so any slice of channels reproduces the full
run. The JAX link draws threefry ``bernoulli`` bits and per-channel
``fold_in`` keys instead; the parity tests inject the JAX draws
(``info=``, ``fading=``, ``noise=``, ``phase=``). The entry points run
on the card unless the caller asks for the CPU.

Frame fit: the information payload per channel is derived from the
config (``info_bits_per_channel``, ``ldpc_codewords_per_channel``,
``polar_codewords_per_channel``); the rest of the frame is zero padding
the receiver never counts.
"""

from __future__ import annotations

import functools
import os

import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.core.config import LinkConfig
from sdr_tpu_torch.link import pipeline
from sdr_tpu_torch.ops.fec import (
    DEFAULT_K,
    DEFAULT_POLYS,
    conv_encode,
    depuncture,
    puncture,
    punctured_len,
    viterbi_decode,
)
from sdr_tpu_torch.ops.interleave import SEED as IL_SEED
from sdr_tpu_torch.ops.interleave import _perm_tensor, interleave
from sdr_tpu_torch.ops.ldpc import QcLdpcCode, ldpc_decode, ldpc_encode, make_qc_ldpc
from sdr_tpu_torch.ops.polar import (
    PolarCode,
    make_polar_code,
    polar_decode_scl,
    polar_decode_scl_fast,
    polar_encode_payload,
)

_LDPC_MB = {"1/2": 12, "2/3": 8, "3/4": 6}  # nb = 24 base, rate = (nb − mb)/nb

# Elements of one pass's (codewords, list, N) float32 plane in the polar
# decoder: 2^28 (1 GiB a plane; 512 channels of config 2's 256 codewords at
# L 8). The decode of 8192 × 256 codewords of (256, 128), L 8 peaks 3.44 GiB
# above its LLRs at this size (``chip_smoke.py`` phase 3k; root PERF.md §5).
POLAR_PASS_ELEMS = 1 << 28


def frame_bits(cfg: LinkConfig) -> int:
    """Payload bits of one frame (every spatial stream)."""
    return cfg.n_data_symbols * cfg.bits_per_ofdm_symbol


def info_bits_per_channel(cfg: LinkConfig, polys=DEFAULT_POLYS, K: int = DEFAULT_K,
                          rate: str = "1/2") -> int:
    """Largest info payload whose terminated, punctured codeword fits one
    frame (``rate``: "1/2", "2/3" or "3/4" — the 802.11a family). MIMO
    frames carry n_streams × the bits."""
    fb = frame_bits(cfg)
    # Upper bound from the average punctured rate, then trim exactly.
    n_info = (fb * int(rate[0])) // int(rate[2]) - (K - 1)
    while n_info > 0 and punctured_len(n_info, rate, polys, K) > fb:
        n_info -= 1
    if n_info < 1:
        raise ValueError(f"frame of {fb} coded bits cannot fit a terminated rate-{rate} K={K} "
                         "codeword")
    return n_info


def _rows(x, sl):
    """Rows ``sl`` of an injected draw: a (B, ...) tensor, a tuple of them,
    or None."""
    if x is None:
        return None
    return tuple(t[sl] for t in x) if isinstance(x, tuple) else x[sl]


def frame_llrs(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, frames: torch.Tensor, *,
               fading=None, noise=None, phase=None) -> torch.Tensor:
    """Carry each channel's interleaved frame (B, frame_bits) int8 over the
    link → its LLRs (B, frame_bits) float32 in the frame's bit order.
    SISO: ``tx_chain`` → ``apply_channel`` → ``rx_chain``; MIMO:
    ``mimo_llr_link`` with the frame as (n_streams, n_symbols, −1) (the
    same reshape on both sides keeps the bit order), in passes of
    ``pipeline.CHUNK`` channels. ``fading``, ``noise`` and ``phase`` are
    the pipeline functions' injection forms."""
    B = frames.shape[0]
    fb = frame_bits(cfg)
    if cfg.mimo is None:
        tx = pipeline.tx_chain(cfg, frames.view(B, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol))
        rx, h, nv = pipeline.apply_channel(cfg, seed, ch_ids, tx, fading=fading, noise=noise,
                                           phase=phase)
        del tx
        llrs, _ = pipeline.rx_chain(cfg, rx, h, nv)
        return llrs.reshape(B, -1)[:, :fb]
    shape = (cfg.mimo.n_streams, cfg.n_symbols, -1)

    def link(sl, ids, fr):
        return pipeline.mimo_llr_link(
            cfg, seed, ids, fr.reshape(fr.shape[0], *shape), fading=_rows(fading, sl),
            noise=_rows(noise, sl), phase=_rows(phase, sl)).reshape(fr.shape[0], -1)

    return pipeline._in_passes(link, ch_ids, frames)


def _carry(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, cw: torch.Tensor, draws: dict):
    """Coded bits (B, sent) → their LLRs (B, sent): pad to the frame,
    interleave the WHOLE frame (the receiver deinterleaves the whole frame,
    so the permutation lengths always match), carry, deinterleave the sent
    positions."""
    B, sent = cw.shape
    fb = frame_bits(cfg)
    frame = torch.zeros((B, fb), dtype=torch.int8, device=cw.device)
    frame[:, :sent] = cw
    llrs = frame_llrs(cfg, seed, ch_ids, interleave(frame, IL_SEED), **draws)
    del frame
    inv = _perm_tensor(fb, IL_SEED, True, str(cw.device))[:sent]
    return llrs[:, inv]


def _counts(decoded: torch.Tensor, info: torch.Tensor):
    """Per-channel (errors, counted) int32 of decoded against sent bits
    (B, ...)."""
    B = info.shape[0]
    errors = (decoded != info).reshape(B, -1).sum(dim=1, dtype=torch.int32)
    counted = torch.full((B,), info[0].numel(), dtype=torch.int32, device=info.device)
    return errors, counted


# ---- the convolutional family ------------------------------------------------------------

def conv_link(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, polys=DEFAULT_POLYS,
              K: int = DEFAULT_K, rate: str = "1/2", info: torch.Tensor | None = None,
              **draws):
    """The convolutional link over GLOBAL channel ids (B,): (decoded, info),
    each (B, n_info) int8. ``info`` injects the information bits (default
    ``prng.info_bits(seed, ids, 1, n_info)``), ``draws`` the channel's
    (``frame_llrs``)."""
    polys = tuple(polys)
    n_info = info_bits_per_channel(cfg, polys, K, rate)
    n_steps = n_info + K - 1
    if info is None:
        info = prng.info_bits(seed, ch_ids, 1, n_info)[:, 0]
    cw = puncture(conv_encode(info, polys, K), rate, len(polys))
    llr_sent = _carry(cfg, seed, ch_ids, cw, draws)
    del cw
    # Punctured positions re-enter the trellis as zero LLRs.
    llr_cw = depuncture(llr_sent, rate, n_steps, len(polys))
    del llr_sent
    return viterbi_decode(llr_cw, n_info, polys, K), info


def simulate_coded(cfg: LinkConfig, seed: int, device="cuda", polys=DEFAULT_POLYS,
                   K: int = DEFAULT_K, rate: str = "1/2"):
    """Convolutional-coded link over cfg.n_channels on ``device``; returns
    (errors, counted) per channel, counting INFORMATION bits."""
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    return _counts(*conv_link(cfg, seed, ch_ids, polys, K, rate))


def make_coded_fn(cfg: LinkConfig, polys=DEFAULT_POLYS, K: int = DEFAULT_K, rate: str = "1/2",
                  device="cuda"):
    """``simulate_coded`` with cfg and the options bound: fn(seed)."""
    return functools.partial(simulate_coded, cfg, device=device, polys=tuple(polys), K=K,
                             rate=rate)


# ---- the LDPC family ------------------------------------------------------------------------

def ldpc_code_for(rate: str = "1/2", z: int = 128) -> QcLdpcCode:
    """The stock QC-LDPC code family (nb = 24, Z = 128)."""
    if rate not in _LDPC_MB:
        raise ValueError(f"LDPC rate must be one of {sorted(_LDPC_MB)}")
    return make_qc_ldpc(nb=24, mb=_LDPC_MB[rate], z=z)


def ldpc_codewords_per_channel(cfg: LinkConfig, code: QcLdpcCode) -> int:
    """Whole codewords per frame (the rest of the frame is zero padding —
    known bits the receiver never counts)."""
    fb = frame_bits(cfg)
    n_cw = fb // code.n
    if n_cw < 1:
        raise ValueError(f"frame of {fb} bits cannot fit an n={code.n} codeword")
    return n_cw


def ldpc_link(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, rate: str = "1/2",
              iters: int = 25, z: int = 128, info: torch.Tensor | None = None, **draws):
    """The LDPC link over GLOBAL channel ids: (decoded systematic bits,
    info), each (B, n_cw, k) int8; the decode is kernel H on the card."""
    code = ldpc_code_for(rate, z)
    n_cw = ldpc_codewords_per_channel(cfg, code)
    B = ch_ids.shape[0]
    if info is None:
        info = prng.info_bits(seed, ch_ids, n_cw, code.k)
    cw = ldpc_encode(code, info).reshape(B, n_cw * code.n)
    llr_cw = _carry(cfg, seed, ch_ids, cw, draws)
    del cw
    decoded = ldpc_decode(code, llr_cw.reshape(B * n_cw, code.n), iters)
    return decoded.reshape(B, n_cw, code.n)[:, :, :code.k], info


def simulate_ldpc(cfg: LinkConfig, seed: int, device="cuda", rate: str = "1/2",
                  iters: int = 25, z: int = 128):
    """LDPC-coded link over cfg.n_channels; returns (errors, counted) per
    channel, counting INFORMATION bits (the systematic prefix)."""
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    return _counts(*ldpc_link(cfg, seed, ch_ids, rate, iters, z))


def make_ldpc_fn(cfg: LinkConfig, rate: str = "1/2", iters: int = 25, z: int = 128,
                 device="cuda"):
    """``simulate_ldpc`` with cfg and the options bound: fn(seed)."""
    return functools.partial(simulate_ldpc, cfg, device=device, rate=rate, iters=iters, z=z)


# ---- the polar family -------------------------------------------------------------------------

def polar_params(rate: str = "1/2", block_len: int = 256):
    """(block_len, k) for a nominal rate string; non-dyadic rates round to
    the nearest k."""
    num, den = int(rate[0]), int(rate[2])
    k = max(1, round(block_len * num / den))
    return block_len, k


def polar_codewords_per_channel(cfg: LinkConfig, block_len: int) -> int:
    fb = frame_bits(cfg)
    n_cw = fb // block_len
    if n_cw < 1:
        raise ValueError(f"frame of {fb} bits cannot fit an N={block_len} polar codeword")
    return n_cw


def polar_code_for(rate: str = "1/2", block_len: int = 256,
                   crc: str | None = "crc11") -> PolarCode:
    """The stock CA-polar code for a nominal rate string: k counts info
    POSITIONS (payload + CRC), so the realized info rate is (k −
    crc_len)/block_len."""
    block_len, k = polar_params(rate, block_len)
    return make_polar_code(block_len, k, crc=crc)


def polar_decoder():
    """The decoder the link runs: the fast-SSCL tree decoder, or the
    bit-serial scan decoder under ``SDR_TPU_POLAR_DECODER=scan`` (the JAX
    link's switch)."""
    if os.environ.get("SDR_TPU_POLAR_DECODER", "fast") == "scan":
        return polar_decode_scl
    return polar_decode_scl_fast


def polar_pass_channels(code: PolarCode, n_cw: int, list_size: int) -> int:
    """Channels a decode pass takes: ``POLAR_PASS_ELEMS`` elements of the
    (codewords, list, N) plane, at least one channel."""
    return max(1, POLAR_PASS_ELEMS // (n_cw * list_size * code.block_len))


def polar_link(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, rate: str = "1/2",
               block_len: int = 256, list_size: int = 8, crc: str | None = "crc11",
               info: torch.Tensor | None = None, **draws):
    """The polar link over GLOBAL channel ids: (decoded payload, payload),
    each (B, n_cw, payload_len) int8 (the decode: ``polar_decode_passes``)."""
    code = polar_code_for(rate, block_len, crc)
    n_cw = polar_codewords_per_channel(cfg, code.block_len)
    B = ch_ids.shape[0]
    if info is None:
        info = prng.info_bits(seed, ch_ids, n_cw, code.payload_len)
    cw = polar_encode_payload(info, code).reshape(B, n_cw * code.block_len)
    llr_cw = _carry(cfg, seed, ch_ids, cw, draws).reshape(B, n_cw, code.block_len)
    del cw
    return polar_decode_passes(llr_cw, code, list_size), info


def polar_decode_passes(llr: torch.Tensor, code: PolarCode, list_size: int = 8,
                        decode=None) -> torch.Tensor:
    """The link's decode of (B, n_cw, N) LLRs → (B, n_cw, payload_len)
    int8, in passes of ``polar_pass_channels`` channels; ``decode``: the
    decoder (default ``polar_decoder()``; the packet modem passes the
    bit-serial one)."""
    B, n_cw, _ = llr.shape
    decode = decode or polar_decoder()
    step = polar_pass_channels(code, n_cw, list_size)
    decoded = torch.empty((B, n_cw, code.payload_len), dtype=torch.int8, device=llr.device)
    for a in range(0, B, step):
        decoded[a:a + step] = decode(llr[a:a + step], code, list_size=list_size)
    return decoded


def simulate_polar(cfg: LinkConfig, seed: int, device="cuda", rate: str = "1/2",
                   block_len: int = 256, list_size: int = 8, crc: str | None = "crc11"):
    """Polar-coded link (CRC-aided SC-list decoding) over cfg.n_channels;
    returns (errors, counted) per channel, counting PAYLOAD bits (info
    positions minus the CRC)."""
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    return _counts(*polar_link(cfg, seed, ch_ids, rate, block_len, list_size, crc))


def make_polar_fn(cfg: LinkConfig, rate: str = "1/2", block_len: int = 256,
                  list_size: int = 8, crc: str | None = "crc11", device="cuda"):
    """``simulate_polar`` with cfg and the options bound: fn(seed)."""
    return functools.partial(simulate_polar, cfg, device=device, rate=rate,
                             block_len=block_len, list_size=list_size, crc=crc)


# ---- family dispatch -------------------------------------------------------------------------

CODE_FAMILIES = ("conv", "ldpc", "polar")


def family_info_rate(family: str, rate: str, block_len: int = 256) -> float:
    """The REALIZED info rate of a family at a nominal rate string: conv
    and LDPC realize the nominal exactly, polar pays the CRC-11 overhead
    ((k − 11)/block_len)."""
    nominal = int(rate[0]) / int(rate[2])
    if family in ("conv", "ldpc"):
        return nominal
    if family == "polar":
        return polar_code_for(rate, block_len).rate
    raise ValueError(f"family must be one of {CODE_FAMILIES}, got {family!r}")


def family_core(cfg: LinkConfig, family: str, rate: str = "1/2", **kw):
    """fn(seed, ch_ids) → per-channel (errors, counted) of a family's link
    over GLOBAL channel ids, with the eager frame-fit check of
    ``make_family_fn``."""
    if family == "conv":
        info_bits_per_channel(cfg, kw.get("polys", DEFAULT_POLYS), kw.get("K", DEFAULT_K), rate)
        return lambda seed, ids: _counts(*conv_link(cfg, seed, ids, rate=rate, **kw))
    if family == "ldpc":
        ldpc_codewords_per_channel(cfg, ldpc_code_for(rate, kw.get("z", 128)))
        return lambda seed, ids: _counts(*ldpc_link(cfg, seed, ids, rate, **kw))
    if family == "polar":
        code = polar_code_for(rate, kw.get("block_len", 256), kw.get("crc", "crc11"))
        polar_codewords_per_channel(cfg, code.block_len)
        return lambda seed, ids: _counts(*polar_link(cfg, seed, ids, rate, **kw))
    raise ValueError(f"family must be one of {CODE_FAMILIES}, got {family!r}")


def make_family_fn(cfg: LinkConfig, family: str, rate: str = "1/2", device="cuda", **kw):
    """(errors, counted) coded-link fn(seed) for any code family on
    ``device``. kw passes the family's knobs: conv (polys, K), ldpc
    (iters, z), polar (block_len, list_size, crc). Raises ValueError when
    the frame cannot fit the family's codeword."""
    core = family_core(cfg, family, rate, **kw)

    def fn(seed: int):
        return core(seed, torch.arange(cfg.n_channels, dtype=torch.int32, device=device))

    return fn
