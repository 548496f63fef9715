"""Packet PHY: bytes → waveform → blind receiver → bytes + CRC (port of
``sdr_tpu/link/packet.py``).

The reference's headline use-case is a byte loopback
(QFDemoWindow.cpp:201-224: bytes → to_constl → ofdm::tx → ofdm::rx →
from_constl → bytes) over a perfect wire. This module is that loop as a
packet modem: a CRC-32-framed, FEC-coded (convolutional, LDPC or polar),
interleaved, pilot-bearing OFDM burst with a Schmidl & Cox acquisition
preamble, received BLIND — unknown timing, carrier offset and fading —
through the port's receiver (``ops.sync`` acquisition → comb-pilot
estimation, phase-tracked → MMSE → max-log LLRs → depuncture → soft
decoding → CRC).

Burst layout (time domain):
    [S&C preamble: 2 OFDM symbols] [n_symbols coded + pilot payload]

Packets are the batch axis (B, ...): every function takes and returns a
batch of packets (the JAX functions take one packet and ``vmap`` over
packets). On the card a campaign runs through the port's kernels:

    payload bits (``prng.info_bits``) → CRC → FEC encode → interleave →
    Gray map, IDFT, CP with the pilot comb (kernel B, ``tx_comb``) →
    fading over the (B, 3 + S, N+cp) burst plane, channel only (kernel E)
    → delay, CFO → noise over the (B, 1, T) stream row (kernel E) →
    acquisition, the tracked comb estimate (torch) → equalise and max-log
    LLRs (kernel C, ``demod_llr``) → deinterleave → Viterbi (torch),
    min-sum (kernel H) or CA-SCL-8 (torch) → CRC

- ``crc32_bits``: the non-reflected 0x04C11DB7 / init 0xFFFFFFFF /
  final-xor 0xFFFFFFFF CRC-32 over the payload bits in transmission order
  (MSB first, the reference's packing, modulation.hpp:87-91). The CRC is
  affine over GF(2): one (n × 32) matrix product mod 2 (exact in float32)
  and the CRC of n zero bits, the bits of the JAX bit-serial LFSR.
- The receive takes ``ops.sync.acquire_start`` and the corrected payload
  window (``corrected_slice``, whose start is clamped as
  ``dynamic_slice`` clamps), then ``pipeline.rx_chain(...,
  track_phase=True)``; ``receive_stream`` runs its rounds as a Python loop
  over a batch of captures (B, T).
- Draws: the payload bits are ``prng.info_bits`` (``ROLE_PAYLOAD``, lane
  1) at (packet, 0, bit), packed MSB first into bytes; the fading is
  ``ops.channel``'s keyed draws at the packet id (``rayleigh_flat``,
  ``rician_flat``, ``multipath_taps``, ``multipath_time_taps``); the noise
  is kernel E's keyed row at (packet, 0, sample). The JAX campaign draws
  threefry ``randint`` payloads and per-packet ``fold_in`` keys instead;
  ``payload=``, ``fading=`` and ``noise=`` inject draws for exact
  comparison.

The entry points run on the card unless the caller asks for the CPU; the
functions that take tensors run on their device. Nothing falls back to
plain torch or to the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.kernels.channel import fade_awgn
from sdr_tpu_torch.link import coded, fast, pipeline
from sdr_tpu_torch.ops import channel as chan
from sdr_tpu_torch.ops import sync
from sdr_tpu_torch.ops.fec import (
    DEFAULT_K,
    DEFAULT_POLYS,
    conv_encode,
    depuncture,
    puncture,
    punctured_len,
    viterbi_decode,
)
from sdr_tpu_torch.ops.interleave import deinterleave, interleave
from sdr_tpu_torch.ops.ldpc import ldpc_decode, ldpc_encode
from sdr_tpu_torch.ops.modulation import bits_to_bytes, bytes_to_bits
from sdr_tpu_torch.ops.polar import _mod2_matmul, polar_decode_scl, polar_encode_payload

_CRC_POLY = 0x04C11DB7
_CRC_BITS = 32
_CRC_MASK = 0xFFFFFFFF
POLAR_LIST = 8  # the CA-SCL list of the polar packets (the JAX module's)


def _crc_zero_step(state: int) -> int:
    """One LFSR step on an input bit 0: shift, tap when the MSB was set."""
    return ((state << 1) & _CRC_MASK) ^ (_CRC_POLY if state >> 31 else 0)


@functools.lru_cache(maxsize=None)
def _crc32_affine(n: int):
    """(M (n, 32) float32, c (32,) float32) numpy with crc32(b) = (b·M + c)
    mod 2 for n bits: a step is state' = zero_step(state) ⊕ poly·b, so bit
    i adds the poly carried through the n − 1 − i steps after it, and c is
    the CRC of n zero bits (the init carried through, the final xor)."""
    shifts = np.arange(31, -1, -1)
    M = np.zeros((n, _CRC_BITS), np.float32)
    v = _CRC_POLY
    for i in range(n - 1, -1, -1):
        M[i] = (v >> shifts) & 1
        v = _crc_zero_step(v)
    s = _CRC_MASK
    for _ in range(n):
        s = _crc_zero_step(s)
    return M, (((s ^ _CRC_MASK) >> shifts) & 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _crc32_tensors(n: int, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in _crc32_affine(n))


def crc32_bits(bits: torch.Tensor) -> torch.Tensor:
    """CRC-32 over bit vectors (..., n) int8 0/1, MSB-first order →
    (..., 32) int8 checksum bits, MSB first."""
    M, c = _crc32_tensors(bits.shape[-1], str(bits.device))
    return torch.remainder(_mod2_matmul(bits, M) + c, 2.0).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class PacketConfig:
    """Static packet-modem parameters (hashable)."""

    payload_bytes: int = 64
    modulation: Modulation = Modulation.QPSK
    ofdm: OFDMConfig = OFDMConfig(n_fft=64, cp_len=16)
    rate: str = "1/2"  # FEC rate: "1/2", "2/3", "3/4"
    pilot_spacing: int = 8
    #: FEC family: "conv" (K=7 + Viterbi), "ldpc" (QC min-sum; note the
    #: 3072-bit codeword — bursts quantize up to it), or "polar" (CA-SCL-8
    #: over (256, k) codewords). The packet CRC-32 arbitrates either way;
    #: info bits beyond the payload+CRC pad the last codeword with zeros
    #: the receiver strips.
    fec: str = "conv"

    def __post_init__(self) -> None:
        if self.payload_bytes < 1:
            raise ValueError("payload_bytes must be >= 1")
        if self.rate not in ("1/2", "2/3", "3/4"):
            raise ValueError(f"rate must be 1/2, 2/3 or 3/4, got {self.rate!r}")
        if self.fec not in ("conv", "ldpc", "polar"):
            raise ValueError(f"fec must be 'conv', 'ldpc' or 'polar', got {self.fec!r}")
        if self.pilot_spacing < 2:
            # The blind receiver estimates the channel from the comb;
            # without pilots decode_packet would run unequalised.
            raise ValueError(
                "the packet receiver needs comb pilots: pilot_spacing "
                f">= 2 required, got {self.pilot_spacing}")

    @property
    def n_info_bits(self) -> int:
        return 8 * self.payload_bytes + _CRC_BITS

    def _block_code(self):
        """The LDPC/polar code object for block-FEC packets."""
        if self.fec == "ldpc":
            return coded.ldpc_code_for(self.rate)
        return coded.polar_code_for(self.rate, 256)

    @property
    def _n_codewords(self) -> int:
        code = self._block_code()
        k = code.k if self.fec == "ldpc" else code.payload_len
        return -(-self.n_info_bits // k)  # ceil

    @property
    def n_coded_bits(self) -> int:
        if self.fec == "conv":
            return punctured_len(self.n_info_bits, self.rate, DEFAULT_POLYS, DEFAULT_K)
        code = self._block_code()
        n = code.n if self.fec == "ldpc" else code.block_len
        return self._n_codewords * n

    def _link_cfg(self, ebno_db: float = 10.0) -> LinkConfig:
        """The LinkConfig carrying the numerology and pilot settings for
        ``tx_chain``/``rx_chain`` (their channel model is not read)."""
        return _link_cfg(self, ebno_db)

    @property
    def n_symbols(self) -> int:
        return self._link_cfg().n_symbols

    @property
    def frame_bits(self) -> int:
        cfg = self._link_cfg()
        return cfg.n_symbols * cfg.bits_per_ofdm_symbol

    @property
    def burst_len(self) -> int:
        """Time samples in one burst (S&C preamble + payload symbols)."""
        return (2 + self.n_symbols) * self.ofdm.symbol_len


@functools.lru_cache(maxsize=None)
def _link_cfg(pcfg: PacketConfig, ebno_db: float = 10.0) -> LinkConfig:
    probe = LinkConfig(
        modulation=pcfg.modulation,
        ofdm=pcfg.ofdm,
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=ebno_db),
        equalizer=Equalizer.MMSE,
        n_symbols=2,  # placeholder; replaced below
        n_channels=1,
        pilot_spacing=pcfg.pilot_spacing,
    )
    n_sym = max(2, math.ceil(pcfg.n_coded_bits / probe.bits_per_ofdm_symbol))
    return dataclasses.replace(probe, n_symbols=n_sym)


def _padded(pcfg: PacketConfig, info: torch.Tensor, k: int) -> torch.Tensor:
    """info (B, n_info) zero-padded to (B, n_codewords, k)."""
    B = info.shape[0]
    out = torch.zeros((B, pcfg._n_codewords * k), dtype=torch.int8, device=info.device)
    out[:, :info.shape[1]] = info
    return out.view(B, pcfg._n_codewords, k)


def _fec_encode(pcfg: PacketConfig, info: torch.Tensor) -> torch.Tensor:
    """info bits (B, n_info_bits) → coded bits (B, n_coded_bits) int8.
    Block families segment into codewords, zero-padding the last (known
    bits the receiver strips)."""
    B = info.shape[0]
    if pcfg.fec == "conv":
        return puncture(conv_encode(info, DEFAULT_POLYS, DEFAULT_K), pcfg.rate)
    code = pcfg._block_code()
    if pcfg.fec == "ldpc":
        return ldpc_encode(code, _padded(pcfg, info, code.k)).reshape(B, -1)
    return polar_encode_payload(_padded(pcfg, info, code.payload_len), code).reshape(B, -1)


def _fec_decode(pcfg: PacketConfig, llr_sent: torch.Tensor) -> torch.Tensor:
    """Coded-bit LLRs (B, n_coded_bits) → decoded info (B, n_info_bits)."""
    B = llr_sent.shape[0]
    if pcfg.fec == "conv":
        llr_cw = depuncture(llr_sent, pcfg.rate, pcfg.n_info_bits + DEFAULT_K - 1)
        return viterbi_decode(llr_cw, pcfg.n_info_bits, DEFAULT_POLYS, DEFAULT_K)
    code = pcfg._block_code()
    n_cw = pcfg._n_codewords
    if pcfg.fec == "ldpc":
        dec = ldpc_decode(code, llr_sent.reshape(B * n_cw, code.n))
        return dec[:, :code.k].reshape(B, -1)[:, :pcfg.n_info_bits]
    # The bit-serial CA-SCL (the JAX module's decoder; the fast-SSCL tree
    # parts from it on ties), in the link's passes.
    dec = coded.polar_decode_passes(llr_sent.reshape(B, n_cw, code.block_len), code, POLAR_LIST,
                                    decode=polar_decode_scl)
    return dec.reshape(B, -1)[:, :pcfg.n_info_bits]


def encode_packet(pcfg: PacketConfig, payload: torch.Tensor) -> torch.Tensor:
    """Payloads (B, payload_bytes) uint8 → bursts (B, burst_len) complex64:
    CRC-append → FEC encode (conv/LDPC/polar per pcfg.fec) → whole-frame
    interleave → pilot-bearing OFDM symbols (kernel B with the comb,
    ``pipeline.tx_chain``) → S&C preamble prepended."""
    cfg = pcfg._link_cfg()
    B = payload.shape[0]
    bits = bytes_to_bits(payload.to(torch.uint8))
    info = torch.cat([bits, crc32_bits(bits)], dim=1)
    cw = _fec_encode(pcfg, info)
    frame = torch.zeros((B, pcfg.frame_bits), dtype=torch.int8, device=payload.device)
    frame[:, :cw.shape[1]] = cw
    re, im = pipeline.tx_chain(
        cfg, interleave(frame).view(B, cfg.n_symbols, cfg.bits_per_ofdm_symbol))
    pre = sync.acquisition_preamble(pcfg.ofdm.n_fft, pcfg.ofdm.cp_len, device=payload.device)
    return torch.cat([pre.expand(B, -1), torch.complex(re, im).reshape(B, -1)], dim=1)


def _acquire(pcfg: PacketConfig, stream: torch.Tensor):
    """Blind acquisition of (B, T) streams: (start (B,) int64, the
    CFO-corrected payload planes (B, n_symbols, N+cp) each), in passes of
    ``pipeline.CHUNK`` streams."""
    N, cp = pcfg.ofdm.n_fft, pcfg.ofdm.cp_len
    S, L = pcfg.n_symbols, pcfg.ofdm.symbol_len

    def front(_, zc):
        start, total = sync.acquire_start(zc, N, cp)
        pay = sync.corrected_slice(zc, total, start, S * L, N).reshape(-1, S, L)
        return start, pay.real, pay.imag

    start, re, im = pipeline._in_passes(front, stream.to(torch.complex64))
    return start, (re, im)


def sent_llrs(pcfg: PacketConfig, payload_t, noise_var) -> torch.Tensor:
    """Aligned payload planes (B, n_symbols, N+cp) → the coded bits' LLRs
    (B, n_coded_bits): ``rx_chain`` with the tracked comb estimate (the
    burst was blind-acquired, so a residual CFO rotates it a little more
    each symbol — load-bearing for LDPC's 28-symbol bursts), then the
    whole-frame deinterleave."""
    cfg = pcfg._link_cfg()
    llrs, _ = pipeline.rx_chain(cfg, payload_t, None, float(noise_var), track_phase=True)
    B = llrs.shape[0]
    llr = deinterleave(llrs.reshape(B, -1)[:, :pcfg.frame_bits])[:, :pcfg.n_coded_bits]
    return llr.contiguous()


def _check_crc(pcfg: PacketConfig, decoded: torch.Tensor):
    """Decoded info (B, n_info_bits) → (payload bytes (B, payload_bytes)
    uint8, crc_ok (B,) bool)."""
    n = 8 * pcfg.payload_bytes
    bits, crc_rx = decoded[:, :n], decoded[:, n:]
    crc_ok = torch.all(crc32_bits(bits) == crc_rx, dim=1)
    return bits_to_bytes(bits), crc_ok


def _decode_aligned(pcfg: PacketConfig, payload_t, noise_var):
    """Aligned payload planes → (bytes, crc_ok)."""
    return _check_crc(pcfg, _fec_decode(pcfg, sent_llrs(pcfg, payload_t, noise_var)))


def decode_packet(pcfg: PacketConfig, stream: torch.Tensor, noise_var):
    """Blind receive: streams (B, T ≥ burst_len + slack) → (payloads (B,
    payload_bytes) uint8, crc_ok (B,) bool).

    A stream may start anywhere before its burst (unknown delay) and carry
    CFO and fading — ``ops.sync`` recovers timing and carrier, the comb
    pilots the channel. ``noise_var`` is the per-subcarrier noise power the
    LLRs are scaled by (an estimate is fine; the CRC arbitrates)."""
    _, payload_t = _acquire(pcfg, stream)
    return _decode_aligned(pcfg, payload_t, noise_var)


def receive_stream(pcfg: PacketConfig, stream: torch.Tensor, noise_var, max_bursts: int):
    """Continuous receiver: find and decode up to ``max_bursts`` bursts
    anywhere in each capture of a batch (B, T), each burst with its own
    delay and CFO.

    Successive cancellation on the DETECTION metric: per round, the full
    blind acquisition (the S&C plateau finds the strongest remaining
    preamble), the decode of that burst, then its samples zeroed out of
    the working stream — the uncorrected one, by index only, so the next
    round estimates its own CFO from scratch. Rounds that land on noise
    after the real bursts decode garbage that the CRC rejects.

    Returns (payloads (B, max_bursts, payload_bytes) uint8, crc_ok (B,
    max_bursts) bool, starts (B, max_bursts) int32 — burst-start sample
    indices, valid where crc_ok)."""
    S, L = pcfg.n_symbols, pcfg.ofdm.symbol_len
    n_payload = S * L
    work = stream.to(torch.complex64)
    idx = torch.arange(work.shape[-1], device=work.device)
    payloads, oks, starts = [], [], []
    for _ in range(max_bursts):
        start, payload_t = _acquire(pcfg, work)
        payload, ok = _decode_aligned(pcfg, payload_t, noise_var)
        b0 = start - 2 * L
        b1 = start + n_payload
        work = torch.where((idx >= b0[:, None]) & (idx < b1[:, None]), 0.0, work)
        payloads.append(payload)
        oks.append(ok)
        starts.append(b0.to(torch.int32))
    return torch.stack(payloads, 1), torch.stack(oks, 1), torch.stack(starts, 1)


def make_packet_codec(pcfg: PacketConfig, device="cuda"):
    """(encode, decode) for one packet shape on ``device``: encode(payloads)
    → bursts, decode(streams, noise_var) → (payloads, crc_ok)."""

    def enc(payload):
        return encode_packet(pcfg, torch.as_tensor(payload, dtype=torch.uint8, device=device))

    def dec(stream, noise_var):
        return decode_packet(pcfg, torch.as_tensor(stream, device=device), noise_var)

    return enc, dec


def noise_var(pcfg: PacketConfig, ch: ChannelConfig) -> float:
    """The subcarrier noise variance of ``ch``'s Eb/N0 (computed in float32,
    as the JAX ``ebno_db_to_noise_var``)."""
    return float(chan.ebno_db_to_noise_var(ch.ebno_db, pcfg.modulation.bits_per_symbol))


def _fading(pcfg: PacketConfig, ch: ChannelConfig, seed: int, ch_ids: torch.Tensor, fading,
            n_rows: int):
    """Kernel E's channel arguments for the (B, n_rows + 1, N+cp) burst
    plane (the tail row after the burst), or None where the model does not
    fade the packet (the JAX branches: MULTIPATH, MULTIPATH_TIME,
    RAYLEIGH_FLAT and RICIAN fade; every other model leaves the burst as
    it is)."""
    model = ch.model
    B = ch_ids.shape[0]
    if model == ChannelModel.MULTIPATH:
        taps = fading if fading is not None else chan.multipath_taps(seed, ch_ids, ch.pdp)
        return dict(zip(("taps_r", "taps_i"), fast._planar(taps.to(torch.complex64))))
    if model == ChannelModel.MULTIPATH_TIME:
        taps = fading if fading is not None else chan.multipath_time_taps(
            seed, ch_ids, ch.pdp, n_rows, ch.doppler_norm)
        # The tail symbol takes the last symbol's taps, with its tail as
        # history (the JAX tail convolution).
        taps = pipeline._tail_row(taps.to(torch.complex64), True)
        return dict(zip(("taps_r", "taps_i"), fast._planar(taps)))
    if model in (ChannelModel.RAYLEIGH_FLAT, ChannelModel.RICIAN):
        if fading is None:
            fading = (chan.rayleigh_flat(seed, ch_ids) if model == ChannelModel.RAYLEIGH_FLAT
                      else chan.rician_flat(seed, ch_ids, ch.k_factor))
        h = fading.to(torch.complex64).reshape(B, 1)
        return dict(zip(("hr_s", "hi_s"), fast._planar(h)))
    return None


def transmit_over_channel(pcfg: PacketConfig, ch: ChannelConfig, seed: int,
                          burst: torch.Tensor, ch_ids: torch.Tensor | None = None, *,
                          fading=None, noise=None):
    """Impair bursts (B, burst_len): unknown delay (``ch.timing_offset``),
    fading, CFO, AWGN — the over-the-air leg of ``simulate_packets``.
    Returns (streams (B, T) complex64, T = timing_offset + burst_len +
    N+cp, and the subcarrier noise variance).

    The burst and one symbol of zeros as a (B, 3 + S, N+cp) plane through
    kernel E with the channel only (``_fading``), the delay's zeros ahead
    (zeros stay zeros through any FIR), the CFO at absolute sample index
    (``ops.sync.apply_cfo``), then E's noise over the stream as one
    (B, 1, T) row, keyed at (ch_ids[b], 0, sample) (none for IDENTITY).
    ``ch_ids``: the packets' global ids (default 0 … B−1). Injection forms:
    ``fading`` — flat gains (B,) for RAYLEIGH_FLAT and RICIAN, taps (B, Lt)
    for MULTIPATH, (B, 2 + S, Lt) for MULTIPATH_TIME —, ``noise`` — the
    N(0, 1) planes (n_re, n_im), each (B, 1, T)."""
    B = burst.shape[0]
    L = pcfg.ofdm.symbol_len
    N = pcfg.ofdm.n_fft
    dev = burst.device
    if ch_ids is None:
        ch_ids = torch.arange(B, dtype=torch.int32, device=dev)
    nv = noise_var(pcfg, ch)
    n_rows = burst.shape[1] // L
    re, im = fast._planar(burst.reshape(B, n_rows, L))
    zeros = torch.zeros((B, 1, L), dtype=torch.float32, device=dev)
    plane = tuple(torch.cat([t, zeros], dim=1) for t in (re, im))
    chan_kw = _fading(pcfg, ch, seed, ch_ids, fading, n_rows)
    if chan_kw is not None:
        plane = fade_awgn(*plane, **chan_kw)
    delay = torch.zeros((B, ch.timing_offset), dtype=torch.float32, device=dev)
    z = torch.complex(*(torch.cat([delay, t.reshape(B, -1)], dim=1) for t in plane))
    del plane
    z = sync.apply_cfo(z, ch.cfo_subcarriers, N)
    if ch.model != ChannelModel.IDENTITY:
        kw = dict(noise=noise) if noise is not None else dict(seed=seed, ch_ids=ch_ids)
        re, im = fade_awgn(*fast._planar(z[:, None, :]), noise_var=nv / N, **kw)
        z = torch.complex(re[:, 0], im[:, 0])
    return z, nv


def draw_payload(pcfg: PacketConfig, seed: int, ch_ids: torch.Tensor) -> torch.Tensor:
    """The packets' payloads (B, payload_bytes) uint8: ``prng.info_bits``
    at (packet, 0, bit), packed MSB first."""
    return bits_to_bytes(prng.info_bits(seed, ch_ids, 1, 8 * pcfg.payload_bytes)[:, 0])


def simulate_packets(pcfg: PacketConfig, ch: ChannelConfig, seed: int, n_packets: int,
                     device="cuda", *, payload=None, fading=None, noise=None):
    """End-to-end packet campaign on ``device``: keyed payloads, the burst,
    the channel, the blind receive. Returns (byte_errors (n_packets,)
    int32, crc_ok (n_packets,) bool) — the packet error rate is
    mean(byte_errors > 0); a CRC false accept shows as crc_ok &
    byte_errors > 0 (probability ~2^-32). ``payload`` ((n_packets,
    payload_bytes) uint8), ``fading`` and ``noise`` (``transmit_over_channel``)
    inject draws."""
    ids = torch.arange(n_packets, dtype=torch.int32, device=device)
    if payload is None:
        payload = draw_payload(pcfg, seed, ids)
    payload = payload.to(device=device, dtype=torch.uint8)
    burst = encode_packet(pcfg, payload)
    stream, nv = transmit_over_channel(pcfg, ch, seed, burst, ids, fading=fading, noise=noise)
    del burst
    rx_payload, crc_ok = decode_packet(pcfg, stream, nv)
    return (rx_payload != payload).sum(dim=1, dtype=torch.int32), crc_ok
