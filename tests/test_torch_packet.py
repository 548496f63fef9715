"""The port's packet modem (sdr_tpu_torch.link.packet) on the CPU, held
against the JAX ``sdr_tpu.link.packet`` — the convolutional packets; the
LDPC and polar packets are ``tests/test_torch_packet_codes.py``.

- ``crc32_bits`` equals the JAX bit-serial LFSR and the JAX test's
  pure-Python one, bit for bit.
- ``PacketConfig``'s derived sizes and link config equal the JAX ones
  exactly over every fec × rate and a few payload sizes.
- ``encode_packet``'s bursts within 1e-5 of their peak of the JAX bursts
  (float32 IDFTs in another order).
- ``transmit_over_channel`` on the JAX campaign's own draws — the fading
  and the noise regenerated from each packet's ``fold_in`` key as the JAX
  function draws them and injected (``fading=``, ``noise=``) — for every
  branch of the JAX function (IDENTITY, AWGN, RAYLEIGH_FLAT, RICIAN,
  MULTIPATH, MULTIPATH_TIME; RAYLEIGH_TIME takes the AWGN branch there),
  within 1e-5 of the stream's peak (the noise is scaled in another order).
- The blind receive on numpy streams the JAX encoder and channel made, at
  rates 1/2, 2/3 and 3/4: near the waterfall (some packets fail in both)
  stage by stage — the acquired starts exactly, the decoder's input LLRs
  within 1e-4 of their peak, the port's decoder and CRC on the JAX LLRs
  giving the JAX bytes and ``crc_ok`` exactly (``check_waterfall``, whose
  notes say why not end to end there); end to end at 16 dB,
  ``decode_packet``'s bytes and ``crc_ok`` exactly. ``receive_stream``'s
  payloads, oks and starts exactly on the JAX test's capture.
- The JAX ``tests/test_packet.py`` gates on the port's own keyed draws at
  the JAX tests' sizes, the JAX tests' key numbers as seeds.

Each JAX function is compiled once per packet shape (module-level caches,
batched with ``vmap``); the JAX compiles are most of this file's time.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.core import prng as jprng
from sdr_tpu.link import packet as jpacket
from sdr_tpu.ops import channel as jchan
from sdr_tpu.link.pipeline import rx_chain as j_rx_chain
from sdr_tpu.ops.interleave import deinterleave as j_deinterleave
from sdr_tpu.ops.modulation import bits_to_bytes as j_bits_to_bytes
from sdr_tpu.ops.sync import acquire as j_acquire
from sdr_tpu.ops.sync import apply_cfo as j_apply_cfo
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import ChannelConfig, ChannelModel
from sdr_tpu_torch.kernels.channel import fade_awgn
from sdr_tpu_torch.link import packet
from sdr_tpu_torch.ops.sync import apply_cfo

torch.set_num_threads(1)

JM = jcfg.ChannelModel
# The JAX tests' packet shape (tests/test_packet.py:52-58).
J_PCFG = jpacket.PacketConfig(payload_bytes=32, modulation=jcfg.Modulation.QPSK,
                              ofdm=jcfg.OFDMConfig(n_fft=64, cp_len=16), rate="1/2",
                              pilot_spacing=8)
PCFG = interop.packet_config_from_reference(J_PCFG)
RATES = ("1/2", "2/3", "3/4")


def _t(a):
    return torch.from_numpy(np.array(a))


def _crc32_ref(bits):
    """Independent bit-serial CRC-32 (0x04C11DB7, init/final 0xFFFFFFFF)."""
    state = 0xFFFFFFFF
    for b in bits:
        fb = ((state >> 31) & 1) ^ int(b)
        state = ((state << 1) & 0xFFFFFFFF) ^ (0x04C11DB7 if fb else 0)
    return state ^ 0xFFFFFFFF


def _channel(jch):
    """A JAX ``ChannelConfig`` → the port's (the fields a packet reads)."""
    return ChannelConfig(model=ChannelModel(jch.model.value), ebno_db=jch.ebno_db,
                         pdp=tuple(jch.pdp), doppler_norm=jch.doppler_norm,
                         cfo_subcarriers=jch.cfo_subcarriers, timing_offset=jch.timing_offset,
                         k_factor=jch.k_factor)


@functools.lru_cache(maxsize=None)
def _j_encoder(jp):
    return jax.jit(jax.vmap(lambda p: jpacket.encode_packet(jp, p)))


@functools.lru_cache(maxsize=None)
def _j_decoder(jp):
    return jax.jit(jax.vmap(lambda s, nv: jpacket.decode_packet(jp, s, nv), in_axes=(0, None)))


def _payloads(seed, n, n_bytes):
    return np.random.default_rng(seed).integers(0, 256, (n, n_bytes)).astype(np.uint8)


# ---- the CRC ---------------------------------------------------------------------------------

def test_crc32_equals_jax_and_the_reference_lfsr():
    rng = np.random.default_rng(3)
    for n in (8, 72, 513, 8 * 64):
        bits = rng.integers(0, 2, size=(3, n)).astype(np.int8)
        got = packet.crc32_bits(_t(bits))
        assert got.dtype == torch.int8 and got.shape == (3, 32)
        want = np.asarray(jax.jit(jax.vmap(jpacket.crc32_bits))(jnp.asarray(bits)))
        np.testing.assert_array_equal(got.numpy(), want)
        for row, crc in zip(bits, got.numpy()):
            assert int("".join(str(int(b)) for b in crc), 2) == _crc32_ref(row)


def test_crc32_detects_single_bit_flip():
    bits = torch.zeros((1, 128), dtype=torch.int8)
    bits[0, 17] = 1
    flipped = bits.clone()
    flipped[0, 90] = 1
    assert not torch.equal(packet.crc32_bits(bits), packet.crc32_bits(flipped))


# ---- sizes -----------------------------------------------------------------------------------

@pytest.mark.parametrize("fec", ["conv", "ldpc", "polar"])
@pytest.mark.parametrize("rate", RATES)
def test_packet_config_sizes_equal_jax(fec, rate):
    for n_bytes in (1, 16, 64, 200):
        jp = jpacket.PacketConfig(payload_bytes=n_bytes, rate=rate, fec=fec)
        pc = interop.packet_config_from_reference(jp)
        for name in ("n_info_bits", "_n_codewords", "n_coded_bits", "n_symbols", "frame_bits",
                     "burst_len"):
            assert getattr(pc, name) == getattr(jp, name), (name, n_bytes)
        assert pc._link_cfg() == interop.link_config_from_reference(jp._link_cfg())


def test_packet_config_validation():
    with pytest.raises(ValueError):
        packet.PacketConfig(payload_bytes=0)
    with pytest.raises(ValueError):
        packet.PacketConfig(rate="5/6")
    with pytest.raises(ValueError):  # the blind receiver needs the pilot comb
        packet.PacketConfig(pilot_spacing=0)
    with pytest.raises(ValueError):
        packet.PacketConfig(fec="turbo")
    assert PCFG.n_info_bits == 32 * 8 + 32
    assert PCFG.n_coded_bits <= PCFG.frame_bits
    assert PCFG.burst_len == (2 + PCFG.n_symbols) * 80


# ---- the burst and the channel -----------------------------------------------------------------

@pytest.mark.parametrize("rate", RATES)
def test_encode_packet_equals_jax(rate):
    jp = dataclasses.replace(J_PCFG, rate=rate)
    pay = _payloads(11, 4, jp.payload_bytes)
    want = np.asarray(_j_encoder(jp)(jnp.asarray(pay)))
    got = packet.encode_packet(interop.packet_config_from_reference(jp), _t(pay))
    assert got.dtype == torch.complex64 and got.shape == (4, jp.burst_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


CHANNELS = {
    "identity": jcfg.ChannelConfig(model=JM.IDENTITY, cfo_subcarriers=0.7, timing_offset=11),
    "awgn": jcfg.ChannelConfig(model=JM.AWGN, ebno_db=8.0, cfo_subcarriers=-1.3,
                               timing_offset=37),
    "rayleigh_flat": jcfg.ChannelConfig(model=JM.RAYLEIGH_FLAT, ebno_db=12.0,
                                        cfo_subcarriers=1.3, timing_offset=37),
    "rician": jcfg.ChannelConfig(model=JM.RICIAN, ebno_db=12.0, k_factor=3.0,
                                 cfo_subcarriers=0.4, timing_offset=5),
    "multipath": jcfg.ChannelConfig(model=JM.MULTIPATH, ebno_db=16.0, pdp=(1.0, 0.5, 0.25),
                                    cfo_subcarriers=1.3, timing_offset=37),
    "multipath_time": jcfg.ChannelConfig(model=JM.MULTIPATH_TIME, ebno_db=16.0,
                                         pdp=(1.0, 0.5, 0.25), doppler_norm=0.05,
                                         cfo_subcarriers=1.3, timing_offset=37),
    "rayleigh_time": jcfg.ChannelConfig(model=JM.RAYLEIGH_TIME, ebno_db=12.0,
                                        cfo_subcarriers=0.9, timing_offset=3),
}


def _jax_transmit(jp, jch, seed, bursts):
    """The JAX ``transmit_over_channel`` of each burst on packet key
    ``fold_in(PRNGKey(seed), i)``, and its draws regenerated from that key
    in the port's injection forms: (streams, nv, fading or None, noise)."""
    n_rows = jp.burst_len // jp.ofdm.symbol_len

    def one(key, burst):
        stream, nv = jpacket.transmit_over_channel(jp, jch, key, burst)
        kf = jprng.role_key(key, jprng.ROLE_FADING)
        if jch.model == JM.MULTIPATH:
            fade = jchan.multipath_taps(kf, jch.pdp)
        elif jch.model == JM.MULTIPATH_TIME:
            fade = jchan.multipath_time_taps(kf, jch.pdp, n_rows, jch.doppler_norm)
        elif jch.model == JM.RAYLEIGH_FLAT:
            fade = jchan.rayleigh_flat(kf, ())
        elif jch.model == JM.RICIAN:
            fade = jchan.rician_flat(kf, (), jch.k_factor)
        else:
            fade = jnp.zeros((), jnp.complex64)
        kr, ki = jax.random.split(jprng.role_key(key, jprng.ROLE_NOISE))
        shape = stream.shape
        return stream, nv, fade, jax.random.normal(kr, shape), jax.random.normal(ki, shape)

    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.arange(bursts.shape[0]))
    stream, nv, fade, nre, nim = (np.asarray(t) for t in jax.jit(jax.vmap(one))(
        keys, jnp.asarray(bursts)))
    fading = None if jch.model in (JM.IDENTITY, JM.AWGN, JM.RAYLEIGH_TIME) else _t(fade)
    return stream, float(nv[0]), fading, (_t(nre[:, None, :]), _t(nim[:, None, :]))


@pytest.mark.parametrize("name", list(CHANNELS))
def test_transmit_over_channel_equals_jax(name):
    jch = CHANNELS[name]
    bursts = np.asarray(_j_encoder(J_PCFG)(jnp.asarray(_payloads(5, 3, 32))))
    want, nv_j, fading, noise = _jax_transmit(J_PCFG, jch, 7, bursts)
    got, nv = packet.transmit_over_channel(PCFG, _channel(jch), 7, _t(bursts), fading=fading,
                                           noise=noise)
    assert got.shape == want.shape == (3, jch.timing_offset + PCFG.burst_len + 80)
    assert nv == nv_j
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---- the blind receive -------------------------------------------------------------------------

# Near the waterfall: multipath, delay and CFO at Eb/N0s where about half of
# the packets fail, so both receivers' wrong decisions are compared too.
# There the two packages' LLRs (float32 FFTs, estimates and rotations in
# other orders) differ by about 1e-6 of their peak, which can move a
# Viterbi decision whose path metrics tie that closely — as batching moves
# the JAX decoder's own (the JAX decode of one packet and of a vmapped
# batch part on such a packet). So the waterfall streams are held stage by
# stage, the JAX receive split at the decoder's input (its ``acquire``,
# slice, ``rx_chain`` and deinterleave, then its ``_fec_decode`` and CRC):
# the acquired start exactly, the LLRs within 1e-4 of their peak, and the
# port's decoder and CRC on the JAX LLRs give the JAX bytes and crc_ok
# exactly. End to end, ``decode_packet`` equals the JAX receive exactly on
# streams at 16 dB. The JAX split is the JAX ``decode_packet``'s own code
# path (``_decode_aligned``), held equal to it on the rate-1/2 streams.
WATERFALL_DB = {"1/2": 3.0, "2/3": 5.0, "3/4": 6.0}


def _j_llrs(jp, stream, nv):
    """The JAX receive up to the decoder's input: (start, coded-bit LLRs)."""
    cfg = jp._link_cfg()
    start, _, rx_c = j_acquire(stream, jp.ofdm.n_fft, jp.ofdm.cp_len)
    payload_t = jax.lax.dynamic_slice_in_dim(rx_c, start, cfg.n_symbols * jp.ofdm.symbol_len)
    llrs, _ = j_rx_chain(cfg, payload_t.reshape(cfg.n_symbols, -1), None, nv, track_phase=True)
    return start, j_deinterleave(llrs.reshape(-1)[:jp.frame_bits])[:jp.n_coded_bits]


def _j_decision(jp, llr):
    """The JAX decoder and CRC on coded-bit LLRs: (bytes, crc_ok)."""
    decoded = jpacket._fec_decode(jp, llr)
    n = 8 * jp.payload_bytes
    bits = decoded[:n]
    return j_bits_to_bytes(bits), jnp.all(jpacket.crc32_bits(bits) == decoded[n:])


@functools.lru_cache(maxsize=None)
def _j_split(jp):
    """The JAX receive split at the decoder's input, each half compiled once
    per packet shape and batched over packets: (streams, nv) → (starts,
    LLRs), LLRs → (bytes, crc_ok)."""
    return (jax.jit(jax.vmap(lambda s, nv: _j_llrs(jp, s, nv), in_axes=(0, None))),
            jax.jit(jax.vmap(lambda x: _j_decision(jp, x))))


@functools.lru_cache(maxsize=None)
def _decode_case(jp, ebno_db):
    """Twelve packets of ``jp`` through the JAX encoder and channel
    (MULTIPATH (1, .5), delay 37, CFO 1.3): (streams, nv, the sent payloads,
    the JAX split receive's (starts, LLRs, bytes, crc_ok))."""
    jch = jcfg.ChannelConfig(model=JM.MULTIPATH, ebno_db=ebno_db, pdp=(1.0, 0.5),
                             cfo_subcarriers=1.3, timing_offset=37)
    pay = _payloads(13, 12, jp.payload_bytes)
    stream, nv, _, _ = _jax_transmit(jp, jch, 3, np.asarray(_j_encoder(jp)(jnp.asarray(pay))))
    llrs, decision = _j_split(jp)
    start, llr = llrs(jnp.asarray(stream), nv)
    return stream, nv, pay, tuple(np.asarray(t) for t in (start, llr, *decision(llr)))


def check_waterfall(jp, ebno_db):
    """The split receive on streams at the waterfall (the module notes)."""
    pc = interop.packet_config_from_reference(jp)
    stream, nv, _, (start_j, llr_j, rx_j, ok_j) = _decode_case(jp, ebno_db)
    start, planes = packet._acquire(pc, _t(stream))
    np.testing.assert_array_equal(start.numpy(), start_j)
    llr = packet.sent_llrs(pc, planes, nv)
    np.testing.assert_allclose(llr.numpy(), llr_j, rtol=0, atol=1e-4 * np.abs(llr_j).max())
    rx, ok = packet._check_crc(pc, packet._fec_decode(pc, _t(llr_j)))
    np.testing.assert_array_equal(rx.numpy(), rx_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert 0 < ok_j.sum() < len(ok_j)  # right and wrong decodes both compared


def check_end_to_end(jp):
    """``decode_packet`` against the JAX receive at 16 dB, exactly."""
    pc = interop.packet_config_from_reference(jp)
    stream, nv, pay, (_, _, rx_j, ok_j) = _decode_case(jp, 16.0)
    rx, ok = packet.decode_packet(pc, _t(stream), nv)
    assert rx.dtype == torch.uint8 and ok.dtype == torch.bool
    np.testing.assert_array_equal(rx.numpy(), rx_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    np.testing.assert_array_equal(ok_j, (rx_j == pay).all(axis=1))


@pytest.mark.parametrize("rate", RATES)
def test_decode_packet_equals_jax_at_the_waterfall(rate):
    check_waterfall(dataclasses.replace(J_PCFG, rate=rate), WATERFALL_DB[rate])


@pytest.mark.parametrize("rate", RATES)
def test_decode_packet_equals_jax(rate):
    check_end_to_end(dataclasses.replace(J_PCFG, rate=rate))


def test_split_receive_is_the_jax_decode_packet():
    """The JAX reference's split (``_j_llrs`` then ``_j_decision``) is the
    JAX ``decode_packet``: the same bytes and crc_ok on the rate-1/2
    streams at the waterfall and at 16 dB."""
    for ebno_db in (WATERFALL_DB["1/2"], 16.0):
        stream, nv, _, (_, _, rx_j, ok_j) = _decode_case(J_PCFG, ebno_db)
        rx, ok = (np.asarray(t) for t in _j_decoder(J_PCFG)(jnp.asarray(stream), nv))
        np.testing.assert_array_equal(rx, rx_j)
        np.testing.assert_array_equal(ok, ok_j)


def _capture(enc, apply, pcfg, payloads):
    """The JAX test's capture (tests/test_packet.py:130-142) before noise:
    three bursts at 180, 1500 and 2890 with CFOs 0.4, −0.8 and 1.2."""
    stream = np.zeros((4096,), np.complex64)
    for payload, pos, cfo in zip(payloads, (180, 1500, 2890), (0.4, -0.8, 1.2)):
        burst = np.asarray(apply(enc(payload), cfo))
        stream[pos:pos + burst.shape[-1]] = burst.reshape(-1)
    return stream


def test_receive_stream_equals_jax():
    jp = dataclasses.replace(J_PCFG, payload_bytes=16)
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, jp.payload_bytes).astype(np.uint8) for _ in range(3)]
    enc = jax.jit(lambda p: jpacket.encode_packet(jp, p))
    clean = _capture(lambda p: enc(jnp.asarray(p)),
                     lambda b, c: j_apply_cfo(b, c, jp.ofdm.n_fft), jp, payloads)
    nv = float(jchan.ebno_db_to_noise_var(20.0, 2))
    stream = np.asarray(jchan.awgn(jax.random.PRNGKey(2), jnp.asarray(clean),
                                   jchan.time_noise_var(nv, jp.ofdm.n_fft)))
    want = [np.asarray(t) for t in jax.jit(
        lambda s: jpacket.receive_stream(jp, s, nv, max_bursts=5))(jnp.asarray(stream))]
    got = packet.receive_stream(interop.packet_config_from_reference(jp), _t(stream[None]), nv, 5)
    assert [t.shape for t in got] == [(1, 5, 16), (1, 5), (1, 5)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w)
    assert want[1].sum() == 3


# ---- the JAX tests' gates on the port's own draws ------------------------------------------------

def test_packet_roundtrip_clean():
    """Perfect channel (tiny noise for the LLR scaling): exact byte round
    trip through encode → blind acquire → decode (tests/test_packet.py:61-73)."""
    enc, dec = packet.make_packet_codec(PCFG, device="cpu")
    payload = (torch.arange(32, dtype=torch.int32) * 7 + 3).to(torch.uint8)[None]
    burst = enc(payload)
    assert burst.shape == (1, PCFG.burst_len)
    stream = torch.cat([burst, torch.zeros((1, 80), dtype=torch.complex64)], dim=1)
    rx, ok = dec(stream, 1e-3)
    assert bool(ok[0])
    assert torch.equal(rx, payload)


@pytest.mark.parametrize("rate", RATES)
def test_packet_roundtrip_impaired(rate):
    """Unknown delay + fractional-plus-integer CFO + multipath at 16 dB:
    the CRC agrees with the bytes, at least 3/4 decode
    (tests/test_packet.py:76-96, key 0)."""
    ch = ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=16.0, pdp=(1.0, 0.5),
                       cfo_subcarriers=1.3, timing_offset=37)
    byte_errs, crc_ok = packet.simulate_packets(dataclasses.replace(PCFG, rate=rate), ch, 0, 16,
                                                device="cpu")
    assert torch.equal(crc_ok, byte_errs == 0)
    assert crc_ok.float().mean() >= 0.75, crc_ok


# The packets of the modem's own numerology (``PacketConfig()``: 64 bytes,
# QPSK, N 64, CP 16) at conv 3/4 through MULTIPATH (1, .5), 16 dB, CFO 1.3,
# delay 37, seed 20261016 (chip_smoke.py's phase 3x campaign) whose payload
# the port decodes right and whose CRC bits it does not: all 15 of ids
# 0-8191 on the CPU, where 270 packets hold byte errors and none passes
# the CRC with them.
FALSE_ALARM_SEED = 20261016
FALSE_ALARM_IDS = (75, 224, 548, 827, 1010, 1533, 2855, 3327, 3662, 4339, 4371, 4476, 4969, 6009,
                   6990)


def test_crc_false_alarms_are_the_jax_decoders():
    """A CRC failure on a packet whose payload bytes are right is the
    decoder's own, not the port's: on the LLRs of the port's false-alarm
    packets, the JAX ``_fec_decode`` decodes the same info words bit for
    bit, the same right payloads and the same failed CRCs. And in the
    campaign's first 1024 packets through ``simulate_packets`` the false
    alarms are exactly the listed ids and no packet passes the CRC with a
    byte error, so ``crc_ok == (byte_errors == 0)`` does not hold at this
    link while no false accept does."""
    jp = jpacket.PacketConfig(rate="3/4")
    pc = interop.packet_config_from_reference(jp)
    assert pc == dataclasses.replace(packet.PacketConfig(), rate="3/4")
    ch = ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=16.0, pdp=(1.0, 0.5),
                       cfo_subcarriers=1.3, timing_offset=37)
    errs, ok = packet.simulate_packets(pc, ch, FALSE_ALARM_SEED, 1024, device="cpu")
    assert not bool((ok & (errs > 0)).any())
    alarms = torch.nonzero(~ok & (errs == 0))[:, 0].tolist()
    assert alarms == [i for i in FALSE_ALARM_IDS if i < 1024]
    ids = torch.tensor(FALSE_ALARM_IDS, dtype=torch.int32)
    pay = packet.draw_payload(pc, FALSE_ALARM_SEED, ids)
    stream, nv = packet.transmit_over_channel(pc, ch, FALSE_ALARM_SEED,
                                              packet.encode_packet(pc, pay), ids)
    llr = packet.sent_llrs(pc, packet._acquire(pc, stream)[1], nv)
    dec = packet._fec_decode(pc, llr)
    rx, ok = packet._check_crc(pc, dec)
    assert torch.equal(rx, pay) and not bool(ok.any())
    llr_j = jnp.asarray(llr.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(lambda x: jpacket._fec_decode(jp, x)))(llr_j)), dec.numpy())
    rx_j, ok_j = (np.asarray(t) for t in _j_split(jp)[1](llr_j))
    np.testing.assert_array_equal(rx_j, pay.numpy())
    assert not ok_j.any()


def test_packet_crc_flags_low_snr():
    """AWGN at −6 dB: bytes are lost and the CRC says so
    (tests/test_packet.py:99-104, key 1)."""
    ch = ChannelConfig(model=ChannelModel.AWGN, ebno_db=-6.0)
    byte_errs, crc_ok = packet.simulate_packets(PCFG, ch, 1, 12, device="cpu")
    assert int(byte_errs.sum()) > 0
    assert torch.equal(crc_ok, byte_errs == 0)


def test_receive_stream_multi_burst():
    """Three bursts in one capture, each with its own CFO, the noise E's
    keyed row (seed 2): all three found and decoded, the extra rounds
    CRC-rejected (tests/test_packet.py:107-157)."""
    pc = dataclasses.replace(PCFG, payload_bytes=16)
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, pc.payload_bytes).astype(np.uint8) for _ in range(3)]
    clean = _capture(lambda p: packet.encode_packet(pc, _t(p[None]))[0],
                     lambda b, c: apply_cfo(b, c, pc.ofdm.n_fft), pc, payloads)
    nv = packet.noise_var(pc, ChannelConfig(ebno_db=20.0))
    re, im = fade_awgn(*(_t(p)[None, None] for p in (clean.real, clean.imag)),
                       noise_var=nv / pc.ofdm.n_fft, seed=2,
                       ch_ids=torch.zeros(1, dtype=torch.int32))
    rx, oks, starts = packet.receive_stream(pc, torch.complex(re[:, 0], im[:, 0]), nv, 5)
    assert int(oks.sum()) == 3, oks
    got = {int(s): p.numpy() for s, p, ok in zip(starts[0], rx[0], oks[0]) if ok}
    for payload, pos in zip(payloads, (180, 1500, 2890)):
        key = min(got, key=lambda s: abs(s - pos))
        assert abs(key - pos) <= pc.ofdm.cp_len, (key, pos)
        np.testing.assert_array_equal(got[key], payload)


def test_entry_points_default_to_the_card():
    for fn in (packet.simulate_packets, packet.make_packet_codec):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            packet.simulate_packets(PCFG, ChannelConfig(), 0, 2)
