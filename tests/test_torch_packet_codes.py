"""The port's LDPC and polar packets (sdr_tpu_torch.link.packet, ``fec``
"ldpc" and "polar") on the CPU, held against the JAX
``sdr_tpu.link.packet`` — as ``tests/test_torch_packet.py`` holds the
convolutional packets, with its helpers:

- ``encode_packet``'s bursts within 1e-5 of their peak of the JAX bursts;
- the blind receive on numpy streams the JAX encoder and channel made: at
  1 dB (the waterfall of both families under MULTIPATH (1, .5)) stage by
  stage — the starts exactly, the decoder's input LLRs within 1e-4 of
  their peak, the port's decoder (kernel H's plain version, and the
  bit-serial CA-SCL-8) and CRC on the JAX LLRs giving the JAX bytes and
  ``crc_ok`` exactly; at 16 dB ``decode_packet`` end to end exactly;
- the JAX ``tests/test_packet.py:174-206`` gate (five 64-byte packets at
  10 dB with delay and CFO 1.3 all decode) on the port's own draws.

The JAX LDPC and polar decoders' compiles are most of this file's time.
"""

import numpy as np
import pytest
import torch

from sdr_tpu.link import packet as jpacket
from sdr_tpu_torch.core.config import ChannelConfig, ChannelModel
from sdr_tpu_torch.link import packet
from tests.test_torch_packet import (
    _j_encoder,
    _payloads,
    _t,
    check_end_to_end,
    check_waterfall,
)

torch.set_num_threads(1)

FECS = ("ldpc", "polar")
WATERFALL_DB = 1.0


def _jp(fec):
    return jpacket.PacketConfig(payload_bytes=64, fec=fec)


@pytest.mark.parametrize("fec", FECS)
def test_encode_packet_equals_jax(fec):
    jp = _jp(fec)
    pay = _payloads(11, 3, jp.payload_bytes)
    want = np.asarray(_j_encoder(jp)(pay))
    got = packet.encode_packet(packet.PacketConfig(payload_bytes=64, fec=fec), _t(pay))
    assert got.shape == (3, jp.burst_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fec", FECS)
def test_decode_packet_equals_jax_at_the_waterfall(fec):
    check_waterfall(_jp(fec), WATERFALL_DB)


@pytest.mark.parametrize("fec", FECS)
def test_decode_packet_equals_jax(fec):
    check_end_to_end(_jp(fec))


@pytest.mark.parametrize("fec", FECS)
def test_packet_block_fec_families(fec):
    """Payload + CRC-32 segmented into LDPC/polar codewords, blind-received
    through delay 17 + t, CFO 1.3 and AWGN at 10 dB: all five decode
    (tests/test_packet.py:174-206, its payloads; the noise E's keyed row,
    seed 50 + t)."""
    pc = packet.PacketConfig(payload_bytes=64, fec=fec)
    rng = np.random.default_rng(3)
    ok_count = 0
    for t in range(5):
        payload = _t(rng.integers(0, 256, (1, 64)).astype(np.uint8))
        ch = ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0, cfo_subcarriers=1.3,
                           timing_offset=17 + t)
        byte_errs, ok = packet.simulate_packets(pc, ch, 50 + t, 1, device="cpu", payload=payload)
        ok_count += int(bool(ok[0]) and int(byte_errs[0]) == 0)
    assert ok_count == 5, ok_count
