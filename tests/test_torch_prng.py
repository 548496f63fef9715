"""Keyed Philox randomness of the port (sdr_tpu_torch.core.prng)."""

import numpy as np
import pytest
import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.kernels.payload import payload_idx, payload_idx_plain

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "ctr,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox-4x32-10 known-answer vectors."""
    out = prng.philox4x32(*(torch.tensor(c) for c in ctr), *key)
    assert tuple(int(o) for o in out) == want


def test_philox_broadcasts_and_stays_uint32():
    w = prng.keyed_words(2**40 + 7, prng.ROLE_NOISE, torch.arange(5, dtype=torch.int32), (3, 4))
    for x in w:
        assert x.shape == (5, 3, 4) and x.dtype == torch.int64
        assert int(x.min()) >= 0 and int(x.max()) < 2**32
    # The 64-bit seed's high half is in the key.
    w2 = prng.keyed_words(7, prng.ROLE_NOISE, torch.arange(5, dtype=torch.int32), (3, 4))
    assert not torch.equal(w[0], w2[0])


@pytest.mark.parametrize("bps", [1, 2, 4, 6, 7, 8, 10])
def test_payload_dtype_and_range(bps):
    idx = payload_idx(4, 32, bps, 11, torch.arange(6, dtype=torch.int32))
    assert idx.shape == (6, 4, 32)
    assert idx.dtype == (torch.int8 if bps <= 7 else torch.int16)
    assert int(idx.min()) >= 0 and int(idx.max()) <= (1 << bps) - 1
    m = 1 << bps
    assert abs(float(idx.float().mean()) - (m - 1) / 2) < 0.1 * m


def test_payload_split_equals_full():
    """Any slice of channels reproduces the full draw bit for bit (no
    128-block rule)."""
    ids = torch.arange(300, dtype=torch.int32)
    full = payload_idx(8, 64, 4, 1234, ids)
    for lo, hi in ((0, 128), (128, 300), (37, 41)):
        torch.testing.assert_close(payload_idx(8, 64, 4, 1234, ids[lo:hi]), full[lo:hi],
                                   rtol=0, atol=0)
    # Non-contiguous global ids: the draw follows the id, not the row.
    perm = torch.tensor([299, 3, 150], dtype=torch.int32)
    torch.testing.assert_close(payload_idx_plain(8, 64, 4, 1234, perm), full[perm.long()],
                               rtol=0, atol=0)


def test_roles_and_seeds_give_independent_streams():
    ids = torch.arange(64, dtype=torch.int32)
    a = prng.keyed_words(5, prng.ROLE_PAYLOAD, ids, (4, 16))[0]
    b = prng.keyed_words(5, prng.ROLE_NOISE, ids, (4, 16))[0]
    c = prng.keyed_words(6, prng.ROLE_PAYLOAD, ids, (4, 16))[0]
    for x, y in ((a, b), (a, c)):
        assert float((x == y).float().mean()) < 1e-3


def test_uniform_in_half_open_unit_interval():
    """(0, 1]: log() never sees 0 (the top word rounds to exactly 1)."""
    u = prng.uniform_01(torch.tensor([0, 1, 255, 256, 2**32 - 1], dtype=torch.int64))
    assert u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) == 1.0
    assert float(u[0]) == 2.0 ** -25


def test_box_muller_moments():
    ids = torch.arange(512, dtype=torch.int32)
    g1, g2 = prng.normal_pair(3, prng.ROLE_NOISE, ids, (16, 128))
    n = g1.numel()
    for g in (g1, g2):
        assert abs(float(g.mean())) < 5 / np.sqrt(n)
        assert abs(float(g.var()) - 1.0) < 0.01
        assert abs(float((g ** 4).mean()) - 3.0) < 0.05  # Gaussian kurtosis
        assert float(g.abs().max()) < 6.5
    assert abs(float((g1 * g2).mean())) < 5 / np.sqrt(n)
