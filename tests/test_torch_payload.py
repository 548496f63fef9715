"""Kernel A's payload layout (sdr_tpu_torch.kernels.payload): four symbol
indices per keyed Philox call, word n mod 4 of counter (channel, s, n div 4,
0), held word by word against ``prng.keyed_words``."""

import pytest
import torch

from sdr_tpu_torch.core import prng
from sdr_tpu_torch.kernels.payload import out_dtype, payload_idx, payload_idx_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("bps", [1, 4, 7, 8, 10])
@pytest.mark.parametrize("N", [4, 6, 64, 256])
def test_payload_takes_all_four_words_of_each_call(N, bps):
    """idx[b, s, n] is word n mod 4 of the call at counter (ch_ids[b], s,
    n div 4, 0), masked to bps bits; N = 6 drops the last call's two extra
    words."""
    S, seed = 3, 2**35 + 19
    ids = torch.tensor([0, 7, 4096, 2**31 - 1], dtype=torch.int32)
    got = payload_idx_plain(S, N, bps, seed, ids)
    assert got.shape == (4, S, N) and got.dtype == out_dtype(bps)
    words = prng.keyed_words(seed, prng.ROLE_PAYLOAD, ids, (S, -(-N // 4)))
    mask = (1 << bps) - 1
    for n in range(N):
        want = words[n % 4][:, :, n // 4] & mask
        assert torch.equal(got[:, :, n].to(torch.int64), want), n
    assert torch.equal(payload_idx(S, N, bps, seed, ids), got)
