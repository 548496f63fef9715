"""The work model against hand counts (the kernel table's bounds at
config 2's 8192 × 64 and G's config-3 pass)."""

import pytest

from linkbench.harness import workmodel as wm


def _ms(work):
    return wm.bound_ms(work)


def test_tx_noise_multiplies_and_bytes_config2():
    w = wm.tx(8192, 64, 256, 64, 4, gains=True)
    assert _ms(wm.Work(imul=w.imul)) == pytest.approx(0.4012, abs=1e-4)
    assert w.bytes / wm.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.4407, abs=1e-4)
    assert _ms(w) == pytest.approx(0.4407, abs=1e-4)  # bound by its bytes


def test_demod_count_config2():
    assert _ms(wm.demod_count(8192, 64, 256, 4)) == pytest.approx(0.3656, abs=1e-4)


def test_mc_pass_config3():
    assert _ms(wm.mc_pass(2048, 64, 1024, 6)) == pytest.approx(0.4012, abs=1e-4)


def test_ldpc_decode_bound():
    # 8192 channels × 21 codewords of n 3072, 25 iterations: 4.8477 ms of
    # operations with the stock rate-1/2 graph's lifted edges (59 · 128).
    w = wm.ldpc_decode(8192 * 21, 3072, 59 * 128, 25)
    assert _ms(w) == pytest.approx(4.8477, rel=2e-3)


def test_fft_and_tail():
    assert wm.fft_flops(256) == 5 * 256 * 8
    assert wm.tail_flops(4) == 12 + 2 * (3 * 4 + 2 * 2)
    assert wm.tail_flops(6) == 12 + 2 * 12 * 3


def test_link_counts_only_the_kept_samples():
    w = wm.link(8192, 64, 256, 4)
    rows = 8192 * 64
    assert w.imul == (rows * 256 / 4 + rows * 256) * wm.PHILOX_IMUL
    assert w.bytes == 8 * 8192
    # The least time is the draws' multiplies: 0.4012 ms a call.
    assert _ms(w) == pytest.approx(0.4012, abs=1e-4)


def test_work_adds_and_scales():
    a = wm.Work(1, 2, 3)
    assert a + a == a * 2 == wm.Work(2, 4, 6)
