"""The FFT backend switch (``sdr_tpu_torch.ops.fft``), the matmul DFT
(``ops.fft_matmul``) and the crossover tuner (``obs.autotune.tune_fft``,
``recommend_crossover``) against the JAX package's ``sdr_tpu.ops.fft``,
``kernels/fft_matmul.py`` and ``obs/autotune.py``, and numpy, on the CPU.

Tolerance (stated before the comparisons): ``tests/test_fft.py``'s
``assert_ref_float_close`` — per component abs 1e-5 times the data's
magnitude (√n for a forward transform of unit samples, 1 for the inverse
and for round trips) or rel 1e-6, the reference's float tolerance.
``"auto"`` at the default crossover is torch's FFT exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.kernels.fft_matmul import matmul_fft as j_matmul_fft
from sdr_tpu.obs.autotune import TunePoint as JTunePoint
from sdr_tpu.obs.autotune import recommend_crossover as j_recommend_crossover
from sdr_tpu.ops.fft import fft as jfft, ifft as jifft
from sdr_tpu.ops.ofdm import ofdm_rx as j_ofdm_rx, ofdm_tx as j_ofdm_tx
from sdr_tpu_torch.obs import autotune
from sdr_tpu_torch.ops import fft as F
from sdr_tpu_torch.ops.fft_matmul import matmul_fft
from sdr_tpu_torch.ops.ofdm import ofdm_rx, ofdm_tx
from tests.test_fft import assert_ref_float_close

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_backend():
    """Each test leaves the module's default backend and crossover as it
    found them, so no other test on the worker sees a change."""
    saved = (F.get_default_backend(), F._MATMUL_MIN_N)
    yield
    F.set_default_backend(saved[0])
    F.set_matmul_min_n(saved[1])


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [1, 2, 64, 128, 512, 8192])
def test_matmul_fft_matches_jax_and_numpy(rng, n, inverse):
    """n ≤ 128 a direct DFT product, 512 one four-step split, 8192 a
    recursive one; batched (3, 2, n) for the small sizes."""
    x = _cplx(rng, (2, n) if n == 8192 else (3, 2, n))
    mag = 1.0 if inverse else np.sqrt(n)
    want = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128), axis=-1)
    got = matmul_fft(torch.from_numpy(x), inverse=inverse).numpy()
    assert got.shape == x.shape and got.dtype == np.complex64
    assert_ref_float_close(got, want, magnitude=mag)
    assert_ref_float_close(got, np.asarray(j_matmul_fft(jnp.asarray(x), inverse=inverse)),
                           magnitude=mag)
    op, jop = (F.ifft, jifft) if inverse else (F.fft, jfft)
    via = op(torch.from_numpy(x), backend="matmul").numpy()
    np.testing.assert_array_equal(via, got)
    assert_ref_float_close(via, np.asarray(jop(jnp.asarray(x), backend="matmul")), magnitude=mag)


def test_matmul_round_trip_and_impulse(rng):
    """ifft(fft(x)) ≈ x through the matmul backend; an impulse's
    transform is all ones (tests/test_fft.py's checks)."""
    x = _cplx(rng, (4, 1024))
    t = torch.from_numpy(x)
    assert_ref_float_close(F.ifft(F.fft(t, backend="matmul"), backend="matmul").numpy(), x)
    imp = torch.zeros(64, dtype=torch.complex64)
    imp[0] = 1.0
    assert_ref_float_close(F.fft(imp, backend="matmul").numpy(), np.ones(64, np.complex64))


@pytest.mark.parametrize("n", [3, 100])
def test_non_power_of_two_rejected_by_every_backend(n):
    x = torch.zeros((2, n), dtype=torch.complex64)
    for backend in ("auto", "xla", "matmul"):
        with pytest.raises(ValueError, match="power"):
            F.fft(x, backend=backend)
        with pytest.raises(ValueError, match="power"):
            F.ifft(x, backend=backend)


def test_auto_is_torch_fft_until_a_crossover_is_set(rng):
    """By default "auto" is torch's FFT bit for bit at every N (no TPU
    crossover carried over); set_matmul_min_n(256) routes N ≥ 256 to the
    matmul DFT and leaves N < 256 on torch's FFT."""
    assert F.get_default_backend() == "auto" and F._MATMUL_MIN_N == F.NEVER
    xs = {n: torch.from_numpy(_cplx(rng, (2, n))) for n in (64, 128, 256, 1024, 8192)}
    for x in xs.values():
        assert torch.equal(F.fft(x), torch.fft.fft(x, dim=-1))
        assert torch.equal(F.ifft(x), torch.fft.ifft(x, dim=-1))
    F.set_matmul_min_n(256)
    for n, x in xs.items():
        want = matmul_fft(x) if n >= 256 else torch.fft.fft(x, dim=-1)
        assert torch.equal(F.fft(x), want)
        assert torch.equal(F.fft(x, backend="xla"), torch.fft.fft(x, dim=-1))
    F.set_default_backend("matmul")
    assert F.get_default_backend() == "matmul"
    assert torch.equal(F.ifft(xs[64]), matmul_fft(xs[64], inverse=True))


def test_set_default_backend_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown FFT backend"):
        F.set_default_backend("bogus")
    assert F.get_default_backend() == "auto"
    with pytest.raises(ValueError, match="unknown FFT backend"):
        F.fft(torch.zeros(8, dtype=torch.complex64), backend="bogus")


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_ofdm_backend_matches_jax(rng, backend):
    """ofdm_tx / ofdm_rx hand ``backend=`` to the transform, as JAX's."""
    n, cp = 256, 32
    x = _cplx(rng, (3, 2, n))
    got = ofdm_tx(torch.from_numpy(x), cp, backend=backend).numpy()
    ref = np.asarray(j_ofdm_tx(jnp.asarray(x), cp, backend=backend))
    assert got.shape == (3, 2, n + cp)
    assert_ref_float_close(got, ref)
    back = ofdm_rx(torch.from_numpy(ref.copy()), cp, backend=backend).numpy()
    assert_ref_float_close(back, np.asarray(j_ofdm_rx(jnp.asarray(ref), cp, backend=backend)),
                           magnitude=np.sqrt(n))
    assert_ref_float_close(back, x, magnitude=np.sqrt(n))


@pytest.mark.parametrize("planted", [
    [(128, 5.0, 1.0), (256, 5.0, 2.0), (512, 1.0, 2.0), (1024, 1.0, 3.0)],
    [(128, 1.0, 2.0), (256, 3.0, 2.0), (512, 1.0, 2.0)],
    [(128, 5.0, 1.0), (4096, 3.0, 1.0)],
    [(1024, 1.0, 3.0), (128, 1.0, 3.0)],
    [(64, 2.0, 2.0)],
], ids=["cross_at_512", "last_only", "never", "always", "tie"])
def test_recommend_crossover_matches_jax(planted):
    """On planted points: the same crossover as JAX (``NEVER`` where
    matmul wins at the largest size not at all; a tie goes to xla)."""
    got = autotune.recommend_crossover([autotune.TunePoint(*p) for p in planted])
    assert got == j_recommend_crossover([JTunePoint(*p) for p in planted])
    assert [autotune.TunePoint(*p).winner for p in planted] == \
        [JTunePoint(*p).winner for p in planted]


def test_tune_fft_on_the_cpu_returns_a_point_per_size():
    pts = autotune.tune_fft(sizes=(64, 128), batch_elems=1 << 12, iters=1, reps=1, device="cpu")
    assert [p.n for p in pts] == [64, 128]
    assert all(p.xla_gelems > 0 and p.matmul_gelems > 0 for p in pts)
    assert autotune.recommend_crossover(pts) in (64, 128, F.NEVER)
