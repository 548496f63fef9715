"""The port's tensor-parallel demod (sdr_tpu_torch.parallel.tp) on the CPU.

- Kernel #20's plain version (``kernels.demod.stage2_llr_plain``)
  against the JAX kernel ``_stage2_llr_pallas`` in interpret mode:
  QPSK, 16- and 64-QAM, n1d 1 and 2, h_syms 1 and S, n2 128.
- The port's TP demod on 4 gloo ranks (one spawn for the module, every
  case inside it) against JAX ``make_tp_demod_fn`` on 4 virtual CPU
  devices — the Pallas route at N 1024, CP 128 (n2 256), the jnp route
  at N 256 (n2 64) — two noise variances through one function each;
  and against the port's unsharded ``ops.demod.demod_chain``.
- ``tp_split``, bad shapes and the mesh validation raise as in JAX;
  ``init_multihost`` is a no-op in one process; the digit permutations
  equal JAX's; the meshes of both packages come from one description
  (``interop.mesh_shape_from_reference``).

Tolerance, the JAX package's own (tests/test_tp.py): within 2e-4 of the
peak |LLR| and identical signs (its stage 2 is a bf16x3 Gauss matmul,
the port's an f32 FFT).
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core.config import Modulation as JMod
from sdr_tpu.parallel import init_multihost as j_init_multihost
from sdr_tpu.parallel import make_link_mesh as j_make_link_mesh
from sdr_tpu.parallel import tp as jtp
from sdr_tpu_torch import interop
from sdr_tpu_torch.core.config import Modulation
from sdr_tpu_torch.kernels.demod import stage2_llr_plain
from sdr_tpu_torch.ops.demod import demod_chain
from sdr_tpu_torch.parallel import dryrun, init_multihost, make_link_mesh, make_tp_demod_fn
from sdr_tpu_torch.parallel import distributed, tp

torch.set_num_threads(1)

WORLD = 4
B, S = 2, 4
NVS = (0.05, 0.2)
MOD = Modulation.QAM16
# label → (JAX route, n_fft, cp, h_syms)
TP_CASES = {
    "pallas_n1024": ("pallas", 1024, 128, 1),
    "pallas_n1024_per_symbol_h": ("pallas", 1024, 128, S),
    "jnp_n256": ("jnp", 256, 32, 1),
}
MESH = (WORLD, 1)  # the one description both packages' meshes come from


def _assert_llrs_close(got, want):
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2e-4 * peak, rtol=0)
    assert np.array_equal(got < 0, want < 0)


def _jax_mesh():
    return j_make_link_mesh(*MESH, devices=jax.devices()[:WORLD])


def _inputs(label):
    _, n_fft, cp, h_syms = TP_CASES[label]
    return interop.tp_inputs(len(label), B, S, n_fft, cp, h_syms)


@pytest.fixture(scope="module")
def tp_ranks():
    """Every TP case run once on 4 gloo ranks; label → per-rank results."""
    shape = interop.mesh_shape_from_reference(_jax_mesh())
    cases = [dict(name=label, kind="tp", mesh=shape, planes=_inputs(label), n_fft=n_fft, cp=cp,
                  mod=MOD, noise_vars=list(NVS), return_output=True)
             for label, (_, n_fft, cp, _) in TP_CASES.items()]
    per_rank = dryrun.spawn(WORLD, dryrun.run_cases, ("cpu", cases), timeout=240)
    return {c["name"]: [r[i] for r in per_rank] for i, c in enumerate(cases)}


@functools.lru_cache(maxsize=None)
def _jax_planes(label):
    """JAX ``make_tp_demod_fn`` on 4 CPU devices: ONE function, both noise
    variances as its runtime argument."""
    route, n_fft, cp, _ = TP_CASES[label]
    fn = jtp.make_tp_demod_fn(n_fft, cp, JMod.QAM16, _jax_mesh(), axis="time", backend=route)
    args = tuple(map(jnp.asarray, _inputs(label)))
    return [np.asarray(fn(*args, nv)) for nv in NVS]


@pytest.mark.parametrize("nv_i", range(len(NVS)), ids=[f"nv{nv:g}" for nv in NVS])
@pytest.mark.parametrize("label", list(TP_CASES))
def test_tp_matches_jax_tp_demod(tp_ranks, label, nv_i):
    got = tp_ranks[label][0]["llr"][nv_i]
    _, n_fft, _, _ = TP_CASES[label]
    assert got.shape == (B, S, n_fft * MOD.bits_per_symbol) and got.dtype == np.float32
    _assert_llrs_close(got, _jax_planes(label)[nv_i])


@pytest.mark.parametrize("label", list(TP_CASES))
def test_tp_matches_unsharded_port_and_every_rank_holds_it(tp_ranks, label):
    """Rank 0 held the plane against the unsharded ``demod_chain`` on its
    own inputs; every rank returns the same public-order plane."""
    r0 = tp_ranks[label][0]
    for err, peak, signs in zip(r0["max_err"], r0["peak"], r0["sign_diff"]):
        assert err <= 2e-4 * peak and signs == 0
    re, im, hr, hi = (torch.as_tensor(a) for a in _inputs(label))
    _, _, cp, _ = TP_CASES[label]
    for nv_i, nv in enumerate(NVS):
        _assert_llrs_close(r0["llr"][nv_i], demod_chain(re, im, hr, hi, cp, MOD, nv).numpy())
        for r in tp_ranks[label][1:]:
            np.testing.assert_array_equal(r["llr"][nv_i], r0["llr"][nv_i])


@pytest.mark.parametrize("h_syms", [1, S], ids=["h_per_link", "h_per_symbol"])
@pytest.mark.parametrize("n1d", [1, 2])
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64],
                         ids=lambda m: m.value)
def test_stage2_plain_matches_jax_kernel(rng, mod, n1d, h_syms):
    """Kernel #20's plain version against ``_stage2_llr_pallas``
    (interpret mode): (B, S, n1d, n2·bps) subcarrier-major."""
    n2 = 128
    tr, ti = (rng.standard_normal((B, S, n1d, n2)).astype(np.float32) for _ in range(2))
    hr, hi = (rng.standard_normal((B, h_syms, n1d, n2)).astype(np.float32) for _ in range(2))
    nv = 0.05
    want = np.asarray(jtp._stage2_llr_pallas(*map(jnp.asarray, (tr, ti, hr, hi)),
                                             jnp.float32(nv), JMod(mod.value), True))
    got = stage2_llr_plain(*map(torch.as_tensor, (tr, ti, hr, hi)), torch.tensor(nv), mod)
    assert got.shape == (B, S, n1d, n2 * mod.bits_per_symbol)
    _assert_llrs_close(got.numpy(), want)


def test_tp_split_validation():
    for bad in ((32, 8), (100, 4)):
        with pytest.raises(ValueError):
            jtp.tp_split(*bad)
        with pytest.raises(ValueError, match="n_dev\\^2 \\| n_fft"):
            tp.tp_split(*bad)
    for n_fft, n_dev in ((1024, 8), (4096, 8), (4096, 4), (256, 1)):
        assert tp.tp_split(n_fft, n_dev) == jtp.tp_split(n_fft, n_dev)


def test_digit_permutations_match_jax(rng):
    n1, n2, bps = 4, 64, MOD.bits_per_symbol
    h = rng.standard_normal((2, 3, n1 * n2)).astype(np.float32)
    np.testing.assert_array_equal(tp.digit_permute_h(torch.as_tensor(h), n1, n2).numpy(),
                                  np.asarray(jtp.digit_permute_h(jnp.asarray(h), n1, n2)))
    llr4 = rng.standard_normal((2, 3, n1, n2 * bps)).astype(np.float32)
    np.testing.assert_array_equal(
        tp.digit_restore_llrs(torch.as_tensor(llr4), MOD).numpy(),
        np.asarray(jtp.digit_restore_llrs(jnp.asarray(llr4), JMod.QAM16)))
    for n1_, n2_ in ((4, 256), (2, 8)):
        for a, b in zip(tp._twiddle_np(n1_, n2_), jtp._twiddle_np(n1_, n2_)):
            np.testing.assert_array_equal(a, b)


def test_tp_rejects_bad_shapes():
    """One process: the mesh is 1 × 1 and the transform is not split."""
    fn = make_tp_demod_fn(1024, 128, Modulation.QPSK, make_link_mesh(), device="cpu")
    re, im, hr, hi = interop.tp_inputs(2, 2, 4, 1024, 64, 1)
    with pytest.raises(ValueError, match="sym_len"):
        fn(re, im, hr, hi, 0.1)  # the CP does not match
    re, im, hr, hi = interop.tp_inputs(2, 2, 4, 1024, 128, 2)
    with pytest.raises(ValueError, match="channel shape"):
        fn(re, im, hr, hi, 0.1)  # h_syms neither 1 nor S
    with pytest.raises(TypeError, match="LinkMesh"):
        make_tp_demod_fn(1024, 128, Modulation.QPSK, 0.1, device="cpu")


def test_tp_one_process_noise_var_at_run_time(rng):
    """One function, the noise variance as a float or a 0-d tensor, equal
    to the unsharded chain (a 1 × 1 mesh: n1 = 1, the whole transform in
    the stage-2 mode)."""
    fn = make_tp_demod_fn(256, 32, MOD, make_link_mesh(), device="cpu")
    re, im, hr, hi = map(torch.as_tensor, interop.tp_inputs(5, 2, 4, 256, 32, 4))
    for nv in NVS:
        got = fn(re, im, hr, hi, nv)
        np.testing.assert_array_equal(fn(re, im, hr, hi, torch.tensor(nv)).numpy(), got.numpy())
        _assert_llrs_close(got.numpy(), demod_chain(re, im, hr, hi, 32, MOD, nv).numpy())


def test_mesh_validation_raises_as_in_jax():
    with pytest.raises(ValueError, match="mesh 4x1 != 8 devices"):
        j_make_link_mesh(4, 1)
    with pytest.raises(ValueError, match="mesh 4x1 != 1 devices"):
        make_link_mesh(4, 1)
    mesh = make_link_mesh()
    assert (mesh.n_time, mesh.n_channel, mesh.size) == (1, 1, 1)
    assert mesh.coord("time") == mesh.coord("channel") == 0
    with pytest.raises(ValueError, match="axis"):
        mesh.coord("space")


def test_mesh_shape_from_reference():
    for desc in ((4, 1), (2, 2), (1, 4), (2, 4)):
        jmesh = j_make_link_mesh(*desc, devices=jax.devices()[:desc[0] * desc[1]])
        assert interop.mesh_shape_from_reference(jmesh) == desc


def test_init_multihost_is_a_no_op_in_one_process():
    got = init_multihost()
    want = j_init_multihost()
    assert set(got) == set(want)
    assert got == dict(process_index=0, process_count=1, local_devices=1, global_devices=1)
    with pytest.raises(ValueError, match="backend"):
        init_multihost(world_size=2, rank=0)
    with pytest.raises(ValueError, match="backend must be"):
        init_multihost("mpi", world_size=1, rank=0)


@pytest.mark.parametrize("env, local_rank, rank, world, cards, want", [
    ({"LOCAL_RANK": "2"}, None, 6, 8, 4, 2),  # torchrun across hosts
    ({"LOCAL_RANK": "3", "RANK": "1", "WORLD_SIZE": "4"}, None, None, None, 4, 3),  # env://
    ({"LOCAL_RANK": "3"}, 1, 5, 8, 4, 1),  # an explicit local rank wins
    ({}, None, 3, 4, 4, 3),  # one host, one card per rank
    ({"RANK": "1", "WORLD_SIZE": "2"}, None, None, None, 2, 1),
    ({}, None, 5, 8, 4, "local rank"),  # across hosts, nothing names the card
    ({"LOCAL_RANK": "1"}, None, 1, 2, 1, "share a card"),  # two ranks, one card
    ({}, None, 1, 2, 1, "local rank"),
])
def test_nccl_card_selection(monkeypatch, env, local_rank, rank, world, cards, want):
    for key in ("LOCAL_RANK", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            distributed._select_card(local_rank, rank, world)
        assert picked == []
    else:
        distributed._select_card(local_rank, rank, world)
        assert picked == [want]


def test_tp_entry_point_defaults_to_the_card():
    assert inspect.signature(make_tp_demod_fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_tp_demod_fn(256, 32, MOD, make_link_mesh())
