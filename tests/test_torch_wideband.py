"""The wideband link (BASELINE configs 3 and 5) against the JAX package.

At N = 1024 and 4096 the JAX package runs its four-step kernels (the TX
``tx_chain_fourstep2`` / ``tx_chain_fourstep``, the demod
``demod_chain_fourstep2`` with its SC-FDE form, on float32 and on
bfloat16 sample planes, and ``demod_chain_fourstep``), the post-FFT LLR
kernel ``llr_chain_pallas`` behind ``demod_chain_hybrid``, and the channels-last kernels (through
their jnp twin ``demod_cl_jnp``, which has the kernels' math and no
interpret lowering of its own). The port serves all of them with kernels
B, C (with its post-FFT mode ``llr_chain``), D and F; here their plain
versions, which the CUDA kernels are held against on the card, meet the
JAX functions on the same numpy inputs.

Shapes: B = 2 channels × S = 4 symbols (B·S a multiple of 8, as the
four-step gates need); config 3 (64-QAM, N 1024, CP 128) and config 5's
shape (16-QAM, N 4096, CP 512), MULTIPATH with config 5's 5-tap profile.
Each JAX reference is computed once per configuration (``_reference``),
with the four-step stage and the DFT matmuls in float32
(``SDR_TPU_FOURSTEP_STAGE=f32``, ``SDR_TPU_MXU_PRECISION=highest``; the
bf16 default stage is a TPU speed choice, not the contract). An
interpret-mode call costs seconds, so the forms that repeat a held
function's math are held at one N: the single-kernel four-step TX and
demod (which compute what the split forms, held at both N, compute) at
config 3, and the SC-FDE sum (whose per-tone work the SC-FDE count holds
at both N) at config 5.

Tolerances (stated before the comparisons):
- sample planes abs 2e-5 (tests/test_torch_fast.py);
- LLR planes within 1e-4 of the plane's peak |LLR|;
- LLR sums rel 1e-5, on noise-like inputs whose sum does not cancel
  (bench.py's synthetic form);
- error counts equal, but for bits whose plain |LLR| < 1e-3 (decisions
  that float rounding may flip).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.core import config as jcfg
from sdr_tpu.kernels.channel_pallas import fade_awgn_pallas
from sdr_tpu.kernels.demod_cl_pallas import demod_cl_jnp, dif_perm as j_dif_perm
from sdr_tpu.kernels.fourstep_pallas import demod_chain_fourstep
from sdr_tpu.kernels.fourstep_split_pallas import (
    demod_chain_fourstep2,
    demod_chain_fourstep2_fde,
)
from sdr_tpu.kernels.fourstep_tx_pallas import tx_chain_fourstep
from sdr_tpu.kernels.fourstep_tx_split_pallas import tx_chain_fourstep2
from sdr_tpu.kernels.llr_pallas import llr_chain_pallas
from sdr_tpu.ops import channel as jchan
from sdr_tpu.ops.demod import demod_chain_hybrid as j_demod_chain_hybrid
from sdr_tpu.ops.ofdm import ofdm_rx as j_ofdm_rx
from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu_torch.kernels import demod as kc
from sdr_tpu_torch.kernels import demod_cl as kd
from sdr_tpu_torch.kernels import tx as kb
from sdr_tpu_torch.link import fast
from sdr_tpu_torch.ops.demod import demod_chain_hybrid, demod_llr_chain_cl

torch.set_num_threads(1)

B, S = 2, 4
PDP5 = (1.0, 0.6, 0.3, 0.1, 0.05)  # config 5's power-delay profile
SAMPLE_ATOL = 2e-5
CONFIGS = {
    "config3": (Modulation.QAM64, 1024, 128, 12.0),
    "config5": (Modulation.QAM16, 4096, 512, 14.0),
}


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _np(x):
    return np.array(x)


def _jax_channel(x, gains, tvar, noise):
    """The JAX engine's channel stage: ``fade_awgn_pallas`` with injected
    noise, y = g·x + sqrt(tvar/2)·n. The kernel is elementwise with one
    gain per row and takes rows in blocks of 128, so the (B, S, L) planes
    go in as 128 rows of B·S·L/128 samples, each row with its channel's
    gain."""
    shape = x.shape
    rows = 128
    cols = int(np.prod(shape)) // rows
    flat = lambda a: jnp.asarray(np.asarray(a, np.float32).reshape(rows, 1, cols))  # noqa: E731
    g = None
    if gains is not None:
        g = np.repeat(gains, rows // shape[0])[:, None]
        g = (jnp.asarray(np.real(g).astype(np.float32)), jnp.asarray(np.imag(g).astype(np.float32)))
    re, im = fade_awgn_pallas(flat(np.real(x)), flat(np.imag(x)), *(g or (None, None)), 0, tvar,
                              noise=(flat(noise[0]), flat(noise[1])), interpret=True)
    return _np(re).reshape(shape), _np(im).reshape(shape)


def _cl(a):
    """(B, S, L) → channels-last (S·L, B)."""
    return np.ascontiguousarray(a.transpose(1, 2, 0).reshape(-1, a.shape[0]))


def _cfg(mod, n_fft, cp, ebno, **kw):
    return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
                      channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=ebno,
                                            pdp=PDP5),
                      n_symbols=S, n_channels=B, **kw)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """One configuration's inputs and every JAX reference on them."""
    mod, N, cp, ebno = CONFIGS[name]
    jm = jcfg.Modulation(mod.value)
    bps = mod.bits_per_symbol
    rng = np.random.default_rng(0x51DE + N)
    L = N + cp
    cplx = lambda *sh: ((rng.standard_normal(sh) + 1j * rng.standard_normal(sh))  # noqa: E731
                        / np.sqrt(2)).astype(np.complex64)
    idx = rng.integers(0, 1 << bps, (B, S, N)).astype(np.int32)
    gains = cplx(B)
    taps = (cplx(B, len(PDP5)) * np.sqrt(np.asarray(PDP5) / sum(PDP5))).astype(np.complex64)
    noise = tuple(rng.standard_normal((B, S, L)).astype(np.float32) for _ in range(2))
    nv = 1.0 / (10 ** (ebno / 10) * bps)
    tvar = nv / N
    # bench.py's noise-like inputs, for the sums.
    bench = ((rng.standard_normal((B, S, L)) / np.sqrt(2 * N)).astype(np.float32),
             (rng.standard_normal((B, S, L)) / np.sqrt(2 * N)).astype(np.float32),
             (rng.standard_normal((B, 1, N)) * np.sqrt(0.5)).astype(np.float32),
             (rng.standard_normal((B, 1, N)) * np.sqrt(0.5)).astype(np.float32))
    cfg = _cfg(mod, N, cp, ebno)
    sc = fast.scfdma_tx(dataclasses.replace(cfg, dft_spread=True), torch.from_numpy(idx))
    sc = sc[0].numpy() + 1j * sc[1].numpy()
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDR_TPU_MXU_PRECISION", "highest")
        mp.setenv("SDR_TPU_FOURSTEP_STAGE", "f32")
        jidx = jnp.asarray(idx)
        ref["tx2"] = tuple(map(_np, tx_chain_fourstep2(jidx, cp, jm, interpret=True)))
        if name == "config3":
            ref["tx1"] = tuple(map(_np, tx_chain_fourstep(jidx, cp, jm, interpret=True)))
        x = ref["tx2"][0] + 1j * ref["tx2"][1]
        ref["flat"] = _jax_channel(x, gains, tvar, noise)
        mp_x = jchan.apply_multipath(jnp.asarray(x.reshape(B, -1)), jnp.asarray(taps))
        ref["multipath"] = _jax_channel(_np(mp_x).reshape(B, S, L), None, tvar, noise)
        sc_x = jchan.apply_multipath(jnp.asarray(sc.reshape(B, -1)), jnp.asarray(taps))
        ref["scfdma"] = _jax_channel(_np(sc_x).reshape(B, S, L), None, tvar, noise)
        h = _np(jchan.freq_response(jnp.asarray(taps), N))[:, None, :]
        hr, hi = np.real(h).astype(np.float32), np.imag(h).astype(np.float32)
        wave = tuple(map(jnp.asarray, (*ref["multipath"], hr, hi)))
        noisy = tuple(map(jnp.asarray, bench))
        sc_args = tuple(map(jnp.asarray, (*ref["scfdma"], hr, hi)))
        ref["d2_plane"] = _np(demod_chain_fourstep2(*wave, cp, jm, nv, interpret=True))
        ref["d2_count"] = _np(demod_chain_fourstep2(*wave, cp, jm, nv, interpret=True,
                                                    count_idx=jidx))
        ref["d2_sum"] = float(demod_chain_fourstep2(*noisy, cp, jm, nv, reduce_sum=True,
                                                    interpret=True))
        if name == "config3":
            ref["d1_plane"] = _np(demod_chain_fourstep(*wave, cp, jm, nv, interpret=True))
            ref["d1_sum"] = float(demod_chain_fourstep(*noisy, cp, jm, nv, reduce_sum=True,
                                                       interpret=True))
        ref["fde_count"] = _np(demod_chain_fourstep2_fde(*sc_args, cp, jm, nv, interpret=True,
                                                         count_idx=jidx))
        # The same on the sample planes rounded to bf16 (the kernels' bf16
        # mode: stage 1 widens them in registers).
        bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        b_wave = (bf(ref["multipath"][0]), bf(ref["multipath"][1]), wave[2], wave[3])
        ref["d2_plane_bf16"] = _np(demod_chain_fourstep2(*b_wave, cp, jm, nv, interpret=True))
        ref["d2_count_bf16"] = _np(demod_chain_fourstep2(*b_wave, cp, jm, nv, interpret=True,
                                                         count_idx=jidx))
        ref["fde_count_bf16"] = _np(demod_chain_fourstep2_fde(
            bf(ref["scfdma"][0]), bf(ref["scfdma"][1]), *sc_args[2:], cp, jm, nv,
            interpret=True, count_idx=jidx))
        if name == "config5":
            ref["fde_sum"] = float(demod_chain_fourstep2_fde(*noisy, cp, jm, nv, reduce_sum=True,
                                                             interpret=True))
        # The post-FFT grids the hybrid route hands to llr_chain_pallas.
        yf = j_ofdm_rx(jnp.asarray(ref["multipath"][0] + 1j * ref["multipath"][1]), cp)
        bf = j_ofdm_rx(jnp.asarray(bench[0] + 1j * bench[1]), cp)
        grids = {"wave": (_np(jnp.real(yf)), _np(jnp.imag(yf))),
                 "bench": (_np(jnp.real(bf)), _np(jnp.imag(bf)))}
        ref["llr_plane"] = _np(llr_chain_pallas(*map(jnp.asarray, grids["wave"]), wave[2],
                                                wave[3], jm, nv, interpret=True))
        ref["llr_sum"] = float(llr_chain_pallas(*map(jnp.asarray, grids["bench"]), noisy[2],
                                                noisy[3], jm, nv, reduce_sum=True,
                                                interpret=True))
        ref["hybrid_plane"] = _np(j_demod_chain_hybrid(*wave, cp, jm, nv))
        ref["hybrid_sum"] = float(j_demod_chain_hybrid(*noisy, cp, jm, nv, reduce_sum=True))
        # The channels-last twin on the same grids laid out (S·L, B).
        cl_wave = tuple(map(jnp.asarray, (_cl(ref["multipath"][0]), _cl(ref["multipath"][1]),
                                          hr[:, 0, :].T, hi[:, 0, :].T)))
        cl_bench = tuple(map(jnp.asarray, (_cl(bench[0]), _cl(bench[1]), bench[2][:, 0, :].T,
                                           bench[3][:, 0, :].T)))
        idx_t = np.ascontiguousarray(idx.transpose(1, 2, 0).reshape(S * N, B))
        ref["cl_count"] = _np(demod_cl_jnp(*cl_wave, cp, jm, nv, out_mode="count",
                                           idx_t=jnp.asarray(idx_t)))
        ref["cl_llr"] = _np(demod_cl_jnp(*cl_wave, cp, jm, nv, out_mode="llr"))
        ref["cl_sum"] = float(demod_cl_jnp(*cl_bench, cp, jm, nv, out_mode="sum"))
    return dict(name=name, mod=mod, N=N, cp=cp, nv=nv, tvar=tvar, idx=idx,
                gains=gains, taps=taps, noise=noise, bench=bench, hr=hr, hi=hi, grids=grids,
                idx_t=idx_t, cfg=cfg, ref=ref)


@pytest.fixture(scope="module", params=list(CONFIGS))
def wide(request):
    return _reference(request.param)


@pytest.fixture(scope="module")
def wide3():
    return _reference("config3")


@pytest.fixture(scope="module")
def wide5():
    return _reference("config5")


def _assert_planes_close(got, ref):
    """LLR planes within 1e-4 of the plane's peak |LLR|."""
    ref = np.asarray(ref)
    peak = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got, np.float32) - ref).max())
    assert err <= 1e-4 * peak, (err, peak)


def _assert_sums_close(got, ref):
    assert abs(float(got) - ref) <= 1e-5 * abs(ref), (float(got), ref)


def _assert_counts_agree(got, ref, llr):
    """Equal, but for the bits whose plain |LLR| < 1e-3."""
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2)).numpy()
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert (diff <= margin).all(), (got, ref, margin)


def _wave(w):
    return _t(*w["ref"]["multipath"], w["hr"], w["hi"])


def _check_tx_off(w, key):
    re, im = kb.tx_chain(*_t(w["idx"]), w["cp"], w["mod"])
    jre, jim = w["ref"][key]
    assert re.shape == (B, S, w["N"] + w["cp"])
    np.testing.assert_allclose(re.numpy(), jre, atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), jim, atol=SAMPLE_ATOL, rtol=0)


def test_tx_channel_off_matches_jax_fourstep2(wide):
    """Kernel B with the channel off (plain version) against the split
    wideband TX kernel: the same waveform within 2e-5."""
    _check_tx_off(wide, "tx2")


def test_tx_channel_off_matches_jax_fourstep_single_kernel(wide3):
    """As above, against the single-kernel four-step TX (config 3)."""
    _check_tx_off(wide3, "tx1")


@pytest.mark.parametrize("channel", ["flat", "multipath"])
def test_tx_channel_on_matches_jax_fourstep_then_channel(wide, channel):
    """Kernel B with the channel on (plain version, injected noise):
    flat per-link gains, or the 5-tap FIR over each channel's stream,
    against tx_chain_fourstep2 → the JAX channel stage (apply_multipath,
    then fade_awgn_pallas with the same noise)."""
    w = wide
    kw = dict(noise_var=w["tvar"], noise=_t(*w["noise"]))
    if channel == "flat":
        kw.update(hs_r=torch.from_numpy(np.real(w["gains"]).copy()),
                  hs_i=torch.from_numpy(np.imag(w["gains"]).copy()))
    else:
        kw.update(taps_r=torch.from_numpy(np.real(w["taps"]).copy()),
                  taps_i=torch.from_numpy(np.imag(w["taps"]).copy()))
    re, im = kb.tx_channel(*_t(w["idx"]), w["cp"], w["mod"], **kw)
    jre, jim = w["ref"][channel]
    np.testing.assert_allclose(re.numpy(), jre, atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), jim, atol=SAMPLE_ATOL, rtol=0)


def _check_plane_and_sum(w, key):
    plane = kc.demod_llr(*_wave(w), w["cp"], w["mod"], w["nv"])
    assert plane.shape == (B, S, w["N"] * w["mod"].bits_per_symbol)
    _assert_planes_close(plane.numpy(), w["ref"][f"{key}_plane"])
    total = kc.demod_llr(*_t(*w["bench"]), w["cp"], w["mod"], w["nv"], reduce_sum=True)
    assert total.ndim == 0
    _assert_sums_close(total, w["ref"][f"{key}_sum"])


def test_demod_plane_and_sum_match_jax_fourstep2(wide):
    """Kernel C's LLR-plane and sum modes (plain version) against the
    split four-step demod."""
    _check_plane_and_sum(wide, "d2")


def test_demod_plane_and_sum_match_jax_fourstep_single_kernel(wide3):
    """As above, against the single-kernel four-step demod (config 3)."""
    _check_plane_and_sum(wide3, "d1")


def test_demod_count_matches_jax_fourstep2(wide):
    """Kernel C's count (plain version) against demod_chain_fourstep2's
    in-kernel count (count_idx=)."""
    w = wide
    got = kc.demod_count(*_wave(w), *_t(w["idx"]), w["cp"], w["mod"], w["nv"])
    assert got.dtype == torch.int32 and int(got.sum()) > 0
    _assert_counts_agree(got, w["ref"]["d2_count"],
                         kc.demod_chain(*_wave(w), w["cp"], w["mod"], w["nv"]))


def test_demod_despread_count_matches_jax_fourstep2_fde(wide):
    """Kernel C's despread count (plain version) against the three-phase
    wideband SC-FDE kernel, on an SC-FDMA waveform through the same
    channel."""
    w = wide
    sc = _t(*w["ref"]["scfdma"], w["hr"], w["hi"])
    got = kc.demod_count(*sc, *_t(w["idx"]), w["cp"], w["mod"], w["nv"], despread=True)
    assert int(got.sum()) > 0
    _assert_counts_agree(got, w["ref"]["fde_count"],
                         kc.demod_chain(*sc, w["cp"], w["mod"], w["nv"], despread=True))


def test_demod_despread_sum_matches_jax_fourstep2_fde(wide5):
    """Kernel C's despread sum (plain version) against the SC-FDE
    kernel's sum on noise-like inputs (config 5's shape)."""
    w = wide5
    total = kc.demod_llr(*_t(*w["bench"]), w["cp"], w["mod"], w["nv"], reduce_sum=True,
                         despread=True)
    _assert_sums_close(total, w["ref"]["fde_sum"])


def _bf16_planes(w, key):
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in w["ref"][key])


def test_demod_on_bf16_matches_jax_fourstep2(wide):
    """Kernel C's plane and count (plain versions) on the waveform's
    sample planes rounded to bf16 against demod_chain_fourstep2 on the
    same bf16 planes."""
    w = wide
    planes = (*_bf16_planes(w, "multipath"), *_t(w["hr"], w["hi"]))
    plane = kc.demod_llr(*planes, w["cp"], w["mod"], w["nv"])
    _assert_planes_close(plane.numpy(), w["ref"]["d2_plane_bf16"])
    got = kc.demod_count(*planes, *_t(w["idx"]), w["cp"], w["mod"], w["nv"])
    assert int(got.sum()) > 0
    _assert_counts_agree(got, w["ref"]["d2_count_bf16"], plane)


def test_demod_despread_count_on_bf16_matches_jax_fourstep2_fde(wide):
    """Kernel C's despread count (plain version) on the SC-FDMA waveform
    rounded to bf16 against the SC-FDE kernel on the same bf16 planes."""
    w = wide
    sc = (*_bf16_planes(w, "scfdma"), *_t(w["hr"], w["hi"]))
    got = kc.demod_count(*sc, *_t(w["idx"]), w["cp"], w["mod"], w["nv"], despread=True)
    assert int(got.sum()) > 0
    _assert_counts_agree(got, w["ref"]["fde_count_bf16"],
                         kc.demod_chain(*sc, w["cp"], w["mod"], w["nv"], despread=True))


@pytest.mark.parametrize("layout", ["planes", "interleaved"])
def test_llr_chain_plain_matches_jax_llr_kernel(wide, layout):
    """Kernel C's post-FFT mode (plain version) against llr_chain_pallas
    on the same frequency-domain grids: plane and sum; y as two planes or
    as the interleaved (B, S, N, 2) plane the hybrid route passes."""
    w = wide

    def y(grid):
        yr, yi = _t(*grid)
        return (yr, yi) if layout == "planes" else (torch.stack((yr, yi), dim=-1), None)

    plane = kc.llr_chain(*y(w["grids"]["wave"]), *_t(w["hr"], w["hi"]), w["mod"], w["nv"])
    assert plane.shape == (B, S, w["N"] * w["mod"].bits_per_symbol)
    _assert_planes_close(plane.numpy(), w["ref"]["llr_plane"])
    total = kc.llr_chain(*y(w["grids"]["bench"]), *_t(*w["bench"][2:]), w["mod"], w["nv"],
                         reduce_sum=True)
    _assert_sums_close(total, w["ref"]["llr_sum"])


def test_demod_chain_hybrid_matches_jax(wide):
    """The hybrid route (torch FFT, then llr_chain) against the JAX
    package's demod_chain_hybrid (XLA FFT, then llr_chain_pallas)."""
    w = wide
    plane = demod_chain_hybrid(*_wave(w), w["cp"], w["mod"], w["nv"])
    _assert_planes_close(plane.numpy(), w["ref"]["hybrid_plane"])
    total = demod_chain_hybrid(*_t(*w["bench"]), w["cp"], w["mod"], w["nv"], reduce_sum=True)
    _assert_sums_close(total, w["ref"]["hybrid_sum"])


@pytest.mark.parametrize("h_order", ["natural", "dif"])
def test_cl_wideband_plain_matches_jax_cl_twin(wide, h_order):
    """Kernels D and F at N 1024 / 4096 (the wideband mode; plain
    versions): the sum, the count and the LLR plane against
    demod_cl_jnp, with h in natural order and pre-permuted into the JAX
    kernel's DIF order."""
    w = wide
    N, cp, mod, nv = w["N"], w["cp"], w["mod"], w["nv"]
    assert kd.supported((S * (N + cp), B), N, cp)
    dif = h_order == "dif"
    perm = j_dif_perm(N) if dif else np.arange(N)
    np.testing.assert_array_equal(kd.dif_perm(N), j_dif_perm(N))
    re_t, im_t = _cl(w["ref"]["multipath"][0]), _cl(w["ref"]["multipath"][1])
    hr_t, hi_t = w["hr"][:, 0, :].T[perm], w["hi"][:, 0, :].T[perm]
    narrow = w["idx_t"].astype(np.int8 if mod.bits_per_symbol <= 7 else np.int16)
    cnt = kd.demod_count_cl(*_t(re_t, im_t, hr_t, hi_t, narrow), cp, mod, nv, h_in_dif_order=dif)
    assert cnt.dtype == torch.int32 and int(cnt.sum()) > 0
    _assert_counts_agree(cnt, w["ref"]["cl_count"], kc.demod_chain(*_wave(w), cp, mod, nv))
    pub = demod_llr_chain_cl(*_t(re_t, im_t, hr_t, hi_t), cp, mod, nv, h_in_dif_order=dif)
    _assert_planes_close(pub.numpy(), w["ref"]["cl_llr"])
    br, bi, bhr, bhi = w["bench"]
    total = kd.demod_sum_cl(*_t(_cl(br), _cl(bi), bhr[:, 0, :].T[perm], bhi[:, 0, :].T[perm]), cp,
                            mod, nv, h_in_dif_order=dif)
    _assert_sums_close(total, w["ref"]["cl_sum"])


@pytest.mark.parametrize("route", ["fused", "staged"])
def test_fast_engine_on_injected_draws_matches_jax(wide, route):
    """The engine's rows layout (``tx_with_channel`` → ``rx_count_core``)
    on the same indices, taps and noise as the JAX engine's wideband
    route (tx_chain_fourstep2 → apply_multipath → fade_awgn_pallas →
    demod_chain_fourstep2's count): the fused route (kernel B's FIR) and
    the staged one (B channel off, FIR in torch, kernel E) give the JAX
    samples, and the per-channel errors equal the JAX counts within the
    near-zero margin; ``layout="cl"`` counts as rows."""
    w = wide
    cfg, ids = w["cfg"], torch.arange(B, dtype=torch.int32)
    idx = torch.from_numpy(w["idx"])
    taps = torch.from_numpy(w["taps"])
    noise = _t(*w["noise"])
    if route == "fused":
        re, im = fast.tx_with_channel(cfg, 0, ids, idx, taps=taps, noise=noise)
    else:
        re, im = fast.apply_channel_fast(cfg, 0, ids, *kb.tx_chain(idx, w["cp"], w["mod"]),
                                         taps=taps, noise=noise)
    jre, jim = w["ref"]["multipath"]
    np.testing.assert_allclose(re.numpy(), jre, atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), jim, atol=SAMPLE_ATOL, rtol=0)
    errors, counted = fast.rx_count_core(cfg, 0, ids, re, im, taps=taps, idx=idx)
    assert int(counted[0]) == S * w["N"] * w["mod"].bits_per_symbol and int(errors.sum()) > 0
    _assert_counts_agree(errors, w["ref"]["d2_count"],
                         kc.demod_chain(*_wave(w), w["cp"], w["mod"], w["nv"]))
    cl_errors, _ = fast.rx_count_core(cfg, 0, ids, *fast._to_cl(re, im), taps=taps, idx=idx,
                                      layout="cl")
    torch.testing.assert_close(cl_errors, errors, rtol=0, atol=0)
    assert fast.layout_supported_cl(cfg, B)
