"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips (with its reason) when
``torch.cuda.is_available()`` is false, which is decided inside the
fixture, never at import. Run on a machine with an NVIDIA Hopper card:

    python -m pytest tests/test_torch_kernels_cuda.py -m gpu -q

Tolerances: indices and counts exact (counts: or within the number of
bits whose plain |LLR| < 1e-3); sample planes 1e-4 absolute (injected
noise) and 1e-5 of the plane's peak (keyed noise; kernel B's FIR and
kernel E, its FIR mode included, in both modes); LLR sums 1e-4 relative. Kernel G and kernel
C's despread mode follow the count rule. Kernel C's LLR-plane mode and
F's LLR mode: 1e-4 of the plane's peak |LLR|; bf16 sign-identical
wherever |LLR| ≥ 1e-3 and within 2^-8 relative; C's sums 1e-5 of the sum
of |LLR|, and the same bits on a second run. Kernel H: identical hard
bits in both schedules and layouts at any batch; the coded engine on the
card equals the CPU run but in channels holding an LLR with |LLR| < 1e-3. The
channels-last kernels run at N 2 to 4096 (the narrow plan to N = 512,
the wideband one above), with ragged B and S, B and C at configs 3 and
5's N, and C's post-FFT mode (``llr_chain``) as C's LLR and sum modes, C's TP stage-2
mode (``tp_stage2_llr``, #20) as C's LLR mode; D and F on bfloat16 sample
planes as on float32 ones. C on bfloat16 sample planes: bit for bit the
same counts, planes and sums as C on the planes widened to float32 (the
kernel widens each sample as it loads it), and against its plain version
as on float32 planes. The matmul DFT (``ops.fft_matmul``): the reference's
float tolerance (abs 1e-5·√n or rel 1e-6) against a float64 FFT, with
TF32 switched on globally.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sdr_tpu_torch.core.config import ChannelConfig, ChannelModel, LinkConfig, Modulation, OFDMConfig
from sdr_tpu_torch.kernels import _lib
from sdr_tpu_torch.kernels import channel as ke
from sdr_tpu_torch.kernels import demod as kc
from sdr_tpu_torch.kernels import demod_cl as kd
from sdr_tpu_torch.kernels import mc as kg
from sdr_tpu_torch.kernels import payload as ka
from sdr_tpu_torch.kernels import tx as kb
from sdr_tpu_torch.link import fast

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _counted(name, fn):
    before = _lib.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _lib.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("bps", [1, 4, 8, 10])
def test_payload_kernel_bit_exact(dev, bps):
    ids = torch.arange(1000, 1300, dtype=torch.int32, device=dev)
    got = _counted("payload", lambda: ka.payload_idx(16, 64, bps, 2**33 + 5, ids))
    want = ka.payload_idx_plain(16, 64, bps, 2**33 + 5, ids)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("bps", [4, 10])
@pytest.mark.parametrize("shape", [(3, 5, 4), (7, 3, 2), (5, 2, 1), (9, 17, 64), (2, 1, 8),
                                   (4, 3, 2048)])
def test_payload_kernel_partial_blocks(dev, shape, bps):
    """Four indices per Philox call: bit-exact where the quads of a channel
    do not fill a block, below one quad (N 1, 2), and in int16."""
    B, S, N = shape
    ids = torch.arange(50, 50 + B, dtype=torch.int32, device=dev)
    got = _counted("payload", lambda: ka.payload_idx(S, N, bps, 77, ids))
    want = ka.payload_idx_plain(S, N, bps, 77, ids)
    assert got.dtype == want.dtype == ka.out_dtype(bps)
    assert torch.equal(got, want)


# Kernel B at both sides of its tile / warp-group boundary (N 64 | 128), in
# every plan of the warp-group form, with config 2's CP ratio (N/4), no CP,
# and rows of (N + cp) % 4 == 2 and odd (the 8-byte and scalar stores).
TX_N_CP = [(64, 16), (128, 32), (256, 64), (512, 128), (1024, 128), (2048, 256), (4096, 512),
           (128, 0), (512, 6), (4096, 3)]
TX_N_CP_IDS = [f"N{n}cp{c}" for n, c in TX_N_CP]


def _tx_indices(dev, B, S, N, mod, idx_dtype, seed):
    """Payload-kernel indices (int8 up to 7 bits a symbol) in the given width."""
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(S, N, mod.bits_per_symbol, seed, ids)
    return idx if idx_dtype == "payload" else idx.to(idx_dtype)


def _tx_close(got, want, keyed, off=False):
    """Keyed noise and channel off: 1e-5 of the peak; injected: 1e-4 absolute."""
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        assert err <= (1e-5 * float(b.abs().max()) if keyed or off else 1e-4), err


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("N,cp", TX_N_CP, ids=TX_N_CP_IDS)
@pytest.mark.parametrize("B,S,idx_dtype", [(40, 8, "payload"), (203, 33, "payload"),
                                           (24, 13, torch.int16), (24, 13, torch.int32)],
                         ids=["40x8-payload", "203x33-payload", "24x13-int16", "24x13-int32"])
def test_tx_kernel_matches_plain(dev, mod, N, cp, B, S, idx_dtype):
    """Kernel B with the channel off and with complex gains per link ((B,)
    and (B, 1)) and per symbol ((B, S)), injected and keyed noise. B = 203
    and S = 33: a block's run of 32 symbols ends part-way through a channel."""
    idx = _tx_indices(dev, B, S, N, mod, idx_dtype, 1)
    g = torch.Generator(device="cpu").manual_seed(1)
    flat = tuple(torch.randn(B, generator=g).to(dev) for _ in range(2))
    per_sym = tuple(torch.randn((B, S), generator=g).to(dev) for _ in range(2))
    noise = tuple(torch.randn((B, S, N + cp), generator=g).to(dev) for _ in range(2))
    ids = torch.arange(B, dtype=torch.int32, device=dev) * 5 + 2
    tvar = 1e-3
    cases = [
        dict(),
        dict(noise_var=tvar, seed=3, ch_ids=ids),
        dict(hs_r=flat[0], hs_i=flat[1], noise_var=tvar, noise=noise),
        dict(hs_r=flat[0][:, None], hs_i=flat[1][:, None], noise_var=tvar, seed=3, ch_ids=ids),
        dict(hs_r=per_sym[0], hs_i=per_sym[1], noise_var=tvar, noise=noise),
        dict(hs_r=per_sym[0], hs_i=per_sym[1], noise_var=tvar, seed=3, ch_ids=ids),
    ]
    for kw in cases:
        got = _counted("tx" if kw else "tx_off", lambda: kb.tx_channel(idx, cp, mod, **kw))
        want = kb.tx_channel_plain(idx, cp, mod, **kw)
        _tx_close(got, want, "seed" in kw, off=not kw)


# Kernel C at both sides of its tile / warp-group boundary (N 64 | 128)
# and in every plan of the warp-group form (one warp a symbol to N 512,
# then 2, 4, 8); B = 203 channels, S = 33 symbols: one past a block's run
# of 32, so a block ends part-way through a channel.
C_N_FFT = [64, 128, 256, 512, 1024, 2048, 4096]
C_SHAPES = pytest.mark.parametrize("B,S", [(48, 8), (203, 33)], ids=["48x8", "203x33"])
# The index plane's width: int16, int32, or the payload kernel's own
# (int8 up to 7 bits a symbol).
C_IDX = pytest.mark.parametrize("idx_dtype", ["payload", torch.int16, torch.int32],
                                ids=["payload", "int16", "int32"])


def _indices(idx, idx_dtype):
    return idx if idx_dtype == "payload" else idx.to(idx_dtype)


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("h_syms", [1, "S"])
@pytest.mark.parametrize("N", C_N_FFT)
@C_SHAPES
@C_IDX
def test_demod_count_kernel_matches_plain(dev, mod, h_syms, N, B, S, idx_dtype):
    cp = N // 4
    h_syms = S if h_syms == "S" else h_syms
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(S, N, mod.bits_per_symbol, 4, ids)
    nv = 1.0 / (10 ** 0.8 * mod.bits_per_symbol)
    g = torch.Generator(device="cpu").manual_seed(2)
    hr = torch.randn((B, h_syms, N), generator=g).to(dev)
    hi = torch.randn((B, h_syms, N), generator=g).to(dev)
    re, im = kb.tx_channel(idx, cp, mod, noise_var=nv / N, seed=4, ch_ids=ids)
    idx = _indices(idx, idx_dtype)
    got = _counted("demod_count", lambda: kc.demod_count(re, im, hr, hi, idx, cp, mod, nv))
    llr = kc.demod_chain(re, im, hr, hi, cp, mod, nv)
    want = kc.count_errors(llr, idx, mod.bits_per_symbol)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert int(want.sum()) > 0
    assert bool(((got - want).abs() <= margin).all())


# Every boundary of the narrow plan (one thread a symbol at N <= 32, one
# exchange and 2-16-point last DFTs at 64-512, 256 to 32 channels a block),
# then the wideband plan's 16, 8, 4 channels a block.
CL_N_FFT = [2, 8, 32, 64, 128, 256, 512, 1024, 2048, 4096]
# B = 203 fills no channel group (256 down to 4) and S = 19 no symbol run
# (32 narrow, 16 wide); S = 33 is one past a narrow run; B = 3 is below one
# group.
CL_SHAPES = pytest.mark.parametrize("B,S", [(203, 19), (203, 33), (3, 17)],
                                    ids=["203x19", "203x33", "3x17"])
CL_WIDE_N_FFT = [1024, 2048, 4096]


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("n_fft", CL_N_FFT)
def test_demod_sum_cl_kernel_matches_plain(dev, mod, n_fft):
    B, S, cp = 203, 19, n_fft // 4
    g = torch.Generator(device="cpu").manual_seed(3)
    re = (torch.randn((S * (n_fft + cp), B), generator=g) / np.sqrt(2 * n_fft)).to(dev)
    im = (torch.randn((S * (n_fft + cp), B), generator=g) / np.sqrt(2 * n_fft)).to(dev)
    hr = (torch.randn((n_fft, B), generator=g) * np.sqrt(0.5)).to(dev)
    hi = (torch.randn((n_fft, B), generator=g) * np.sqrt(0.5)).to(dev)
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    got = _counted("demod_sum_cl", lambda: kd.demod_sum_cl(re, im, hr, hi, cp, mod, nv))
    want = kd.demod_sum_cl_plain(re, im, hr, hi, cp, mod, nv)
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    again = kd.demod_sum_cl(re, im, hr, hi, cp, mod, nv)
    assert float(again) == float(got)  # deterministic reduction


@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.RICIAN], ids=lambda m: m.value)
def test_fast_simulate_on_card_matches_cpu(dev, model):
    """The whole keyed link on the card (kernels A, B, C) against the same
    link on the CPU (plain versions): per-channel counts equal, or within
    the bits whose plain |LLR| < 1e-3."""
    cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(256, 64),
                     channel=ChannelConfig(model=model, ebno_db=6.0), n_symbols=16,
                     n_channels=96)
    got, counted = fast.fast_simulate(cfg, 31, device=dev)
    want, _ = fast.fast_simulate(cfg, 31, device="cpu")
    ids = torch.arange(96, dtype=torch.int32)
    idx = fast.draw_idx(cfg, 31, ids)
    h, _ = fast.fade_state(cfg, 31, ids)
    re, im = fast.tx_with_channel(cfg, 31, ids, idx, h=h)
    hb = torch.ones((96, 1, 1), dtype=torch.complex64) if h is None else h
    hr = hb.real.expand(96, 1, 256).contiguous()
    hi = hb.imag.expand(96, 1, 256).contiguous()
    llr = kc.demod_chain(re, im, hr, hi, 64, cfg.modulation, fast.noise_var(cfg))
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert int(want.sum()) > 0 and int(counted[0]) == 16 * 256 * 4
    assert bool(((got.cpu() - want).abs() <= margin).all())


def _close_planes(got, want, keyed):
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        assert err <= (1e-5 * float(b.abs().max()) if keyed else 1e-4), err


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16, Modulation.QAM1024],
                         ids=lambda m: m.value)
@pytest.mark.parametrize("kind", ["taps_static", "taps_per_symbol"])
@pytest.mark.parametrize("L", [1, 5, 16])
@pytest.mark.parametrize("N,cp", TX_N_CP, ids=TX_N_CP_IDS)
@pytest.mark.parametrize("B,S,idx_dtype", [(24, 13, torch.int16), (203, 33, "payload")],
                         ids=["24x13-int16", "203x33-payload"])
def test_tx_channel_modes_match_plain(dev, mod, kind, L, N, cp, B, S, idx_dtype):
    """Kernel B's FIR, static and per-symbol taps, injected then keyed noise.
    S = 13 is not a multiple of the tile's symbols per chunk; at S = 33 the
    history of the FIR crosses a run of 32 symbols (one block to the next)."""
    idx = _tx_indices(dev, B, S, N, mod, idx_dtype, 5)
    g = torch.Generator(device="cpu").manual_seed(5)
    ids = torch.arange(B, dtype=torch.int32, device=dev) * 3
    noise = tuple(torch.randn((B, S, N + cp), generator=g).to(dev) for _ in range(2))
    shape = (B, L) if kind == "taps_static" else (B, S, L)
    ch = dict(taps_r=(torch.randn(shape, generator=g) * 0.3).to(dev),
              taps_i=(torch.randn(shape, generator=g) * 0.3).to(dev))
    for kw in (dict(noise=noise), dict(seed=8, ch_ids=ids)):
        got = _counted("tx_taps", lambda: kb.tx_channel(idx, cp, mod, noise_var=1e-3, **ch, **kw))
        want = kb.tx_channel_plain(idx, cp, mod, noise_var=1e-3, **ch, **kw)
        _close_planes(got, want, "seed" in kw)


@pytest.mark.parametrize("N", [64, 128, 256, 1024, 4096])
@pytest.mark.parametrize("kind", ["gains_flat", "gains_per_symbol", "taps_static",
                                  "taps_per_symbol"])
def test_tx_keyed_split_equals_full(dev, N, kind):
    """Keyed noise depends on the channel id alone: channels [0, B/2) run
    alone give the full run's first half, bit for bit."""
    B, S, cp = 203, 33, N // 8
    mod = Modulation.QAM16
    idx = _tx_indices(dev, B, S, N, mod, "payload", 9)
    ids = torch.arange(B, dtype=torch.int32, device=dev) + 1000
    g = torch.Generator(device="cpu").manual_seed(9)
    shape = {"gains_flat": (B,), "gains_per_symbol": (B, S), "taps_static": (B, 5),
             "taps_per_symbol": (B, S, 5)}[kind]
    ch = [(torch.randn(shape, generator=g) * 0.5).to(dev) for _ in range(2)]
    keys = ("hs_r", "hs_i") if kind.startswith("gains") else ("taps_r", "taps_i")
    h = B // 2

    def run(sl):
        kw = {k: v[sl] for k, v in zip(keys, ch)}
        return kb.tx_channel(idx[sl], cp, mod, noise_var=1e-3, seed=11, ch_ids=ids[sl], **kw)

    full, half = run(slice(None)), run(slice(0, h))
    assert all(torch.equal(a[:h], b) for a, b in zip(full, half))


@pytest.mark.parametrize("h_syms", [0, 1, 7])
def test_fade_awgn_kernel_matches_plain(dev, h_syms):
    B, S, L = 50, 7, 320
    g = torch.Generator(device="cpu").manual_seed(6)
    re, im = (torch.randn((B, S, L), generator=g).to(dev) for _ in range(2))
    hs = (None, None)
    if h_syms:
        hs = tuple(torch.randn((B, h_syms), generator=g).to(dev) for _ in range(2))
    noise = tuple(torch.randn((B, S, L), generator=g).to(dev) for _ in range(2))
    ids = torch.arange(1000, 1000 + B, dtype=torch.int32, device=dev)
    for kw in (dict(noise=noise), dict(seed=12, ch_ids=ids)):
        got = _counted("fade_awgn", lambda: ke.fade_awgn(re, im, *hs, 0.02, **kw))
        want = ke.fade_awgn_plain(re, im, *hs, 0.02, **kw)
        _close_planes(got, want, "seed" in kw)


# Kernel E's FIR mode: N 16 and 4096, config 2's N 256 (CP 64), and a row
# of 319 samples (not a multiple of 4); taps up to cp + 1.
E_FIR_SHAPES = [(40, 9, 16, 16), (24, 40, 256, 64), (20, 33, 256, 63), (3, 5, 4096, 512)]
E_FIR_CASES = [(shape, n_taps) for shape in E_FIR_SHAPES for n_taps in (2, 17, 24, shape[3] + 1)
               if n_taps <= shape[3] + 1]


def _fir_inputs(dev, B, S, L, n_taps, kind, seed=8):
    g = torch.Generator(device="cpu").manual_seed(seed)
    re, im = (torch.randn((B, S, L), generator=g).to(dev) for _ in range(2))
    shape = (B, n_taps) if kind == "static" else (B, S, n_taps)
    taps = tuple((torch.randn(shape, generator=g) * n_taps ** -0.5).to(dev) for _ in range(2))
    return re, im, taps


@pytest.mark.parametrize("kind", ["static", "per_symbol"])
@pytest.mark.parametrize("shape,n_taps", E_FIR_CASES,
                         ids=[f"{b}x{s}-N{n}-cp{c}-{t}taps" for (b, s, n, c), t in E_FIR_CASES])
def test_fade_awgn_fir_kernel_matches_plain(dev, shape, n_taps, kind):
    B, S, N, cp = shape
    re, im, (tr, ti) = _fir_inputs(dev, B, S, N + cp, n_taps, kind)
    g = torch.Generator(device="cpu").manual_seed(9)
    noise = tuple(torch.randn((B, S, N + cp), generator=g).to(dev) for _ in range(2))
    ids = torch.arange(300, 300 + B, dtype=torch.int32, device=dev)
    for kw in (dict(noise=noise), dict(seed=13, ch_ids=ids)):
        got = _counted("fade_awgn_fir", lambda: ke.fade_awgn(re, im, noise_var=0.02, taps_r=tr,
                                                             taps_i=ti, **kw))
        want = ke.fade_awgn_plain(re, im, noise_var=0.02, taps_r=tr, taps_i=ti, **kw)
        _close_planes(got, want, "seed" in kw)


@pytest.mark.parametrize("kind", ["static", "per_symbol"])
def test_fade_awgn_fir_kernel_split_equals_full(dev, kind):
    """Channels [0, B/2) alone give the same bits as inside the full run:
    a block reads its history from the clean input, not from another
    block's output."""
    B, S, N, cp = 24, 40, 256, 63
    re, im, (tr, ti) = _fir_inputs(dev, B, S, N + cp, 24, kind)
    ids = torch.arange(500, 500 + B, dtype=torch.int32, device=dev)
    h = B // 2

    def run(sl):
        return ke.fade_awgn(re[sl], im[sl], noise_var=0.02, taps_r=tr[sl], taps_i=ti[sl],
                            seed=3, ch_ids=ids[sl])

    full, half = run(slice(None)), run(slice(0, h))
    assert all(torch.equal(a[:h], b) for a, b in zip(full, half))


def test_staged_route_runs_kernel_e_alone(dev, monkeypatch):
    """On the card the staged route makes no plain-torch FIR: after B's
    channel-off launch, one launch of E a call (its FIR mode for the
    selective models, its gain mode for the flat ones)."""
    from sdr_tpu_torch.ops import channel as chan

    def no_fir(*args, **kwargs):
        raise AssertionError("plain-torch FIR on the card")

    monkeypatch.setattr(chan, "grid_fir", no_fir)
    monkeypatch.setattr(ke, "grid_fir", no_fir)
    for model, pdp, counter in ((ChannelModel.MULTIPATH, tuple(0.8 ** l for l in range(24)),
                                 "fade_awgn_fir"),
                                (ChannelModel.MULTIPATH_TIME, tuple(0.8 ** l for l in range(20)),
                                 "fade_awgn_fir"),
                                (ChannelModel.RAYLEIGH_FLAT, None, "fade_awgn")):
        cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(256, 64),
                         channel=ChannelConfig(model=model, ebno_db=14.0, doppler_norm=0.02,
                                               **({"pdp": pdp} if pdp else {})),
                         n_symbols=8, n_channels=16)
        ids = torch.arange(16, dtype=torch.int32, device=dev)
        idx = fast.draw_idx(cfg, 5, ids)
        _lib.reset_launches()
        re, im = kb.tx_chain(idx, 64, cfg.modulation)
        out = fast.apply_channel_fast(cfg, 5, ids, re, im)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _lib.LAUNCHES.items() if v}
        assert launched == {"tx_off": 1, counter: 1}, launched
        assert all(bool(torch.isfinite(p).all()) for p in out)


def test_fade_awgn_refused_launch_raises(dev, monkeypatch):
    """A launch the C entry refuses raises and counts nothing: no FIR
    falls back to the plain version on the card."""
    re = torch.zeros((4, 3, 80), device=dev)
    taps = torch.zeros((4, 5), device=dev)

    class Refusing:
        @staticmethod
        def sdr_fade_awgn(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_lib, "lib", lambda: Refusing)
    before = dict(_lib.LAUNCHES)
    with pytest.raises(RuntimeError, match="fade_awgn"):
        ke.fade_awgn(re, re, taps_r=taps, taps_i=taps)
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("s0", [1, 7, 4096])
@pytest.mark.parametrize("shape", [(3, 5, 4), (9, 17, 64), (40, 8, 256), (2, 3, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_payload_kernel_s0_matches_plain(dev, shape, s0):
    """Kernel A at a symbol offset: bit for bit its plain version, and rows
    s0 … of the frame's draw."""
    B, S, N = shape
    ids = torch.arange(70, 70 + B, dtype=torch.int32, device=dev)
    got = _counted("payload", lambda: ka.payload_idx(S, N, 4, 31, ids, s0=s0))
    assert torch.equal(got, ka.payload_idx_plain(S, N, 4, 31, ids, s0=s0))
    assert torch.equal(got, ka.payload_idx(s0 + S, N, 4, 31, ids)[:, s0:])


# Kernel E with history planes: the FIR shapes above, taps 2, 4, 17, cp + 1.
E_HIST_CASES = [(shape, n_taps) for shape in E_FIR_SHAPES for n_taps in (2, 4, 17, shape[3] + 1)
                if n_taps <= shape[3] + 1]


@pytest.mark.parametrize("kind", ["static", "per_symbol"])
@pytest.mark.parametrize("shape,n_taps", E_HIST_CASES,
                         ids=[f"{b}x{s}-N{n}-cp{c}-{t}taps" for (b, s, n, c), t in E_HIST_CASES])
def test_fade_awgn_history_kernel_matches_plain(dev, shape, n_taps, kind):
    """E's FIR from history planes (row 0's halo) and at a symbol offset,
    injected and keyed, against the plain version."""
    B, S, N, cp = shape
    re, im, (tr, ti) = _fir_inputs(dev, B, S, N + cp, n_taps, kind)
    g = torch.Generator(device="cpu").manual_seed(10)
    hist = tuple(torch.randn((B, n_taps - 1), generator=g).to(dev) for _ in range(2))
    noise = tuple(torch.randn((B, S, N + cp), generator=g).to(dev) for _ in range(2))
    ids = torch.arange(300, 300 + B, dtype=torch.int32, device=dev)
    for kw in (dict(noise=noise), dict(seed=13, ch_ids=ids, s0=5)):
        got = _counted("fade_awgn_fir", lambda: ke.fade_awgn(
            re, im, noise_var=0.02, taps_r=tr, taps_i=ti, history_r=hist[0], history_i=hist[1],
            **kw))
        want = ke.fade_awgn_plain(re, im, noise_var=0.02, taps_r=tr, taps_i=ti,
                                  history_r=hist[0], history_i=hist[1], **kw)
        _close_planes(got, want, "seed" in kw)


@pytest.mark.parametrize("kind", ["static", "per_symbol", "gains", "noise_only"])
@pytest.mark.parametrize("L", [319, 320])
def test_fade_awgn_block_equals_frame_rows(dev, kind, L):
    """Keyed E over rows [s0, S) of a frame at s0, with the frame's tail
    before s0 as history, gives those rows of the whole frame's channel
    (the seam of a time block, link/stream.py), bit for bit: on rows of a
    multiple of 4 samples (config 2's 320), and on 319-sample rows, where
    the block's first quad of the FIR is taken sample by sample (it starts
    off the 16-byte grid) while the frame takes it whole — both sum in the
    pinned rounding of ``sdr::cmac``."""
    B, S, s0, Lt = 12, 40, 17, 24
    re, im, (tr, ti) = _fir_inputs(dev, B, S, L, Lt, "per_symbol" if kind == "per_symbol"
                                   else "static")
    ids = torch.arange(40, 40 + B, dtype=torch.int32, device=dev)
    rows = slice(s0, None)
    kw_full, kw_part = {}, {}
    if kind == "gains":
        g = torch.Generator(device="cpu").manual_seed(4)
        hr, hi = (torch.randn((B, S), generator=g).to(dev) for _ in range(2))
        kw_full = dict(hr_s=hr, hi_s=hi)
        kw_part = dict(hr_s=hr[:, rows].contiguous(), hi_s=hi[:, rows].contiguous())
    elif kind != "noise_only":
        kw_full = dict(taps_r=tr, taps_i=ti)
        kw_part = dict(taps_r=tr, taps_i=ti) if kind == "static" else dict(
            taps_r=tr[:, rows].contiguous(), taps_i=ti[:, rows].contiguous())
        kw_part.update(history_r=re[:, s0 - 1, -(Lt - 1):].contiguous(),
                       history_i=im[:, s0 - 1, -(Lt - 1):].contiguous())
    full = ke.fade_awgn(re, im, noise_var=0.02, seed=9, ch_ids=ids, **kw_full)
    part = ke.fade_awgn(re[:, rows].contiguous(), im[:, rows].contiguous(), noise_var=0.02,
                        seed=9, ch_ids=ids, s0=s0, **kw_part)
    want = tuple(b[:, rows] for b in full)
    assert all(torch.equal(a, b) for a, b in zip(part, want))


def _pipeline_cfg(model=ChannelModel.MULTIPATH, B=64, S=16, **kw):
    from sdr_tpu_torch.core.config import Equalizer

    channel = dict(pdp=(1.0, 0.5, 0.25, 0.125), doppler_norm=0.03)
    return LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(256, 64),
                      channel=ChannelConfig(model=model, ebno_db=kw.pop("ebno_db", 12.0),
                                            **channel),
                      equalizer=kw.pop("equalizer", Equalizer.MMSE), n_symbols=S, n_channels=B,
                      **kw)


def test_pipeline_on_card_equals_fast_simulate(dev):
    """``__graft_entry__.entry()``'s link on the card: the pipeline's counts
    equal the fast engine's on the same seed (B off then E's FIR is B's
    fused FIR bit for bit), through A, B off, E and C's count alone; the
    LLR plane's hard bits give the same counts."""
    from sdr_tpu_torch.link import pipeline

    cfg = _pipeline_cfg()
    _lib.reset_launches()
    res = pipeline.simulate(cfg, 7, device=dev)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _lib.LAUNCHES.items() if v}
    assert launched == {"payload": 1, "tx_off": 1, "fade_awgn_fir": 1, "demod_count": 1}, launched
    want, counted = fast.fast_simulate(cfg, 7, device=dev)
    assert torch.equal(res.bit_errors, want) and torch.equal(res.bits_counted, counted)
    plane = pipeline.simulate(cfg, 7, device=dev, want_llrs=True)
    assert plane.llrs.shape == (64, 16, 1024) and plane.llrs.device.type == "cuda"
    margin = (plane.llrs.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((plane.bit_errors - res.bit_errors).abs() <= margin).all())


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("model", [ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME])
def test_stream_on_card_equals_simulate(dev, model, n_blocks):
    """The blocked stream on the card, its seams through E's history planes,
    equals the whole frame: bit for bit on static taps, under Jakes fading
    but for bits whose |LLR| < 1e-3."""
    from sdr_tpu_torch.link import pipeline
    from sdr_tpu_torch.link.stream import exact_at_seams, stream_simulate

    cfg = _pipeline_cfg(model)
    errors, _ = stream_simulate(cfg, 7, n_blocks, device=dev)
    ref = pipeline.simulate(cfg, 7, device=dev)
    if exact_at_seams(cfg):
        assert torch.equal(errors, ref.bit_errors)
    else:
        llrs = pipeline.simulate(cfg, 7, device=dev, want_llrs=True).llrs
        margin = (llrs.abs() < 1e-3).sum(dim=(1, 2))
        assert bool(((errors - ref.bit_errors).abs() <= margin).all())
    assert int(errors.sum()) > 0


_MIMO_ON_CARD = {
    "alamouti_2x2": dict(scheme="alamouti", n_tx=2, n_rx=2),
    "mrc_1x3_multipath": dict(scheme="mrc", n_tx=1, n_rx=3, model=ChannelModel.MULTIPATH),
    "mux_2x2_ml_preamble_dft": dict(scheme="mux", n_tx=2, n_rx=2, csi="preamble",
                                    detector="ml", model=ChannelModel.MULTIPATH),
    "mux_3x4_sic": dict(scheme="mux", n_tx=3, n_rx=4, detector="sic",
                        mod=Modulation.QPSK),
    "scfdma_mux_2x2_preamble_pa": dict(scheme="mux", n_tx=2, n_rx=2, csi="preamble",
                                       dft_spread=True, pa_ibo_db=6.0),
}


@pytest.mark.parametrize("case", list(_MIMO_ON_CARD))
def test_mimo_links_on_card_match_the_cpu(dev, case):
    """A MIMO link (item 11e-i) on the card against the same link's plain
    versions on the CPU: LLRs within 1e-4 of their peak, counts equal but
    for bits whose |LLR| < 1e-3; the card's call launches A, B off, E (the
    pair plane, then the noise) and C's post-FFT mode (not for ML)."""
    from sdr_tpu_torch.core.config import ChannelEstimator, Equalizer, MIMOConfig, MIMOScheme
    from sdr_tpu_torch.link import pipeline

    kw = dict(_MIMO_ON_CARD[case])
    model = kw.pop("model", ChannelModel.RAYLEIGH_FLAT)
    mod = kw.pop("mod", Modulation.QAM16)
    spread = kw.pop("dft_spread", False)
    channel = {"pa_ibo_db": kw.pop("pa_ibo_db")} if "pa_ibo_db" in kw else {}
    if model == ChannelModel.MULTIPATH:
        channel["pdp"] = (1.0, 0.5, 0.25)
    cfg = LinkConfig(modulation=mod, ofdm=OFDMConfig(64, 16),
                     channel=ChannelConfig(model=model, ebno_db=10.0, **channel),
                     equalizer=Equalizer.MMSE, estimator=ChannelEstimator.DFT, n_symbols=16,
                     n_channels=64,
                     dft_spread=spread,
                     mimo=MIMOConfig(MIMOScheme(kw.pop("scheme")), **kw))
    _lib.reset_launches()
    res = pipeline.simulate(cfg, 5, device=dev, want_llrs=True)
    torch.cuda.synchronize()
    launched = {k for k, v in _lib.LAUNCHES.items() if v}
    want = {"payload", "tx_off", "fade_awgn"} | (
        {"fade_awgn_fir"} if model == ChannelModel.MULTIPATH else set()) | (
        set() if cfg.mimo.detector == "ml" else {"llr_chain"})
    if spread:
        want.discard("tx_off")
    assert launched == want, launched
    ref = pipeline.simulate(cfg, 5, device="cpu", want_llrs=True)
    got = res.llrs.cpu()
    peak = float(ref.llrs.abs().max())
    assert float((got - ref.llrs).abs().max()) <= 1e-4 * peak
    margin = (ref.llrs.abs() < 1e-3).sum(dim=(1, 2, 3))
    assert bool(((res.bit_errors.cpu() - ref.bit_errors).abs() <= margin).all())
    assert int(ref.bit_errors.sum()) > 0


_MIMO_TIME_ON_CARD = {
    "rayleigh_time_mrc_genie": dict(model=ChannelModel.RAYLEIGH_TIME, scheme="mrc", n_tx=1,
                                    n_rx=2),
    "multipath_time_alamouti_midamble_dft": dict(model=ChannelModel.MULTIPATH_TIME,
                                                 scheme="alamouti", n_tx=2, n_rx=2,
                                                 csi="preamble", midamble_period=4),
    "rayleigh_time_ml_per_symbol": dict(model=ChannelModel.RAYLEIGH_TIME, scheme="mux", n_tx=2,
                                        n_rx=2, detector="ml", mod=Modulation.QPSK),
    "acquired_walk_iq_alamouti": dict(scheme="alamouti", n_tx=2, n_rx=2, csi="preamble",
                                      midamble_period=4, phase_noise_std=2e-3, iq_gain=1.05,
                                      iq_phase_rad=0.03, cfo_subcarriers=1.3, timing_offset=37),
    "acquired_scfdma_pa": dict(scheme="alamouti", n_tx=2, n_rx=2, csi="preamble",
                               midamble_period=4, dft_spread=True, pa_ibo_db=6.0,
                               cfo_subcarriers=1.3, timing_offset=37),
    "acquired_multipath_time_sic": dict(model=ChannelModel.MULTIPATH_TIME, scheme="mux", n_tx=2,
                                        n_rx=2, detector="sic", csi="preamble",
                                        midamble_period=4, cfo_subcarriers=-0.7,
                                        timing_offset=11),
}


@pytest.mark.parametrize("case", list(_MIMO_TIME_ON_CARD))
def test_mimo_time_links_on_card_match_the_cpu(dev, case):
    """A time-varying or impaired MIMO link (item 11e-ii) on the card against
    the same link's plain versions on the CPU: the acquired links' starts
    equal and their total CFO estimates within 1e-5 subcarriers; LLRs within
    (1e-4 + 4ρ) of their peak — ρ = 0 on the aligned links, on the acquired
    ones the samples' relative error after the CFO correction,
    2π·|Δε|·T/N for the two estimates' difference Δε plus the rotations'
    float32 error 4 ulp(2π·5·T/N) and 2u —; counts equal but for bits
    whose |LLR| < 1e-3. The card's call launches A, B off (not SC-FDMA), E
    (gains or FIR, and the noise) and C's post-FFT mode (not for ML)."""
    import math

    import numpy as np

    from sdr_tpu_torch.core.config import ChannelEstimator, Equalizer, MIMOConfig, MIMOScheme
    from sdr_tpu_torch.link import pipeline

    kw = dict(_MIMO_TIME_ON_CARD[case])
    model = kw.pop("model", ChannelModel.RAYLEIGH_FLAT)
    mod = kw.pop("mod", Modulation.QAM16)
    spread = kw.pop("dft_spread", False)
    ch_keys = ("pa_ibo_db", "phase_noise_std", "iq_gain", "iq_phase_rad", "cfo_subcarriers",
               "timing_offset")
    channel = {k: kw.pop(k) for k in ch_keys if k in kw}
    if model in (ChannelModel.RAYLEIGH_TIME, ChannelModel.MULTIPATH_TIME):
        channel["doppler_norm"] = 0.02
    if model == ChannelModel.MULTIPATH_TIME:
        channel["pdp"] = (1.0, 0.5, 0.25)
    cfg = LinkConfig(modulation=mod, ofdm=OFDMConfig(64, 16),
                     channel=ChannelConfig(model=model, ebno_db=10.0, **channel),
                     equalizer=Equalizer.MMSE, estimator=ChannelEstimator.DFT, n_symbols=16,
                     n_channels=64, dft_spread=spread,
                     mimo=MIMOConfig(MIMOScheme(kw.pop("scheme")), **kw))
    _lib.reset_launches()
    res = pipeline.simulate(cfg, 5, device=dev, want_llrs=True)
    torch.cuda.synchronize()
    launched = {k for k, v in _lib.LAUNCHES.items() if v}
    want = {"payload", "tx_off", "fade_awgn"} | (
        {"fade_awgn_fir"} if model == ChannelModel.MULTIPATH_TIME else set()) | (
        set() if cfg.mimo.detector == "ml" else {"llr_chain"})
    if spread:
        want.discard("tx_off")
    assert launched == want, launched
    ref = pipeline.simulate(cfg, 5, device="cpu", want_llrs=True)
    rho = 0.0
    if cfg.channel.impaired:
        fronts = []
        for d in (dev, "cpu"):
            ids = torch.arange(64, dtype=torch.int32, device=d)
            tx = pipeline.mimo_tx(cfg, pipeline.draw_mimo_idx(cfg, 5, ids))
            fronts.append(pipeline.mimo_acquire(cfg, pipeline.mimo_stream(cfg, 5, ids, tx))[:2])
        (s_g, t_g), (s_c, t_c) = fronts
        assert torch.equal(s_g.cpu(), s_c)
        d_eps = float((t_g.cpu() - t_c).abs().max())
        assert d_eps <= 1e-5
        T = cfg.channel.timing_offset + (pipeline.n_tx_symbols(cfg) + 3) * 80
        rho = (2 * math.pi * d_eps * T / 64
               + 4 * float(np.spacing(np.float32(2 * math.pi * 5 * T / 64))) + 2.0 ** -23)
    got = res.llrs.cpu()
    peak = float(ref.llrs.abs().max())
    assert float((got - ref.llrs).abs().max()) <= (1e-4 + 4 * rho) * peak
    margin = (ref.llrs.abs() < 1e-3).sum(dim=(1, 2, 3))
    assert bool(((res.bit_errors.cpu() - ref.bit_errors).abs() <= margin).all())
    assert int(ref.bit_errors.sum()) > 0


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("N", C_N_FFT)
@pytest.mark.parametrize("B,S", [(40, 8), (203, 33)], ids=["40x8", "203x33"])
def test_demod_count_taps_kernel_matches_plain(dev, mod, L, N, B, S):
    cp = N // 4
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(S, N, mod.bits_per_symbol, 4, ids)
    nv = 1.0 / (10 ** 1.0 * mod.bits_per_symbol)
    g = torch.Generator(device="cpu").manual_seed(7)
    taps = tuple((torch.randn((B, S, L), generator=g) / np.sqrt(2 * L)).to(dev) for _ in range(2))
    re, im = kb.tx_channel(idx, cp, mod, noise_var=nv / N, seed=4, ch_ids=ids, taps_r=taps[0],
                           taps_i=taps[1])
    got = _counted("demod_count_taps",
                   lambda: kc.demod_count(re, im, None, None, idx, cp, mod, nv, taps=taps))
    hr, hi = kc.taps_plane(taps, N)
    llr = kc.demod_chain(re, im, hr, hi, cp, mod, nv)
    want = kc.count_errors(llr, idx, mod.bits_per_symbol)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert int(want.sum()) > 0
    assert bool(((got - want).abs() <= margin).all())


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("n_fft", CL_N_FFT)
def test_demod_count_cl_kernel_matches_plain(dev, mod, n_fft):
    """B below one group: test_cl_kernels_below_one_group_match_plain."""
    B, S, cp = 203, 19, n_fft // 4
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(S, n_fft, mod.bits_per_symbol, 9, ids)
    nv = 1.0 / (10 ** 0.8 * mod.bits_per_symbol)
    re, im = kb.tx_channel(idx, cp, mod, noise_var=nv / n_fft, seed=9, ch_ids=ids)
    re_t, im_t = fast._to_cl(re, im)
    idx_t = idx.permute(1, 2, 0).reshape(S * n_fft, B).contiguous()
    hr_t = torch.ones((n_fft, B), device=dev)
    hi_t = torch.zeros((n_fft, B), device=dev)
    got = _counted("demod_count_cl",
                   lambda: kd.demod_count_cl(re_t, im_t, hr_t, hi_t, idx_t, cp, mod, nv))
    want = kd.demod_count_cl_plain(re_t, im_t, hr_t, hi_t, idx_t, cp, mod, nv)
    llr = kc.demod_chain(re, im, torch.ones((B, 1, n_fft), device=dev),
                         torch.zeros((B, 1, n_fft), device=dev), cp, mod, nv)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert int(want.sum()) > 0
    assert bool(((got - want).abs() <= margin).all())


@pytest.mark.parametrize(
    "model,layout",
    [(ChannelModel.MULTIPATH, "rows"), (ChannelModel.MULTIPATH_TIME, "rows"),
     (ChannelModel.RAYLEIGH_TIME, "rows"), (ChannelModel.MULTIPATH, "cl")],
    ids=["multipath", "multipath_time", "rayleigh_time", "multipath_cl"],
)
def test_selective_fast_simulate_on_card_matches_cpu(dev, model, layout):
    """The selective and time-varying links on the card against the same
    links on the CPU: counts equal, or within the bits whose plain
    |LLR| < 1e-3 (the keyed fading draws are the same bits on both)."""
    cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(256, 64),
                     channel=ChannelConfig(model=model, ebno_db=10.0, pdp=(1.0, 0.5, 0.25),
                                           doppler_norm=0.02),
                     n_symbols=16, n_channels=64)
    got, _ = fast.fast_simulate(cfg, 17, device=dev, layout=layout)
    want, _ = fast.fast_simulate(cfg, 17, device="cpu", layout=layout)
    ids = torch.arange(64, dtype=torch.int32)
    h, _ = fast.fade_state(cfg, 17, ids)
    re, im = fast.tx_channel_core(cfg, 17, ids)
    hb = h.expand(64, h.shape[1], 256)
    llr = kc.demod_chain(re, im, hb.real, hb.imag, 64, cfg.modulation, fast.noise_var(cfg))
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert int(want.sum()) > 0
    assert bool(((got.cpu() - want).abs() <= margin).all())


def test_wrappers_raise_instead_of_falling_back(dev):
    mod = Modulation.QAM16
    with pytest.raises(ValueError):  # samples of two types (bf16 and f32 alone are taken)
        kd.demod_sum_cl(torch.zeros((80, 128), device=dev, dtype=torch.bfloat16),
                        torch.zeros((80, 128), device=dev),
                        torch.zeros((64, 128), device=dev), torch.zeros((64, 128), device=dev),
                        16, mod, 0.1)
    with pytest.raises(ValueError):
        kb.tx_chain(torch.zeros((2, 2, 96), dtype=torch.int32, device=dev), 8, mod)
    with pytest.raises(ValueError):
        kc.demod_count(*(torch.zeros((2, 2, 80), device=dev),) * 2,
                       *(torch.zeros((2, 1, 64), device=dev),) * 2,
                       torch.zeros((2, 2, 64), dtype=torch.int64, device=dev), 16, mod, 0.1)
    with pytest.raises(ValueError):
        kb.tx_channel(torch.zeros((2, 2, 64), dtype=torch.int32, device=dev), 16, mod,
                      taps_r=torch.zeros((2, 17), device=dev),
                      taps_i=torch.zeros((2, 17), device=dev))
    with pytest.raises(ValueError):  # an index plane off the 16-byte grid (N >= 128)
        kb.tx_chain(torch.zeros(2 * 2 * 128 + 1, dtype=torch.int8, device=dev)[1:].view(2, 2, 128),
                    32, mod)
    with pytest.raises(ValueError):
        kd.demod_count_cl(*(torch.zeros((80, 32), device=dev),) * 2,
                          *(torch.zeros((64, 32), device=dev),) * 2,
                          torch.zeros((64, 32), dtype=torch.int32, device=dev), 16, mod, 0.1)
    with pytest.raises(ValueError):  # above the channels-last kernels' N = 4096
        kd.demod_sum_cl(*(torch.zeros((8192 + 16, 8), device=dev),) * 2,
                        *(torch.zeros((8192, 8), device=dev),) * 2, 16, mod, 0.1)
    with pytest.raises(ValueError):
        kc.llr_chain(*(torch.zeros((2, 2, 96), device=dev),) * 2,
                     *(torch.zeros((2, 1, 96), device=dev),) * 2, mod, 0.1)
    with pytest.raises(ValueError):  # a y plane off the 16-byte grid
        kc.llr_chain(*(torch.zeros(2 * 2 * 64 + 1, device=dev)[1:].view(2, 2, 64),) * 2,
                     *(torch.zeros((2, 1, 64), device=dev),) * 2, mod, 0.1)
    with pytest.raises(ValueError):  # an interleaved y plane off the 16-byte grid at N = 2
        kc.llr_chain(torch.zeros(2 * 2 * 2 * 2 + 2, device=dev)[2:].view(2, 2, 2, 2), None,
                     *(torch.zeros((2, 1, 2), device=dev),) * 2, mod, 0.1)
    with pytest.raises(ValueError):  # a TP h plane off the 16-byte grid (n2 >= 128)
        kc.tp_stage2_llr(*(torch.zeros((2, 2, 1, 128), device=dev),) * 2,
                         *(torch.zeros(2 * 2 * 128 + 1, device=dev)[1:].view(2, 2, 1, 128),) * 2,
                         torch.tensor(0.1, device=dev), mod)
    x, taps = torch.zeros((4, 3, 80), device=dev), torch.zeros((4, 5), device=dev)
    with pytest.raises(ValueError):  # E: taps and gains together
        ke.fade_awgn(x, x, taps[:, :1], taps[:, :1], taps_r=taps, taps_i=taps)
    with pytest.raises(ValueError):  # E: more taps than a row and its history hold
        ke.fade_awgn(x, x, taps_r=torch.zeros((4, 82), device=dev),
                     taps_i=torch.zeros((4, 82), device=dev))
    with pytest.raises(ValueError):  # E: taps of another batch
        ke.fade_awgn(x, x, taps_r=taps[:2], taps_i=taps[:2])


def _within_margin(got, llr, want):
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((got - want).abs() <= margin).all()), (got, want, margin)


def _despread_count_case(dev, mod, n_fft, h_syms, B, S, idx_dtype=None):
    """Kernel C's despread count against its plain version on an SC-FDMA
    waveform through a per-subcarrier channel (h one row a channel, or
    one a symbol with h_syms = "S")."""
    cp = n_fft // 8
    h_syms = S if h_syms == "S" else h_syms
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(S, n_fft, mod.bits_per_symbol, 5, ids)
    nv = 1.0 / (10 ** 1.0 * mod.bits_per_symbol)
    g = torch.Generator(device="cpu").manual_seed(8)
    hr = (torch.randn((B, h_syms, n_fft), generator=g) * np.sqrt(0.5)).to(dev)
    hi = (torch.randn((B, h_syms, n_fft), generator=g) * np.sqrt(0.5)).to(dev)
    cfg = LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft, cp), n_symbols=S, n_channels=B,
                     dft_spread=True)
    x = torch.complex(*fast.scfdma_tx(cfg, idx))
    y = torch.fft.ifft(torch.fft.fft(x[..., cp:]) * torch.complex(hr, hi))
    y = torch.cat([y[..., -cp:], y], dim=-1) + 0.2 * torch.randn(y.shape[:-1] + (n_fft + cp,),
                                                                  dtype=torch.complex64,
                                                                  device=dev) * nv ** 0.5
    re, im = y.real.contiguous(), y.imag.contiguous()
    if idx_dtype is not None:
        idx = idx.to(idx_dtype)
    got = _counted("demod_count_despread",
                   lambda: kc.demod_count(re, im, hr, hi, idx, cp, mod, nv, despread=True))
    llr = kc.demod_chain(re, im, hr, hi, cp, mod, nv, despread=True)
    want = kc.count_errors(llr, idx, mod.bits_per_symbol)
    assert int(want.sum()) > 0
    _within_margin(got, llr, want)


_DESPREAD_N = [64, 128, 256, 512, 1024, 2048, 4096]


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("n_fft", _DESPREAD_N)
@pytest.mark.parametrize("h_syms", [1, "S"])
@pytest.mark.parametrize("B,S", [(20, 7), (203, 33)], ids=["20x7", "203x33"])
def test_demod_count_despread_kernel_matches_plain(dev, mod, n_fft, h_syms, B, S):
    """Kernel C's despread mode (SC-FDE) in every plan: the tile at N 64,
    the warp-group form at N 128-4096 (1, 2, 4, 8 warps a symbol); S = 33
    is one past a block's run of 32 symbols."""
    _despread_count_case(dev, mod, n_fft, h_syms, B, S)


@pytest.mark.parametrize("idx_dtype,n_fft,h_syms", [(torch.int16, 1024, "S"),
                                                    (torch.int32, 256, 1)],
                         ids=["int16", "int32"])
def test_demod_count_despread_kernel_index_widths(dev, idx_dtype, n_fft, h_syms):
    """The despread count reads int16 and int32 index rows as int8 ones."""
    _despread_count_case(dev, Modulation.QAM16, n_fft, h_syms, 20, 33, idx_dtype)


_MC_MODELS = [
    (ChannelModel.IDENTITY, {}), (ChannelModel.AWGN, {}), (ChannelModel.RAYLEIGH_FLAT, {}),
    (ChannelModel.RICIAN, {}), (ChannelModel.RAYLEIGH_TIME, dict(doppler_norm=0.02)),
    (ChannelModel.MULTIPATH, dict(pdp=(1.0, 0.5, 0.25, 0.125))),
    (ChannelModel.MULTIPATH_TIME, dict(pdp=(1.0, 0.5, 0.25), doppler_norm=0.02)),
]


def _mc_cfg(model, channel, n_fft=256, mod=Modulation.QAM16, S=8, B=40, spread=False):
    return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft, n_fft // 4),
                      channel=ChannelConfig(model=model, ebno_db=8.0, **channel), n_symbols=S,
                      n_channels=B, dft_spread=spread)


@pytest.mark.parametrize("model,channel", _MC_MODELS, ids=lambda v: getattr(v, "value", ""))
@pytest.mark.parametrize("n_fft,spread", [(128, False), (256, True), (512, False),
                                          (1024, False), (2048, False), (4096, False)])
@pytest.mark.parametrize("S", [7, 1])
def test_mc_kernel_keyed_matches_plain(dev, model, channel, n_fft, spread, S):
    """Kernel G (keyed) against its plain twin on the same keys, in each
    of its forms (one warp a symbol with 4, 8 or 16 points a lane up to
    N 512; groups of 2, 4 and 8 warps at N 1024–4096); S = 7 is not a multiple
    of the symbols a block runs at once, S = 1 leaves all but one group
    of a block idle."""
    cfg = _mc_cfg(model, channel, n_fft, S=S, B=24, spread=spread)
    ids = torch.arange(100, 124, dtype=torch.int32, device=dev)
    got = _counted("mc_count", lambda: kg.mc_count(cfg, 2**31 + 77, ids))
    llr, idx = kg.mc_llr_plain(cfg, 2**31 + 77, ids)
    want = kg.count_errors(llr, idx, cfg.modulation.bits_per_symbol)
    if model != ChannelModel.IDENTITY:
        assert int(want.sum()) > 0
    _within_margin(got, llr, want)


@pytest.mark.parametrize("model,channel", _MC_MODELS, ids=lambda v: getattr(v, "value", ""))
@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QAM64, Modulation.QAM1024],
                         ids=lambda m: m.value)
def test_mc_kernel_injected_matches_plain(dev, model, channel, mod):
    cfg = _mc_cfg(model, channel, mod=mod, spread=model == ChannelModel.RAYLEIGH_FLAT)
    B, S, N = 40, 8, 256
    g = torch.Generator(device="cpu").manual_seed(9)
    hs = kg.h_syms(cfg)
    rand = (torch.randint(0, 1 << mod.bits_per_symbol, (B, S, N), generator=g,
                          dtype=torch.int32),
            torch.randn((B, S, N), generator=g), torch.randn((B, S, N), generator=g),
            torch.randn((B, hs, N), generator=g), torch.randn((B, hs, N), generator=g))
    rand = tuple(t.to(dev) for t in rand)
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    got = _counted("mc_count", lambda: kg.mc_count(cfg, 0, ids, rand_inputs=rand))
    llr, idx = kg.mc_llr_plain(cfg, 0, ids, rand_inputs=rand)
    _within_margin(got, llr, kg.count_errors(llr, idx, mod.bits_per_symbol))


@pytest.mark.parametrize("model,channel", _MC_MODELS[1:], ids=lambda v: getattr(v, "value", ""))
def test_mc_kernel_keyed_equals_fast_engine_on_card(dev, model, channel):
    """A keyed pass of kernel G is the fast engine's link for the same
    seed: per-channel counts equal but for near-zero LLRs."""
    cfg = _mc_cfg(model, channel, B=64, S=16)
    ids = torch.arange(64, dtype=torch.int32, device=dev)
    got = kg.mc_count(cfg, 41, ids)
    want, _ = fast.fast_simulate(cfg, 41, device=dev)
    llr, _ = kg.mc_llr_plain(cfg, 41, ids)
    assert int(want.sum()) > 0
    _within_margin(got, llr, want)


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
@pytest.mark.parametrize("model,channel", [_MC_MODELS[2], _MC_MODELS[6]],
                         ids=lambda v: getattr(v, "value", ""))
def test_mc_kernel_counts_depend_only_on_seed_and_channel(dev, model, channel, n_fft):
    """A keyed pass over channels [590, 600) gives the full pass's counts
    there, though the kernel splits a channel's symbols over more blocks
    when it has fewer channels; two runs give the same counts."""
    cfg = _mc_cfg(model, channel, n_fft, S=9, B=600)
    ids = torch.arange(1000, 1600, dtype=torch.int32, device=dev)
    full = kg.mc_count(cfg, 5, ids)
    assert int(full.sum()) > 0
    assert torch.equal(kg.mc_count(cfg, 5, ids), full)
    assert torch.equal(kg.mc_count(cfg, 5, ids[590:].contiguous()), full[590:])


def test_mc_kernel_raises_on_unsupported(dev):
    ids = torch.arange(4, dtype=torch.int32, device=dev)
    for cfg in (_mc_cfg(ChannelModel.AWGN, {}, n_fft=64, B=4),
                _mc_cfg(ChannelModel.AWGN, {}, n_fft=512, B=4, spread=True)):
        with pytest.raises(ValueError):
            kg.mc_count(cfg, 0, ids)
    with pytest.raises(ValueError):
        kg.mc_count(_mc_cfg(ChannelModel.AWGN, {}, B=4), 0, ids.to(torch.int64))


def test_mc_kernel_c_entry_refuses_scfdma_above_256(dev, monkeypatch):
    """The C entry builds SC-FDMA at N 128-256 only: past the wrapper's
    cap it refuses the launch, which raises and counts none."""
    monkeypatch.setattr(kg, "MAX_SPREAD_N_FFT", 4096)
    ids = torch.arange(4, dtype=torch.int32, device=dev)
    before = _lib.LAUNCHES["mc_count"]
    with pytest.raises(RuntimeError, match="mc_count"):
        kg.mc_count(_mc_cfg(ChannelModel.AWGN, {}, n_fft=512, B=4, spread=True), 0, ids)
    assert _lib.LAUNCHES["mc_count"] == before


@pytest.mark.parametrize("n_fft", [256, 1024])
@pytest.mark.parametrize("model", [ChannelModel.AWGN, ChannelModel.MULTIPATH_TIME],
                         ids=lambda m: m.value)
def test_scfdma_fast_simulate_on_card_matches_cpu(dev, model, n_fft):
    """Full-grid SC-FDMA through the fast engine on the card (plain TX,
    kernel E, kernel C's despread) against the CPU run."""
    cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft, n_fft // 4),
                     channel=ChannelConfig(model=model, ebno_db=10.0, pdp=(1.0, 0.5, 0.25),
                                           doppler_norm=0.02),
                     n_symbols=8, n_channels=32, dft_spread=True)
    before = _lib.LAUNCHES["demod_count_despread"]
    got, _ = fast.fast_simulate(cfg, 23, device=dev)
    assert _lib.LAUNCHES["demod_count_despread"] == before + 1
    want, _ = fast.fast_simulate(cfg, 23, device="cpu")
    ids = torch.arange(32, dtype=torch.int32)
    h, _ = fast.fade_state(cfg, 23, ids)
    hb = (torch.ones((32, 1, 1), dtype=torch.complex64) if h is None else h).expand(
        32, 1 if h is None else h.shape[1], n_fft)
    re, im = fast.tx_channel_core(cfg, 23, ids)
    llr = kc.demod_chain(re, im, hb.real, hb.imag, n_fft // 4, cfg.modulation,
                         fast.noise_var(cfg), despread=True)
    assert int(want.sum()) > 0
    _within_margin(got.cpu(), llr, want)


def _llr_close(got, want):
    """Kernel LLRs against the plain plane: 1e-4 of the plane's peak."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("n_fft,h_syms,despread", [(64, 1, False), (256, "S", False),
                                                   (1024, 1, False), (256, 1, True),
                                                   (4096, "S", True), (64, "S", False),
                                                   (128, 1, False), (128, "S", False),
                                                   (512, 1, False), (1024, "S", False),
                                                   (2048, 1, False), (4096, 1, False),
                                                   (4096, "S", False), (64, "S", True),
                                                   (128, 1, True), (128, "S", True),
                                                   (256, "S", True), (512, 1, True),
                                                   (512, "S", True), (1024, 1, True),
                                                   (1024, "S", True), (2048, 1, True),
                                                   (2048, "S", True), (4096, 1, True)])
@pytest.mark.parametrize("B,S", [(20, 7), (203, 33)], ids=["20x7", "203x33"])
def test_demod_llr_and_sum_kernels_match_plain(dev, mod, n_fft, h_syms, despread, B, S):
    """Kernel C's LLR-plane and sum modes (and their despread forms, on
    the tile at N 64 and in the warp-group form at N 128-4096) against
    the plain plane; S = 7 rows is not a multiple of the tile's rows per
    block, S = 33 one past the warp-group form's run of 32 symbols a
    block; h one row a channel or one a symbol; the sum is
    deterministic."""
    cp = n_fft // 4
    h_syms = S if h_syms == "S" else h_syms
    g = torch.Generator(device="cpu").manual_seed(10)
    re, im = ((torch.randn((B, S, n_fft + cp), generator=g) / np.sqrt(2 * n_fft)).to(dev)
              for _ in range(2))
    hr, hi = ((torch.randn((B, h_syms, n_fft), generator=g) * np.sqrt(0.5)).to(dev)
              for _ in range(2))
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    want = kc.demod_chain(re, im, hr, hi, cp, mod, nv, despread=despread)
    got = _counted(kc.llr_counter(False, despread),
                   lambda: kc.demod_llr(re, im, hr, hi, cp, mod, nv, despread=despread))
    assert got.shape == (B, S, n_fft * mod.bits_per_symbol) and got.dtype == torch.float32
    _llr_close(got, want)
    tot = _counted(kc.llr_counter(True, despread),
                   lambda: kc.demod_llr(re, im, hr, hi, cp, mod, nv, reduce_sum=True,
                                        despread=despread))
    assert tot.ndim == 0
    assert abs(float(tot) - float(want.double().sum())) <= 1e-5 * float(want.abs().double().sum())
    again = kc.demod_llr(re, im, hr, hi, cp, mod, nv, reduce_sum=True, despread=despread)
    assert float(again) == float(tot)


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("n_fft", CL_N_FFT)
@CL_SHAPES
def test_demod_llr_cl_kernel_matches_plain(dev, mod, n_fft, B, S):
    """Kernel F's LLR mode, f32 and bf16, against the plain plane in the
    kernel order; bf16 is the f32 plane rounded (sign-identical wherever
    |LLR| ≥ 1e-3)."""
    from sdr_tpu_torch.ops.demod import demod_llr_chain_cl

    cp = n_fft // 4
    g = torch.Generator(device="cpu").manual_seed(11)
    re, im = ((torch.randn((S * (n_fft + cp), B), generator=g) / np.sqrt(2 * n_fft)).to(dev)
              for _ in range(2))
    hr, hi = ((torch.randn((n_fft, B), generator=g) * np.sqrt(0.5)).to(dev) for _ in range(2))
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    want = kd.demod_llr_cl_plain(re, im, hr, hi, cp, mod, nv)
    got = _counted("demod_llr_cl", lambda: kd.demod_llr_cl(re, im, hr, hi, cp, mod, nv))
    assert got.shape == (S * mod.bits_per_symbol * n_fft, B)
    _llr_close(got, want)
    half = _counted("demod_llr_cl_bf16",
                    lambda: kd.demod_llr_cl(re, im, hr, hi, cp, mod, nv,
                                            out_dtype=torch.bfloat16))
    assert half.dtype == torch.bfloat16
    big = got.abs() >= 1e-3
    assert torch.equal((half.float() < 0)[big], (got < 0)[big])
    assert float(((half.float() - got).abs() - got.abs() * 2.0 ** -8).max()) <= 0.0
    pub = demod_llr_chain_cl(re, im, hr, hi, cp, mod, nv)
    assert torch.equal(pub, kd.kernel_to_public(got, S, mod.bits_per_symbol, n_fft))


def _ldpc_llrs(code, n_cw, sigma, seed, dev):
    from sdr_tpu_torch.ops.ldpc import ldpc_encode

    g = torch.Generator(device="cpu").manual_seed(seed)
    info = torch.randint(0, 2, (n_cw, code.k), generator=g, dtype=torch.int8)
    x = 1.0 - 2.0 * ldpc_encode(code, info).float()
    llr = 2.0 * (x + sigma * torch.randn(x.shape, generator=g)) / sigma ** 2
    return llr.to(dev)


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "8,4"])
@pytest.mark.parametrize("schedule,iters", [("flooding", 25), ("layered", 13)])
def test_ldpc_kernel_decisions_equal_plain(dev, rate, schedule, iters):
    """Kernel H, both layouts, against its plain version: identical hard
    bits, at an operating point with residual errors; any batch."""
    from sdr_tpu_torch.link.coded import ldpc_code_for
    from sdr_tpu_torch.ops.ldpc import make_qc_ldpc

    from sdr_tpu_torch.kernels import ldpc as kh

    code = make_qc_ldpc(8, 4, 128) if rate == "8,4" else ldpc_code_for(rate)
    llr = _ldpc_llrs(code, 203, 0.85, 12, dev)
    want = kh.ldpc_decode_plain(code, llr, iters, 0.5, schedule)
    got = _counted(kh.counter_name(schedule, False),
                   lambda: kh.ldpc_decode(code, llr, iters, 0.5, schedule))
    assert got.dtype == torch.int8 and torch.equal(got, want)
    got_t = _counted(kh.counter_name(schedule, True),
                     lambda: kh.ldpc_decode(code, llr.T.contiguous(), iters, 0.5, schedule,
                                            transposed=True))
    assert torch.equal(got_t.T, want)


@pytest.mark.parametrize("batch", [1, 3, 203, 4097])
@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "8,4", "8,4,z100"])
@pytest.mark.parametrize("schedule,iters", [("flooding", 25), ("layered", 13)])
def test_ldpc_kernel_every_batch_and_configuration(dev, batch, rate, schedule, iters):
    """Kernel H against its plain version at batches from 1 to 4097, in
    both layouts, at every stock rate and with a code whose Z (100) is
    not a multiple of 32."""
    from sdr_tpu_torch.link.coded import ldpc_code_for
    from sdr_tpu_torch.ops.ldpc import make_qc_ldpc

    from sdr_tpu_torch.kernels import ldpc as kh

    code = (make_qc_ldpc(8, 4, 100) if rate == "8,4,z100" else
            make_qc_ldpc(8, 4, 128) if rate == "8,4" else ldpc_code_for(rate))
    llr = _ldpc_llrs(code, batch, 0.85, 21, dev)
    want = kh.ldpc_decode_plain(code, llr, iters, 0.5, schedule)
    llr_t = llr.T.contiguous()
    got = _counted(kh.counter_name(schedule, False),
                   lambda: kh.ldpc_decode(code, llr, iters, 0.5, schedule))
    assert torch.equal(got, want)
    got_t = _counted(kh.counter_name(schedule, True),
                     lambda: kh.ldpc_decode(code, llr_t, iters, 0.5, schedule, transposed=True))
    assert torch.equal(got_t.T, want)


def test_ldpc_kernel_raises_by_name_beyond_its_limits(dev):
    """Codes beyond the kernel's tables or loops raise ValueError naming
    the limit; nothing falls back."""
    from sdr_tpu_torch.ops.ldpc import QcLdpcCode, make_qc_ldpc

    from sdr_tpu_torch.kernels import ldpc as kh

    col4 = QcLdpcCode(((0, 0, -1), (1, -1, 0), (2, 0, -1), (3, -1, 0)), 8)
    with pytest.raises(ValueError, match="column degree 4 > 3"):
        kh.ldpc_decode(col4, torch.zeros((2, col4.n), device=dev))
    row17 = QcLdpcCode((tuple([0] * 17 + [-1]), tuple([-1] * 17 + [0])), 8)
    with pytest.raises(ValueError, match="row degree 17 > 16"):
        kh.ldpc_decode(row17, torch.zeros((2, row17.n), device=dev))
    z2048 = make_qc_ldpc(8, 4, 2048)
    with pytest.raises(ValueError, match="Z = 2048 outside 1..1024"):
        kh.ldpc_decode(z2048, torch.zeros((2, z2048.n), device=dev))
    wide = make_qc_ldpc(8, 4, 1024)
    llr = _ldpc_llrs(wide, 5, 0.85, 3, dev)
    got = kh.ldpc_decode(wide, llr, 5, 0.5)  # Z > 512: the wide form, 1024 threads
    assert torch.equal(got, kh.ldpc_decode_plain(wide, llr, 5, 0.5))


@pytest.mark.parametrize("seam", ["staged", "fused"])
@pytest.mark.parametrize("schedule,iters", [("flooding", 25), ("layered", 13)])
def test_coded_engine_on_card_matches_cpu(dev, seam, schedule, iters):
    """The coded link on the card (kernels B, C or F, H) against the same
    link on the CPU (plain versions): info-bit errors equal but in
    codewords holding an LLR with plain |LLR| < 1e-3."""
    from sdr_tpu_torch.link import fast_coded as fc

    cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(256, 64),
                     channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=7.0),
                     n_symbols=12, n_channels=48)
    before = dict(_lib.LAUNCHES)
    got, counted = fc.ldpc_fast_simulate(cfg, 29, iters=iters, schedule=schedule, seam=seam,
                                         device=dev)
    demod = "demod_llr_cl" if seam == "fused" else "demod_llr"
    from sdr_tpu_torch.kernels import ldpc as kh

    for name in (demod, kh.counter_name(schedule, seam == "fused"), "tx"):
        assert _lib.LAUNCHES[name] == before[name] + 1, name
    want, _ = fc.ldpc_fast_simulate(cfg, 29, iters=iters, schedule=schedule, seam="staged",
                                    device="cpu")
    assert int(want.sum()) > 0 and int(counted[0]) == 4 * 1536
    differ = (got.cpu() != want)
    if bool(differ.any()):
        ids = torch.arange(48, dtype=torch.int32)
        re, im = fast.tx_channel_core(cfg, 29, ids)
        h, _ = fast.fade_state(cfg, 29, ids)
        hb = h.expand(48, 1, 256)
        llr = kc.demod_chain(re, im, hb.real, hb.imag, 64, cfg.modulation, fast.noise_var(cfg))
        near = (llr.abs() < 1e-3).any(dim=2).any(dim=1)
        assert bool(near[differ].all())


def test_coded_kernels_raise_instead_of_falling_back(dev):
    from sdr_tpu_torch.kernels import ldpc as kh
    from sdr_tpu_torch.link.coded import ldpc_code_for

    code = ldpc_code_for("1/2")
    with pytest.raises(ValueError):
        kh.ldpc_decode(code, torch.zeros((4, code.n), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        kh.ldpc_decode(code, torch.zeros((4, code.n - 1), device=dev))
    mod = Modulation.QAM16
    with pytest.raises(ValueError):
        kc.demod_llr(*(torch.zeros((2, 2, 96), device=dev),) * 2,
                     *(torch.zeros((2, 1, 64), device=dev),) * 2, 16, mod, 0.1)
    with pytest.raises(ValueError):
        kd.demod_llr_cl(*(torch.zeros((80, 32), device=dev),) * 2,
                        *(torch.zeros((64, 32), device=dev),) * 2, 16, mod, 0.1,
                        out_dtype=torch.float16)


@pytest.mark.parametrize("mod", list(Modulation), ids=lambda m: m.value)
@pytest.mark.parametrize("n_fft,h_syms,S", [(256, 1, 5), (1024, 1, 5), (4096, "S", 5),
                                            (2, 1, 5), (2, "S", 5), (64, 1, 5), (128, "S", 5),
                                            (128, 1, 37), (1024, "S", 37), (2048, 1, 37)])
def test_llr_chain_kernel_matches_plain(dev, mod, n_fft, h_syms, S):
    """Kernel C's post-FFT mode against its plain version: the plane
    within 1e-4 of its peak, the sum within 1e-5 of the sum of |LLR| and
    the same bits twice; S = 37 is one symbol past a block's run of 32.
    demod_chain_hybrid runs it on torch's FFT output in place (the
    interleaved plane): bit for bit the kernel on planar copies of it,
    plane and sum."""
    from sdr_tpu_torch.ops.demod import demod_chain_hybrid
    from sdr_tpu_torch.ops.ofdm import ofdm_rx

    B, cp = 20, max(n_fft // 8, 1)
    h_syms = S if h_syms == "S" else h_syms
    g = torch.Generator(device="cpu").manual_seed(12)
    yr, yi = (torch.randn((B, S, n_fft), generator=g).to(dev) * 0.7 for _ in range(2))
    hr, hi = ((torch.randn((B, h_syms, n_fft), generator=g) * np.sqrt(0.5)).to(dev)
              for _ in range(2))
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    want = kc.llr_chain_plain(yr, yi, hr, hi, mod, nv)
    got = _counted("llr_chain", lambda: kc.llr_chain(yr, yi, hr, hi, mod, nv))
    assert got.shape == (B, S, n_fft * mod.bits_per_symbol)
    _llr_close(got, want)
    tot = _counted("llr_chain_sum", lambda: kc.llr_chain(yr, yi, hr, hi, mod, nv,
                                                         reduce_sum=True))
    assert abs(float(tot) - float(want.double().sum())) <= 1e-5 * float(want.abs().double().sum())
    assert float(kc.llr_chain(yr, yi, hr, hi, mod, nv, reduce_sum=True)) == float(tot)
    re, im = ((torch.randn((B, S, n_fft + cp), generator=g) / np.sqrt(2 * n_fft)).to(dev)
              for _ in range(2))
    hyb = _counted("llr_chain", lambda: demod_chain_hybrid(re, im, hr, hi, cp, mod, nv))
    _llr_close(hyb, kc.demod_chain(re, im, hr, hi, cp, mod, nv))
    y = ofdm_rx(torch.complex(re, im), cp)
    planar = (y.real.contiguous(), y.imag.contiguous(), hr, hi, mod, nv)
    assert torch.equal(hyb, kc.llr_chain(*planar))
    hyb_sum = _counted("llr_chain_sum", lambda: demod_chain_hybrid(re, im, hr, hi, cp, mod, nv,
                                                                   reduce_sum=True))
    assert float(hyb_sum) == float(kc.llr_chain(*planar, reduce_sum=True))


@pytest.mark.parametrize("n_fft,cp,mod", [(1024, 128, Modulation.QAM64),
                                          (4096, 512, Modulation.QAM16)],
                         ids=["config3", "config5"])
def test_wideband_tx_and_count_kernels_match_plain(dev, n_fft, cp, mod):
    """Kernels B (every channel mode) and C (count) at configs 3 and 5's
    N, against their plain versions; the FIR has config 5's 5 taps."""
    B, S = 24, 6
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(S, n_fft, mod.bits_per_symbol, 13, ids)
    nv = 1.0 / (10 ** 1.2 * mod.bits_per_symbol)
    g = torch.Generator(device="cpu").manual_seed(13)
    flat = tuple(torch.randn(B, generator=g).to(dev) for _ in range(2))
    per_sym = tuple(torch.randn((B, S), generator=g).to(dev) for _ in range(2))
    taps = tuple((torch.randn((B, 5), generator=g) * 0.4).to(dev) for _ in range(2))
    for name, kw in (("tx", {}), ("tx", dict(hs_r=flat[0], hs_i=flat[1])),
                     ("tx", dict(hs_r=per_sym[0], hs_i=per_sym[1])),
                     ("tx_taps", dict(taps_r=taps[0], taps_i=taps[1]))):
        got = _counted(name, lambda: kb.tx_channel(idx, cp, mod, noise_var=nv / n_fft, seed=13,
                                                   ch_ids=ids, **kw))
        want = kb.tx_channel_plain(idx, cp, mod, noise_var=nv / n_fft, seed=13, ch_ids=ids, **kw)
        peak = max(float(w.abs().max()) for w in want)
        assert max(float((a - b).abs().max()) for a, b in zip(got, want)) <= 1e-5 * peak
    re, im = got
    hr, hi = (torch.ones((B, 1, n_fft), device=dev), torch.zeros((B, 1, n_fft), device=dev))
    got_c = _counted("demod_count", lambda: kc.demod_count(re, im, hr, hi, idx, cp, mod, nv))
    llr = kc.demod_chain(re, im, hr, hi, cp, mod, nv)
    assert int(kc.count_errors(llr, idx, mod.bits_per_symbol).sum()) > 0
    _within_margin(got_c, llr, kc.count_errors(llr, idx, mod.bits_per_symbol))


@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
                                 Modulation.QAM64], ids=lambda m: m.value)
@pytest.mark.parametrize("n2,n1d,h_syms,S", [(64, 1, 1, 3), (64, 2, "S", 3), (1024, 1, "S", 3),
                                             (1024, 4, 1, 3), (4096, 1, 1, 3),
                                             (4096, 1, "S", 3), (128, 1, 1, 3),
                                             (512, 2, "S", 3), (1024, 4, 1, 37),
                                             (1024, 4, "S", 37)])
def test_tp_stage2_kernel_matches_plain(dev, mod, n2, n1d, h_syms, S):
    """Kernel C's TP stage-2 mode (#20; the tile at n2 64, the warp-group
    form from n2 128): LLRs within 1e-4 of the plain version's peak, equal
    signs where |LLR| ≥ 1e-3, the noise variance a 0-d tensor on the card
    (two values through the same inputs); S = 37 splits a digit row's
    run over two blocks, the second one short. The rows have the TP path's
    scale (variance 1/n2: a unit-energy grid after the transform)."""
    B = 3
    h_syms = S if h_syms == "S" else h_syms
    g = torch.Generator(device=dev).manual_seed(n2 + n1d)
    tr, ti = (torch.randn((B, S, n1d, n2), device=dev, generator=g) * (0.5 / n2) ** 0.5
              for _ in range(2))
    hr, hi = (torch.randn((B, h_syms, n1d, n2), device=dev, generator=g) * 0.7 for _ in range(2))
    for nv in (0.05, 0.5):
        nv_t = torch.tensor(nv, dtype=torch.float32, device=dev)
        got = _counted("tp_stage2_llr", lambda: kc.tp_stage2_llr(tr, ti, hr, hi, nv_t, mod))
        want = kc.stage2_llr_plain(tr, ti, hr, hi, nv_t, mod)
        assert got.shape == (B, S, n1d, n2 * mod.bits_per_symbol)
        peak = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * peak
        big = want.abs() >= 1e-3
        assert torch.equal((got < 0)[big], (want < 0)[big])


def test_tp_stage2_kernel_raises_instead_of_falling_back(dev):
    t = torch.zeros((2, 2, 1, 64), device=dev)
    h = torch.ones((2, 1, 1, 64), device=dev)
    with pytest.raises(ValueError, match="unsupported shapes"):
        kc.tp_stage2_llr(t, t, h[..., :32], h[..., :32], 0.1, Modulation.QPSK)
    with pytest.raises(ValueError, match="float32"):
        kc.tp_stage2_llr(t.double(), t.double(), h, h, 0.1, Modulation.QPSK)


@pytest.mark.parametrize("n_fft", CL_N_FFT)
def test_cl_kernels_on_bf16_samples_match_plain(dev, n_fft):
    """D's sum, F's count and F's plane on bfloat16 sample planes against
    their plain versions on the same planes, with their own counters."""
    mod, B, S, cp = Modulation.QAM16, 37, 3, n_fft // 8
    g = torch.Generator(device=dev).manual_seed(n_fft)
    re, im = (torch.randn((S * (n_fft + cp), B), device=dev, generator=g) / (2 * n_fft) ** 0.5
              for _ in range(2))
    rb, ib = re.to(torch.bfloat16), im.to(torch.bfloat16)
    hr, hi = (torch.randn((n_fft, B), device=dev, generator=g) * 0.5 ** 0.5 for _ in range(2))
    idx = torch.randint(0, 16, (S * n_fft, B), device=dev, generator=g, dtype=torch.int8)
    nv = 0.05
    tot = _counted("demod_sum_cl_in_bf16", lambda: kd.demod_sum_cl(rb, ib, hr, hi, cp, mod, nv))
    want = kd.demod_sum_cl_plain(rb, ib, hr, hi, cp, mod, nv)
    assert abs(float(tot) - float(want)) <= 1e-4 * abs(float(want))
    assert float(kd.demod_sum_cl(rb, ib, hr, hi, cp, mod, nv)) == float(tot)  # deterministic
    cnt = _counted("demod_count_cl_in_bf16",
                   lambda: kd.demod_count_cl(rb, ib, hr, hi, idx, cp, mod, nv))
    plane = kd.demod_llr_cl_plain(rb, ib, hr, hi, cp, mod, nv)
    margin = (plane.abs() < 1e-3).sum(dim=0)
    assert bool(((cnt - kd.demod_count_cl_plain(rb, ib, hr, hi, idx, cp, mod, nv)).abs()
                 <= margin).all())
    f32 = _counted("demod_llr_cl_in_bf16", lambda: kd.demod_llr_cl(rb, ib, hr, hi, cp, mod, nv))
    assert float((f32 - plane).abs().max()) <= 1e-4 * float(plane.abs().max())
    half = _counted("demod_llr_cl_bf16_in_bf16",
                    lambda: kd.demod_llr_cl(rb, ib, hr, hi, cp, mod, nv, out_dtype=torch.bfloat16))
    assert half.dtype == torch.bfloat16
    assert float(((half.float() - f32).abs() - f32.abs() * 2.0 ** -8).max()) <= 0.0
    big = plane.abs() >= 1e-3
    assert torch.equal((half.float() < 0)[big], (plane < 0)[big])


@pytest.mark.parametrize("n_fft", [64, 256, 512] + CL_WIDE_N_FFT)
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cl_kernels_below_one_group_match_plain(dev, n_fft, in_dtype):
    """Both plans with B = 3 channels (below one group) and S one past a
    symbol run (33 narrow, 17 wide): D's sum within 1e-5 of the sum of
    |LLR| (C's sum rule: a 3-channel sum may cancel) and the same bits
    twice, F's count within the |LLR| < 1e-3 bits, F's plane within 1e-4 of
    its peak (bf16 out: sign-identical wherever |LLR| >= 1e-3), each
    counter moved."""
    mod, B, cp = Modulation.QAM64, 3, n_fft // 8
    S = 33 if n_fft <= 512 else 17
    g = torch.Generator(device=dev).manual_seed(n_fft + 1)
    re, im = ((torch.randn((S * (n_fft + cp), B), device=dev, generator=g)
               / (2 * n_fft) ** 0.5).to(in_dtype) for _ in range(2))
    hr, hi = (torch.randn((n_fft, B), device=dev, generator=g) * 0.5 ** 0.5 for _ in range(2))
    idx = torch.randint(0, 64, (S * n_fft, B), device=dev, generator=g, dtype=torch.int8)
    nv = 0.02
    tag = "_in_bf16" if in_dtype == torch.bfloat16 else ""
    plane = kd.demod_llr_cl_plain(re, im, hr, hi, cp, mod, nv)
    tot = _counted("demod_sum_cl" + tag, lambda: kd.demod_sum_cl(re, im, hr, hi, cp, mod, nv))
    want = kd.demod_sum_cl_plain(re, im, hr, hi, cp, mod, nv)
    assert abs(float(tot) - float(want)) <= 1e-5 * float(plane.abs().double().sum())
    assert float(kd.demod_sum_cl(re, im, hr, hi, cp, mod, nv)) == float(tot)
    cnt = _counted("demod_count_cl" + tag,
                   lambda: kd.demod_count_cl(re, im, hr, hi, idx, cp, mod, nv))
    margin = (plane.abs() < 1e-3).sum(dim=0)
    want_cnt = kd.demod_count_cl_plain(re, im, hr, hi, idx, cp, mod, nv)
    assert int(want_cnt.sum()) > 0
    assert bool(((cnt - want_cnt).abs() <= margin).all())
    f32 = _counted("demod_llr_cl" + tag, lambda: kd.demod_llr_cl(re, im, hr, hi, cp, mod, nv))
    _llr_close(f32, plane)
    half = _counted("demod_llr_cl_bf16" + tag,
                    lambda: kd.demod_llr_cl(re, im, hr, hi, cp, mod, nv, out_dtype=torch.bfloat16))
    big = plane.abs() >= 1e-3
    assert torch.equal((half.float() < 0)[big], (plane < 0)[big])


def test_twiddles_are_built_once_per_size_and_device(dev):
    """The kernels' twiddle tables are cached per (n, device): two calls
    give the same tensors, bit-identical to a table built anew."""
    d = torch.empty(1, device=dev).device
    first, again = _lib.twiddles(256, d), _lib.twiddles(256, d)
    assert first[0] is again[0] and first[1] is again[1]
    fresh = _lib.twiddles.__wrapped__(256, d)
    assert torch.equal(first[0], fresh[0]) and torch.equal(first[1], fresh[1])
    assert _lib.twiddles(512, d)[0].shape == (256,)


# Kernel B's pilot comb and kernel C's pilot-skipping count (the comb-pilot
# link's TX and count): on the tile (N 16, 64) and the warp-group form
# (N 256, 1024), at spacings that divide N and one that does not (3).
COMB_N = [16, 64, 256, 1024]
COMB_SPACING = [4, 8, 3]


@pytest.mark.parametrize("spacing", COMB_SPACING)
@pytest.mark.parametrize("N", COMB_N)
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64],
                         ids=lambda m: m.value)
def test_tx_comb_kernel_matches_plain(dev, mod, N, spacing):
    """B with the comb, channel off and with per-symbol gains and keyed
    noise: 1e-5 of the peak (the channel-off and keyed rule). The pilot
    tones' indices are not read: a grid with other values there gives the
    same samples, bit for bit."""
    B, S, cp = 203, 33, N // 4
    idx = _tx_indices(dev, B, S, N, mod, "payload", 6)
    g = torch.Generator(device="cpu").manual_seed(6)
    gains = tuple(torch.randn((B, S), generator=g).to(dev) for _ in range(2))
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    for kw in (dict(), dict(hs_r=gains[0], hs_i=gains[1], noise_var=1e-3, seed=3, ch_ids=ids)):
        got = _counted("tx_comb", lambda: kb.tx_channel(idx, cp, mod, pilot_spacing=spacing, **kw))
        _tx_close(got, kb.tx_channel_plain(idx, cp, mod, pilot_spacing=spacing, **kw), True)
    other = idx.clone()
    other[..., ::spacing] = 0
    assert all(torch.equal(a, b) for a, b in zip(
        kb.tx_chain(idx, cp, mod, pilot_spacing=spacing),
        kb.tx_chain(other, cp, mod, pilot_spacing=spacing)))


@pytest.mark.parametrize("spacing", COMB_SPACING)
@pytest.mark.parametrize("N", COMB_N)
@pytest.mark.parametrize("h_syms", [1, "S"])
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16], ids=lambda m: m.value)
def test_demod_count_comb_kernel_matches_plain(dev, mod, h_syms, N, spacing):
    """C's count skipping the comb's tones, on the h plane and on taps=,
    against the plain count over the data tones: within the bits whose
    plain |LLR| < 1e-3 there. Errors placed on the pilot tones alone are
    not counted."""
    from sdr_tpu_torch.ops.pilots import data_tones

    B, S, cp = 203, 33, N // 4
    h_syms = S if h_syms == "S" else h_syms
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(S, N, mod.bits_per_symbol, 4, ids)
    nv = 1.0 / (10 ** 0.8 * mod.bits_per_symbol)
    g = torch.Generator(device="cpu").manual_seed(8)
    hr = torch.randn((B, h_syms, N), generator=g).to(dev)
    hi = torch.randn((B, h_syms, N), generator=g).to(dev)
    re, im = kb.tx_channel(idx, cp, mod, noise_var=nv / N, seed=4, ch_ids=ids,
                           pilot_spacing=spacing)
    got = _counted("demod_count_comb", lambda: kc.demod_count(re, im, hr, hi, idx, cp, mod, nv,
                                                              pilot_spacing=spacing))
    llr = data_tones(kc.demod_chain(re, im, hr, hi, cp, mod, nv), spacing, mod.bits_per_symbol)
    want = kc.count_errors(llr, data_tones(idx, spacing), mod.bits_per_symbol)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    assert int(want.sum()) > 0 and bool(((got - want).abs() <= margin).all())
    assert torch.equal(want, kc.demod_count_plain(re, im, hr, hi, idx, cp, mod, nv,
                                                  pilot_spacing=spacing))
    wrong = idx.clone()
    wrong[..., ::spacing] ^= 1
    assert torch.equal(kc.demod_count(re, im, hr, hi, wrong, cp, mod, nv, pilot_spacing=spacing),
                       got)
    taps = tuple(torch.randn((B, S, 3), generator=g).to(dev) for _ in range(2))
    got_t = _counted("demod_count_comb", lambda: kc.demod_count(
        re, im, None, None, idx, cp, mod, nv, taps=taps, pilot_spacing=spacing))
    want_t = kc.demod_count_plain(re, im, None, None, idx, cp, mod, nv, taps=taps,
                                  pilot_spacing=spacing)
    tr, ti = kc.taps_plane(taps, N)
    llr_t = data_tones(kc.demod_chain(re, im, tr, ti, cp, mod, nv), spacing, mod.bits_per_symbol)
    assert bool(((got_t - want_t).abs() <= (llr_t.abs() < 1e-3).sum(dim=(1, 2))).all())


def test_comb_wrappers_raise_on_spacings_outside_the_grid(dev):
    """B and C refuse a spacing outside [2, N] (and C the comb with the
    despread) before any launch; nothing falls back."""
    N, cp, mod = 256, 64, Modulation.QAM16
    ids = torch.arange(8, dtype=torch.int32, device=dev)
    idx = ka.payload_idx(4, N, mod.bits_per_symbol, 1, ids)
    re, im = kb.tx_chain(idx, cp, mod)
    h = torch.ones((8, 1, N), device=dev)
    before = dict(_lib.LAUNCHES)
    for bad in (1, -4, N + 1):
        with pytest.raises(ValueError, match="pilot_spacing"):
            kb.tx_chain(idx, cp, mod, pilot_spacing=bad)
        with pytest.raises(ValueError, match="pilot_spacing"):
            kc.demod_count(re, im, h, 0 * h, idx, cp, mod, 0.1, pilot_spacing=bad)
    with pytest.raises(ValueError, match="despread"):
        kc.demod_count(re, im, h, 0 * h, idx, cp, mod, 0.1, despread=True, pilot_spacing=4)
    assert _lib.LAUNCHES == before


def _pilot_cfg(**kw):
    from sdr_tpu_torch.core.config import ChannelEstimator

    kw.setdefault("pilot_spacing", 8)
    kw.setdefault("estimator", ChannelEstimator.DFT)
    return _pipeline_cfg(**kw)


@pytest.mark.parametrize("case", ["comb_dft", "comb_ls_rayleigh_time", "block_dft",
                                  "block_interp_full"])
def test_pilot_pipeline_on_card_matches_cpu(dev, case):
    """A pilot link on the card (A, B's comb or the block TX, E, the torch
    FFT and estimate, C's comb or despread count) counts what the CPU run
    counts but for bits whose |LLR| < 1e-3, through the comb modes."""
    from sdr_tpu_torch.core.config import ChannelEstimator
    from sdr_tpu_torch.link import pipeline

    cfg = {
        "comb_dft": lambda: _pilot_cfg(),
        "comb_ls_rayleigh_time": lambda: _pilot_cfg(model=ChannelModel.RAYLEIGH_TIME,
                                                    estimator=ChannelEstimator.LS),
        "block_dft": lambda: _pilot_cfg(pilot_spacing=4, dft_spread=True, ebno_db=14.0),
        "block_interp_full": lambda: _pilot_cfg(model=ChannelModel.MULTIPATH_TIME,
                                                pilot_spacing=4, dft_spread=True),
    }[case]()
    _lib.reset_launches()
    res = pipeline.simulate(cfg, 7, device=dev)
    torch.cuda.synchronize()
    launched = {k for k, v in _lib.LAUNCHES.items() if v}
    want_launched = {"demod_count_despread"} if cfg.dft_spread else {"tx_comb", "demod_count_comb"}
    assert want_launched <= launched and "payload" in launched, launched
    cpu = pipeline.simulate(cfg, 7, device="cpu", want_llrs=True)
    margin = (cpu.llrs.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((res.bit_errors.cpu() - cpu.bit_errors).abs() <= margin).all())
    assert torch.equal(res.bits_counted.cpu(), cpu.bits_counted) and int(cpu.bit_errors.sum()) > 0


@pytest.mark.parametrize("case", ["acq_awgn", "acq_multipath_pa", "pn_iq_comb",
                                  "acq_block_pa"])
def test_impaired_pipeline_on_card_matches_cpu(dev, case):
    """An impaired link on the card (A, B's comb or the block TX, E's
    channel and its noise row, the torch front end and acquisition, C's
    comb or despread count) counts what the CPU run counts but for bits
    whose |LLR| < 1e-3."""
    from sdr_tpu_torch.link import pipeline

    acq = dict(cfo_subcarriers=1.3, timing_offset=37)
    kw = {"acq_awgn": dict(model=ChannelModel.AWGN, **acq),
          "acq_multipath_pa": dict(pa_ibo_db=6.0, **acq),
          "pn_iq_comb": dict(phase_noise_std=1e-3, iq_gain=1.05, iq_phase_rad=0.03),
          "acq_block_pa": dict(pilot_spacing=4, dft_spread=True, ebno_db=14.0, pa_ibo_db=6.0,
                               **acq)}[case]
    channel = {k: kw.pop(k) for k in list(kw) if k in (
        "cfo_subcarriers", "timing_offset", "pa_ibo_db", "phase_noise_std", "iq_gain",
        "iq_phase_rad")}
    cfg = _pilot_cfg(**kw)
    cfg = dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel, **channel))
    _lib.reset_launches()
    res = pipeline.simulate(cfg, 7, device=dev)
    torch.cuda.synchronize()
    launched = {k for k, v in _lib.LAUNCHES.items() if v}
    want = {"demod_count_despread"} if cfg.dft_spread else {"tx_comb", "demod_count_comb"}
    assert want | {"payload"} <= launched and launched & {"fade_awgn", "fade_awgn_fir"}, launched
    if cfg.channel.impaired:
        assert "fade_awgn" in launched  # the acquired stream's noise row
    cpu = pipeline.simulate(cfg, 7, device="cpu", want_llrs=True)
    margin = (cpu.llrs.abs() < 1e-3).sum(dim=(1, 2))
    assert bool(((res.bit_errors.cpu() - cpu.bit_errors).abs() <= margin).all())
    assert torch.equal(res.bits_counted.cpu(), cpu.bits_counted)


def test_fade_awgn_noise_row_off_the_grid(dev):
    """E's noise-only mode on one odd-length row a channel (the acquired
    stream's (B, 1, T) shape, off the 16-byte grid): injected noise equal
    to the plain version within 1e-5 of the peak, keyed noise too."""
    B, T = 64, 21477
    g = torch.Generator(device="cpu").manual_seed(5)
    row = tuple(torch.randn((B, 1, T), generator=g).to(dev) for _ in range(2))
    noise = tuple(torch.randn((B, 1, T), generator=g).to(dev) for _ in range(2))
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    for kw in (dict(noise=noise), dict(seed=3, ch_ids=ids)):
        got = ke.fade_awgn(*row, noise_var=0.01, **kw)
        want = ke.fade_awgn_plain(*row, noise_var=0.01, **kw)
        peak = max(float(w.abs().max()) for w in want)
        assert max(float((a - b).abs().max()) for a, b in zip(got, want)) <= 1e-5 * peak


@pytest.mark.parametrize("model,counter", [
    (ChannelModel.RAYLEIGH_FLAT, "fade_awgn"), (ChannelModel.RAYLEIGH_TIME, "fade_awgn"),
    (ChannelModel.MULTIPATH, "fade_awgn_fir"), (ChannelModel.MULTIPATH_TIME, "fade_awgn_fir")])
def test_fade_awgn_channel_only_on_the_acquired_plane(dev, model, counter):
    """E's channel-only mode (no noise) on the acquired link's
    (B, S+3, N+cp) plane at S = 64 (67 rows: a partial run of E's
    32-symbol blocks), with ``pipeline.acquired_plane``'s inputs — per-link
    gains, per-symbol gains with a unit tail row, static taps, per-symbol
    taps with the last row repeated — within 1e-5 of the plain version's
    peak."""
    from sdr_tpu_torch.link import pipeline

    cfg = _pilot_cfg(model=model, B=24, S=64)
    cfg = dataclasses.replace(cfg, channel=dataclasses.replace(
        cfg.channel, cfo_subcarriers=1.3, timing_offset=37))
    ids = torch.arange(100, 124, dtype=torch.int32, device=dev)
    plane, kw = pipeline.acquired_plane(cfg, 7, ids, pipeline.draw_idx(cfg, 7, ids))
    assert plane[0].shape == (24, 67, 320) and kw is not None
    got = _counted(counter, lambda: ke.fade_awgn(*plane, **kw))
    want = ke.fade_awgn_plain(*plane, **kw)
    peak = max(float(w.abs().max()) for w in want)
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) <= 1e-5 * peak


def test_dft_projections_on_card_stay_full_f32(dev):
    """The DFT estimators' products run in full float32 on the card even
    with TF32 switched on globally (``ops.pilots._project`` holds it off):
    within 1e-5 of the peak of a float64 reference, where TF32's 10-bit
    mantissa would miss by about 1e-3; the flag is restored."""
    from sdr_tpu_torch.ops import pilots as pil

    g = np.random.default_rng(3)
    y = (g.standard_normal((512, 64, 256)) + 1j * g.standard_normal((512, 64, 256))).astype(
        np.complex64)
    pidx = list(pil.pilot_indices(256, 8))
    want = (y[..., pidx].astype(np.complex128) / pil.PILOT_VALUE) @ pil._dft_projection(
        256, 8, 32).astype(np.complex128)
    y_pil = y[:, :4]
    want_b = y_pil.astype(np.complex128) * np.conj(pil.zadoff_chu(256)).astype(np.complex128)
    want_b = want_b.mean(axis=-2) @ pil._dft_projection_full(256, 65).astype(np.complex128)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = pil.estimate_dft_comb(torch.from_numpy(y).to(dev), 8, 32, per_symbol=True)
        got_b = pil.estimate_block_pilots(torch.from_numpy(y_pil).to(dev), 65)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in ((got, want), (got_b, want_b)):
        err = float(np.abs(a.cpu().numpy() - b).max())
        assert err <= 1e-5 * float(np.abs(b).max()), err


@pytest.mark.parametrize("family", ["conv", "ldpc", "polar"])
def test_coded_links_on_card_match_the_cpu(dev, family):
    """A coded link (item 11f) on the card against the CPU. The decoder on
    the card decodes the card's LLRs as the CPU decodes them, bit for bit
    (Viterbi and polar are plain torch with no reduction whose order could
    differ; kernel H's decisions are its plain version's). The link's LLRs
    (``coded.frame_llrs`` on the same frames) are within C's plane
    tolerance of the CPU's, 1e-4 of the peak; so the counts may differ, per
    channel, by at most the info bits of the codewords that hold a coded
    bit whose CPU |LLR| < 1e-3 (C's sure threshold), and not elsewhere. The
    card's call launches B off, E and C's LLR plane (and H for LDPC)."""
    from sdr_tpu_torch.core.config import Equalizer
    from sdr_tpu_torch.link import coded
    from sdr_tpu_torch.ops.fec import depuncture, viterbi_decode
    from sdr_tpu_torch.ops.ldpc import ldpc_decode

    cfg = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(64, 16),
                     channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=5.0,
                                           pdp=(1.0, 0.5, 0.25)),
                     equalizer=Equalizer.MMSE, n_symbols=32, n_channels=64)
    B, fb = cfg.n_channels, coded.frame_bits(cfg)
    frames = torch.randint(0, 2, (B, fb), dtype=torch.int8,
                           generator=torch.Generator().manual_seed(3))
    ids = torch.arange(B, dtype=torch.int32)
    _lib.reset_launches()
    llr_d = coded.frame_llrs(cfg, 7, ids.to(dev), frames.to(dev))
    torch.cuda.synchronize()
    assert {k for k, v in _lib.LAUNCHES.items() if v} == {"tx_off", "fade_awgn_fir",
                                                          "demod_llr"}
    llr_c = coded.frame_llrs(cfg, 7, ids, frames)
    peak = float(llr_c.abs().max())
    assert float((llr_d.cpu() - llr_c).abs().max()) <= 1e-4 * peak
    # The decoder alone on the card's LLRs (the first sent bits of a frame).
    if family == "conv":
        n_info = coded.info_bits_per_channel(cfg)
        x = depuncture(llr_d[:, :2 * (n_info + 6)], "1/2", n_info + 6)
        got = viterbi_decode(x, n_info)
        want = viterbi_decode(x.cpu(), n_info)
    elif family == "ldpc":
        code = coded.ldpc_code_for("1/2")
        x = llr_d[:, :code.n * (fb // code.n)].reshape(-1, code.n)
        got, want = ldpc_decode(code, x, 25), ldpc_decode(code, x.cpu(), 25)
    else:
        code = coded.polar_code_for("1/2")
        x = llr_d.reshape(B, -1, 256)
        got = coded.polar_decode_passes(x, code, 8)
        want = coded.polar_decode_passes(x.cpu(), code, 8)
    assert torch.equal(got.cpu(), want)
    # The link, keyed, on both devices.
    core = coded.family_core(cfg, family)
    _lib.reset_launches()
    e_d, c_d = core(9, ids.to(dev))
    torch.cuda.synchronize()
    launched = {k for k, v in _lib.LAUNCHES.items() if v}
    assert launched == {"tx_off", "fade_awgn_fir", "demod_llr"} | (
        {"ldpc_minsum"} if family == "ldpc" else set()), launched
    e_c, c_c = core(9, ids)
    assert torch.equal(c_d.cpu(), c_c)
    # The allowance: the info bits of each codeword with a coded bit whose
    # CPU |LLR| < 1e-3 (the keyed link's sent bits, in codeword order).
    from sdr_tpu_torch.core import prng
    from sdr_tpu_torch.ops.fec import conv_encode
    from sdr_tpu_torch.ops.ldpc import ldpc_encode
    from sdr_tpu_torch.ops.polar import polar_encode_payload

    if family == "conv":
        n_cw, k = 1, coded.info_bits_per_channel(cfg)
        cw = conv_encode(prng.info_bits(9, ids, 1, k)[:, 0])
    elif family == "ldpc":
        code = coded.ldpc_code_for("1/2")
        n_cw, k = fb // code.n, code.k
        cw = ldpc_encode(code, prng.info_bits(9, ids, n_cw, k)).reshape(B, -1)
    else:
        code = coded.polar_code_for("1/2")
        n_cw, k = fb // 256, code.payload_len
        cw = polar_encode_payload(prng.info_bits(9, ids, n_cw, k), code).reshape(B, -1)
    weak = (coded._carry(cfg, 9, ids, cw, {}).abs() < 1e-3).reshape(B, n_cw, -1).any(dim=-1)
    allowance = weak.sum(dim=1) * k
    assert bool(((e_d.cpu() - e_c).abs() <= allowance).all())
    assert int(e_c.sum()) > 0


def _packet_case(fec):
    from sdr_tpu_torch.link import packet

    pc = packet.PacketConfig(fec=fec)  # the modem's defaults: 64 bytes, QPSK, N 64, CP 16
    ch = ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=6.0, pdp=(1.0, 0.5),
                       cfo_subcarriers=1.3, timing_offset=37)
    return packet, pc, ch


@pytest.mark.parametrize("fec", ["conv", "ldpc", "polar"])
def test_packet_campaign_on_card_matches_the_cpu(dev, fec):
    """A packet campaign (item 11g) of 256 packets at 6 dB on the card
    against the CPU. The card's call launches B's comb, E (the channel
    over the burst plane, the noise row) and C's LLR plane (and H for
    LDPC). The acquired starts are equal; the decoder's input LLRs within
    C's plane tolerance, 1e-4 of the peak; the decoder on the card decodes
    the card's LLRs as the CPU decodes them, bit for bit; so the payloads
    and crc_ok of the two campaigns differ at most in packets holding a
    coded bit whose CPU |LLR| < 1e-3 (C's sure threshold)."""
    packet, pc, ch = _packet_case(fec)
    n = 256
    _lib.reset_launches()
    errs_d, ok_d = packet.simulate_packets(pc, ch, 5, n, device=dev)
    torch.cuda.synchronize()
    launched = {k for k, v in _lib.LAUNCHES.items() if v}
    assert launched == {"tx_comb", "fade_awgn_fir", "fade_awgn", "demod_llr"} | (
        {"ldpc_minsum"} if fec == "ldpc" else set()), launched
    errs_c, ok_c = packet.simulate_packets(pc, ch, 5, n, device="cpu")
    ids = torch.arange(n, dtype=torch.int32)
    burst = packet.encode_packet(pc, packet.draw_payload(pc, 5, ids))
    stream_c, nv = packet.transmit_over_channel(pc, ch, 5, burst, ids)
    stream_d, _ = packet.transmit_over_channel(pc, ch, 5, burst.to(dev), ids.to(dev))
    assert float((stream_d.cpu() - stream_c).abs().max()) <= 1e-5 * float(stream_c.abs().max())
    start_c, planes_c = packet._acquire(pc, stream_c)
    start_d, planes_d = packet._acquire(pc, stream_d)
    assert torch.equal(start_d.cpu(), start_c)
    llr_c = packet.sent_llrs(pc, planes_c, nv)
    llr_d = packet.sent_llrs(pc, planes_d, nv)
    assert float((llr_d.cpu() - llr_c).abs().max()) <= 1e-4 * float(llr_c.abs().max())
    assert torch.equal(packet._fec_decode(pc, llr_d).cpu(), packet._fec_decode(pc, llr_d.cpu()))
    weak = (llr_c.abs() < 1e-3).any(dim=1)
    same = (errs_d.cpu() == errs_c) & (ok_d.cpu() == ok_c)
    assert bool((same | weak).all())
    assert 0 < int(ok_c.sum()) < n  # right and wrong decodes both compared


def test_packet_kernels_at_packet_shapes_match_plain(dev):
    """The kernels a packet campaign runs, at its shapes (64-byte conv 1/2
    packets, 10 symbols of N 64 + CP 16, B 512): B's comb (1e-5 of the
    peak), E's channel alone over the (B, 13, 80) burst plane with static
    taps, per-symbol taps with the last row repeated and flat gains, E's
    keyed noise over the (B, 1, T) stream row (1e-5 of the peak), C's LLR
    plane on the tracked comb estimate h (B, S, N) (1e-4 of the peak)."""
    from sdr_tpu_torch.link import pipeline

    packet, pc, _ = _packet_case("conv")
    B, S, L = 512, pc.n_symbols, pc.ofdm.symbol_len
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    payload = packet.draw_payload(pc, 3, ids)
    cfg = pc._link_cfg()
    bits = torch.randint(0, 2, (B, S, cfg.bits_per_ofdm_symbol), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(4)).to(dev)
    idx = pipeline._grid_of(cfg, pipeline._bits_to_ints(bits, 2).to(ka.out_dtype(2)))
    got = _counted("tx_comb", lambda: kb.tx_chain(idx, 16, Modulation.QPSK, pilot_spacing=8))
    _tx_close(got, kb.tx_channel_plain(idx, 16, Modulation.QPSK, pilot_spacing=8), True)
    burst = packet.encode_packet(pc, payload)
    n_rows = burst.shape[1] // L
    for model, counter in ((ChannelModel.MULTIPATH, "fade_awgn_fir"),
                           (ChannelModel.MULTIPATH_TIME, "fade_awgn_fir"),
                           (ChannelModel.RAYLEIGH_FLAT, "fade_awgn")):
        ch = ChannelConfig(model=model, ebno_db=10.0, pdp=(1.0, 0.5, 0.25), doppler_norm=0.02)
        kw = packet._fading(pc, ch, 3, ids, None, n_rows)
        re, im = fast._planar(burst.reshape(B, n_rows, L))
        z = torch.zeros((B, 1, L), device=dev)
        plane = (torch.cat([re, z], 1).contiguous(), torch.cat([im, z], 1).contiguous())
        got = _counted(counter, lambda: ke.fade_awgn(*plane, **kw))
        want = ke.fade_awgn_plain(*plane, **kw)
        peak = max(float(w.abs().max()) for w in want)
        assert max(float((a - b).abs().max()) for a, b in zip(got, want)) <= 1e-5 * peak
    ch = ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0, cfo_subcarriers=1.3,
                       timing_offset=37)
    stream, nv = packet.transmit_over_channel(pc, ch, 3, burst, ids)
    row = fast._planar(stream[:, None, :])
    got = _counted("fade_awgn", lambda: ke.fade_awgn(*row, noise_var=nv / 64, seed=3,
                                                     ch_ids=ids))
    want = ke.fade_awgn_plain(*row, noise_var=nv / 64, seed=3, ch_ids=ids)
    peak = max(float(w.abs().max()) for w in want)
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) <= 1e-5 * peak
    _, (re, im) = packet._acquire(pc, stream)
    _, h = pipeline._estimate(cfg, (re, im), track_phase=True)
    assert h.shape == (B, S, 64)
    hr, hi = fast._planar(h.to(torch.complex64))
    got = _counted("demod_llr", lambda: kc.demod_llr(re, im, hr, hi, 16, Modulation.QPSK, nv))
    want = kc.demod_chain(re, im, hr, hi, 16, Modulation.QPSK, nv)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ---- the command line on the card ------------------------------------------------------------

def _cli_on(dev, argv):
    """``app.cli.main(argv)`` on the card: its last JSON line and the
    launches it made."""
    import contextlib
    import io
    import json

    from sdr_tpu_torch.app import cli

    _lib.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1]), dict(_lib.LAUNCHES)


@pytest.fixture
def small_cases(monkeypatch):
    import sdr_tpu_torch.app.baseline_configs as bc

    orig = bc.baseline_cases
    monkeypatch.setattr(bc, "baseline_cases", lambda: [
        dataclasses.replace(c, cfg=dataclasses.replace(c.cfg, n_channels=8, n_symbols=16))
        for c in orig()])


@pytest.mark.parametrize("argv,kernels", [
    (["bench", "--config", "1"], ("payload", "tx_off", "fade_awgn", "demod_count")),
    (["bench", "--config", "3"], ("payload", "tx_off", "fade_awgn_fir", "demod_count")),
    (["bench", "--config", "1", "--fast"], ("payload", "tx", "demod_count")),
    (["bench", "--config", "1", "--mc", "2"], ("mc_count",)),
    (["bench", "--config", "1", "--coded", "--code", "ldpc"], ("ldpc_minsum", "demod_llr")),
], ids=["pipeline", "pipeline-multipath", "fast", "mc", "ldpc"])
def test_cli_bench_on_card_matches_the_cpu(dev, small_cases, argv, kernels):
    """The command runs on the card by default through the path's kernels,
    and counts what ``--device cpu`` counts (the bits exactly, the errors
    within a few bits whose |LLR| is near 0)."""
    out, launches = _cli_on(dev, argv)
    for name in kernels:
        assert launches[name] > 0, (name, launches)
    ref, _ = _cli_on(dev, argv + ["--device", "cpu"])
    bits = "info_bits" if "info_bits" in ref else "bits"
    assert out[bits] == ref[bits]
    assert abs(out["bit_errors"] - ref["bit_errors"]) <= max(2, ref["bit_errors"] // 100)


def test_cli_sweep_packet_autotune_on_card(dev, small_cases, tmp_path):
    ck = str(tmp_path / "ck.json")
    argv = ["sweep", "--config", "1", "--engine", "mc", "--ebno-grid", "0,4", "--checkpoint", ck,
            "--max-bits", "100000"]
    first, launches = _cli_on(dev, argv)
    assert launches["mc_count"] > 0
    again, launches = _cli_on(dev, argv)
    assert again == first and launches["mc_count"] == 0
    path = str(tmp_path / "b.sc16")
    rec, launches = _cli_on(dev, ["packet", "--n", "64", "--ebno", "16", "--record", path])
    assert launches["tx_comb"] > 0 and launches["demod_llr"] > 0
    assert rec["crc_verdicts_consistent"] and rec["packets"] == 64
    rep, _ = _cli_on(dev, ["packet", "--n", "64", "--ebno", "16", "--replay", path])
    assert rep == rec
    tune, launches = _cli_on(dev, ["autotune", "--demod", "--demod-nfft", "256", "--demod-cp",
                                   "64", "--iters", "2"])
    assert all(p["error"] is None and p["gs_per_s"] > 0 for p in tune["points"])
    for name in ("demod_sum", "demod_sum_in_bf16", "llr_chain_sum", "demod_sum_cl",
                 "demod_sum_cl_in_bf16"):
        assert launches[name] > 0, name
    fft_tune, _ = _cli_on(dev, ["autotune", "--sizes", "256,8192", "--iters", "2"])
    assert set(fft_tune) == {"matmul_min_n", "points"}
    assert [p["n"] for p in fft_tune["points"]] == [256, 8192]
    assert all(p["xla"] > 0 and p["matmul"] > 0 for p in fft_tune["points"])


# ---- kernel C on bf16 sample planes ----------------------------------------------------------

C_BF16_N = [16, 64, 256, 1024, 4096]
# Each mode: its counter, and the call on (re, im, hr, hi, taps, idx).
_C_BF16_MODES = {
    "count": ("demod_count", lambda a, k: kc.demod_count(*a[:4], a[5], *k)),
    "count_h_per_symbol": ("demod_count", lambda a, k: kc.demod_count(*a[:2], *a[6:8], a[5], *k)),
    "count_taps": ("demod_count_taps",
                   lambda a, k: kc.demod_count(*a[:2], None, None, a[5], *k, taps=a[4])),
    "count_comb": ("demod_count_comb",
                   lambda a, k: kc.demod_count(*a[:4], a[5], *k, pilot_spacing=4)),
    "count_despread": ("demod_count_despread",
                       lambda a, k: kc.demod_count(*a[:4], a[5], *k, despread=True)),
    "plane": ("demod_llr", lambda a, k: kc.demod_llr(*a[:4], *k)),
    "plane_h_per_symbol": ("demod_llr", lambda a, k: kc.demod_llr(*a[:2], *a[6:8], *k)),
    "sum": ("demod_sum", lambda a, k: kc.demod_llr(*a[:4], *k, reduce_sum=True)),
    "plane_despread": ("demod_llr_despread", lambda a, k: kc.demod_llr(*a[:4], *k, despread=True)),
    "sum_despread": ("demod_sum_despread",
                     lambda a, k: kc.demod_llr(*a[:4], *k, reduce_sum=True, despread=True)),
}


def _c_bf16_inputs(dev, mod, n_fft, B=37, S=33):
    """Noise-like sample planes (unrounded f32), h one row a channel and
    one a symbol, 3 per-symbol taps and random indices."""
    cp = n_fft // 4
    g = torch.Generator(device=dev).manual_seed(n_fft + mod.bits_per_symbol)
    re, im = (torch.randn((B, S, n_fft + cp), device=dev, generator=g) / (2 * n_fft) ** 0.5
              for _ in range(2))
    hr, hi = (torch.randn((B, 1, n_fft), device=dev, generator=g) * 0.5 ** 0.5 for _ in range(2))
    hsr, hsi = (torch.randn((B, S, n_fft), device=dev, generator=g) * 0.5 ** 0.5
                for _ in range(2))
    taps = tuple(torch.randn((B, S, 3), device=dev, generator=g) / 6 ** 0.5 for _ in range(2))
    idx = torch.randint(0, 1 << mod.bits_per_symbol, (B, S, n_fft), device=dev, generator=g,
                        dtype=torch.int16)
    return [re, im, hr, hi, taps, idx, hsr, hsi], cp


@pytest.mark.parametrize("mode", list(_C_BF16_MODES))
@pytest.mark.parametrize("n_fft", C_BF16_N)
@pytest.mark.parametrize("mod", [Modulation.BPSK, Modulation.QAM16, Modulation.QAM1024],
                         ids=lambda m: m.value)
def test_demod_kernel_on_bf16_equals_f32_on_widened_planes(dev, mod, n_fft, mode):
    """C on bf16 sample planes gives the bits of C on the same planes
    widened to f32 (the tile at N 16 and 64, the warp-group form at 256,
    1024 and 4096), counted under the mode's ``_in_bf16`` counter; and it
    meets its plain version on the same bf16 planes as the f32 modes do
    (counts within the |LLR| < 1e-3 bits, planes 1e-4 of the peak, sums
    1e-5 of the sum of |LLR|)."""
    name, call = _C_BF16_MODES[mode]
    args, cp = _c_bf16_inputs(dev, mod, n_fft)
    k = (cp, mod, 1.0 / (10 ** 1.2 * mod.bits_per_symbol))
    half = args[:]
    half[0], half[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    wide = args[:]
    wide[0], wide[1] = half[0].float(), half[1].float()
    got = _counted(name + "_in_bf16", lambda: call(half, k))
    want = _counted(name, lambda: call(wide, k))
    assert got.dtype == want.dtype and torch.equal(got, want)
    despread = mode.endswith("despread")
    h = (args[6], args[7]) if mode.endswith("per_symbol") else (
        kc.taps_plane(args[4], n_fft) if mode == "count_taps" else (args[2], args[3]))
    plain = kc.demod_chain(half[0], half[1], *h, *k, despread=despread)
    if mode.startswith("count"):
        want_plain = (kc.demod_count_plain(*half[:4], half[5], *k, despread=despread,
                                           pilot_spacing=4) if mode == "count_comb" else
                      kc.count_errors(plain, half[5], mod.bits_per_symbol))
        _within_margin(got, plain, want_plain)
    elif mode.startswith("sum"):
        assert abs(float(got) - float(plain.double().sum())) <= \
            1e-5 * float(plain.abs().double().sum())
    else:
        _llr_close(got, plain)


def test_demod_kernel_on_bf16_meets_the_jax_bounds_against_f32(dev):
    """C's bf16 run against its f32 run on the unrounded planes, at the
    JAX test's bounds (tests/test_demod.py:269-292): within 2e-2 of the f32
    peak, sign flips only where |LLR| < 5e-2 of the peak; 16-QAM at 8 dB,
    N 256 and 4096."""
    mod = Modulation.QAM16
    nv = 1.0 / (10 ** 0.8 * mod.bits_per_symbol)
    for n_fft in (256, 4096):
        args, cp = _c_bf16_inputs(dev, mod, n_fft, B=16, S=8)
        for despread in (False, True):
            l32 = kc.demod_llr(*args[:4], cp, mod, nv, despread=despread)
            l16 = kc.demod_llr(args[0].to(torch.bfloat16), args[1].to(torch.bfloat16),
                               *args[2:4], cp, mod, nv, despread=despread)
            peak = float(l32.abs().max())
            assert float((l16 - l32).abs().max()) < 2e-2 * peak
            flips = (l16 < 0) != (l32 < 0)
            assert float(l32[flips].abs().max()) < 5e-2 * peak if bool(flips.any()) else True


def test_demod_routes_run_kernel_c_on_bf16_planes(dev):
    """``ops.demod.demod_chain`` and ``demod_count_chain`` on bf16 planes
    launch C's bf16 modes (no widening in torch, no CPU); a mixed pair of
    planes raises on the card as on the CPU."""
    from sdr_tpu_torch.ops import demod as od

    mod = Modulation.QAM16
    args, cp = _c_bf16_inputs(dev, mod, 256, B=8, S=4)
    rb, ib = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    k = (cp, mod, 0.05)
    _counted("demod_llr_in_bf16", lambda: od.demod_chain(rb, ib, *args[2:4], *k))
    _counted("demod_sum_in_bf16", lambda: od.demod_chain(rb, ib, *args[2:4], *k, reduce_sum=True))
    _counted("demod_count_in_bf16", lambda: od.demod_count_chain(rb, ib, *args[2:4], args[5], *k))
    _counted("demod_count_despread_in_bf16",
             lambda: od.demod_count_chain(rb, ib, *args[2:4], args[5], *k, despread=True))
    for planes in ((args[0], ib), (rb, args[1]), (args[0].half(), args[1].half())):
        with pytest.raises(ValueError, match="float32 or both bfloat16"):
            od.demod_chain(*planes, *args[2:4], *k)
        with pytest.raises(ValueError, match="float32 or both bfloat16"):
            od.demod_count_chain(*planes, *args[2:4], args[5], *k)
    with pytest.raises(ValueError, match="hr/hi must be float32"):
        kc.demod_llr(rb, ib, args[2].to(torch.bfloat16), args[3], *k)


# ---- the matmul DFT on the card --------------------------------------------------------------

def _ref_float_close(got, want, magnitude):
    """abs 1e-5·magnitude or rel 1e-6, per component (tests/test_fft.py)."""
    for part in (torch.real, torch.imag):
        a, b = part(got).double(), part(want)
        d = (a - b).abs()
        ok = (d <= 1e-5 * magnitude) | (d <= 1e-6 * torch.maximum(a.abs(), b.abs()))
        assert bool(ok.all()), float(d.max())


@pytest.mark.parametrize("n", [64, 128, 512, 8192])
def test_matmul_fft_on_card_is_full_f32_with_tf32_on(dev, n):
    """``matmul_fft`` and ``fft(backend="matmul")`` on the card at the
    reference tolerance against a float64 FFT, with TF32 switched on
    globally by the test: the products are pinned to full f32 (the same
    products left to TF32 miss the tolerance), and the setting is
    restored after each call."""
    from sdr_tpu_torch.ops import fft as F
    from sdr_tpu_torch.ops import fft_matmul

    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.complex(*(torch.randn((6, n), device=dev, generator=g) for _ in range(2)))
    want = torch.fft.fft(x.cpu().to(torch.complex128), dim=-1).to(dev)
    want_i = torch.fft.ifft(x.cpu().to(torch.complex128), dim=-1).to(dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fft_matmul.matmul_fft(x)
        assert torch.backends.cuda.matmul.allow_tf32
        via = F.fft(x, backend="matmul")
        inv = F.ifft(x, backend="matmul")
        loose = torch.complex(*fft_matmul._dft_planar(x.real, x.imag, False))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    _ref_float_close(got, want, n ** 0.5)
    assert torch.equal(via, got)
    _ref_float_close(inv, want_i, 1.0)
    err = float((loose.to(torch.complex128) - want).abs().max())
    assert err > 1e-5 * n ** 0.5, err  # TF32 was on: unpinned products miss the bound
