"""State carried across from the JAX package.

- ``link_config_from_reference``: a ``sdr_tpu`` ``LinkConfig`` → the
  port's ``LinkConfig``, through the reference's own dict form
  (``link_config_to_dict``, looked up on the object's module, so this
  package never imports JAX itself) and the port's
  ``link_config_from_dict``; validation runs again on the way in.
- numpy → tensor helpers for the channel state the parity tests feed
  both packages: symbol indices, flat gains and injected noise planes
  (``channel_state``), and the JAX engine's fading state — FIR taps,
  per-symbol gains, Jakes (θ, φ) — (``fading_state``), and the
  Monte-Carlo kernel's injected draws (``mc_rand_inputs_from_reference``);
- ``ldpc_code_from_reference``: a ``sdr_tpu`` ``QcLdpcCode`` → the
  port's (its base matrix and Z are a code's only state);
- ``mesh_shape_from_reference``: a JAX ``Mesh`` over the ("time",
  "channel") axes → the port's (n_time, n_channel) rank layout;
- ``tp_inputs``: the numpy inputs of the tensor-parallel demod that both
  packages are fed (planar samples and the natural-order channel plane);
- ``packet_config_from_reference``: a ``sdr_tpu`` ``PacketConfig`` → the
  port's (``link.packet``), field by field, validation again on the way in;
- ``mcs_table_from_reference``: a list of ``sdr_tpu`` ``MCSThreshold`` →
  the port's (``link.adapt``), in order.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sdr_tpu_torch.core.config import (
    LinkConfig,
    Modulation,
    OFDMConfig,
    link_config_from_dict,
)
from sdr_tpu_torch.ops.ldpc import QcLdpcCode


def link_config_from_reference(cfg) -> LinkConfig:
    """Carry a reference-package ``LinkConfig`` across."""
    to_dict = sys.modules[type(cfg).__module__].link_config_to_dict
    return link_config_from_dict(to_dict(cfg))


def planes(*arrays, device="cpu", dtype=torch.float32):
    """numpy arrays → contiguous tensors of ``dtype`` on ``device``."""
    return tuple(
        torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device) for a in arrays
    )


def channel_state(idx=None, h=None, noise=None, device="cpu"):
    """numpy channel state → tensors: ``idx`` symbol indices (B, S, N) →
    int32; ``h`` per-channel complex gains (B,) → (B, 1, 1) complex64;
    ``noise`` (n_re, n_im) N(0, 1) planes (B, S, N+cp) → float32."""
    out = {}
    if idx is not None:
        out["idx"] = torch.as_tensor(np.asarray(idx, np.int32), device=device)
    if h is not None:
        out["h"] = torch.as_tensor(
            np.asarray(h, np.complex64).reshape(-1, 1, 1), device=device
        )
    if noise is not None:
        out["noise"] = planes(*noise, device=device)
    return out


def fading_state(taps=None, gains=None, jakes=None, device="cpu"):
    """The JAX engine's fading state (numpy) → the port's tensors.

    ``taps``: FIR taps (B, L) static or (B, S, L) per symbol → complex64,
    as ``link.fast.fade_state`` returns them; ``gains``: per-symbol flat
    gains (B, S) → (B, S, 1) complex64, ``fade_state``'s h for
    RAYLEIGH_TIME; ``jakes``: (θ, φ) of ``jakes_params`` /
    ``multipath_time_params``, (..., n_paths) → float32, for
    ``ops.channel.jakes_eval``."""
    out = {}
    if taps is not None:
        out["taps"] = torch.as_tensor(np.asarray(taps, np.complex64), device=device)
    if gains is not None:
        g = np.asarray(gains, np.complex64)
        out["h"] = torch.as_tensor(g.reshape(g.shape[0], -1, 1), device=device)
    if jakes is not None:
        out["jakes"] = planes(*jakes, device=device)
    return out


def mc_rand_inputs_from_reference(idx, nr, ni, hr, hi, device="cpu"):
    """The JAX MC kernel's ``rand_inputs`` (numpy: idx (B, S, N), nr/ni
    (B, S, N) N(0, 1) planes, hr/hi (B, 1 | S, N) responses) → the port's
    ``rand_inputs`` for ``kernels.mc.mc_count``: int32 indices and
    contiguous float32 planes on ``device``."""
    idx_t = torch.as_tensor(np.ascontiguousarray(idx, np.int32), device=device)
    return (idx_t, *planes(nr, ni, hr, hi, device=device))


def ldpc_code_from_reference(code) -> QcLdpcCode:
    """Carry a reference-package ``QcLdpcCode`` across (duck-typed: its
    ``base`` rows and ``z``)."""
    return QcLdpcCode(tuple(tuple(int(x) for x in row) for row in code.base), int(code.z))


def mesh_shape_from_reference(mesh) -> tuple[int, int]:
    """A reference ``Mesh`` (axes "time" and "channel", duck-typed: its
    ``shape`` mapping) → the port's (n_time, n_channel), the arguments of
    ``parallel.make_link_mesh``."""
    return int(mesh.shape["time"]), int(mesh.shape["channel"])


def tp_inputs(seed: int, batch: int, n_syms: int, n_fft: int, cp_len: int, h_syms: int = 1):
    """numpy float32 inputs of the TP demod: samples re/im (batch,
    n_syms, n_fft + cp_len) and channel hr/hi (batch, h_syms, n_fft),
    all N(0, 1) as the reference's TP tests draw them."""
    rng = np.random.default_rng(seed)
    shapes = [(batch, n_syms, n_fft + cp_len)] * 2 + [(batch, h_syms, n_fft)] * 2
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in shapes)


def packet_config_from_reference(pcfg):
    """Carry a reference-package ``PacketConfig`` across (duck-typed: its
    fields; the modulation by its string value)."""
    from sdr_tpu_torch.link.packet import PacketConfig

    return PacketConfig(
        payload_bytes=int(pcfg.payload_bytes),
        modulation=Modulation(pcfg.modulation.value),
        ofdm=OFDMConfig(n_fft=int(pcfg.ofdm.n_fft), cp_len=int(pcfg.ofdm.cp_len)),
        rate=str(pcfg.rate),
        pilot_spacing=int(pcfg.pilot_spacing),
        fec=str(pcfg.fec),
    )


def mcs_table_from_reference(table) -> list:
    """Carry a reference-package MCS table (a list of ``MCSThreshold``)
    across, entry by entry in order."""
    from sdr_tpu_torch.link.adapt import MCSThreshold

    return [
        MCSThreshold(Modulation(t.modulation.value), str(t.rate), float(t.efficiency),
                     float(t.esno_db), float(t.measured_ber), str(t.family), str(t.waveform))
        for t in table
    ]
