"""Blocked stream simulation — the sequence-parallel link.

Port of ``sdr_tpu/link/stream.py`` (ROADMAP queue 1, item 11b). A frame
of ``n_symbols`` OFDM symbols per channel is split into ``n_blocks``
contiguous time blocks; block b covers symbols [b·spb, (b+1)·spb). The
channels' fading state is drawn once (``link.fast.fading_params``, as
the JAX ``_channel_taps``); each block then runs ``link.pipeline``'s chain
on its own: kernel A's payload rows, kernel B's waveform (SC-FDMA's full-grid
TX), the fading at the block's absolute symbols and kernel E's channel,
then kernel C's count.
The only cross-block coupling is the multipath FIR's L−1-sample history
at each block seam: the previous block's clean TX tail, zeros before
block 0, which E reads as its history planes. ``parallel.shard.
make_sharded_stream_fn`` exchanges that halo between ranks.

Keying: every draw is keyed by absolute position — the payload and the
noise by (channel, symbol, sample), the fading by channel, with
RAYLEIGH_TIME and MULTIPATH_TIME evaluating their Jakes state at absolute
symbol indices — so a stream equals ``pipeline.simulate`` for any
``n_blocks`` (the JAX module keys the payload and the noise per (channel,
block), a stream of its own): bit for bit for the static models, and for
the two Jakes models but for bits whose |LLR| < 1e-3, where a block's
Jakes evaluation may differ from the whole frame's by an ulp
(``exact_at_seams``).

This module is the unsharded oracle: the sharded stream must equal it
bit for bit for any mesh. Entry points run on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.core.config import ChannelModel, LinkConfig
from sdr_tpu_torch.link import fast, pipeline


def _check_blocking(cfg: LinkConfig, n_blocks: int) -> int:
    """The symbols per block; raises for what the stream does not run:
    MIMO (it runs in the pipeline, as the JAX module says), front-end
    impairments (the JAX stream runs the propagation model alone there;
    this one names item 11d), then pilots, as the JAX module does
    (stream.py:40-49)."""
    if cfg.mimo is not None:
        raise NotImplementedError(
            "the blocked-stream path is SISO; MIMO links run in "
            "link.pipeline.simulate (set mimo=None here)")
    if pipeline.front_end_impaired(cfg):
        raise NotImplementedError(
            "the blocked stream does not run front-end impairments (PA, phase noise, I/Q "
            "imbalance, timing/CFO acquisition: ROADMAP queue 1, item 11d, ported in "
            "link.pipeline.simulate only)")
    if cfg.pilot_spacing:
        raise NotImplementedError(
            "the blocked-stream path simulates full-grid links; pilot-based "
            "estimation lives in link.pipeline.simulate (pilot_spacing=0 here)")
    if n_blocks < 1 or cfg.n_symbols % n_blocks != 0:
        raise ValueError(f"n_symbols={cfg.n_symbols} not divisible by n_blocks={n_blocks}")
    return cfg.n_symbols // n_blocks


def exact_at_seams(cfg: LinkConfig) -> bool:
    """Whether a stream counts what ``pipeline.simulate`` counts, bit for
    bit: where every draw is keyed by absolute position and no Jakes
    evaluation enters (every model but RAYLEIGH_TIME and MULTIPATH_TIME,
    whose per-block evaluation may round apart from the frame's; those
    agree but for the bits whose |LLR| < 1e-3)."""
    return cfg.channel.model not in fast._PER_SYMBOL


def _halo_len(cfg: LinkConfig) -> int:
    """The FIR's history at a seam: L − 1 samples of a selective model."""
    if cfg.channel.model in (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME):
        return max(len(cfg.channel.pdp) - 1, 0)
    return 0


def block_tx(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, b: int, spb: int):
    """TX of block b: (indices (B, spb, N), planar waveform (B, spb, N+cp))."""
    idx = pipeline.draw_idx(cfg, seed, ch_ids, s0=b * spb, n_symbols=spb)
    return idx, pipeline.tx_idx(cfg, idx)


def block_rx(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, b: int, spb: int, tx, idx,
             fading, halo=None) -> torch.Tensor:
    """Channel and receiver of block b: per-channel (B,) int32 errors.
    ``fading``: the block's (h, taps); ``halo`` (hr, hi) (B, L−1): the
    clean samples before the block."""
    rx, h_freq, nv = pipeline.apply_channel(cfg, seed, ch_ids, tx, s0=b * spb, history=halo,
                                            fading=fading)
    return pipeline.count_errors(cfg, rx, h_freq, nv, idx)


def tail(tx, n: int):
    """The last ``n`` samples of each channel's planar block stream:
    (hr, hi), each (B, n)."""
    return tuple(t.reshape(t.shape[0], -1)[:, -n:].contiguous() for t in tx)


def run_blocks(cfg: LinkConfig, seed: int, ch_ids: torch.Tensor, blocks, spb: int, halo,
               txs=None) -> torch.Tensor:
    """Blocks ``blocks`` (consecutive) of the channels ``ch_ids``, the first
    taking ``halo`` as its history (None: zeros) and each later one its
    predecessor's tail; ``txs`` the blocks' (idx, tx), drawn here when
    None. Returns per-channel (B,) int32 errors."""
    n_halo = _halo_len(cfg)
    state = fast.fading_params(cfg, seed, ch_ids)
    errors = torch.zeros(ch_ids.shape[0], dtype=torch.int32, device=ch_ids.device)
    for i, b in enumerate(blocks):
        idx, tx = txs[i] if txs is not None else block_tx(cfg, seed, ch_ids, b, spb)
        errors += block_rx(cfg, seed, ch_ids, b, spb, tx, idx,
                           fast.fading_at(cfg, state, b * spb, spb), halo)
        if n_halo:
            halo = tail(tx, n_halo)
    return errors


def stream_simulate(cfg: LinkConfig, seed: int, n_blocks: int, device="cuda"):
    """Unsharded blocked-stream link over all channels on ``device``.

    Returns (bit_errors (n_channels,) int32, bits_counted (n_channels,)
    int32); ``parallel.shard.make_sharded_stream_fn`` must match it bit
    for bit for any mesh."""
    spb = _check_blocking(cfg, n_blocks)
    ch_ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=device)
    errors = run_blocks(cfg, seed, ch_ids, range(n_blocks), spb, None)
    counted = torch.full((cfg.n_channels,), cfg.n_symbols * cfg.bits_per_ofdm_symbol,
                         dtype=torch.int32, device=ch_ids.device)
    return errors, counted
