"""Pipeline parallelism: the link chain in two stages (port of
``sdr_tpu/parallel/pp.py``).

The mesh's "time" axis (size 2) holds the stages: row 0 runs TX +
channel (``link.fast.tx_channel_core``), row 1 demod + error count
(``link.fast.rx_count_core``); "channel" is data parallelism. Each
column's n_channels / n_channel links split into ``n_micro``
microbatches that flow through the pipe in n_micro + 1 ticks (the bubble
is 1/(n_micro + 1)): at tick t stage 0 produces microbatch t and sends
it, and stage 1 receives microbatch t − 1 and counts it. The only data
crossing the stage boundary is the impaired samples, one send of
(2, mb, S, N+cp) float32 per tick: stage 1 recomputes the channel and
the transmitted indices from the keys. Stage 0 and stage 1 are the two
halves ``fast_core`` composes, so the result equals ``fast_simulate``
bit for bit for any layout. Unlike the JAX program (SPMD under
``lax.cond``), each rank runs only its own stage's work.
"""

from __future__ import annotations

import torch

from sdr_tpu_torch.core.config import LinkConfig
from sdr_tpu_torch.link.fast import rx_count_core, tx_channel_core
from sdr_tpu_torch.parallel import _comm
from sdr_tpu_torch.parallel.mesh import LinkMesh
from sdr_tpu_torch.parallel.distributed import resolve_device

N_STAGES = 2  # TX+channel | RX+count


def make_pipelined_fast_fn(cfg: LinkConfig, mesh: LinkMesh, n_micro: int = 2, device="cuda"):
    """2-stage pipelined fast link over ``mesh`` (its "time" axis must be
    2). Returns ``fn(seed) -> (bit_errors, bits_counted)``, both
    (n_channels,) int32 on every rank, equal to ``fast_simulate``."""
    if mesh.n_time != N_STAGES:
        raise ValueError(
            f'pipeline needs mesh "time" axis == {N_STAGES} (stages), got {mesh.n_time}'
        )
    if cfg.pilot_spacing:
        raise NotImplementedError("the fast path simulates full-grid links (see link.fast)")
    cdev = mesh.n_channel
    if cfg.n_channels % (cdev * n_micro) != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by "
            f"channel shards × microbatches = {cdev}×{n_micro}"
        )
    dev = resolve_device(device)
    local = cfg.n_channels // cdev
    mb = local // n_micro
    S, sym_len = cfg.n_symbols, cfg.ofdm.n_fft + cfg.ofdm.cp_len
    stage, csh = mesh.coord("time"), mesh.coord("channel")
    peer = mesh.rank_at(1 - stage, csh)
    wire = mesh.world_group

    def mb_ids(m):
        start = csh * local + m * mb
        return torch.arange(start, start + mb, dtype=torch.int32, device=dev)

    def fn(seed: int):
        errors = torch.zeros((local,), dtype=torch.int32, device=dev)
        for t in range(n_micro + 1):
            if stage == 0 and t < n_micro:
                re, im = tx_channel_core(cfg, seed, mb_ids(t))
                _comm.send(torch.stack([re, im]), peer, wire)
            if stage == 1 and t >= 1:
                m = t - 1
                buf = _comm.recv((2, mb, S, sym_len), torch.float32, peer, dev, wire)
                errors[m * mb:(m + 1) * mb] = rx_count_core(cfg, seed, mb_ids(m), buf[0],
                                                            buf[1])[0]
        # Stage 0's rows are zeros: the sum over "time" leaves stage 1's counts.
        per_rank = _comm.all_gather(errors, wire)  # (2·cdev, local), rank order
        errors = per_rank.reshape(N_STAGES, cdev * local).sum(dim=0, dtype=torch.int32)
        counted = torch.full((cfg.n_channels,), S * cfg.bits_per_ofdm_symbol, dtype=torch.int32,
                             device=dev)
        return errors, counted

    return fn
