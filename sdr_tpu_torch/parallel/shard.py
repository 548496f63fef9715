"""Channel-batch data parallelism and time-block sequence parallelism
(port of ``sdr_tpu/parallel/shard.py``).

Every entry point is SPMD over a ``LinkMesh``: each rank runs the
unsharded engine on its block of GLOBAL channel ids, and one
``all_gather`` gives every rank the (n_channels,) result. Because every
draw of the pipeline, fast, coded and injected Monte-Carlo links is keyed
by (seed, global channel id), the result equals the unsharded run bit
for bit, for any mesh (any slice of channels reproduces the full run).

The fast and coded links have no time-axis structure, so every rank is
a DP worker over the flattened mesh (rank r owns block r, as the JAX
module's ``time·n_channel + channel``); the pipeline and Monte-Carlo
builders shard over "channel" and repeat the work along "time", as in
JAX. The stream builder shards time blocks over "time" and channels over
"channel"; its one exchange is the FIR's halo, each time rank's last
clean block tail sent to the next rank along "time" (the JAX
``ppermute``), then one reduction of the counts over "time".

``make_sharded_coded_fn`` runs ``link.coded``'s families (conv, LDPC,
polar) the same way: each rank decodes its global channel ids
device-locally, and the counts are the only communication.
"""

from __future__ import annotations

import dataclasses

import torch

from sdr_tpu_torch.core.config import LinkConfig
from sdr_tpu_torch.link import coded, fast, fast_coded, pipeline
from sdr_tpu_torch.link import stream as _stream
from sdr_tpu_torch.link.mc import _wrap_i32, mc_simulate
from sdr_tpu_torch.parallel import _comm
from sdr_tpu_torch.parallel.mesh import LinkMesh
from sdr_tpu_torch.parallel.distributed import resolve_device

_SHARD_STRIDE = 0x5BD1E995 & 0x7FFFFFFF  # the JAX module's per-shard seed step (shard.py:246)


def _local_ids(cfg: LinkConfig, n_shards: int, shard: int, dev):
    if cfg.n_channels % n_shards != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by device count {n_shards}"
        )
    local = cfg.n_channels // n_shards
    return torch.arange(shard * local, (shard + 1) * local, dtype=torch.int32, device=dev)


def _gather_pair(errors, counted, group):
    """One all_gather of the stacked (2, local) counts → global (n,) pair."""
    both = _comm.all_gather(torch.stack([errors, counted]), group)  # (D, 2, local)
    both = both.permute(1, 0, 2).reshape(2, -1)
    return both[0], both[1]


def make_sharded_simulate_fn(cfg: LinkConfig, mesh: LinkMesh, device="cuda"):
    """Channel DP for ``link.pipeline.simulate`` over "channel" (repeated
    along "time", as in JAX). Returns ``fn(seed) -> (bit_errors,
    bits_counted)``, both (n_channels,) int32 on every rank, equal to the
    unsharded ``simulate`` bit for bit."""
    dev = resolve_device(device)
    ids = _local_ids(cfg, mesh.shape["channel"], mesh.coord("channel"), dev)

    def fn(seed: int):
        errors, counted, _ = pipeline.simulate_core(cfg, seed, ids)
        return _gather_pair(errors, counted, mesh.group("channel"))

    return fn


def _exchange_halo(halo, mesh: LinkMesh):
    """The FIR's halo along "time": this rank's last block tail (hr, hi)
    (B, L−1) goes to the next time rank, the previous rank's comes back
    (None at time rank 0: zeros). Even time ranks send first and odd ones
    receive first, so the blocking point-to-point pairs of gloo always
    meet."""
    t, c, n_t = mesh.coord("time"), mesh.coord("channel"), mesh.shape["time"]
    wire = torch.stack(halo)
    group = mesh.group("time")
    got = None

    def send():
        if t + 1 < n_t:
            _comm.send(wire, mesh.rank_at(t + 1, c), group)

    def recv():
        if t > 0:
            return _comm.recv(wire.shape, wire.dtype, mesh.rank_at(t - 1, c), wire.device, group)
        return None

    if t % 2 == 0:
        send()
        got = recv()
    else:
        got = recv()
        send()
    return None if got is None else (got[0], got[1])


def make_sharded_stream_fn(cfg: LinkConfig, mesh: LinkMesh, n_blocks: int | None = None,
                           device="cuda"):
    """Time-block SP (+ channel DP) for the stream link. ``n_blocks``
    blocks (default one per time rank) go contiguously to the time ranks:
    rank t owns global blocks [t·bpd, (t+1)·bpd). Each rank draws and
    transmits its blocks, sends its last block's clean tail to the next
    time rank and takes the previous rank's as its first block's history
    (rank 0: zeros), threads the seams inside its own run, and counts.
    Returns ``fn(seed) -> (bit_errors, bits_counted)`` (n_channels,) on
    every rank, equal to ``link.stream.stream_simulate(cfg, seed,
    n_blocks)`` bit for bit."""
    dev = resolve_device(device)
    n_t = mesh.shape["time"]
    if n_blocks is None:
        n_blocks = n_t
    if n_blocks % n_t != 0:
        raise ValueError(f"n_blocks={n_blocks} not divisible by time axis {n_t}")
    spb = _stream._check_blocking(cfg, n_blocks)
    ids = _local_ids(cfg, mesh.shape["channel"], mesh.coord("channel"), dev)
    bpd = n_blocks // n_t
    blocks = range(mesh.coord("time") * bpd, (mesh.coord("time") + 1) * bpd)
    n_halo = _stream._halo_len(cfg)

    def fn(seed: int):
        txs = [_stream.block_tx(cfg, seed, ids, b, spb) for b in blocks]
        halo = _exchange_halo(_stream.tail(txs[-1][1], n_halo), mesh) if n_halo else None
        errors = _stream.run_blocks(cfg, seed, ids, blocks, spb, halo, txs)
        errors = _comm.all_gather(errors, mesh.group("time")).sum(dim=0, dtype=torch.int32)
        counted = torch.full_like(errors, cfg.n_symbols * cfg.bits_per_ofdm_symbol)
        return _gather_pair(errors, counted, mesh.group("channel"))

    return fn


def make_sharded_fast_fn(cfg: LinkConfig, mesh: LinkMesh, layout: str = "auto",
                         device="cuda"):
    """DP for the keyed fast link (``link.fast.fast_core``). Returns
    ``fn(seed) -> (bit_errors, bits_counted)``, both (n_channels,) int32
    on every rank, equal to ``fast_simulate(cfg, seed)``. ``layout="auto"``
    resolves once against the per-rank batch."""
    dev = resolve_device(device)
    if cfg.mimo is not None:
        raise NotImplementedError(
            "the fast path is SISO; sharded MIMO links run through "
            "make_sharded_simulate_fn (link.pipeline)")
    fast.check_supported(cfg, layout)
    ids = _local_ids(cfg, mesh.size, mesh.rank, dev)
    if layout == "auto":
        layout = fast.select_layout(cfg, ids.shape[0])

    def fn(seed: int):
        errors, counted = fast.fast_core(cfg, seed, ids, layout=layout)
        return _gather_pair(errors, counted, mesh.world_group)

    return fn


def _channel_shard(cfg: LinkConfig, mesh: LinkMesh):
    n_shards = mesh.shape["channel"]
    if cfg.n_channels % n_shards != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by channel-axis size {n_shards}"
        )
    return dataclasses.replace(cfg, n_channels=cfg.n_channels // n_shards)


def make_sharded_mc_fn(cfg: LinkConfig, mesh: LinkMesh, iters: int = 1, device="cuda"):
    """DP for the Monte-Carlo engine over "channel": each shard runs
    ``mc_simulate`` on n_channels / shards links with the seed
    seed + shard·(0x5BD1E995 & 0x7FFFFFFF), wrapped to int32. Statistics,
    not draws, are the contract (the result depends on the mesh).
    Returns ``fn(seed) -> (bit_errors, bits_counted)`` (n_channels,)."""
    dev = resolve_device(device)
    local_cfg = _channel_shard(cfg, mesh)
    me = mesh.coord("channel")

    def fn(seed: int):
        errors, counted = mc_simulate(local_cfg, _wrap_i32(int(seed) + me * _SHARD_STRIDE),
                                      iters=iters, device=dev)
        return _gather_pair(errors, counted, mesh.group("channel"))

    return fn


def make_sharded_mc_inject_fn(cfg: LinkConfig, mesh: LinkMesh, device="cuda"):
    """Inject-mode twin of ``make_sharded_mc_fn``: ``fn(idx, nr, ni, hr,
    hi)`` takes the GLOBAL draws (``mc_simulate``'s ``rand_inputs``,
    leading axis n_channels), each shard runs its channel block, and the
    result equals the unsharded inject run bit for bit."""
    dev = resolve_device(device)
    local_cfg = _channel_shard(cfg, mesh)
    me = mesh.coord("channel")
    block = slice(me * local_cfg.n_channels, (me + 1) * local_cfg.n_channels)

    def fn(idx, nr, ni, hr, hi):
        rand = tuple(torch.as_tensor(a, device=dev)[block].contiguous()
                     for a in (idx, nr, ni, hr, hi))
        errors, counted = mc_simulate(local_cfg, 0, iters=1, device=dev, rand_inputs=rand)
        return _gather_pair(errors, counted, mesh.group("channel"))

    return fn


def make_sharded_coded_fast_fn(cfg: LinkConfig, mesh: LinkMesh, rate: str = "1/2",
                               ldpc_iters: int = 25, schedule: str = "flooding",
                               seam: str = "auto", device="cuda"):
    """DP for the coded fast engine (``link.fast_coded.ldpc_fast_core``):
    ``fn(seed) -> (info_bit_errors, info_bits_counted)`` (n_channels,),
    equal to ``ldpc_fast_simulate``. ``seam="auto"`` is "staged", as in
    the engine."""
    dev = resolve_device(device)
    fast_coded.check_supported(cfg, seam, schedule)
    ids = _local_ids(cfg, mesh.size, mesh.rank, dev)

    def fn(seed: int):
        errors, counted = fast_coded.ldpc_fast_core(cfg, seed, ids, rate=rate, iters=ldpc_iters,
                                                    schedule=schedule, seam=seam)
        return _gather_pair(errors, counted, mesh.world_group)

    return fn


def coded_family_kw(code: str, ldpc_iters: int = 25, polar_n: int = 256,
                    polar_list: int = 8) -> dict:
    """``make_sharded_coded_fn``'s knobs as ``link.coded``'s family keywords."""
    kw = {"conv": {}, "ldpc": dict(iters=ldpc_iters),
          "polar": dict(block_len=polar_n, list_size=polar_list)}
    if code not in kw:
        raise ValueError(f"code must be 'conv', 'ldpc' or 'polar', got {code!r}")
    return kw[code]


def make_sharded_coded_fn(cfg: LinkConfig, mesh: LinkMesh, code: str = "conv",
                          rate: str = "1/2", ldpc_iters: int = 25, polar_n: int = 256,
                          polar_list: int = 8, device="cuda"):
    """DP for the coded links of ``link.coded`` (conv/Viterbi, LDPC/min-sum,
    polar/CA-SCL) over the flattened mesh, as JAX: rank r decodes its block
    of global channel ids entirely locally. Returns ``fn(seed) ->
    (info_bit_errors, info_bits_counted)`` (n_channels,) on every rank,
    equal to ``simulate_coded`` / ``simulate_ldpc`` / ``simulate_polar``
    bit for bit."""
    dev = resolve_device(device)
    core = coded.family_core(cfg, code, rate, **coded_family_kw(code, ldpc_iters, polar_n,
                                                                polar_list))
    ids = _local_ids(cfg, mesh.size, mesh.rank, dev)

    def fn(seed: int):
        errors, counted = core(seed, ids)
        return _gather_pair(errors, counted, mesh.world_group)

    return fn
