"""Weak scaling over the ranks of the process group (port of
``sdr_tpu/obs/scaling.py``).

Grows the channel count with the rank count (fixed work per rank), runs
the channel-DP link (``parallel.make_sharded_simulate_fn``) on each
subset of ranks, and reports samples/s and the efficiency relative to
rank 0's first point. Without a process group the only count is 1. Ranks
that share one card give no scaling figure: weak scaling across cards
needs a card per rank.

Timing: each rep runs ``iters`` calls back to back and syncs once, on
the host clock around the rep (the counts end on every rank). The
calls are chained through the error count: every call's error sum
accumulates on the device, and each rep's seeds fold in the count the
previous rep fetched, so no call's result is unused.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from sdr_tpu_torch.core.config import LinkConfig
from sdr_tpu_torch.parallel.distributed import resolve_device
from sdr_tpu_torch.parallel.mesh import LinkMesh, make_link_mesh
from sdr_tpu_torch.parallel.shard import make_sharded_simulate_fn


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    n_channels: int
    samples_per_s: float
    efficiency: float  # vs perfect scaling of the first point


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(k: int):
    """A 1 × k channel mesh over ranks 0 … k−1 (None on the other ranks).
    Every rank calls this for every k, in the same order."""
    if k == _world():
        return make_link_mesh(1, k)
    group = dist.new_group(list(range(k)))
    rank = dist.get_rank()
    if rank >= k:
        return None
    return LinkMesh(1, k, rank, {"time": None, "channel": group}, group)


def _from_rank0(value):
    """Rank 0's ``value`` on every rank (a collective of the default
    group); ``value`` itself without a group."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _seed(rep: int, i: int, last: int) -> int:
    return (rep * 1_000_003 + i * 7919 + last) & 0x7FFFFFFF


def _rate(cfg: LinkConfig, mesh, iters: int, reps: int, device) -> float:
    fn = make_sharded_simulate_fn(cfg, mesh, device)
    dev = resolve_device(device)

    def run(rep: int, last: int) -> int:
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(iters):
            errors, _ = fn(_seed(rep, i, last))
            acc += errors.sum()
        return int(acc)  # the one sync of the rep

    last = run(0, 0)  # warm-up
    best = float("inf")
    for rep in range(1, reps + 1):
        t0 = time.perf_counter()
        last = run(rep, last)
        best = min(best, time.perf_counter() - t0)
    samples = cfg.n_channels * cfg.n_symbols * cfg.samples_per_symbol * iters
    return samples / best


def weak_scaling(
    cfg: LinkConfig,
    device_counts=None,
    iters: int = 10,
    reps: int = 3,
    device="cuda",
) -> list:
    """Run the DP-sharded link at each rank count on ``device`` (the card
    unless the caller asks for the CPU); channels scale with ranks,
    keeping cfg.n_channels per rank constant. Returns [ScalePoint...] on
    rank 0 (the other ranks return the points of the counts they took
    part in). Every efficiency is relative to rank 0's rate at the first
    count, broadcast to the other ranks."""
    world = _world()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    if any(k > world for k in device_counts):
        raise ValueError(f"device counts {list(device_counts)} exceed the {world} ranks")
    per_dev = cfg.n_channels
    points = []
    base = None
    for j, k in enumerate(device_counts):
        mesh = _mesh(k)
        cfg_k = dataclasses.replace(cfg, n_channels=per_dev * k)
        rate = None if mesh is None else _rate(cfg_k, mesh, iters, reps, device)
        if j == 0:
            base = _from_rank0(rate)
        if mesh is None:
            continue
        points.append(
            ScalePoint(
                n_devices=k,
                n_channels=cfg_k.n_channels,
                samples_per_s=rate,
                efficiency=rate / (base * k / device_counts[0]),
            )
        )
    return points
