"""Multi-process runtime initialisation (port of
``sdr_tpu/parallel/distributed.py``).

One process per rank, each driving one device. ``init_multihost`` wraps
``torch.distributed.init_process_group``; the caller names the backend:

- ``"nccl"``: one card per rank, device tensors passed to the
  collectives. The rank's card is ``local_rank``, else ``LOCAL_RANK``
  from the environment (torchrun sets it), else the rank itself, and
  that only when the whole job fits on this host's cards;
- ``"gloo"``: collectives through the host. It serves the CPU tests and
  ranks that share one card; the port's collectives (``parallel/_comm``)
  stage device tensors through the host explicitly on it.

Nothing is chosen for the caller: NCCL on a rank whose card does not
exist (two ranks on one card, for instance) raises, and more than one
process without a backend raises. Nothing on a machine tells a program
of its cluster, so the address (``init_method``: ``tcp://host:port`` or
``file://path``; default torch's ``env://``), the world size and the
rank come from the caller.

Usage on each process:

    from sdr_tpu_torch.parallel import init_multihost, make_link_mesh
    init_multihost("nccl", "tcp://host0:29500", world_size=8, rank=r)
    mesh = make_link_mesh(n_time=2, n_channel=4)

Every sharded entry point is SPMD over the mesh; results are
layout-independent because every draw is keyed by global channel id.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def init_multihost(backend: str | None = None, init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   local_rank: int | None = None) -> dict:
    """Initialise the process group; returns a topology summary with the
    JAX function's keys.

    No-op for one process without a backend (safe to call at program
    start); a backend given with ``world_size`` 1 starts a one-rank group,
    so that the collectives run. Already initialised: only the summary."""
    if not dist.is_initialized():
        if backend is None:
            if world_size is not None and world_size > 1:
                raise ValueError(
                    f"init_multihost: {world_size} processes need a backend: 'nccl' (one card "
                    "per rank) or 'gloo' (through the host)"
                )
        else:
            if backend not in BACKENDS:
                raise ValueError(f"init_multihost: backend must be one of {BACKENDS}, "
                                 f"got {backend!r}")
            if backend == "nccl":
                _select_card(local_rank, rank, world_size)
            kw = {} if init_method is None else dict(init_method=init_method)
            if world_size is not None:
                kw.update(world_size=world_size, rank=rank)
            dist.init_process_group(backend, **kw)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: raise for a CUDA device when
    there is none (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the parallel entry points run on the card by default and no CUDA "
                           "device is available; pass device='cpu' for the plain versions")
    return dev


def _card_index(local_rank: int | None, rank: int | None, world_size: int | None,
                n_cards: int) -> int:
    """The card an NCCL rank takes on a host with ``n_cards``, or raise."""
    if local_rank is None and "LOCAL_RANK" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if local_rank is None:
        world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
        if world > n_cards:
            raise ValueError(
                f"init_multihost: {world} NCCL ranks and {n_cards} cards here, and no local "
                "rank: pass local_rank (or set LOCAL_RANK) on a job across hosts"
            )
        local_rank = rank
    if local_rank >= n_cards:
        raise ValueError(
            f"init_multihost: NCCL takes one card per rank, and rank {rank} would need card "
            f"{local_rank} of the {n_cards} here; ranks that share a card take backend='gloo'"
        )
    return local_rank


def _select_card(local_rank: int | None, rank: int | None, world_size: int | None) -> None:
    """NCCL takes one card per rank: bind this process to its card or raise."""
    if not torch.cuda.is_available():
        raise RuntimeError("init_multihost: backend 'nccl' needs a CUDA device")
    torch.cuda.set_device(_card_index(local_rank, rank, world_size, torch.cuda.device_count()))
