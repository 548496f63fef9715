"""The collectives of the parallel layer, on ``torch.distributed``.

- ``all_to_all``: the tensor-parallel lane exchange
  (``all_to_all_single``): block j of dim 0 goes to the group's j-th
  rank, block p of the result came from its p-th rank;
- ``all_gather``: the per-channel counts and the LLR blocks, stacked on a
  new dim 0 in group order;
- ``send`` / ``recv``: the pipeline hop between stages (global ranks).

Which path a call takes is decided by the group's backend, not by the
tensor: on ``gloo`` a device tensor is copied to the host, the
collective runs there and the result is copied back (explicitly: gloo
is not relied on to take CUDA tensors); on ``nccl`` device tensors go
to the collective as they are. A group of None (no process group: one
rank) makes every collective the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(group) -> bool:
    """True when the group's collectives run on host tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    return (x.cpu() if _staged(group) else x).contiguous()


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (D, ...): block j to rank j of ``group``; returns (D, ...) with
    block p from rank p."""
    if group is None:
        return x
    send = _to_wire(x, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.to(x.device)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x stacked in group order: (D, *x.shape)."""
    if group is None:
        return x[None]
    send = _to_wire(x, group)
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.stack(parts).to(x.device)


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send x to global rank ``dst`` (blocking)."""
    dist.send(_to_wire(x, group), dst)


def recv(shape, dtype, src: int, device, group) -> torch.Tensor:
    """Receive a tensor of ``shape`` from global rank ``src`` onto ``device``."""
    buf = torch.empty(shape, dtype=dtype, device="cpu" if _staged(group) else device)
    dist.recv(buf, src)
    return buf.to(device)


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)
