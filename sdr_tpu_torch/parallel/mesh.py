"""The rank mesh of the link simulator (port of ``sdr_tpu/parallel/mesh.py``).

The ranks of the process group are laid out row-major as a 2-D mesh with
the JAX package's axes:

- ``"time"`` (rows): the stage axis of the pipeline and the subcarrier
  axis of the tensor-parallel demod;
- ``"channel"`` (columns): data parallelism over independent links.

Rank r sits at (r // n_channel, r % n_channel), as ``jax.devices()``
reshaped to (n_time, n_channel). Each rank holds the process group of
its row (the ranks along "channel") and of its column (along "time").
Every rank creates every group, in the same order, as
``torch.distributed.new_group`` requires. Without a process group the
mesh is 1 × 1 and every collective is the identity.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

AXES = ("time", "channel")


@dataclasses.dataclass(frozen=True)
class LinkMesh:
    """This rank's view of the (n_time, n_channel) mesh."""

    n_time: int
    n_channel: int
    rank: int
    groups: dict  # axis -> the process group along it holding this rank (None: no group)
    world_group: object = None

    @property
    def shape(self) -> dict:
        return {"time": self.n_time, "channel": self.n_channel}

    @property
    def size(self) -> int:
        return self.n_time * self.n_channel

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if axis == "time":
            return self.rank // self.n_channel
        if axis == "channel":
            return self.rank % self.n_channel
        raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")

    def group(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")
        return self.groups[axis]

    def rank_at(self, t: int, c: int) -> int:
        """Global rank of mesh position (t, c)."""
        return t * self.n_channel + c


def make_link_mesh(n_time: int | None = None, n_channel: int | None = None) -> LinkMesh:
    """Build a ("time", "channel") mesh over the ranks of the process
    group (one rank without one).

    Defaults: all ranks on the channel axis (pure DP), as the JAX
    function; the same ``ValueError`` when the shape does not cover the
    ranks."""
    on = dist.is_initialized()
    n_dev = dist.get_world_size() if on else 1
    if n_time is None and n_channel is None:
        n_time, n_channel = 1, n_dev
    elif n_time is None:
        n_time = n_dev // n_channel
    elif n_channel is None:
        n_channel = n_dev // n_time
    if n_time * n_channel != n_dev:
        raise ValueError(f"mesh {n_time}x{n_channel} != {n_dev} devices")
    rank = dist.get_rank() if on else 0
    groups = {"time": None, "channel": None}
    world_group = None
    if on:
        t_me, c_me = divmod(rank, n_channel)
        for t in range(n_time):  # rows: the ranks along "channel"
            g = dist.new_group([t * n_channel + c for c in range(n_channel)])
            if t == t_me:
                groups["channel"] = g
        for c in range(n_channel):  # columns: the ranks along "time"
            g = dist.new_group([t * n_channel + c for t in range(n_time)])
            if c == c_me:
                groups["time"] = g
        world_group = dist.group.WORLD
    return LinkMesh(n_time, n_channel, rank, groups, world_group)


def mesh_info(mesh: LinkMesh) -> str:
    return f"mesh time={mesh.n_time} channel={mesh.n_channel} devices={mesh.size}"
