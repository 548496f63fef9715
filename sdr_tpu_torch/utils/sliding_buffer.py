"""Sliding (circular) buffers — host-side and functional on tensors (port
of ``sdr_tpu/utils/sliding_buffer.py``).

The reference's ``utils::sliding_buffer<T>``
(the reference library's lib/inc/sliding_buffer.hpp:14-104) is a fixed-capacity
ring used by its demo GUI for plot history: logical index ``pos`` maps
to ``data_[(cur_ + pos) % size]`` (sliding_buffer.hpp:73-76), range
``push_back`` splits the copy at the physical end and wraps
(sliding_buffer.hpp:78-88), checked ``at()`` reports
"pos=N exceeds size=M" (sliding_buffer.hpp:59-65).

- ``SlidingBuffer`` — a host-side Python ring with the reference's exact
  indexing/push/saturation semantics (the JAX package's class, copied:
  the port imports nothing of it). The demo keeps its plot and text
  history in it, as the reference GUI does (QFDemoWindow.cpp:20-21).
- ``RingState`` + ``ring_*`` — the functional fixed-shape ring on
  tensors (the JAX package's jit ring as plain functions): state in,
  state out, the cursor a 0-d int32 tensor on the ring's device, so a
  push, a read and a window never wait for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


class SlidingBuffer:
    """Host-side fixed-capacity ring with reference-exact semantics."""

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError(f"size must be positive, got {size}")
        self._data = [0] * size
        self._cur = 0

    def __len__(self) -> int:
        return len(self._data)

    def size(self) -> int:
        return len(self._data)

    def __getitem__(self, pos: int):
        # Logical index relative to the head (sliding_buffer.hpp:73-76).
        return self._data[(self._cur + pos) % len(self._data)]

    def __setitem__(self, pos: int, val) -> None:
        self._data[(self._cur + pos) % len(self._data)] = val

    def at(self, pos: int):
        """Checked access; raises IndexError with the reference's message."""
        if pos >= len(self._data) or pos < 0:
            raise IndexError(f"pos={pos} exceeds size={len(self._data)}")
        return self[pos]

    def push_back(self, values) -> None:
        """Append a scalar or an iterable, wrapping at the physical end.

        Mirrors sliding_buffer.hpp:78-94: copy up to the physical end
        from the cursor, wrap the remainder to the front, leave the
        cursor one past the last written element.
        """
        if not isinstance(values, (list, tuple)) and not hasattr(values, "__iter__"):
            values = [values]
        vals = list(values)
        size = len(self._data)
        free = size - self._cur
        if len(vals) - free > size:
            # The reference's behavior here is an untested overflow
            # (SURVEY.md component #11); reject instead of corrupting.
            raise ValueError(
                f"push of {len(vals)} overflows capacity {size} (cur={self._cur})"
            )
        head = vals[: min(free, len(vals))]
        self._data[self._cur : self._cur + len(head)] = head
        if len(head) == free and len(vals) > len(head):
            rest = vals[len(head) :]
            self._data[: len(rest)] = rest
            self._cur = len(rest)
        else:
            self._cur = self._cur + len(head)
            if self._cur == size:
                self._cur = 0

    def __iter__(self):
        for i in range(len(self._data)):
            yield self[i]

    def tolist(self) -> list:
        return list(iter(self))


# ---------------------------------------------------------------------------
# Functional ring on tensors.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RingState:
    """Functional ring state: fixed-shape data + cursor (both tensors)."""

    data: torch.Tensor  # (capacity, ...) — slot 0 is physical, not logical
    cur: torch.Tensor  # int32 0-d: next write position == logical head


def ring_new(capacity: int, dtype=torch.float32, item_shape: Sequence[int] = (),
             device="cuda") -> RingState:
    """Zero-initialised ring on ``device`` (the reference zero-fills too,
    hpp:53)."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    return RingState(
        data=torch.zeros((capacity, *item_shape), dtype=dtype, device=device),
        cur=torch.zeros((), dtype=torch.int32, device=device),
    )


def _slots(state: RingState, pos: torch.Tensor) -> torch.Tensor:
    """Physical slots (int64) of logical positions ``pos`` from the head."""
    return torch.remainder(state.cur.to(torch.int64) + pos, state.data.shape[0])


def ring_push(state: RingState, values: torch.Tensor) -> RingState:
    """Push ``values`` (leading axis = count) with wrap-around; returns the
    new state (the old one is left as it was).

    The count must be <= capacity (the reference's behaviour beyond that
    is an untested overflow, SURVEY.md component #11 — rejected here)."""
    n = values.shape[0]
    cap = state.data.shape[0]
    if n > cap:
        raise ValueError(f"push of {n} exceeds capacity {cap}")
    idx = _slots(state, torch.arange(n, device=state.data.device))
    data = state.data.index_copy(0, idx, values.to(state.data.dtype))
    return RingState(data=data, cur=torch.remainder(state.cur + n, cap).to(torch.int32))


def ring_read(state: RingState, pos) -> torch.Tensor:
    """Logical read relative to the head: data[(cur + pos) % capacity]."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=state.data.device)
    return state.data[_slots(state, pos)]


def ring_window(state: RingState) -> torch.Tensor:
    """The full buffer in logical order (oldest at the head), shape-stable:
    the reference buffer iterated begin()..end()."""
    return state.data[_slots(state, torch.arange(state.data.shape[0],
                                                 device=state.data.device))]
