"""State carried across from the JAX package.

- ``link_config_from_reference``: a ``sdr_tpu`` ``LinkConfig`` → the
  port's ``LinkConfig``, through the reference's own dict form
  (``link_config_to_dict``, looked up on the object's module, so this
  package never imports JAX itself) and the port's
  ``link_config_from_dict``; validation runs again on the way in.
- numpy → tensor helpers for the channel state the parity tests feed
  both packages: symbol indices, flat gains and injected noise planes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sdr_tpu_torch.core.config import LinkConfig, link_config_from_dict


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
