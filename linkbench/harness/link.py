"""The simulator's link configuration from a cell's configuration and
traffic files, and the reference's plain view of the same link."""

from __future__ import annotations

import torch

from linkbench.reference.link import BITS


def link_config(config: dict, traffic: dict):
    """The port's ``LinkConfig``: the configuration's numerology, the
    traffic's channel."""
    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelModel,
        Equalizer,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )

    ch = traffic["channel"]
    channel = ChannelConfig(model=ChannelModel(ch["model"]), ebno_db=float(ch["ebno_db"]),
                            pdp=tuple(float(p) for p in ch.get("pdp", (1.0,))))
    return LinkConfig(modulation=Modulation(config["modulation"]),
                      ofdm=OFDMConfig(n_fft=config["n_fft"], cp_len=config["cp_len"]),
                      channel=channel, equalizer=Equalizer(config["equalizer"]),
                      n_symbols=config["n_symbols"], n_channels=config["n_channels"])


def plain(config: dict) -> dict:
    """The numerology as the reference reads it."""
    return {"n_symbols": config["n_symbols"], "n_fft": config["n_fft"],
            "cp_len": config["cp_len"], "modulation": config["modulation"],
            "bits_per_symbol": BITS[config["modulation"]]}


def n_taps(traffic: dict) -> int:
    ch = traffic["channel"]
    return len(ch.get("pdp", ())) if ch["model"] in ("multipath", "multipath_time") else 0


def fading_calls(traffic: dict) -> int:
    """Philox calls a channel's fading draw takes: one a tap, one a flat gain."""
    return n_taps(traffic) or (1 if traffic["channel"]["model"] == "rayleigh_flat" else 0)


def in_blocks(fn, ch_ids: torch.Tensor, block: int) -> torch.Tensor:
    """fn over ``ch_ids`` in blocks of ``block`` channels, concatenated."""
    return torch.cat([fn(ch_ids[i:i + block]) for i in range(0, ch_ids.shape[0], block)])
