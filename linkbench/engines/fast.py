"""Engine adapter: ``link/fast.py::fast_simulate``, the keyed fast link
(kernel A's payload, kernel B's TX, channel and noise, kernel C's count)."""

from __future__ import annotations

import torch

from linkbench.harness import link, workmodel
from linkbench.reference.link import uncoded_errors


REFERENCE_BLOCK = 256  # channels the reference computes at once


class Engine:
    def __init__(self, config: dict, traffic: dict, device: torch.device):
        from sdr_tpu_torch.link.fast import fast_simulate

        self.config, self.traffic, self.device = config, traffic, device
        self.cfg = link.link_config(config, traffic)
        self._simulate = fast_simulate
        self.layout = traffic.get("layout", "auto")
        S, N, cp = config["n_symbols"], config["n_fft"], config["cp_len"]
        self.n_channels = config["n_channels"]
        self.bits_per_channel = S * N * self.cfg.modulation.bits_per_symbol
        self.samples_per_call = self.n_channels * S * (N + cp)

    def call(self, seed: int):
        return self._simulate(self.cfg, seed, device=self.device, layout=self.layout)

    def reference(self, seed: int, ch_ids: torch.Tensor, precision: str = "float32"):
        cfg, ch = link.plain(self.config), self.traffic["channel"]
        return link.in_blocks(lambda ids: uncoded_errors(cfg, ch, seed, ids, precision), ch_ids,
                              REFERENCE_BLOCK)

    def stage_work(self, stage: str) -> workmodel.Work | None:
        """The work of one kernel's stage a call at this cell's shapes, for
        the stages this engine runs: B's TX and channel, C's count."""
        c, bps = self.config, self.cfg.modulation.bits_per_symbol
        B, S, N, cp = c["n_channels"], c["n_symbols"], c["n_fft"], c["cp_len"]
        if stage == "tx":
            model = self.traffic["channel"]["model"]
            return workmodel.tx(B, S, N, cp, bps, n_taps=link.n_taps(self.traffic),
                                gains=model in ("rayleigh_flat", "rician", "rayleigh_time"))
        if stage == "demod":
            return workmodel.demod_count(B, S, N, bps)
        return None

    def link_work(self) -> workmodel.Work:
        c = self.config
        return workmodel.link(c["n_channels"], c["n_symbols"], c["n_fft"],
                              self.cfg.modulation.bits_per_symbol, n_taps=link.n_taps(self.traffic),
                              fading_calls=link.fading_calls(self.traffic))
