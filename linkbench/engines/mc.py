"""Engine adapter: ``link/mc.py::mc_simulate``, the Monte-Carlo link
(kernel G, one launch a pass, ``passes`` passes a call)."""

from __future__ import annotations

import torch

from linkbench.harness import link, workmodel
from linkbench.reference.link import mc_errors


REFERENCE_BLOCK = 128  # channels the reference computes at once


class Engine:
    def __init__(self, config: dict, traffic: dict, device: torch.device):
        from sdr_tpu_torch.link.mc import mc_simulate

        self.config, self.traffic, self.device = config, traffic, device
        self.cfg = link.link_config(config, traffic)
        self._simulate = mc_simulate
        self.passes = int(traffic["passes"])
        S, N, cp = config["n_symbols"], config["n_fft"], config["cp_len"]
        self.n_channels = config["n_channels"]
        self.bits_per_channel = S * N * self.cfg.modulation.bits_per_symbol * self.passes
        self.samples_per_call = self.n_channels * S * (N + cp) * self.passes

    def call(self, seed: int):
        return self._simulate(self.cfg, seed, iters=self.passes, device=self.device)

    def reference(self, seed: int, ch_ids: torch.Tensor, precision: str = "float32"):
        cfg, ch = link.plain(self.config), self.traffic["channel"]
        return link.in_blocks(lambda ids: mc_errors(cfg, ch, seed, self.passes, ids, precision),
                              ch_ids, REFERENCE_BLOCK)

    def stage_work(self, stage: str) -> workmodel.Work | None:
        """The work of kernel G's passes a call, the one stage this engine runs."""
        if stage != "mc":
            return None
        c = self.config
        one = workmodel.mc_pass(c["n_channels"], c["n_symbols"], c["n_fft"],
                                self.cfg.modulation.bits_per_symbol,
                                n_taps=link.n_taps(self.traffic),
                                fading_calls=link.fading_calls(self.traffic))
        return one * self.passes

    def link_work(self) -> workmodel.Work:
        c = self.config
        one = workmodel.link(c["n_channels"], c["n_symbols"], c["n_fft"],
                             self.cfg.modulation.bits_per_symbol, n_taps=link.n_taps(self.traffic),
                             fading_calls=link.fading_calls(self.traffic))
        return one * self.passes
