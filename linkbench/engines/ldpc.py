"""Engine adapter: ``link/fast_coded.py::ldpc_fast_simulate``, the
LDPC-coded link (torch info bits, encode and interleave, kernel B, kernel
C's LLR plane, the deinterleave gather, kernel H's min-sum decode)."""

from __future__ import annotations

import math

import torch

from linkbench.harness import link, workmodel
from linkbench.reference import ldpc as ref_ldpc


REFERENCE_BLOCK = 128  # channels the reference computes at once


class Engine:
    def __init__(self, config: dict, traffic: dict, device: torch.device):
        from sdr_tpu_torch.link.fast_coded import ldpc_fast_simulate

        self.config, self.traffic, self.device = config, traffic, device
        self.cfg = link.link_config(config, traffic)
        self._simulate = ldpc_fast_simulate
        self.code = traffic["code"]
        nb, mb, z = self.code["nb"], self.code["mb"], self.code["z"]
        S, N, cp = config["n_symbols"], config["n_fft"], config["cp_len"]
        bps = self.cfg.modulation.bits_per_symbol
        self.n = nb * z
        self.k = (nb - mb) * z
        self.n_cw = S * N * bps // self.n
        self.n_channels = config["n_channels"]
        self.bits_per_channel = self.n_cw * self.k
        self.samples_per_call = self.n_channels * S * (N + cp)

    def call(self, seed: int):
        c = self.code
        return self._simulate(self.cfg, seed, rate=c["rate"], iters=c["iters"],
                              schedule=c["schedule"], seam=c["seam"], device=self.device)

    def reference(self, seed: int, ch_ids: torch.Tensor, precision: str = "float32"):
        cfg, ch = link.plain(self.config), self.traffic["channel"]
        return link.in_blocks(
            lambda ids: ref_ldpc.coded_errors(cfg, ch, self.code, seed, ids, precision), ch_ids,
            REFERENCE_BLOCK)

    def decoder_edges(self) -> int:
        """Lifted edges of one codeword's graph."""
        var, valid = ref_ldpc.lifted_rows(self.code["nb"], self.code["mb"], self.code["z"])
        return int(valid.sum())

    def stage_work(self, stage: str) -> workmodel.Work | None:
        """The work a call of the stages whose shares this cell reports: C's
        LLR plane on the staged seam, H's decode."""
        c = self.config
        if stage == "demod":
            return workmodel.demod_plane(c["n_channels"], c["n_symbols"], c["n_fft"],
                                         self.cfg.modulation.bits_per_symbol)
        if stage == "ldpc":
            return workmodel.ldpc_decode(c["n_channels"] * self.n_cw, self.n,
                                         self.decoder_edges(), self.code["iters"])
        return None

    def link_work(self) -> workmodel.Work:
        c = self.config
        B = c["n_channels"]
        info_calls = B * self.n_cw * math.ceil(self.k / 128)
        decode = self.stage_work("ldpc")
        return workmodel.link(B, c["n_symbols"], c["n_fft"], self.cfg.modulation.bits_per_symbol,
                              fading_calls=link.fading_calls(self.traffic),
                              payload_calls=info_calls, extra=workmodel.Work(flops=decode.flops))
