"""The five BASELINE.json benchmark configs as named, runnable cases (port
of ``sdr_tpu/app/baseline_configs.py``, built on the port's
``core.config``).

BASELINE.json "configs" (the north-star scenarios) each map to a
LinkConfig here; tests and the smoke run take them by name or index.
Config 5's multi-host sharding is exercised via ``sdr_tpu_torch.parallel``
on whatever ranks are available.
"""

from __future__ import annotations

import dataclasses

from sdr_tpu_torch.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)


@dataclasses.dataclass(frozen=True)
class BaselineCase:
    name: str
    description: str
    cfg: LinkConfig
    ebno_sweep_db: tuple = ()  # non-empty → sweep case
    sharded: bool = False      # config 5: time+channel mesh sharding


def baseline_cases() -> list:
    """BASELINE.json configs[0..4], in order."""
    return [
        BaselineCase(
            name="qpsk64-awgn",
            description=(
                "QPSK over 64-subcarrier OFDM, CP 16, AWGN at 10 dB Eb/N0, "
                "1e6 bits (matches the reference lib/tests loopback, "
                "ofdm_test.cpp:11-36, plus the AWGN the reference lacks)"
            ),
            cfg=LinkConfig(
                modulation=Modulation.QPSK,
                ofdm=OFDMConfig(n_fft=64, cp_len=16),
                channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0),
                n_symbols=128,
                n_channels=62,  # 62*128*128 ≈ 1.016e6 bits
            ),
        ),
        BaselineCase(
            name="qam16-256-llr",
            description=(
                "16-QAM OFDM 256 subcarriers with max-log LLR soft output, "
                "Eb/N0 sweep 0-20 dB"
            ),
            cfg=LinkConfig(
                modulation=Modulation.QAM16,
                ofdm=OFDMConfig(n_fft=256, cp_len=64),
                channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0),
                n_symbols=64,
                n_channels=16,
            ),
            ebno_sweep_db=tuple(range(0, 21, 2)),
        ),
        BaselineCase(
            name="qam64-1024",
            description="64-QAM OFDM 1024 subcarriers + CP, BER vs theoretical AWGN bound",
            cfg=LinkConfig(
                modulation=Modulation.QAM64,
                ofdm=OFDMConfig(n_fft=1024, cp_len=128),
                channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=14.0),
                n_symbols=32,
                n_channels=8,
            ),
            ebno_sweep_db=tuple(range(4, 21, 2)),
        ),
        BaselineCase(
            name="multichannel-64",
            description=(
                "64 independent OFDM links batch-sharded across chips, "
                "per-channel BER (channel-axis data parallelism)"
            ),
            cfg=LinkConfig(
                modulation=Modulation.QAM16,
                ofdm=OFDMConfig(n_fft=256, cp_len=64),
                channel=ChannelConfig(
                    model=ChannelModel.MULTIPATH,
                    ebno_db=14.0,
                    pdp=(1.0, 0.5, 0.25, 0.125),
                ),
                equalizer=Equalizer.MMSE,
                n_symbols=32,
                n_channels=64,
            ),
            sharded=True,
        ),
        BaselineCase(
            name="wideband-multihost",
            description=(
                "256 channels x 4096-subcarrier OFDM, time-blocks sharded "
                "across hosts with boundary collectives (halo ppermute)"
            ),
            cfg=LinkConfig(
                modulation=Modulation.QAM16,
                ofdm=OFDMConfig(n_fft=4096, cp_len=512),
                channel=ChannelConfig(
                    model=ChannelModel.MULTIPATH,
                    ebno_db=14.0,
                    pdp=(1.0, 0.6, 0.3, 0.1, 0.05),
                ),
                equalizer=Equalizer.MMSE,
                n_symbols=16,
                n_channels=256,
            ),
            sharded=True,
        ),
    ]


def get_case(name_or_index: str) -> BaselineCase:
    cases = baseline_cases()
    try:
        return cases[int(name_or_index)]
    except (ValueError, IndexError):
        pass
    for c in cases:
        if c.name == name_or_index:
            return c
    raise KeyError(
        f"unknown baseline case {name_or_index!r}; "
        f"have {[c.name for c in cases]} (or index 0-4)"
    )
