"""The control: the plain reference computed in bfloat16 fails each cell's
check, read against the reference in float32 over the same sample. On
the CPU at a size a test run holds; on the card (``gpu``) at the cell's
own size on three seeds, as its limit was set."""

import numpy as np
import pytest
import torch

from linkbench.harness import check, spec

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def _control_gap(cell, device, seeds, calls, channels):
    engine = spec.load_module("engines", cell.traffic["engine"]).Engine(cell.config, cell.traffic,
                                                                        device)
    gaps = []
    for seed in seeds:
        picked = []
        for k in range(calls):
            chans = check.sample_channels(seed, k, engine.n_channels, channels)
            ids = torch.as_tensor(chans, dtype=torch.int32, device=device)
            picked.append((seed * 7 + k, ids, None))
        ctl = [engine.reference(s, ids, "bf16").cpu().numpy() for s, ids, _ in picked]
        gaps.append(check.reference_gap(engine, picked, against=ctl))
    return gaps


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(name):
    cell = spec.cell(name)
    coded = cell.traffic["engine"] == "ldpc"
    cell.config = dict(cell.config, n_channels=256, n_symbols=8 if coded else 4)
    gaps = _control_gap(cell, torch.device("cpu"), [11], 1, 64 if coded else 32)
    assert min(gaps) > cell.checks["limits"]["err_gap_ppm"], gaps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cell_size(name, cuda):
    cell = spec.cell(name)
    gaps = _control_gap(cell, cuda, [21, 22, 23], cell.checks["calls"], cell.checks["channels"])
    assert np.min(gaps) > cell.checks["limits"]["err_gap_ppm"], gaps
