"""The window's loop and seed rule on the port's CPU path at a tiny size,
held against the plain reference; and the harness's faults: each
planted under the timed path turns ``correct`` false."""

import time

import numpy as np
import pytest
import torch

from linkbench.harness import check, runner, spec
from linkbench.harness.window import Spans, invocation_seed, run_window

CELLS = [w["name"] for w in spec.manifest()["workloads"]]
SEED = 3_000_000_019  # above 2**31: seeds that large must work


def tiny(name, channels=8, symbols=4, calls=2):
    c = spec.cell(name)
    c.config = dict(c.config, n_channels=channels, n_symbols=symbols)
    c.checks = dict(c.checks, channels=min(c.checks["channels"], channels), calls=calls)
    return c


def _seconds(cell):
    return 3.0 if cell.traffic["engine"] == "ldpc" else 1.0


def test_invocation_seed_rule():
    assert invocation_seed(7, 0, 0) == (7 * 0x9E3779B1) & 0x7FFFFFFF
    assert invocation_seed(7, 1, 5) == (7 * 0x9E3779B1 + 1_000_003 + 5) & 0x7FFFFFFF
    assert 0 <= invocation_seed(SEED, 0, 3) < 2**31
    with pytest.raises(ValueError):
        invocation_seed(1, 0, 1_000_003)


def test_window_keeps_a_seeded_sample_and_counts_every_call():
    n, bits = 4, 100
    calls = []

    def call(seed):
        calls.append(seed)
        return (torch.full((n,), seed % 7, dtype=torch.int32),
                torch.full((n,), bits, dtype=torch.int32))

    w = run_window(call, n, bits, SEED, 0.2, 2, torch.device("cpu"), Spans(), keep=3)
    assert w.attempted == len(calls) > 3 and w.failed == 0
    assert calls == [invocation_seed(SEED, 0, k) for k in range(len(calls))]
    assert w.bits == bits * n * len(calls)
    assert w.errors == sum(n * (s % 7) for s in calls)
    assert len(w.kept) == 3
    for index, (seed, errs) in w.kept.items():
        assert seed == calls[index] and (errs == seed % 7).all()
    assert all(c.t_start <= c.t_return <= c.t_done for c in w.calls)


def test_window_counts_a_wrong_bit_count_and_a_raise_as_failed():
    def call(seed):
        if seed % 2:
            raise RuntimeError("boom")
        return torch.zeros(2, dtype=torch.int32), torch.full((2,), 9, dtype=torch.int32)

    w = run_window(call, 2, 10, 5, 0.1, 2, torch.device("cpu"), Spans(), keep=2)
    assert w.failed == w.attempted > 0


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_cpu_path_is_correct(name):
    cell = tiny(name)
    out = runner.run_cell(cell, SEED, _seconds(cell), False, "cpu", time.perf_counter())
    assert out["correct"], out["check"]
    assert out["check"]["err_gap_ppm"]["value"] == 0.0
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert {m["name"] for m in cell.end_to_end} == set(out["metrics"])


def test_sampled_channels_follow_the_seed():
    a = check.sample_channels(SEED, 3, 8192, 1024)
    assert (a == check.sample_channels(SEED, 3, 8192, 1024)).all()
    assert len(np.unique(a)) == 1024
    assert not (a == check.sample_channels(SEED + 1, 3, 8192, 1024)).all()


def _stale(call):
    """A step that returns its state unchanged: every call after the
    first hands back the first call's counts."""
    first = []

    def wrapped(seed):
        out = call(seed)
        if not first:
            first.append(tuple(t.clone() for t in out))
        return first[0]
    return wrapped


def _half_batch(call):
    """Half of the batch left out, the mean of the rest in its place."""
    def wrapped(seed):
        errs, counted = call(seed)
        half = errs.shape[0] // 2
        errs = errs.clone()
        errs[half:] = errs[:half].float().mean().round().to(errs.dtype)
        return errs, counted
    return wrapped


def _altered(call):
    """An answer altered where it is produced: each channel's count off by one."""
    def wrapped(seed):
        errs, counted = call(seed)
        return errs + 1, counted
    return wrapped


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    cell = tiny(name)
    out = runner.run_cell(cell, SEED, _seconds(cell), False, "cpu", time.perf_counter(),
                          wrap=fault)
    assert not out["correct"], out["check"]
    assert out["check"]["err_gap_ppm"]["value"] > cell.checks["limits"]["err_gap_ppm"]
