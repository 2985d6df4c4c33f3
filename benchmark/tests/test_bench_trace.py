"""The trace's reduction: busy time, idle gaps by host stage, kernel names."""

import pytest

from harness.trace import (Kernel, Stage, align, base_name, device_ops, idle_by_stage,
                           idle_gaps, kernel_base_seconds, union_seconds)


def test_union_clips_and_merges():
    assert union_seconds([(0, 2), (1, 3), (5, 6), (9, 12)], 0, 10) == 3 + 1 + 1


def test_idle_gaps():
    assert idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [(0, 1), (3, 5), (6, 8)]
    assert idle_gaps([], 0, 1) == [(0, 1)]


def test_idle_labelled_by_innermost_stage():
    ks = [Kernel("a", 0.0, 1.0), Kernel("b", 3.0, 1.0), Kernel("a", 6.0, 4.0)]
    st = [Stage("job", 0.0, 10.0), Stage("prep", 1.0, 3.0)]
    assert idle_by_stage(ks, st, 0.0, 10.0) == [["prep", 2.0], ["job", 2.0]]


def test_device_ops_and_base_names():
    ks = [Kernel("void (anonymous namespace)::k2_cluster<8>(SweepArgs)", 0, 2e-3),
          Kernel("k3_cluster", 0, 1e-3), Kernel("void cub::CUB_1_NS::DeviceRadixSortOnesweepKernel<x>(y)", 0, 5e-3)]
    assert base_name(ks[0].name) == "k2_cluster"
    assert base_name(ks[2].name) == "DeviceRadixSortOnesweepKernel"
    assert kernel_base_seconds(ks, ("k2_", "k3_")) == (3e-3, 2)
    assert device_ops(ks)[0][0].endswith("(y)")


def test_align_refuses_a_profiler_on_another_clock():
    ks = [Kernel("a", 100.5, 1e-3), Kernel("b", 101.0, 1e-3)]
    assert align(ks, 100.0, 102.0) == ks
    with pytest.raises(RuntimeError):
        align(ks, 5000.0, 5002.0)
