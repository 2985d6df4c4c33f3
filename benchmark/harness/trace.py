"""The traced run: the profiler over whole jobs, the host's stages as
intervals, and their reduction to busy time, idle gaps and kernel sums.

Device intervals come from ``torch.profiler`` (CUPTI); host stages from
the program's ``stage_timer``, wrapped in every loaded module of the
program for the traced jobs.  Both are on the host's wall clock in
nanoseconds (``time.time_ns``), the clock the profiler converts its
timestamps to.  The arithmetic (device ``busy`` share and idle gaps from a
frozen copy of ``chip_smoke.device_profile`` at commit 15258b49d6b0, recast
to a union of intervals over the traced window) is plain Python, tested on
the CPU.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


@dataclass
class Kernel:
    name: str
    start: float       # s, wall clock
    dur: float         # s


@dataclass
class Stage:
    name: str
    start: float
    end: float


def union_seconds(intervals: List[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The gaps in [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def stage_at(stages: List[Stage], t: float) -> str:
    """The innermost host stage open at time ``t``."""
    best = None
    for st in stages:
        if st.start <= t < st.end and (best is None or st.end - st.start < best.end - best.start):
            best = st
    return best.name if best is not None else "harness"


def idle_by_stage(kernels: List[Kernel], stages: List[Stage], lo: float, hi: float,
                  top: int = 10) -> List[List]:
    """Idle seconds of the device by the host stage open at each gap's
    midpoint, largest first."""
    acc: Dict[str, float] = defaultdict(float)
    for s, e in idle_gaps([(k.start, k.start + k.dur) for k in kernels], lo, hi):
        acc[stage_at(stages, 0.5 * (s + e))] += e - s
    return [[n, v] for n, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(kernels: List[Kernel], top: int = 10) -> List[List]:
    """Device seconds by operation name, largest first."""
    acc: Dict[str, float] = defaultdict(float)
    for k in kernels:
        acc[k.name[:120]] += k.dur
    return [[n, v] for n, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def base_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::k2_cluster<8>(
    SweepArgs)`` -> ``k2_cluster``."""
    s = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return s.split("::")[-1].split(" ")[-1]


def kernel_base_seconds(kernels: List[Kernel], prefixes) -> Tuple[float, int]:
    """(device seconds, instances) of the kernels whose base name starts with
    one of ``prefixes``."""
    hit = [k for k in kernels if base_name(k.name).startswith(tuple(prefixes))]
    return sum(k.dur for k in hit), len(hit)


@dataclass
class TraceContext:
    """What the per-layer metric readers get from a traced run."""

    jobs: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: List[Kernel] = field(default_factory=list)
    stages: List[Stage] = field(default_factory=list)
    stage_s: Dict[str, float] = field(default_factory=dict)     # program's stage walls, summed
    host_reads: Dict[str, int] = field(default_factory=dict)    # program's counter, summed
    records: Dict[str, list] = field(default_factory=dict)      # calls kept by readers' hooks
    breakdown: Dict[str, list] = field(default_factory=dict)    # the result line's breakdown


# ---------------------------------------------------------------------------
# capture (on the card)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def host_stages(stages: List[Stage]):
    """Within the block, every ``stage_timer`` the loaded program modules
    call also appends its interval (wall clock, s) to ``stages``."""
    from ltm_torch.utils import logging as lg

    original = lg.stage_timer

    @contextlib.contextmanager
    def recording(stage, logger=None):
        t0 = time.time_ns()
        try:
            with original(stage, logger):
                yield
        finally:
            stages.append(Stage(stage, t0 * 1e-9, time.time_ns() * 1e-9))

    patched = [m for name, m in list(sys.modules.items())
               if name.split(".", 1)[0] == "ltm_torch" and getattr(m, "stage_timer", None) is original]
    for m in patched:
        m.stage_timer = recording
    try:
        yield
    finally:
        for m in patched:
            m.stage_timer = original


def profiled_kernels(prof) -> List[Kernel]:
    """Device operations of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        out.append(Kernel(e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
    return out


def align(kernels: List[Kernel], lo: float, hi: float) -> List[Kernel]:
    """The kernels, checked to be on the host's wall clock: the first must
    start within the traced window (a second of slack before it).  A
    profiler on another clock raises: its idle gaps could not be labelled."""
    if kernels:
        first = min(k.start for k in kernels)
        if not lo - 1.0 <= first <= hi:
            raise RuntimeError(f"the profiler's first kernel at {first:.3f} s lies outside "
                               f"the traced window [{lo:.3f}, {hi:.3f}] s of the wall clock")
    return kernels
