"""The measured window: jobs back to back, one in flight (a closed loop).

A job that starts before the deadline runs to its end and counts; the
window's time runs from its start to the last completion.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class Job:
    start: float
    end: float
    units: int                 # keyframes, or whatever the cell counts

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    start: float
    jobs: List[Job] = field(default_factory=list)
    device_s: Optional[float] = None   # the card's busy seconds, where the run profiles it

    @property
    def units(self) -> int:
        return sum(j.units for j in self.jobs)

    @property
    def seconds(self) -> float:
        return (self.jobs[-1].end - self.start) if self.jobs else 0.0

    def rate(self) -> float:
        """Units of all jobs over all the window's time."""
        return self.units / self.seconds

    def percentile(self, q: float) -> float:
        """Nearest-rank ``q``-th percentile of the jobs' walls."""
        walls = sorted(j.wall for j in self.jobs)
        return walls[max(math.ceil(q / 100.0 * len(walls)) - 1, 0)]


def run_window(job: Callable[[int], int], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``job(i)`` for i = 0, 1, ... while the clock is before the
    deadline; ``job`` returns its units once its work is complete."""
    w = Window(start=clock())
    deadline = w.start + seconds
    i = 0
    while clock() < deadline:
        s = clock()
        units = job(i)
        w.jobs.append(Job(s, clock(), units))
        i += 1
    return w
