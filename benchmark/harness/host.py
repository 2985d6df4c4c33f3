"""What the host did around a measured window: its load, the share of its
CPU time taken by other guests (steal), the process's own CPU time, page
faults and context switches, and the host's speed on two fixed probes (a
pure-Python loop and a random gather over 64 MB) at each end.  Read from
``/proc``, ``os`` and ``resource``; recorded beside each run's numbers so
that a run that reads slow can be told apart by its host."""

from __future__ import annotations

import os
import resource
import time
from typing import Dict, List, Optional


def _cpu_jiffies() -> Optional[List[int]]:
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


_GATHER = None


def probe() -> Dict[str, float]:
    """Seconds of two fixed pieces of host work: one core's interpreter
    speed, and memory latency (the native voxel grid's hash lookups)."""
    global _GATHER
    import numpy as np
    if _GATHER is None:
        rng = np.random.default_rng(0)
        _GATHER = (np.arange(1 << 24, dtype=np.float32), rng.integers(0, 1 << 24, 1 << 21))
    t0 = time.perf_counter()
    s = 0
    for i in range(1_000_000):
        s += i
    t1 = time.perf_counter()
    _GATHER[0][_GATHER[1]].sum()
    return {"python_loop_s": t1 - t0, "gather_s": time.perf_counter() - t1}


def snapshot() -> Dict:
    t = os.times()
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "cpu": t.user + t.system,
            "load1": os.getloadavg()[0], "jiffies": _cpu_jiffies(),
            "minflt": r.ru_minflt, "nivcsw": r.ru_nivcsw, "nvcsw": r.ru_nvcsw, "probe": probe()}


def between(a: Dict, b: Dict) -> Dict[str, float]:
    """The host over [a, b]: load at each end, the steal share of all CPU
    time, the process's CPU seconds per wall second, its minor page faults
    and its involuntary and voluntary context switches, and each probe at
    both ends."""
    out = {"load1_start": a["load1"], "load1_end": b["load1"],
           "process_cpu_per_wall": (b["cpu"] - a["cpu"]) / max(b["wall"] - a["wall"], 1e-9),
           "minor_faults": b["minflt"] - a["minflt"],
           "involuntary_switches": b["nivcsw"] - a["nivcsw"],
           "voluntary_switches": b["nvcsw"] - a["nvcsw"]}
    for k in a["probe"]:
        out[f"{k}_start"], out[f"{k}_end"] = a["probe"][k], b["probe"][k]
    if a["jiffies"] and b["jiffies"]:
        d = [y - x for x, y in zip(a["jiffies"], b["jiffies"])]
        out["steal_share"] = (d[7] if len(d) > 7 else 0) / max(sum(d[:8]), 1)
    return out
