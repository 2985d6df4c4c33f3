#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``ltm_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ltm_torch/csrc`` (nvcc,
sm_90a), then runs four phases, each of which raises on failure:

  1. device and build: the card, PyTorch/CUDA versions, kernel build time;
  2. kernel vs plain: ``knn2_sqdists`` (CUDA) against ``knn2_sqdists_plain``
     on the card, on a masked case, a duplicate-target case and a km-scale
     case, to 1 ulp and with identical kNN decisions at 0.04 and 1.0;
  3. card vs CPU: ``Removerter.run`` on a small synthetic survey on the CPU
     (plain versions) and on the card (kernels); the 14 named point sets
     agree within max(2, 1e-4·|set|) points;
  4. full width: the LT-removert pipeline workload of ``bench.py`` (two
     sessions x 48 keyframes x 120k points, 0.1 m voxels, brute kNN) once to
     warm up and three timed times, then once under ``torch.profiler``;
     every kernel of the path must launch in every timed run.

It prints one JSON object per kernel line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.  The port imports neither ``jax`` nor ``ltm``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H100_FP32_FLOPS = 67e12      # non-tensor FP32 peak, H100 SXM (an FMA counts as two)
H100_BYTES_PER_S = 3.35e12   # HBM3 peak, H100 SXM


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=3):
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ulps_apart(a, b):
    """Largest distance in float32 ulps between two finite arrays."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


def knn2_bound(qm, tm):
    """(ms, "bytes" or "operations"): the least time for the 2-NN of these
    inputs, the larger of the bytes it must move (points and masks read
    once, (N,2) written once) over the memory rate and its float32
    operations (8 per valid pair) over the non-tensor FP32 rate."""
    n, m = qm.numel(), tm.numel()
    t_bytes = (13 * n + 13 * m + 8 * n) / H100_BYTES_PER_S
    t_ops = 8.0 * int(qm.sum()) * int(tm.sum()) / H100_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def library_knn2_ms(q, qm, t, tm, chunk=1024) -> float:
    """Yardstick only (the port never calls it): ``torch.cdist`` +
    ``torch.topk`` over the valid points, in query chunks of ``chunk`` so
    the distance block fits; no single PyTorch call computes a masked 2-NN."""
    import torch

    qv, tv = q[qm], t[tm]

    def run():
        for i in range(0, qv.shape[0], chunk):
            d = torch.cdist(qv[i:i + chunk], tv)
            torch.topk(d, 2, dim=1, largest=False)

    run()
    return cuda_ms(run, reps=1)


def compare_knn2(name, q, qm, t, tm, timed=False):
    """Kernel vs plain on the card: 1 ulp, same decisions.  Returns stats."""
    import torch

    from ltm_torch.kernels.knn2 import knn2_sqdists, knn2_sqdists_plain

    before = knn2_sqdists.launches
    got = knn2_sqdists(q, qm, t, tm)
    torch.cuda.synchronize()
    ref = knn2_sqdists_plain(q, qm, t, tm)
    torch.cuda.synchronize()
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    ulps = ulps_apart(g, r)
    if ulps > 1:
        raise AssertionError(f"{name}: kernel and plain differ by {ulps} ulps")
    for thr in (0.04, 1.0):
        if not np.array_equal(g.mean(1) < thr, r.mean(1) < thr):
            raise AssertionError(f"{name}: kNN decisions at {thr} differ")
    valid = qm.cpu().numpy()
    stats = {"case": name, "n": q.shape[0], "m": t.shape[0], "ulps": ulps,
             "max_abs_err": float(np.abs(g[valid] - r[valid]).max(initial=0.0))}
    if timed:
        stats["kernel_ms"] = cuda_ms(lambda: knn2_sqdists(q, qm, t, tm))
        stats["plain_ms"] = cuda_ms(lambda: knn2_sqdists_plain(q, qm, t, tm), reps=1)
        stats["library_ms"] = library_knn2_ms(q, qm, t, tm)
        stats["bound_ms"], stats["bound_by"] = knn2_bound(qm, tm)
    knn2_sqdists.launches = before      # comparison launches do not count
    return stats


def km_scale_case(rng, n=16385, m=300_000):
    """Survey-like points ~1 km from the origin at ~0.05 m spacing, 20%
    invalid on both sides; n is not a multiple of the kernel's block."""
    side = int(np.ceil((m / 12) ** 0.5))
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side), np.arange(12)), -1).reshape(-1, 3)[:m]
    t = (g * 0.05 + [1000.0, -700.0, 3.0] + rng.normal(0, 0.01, (m, 3))).astype(np.float32)
    q = (t[rng.choice(m, n)] + rng.normal(0, 0.15, (n, 3))).astype(np.float32)
    return q, rng.uniform(size=n) > 0.2, t, rng.uniform(size=m) > 0.2


def device_profile(fn, top=8):
    """One profiled call of ``fn``: the card's busy share (summed kernel
    time over the wall, which the profiler's own host cost inflates, so the
    share is a lower bound) and the kernels that took the most device time.
    Only the kernels' own entries are summed: the CPU operators that launch
    them report the same device time again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall if busy_us else "not measured",
            "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3 for e in events[:top]}}


def set_difference(a: np.ndarray, b: np.ndarray, tol: float = 1e-4) -> int:
    """Points of either set with no point of the other within ``tol``."""
    from scipy.spatial import cKDTree

    if len(a) == 0 or len(b) == 0:
        return len(a) + len(b)
    da, _ = cKDTree(b).query(a, distance_upper_bound=tol)
    db, _ = cKDTree(a).query(b, distance_upper_bound=tol)
    return int(np.isinf(da).sum() + np.isinf(db).sum())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from ltm_torch.core.config import RemovertConfig
    from ltm_torch.io import native
    from ltm_torch.io.synthetic import synth_session
    from ltm_torch.kernels._build import build_all
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter, RemovertInput
    from ltm_torch.removert.pipeline import MASK_NAMES
    from ltm_torch.utils import reset_slot_counts, reset_stage_times, slot_counts, stage_times

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: device and build --------------------------------------
    log(f"[1] card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = build_all()
    log(f"[1] kernels built in {time.perf_counter() - t0:.2f} s: {sorted(logs) or 'cached'}")
    for name, text in logs.items():
        log(f"[1] nvcc {name}.cu:\n{text.strip()}")
    log(f"[1] native/libltm_native.so loaded: {native.available()}"
        + ("" if native.available() else " (host voxels: first point per voxel)"))

    # ---- phase 2: kernel vs plain on the card ---------------------------
    rng = np.random.default_rng(0)
    q = rng.normal(size=(700, 3)).astype(np.float32) * 5
    t = rng.normal(size=(1500, 3)).astype(np.float32) * 5
    qm = np.ones(700, bool)
    qm[13] = False
    cases = [("masked", q, qm, t, rng.uniform(size=1500) > 0.2)]
    td = np.tile(np.array([[1.0, 0, 0], [1.0, 0, 0], [5.0, 0, 0]], np.float32), (200, 1))[:512]
    cases.append(("duplicates", np.zeros((8, 3), np.float32), np.ones(8, bool), td, np.ones(512, bool)))
    cases.append(("km_scale",) + km_scale_case(rng))
    for name, *arrays in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        st = compare_knn2(name, *args, timed=(name == "km_scale"))
        if name == "duplicates" and not np.allclose(
                knn2_sqdists(*args).cpu().numpy(), 1.0, atol=1e-6):
            raise AssertionError("duplicate targets must count twice")
        log(f"[2] {json.dumps(st)}")
    knn2_sqdists.launches = 0

    # ---- phase 3: card vs CPU on a small survey --------------------------
    def workload(n_kf, n_pts, traj):
        r = np.random.default_rng(0)
        c_scans, c_poses = synth_session(r, n_kf, n_pts, traj=traj, phase=0.0)
        q_scans, q_poses = synth_session(r, n_kf, n_pts, traj=traj, phase=0.25)
        return RemovertInput(scans=c_scans, poses=c_poses), RemovertInput(scans=q_scans, poses=q_poses)

    cfg = RemovertConfig()
    cfg.downsample_voxel_size = 0.1
    cfg.use_chunk_knn = False      # the chunked kNN is ported in a later slice
    small = workload(4, 6000, 300.0)
    res_cpu = Removerter(cfg, device="cpu").run(*small)
    res_gpu = Removerter(cfg, device="cuda").run(*small)
    counts = {}
    for name in MASK_NAMES:
        a, b = res_cpu.points(name), res_gpu.points(name)
        diff = set_difference(a, b)
        counts[name] = [len(a), len(b), diff]
        if diff > max(2, 1e-4 * len(a)):
            raise AssertionError(f"card vs CPU: set {name} differs by {diff} points "
                                 f"(cpu {len(a)}, cuda {len(b)})")
    log(f"[3] card vs CPU, [cpu, cuda, symmetric difference] per set: {json.dumps(counts)}")

    # ---- phase 4: full width on the card --------------------------------
    os.environ["LTM_SYNC_STAGES"] = "1"   # stage walls include their device work
    full = workload(48, 120_000, 1200.0)
    rm = Removerter(cfg, device="cuda")
    runs = []
    for i in range(4):                     # run 0 warms up
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_stage_times()
        reset_slot_counts()
        torch.cuda.synchronize()
        knn2_sqdists.launches = 0
        t0 = time.perf_counter()
        result = rm.run(*full)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = knn2_sqdists.launches
        if launches <= 0:
            raise AssertionError("the full-width run never launched the knn2 kernel")
        n_kf = result.central.num_keyframes + result.query.num_keyframes
        runs.append({"run": i, "wall_s": wall, "keyframes_per_s": n_kf / wall,
                     "knn2_launches": launches, "stages_s": stage_times(),
                     "map_slots_per_stage": slot_counts()})
        log(f"[4] {json.dumps(runs[-1])}")
    sizes = {name: int(result.masks[name].sum()) for name in MASK_NAMES}
    for name in ("static_c", "static_q", "nd", "pd", "updated"):
        if sizes[name] == 0:
            raise AssertionError(f"full-width set {name} is empty")
    for m in result.masks.values():
        if m.shape[0] not in (result.central.map_xyz.shape[0], result.query.map_xyz.shape[0],
                              result.combined_xyz.shape[0]):
            raise AssertionError("a mask does not match its map")
    if not bool(torch.isfinite(result.combined_xyz).all()):
        raise AssertionError("non-finite map coordinates")
    timed = runs[1:]
    summary = {
        "median_keyframes_per_s": statistics.median(r["keyframes_per_s"] for r in timed),
        "median_wall_s": statistics.median(r["wall_s"] for r in timed),
        "keyframes": n_kf,
        "map_points": [int(result.central.map_mask.sum()), int(result.query.map_mask.sum())],
        "map_capacity": [result.central.map_xyz.shape[0], result.query.map_xyz.shape[0]],
        "set_sizes": sizes,
        "knn2_launches_per_run": [r["knn2_launches"] for r in timed],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"[4] {json.dumps(summary)}")
    log(f"[4] profiled run: {json.dumps(device_profile(lambda: rm.run(*full)))}")

    # the kernel at the main path's shapes: the ND kNN-diff call (central
    # map's eligible points against the query map's static points)
    c, qs = result.central, result.query
    args = (c.map_xyz, c.masks["static"] & c.masks["proj_static"], qs.map_xyz, qs.masks["static"])
    st = compare_knn2("full_width_nd", *args, timed=True)
    log(f"[4] {json.dumps(st)}")

    kernels = [{
        "name": "knn2_sqdists",
        "route": "cuda",
        "source": "ltm_torch/csrc/knn2.cu",
        "replaces": "ltm/kernels/pallas_knn.py:95",
        "launches": timed[-1]["knn2_launches"],
        "max_abs_err": st["max_abs_err"],
        "ms": st["kernel_ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "library_ms": st["library_ms"],
    }]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
