#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``ltm_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ltm_torch/csrc`` (nvcc,
sm_90a), then runs four phases, each of which raises on failure:

  1. device and build: the card, PyTorch/CUDA versions, kernel build time,
     the ``-Xptxas -v`` report, and the scan kernel's hot block read from
     ``cuobjdump -sass`` (full dump in ``chiprun_out/knn2.sass``);
  2. kernel vs plain: ``knn2_sqdists`` (CUDA) against ``knn2_sqdists_plain``
     on the card at 0 ulps, on a masked case, duplicate targets, duplicates
     straddling a target-split boundary, a split-heavy case, all queries
     invalid, no valid target, one valid target, a valid-query count that
     is not a multiple of a CTA's queries, and a km-scale case (timed);
  3. card vs CPU: ``Removerter.run`` on a small synthetic survey on the CPU
     (plain versions) and on the card (kernels); the 14 named point sets
     agree within max(2, 1e-4·|set|) points;
  4. full width: the LT-removert pipeline workload of ``bench.py`` (two
     sessions x 48 keyframes x 120k points, 0.1 m voxels, brute kNN) once to
     warm up (recording the three knn2 calls: ND, PD, weak->strong
     promotion) and three timed times, then once under ``torch.profiler``;
     every kernel of the path must launch in every timed run.  Each of the
     three recorded calls is then held to the plain version at 0 ulps and
     timed against its bound.

Every timed call whose targets split is also run and timed with the plan
held at one split, which must give the same bits.

It prints one JSON object per kernel line, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.  The port imports neither ``jax`` nor ``ltm``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

H100_FP32_FLOPS = 67e12      # non-tensor FP32 peak, H100 SXM (an FMA counts as two)
H100_BYTES_PER_S = 3.35e12   # HBM3 peak, H100 SXM
OUT_DIR = "chiprun_out"


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


def plan_of(q, qm, t, tm):
    """(splits, chunk) the wrapper plans for these inputs on this card."""
    from ltm_torch.kernels import knn2

    return knn2._device_plan(q.device, int(qm.sum()), int(tm.sum()))


def unsplit(fn):
    """``fn()`` with the wrapper's launch plan held at one target split."""
    from ltm_torch.kernels import knn2

    plan = knn2._plan
    knn2._plan = lambda *args: 1
    try:
        return fn()
    finally:
        knn2._plan = plan


def compare_knn2(name, q, qm, t, tm, timed=False, library=False, launches=1):
    """Kernel vs plain on the card: 0 ulps, same decisions, and the expected
    number of scan launches (0 when a side has no valid point).  The plain
    call is timed once, by CUDA events; a timed call whose targets split is
    also timed unsplit, which must give the same bits.  Returns stats."""
    import torch

    from ltm_torch.kernels.knn2 import knn2_sqdists, knn2_sqdists_plain

    before = knn2_sqdists.launches, knn2_sqdists.merges
    got = knn2_sqdists(q, qm, t, tm)
    torch.cuda.synchronize()
    if knn2_sqdists.launches - before[0] != launches:
        raise AssertionError(f"{name}: {knn2_sqdists.launches - before[0]} scan launches, "
                             f"expected {launches}")
    holder = []
    plain_ms = cuda_ms(lambda: holder.append(knn2_sqdists_plain(q, qm, t, tm)), reps=1)
    g, r = got.cpu().numpy(), holder[0].cpu().numpy()
    ulps = ulps_apart(g, r)
    if ulps > 0:
        raise AssertionError(f"{name}: kernel and plain differ by {ulps} ulps")
    for thr in (0.04, 1.0):
        if not np.array_equal(g.mean(1) < thr, r.mean(1) < thr):
            raise AssertionError(f"{name}: kNN decisions at {thr} differ")
    valid = qm.cpu().numpy()
    n_valid, m_valid = int(qm.sum()), int(tm.sum())
    stats = {"case": name, "n": q.shape[0], "m": t.shape[0], "n_valid": n_valid,
             "m_valid": m_valid, "valid_pairs": n_valid * m_valid, "ulps": ulps,
             "max_abs_err": float(np.abs(g[valid] - r[valid]).max(initial=0.0))}
    if launches:
        stats["splits"], stats["chunk"] = plan_of(q, qm, t, tm)
    if timed:
        stats["kernel_ms"] = cuda_ms(lambda: knn2_sqdists(q, qm, t, tm), reps=5)
        if stats["splits"] > 1:
            one = unsplit(lambda: knn2_sqdists(q, qm, t, tm)).cpu().numpy()
            if ulps_apart(one, g) > 0:
                raise AssertionError(f"{name}: one split and {stats['splits']} differ")
            stats["unsplit_ms"] = unsplit(lambda: cuda_ms(lambda: knn2_sqdists(q, qm, t, tm),
                                                          reps=5))
        stats["bound_ms"], stats["bound_by"] = knn2_bound(qm, tm)
        stats["bound_share"] = stats["bound_ms"] / stats["kernel_ms"]
    if library:
        stats["plain_ms"] = plain_ms
        stats["library_ms"] = library_knn2_ms(q, qm, t, tm)
    knn2_sqdists.launches, knn2_sqdists.merges = before   # comparison launches do not count
    return stats


def km_scale_case(rng, n=16385, m=300_000):
    """Survey-like points ~1 km from the origin at ~0.05 m spacing, 20%
    invalid on both sides; n is not a multiple of the kernel's block."""
    side = int(np.ceil((m / 12) ** 0.5))
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side), np.arange(12)), -1).reshape(-1, 3)[:m]
    t = (g * 0.05 + [1000.0, -700.0, 3.0] + rng.normal(0, 0.01, (m, 3))).astype(np.float32)
    q = (t[rng.choice(m, n)] + rng.normal(0, 0.15, (n, 3))).astype(np.float32)
    return q, rng.uniform(size=n) > 0.2, t, rng.uniform(size=m) > 0.2


def sass_hot_blocks(lib_path):
    """The hot block of ``knn2_scan`` in the built library, from
    ``cuobjdump -sass``: the basic block with the most FFMA, which is one
    group's fast path (its 32 pairs' arithmetic, their OR-ed top-2 test and
    the branch).  Instructions, pairs (one FMUL each), instructions a pair
    and the opcode counts.  The full dump goes to ``chiprun_out/knn2.sass``."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return {"cuobjdump": "not found"}
    text = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "knn2.sass"), "w") as f:
        f.write(text)
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        if "knn2_scan" not in func.split("\n", 1)[0]:
            continue
        blocks, cur = [], []
        for line in func.splitlines():
            if re.match(r"\s*\.L_x_\d+:", line):
                blocks.append(cur)
                cur = []
                continue
            ins = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", line)
            if not ins:
                continue
            cur.append(ins.group(1))
            if ins.group(1).split(".")[0] in ("BRA", "EXIT", "RET"):
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        hot = max(blocks, key=lambda b: sum(op.startswith("FFMA") for op in b))
        ops = collections.Counter(op.split(".")[0] for op in hot)
        pairs = ops["FMUL"]
        return {"instructions": len(hot), "pairs": pairs,
                "per_pair": len(hot) / pairs if pairs else None, "ops": dict(ops)}
    raise AssertionError("cuobjdump -sass shows no knn2_scan")


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


def phase_build():
    """Phase 1: build every kernel, print the compiler's report and the
    scan's hot block."""
    from ltm_torch.io import native
    from ltm_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[1] kernels built in {time.perf_counter() - t0:.2f} s: {sorted(logs) or 'cached'}")
    for name, text in logs.items():
        log(f"[1] nvcc {name}.cu:\n{text.strip()}")
    log(f"[1] knn2_scan hot block (cuobjdump -sass): "
        f"{json.dumps(sass_hot_blocks(_build._lib_path('knn2')))}")
    log(f"[1] native/libltm_native.so loaded: {native.available()}"
        + ("" if native.available() else " (host voxels: first point per voxel)"))


def phase_kernel_cases(dev):
    """Phase 2: the kernel against its plain version on the card, on cases
    that reach every route of the wrapper.  Returns the km-scale stats."""
    import torch

    from ltm_torch.kernels import knn2

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    rng = np.random.default_rng(0)
    per_cta = knn2._R * knn2._THREADS
    q = rng.normal(size=(700, 3)).astype(np.float32) * 5
    t = rng.normal(size=(1500, 3)).astype(np.float32) * 5
    qm = np.ones(700, bool)
    qm[13] = False
    cases = [("masked", q, qm, t, rng.uniform(size=1500) > 0.2)]
    td = np.tile(np.array([[1.0, 0, 0], [1.0, 0, 0], [5.0, 0, 0]], np.float32), (200, 1))[:512]
    cases.append(("duplicates", np.zeros((8, 3), np.float32), np.ones(8, bool), td,
                  np.ones(512, bool)))
    # few queries, many targets: the plan splits the targets
    ts = rng.uniform(-50, 50, (400_000, 3)).astype(np.float32)
    cases.append(("split_heavy", rng.uniform(-50, 50, (300, 3)).astype(np.float32),
                  np.ones(300, bool), ts, rng.uniform(size=400_000) > 0.1))
    # the nearest target, duplicated at compacted positions chunk-1 and chunk
    tb = rng.uniform(100, 200, (200_000, 3)).astype(np.float32)
    qb, qbm = np.zeros((64, 3), np.float32), np.ones(64, bool)
    splits, chunk = plan_of(*on_card(qb, qbm, tb, np.ones(200_000, bool)))
    if splits < 2:
        raise AssertionError(f"split_boundary: the plan does not split ({splits})")
    tb[[chunk - 1, chunk]] = [2.0, 2.0, 0.0]
    cases.append(("split_boundary", qb, qbm, tb, np.ones(200_000, bool)))
    cases.append(("no_valid_query", q, np.zeros(700, bool), t, np.ones(1500, bool)))
    cases.append(("no_valid_target", q, qm, t, np.zeros(1500, bool)))
    one = np.zeros(1500, bool)
    one[777] = True
    cases.append(("one_valid_target", q, qm, t, one))
    n_rag = 3 * per_cta + 17
    cases.append(("ragged_queries", rng.normal(size=(n_rag + 40, 3)).astype(np.float32) * 5,
                  np.arange(n_rag + 40) < n_rag, t, np.ones(1500, bool)))
    cases.append(("km_scale",) + km_scale_case(rng))
    km = None
    for name, *arrays in cases:
        args = on_card(*arrays)
        launches = int(arrays[1].any() and arrays[3].any())
        st = compare_knn2(name, *args, timed=(name == "km_scale"), launches=launches)
        got = knn2.knn2_sqdists(*args).cpu().numpy()
        if name == "duplicates" and not np.allclose(got, 1.0, atol=1e-6):
            raise AssertionError("duplicate targets must count twice")
        if name == "split_boundary" and not np.all(got == np.float32(8.0)):
            raise AssertionError("a duplicate across a split boundary must count twice")
        if name.startswith("no_valid") and not np.all(got == np.float32(1e30)):
            raise AssertionError(f"{name}: rows must be 1e30")
        if name == "one_valid_target" and not np.all(got[:, 1] == np.float32(1e30)):
            raise AssertionError("one valid target: slot 2 must be 1e30")
        log(f"[2] {json.dumps(st)}")
        if name == "km_scale":
            km = st
    knn2.knn2_sqdists.launches = knn2.knn2_sqdists.merges = 0
    return km


def phase_card_vs_cpu(cfg):
    """Phase 3: ``Removerter.run`` on a small survey, CPU against card."""
    from ltm_torch.removert import Removerter
    from ltm_torch.removert.pipeline import MASK_NAMES

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


def workload(n_kf, n_pts, traj):
    from ltm_torch.io.synthetic import synth_session
    from ltm_torch.removert import RemovertInput

    r = np.random.default_rng(0)
    c_scans, c_poses = synth_session(r, n_kf, n_pts, traj=traj, phase=0.0)
    q_scans, q_poses = synth_session(r, n_kf, n_pts, traj=traj, phase=0.25)
    return RemovertInput(scans=c_scans, poses=c_poses), RemovertInput(scans=q_scans, poses=q_poses)


KNN2_CALLS = ("full_width_nd", "full_width_pd", "full_width_promotion")


def phase_full_width(cfg):
    """Phase 4: the full-width workload, warm-up (recording the knn2 calls)
    then three timed runs and one profiled run; then each recorded call
    against the plain version.  Returns the per-call stats and the last
    timed run's launch counts."""
    import torch

    import ltm_torch.kernels.knn as knn_mod
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter
    from ltm_torch.removert.pipeline import MASK_NAMES
    from ltm_torch.utils import reset_slot_counts, reset_stage_times, slot_counts, stage_times

    os.environ["LTM_SYNC_STAGES"] = "1"   # stage walls include their device work
    full = workload(48, 120_000, 1200.0)
    rm = Removerter(cfg, device="cuda")
    calls = []

    def recording(*args):
        calls.append(args)
        return knn2_sqdists(*args)

    runs = []
    for i in range(4):                     # run 0 warms up and records the calls
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_stage_times()
        reset_slot_counts()
        torch.cuda.synchronize()
        knn2_sqdists.launches = knn2_sqdists.merges = 0
        knn_mod.knn2_sqdists = recording if i == 0 else knn2_sqdists
        try:
            t0 = time.perf_counter()
            result = rm.run(*full)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            knn_mod.knn2_sqdists = knn2_sqdists
        launches, merges = knn2_sqdists.launches, knn2_sqdists.merges
        if launches <= 0 or merges <= 0:
            raise AssertionError(f"the full-width run launched the knn2 scan {launches} and "
                                 f"the merge {merges} times; both must run")
        n_kf = result.central.num_keyframes + result.query.num_keyframes
        runs.append({"run": i, "wall_s": wall, "keyframes_per_s": n_kf / wall,
                     "knn2_launches": launches, "knn2_merge_launches": merges,
                     "stages_s": stage_times(), "map_slots_per_stage": slot_counts()})
        log(f"[4] {json.dumps(runs[-1])}")
    if len(calls) != len(KNN2_CALLS):
        raise AssertionError(f"the pipeline made {len(calls)} knn2 calls, expected ND, PD "
                             f"and the weak->strong promotion")
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
        "knn2_merge_launches_per_run": [r["knn2_merge_launches"] for r in timed],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"[4] {json.dumps(summary)}")
    log(f"[4] profiled run: {json.dumps(device_profile(lambda: rm.run(*full)))}")

    # the kernel at the main path's three call shapes, as the pipeline made them
    stats = []
    for name, args in zip(KNN2_CALLS, calls):
        st = compare_knn2(name, *args, timed=True, library=(name == "full_width_nd"))
        stats.append(st)
        log(f"[4] {json.dumps(st)}")
    return stats, timed[-1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from ltm_torch.core.config import RemovertConfig

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    phase_build()
    km = phase_kernel_cases(dev)

    cfg = RemovertConfig()
    cfg.downsample_voxel_size = 0.1
    cfg.use_chunk_knn = False      # the chunked kNN is ported in a later slice
    phase_card_vs_cpu(cfg)
    calls, last_run = phase_full_width(cfg)

    nd = calls[0]
    kernels = [{
        "name": "knn2_sqdists",
        "route": "cuda",
        "route_kernels": ["knn2_compact (valid points)",
                          "knn2_scan (queries x target split)",
                          "knn2_merge (partial top-2s, when the targets split)"],
        "source": "ltm_torch/csrc/knn2.cu",
        "replaces": "ltm/kernels/pallas_knn.py:95",
        "launches": last_run["knn2_launches"],
        "merge_launches": last_run["knn2_merge_launches"],
        "max_abs_err": max(st["max_abs_err"] for st in calls),
        "ms": nd["kernel_ms"],
        "plain_ms": nd["plain_ms"],
        "bound_ms": nd["bound_ms"],
        "bound_by": nd["bound_by"],
        "library_ms": nd["library_ms"],
        "per_launch": [{k: st.get(k) for k in ("case", "valid_pairs", "splits", "kernel_ms",
                                               "unsplit_ms", "bound_ms", "bound_by")}
                       for st in calls],
        "km_scale_ms": km["kernel_ms"],
        "km_scale_unsplit_ms": km.get("unsplit_ms"),
        "km_scale_bound_ms": km["bound_ms"],
    }]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
