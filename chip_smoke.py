#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``ltm_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ltm_torch/csrc`` (nvcc,
sm_90a), then runs nine phases, each of which raises on failure:

  1. device and build: the card, PyTorch/CUDA versions, kernel build time,
     the ``-Xptxas -v`` report of every source, and the 2-NN scan's hot
     block read from ``cuobjdump -sass`` (full dump in
     ``knn2.sass`` under ``OUT_DIR``);
  2. kernels vs plain on the card, bit for bit: ``knn2_sqdists`` (K1) on a
     masked case, duplicate targets, duplicates straddling a target-split
     boundary, a split-heavy case, all queries invalid, no valid target,
     one valid target, a ragged valid-query count and a km-scale case
     (timed); ``chunk_knn_sqdists`` (K4) on masked queries, a target
     subset, a forced overflow, an all-invalid tail of chunks, duplicate
     targets, km-offset coordinates (timed, with the scan at segments of
     4, 8 and 16 listed blocks), one chunk whose list spans many segments,
     a nearest target duplicated on both sides of a segment boundary, a
     block at exactly the reach of a chunk inside a super-block, a chunk
     with no hit, a call of an escalation's size, a block capacity of 201
     with a misaligned ``target_extra``, and exactly ``k_blocks`` and
     ``k_blocks + 1`` hits, each with the plain version's
     ``chunk_overflow`` and ``order``, and the kernels' own counts of their
     work (block tests, work items) equal to the plain steps';
  3. card vs CPU: ``Removerter.run`` on a small synthetic survey on the CPU
     (plain versions) and on the card (kernels); the 14 named point sets
     agree within max(2, 1e-4·|set|) points;
  4. full width, brute-force kNN: the LT-removert pipeline workload of
     ``bench.py`` (two sessions x 48 keyframes x 120k points, 0.1 m voxels,
     ``use_chunk_knn=False``) once to warm up (recording the three knn2
     calls: ND, PD, weak->strong promotion), three timed times and once
     under ``torch.profiler``; K1 must launch in every timed run.  Each
     recorded call is then held to the plain version and timed against its
     bound, the plain version and ``cdist`` + ``topk``;
  5. full width, ``RemovertConfig()`` defaults (the chunked kNN), the same
     runs; K4's scan and merge must launch in every timed run and the 14
     sets must equal phase 4's.  Each recorded K4 call (ND, PD, promotion,
     their escalations, and the high-dynamic extraction of
     ``_save_artifacts``) is held to the plain version and timed against
     its bound and the K1 yardstick, whole and by part (the prep: keys,
     sort and bounds; the scan, at segments of 4, 8 and 16 blocks), with its
     per-kernel device times, the kernels' block tests a chunk and work
     items, and merge launches;
  6. the CLI: ``python -m ltm_torch.cli.ltremovert`` in a subprocess on
     session directories of 8 keyframes x 120k points a session; its
     artifact tree must hold the expected files with the point counts of
     ``Removerter.run`` on the same inputs in this process;
  7. LT-SLAM card vs CPU: ``LTSlam.run`` with ``LTSlamConfig()`` on phase
     8's workload cut to 60 + 20 keyframes, on both devices: the same
     accepted loop set, central poses within 0.01 m;
  8. LT-SLAM at full width: ``bench.py:_slam_bench``'s workload (two
     sessions x 500 keyframes x 8 000 points, ``LTSlamConfig()``), a
     warm-up and two timed runs (ATE RMSE ≤ 0.10 m), one run that times
     each call of the path's hot loops (the ICP 1-NN, the Scan Context
     distance, the polar-bin scatter-max, the tridiagonal sweeps) with a
     sync on each side, the largest 1-NN call against its bound and
     ``torch.cdist``, one run with 10 RS loops (ATE ≤ 0.10 m) and one at
     ``odom_noise=4e-3`` (ATE ≤ 0.25 m);
  9. ``python -m ltm_torch.cli.ltmapper`` in a subprocess on session
     directories of 40 keyframes x 8 000 points a session: ``ltslam/``
     holds the eight trajectory files and ``removert/`` equals
     ``Removerter.run`` in this process on those poses.

Every timed call whose targets split is also run and timed with the plan
held at one split, which must give the same bits.

It prints the ``{"kernels": [...]}`` line, the ``{"slam": {...}}`` line
(phases 7-9), then the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  The LT-SLAM path runs no hand kernel:
its hot loops are PyTorch ops, measured in phase 8.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.  The port imports neither ``jax`` nor ``ltm``.
"""

from __future__ import annotations

import collections
import faulthandler
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


def chunk_work(q, qm, bm, extra, clamp, chunk, k_blocks, sort_cell):
    """The work of a chunked 2-NN call on these inputs, counted from the
    plain steps: scored valid pairs (the chunks that did not overflow, each
    valid query against the valid slots of the blocks its ball reaches) and
    listed blocks, which the bound reads; and what the kernels count of
    their own work, to hold their counts to: the chunks with a valid query,
    the two-level cull's block tests (in all and the most in one chunk; the
    single-level test made n_blocks a chunk) and the scoring's work items."""
    import torch

    from ltm_torch.kernels import chunk_knn as ck

    t_mask, bval, blo, bhi = ck._block_bounds(bm, extra)
    qx, qmc, _ = ck._prep_sorted_chunks(q, qm, chunk, sort_cell)
    cnt, center, reach = ck._chunk_balls(qx, qmc, clamp)
    slots = t_mask.sum(1).double()
    active = torch.nonzero(cnt > 0).squeeze(1)
    pairs = listed = 0.0
    tests, scored = [], torch.zeros(cnt.shape[0], dtype=torch.int64, device=q.device)
    step = max(1, (1 << 22) // bval.shape[0])
    for a0 in range(0, active.shape[0], step):
        cs = active[a0:a0 + step]
        hit, t = ck._cull_two_level(center[cs], reach[cs], bval, blo, bhi)
        n_int = hit.sum(1)
        ok = n_int <= k_blocks
        pairs += float(((hit.double() @ slots) * cnt[cs] * ok).sum())
        listed += float((n_int * ok).sum())
        scored[cs] = n_int * ok
        tests.append(t)
    tests = torch.cat(tests) if tests else torch.zeros(1, dtype=torch.int64)
    return {"scored_pairs": pairs, "listed_blocks": listed,
            "max_listed": int(scored.max()) if scored.numel() else 0,
            "n_blocks": bm.num_blocks,
            "plain_counts": {"work_items": int(ck._work_items(scored, chunk).shape[0]),
                             "block_tests": int(tests.sum()), "chunks_culled": int(active.numel()),
                             "max_block_tests": int(tests.max())}}


def kernel_counts():
    """The last chunk kNN scan's own counts, read from the card: work items,
    block and super-block tests, chunks culled, the most tests in a chunk."""
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists

    items, _taken, tests, culled, most = chunk_knn_sqdists.counts.tolist()
    return {"work_items": items, "block_tests": tests, "chunks_culled": culled,
            "max_block_tests": most}


def chunk_bound(q, bm, n_chunks, pairs, listed):
    """(ms, "bytes" or "operations", gather ms): the least time of a chunked
    2-NN call, the larger of its bytes (queries and block map read once,
    (N,2) rows, the order and the per-chunk overflow written once) over the
    memory rate and its float32 operations (8 a scored valid pair) over the
    non-tensor FP32 rate; and the time of the block gather alone (every
    listed block's slots, 13 bytes each, read once a chunk)."""
    n, slots = q.shape[0], bm.mask.numel()
    t_bytes = (13 * n + 13 * slots + 12 * n + 4 * n_chunks) / H100_BYTES_PER_S
    t_ops = 8.0 * pairs / H100_FP32_FLOPS
    gather = 13 * listed * bm.block_capacity / H100_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), 1e3 * gather


def compare_chunk(name, q, qm, bm, extra, clamp_radius, k=2, chunk=256, k_blocks=64,
                  sort_cell=4.0, timed=False):
    """Chunk kNN kernels vs plain on the card: the same bits in every row
    (NaN rows of overflowed chunks included), the same overflow and order,
    one scan launch and a merge launch when a chunk can list more than one
    segment, and the kernels' own counts of their work (block tests, work
    items) equal to the plain steps' (``chunk_work``).  A timed call is also
    timed whole, by its parts (the prep: keys, sort and bounds; the scan:
    cull, scoring and merge), with the scan at segments of 4, 8 and 16
    listed blocks (each with the same bits), by kernel under the profiler,
    and against its bound and the K1 yardstick (the same targets through
    ``knn2_sqdists`` plus the clamp).  Returns stats."""
    import torch

    from ltm_torch.kernels import chunk_knn as ck
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists, chunk_knn_sqdists_plain
    from ltm_torch.kernels.knn2 import knn2_sqdists

    kw = dict(k=k, chunk=chunk, k_blocks=k_blocks, sort_cell=sort_cell)
    before = (chunk_knn_sqdists.launches, chunk_knn_sqdists.merges, knn2_sqdists.launches,
              knn2_sqdists.merges)
    got = chunk_knn_sqdists(q, qm, bm, extra, clamp_radius, **kw)
    torch.cuda.synchronize()
    counts = kernel_counts()
    merges = int(min(k_blocks, bm.num_blocks) > ck._SEG)
    if (chunk_knn_sqdists.launches - before[0], chunk_knn_sqdists.merges - before[1]) != (1, merges):
        raise AssertionError(f"{name}: {chunk_knn_sqdists.launches - before[0]} scan and "
                             f"{chunk_knn_sqdists.merges - before[1]} merge launches, expected "
                             f"1 and {merges}")
    holder = []
    plain_ms = cuda_ms(lambda: holder.append(
        chunk_knn_sqdists_plain(q, qm, bm, extra, clamp_radius, **kw)), reps=1)
    ref = holder[0]
    g, r = got.sqdists.cpu().numpy(), ref.sqdists.cpu().numpy()
    over = got.chunk_overflow.cpu().numpy()
    if not np.array_equal(over, ref.chunk_overflow.cpu().numpy()):
        raise AssertionError(f"{name}: chunk_overflow differs from the plain version's")
    if not torch.equal(got.order, ref.order):
        raise AssertionError(f"{name}: order differs from the plain version's")
    ulps = ulps_apart(g, r)
    if ulps > 0:
        raise AssertionError(f"{name}: kernel and plain differ by {ulps} ulps")
    fin = np.isfinite(g) & (g < 1e29)
    n_valid = int(qm.sum())
    stats = {"case": name, "n": q.shape[0], "n_valid": n_valid, "chunks": over.size,
             "overflowed_chunks": int((over > 0).sum()), "k_blocks": k_blocks,
             "blocks": bm.num_blocks, "block_capacity": bm.block_capacity, "ulps": ulps,
             "max_abs_err": float(np.abs(g[fin] - r[fin]).max(initial=0.0)),
             "merge_launches": merges}
    stats.update(chunk_work(q, qm, bm, extra, clamp_radius, chunk, k_blocks, sort_cell))
    plain_counts = stats.pop("plain_counts")
    if counts != plain_counts:
        raise AssertionError(f"{name}: the kernels counted {counts}, the plain steps "
                             f"{plain_counts}")
    stats.update(counts)
    stats["block_tests_per_chunk"] = counts["block_tests"] / max(counts["chunks_culled"], 1)
    if timed:
        stats["kernel_ms"] = cuda_ms(lambda: chunk_knn_sqdists(q, qm, bm, extra, clamp_radius,
                                                               **kw), reps=5)
        targets = ck._target_arrays(bm, extra)
        order, bounds = ck._prep_cuda(q, qm, targets, sort_cell)
        stats["prep_ms"] = cuda_ms(lambda: ck._prep_cuda(q, qm, targets, sort_cell), reps=5)
        stats["scan_ms_by_seg"] = seg_sweep(name, got.sqdists, q, qm, order, targets, bounds,
                                            clamp_radius, chunk, k_blocks)
        stats["scan_ms"] = stats["scan_ms_by_seg"][str(ck._SEG)]
        by_kernel = device_profile(lambda: chunk_knn_sqdists(q, qm, bm, extra, clamp_radius,
                                                             **kw), top=20)["top_device_ms"]
        stats["device_ms_by_kernel"] = by_kernel or "not measured"
        stats["merge_ms"] = next((v for key, v in by_kernel.items() if "ck_merge" in key),
                                 "not measured")
        stats["plain_ms"] = plain_ms
        stats["bound_ms"], stats["bound_by"], stats["gather_ms"] = chunk_bound(
            q, bm, over.size, stats["scored_pairs"], stats["listed_blocks"])
        stats["bound_share"] = stats["bound_ms"] / stats["kernel_ms"]
        stats["scan_bound_share"] = stats["bound_ms"] / stats["scan_ms"]
        t, tm = bm.xyz.reshape(-1, 3), bm.mask.reshape(-1)
        if extra is not None:
            tm = tm & extra
        r2 = torch.tensor(clamp_radius * clamp_radius, dtype=torch.float32, device=q.device)
        stats["k1_yardstick_ms"] = cuda_ms(lambda: torch.minimum(knn2_sqdists(q, qm, t, tm), r2),
                                           reps=3)
    # comparison launches do not count
    (chunk_knn_sqdists.launches, chunk_knn_sqdists.merges, knn2_sqdists.launches,
     knn2_sqdists.merges) = before
    return stats


def seg_sweep(name, want, q, qm, order, targets, bounds, clamp_radius, chunk, k_blocks,
              segs=(4, 8, 16), rounds=5):
    """{seg: median ms} of the scan alone with work items of ``seg`` listed
    blocks, timed in turns (one call of each a round, so drift spreads over
    all), each with the bits of ``want``."""
    import torch

    from ltm_torch.kernels import chunk_knn as ck

    def scan(seg):
        return ck._scan_cuda(q, qm, order, targets, bounds, clamp_radius, chunk, k_blocks,
                             seg=seg)[0]

    for seg in segs:
        if not torch.equal(scan(seg).view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name}: the scan at segments of {seg} gives other bits")
    times = {seg: [] for seg in segs}
    for _ in range(rounds):
        for seg in segs:
            times[seg].append(cuda_ms(lambda: scan(seg), reps=1))
    return {str(seg): statistics.median(t) for seg, t in times.items()}


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
        st = compare_knn2(name, *args, timed=(name == "km_scale"), library=(name == "km_scale"),
                          launches=launches)
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


def phase_chunk_cases(dev):
    """Phase 2, K4: the chunk kNN kernel against its plain version on the
    card, on cases that reach every route of the scan.  Returns the timed
    km-offset stats."""
    import torch

    from ltm_torch.kernels import chunk_knn as ck
    from ltm_torch.kernels.blocks import BlockMap, build_block_map_with_slots

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def layout(t, tm, cell, cap):
        tt, ttm = on_card(t, tm)
        need = max(-(-int(tm.sum()) * 2 // cap), 1)
        bm, ov, _ = build_block_map_with_slots(tt, ttm, cell, 1 << (need - 1).bit_length(), cap)
        if ov:
            raise AssertionError("phase 2 block layout overflowed")
        return bm

    def manual_layout(pts):
        """A block map of (n_blocks, cap, 3) points, every slot valid."""
        xyz = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
        z = torch.zeros(1, device=dev)
        return BlockMap(xyz, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev), z, z, z, z, z)

    rng = np.random.default_rng(1)
    t = rng.uniform(-30, 30, (50_000, 3)).astype(np.float32)
    tm = rng.uniform(size=50_000) > 0.2
    bm = layout(t, tm, 8.0, 64)
    q = rng.uniform(-32, 32, (17_777, 3)).astype(np.float32)
    qm = rng.uniform(size=17_777) > 0.1
    extra = torch.from_numpy(rng.uniform(size=bm.mask.numel()) > 0.5).to(dev)
    tail_m = np.arange(17_777) < 5_000              # 5 000 valid: the sorted tail is all-invalid
    td = np.tile(np.array([[1.0, 0, 0], [1.0, 0, 0], [5.0, 0, 0]], np.float32), (200, 1))
    km_q, km_qm, km_t, km_tm = km_scale_case(rng)
    near = dict(clamp_radius=2.0, k_blocks=2048, sort_cell=8.0)
    cases = [
        ("chunk_masked", *on_card(q, qm), bm, None, near),
        ("chunk_target_extra", *on_card(q, qm), bm, extra, near),
        ("chunk_forced_overflow", *on_card(q, qm), bm, None, dict(near, k_blocks=4)),
        ("chunk_invalid_tail", *on_card(q, tail_m), bm, None, near),
        ("chunk_duplicates", *on_card(np.zeros((8, 3), np.float32), np.ones(8, bool)),
         layout(td, np.ones(len(td), bool), 8.0, 64), None,
         dict(clamp_radius=3.0, chunk=8, k_blocks=64)),
        ("chunk_km_offset", *on_card(km_q, km_qm), layout(km_t, km_tm, 12.5, 128), None,
         dict(clamp_radius=float(np.sqrt(2.0)), k_blocks=3072)),
    ]
    # one chunk over the whole cube: its list spans many segments
    cases.append(("chunk_long_list", *on_card(rng.uniform(-30, 30, (256, 3)).astype(np.float32),
                                              np.ones(256, bool)), bm, None,
                  dict(clamp_radius=2.0, k_blocks=4096, sort_cell=8.0)))
    # one super-block of 32 blocks, listed in block order: the nearest target
    # is duplicated at the end of the first segment's last block and the
    # start of the second segment's first block
    pts = rng.normal(size=(32, 16, 3))
    pts *= rng.uniform(1.5, 2.9, (32, 16, 1)) / np.linalg.norm(pts, axis=2, keepdims=True)
    pts[ck._SEG - 1, 15] = pts[ck._SEG, 0] = [1.0, 0.0, 0.0]
    cases.append(("chunk_segment_duplicate", *on_card(np.zeros((8, 3), np.float32),
                                                      np.ones(8, bool)),
                  manual_layout(pts), None, dict(clamp_radius=3.0, chunk=8, k_blocks=64)))
    # queries 0 and 0.5 on x: center 0.25, reach 0.25 + 1.5 = 1.75 exactly;
    # block 5's AABB starts at x = 2 (gap exactly 1.75: listed), block 6's one
    # ulp beyond (not listed), inside super-block 0 with block 0 (near) and
    # far blocks; k_blocks = 1 shows the hit count as the overflow
    pts = rng.uniform(10, 11, (64, 16, 3))
    pts[0] = rng.uniform(-0.2, 0.2, (16, 3))
    for b, x0 in ((5, np.float32(2.0)), (6, np.nextafter(np.float32(2.0), np.float32(3.0)))):
        pts[b] = np.c_[rng.uniform(2.1, 2.5, 16), rng.uniform(-0.5, 0.5, (16, 2))]
        pts[b, 0, 0] = x0
    qb = np.array([[0.0, 0, 0], [0.5, 0, 0]], np.float32)
    for kb in (1, 64):
        cases.append((f"chunk_reach_boundary_k{kb}", *on_card(qb, np.ones(2, bool)),
                      manual_layout(pts), None,
                      dict(clamp_radius=1.5, chunk=2, k_blocks=kb, sort_cell=4.0)))
    cases.append(("chunk_no_hit", *on_card(q[:300] + np.float32(5000.0), np.ones(300, bool)), bm,
                  None, near))
    # a call of an escalation's size (ties in the keys, invalid queries last)
    cases.append(("chunk_small_call", *on_card(q[:8000], qm[:8000]), bm, None, near))
    # 201 slots a block (two staged pieces, the second of 73 slots; every
    # block at another alignment) and a target_extra at an odd byte offset
    bm201 = layout(t, tm, 8.0, 201)
    extra201 = torch.from_numpy(rng.uniform(size=bm201.mask.numel() + 3) > 0.5).to(dev)[3:]
    cases.append(("chunk_odd_capacity", *on_card(q, qm), bm201, extra201, near))
    km = masked = None
    for name, qq, qqm, b, ex, kw in cases:
        st = check_chunk_case(name, qq, qqm, b, ex, kw)
        if name == "chunk_km_offset":
            km = st
        if name == "chunk_masked":
            masked = st
    # exactly k_blocks hits in the fullest chunk, then k_blocks + 1
    top = masked["max_listed"]
    for name, kb in (("chunk_k_blocks_exact", top), ("chunk_k_blocks_plus_one", top - 1)):
        check_chunk_case(name, *on_card(q, qm), bm, None, dict(near, k_blocks=kb))
    ck.chunk_knn_sqdists.launches = ck.chunk_knn_sqdists.merges = 0
    return km


def check_chunk_case(name, q, qm, bm, extra, kw):
    """``compare_chunk`` on one phase-2 case, and the case's own checks."""
    from ltm_torch.kernels.chunk_knn import _SEG, chunk_knn_sqdists

    st = compare_chunk(name, q, qm, bm, extra, timed=(name == "chunk_km_offset"), **kw)
    overflows = name in ("chunk_forced_overflow", "chunk_reach_boundary_k1",
                         "chunk_k_blocks_plus_one")
    if overflows != bool(st["overflowed_chunks"]):
        raise AssertionError(f"{name}: {st['overflowed_chunks']} chunks overflowed")
    got = chunk_knn_sqdists(q, qm, bm, extra, **kw)
    rows = got.sqdists.cpu().numpy()
    if name == "chunk_invalid_tail" and st["chunks"] <= -(-5_000 // 256):
        raise AssertionError("invalid tail: no all-invalid chunk")
    if name in ("chunk_duplicates", "chunk_segment_duplicate") and not np.array_equal(
            rows, np.ones((8, 2), np.float32)):
        raise AssertionError(f"{name}: duplicate targets must count twice")
    if name == "chunk_long_list" and st["max_listed"] < 10 * _SEG:
        raise AssertionError(f"long list: only {st['max_listed']} listed blocks")
    if name == "chunk_reach_boundary_k1" and got.chunk_overflow.tolist() != [1]:
        raise AssertionError("reach boundary: the block at exactly reach is not listed")
    if name == "chunk_no_hit" and not np.all(rows == np.float32(kw["clamp_radius"] ** 2)):
        raise AssertionError("no hit: rows must be the clamp")
    if name == "chunk_k_blocks_plus_one" and int(got.chunk_overflow.max()) != 1:
        raise AssertionError("k_blocks + 1: the fullest chunk must overflow by one")
    log(f"[2] {json.dumps(st)}")
    return st


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
FULL_WIDTH = (48, 120_000, 1200.0)     # keyframes a session, points a scan, corridor metres
CLI_WIDTH = (8, 120_000, 200.0)        # phase 6: full scan width, reduced depth


def phase_full_width(cfg):
    """Phase 4: the full-width workload on the brute-force kNN (K1), warm-up
    (recording the knn2 calls) then three timed runs and one profiled run;
    then each recorded call against the plain version.  Returns the per-call
    stats, the last timed run's launch counts and its 14 masks (host)."""
    import torch

    import ltm_torch.kernels.knn as knn_mod
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter
    from ltm_torch.removert.pipeline import MASK_NAMES
    from ltm_torch.utils import reset_slot_counts, reset_stage_times, slot_counts, stage_times

    os.environ["LTM_SYNC_STAGES"] = "1"   # stage walls include their device work
    full = workload(*FULL_WIDTH)
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
        st = compare_knn2(name, *args, timed=True, library=True)
        stats.append(st)
        log(f"[4] {json.dumps(st)}")
    return stats, timed[-1], {name: m.cpu().numpy() for name, m in result.masks.items()}


def phase_default_config(cfg, brute_masks):
    """Phase 5: the full-width workload on ``RemovertConfig()``'s defaults
    (the chunked kNN, K4), warm-up (recording its K4 calls) then three timed
    runs and one profiled run; K4 must launch in every timed run and the 14
    sets must equal phase 4's brute-force run.  Then the high-dynamic scan
    extraction of ``_save_artifacts`` (the largest kNN call) is recorded too,
    and each recorded call is held to the plain version and timed against
    its bound and the K1 yardstick.  Returns the per-call stats and the last
    timed run."""
    import torch

    import ltm_torch.removert.pipeline as pipe
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter
    from ltm_torch.removert.pipeline import MASK_NAMES
    from ltm_torch.utils import (current_stage, reset_slot_counts, reset_stage_times,
                                 stage_timer, stage_times)

    os.environ["LTM_SYNC_STAGES"] = "1"
    full = workload(*FULL_WIDTH)
    rm = Removerter(cfg, device="cuda")
    calls = []

    def recording(*args, **kwargs):
        stage = current_stage()
        if kwargs["k_blocks"] > cfg.chunk_knn_k_blocks:    # an escalation follows its main call
            name = calls[-1][0].replace("_escalated", "") + "_escalated"
        elif stage == "removert.knn_diff":
            name = "full_width_pd" if calls else "full_width_nd"
        else:
            name = {"removert.strong_weak.propagate": "full_width_promotion",
                    "removert.save": "full_width_high_dyn"}[stage]
        calls.append((name, args, kwargs))
        return chunk_knn_sqdists(*args, **kwargs)

    runs = []
    for i in range(4):                     # run 0 warms up and records the calls
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_stage_times()
        reset_slot_counts()
        torch.cuda.synchronize()
        chunk_knn_sqdists.launches = chunk_knn_sqdists.merges = 0
        knn2_sqdists.launches = knn2_sqdists.merges = 0
        pipe.chunk_knn_sqdists = recording if i == 0 else chunk_knn_sqdists
        try:
            t0 = time.perf_counter()
            result = rm.run(*full)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pipe.chunk_knn_sqdists = chunk_knn_sqdists
        if chunk_knn_sqdists.launches <= 0 or chunk_knn_sqdists.merges <= 0:
            raise AssertionError(f"the default-configuration run launched the chunk kNN scan "
                                 f"{chunk_knn_sqdists.launches} and its merge "
                                 f"{chunk_knn_sqdists.merges} times; both must run")
        n_kf = result.central.num_keyframes + result.query.num_keyframes
        fb = rm.chunk_knn_fallbacks
        runs.append({"run": i, "wall_s": wall, "keyframes_per_s": n_kf / wall,
                     "k4_launches": chunk_knn_sqdists.launches,
                     "k4_merge_launches": chunk_knn_sqdists.merges,
                     "knn2_launches": knn2_sqdists.launches,
                     "escalated_queries": sum(len(f["escalated"]) for f in fb),
                     "brute_forced_queries": sum(len(f["brute"]) for f in fb),
                     "stages_s": stage_times()})
        log(f"[5] {json.dumps(runs[-1])}")
    diff = [n for n in MASK_NAMES
            if not np.array_equal(result.masks[n].cpu().numpy(), brute_masks[n])]
    if diff:
        raise AssertionError(f"chunked kNN and brute force differ in sets {diff}")
    timed = runs[1:]
    summary = {
        "median_keyframes_per_s": statistics.median(r["keyframes_per_s"] for r in timed),
        "median_wall_s": statistics.median(r["wall_s"] for r in timed),
        "k4_launches_per_run": [r["k4_launches"] for r in timed],
        "k4_merge_launches_per_run": [r["k4_merge_launches"] for r in timed],
        "escalated_queries_per_run": [r["escalated_queries"] for r in timed],
        "brute_forced_queries_per_run": [r["brute_forced_queries"] for r in timed],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "sets_equal_brute_force": True,
    }
    log(f"[5] {json.dumps(summary)}")
    log(f"[5] profiled run: {json.dumps(device_profile(lambda: rm.run(*full)))}")

    pipe.chunk_knn_sqdists = recording
    try:
        with stage_timer("removert.save"):
            hd = rm._high_dyn_points(result.central)
    finally:
        pipe.chunk_knn_sqdists = chunk_knn_sqdists
    if not (len(hd) and np.isfinite(hd).all()):
        raise AssertionError("high-dynamic extraction: no points or non-finite points")
    stats = []
    for name, args, kwargs in calls:
        st = compare_chunk(name, *args, timed=True, **kwargs)
        stats.append(st)
        log(f"[5] {json.dumps(st)}")
    return stats, timed[-1]


def phase_cli(device="cuda"):
    """Phase 6: ``python -m ltm_torch.cli.ltremovert`` on the card in a
    subprocess, on session directories written from ``synth_session`` (full
    scan width, 8 keyframes a session), against ``Removerter.run`` on the
    same inputs in this process: the same artifact files, the same point
    count in each."""
    from ltm_torch.core.config import RemovertConfig
    from ltm_torch.io.pcd import read_pcd, write_pcd
    from ltm_torch.io.poses import write_kitti_poses
    from ltm_torch.io.synthetic import synth_session
    from ltm_torch.removert import Removerter, RemovertInput

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    n_kf, n_pts, traj = CLI_WIDTH
    r = np.random.default_rng(0)
    flags = []
    for name, phase in (("central", 0.0), ("query", 0.25)):
        scans, poses = synth_session(r, n_kf, n_pts, traj=traj, phase=phase)
        os.makedirs(os.path.join(root, name, "scans"))
        for i, scan in enumerate(scans):
            write_pcd(os.path.join(root, name, "scans", f"{i}.pcd"), scan)
        write_kitti_poses(os.path.join(root, name, "poses.txt"), poses)
        flags += [f"--{name}-scans", os.path.join(root, name, "scans"),
                  f"--{name}-poses", os.path.join(root, name, "poses.txt")]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ltm_torch.cli.ltremovert", *flags,
                          "--out", os.path.join(root, "cli_out"), "--device", device],
                         capture_output=True, text=True, timeout=600, cwd=repo)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the CLI exited {out.returncode}:\n{out.stderr[-4000:]}")
    t0 = time.perf_counter()
    Removerter(RemovertConfig(), device=device).run(
        RemovertInput.from_dirs(flags[1], flags[3]), RemovertInput.from_dirs(flags[5], flags[7]),
        save_directory=os.path.join(root, "lib_out"))
    lib_s = time.perf_counter() - t0

    def tree(d):
        return {os.path.relpath(os.path.join(a, n), d): len(read_pcd(os.path.join(a, n)))
                for a, _, names in os.walk(d) for n in names}

    cli, lib = tree(os.path.join(root, "cli_out")), tree(os.path.join(root, "lib_out"))
    expected = {"updated_map.pcd", "nd_map.pcd", "pd_map.pcd", "central_sess_high_dyn.pcd",
                "map_static/CentralStaticMapMapsideGlobalResX2.5.pcd"}
    expected |= {f"{sub}/{i}.pcd" for sub in ("scans_updated", "scans_pd", "scans_nd_strong")
                 for i in range(n_kf)}
    if not expected <= set(cli):
        raise AssertionError(f"the CLI's tree lacks {sorted(expected - set(cli))}")
    if cli != lib:
        raise AssertionError(f"CLI and in-process trees differ: "
                             f"{sorted(set(cli) ^ set(lib))} "
                             f"{[k for k in cli if k in lib and cli[k] != lib[k]]}")
    st = {"files": len(cli), "points": sum(cli.values()), "cli_s": cli_s,
          "in_process_s": lib_s, "updated_map_points": cli["updated_map.pcd"]}
    log(f"[6] {json.dumps(st)}")
    shutil.rmtree(root, ignore_errors=True)


SLAM_WIDTH = dict(seed=11, num_keyframes=500, num_cars=12, num_changed=4,
                  max_scan_points=8000, scan_range=70.0)   # bench.py:_slam_bench
SLAM_CLI_KEYFRAMES = 40                                     # phase 9: full scan width, depth cut
ATE_BOUND = 0.10          # m, bench.py:39 (odom_noise 5e-4, with and without RS loops)
ATE_NOISY_BOUND = 0.25    # m, bench.py:40 (odom_noise 4e-3)


SLAM_CUT = (60, 20)    # phase 7: keyframes kept of the central and the query session


def cut_bundle(full, n_central, n_query):
    """The first keyframes of each session of a ``make_two_sessions`` bundle
    (scans, poses, ground truth; the edges among the kept nodes)."""
    import dataclasses

    def cut(syn, n):
        d = syn.data
        ef, et, er = d.edges
        keep = (ef < n) & (et < n)
        data = dataclasses.replace(d, node_ids=d.node_ids[:n], poses=d.poses[:n],
                                   scans=d.scans[:n], edges=(ef[keep], et[keep], er[keep]))
        return dataclasses.replace(syn, data=data, site_poses=syn.site_poses[:n])
    return dict(full, central=cut(full["central"], n_central), query=cut(full["query"], n_query))


def slam_ate(result, bundle) -> float:
    errs = [np.linalg.norm(result.central_poses[name][:, :3, 3] - syn.site_poses[:, :3, 3], axis=1)
            for name, syn in (("01", bundle["central"]), ("02", bundle["query"]))]
    return float(np.sqrt(np.mean(np.concatenate(errs) ** 2)))


def loop_set(slam):
    return sorted((int(a[0]), int(a[1])) for a in slam.anchored)


def nudge_after_first_solve(slam, scale: float) -> None:
    """Move every non-gauge node of every session by N(0, scale) metres right
    after the pipeline's first solve: how far the result moves measures how
    far card-vs-CPU rounding can carry it."""
    solve_once = slam._optimize

    def optimize():
        solve_once()
        if not getattr(slam, "_nudged", False):
            slam._nudged = True
            rng = np.random.default_rng(1)
            for sess in slam.sessions:
                sess.poses_local = sess.poses_local.copy()
                sess.poses_local[1:, :3, 3] += rng.normal(scale=scale, size=(sess.num_nodes - 1, 3))
    slam._optimize = optimize


def phase_slam_card_vs_cpu():
    """Phase 7: ``LTSlam.run`` with ``LTSlamConfig()`` on phase 8's workload
    cut to its first 60 central and 20 query keyframes, on the CPU and on
    the card: the same accepted loop set, central poses within 0.01 m; and
    how far a 1e-5 m nudge of the poses after the first solve moves the
    card's result.  (The 24-keyframe CPU-test fixture, with its thinned ICP
    submaps, is no yardstick for this: its ICPs creep for 25-54 iterations
    and land where rounding sends them.)"""
    from ltm_torch.core.config import LTSlamConfig
    from ltm_torch.io.synthetic import make_two_sessions
    from ltm_torch.slam import LTSlam

    b = cut_bundle(make_two_sessions(odom_noise=5e-4, **SLAM_WIDTH), *SLAM_CUT)
    out = {}
    for dev, nudge in (("cpu", 0.0), ("cuda", 0.0), ("nudged", 1e-5)):
        t0 = time.perf_counter()
        slam = LTSlam(LTSlamConfig(), device="cuda" if dev == "nudged" else dev)
        if nudge:
            nudge_after_first_solve(slam, nudge)
        res = slam.run(b["central"].data, b["query"].data)
        out[dev] = (slam, res, time.perf_counter() - t0)
    (s_c, r_c, t_c), (s_g, r_g, t_g) = out["cpu"], out["cuda"]
    nudged = max(float(np.abs(out["nudged"][1].central_poses[n][:, :3, 3]
                              - r_g.central_poses[n][:, :3, 3]).max()) for n in r_g.central_poses)
    if loop_set(s_c) != loop_set(s_g) or not loop_set(s_g):
        raise AssertionError(f"card vs CPU: loop sets differ {loop_set(s_c)} {loop_set(s_g)}")
    dmax = max(float(np.abs(r_c.central_poses[n][:, :3, 3] - r_g.central_poses[n][:, :3, 3]).max())
               for n in r_c.central_poses)
    if dmax > 0.01:
        raise AssertionError(f"card vs CPU: central poses differ by {dmax} m")
    st = {"keyframes": list(SLAM_CUT), "loops": len(loop_set(s_g)), "max_central_pose_diff_m": dmax,
          "card_nudged_1e-5_m_diff_m": nudged,
          "ate_rmse_m": [slam_ate(r_c, b), slam_ate(r_g, b)],
          "icp_iterations_max": [max(s_c.icp_iterations), max(s_g.icp_iterations)],
          "cpu_s": t_c, "cuda_s": t_g}
    log(f"[7] {json.dumps(st)}")
    return st


class HotLoops:
    """Counts (and, with ``timed``, times with a sync on each side) the calls
    of the LT-SLAM path's XLA-lowered hot loops, by patching the module
    attributes their callers read."""

    TARGETS = (("icp_1nn", "ltm_torch.register.icp", "nn_sqdist_argmin"),
               ("sc_distance_matrix", "ltm_torch.retrieval.scancontext", "sc_distance_matrix"),
               ("polar_bin_scatter_max", "ltm_torch.kernels.polar_bin", "make_descriptors"),
               ("tridiag_factor", "ltm_torch.graph.solver", "_tridiag_factor"),
               ("tridiag_apply", "ltm_torch.graph.solver", "_tridiag_apply"))

    def __init__(self, timed=False):
        import importlib

        self.timed = timed
        self.calls = {name: 0 for name, _, _ in self.TARGETS}
        self.seconds = {name: 0.0 for name, _, _ in self.TARGETS}
        self.bound_s = {name: 0.0 for name, _, _ in self.TARGETS}
        self.largest_1nn = None
        self._saved = []
        for name, mod, attr in self.TARGETS:
            m = importlib.import_module(mod)
            self._saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, self._wrap(name, getattr(m, attr)))

    def _wrap(self, name, fn):
        import torch

        def wrapped(*args, **kwargs):
            self.calls[name] += 1
            if self.timed:                   # the bound reads the masks' counts: a host sync
                self.bound_s[name] += hot_loop_bound_s(name, args)
            if name == "icp_1nn" and (self.largest_1nn is None
                                      or args[0].shape[0] > self.largest_1nn[0][0].shape[0]):
                self.largest_1nn = (args, kwargs)
            if not self.timed:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            return out
        return wrapped

    def restore(self):
        for m, attr, fn in self._saved:
            setattr(m, attr, fn)


def hot_loop_bound_s(name, args) -> float:
    """The least time the card could take for one hot-loop call: the larger
    of its bytes (inputs read once, outputs written once) at the HBM rate
    and its FP32 operations at the non-tensor peak, from the call's shapes
    (the 1-NN: 8 flops a valid pair)."""
    if name == "icp_1nn":
        q, qm, t, tm = args[:4]
        ops = 8.0 * float((qm.sum(-1).double() * tm.sum(-1).double()).sum())
        nbytes = q.numel() * 4 + qm.numel() + t.numel() * 4 + tm.numel() + qm.numel() * 12
    elif name == "sc_distance_matrix":
        (Q, R, S), T = args[0].shape, args[1].shape[0]
        ops = 2.0 * S * Q * T * (R * S + 2 * S)        # scores, column counts, sector keys
        nbytes = (Q + T) * R * S * 4 + Q * T * 8
    elif name == "polar_bin_scatter_max":
        xyz, mask = args[0], args[1]
        ops = 0.0
        nbytes = xyz.numel() * 4 + mask.numel() + xyz.shape[0] * 20 * 60 * 4
    elif name == "tridiag_factor":
        V = args[0].shape[0]
        ops = V * (4 * 216 + 2 * 216)                  # two 6x6 products and an inverse a block
        nbytes = 3 * V * 36 * 4
    else:                                              # tridiag_apply (Cinv, Lc, chains, r)
        r = args[3]
        lanes = r.numel() // (r.shape[-2] * 6)
        ops = lanes * r.shape[-2] * 4 * 72.0           # four 6x6 mat-vecs a block
        nbytes = 2 * args[0].numel() * 4 + 2 * r.numel() * 4
    return max(ops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S)


def nn_bound_and_library(args, kwargs):
    """The largest 1-NN call of the farm: its time by CUDA events, its bound
    (8 FP32 flops a valid pair at the card's peak, or its bytes) and the
    time of ``torch.cdist`` + ``min`` on the same inputs (in 4-lane chunks)."""
    import torch

    from ltm_torch.kernels.knn import nn_sqdist_argmin

    q, qm, t, tm = args
    ms = cuda_ms(lambda: nn_sqdist_argmin(*args, **kwargs), reps=3)
    pairs = float((qm.sum(-1).double() * tm.sum(-1).double()).sum())
    flops_ms = 8 * pairs / H100_FP32_FLOPS * 1e3
    nbytes = q.numel() * 4 + qm.numel() + t.numel() * 4 + tm.numel() + qm.numel() * 12
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3

    def library():
        for c in range(0, q.shape[0], 4):
            torch.cdist(q[c:c + 4], t[c:c + 4]).min(-1)
    lib_ms = cuda_ms(library, reps=3)
    return {"lanes": q.shape[0], "queries": q.shape[1], "targets": t.shape[1],
            "valid_pairs": pairs, "ms": ms, "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms, "library": "torch.cdist + min, 4 lanes a call"}


def phase_slam_full_width():
    """Phase 8: ``bench.py:_slam_bench``'s workload (500 keyframes a session,
    ~1 000 pose-graph nodes, ``LTSlamConfig()``): a warm-up, two timed runs
    (ATE ≤ 0.10 m), an instrumented run that times each hot-loop call with a
    sync on each side, one run with 10 RS loops (ATE ≤ 0.10 m) and one at
    ``odom_noise=4e-3`` (ATE ≤ 0.25 m)."""
    import torch

    from ltm_torch.core.config import LTSlamConfig
    from ltm_torch.graph import solver
    from ltm_torch.io.synthetic import make_two_sessions
    from ltm_torch.slam import LTSlam
    from ltm_torch.utils import host_reads, reset_host_reads, reset_stage_times, stage_times

    os.environ["LTM_SYNC_STAGES"] = "1"
    t0 = time.perf_counter()
    bundle = make_two_sessions(odom_noise=5e-4, **SLAM_WIDTH)
    n_kf = 2 * SLAM_WIDTH["num_keyframes"]
    log(f"[8] workload made in {time.perf_counter() - t0:.1f} s")

    def one_run(cfg, b, hot=None):
        reset_stage_times()
        reset_host_reads()
        torch.cuda.synchronize()
        slam = LTSlam(cfg, device="cuda")
        t0 = time.perf_counter()
        res = slam.run(b["central"].data, b["query"].data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        it = np.asarray(slam.icp_iterations)
        return res, {"wall_s": wall, "keyframes_per_s": n_kf / wall, "ate_rmse_m": slam_ate(res, b),
                     "sc_loops": res.num_sc_loops, "rs_loops": res.num_rs_loops,
                     "icp_pairs": len(it),
                     "icp_iterations_min_p50_p90_max": [int(it.min()), float(np.median(it)),
                                                        float(np.percentile(it, 90)), int(it.max())]
                     if len(it) else None,
                     "host_reads": host_reads(), "stages_s": stage_times(),
                     "hot_loop_calls": dict(hot.calls) if hot else None}

    runs = []
    for i in range(3):                          # run 0 warms up
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        hot = HotLoops()
        try:
            res, st = one_run(LTSlamConfig(), bundle, hot)
        finally:
            hot.restore()
        st["run"] = i
        runs.append(st)
        log(f"[8] {json.dumps(st)}")
        if st["ate_rmse_m"] > ATE_BOUND:
            raise AssertionError(f"full-width ATE {st['ate_rmse_m']} m > {ATE_BOUND} m")
        if res.num_sc_loops <= 0:
            raise AssertionError("full width: no SC loop accepted")
    peak = torch.cuda.max_memory_allocated()

    hot = HotLoops(timed=True)
    solver.CUDA_GRAPHS = False            # each sweep eagerly, so a sync can bracket it
    try:
        _, inst = one_run(LTSlamConfig(), bundle, hot)
    finally:
        hot.restore()
        solver.CUDA_GRAPHS = True
    optimize_s = sum(v for k, v in inst["stages_s"].items() if k.startswith("ltslam.optimize."))
    tri_s = hot.seconds["tridiag_factor"] + hot.seconds["tridiag_apply"]
    loops = {name: {"calls": hot.calls[name], "s": hot.seconds[name],
                    "ms_per_call": hot.seconds[name] / hot.calls[name] * 1e3 if hot.calls[name] else None,
                    "bound_ms_per_call": hot.bound_s[name] / hot.calls[name] * 1e3 if hot.calls[name] else None}
             for name in hot.calls}
    nn = nn_bound_and_library(*hot.largest_1nn)
    log(f"[8] instrumented run (a sync around each hot-loop call, PCG without CUDA graphs): "
        f"wall {inst['wall_s']:.3f} s, optimize {optimize_s:.3f} s, "
        f"{json.dumps(loops)}; tridiagonal share of ltslam.optimize.*: {tri_s / optimize_s:.4f}")
    log(f"[8] largest 1-NN call: {json.dumps(nn)}")

    cfg = LTSlamConfig()
    cfg.num_rs_loops_upper_bound = 10
    res, rs = one_run(cfg, bundle)
    log(f"[8] RS loops (num_rs_loops_upper_bound=10): {json.dumps(rs)}")
    if rs["ate_rmse_m"] > ATE_BOUND or res.num_rs_loops <= 0:
        raise AssertionError(f"RS run: ATE {rs['ate_rmse_m']} m, {res.num_rs_loops} RS loops")
    noisy_b = make_two_sessions(odom_noise=4e-3, **SLAM_WIDTH)
    _, noisy = one_run(LTSlamConfig(), noisy_b)
    log(f"[8] odom_noise=4e-3: {json.dumps(noisy)}")
    if noisy["ate_rmse_m"] > ATE_NOISY_BOUND:
        raise AssertionError(f"noisy run: ATE {noisy['ate_rmse_m']} m > {ATE_NOISY_BOUND} m")

    timed = runs[1:]
    summary = {
        "keyframes": n_kf,
        "median_keyframes_per_s": statistics.median(r["keyframes_per_s"] for r in timed),
        "median_wall_s": statistics.median(r["wall_s"] for r in timed),
        "ate_rmse_m": [r["ate_rmse_m"] for r in timed], "sc_loops": timed[-1]["sc_loops"],
        "rs_run": {k: rs[k] for k in ("ate_rmse_m", "rs_loops", "wall_s", "stages_s")},
        "noisy_run": {k: noisy[k] for k in ("ate_rmse_m", "sc_loops", "wall_s")},
        "stages_s": timed[-1]["stages_s"],
        "icp_iterations_min_p50_p90_max": timed[-1]["icp_iterations_min_p50_p90_max"],
        "host_reads": timed[-1]["host_reads"],
        "hot_loop_calls_per_run": timed[-1]["hot_loop_calls"],
        "hot_loops_instrumented": loops,
        "instrumented_wall_s": inst["wall_s"],
        "instrumented_optimize_s": optimize_s,
        "tridiag_share_of_optimize_eager": tri_s / optimize_s,
        "largest_1nn_call": nn,
        "max_memory_allocated_bytes": peak,
    }
    log(f"[8] {json.dumps(summary)}")
    return summary


def phase_slam_cli(device="cuda"):
    """Phase 9: ``python -m ltm_torch.cli.ltmapper`` in a subprocess on session
    directories (``write_session_dir``, 40 keyframes x 8 000 points a
    session); its ``removert/`` tree must equal ``Removerter.run`` in this
    process on the ``ltslam/`` poses it wrote: the same files, the same
    point count in each."""
    from ltm_torch.core.config import RemovertConfig
    from ltm_torch.io.pcd import read_pcd
    from ltm_torch.io.sessions import write_session_dir
    from ltm_torch.io.synthetic import make_two_sessions
    from ltm_torch.removert import Removerter, RemovertInput

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_ltmapper")
    shutil.rmtree(root, ignore_errors=True)
    b = make_two_sessions(odom_noise=5e-4, **dict(SLAM_WIDTH, num_keyframes=SLAM_CLI_KEYFRAMES))
    for name in ("central", "query"):
        write_session_dir(os.path.join(root, "data", b[name].data.name), b[name].data)
    out_dir = os.path.join(root, "out")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ltm_torch.cli.ltmapper", "--sessions-dir",
                          os.path.join(root, "data"), "--out", out_dir, "--device", device],
                         capture_output=True, text=True, timeout=600, cwd=repo)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"ltmapper exited {out.returncode}:\n{out.stderr[-4000:]}")
    slam_files = sorted(os.listdir(os.path.join(out_dir, "ltslam")))
    want = sorted(f"{n}_{k}_{p}_intersession_loops.txt" for n in ("01", "02")
                  for k in ("local", "central") for p in ("bfr", "aft"))
    if slam_files != want:
        raise AssertionError(f"ltslam/ holds {slam_files}")
    lib_dir = os.path.join(root, "lib_removert")
    Removerter(RemovertConfig(), device=device).run(
        *(RemovertInput.from_dirs(os.path.join(root, "data", n, "Scans"),
                                  os.path.join(out_dir, "ltslam", f"{n}_central_aft_intersession_loops.txt"))
          for n in ("01", "02")), save_directory=lib_dir)

    def tree(d):
        return {os.path.relpath(os.path.join(a, n), d): len(read_pcd(os.path.join(a, n)))
                for a, _, names in os.walk(d) for n in names if n.endswith(".pcd")}

    cli, lib = tree(os.path.join(out_dir, "removert")), tree(lib_dir)
    if not cli or cli != lib:
        raise AssertionError(f"ltmapper's removert/ and the in-process tree differ: "
                             f"{sorted(set(cli) ^ set(lib))} "
                             f"{[k for k in cli if k in lib and cli[k] != lib[k]]}")
    st = {"keyframes_a_session": SLAM_CLI_KEYFRAMES, "removert_files": len(cli),
          "points": sum(cli.values()), "updated_map_points": cli.get("updated_map.pcd"),
          "cli_s": cli_s}
    log(f"[9] {json.dumps(st)}")
    shutil.rmtree(root, ignore_errors=True)
    return st


def main() -> int:
    import torch

    faulthandler.enable()   # a crash in native code prints the Python stack

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
    km4 = phase_chunk_cases(dev)

    cfg = RemovertConfig()
    cfg.downsample_voxel_size = 0.1
    phase_card_vs_cpu(cfg)
    brute = RemovertConfig()
    brute.downsample_voxel_size = 0.1
    brute.use_chunk_knn = False    # phase 4 is the brute-force path (K1) by design
    calls, last_run, brute_masks = phase_full_width(brute)
    k4_calls, k4_run = phase_default_config(cfg, brute_masks)
    phase_cli()
    slam = {"card_vs_cpu": phase_slam_card_vs_cpu(), "full_width": phase_slam_full_width(),
            "ltmapper_cli": phase_slam_cli()}

    nd = calls[0]
    k4_nd = next(st for st in k4_calls if st["case"] == "full_width_nd")
    per_call = ("case", "n_valid", "scored_pairs", "listed_blocks", "overflowed_chunks",
                "k_blocks", "chunks_culled", "block_tests_per_chunk", "max_block_tests",
                "work_items", "merge_launches", "kernel_ms", "prep_ms", "scan_ms",
                "scan_ms_by_seg", "merge_ms", "plain_ms", "bound_ms", "bound_by", "gather_ms",
                "k1_yardstick_ms")
    kernels = [{
        "name": "knn2_sqdists",
        "route": "cuda",
        "route_kernels": ["knn2_compact (valid points)",
                          "knn2_scan (queries x target split)",
                          "knn2_merge (partial top-2s, when the targets split)"],
        "source": "ltm_torch/csrc/knn2.cu",
        "replaces": "ltm/kernels/pallas_knn.py:95",
        "launches": last_run["knn2_launches"],
        "launches_path": "phase 4 (use_chunk_knn=False)",
        "merge_launches": last_run["knn2_merge_launches"],
        "max_abs_err": max(st["max_abs_err"] for st in calls),
        "ms": nd["kernel_ms"],
        "plain_ms": nd["plain_ms"],
        "bound_ms": nd["bound_ms"],
        "bound_by": nd["bound_by"],
        "library_ms": nd["library_ms"],
        "per_launch": [{k: st.get(k) for k in ("case", "valid_pairs", "splits", "kernel_ms",
                                               "unsplit_ms", "bound_ms", "bound_by", "plain_ms",
                                               "library_ms")}
                       for st in calls],
        "km_scale_ms": km["kernel_ms"],
        "km_scale_unsplit_ms": km.get("unsplit_ms"),
        "km_scale_bound_ms": km["bound_ms"],
        "km_scale_library_ms": km["library_ms"],
    }, {
        "name": "chunk_knn_sqdists",
        "route": "cuda",
        "route_kernels": ["ck_cell_min, ck_keys (Morton keys, query indices)",
                          "CUB DeviceRadixSort::SortPairs (their stable order, in the prep's "
                          "C call)",
                          "ck_bounds (block and super-block AABBs)",
                          "ck_cull (a chunk's ball, the two-level cull, work items)",
                          "ck_score (persistent warps over the work items)",
                          "ck_merge (rows of chunks split over several items)"],
        "source": "ltm_torch/csrc/chunk_knn.cu",
        "replaces": "ltm/kernels/chunk_knn.py:119",
        "launches": k4_run["k4_launches"],
        "launches_path": "phase 5 (RemovertConfig() defaults)",
        "merge_launches": k4_run["k4_merge_launches"],
        "max_abs_err": max(st["max_abs_err"] for st in k4_calls),
        "ms": k4_nd["kernel_ms"],
        "plain_ms": k4_nd["plain_ms"],
        "bound_ms": k4_nd["bound_ms"],
        "bound_by": k4_nd["bound_by"],
        "library_ms": None,
        "k1_yardstick_ms": k4_nd["k1_yardstick_ms"],
        "per_launch": [{k: st.get(k) for k in per_call} for st in k4_calls],
        "scan_ms": k4_nd["scan_ms"],
        "km_offset_ms": km4["kernel_ms"],
        "km_offset_scan_ms": km4["scan_ms"],
        "km_offset_scan_ms_by_seg": km4["scan_ms_by_seg"],
        "km_offset_bound_ms": km4["bound_ms"],
        "km_offset_k1_yardstick_ms": km4["k1_yardstick_ms"],
    }]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"slam": slam}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
