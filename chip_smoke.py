#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``ltm_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ltm_torch/csrc`` (nvcc,
sm_90a), then runs fourteen phases, each of which raises on failure:

  1. device and build: the card, PyTorch/CUDA versions, kernel build time,
     the ``-Xptxas -v`` report of every source, and the hot blocks of the
     2-NN scan and the 1-NN scan read from ``cuobjdump -sass`` (full dumps
     in ``knn2.sass`` and ``nn.sass`` under ``OUT_DIR``);
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
     work (block tests, work items) equal to the plain steps'; the sweep
     kernels K2 and K3 (``csrc/sweep.cu``): the pixel rule on 2^21 points
     (azimuth ±180°, row clamps, pixel edges, range 0, the packed clamp)
     against ``spherical_project``/``_pack_points``, then the four block
     sweeps on both ``reverse`` values, a ``presel`` list with padding
     entries, ``k_blocks == n_blocks``, a point at range 0, an all-masked
     keyframe, far-padded keyframes, K = 0, forced keyframe chunks and, at
     a finer resolution, one case of the global variant a kernel and a
     cluster of 8 CTAs, each launched twice and bit-equal to its
     ``*_plain`` loop, and the cluster variant's device memory (no image
     allocated); the solver's fixed-order scatter-sum
     (``csrc/scatter.cu``) on a pose graph's shape, rows of 1 to 70
     elements, bit-equal to its plain version; K5b, the ICP 1-NN
     (``csrc/nn_argmin.cu``), on ten cases against
     ``nn_sqdist_argmin_plain`` (indices equal except at counted
     near-ties, distances bit-equal where they agree, a lane alone equal
     to the same lane in its batch, the scan's own counts of tiles scored
     and culled; duplicated targets, a lane without a valid target, a
     split boundary, the farm's largest shape on a random cloud and in the
     farm's voxel point order, both timed, with 1, 2, 4 and 8 splits);
     K5a, the solver's block-tridiagonal factor and solve
     (``csrc/tridiag.cu``), on random SPD systems on LTSlam's chain layout
     at phase 8's width and on ragged chains, float32 and float64, with no
     lane, 4 and 120 lanes (the marginals' shape, timed, beside the
     register-only dependent-step floors of the factor and the solve, and
     the solve in float64 for the float64-P trial): each launched twice
     (the same bits), captured in a CUDA graph (the eager bits), and the
     factor's Cinv and P and the solve no further from the float64 plain
     version than twice the plain float32 route, or 1e-6, both measured
     block by block (a block's error over its own size:
     ``kernels.tridiag.card_rule``, through ``tridiag_rule``); the factor's
     reciprocal (``rcp.approx.ftz.f64`` and a Newton step) within one ulp
     of IEEE ``1/x`` on 2^22 values (``recip_check``); K5c, the solver's
     Gauss-Newton product (``csrc/gn_product.cu``), on random graphs of
     phase 8's shape at 1, 4, 120 and 762 lanes (the RS marginals' 6 M), on
     small graphs with invalid factors, fixed variables, a row of degree
     0 and anchored factors whose anchors coincide, float32 and float64,
     and on small graphs whose anchor rows sit at the rows kernel's heavy
     threshold, one either side of it and over two of its chunks, at 1, 4,
     40 and 762 lanes: each launched twice and captured in a CUDA graph,
     bit-equal to ``gn_product_plain`` (``gn_cases``), the one-lane and the
     marginals' shapes timed, by kernel too, against the bound, the no-FMA
     contract floor and the route before K5c;
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
     items, and merge launches.  K2 and K3 must launch in every timed run;
     every sweep call of the warm-up run is held to its plain loop bit for
     bit, the largest call of each sweep is timed against its bound and its
     plain loop, and one set of runs in turns (plain sweeps, kernels,
     kernels, plain) gives both routes' stage walls, its sets phase 4's;
  6. the CLI: ``python -m ltm_torch.cli.ltremovert`` in a subprocess on
     session directories of 8 keyframes x 120k points a session; its
     artifact tree must hold the expected files with the point counts of
     ``Removerter.run`` on the same inputs in this process;
  7. LT-SLAM card vs CPU: ``LTSlam.run`` with ``LTSlamConfig()`` on phase
     8's workload cut to 60 + 20 keyframes, on both devices: the same
     accepted loop set, central poses within 0.01 m;
  8. LT-SLAM at full width: ``bench.py:_slam_bench``'s workload (two
     sessions x 500 keyframes x 8 000 points, ``LTSlamConfig()``), a
     warm-up and one timed run (ATE RMSE ≤ 0.10 m), one run that times
     each call of the path's hot loops (the ICP 1-NN, the Scan Context
     distance, the polar-bin scatter-max, the tridiagonal sweeps) with a
     sync on each side (outside the PCG's graph replays), the largest
     1-NN call (K5b) against the plain version, its bound and
     ``torch.cdist``, one run with 10 RS loops (ATE ≤ 0.10 m) and one at
     ``odom_noise=4e-3`` (ATE ≤ 0.25 m); every 1-NN call of the warm-up
     run is held to the plain version as it happens (``NnFarmCheck``, with
     the scan's counts of tiles scored and culled), K5b must launch once a
     1-NN call, LT-SLAM's peak memory is recorded;
     the scatter-sum kernel must launch, and its largest calls of the
     warm-up run are held to the plain version and timed against their
     bound and ``index_add_``, wrapper and device time; every eager call of
     the tridiagonal factor and solve (K5a) in the warm-up run is held to
     its plain version under phase 2's rule (``TridiagCheck``: the
     factor's Cinv and P, its Lc bit-equal, the solve; each float32 solve
     also with P kept in double, ``p64_trial``), K5a must
     launch once a call of each, the solve's runs are counted with the
     PCG's graph replays, its largest calls are timed (one call, a call in
     a CUDA graph, the plain version, the bound, the longest chain, the
     device ms a dependent step and the register-only floors), a
     graph-replayed PCG iteration is
     profiled by kernel with K5a and with the plain sweeps, and one run with
     the plain sweeps gives the wall and the solver's stages beside the
     timed run's; every eager Gauss-Newton product (K5c) of the warm-up and
     of the RS run is held to ``gn_product_plain`` bit for bit
     (``GnCheck``), K5c must run once a PCG iteration (its launches with
     the graph replays), the LM's call and the marginals' are timed
     (``compare_gn``), the LM's PCG iteration is profiled with the route
     before K5c too, and the RS run's marginals are measured by parts
     (``MarginalsProbe``: M, the iterations a lane, the wall split into
     set-up, first eager iteration, capture and replays, peak memory) and
     in turns against the route before K5c (``marginals_turns``: old,
     kernel, kernel, old);
  9. ``python -m ltm_torch.cli.ltmapper`` in a subprocess on session
     directories of 40 keyframes x 8 000 points a session: ``ltslam/``
     holds the eight trajectory files and ``removert/`` equals
     ``Removerter.run`` in this process on those poses;
 10. the lifelong meta-map chain: ``bench.py:_lifelong_bench``'s workload
     (6 sessions x 24 keyframes x 40 000 points, seed 29) through
     ``lifelong_update``, a warm-up and two timed chains (per-round walls,
     nd/pd/updated, K4 and K1 launches a round, peak memory, the last
     round's keyframes/s), each K4 call of the warm-up chain's last round
     held to the plain version bit for bit, then the chain cut to 3
     sessions x 6 keyframes on the card (K4 must launch) and on the CPU:
     each round's 14 sets and the live map within phase 3's rule;
 11. the opt-in configurations: (a) occlusion culling on phase 5's
     workload, its 14 masks bit-equal to phase 5's, every presel sweep
     call (K2) of its warm-up run launched twice and bit-equal to its
     plain loop and to the run's result, and the grid kNN refused on that
     corridor for the points past ±2^9 cells alone; (b)
     the grid kNN on phase 10's first session pair, its masks equal to the
     brute path's, whose K1 calls are held to the plain version, its ND
     call timed against K1 and K4; (c) ``device_scan_prep`` on phase 5's
     workload, the timed run's central map against the CPU's build, card
     against CPU on phase 3's workload, and the map equivalent to the host
     prep's at full density; (d) ``use_self_removert``, card against CPU
     on phase 3's workload and one run at phase 5's width; then each hot
     loop of these paths (torch ops) at its largest call against its
     bound;
 12. ``bench.py:62-119``'s headline workload: the 5 M-point visibility sweep
     (``block_sweep_discrepancy``, 32 keyframes x 65 536 points, K2 in every
     timed sweep), its keyframes/s and flagged count, the sweep in turns
     through the plain loop and K2 (bit-equal), and K2's time against its
     bound;
 13. LT-removert on a mesh of 4 slots of the card (``ltm_torch.dist``):
     ``Removerter.run`` on phase 5's workload with the mesh assigned to
     ``rm.mesh``, its 14 sets equal to phase 4's with the chunked kNN and
     without it, its wall and stage walls beside phase 5's; every sharded
     function at those shapes bit-equal to its one-device function, and
     each K4 call of the run scanned shard by shard (one scan a non-empty
     shard, the ranges covering every chunk once, counts summed, rows 0
     ulps from the plain version); the whole-map path on phase 3's
     workload, mesh against one device and card against CPU; the run once
     more through a one-process NCCL group (``initialize_multihost``); and
     phase 10's cut chain on 2 slots, its sets the one-device chain's;
 14. LT-SLAM on a mesh of 4 slots of the card: ``LTSlam.run`` at phase 8's
     full width with the mesh assigned to ``LTSlam.mesh`` (schur), its
     accepted loop set phase 8's, central poses within 0.01 m of phase 8's,
     ATE ≤ 0.10 m, its stage walls beside phase 8's; the sharded Scan
     Context distance, ICP farm and solver (both modes) at those shapes
     against their one-device functions (the one-device solve of phase
     8's graph twice, bit for bit; an ICP lane's result independent of its
     batch), and the solver's collectives an
     LM step; phase 7's cut workload on 4 slots, card against CPU; and
     ``solve_sharded`` on 2 slots through a one-process NCCL group, bit for
     bit the same call without a group; beside the schur mode's gate, both
     solves driven the one-device solve's number of LM steps
     (``fixed_step_pair``, logged).

Every timed call whose targets split is also run and timed with the plan
held at one split, which must give the same bits.

It prints the ``{"kernels": [...]}`` line, the ``{"slam": {...}}`` line
(phases 7-9), the ``{"lifelong": ..., "optin": ..., "headline": ..., "mesh": ...,
"slam_mesh": ...}`` line (phases 10-14), then the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  The ``kernels`` line lists K1, K4, K2
and K3 (each with both variants), the solver's scatter-sum, K5b, K5a's
factor and solve, and K5c; the rest of the LT-SLAM path's hot loops (the Scan
Context distance and descriptors) are PyTorch ops, measured in phase 8.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.  The port imports neither ``jax`` nor ``ltm``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
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
H100_FP64_FLOPS = 34e12      # non-tensor FP64 peak, H100 SXM (NVIDIA data sheet)
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
    and against its bound, the K1 yardstick (the same targets through
    ``knn2_sqdists`` plus the clamp) and ``library_knn2_ms`` (``cdist`` +
    ``topk`` over the same valid points, query-chunked, unclamped).
    Returns stats."""
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
        stats["library_ms"] = library_knn2_ms(q, qm, t, tm)
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


def sass_hot_blocks(lib_path, kernel="knn2_scan"):
    """The hot block of ``kernel`` (``knn2_scan`` or ``nn_scan``) in the
    built library, from ``cuobjdump -sass``: the basic block with the most
    FFMA, which is one group's fast path (its 32 pairs' arithmetic, their
    OR-ed test and the branch).  Instructions, pairs (one FMUL each),
    instructions a pair and the opcode counts.  The full dump goes to
    ``chiprun_out/<library>.sass``."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return {"cuobjdump": "not found"}
    text = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, kernel.split("_")[0] + ".sass"), "w") as f:
        f.write(text)
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        if kernel not in func.split("\n", 1)[0]:
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
    raise AssertionError(f"cuobjdump -sass shows no {kernel}")


def device_profile(fn, top=8):
    """One profiled call of ``fn``: the card's busy share (summed kernel
    time over the wall, which the profiler's own host cost inflates, so the
    share is a lower bound) and the ``top`` kernels (None: all) that took
    the most device time.
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
    for lib, kernel in (("knn2", "knn2_scan"), ("nn_argmin", "nn_scanILb0E")):
        log(f"[1] {kernel} hot block (cuobjdump -sass): "
            f"{json.dumps(sass_hot_blocks(_build._lib_path(lib), kernel))}")
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


# ---- the solver's fixed-order scatter-sum -------------------------------------

def scatter_index(plan):
    """The index array of ``plan`` as ``index_add_`` takes it: each listed
    contribution's row, and a spare row past the last for those no row
    lists."""
    import torch

    counts = plan.rowptr[1:] - plan.rowptr[:-1]
    rows = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device),
                                   counts.long())
    idx = torch.full((plan.n_src,), counts.shape[0], dtype=torch.long, device=counts.device)
    idx[plan.cols.long()] = rows
    return idx


def compare_scatter(name, src, plan, timed=False):
    """``fixed_order_sum`` through its kernel on the card, a second launch,
    and ``fixed_order_sum_plain`` on the same inputs: the same bits.  With
    ``timed``: the kernel's ms (CUDA events, median of 5) against its bound
    (its bytes, each read or written once, or its adds at the card's rate
    for the type), the plain version's ms and ``index_add_``'s (the library
    call; atomic, not a fixed order).  The launch count is restored."""
    import torch

    from ltm_torch.kernels.scatter import fixed_order_sum, fixed_order_sum_plain

    saved = fixed_order_sum.launches
    try:
        got = fixed_order_sum(src, plan)
        again = fixed_order_sum(src, plan)
        plain = fixed_order_sum_plain(src, plan)
        torch.cuda.synchronize()
        differ, repeat = int((got != plain).sum()), int((got != again).sum())
        err = float((got.double() - plain.double()).abs().max()) if differ else 0.0
        if differ or repeat:
            raise AssertionError(f"fixed_order_sum {name}: {differ} entries differ from the "
                                 f"plain version (largest {err}), {repeat} between launches")
        st = {"case": name, "src": list(src.shape), "dtype": str(src.dtype).split(".")[-1],
              "rows": plan.rowptr.shape[0] - 1, "max_degree": plan.table.shape[1],
              "differ": differ, "repeat_differ": repeat, "max_abs_err": err}
        if timed:
            idx = scatter_index(plan)
            spare = got.shape[:-2] + (got.shape[-2] + 1, got.shape[-1])

            def library():
                return torch.zeros(spare, dtype=src.dtype, device=src.device).index_add_(
                    -2, idx, src)

            st["ms"] = cuda_ms(lambda: fixed_order_sum(src, plan), reps=5)
            st["plain_ms"] = cuda_ms(lambda: fixed_order_sum_plain(src, plan), reps=1)
            st["library_ms"] = cuda_ms(library, reps=5)
            st.update(scatter_device_times(lambda: fixed_order_sum(src, plan), library))
            size = src.element_size()
            nbytes = (src.numel() + got.numel()) * size + 4 * (plan.n_src + plan.rowptr.numel())
            rate = H100_FP32_FLOPS if src.dtype == torch.float32 else H100_FP64_FLOPS
            t_ops, t_bytes = src.numel() / rate, nbytes / H100_BYTES_PER_S
            st.update(bytes=nbytes, adds=src.numel(), bound_ms=1e3 * max(t_ops, t_bytes),
                      bound_by="operations" if t_ops >= t_bytes else "bytes")
    finally:
        fixed_order_sum.launches = saved
    return st


def capture(fn, calls=1):
    """``calls`` calls of ``fn`` captured as one CUDA graph (after one call
    on a side stream, as capture needs), replayed once: (the graph, the
    last captured call's outputs)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph, out


def graph_replay_ms(fn, calls=50, reps=5):
    """Device ms a call of ``fn`` with no host in the way: ``calls`` calls
    captured as one CUDA graph (``capture``), its replay timed by CUDA
    events (median of ``reps``), divided by ``calls`` (how the PCG's graph
    replays pay)."""
    return cuda_ms(capture(fn, calls)[0].replay, reps=reps) / calls


def scatter_device_times(kernel, library, calls=200, profiled=50, turns=8):
    """The scatter-sum against ``index_add_`` as the solver pays for them,
    each side in ``turns`` turns (kernel, library, library, kernel, ...),
    the card warm from the turns before: ms a call over ``calls`` calls
    back to back on the host clock, ended by one sync (what the eager calls
    pay: the larger of the wrapper's host work and the device time); ms a
    call inside a CUDA graph (``graph_replay_ms``: what the PCG's replays
    pay); and device ms a call from ``torch.profiler`` over ``profiled``
    calls (the kernel's own time; the library's ``zeros`` fill and
    ``index_add_``).  The profiler at times records some or none of such
    short kernels (a turn of 0): its median is over the turns it recorded,
    and ``graph_replay_ms`` is the device figure to read.  The median of
    each side's turns, and every turn."""
    import torch

    def repeated(fn, n):
        def run():
            for _ in range(n):
                fn()
        return run

    sides = {"": kernel, "library_": library}
    keys = ("back_to_back_turns_ms", "graph_replay_turns_ms", "device_turns_ms")
    out = {tag + key: [] for tag in sides for key in keys}
    order = ["", "library_", "library_", ""] * (turns // 4)
    for fn in sides.values():
        repeated(fn, calls)()
    for tag in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        repeated(sides[tag], calls)()
        torch.cuda.synchronize()
        out[tag + "back_to_back_turns_ms"].append((time.perf_counter() - t0) / calls * 1e3)
    for tag in order:
        out[tag + "graph_replay_turns_ms"].append(graph_replay_ms(sides[tag]))
    for tag in order:
        prof = device_profile(repeated(sides[tag], profiled))
        out[tag + "device_turns_ms"].append(prof["device_busy_s"] * 1e3 / profiled)
        out[tag + "device_kernels_ms"] = {k: v / profiled
                                          for k, v in prof["top_device_ms"].items()}
    for tag in sides:
        out[tag + "back_to_back_ms"] = statistics.median(out[tag + "back_to_back_turns_ms"])
        out[tag + "graph_replay_ms"] = statistics.median(out[tag + "graph_replay_turns_ms"])
        recorded = [t for t in out[tag + "device_turns_ms"] if t > 0]
        out[tag + "device_ms"] = statistics.median(recorded) if recorded else "not measured"
    return out


def scatter_recorder(calls):
    """A stand-in for the solver's ``fixed_order_sum`` that runs it and
    keeps, for each row width, the call with the most contributions
    (``calls``: {width name: (src, plan)}); a call inside a CUDA graph's
    capture is not kept."""
    import torch

    from ltm_torch.kernels.scatter import fixed_order_sum

    def recording(src, plan):
        out = fixed_order_sum(src, plan)
        if not torch.cuda.is_current_stream_capturing():
            name = f"width_{src.shape[-1]}" + ("_lanes" if src.dim() > 2 else "")
            if name not in calls or src.numel() > calls[name][0].numel():
                calls[name] = (src.clone(), plan)
        return out
    return recording


def scatter_cases(dev):
    """Phase 2, the fixed-order scatter-sum: a pose graph's shape (1 026
    variables: two odometry chains, priors, two anchors each touched by 600
    anchored factors' ends, 8 % padding at variable 0), float32 and float64,
    one lane and 12 lanes, rows of 1, 6, 33, 36 and 70 elements (one warp
    load of several rows, one of a row, passes of 32), each against its
    plain version bit for bit."""
    import torch

    from ltm_torch.kernels.scatter import plan_scatter

    rng = np.random.default_rng(17)
    V, n = 1026, 512
    chain = np.concatenate([np.arange(0, n - 1), np.arange(n, 2 * n - 1)])
    ends = np.concatenate([[0, n], chain, chain + 1, rng.integers(0, n, 600),
                           rng.integers(n, 2 * n, 600), np.full(600, 2 * n),
                           np.full(600, 2 * n + 1), np.zeros(200, np.int64)])
    plan = plan_scatter(ends, V, dev)
    out = []
    for dtype in (torch.float32, torch.float64):
        for shape in ((len(ends), 36), (len(ends), 6), (12, len(ends), 6), (len(ends), 1),
                      (3, len(ends), 33), (len(ends), 70)):
            src = torch.from_numpy(rng.normal(size=shape)).to(dev, dtype)
            out.append(compare_scatter(f"graph_{len(shape) - 1}d_{shape[-1]}", src, plan))
    return out


# ---- K5b, the ICP 1-NN -------------------------------------------------------

NEAR_TIE = 1e-5    # m², tests/test_torch_icp.py:59: both picks this close to each other


def nn_counts():
    from ltm_torch.kernels.nn_argmin import nn_argmin_select

    return nn_argmin_select.launches, nn_argmin_select.merges


def set_nn_counts(values=(0, 0)):
    from ltm_torch.kernels.nn_argmin import nn_argmin_select

    nn_argmin_select.launches, nn_argmin_select.merges = values


def nn_diff(got, want, args):
    """K5b's ``(d, index)`` against the plain version's on the same inputs:
    (indices that differ, distances that differ where the indices agree,
    the largest absolute difference of the distances).
    Each differing index must be a near-tie: both picks valid targets whose
    exact squared distances (float64, original coordinates) are within
    ``NEAR_TIE`` of each other; anything else raises."""
    import torch

    (d, i), (d_w, i_w) = got, want
    q, _, t, tm = args
    apart = i != i_w
    bits = int(((d != d_w) & ~apart).sum())
    n_apart = int(apart.sum())
    if n_apart:
        lead = apart.nonzero(as_tuple=True)
        rows = lead[:-1]
        qd = q[lead].double()

        def exact(idx):
            pick = idx[lead]
            return ((qd - t[rows + (pick,)].double()) ** 2).sum(-1), tm[rows + (pick,)]

        (e, ok), (e_w, ok_w) = exact(i), exact(i_w)
        bad = ~ok | ~ok_w | ((e - e_w).abs() > NEAR_TIE)
        if bool(bad.any()):
            k = int(bad.nonzero()[0, 0])
            raise AssertionError(f"1-NN: {int(bad.sum())} of {n_apart} index differences are "
                                 f"not near-ties (first: exact {float(e[k])} against "
                                 f"{float(e_w[k])}, valid {bool(ok[k])}/{bool(ok_w[k])})")
    err = float((d.double() - d_w.double()).abs().max()) if d.numel() else 0.0
    return n_apart, bits, err


def nn_work(args, got=None):
    """The scan's own counts of its work on one call of K5b
    (``nn_argmin_select(..., counts=)``): tiles its warps considered,
    scored and culled, the update branches they took, and the cull's share
    of the tiles.  The counted launch must give ``got``'s bits; the launch
    counts are restored."""
    import torch

    from ltm_torch.kernels.nn_argmin import nn_argmin_select

    counts = torch.zeros(4, dtype=torch.int64, device=args[0].device)
    saved = nn_counts()
    try:
        out = nn_argmin_select(*args[:4], counts=counts)
    finally:
        set_nn_counts(saved)
    if got is not None and not (torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])):
        raise AssertionError("K5b: the counted scan gave other bits than the call")
    considered, scored, culled, branches = (int(v) for v in counts.cpu())
    return {"tiles_considered": considered, "tiles_scored": scored, "tiles_culled": culled,
            "update_branches": branches,
            "cull_share": culled / considered if considered else "not measured"}


def nn_lane_alone(args, kwargs, got, lanes):
    """Each lane of ``lanes`` through the kernel in a batch of its own: the
    bits of its row of ``got`` (the batch's result); entries that differ."""
    from ltm_torch.kernels.knn import nn_sqdist_argmin

    differ = 0
    for b in lanes:
        d, i = nn_sqdist_argmin(*(x[b:b + 1] for x in args), **kwargs)
        differ += int((d[0] != got[0][b]).sum() + (i[0] != got[1][b]).sum())
    return differ


def compare_nn(name, args, kwargs=None, timed=False):
    """``nn_sqdist_argmin`` through K5b on the card (twice: the same bits),
    against ``nn_sqdist_argmin_plain`` on the same inputs (``nn_diff``),
    and, with several lanes, the first, a middle and the last lane each
    alone (``nn_lane_alone``: 0 entries apart).  With ``timed``: the
    wrapper's ms (CUDA events, median of 5), its kernels' device time
    (``device_profile``), the ms with the plan held at one split, the plain
    version's ms (once), ``torch.cdist`` + ``min`` (4 lanes a call), and
    the bound: 8 FP32 flops a pair of the tiles the scan scored (its own
    count, ``nn_work``: the work this call's data needed past the cull), or
    the bytes; over every valid pair beside it.  The launch counts are
    restored."""
    import torch

    from ltm_torch.kernels import nn_argmin
    from ltm_torch.kernels.knn import nn_sqdist_argmin, nn_sqdist_argmin_plain

    kwargs = kwargs or {}
    q, qm, t, tm = args
    saved = nn_counts()
    try:
        got = nn_sqdist_argmin(*args, **kwargs)
        again = nn_sqdist_argmin(*args, **kwargs)
        want = nn_sqdist_argmin_plain(*args, **kwargs)
        torch.cuda.synchronize()
        repeat = int((got[0] != again[0]).sum() + (got[1] != again[1]).sum())
        apart, bits, err = nn_diff(got, want, args)
        lanes = q.shape[0] if q.dim() > 2 else 1
        alone = (nn_lane_alone(args, kwargs, got, sorted({0, lanes // 2, lanes - 1}))
                 if q.dim() > 2 and lanes > 1 else 0)
        if repeat or bits or alone:
            raise AssertionError(f"1-NN {name}: {repeat} entries apart between launches, {bits} "
                                 f"distances apart where the indices agree, {alone} entries "
                                 f"apart for a lane alone")
        splits = nn_argmin._device_plan(q.device, lanes, q.shape[-2], t.shape[-2])[0]
        st = {"case": name, "shape": [lanes, q.shape[-2], t.shape[-2]], "splits": splits,
              "near_ties": apart, "differ_where_indices_agree": bits, "repeat_differ": repeat,
              "lane_alone_differ": alone, "max_abs_err": err}
        st["work"] = nn_work(args, got)
        if timed:
            st.update(nn_timing(args, kwargs))
            # the work this call's data needed: the pairs of the tiles its warps
            # scored (a tile of 256 targets against a warp's 128 query slots),
            # at most the valid pairs
            scored = 256.0 * 128.0 * st["work"]["tiles_scored"]
            flops_ms = 8 * min(scored, st["valid_pairs"]) / H100_FP32_FLOPS * 1e3
            st.update(all_pairs_bound_ms=st["bound_ms"], all_pairs_bound_by=st["bound_by"],
                      scored_pairs=scored, bound_ms=max(flops_ms, st["bytes_ms"]),
                      bound_by="operations" if flops_ms >= st["bytes_ms"] else "bytes")
    finally:
        set_nn_counts(saved)
    return st


def nn_timing(args, kwargs):
    """The timing half of ``compare_nn`` (launch counts not restored)."""
    import torch

    from ltm_torch.kernels import nn_argmin
    from ltm_torch.kernels.knn import nn_sqdist_argmin, nn_sqdist_argmin_plain

    q, qm, t, tm = args
    st = {"ms": cuda_ms(lambda: nn_sqdist_argmin(*args, **kwargs), reps=5)}
    for tag, fn in (("", nn_sqdist_argmin), ("plain_", nn_sqdist_argmin_plain)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        st[tag + "peak_above_inputs_bytes"] = torch.cuda.max_memory_allocated() - held
    profiled = 5      # one call's records were at times missing from the profile

    def calls():
        for _ in range(profiled):
            nn_sqdist_argmin(*args, **kwargs)
    for _ in range(3):   # a profile at times holds none of the calls' kernels
        prof = device_profile(calls)
        st["device_ms"] = {k: v / profiled for k, v in prof["top_device_ms"].items()
                           if "nn_" in k}
        if st["device_ms"]:
            break
    plan = nn_argmin._plan
    st["split_sweep_ms"] = {}
    try:
        for splits in (1, 2, 4, 8):
            nn_argmin._plan = lambda lanes, n, m, *rest, s=splits: max(
                s, -(-m // (nn_argmin._TILE * nn_argmin._MAX_TILES)))
            st["split_sweep_ms"][splits] = cuda_ms(lambda: nn_sqdist_argmin(*args, **kwargs),
                                                   reps=3)
    finally:
        nn_argmin._plan = plan
    st["unsplit_ms"] = st["split_sweep_ms"][1]
    st["plain_ms"] = cuda_ms(lambda: nn_sqdist_argmin_plain(*args, **kwargs), reps=1)
    q3, t3 = (q, t) if q.dim() > 2 else (q[None], t[None])

    def library():
        for c in range(0, q3.shape[0], 4):
            torch.cdist(q3[c:c + 4], t3[c:c + 4]).min(-1)
    st["library_ms"] = cuda_ms(library, reps=3)
    st["library"] = "torch.cdist + min, 4 lanes a call"
    pairs = float((qm.sum(-1).double() * tm.sum(-1).double()).sum())
    flops_ms = 8 * pairs / H100_FP32_FLOPS * 1e3
    nbytes = q.numel() * 4 + qm.numel() + t.numel() * 4 + tm.numel() + qm.numel() * 12
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    st.update(valid_pairs=pairs, bound_ms=max(flops_ms, bytes_ms), bytes_ms=bytes_ms,
              bound_by="operations" if flops_ms >= bytes_ms else "bytes")
    return st


def sorted_farm(arrays, voxel=0.3, yaw_deg=8.0, seed=31):
    """The farm's point order on a cloud: targets and queries each sorted by
    their voxel key, x first (as the submap and the source scan come from
    ``voxel_downsample_representative_capped``), the queries then turned by
    ``yaw_deg`` about the lanes' centre (an ICP pose estimate's yaw)."""
    q, qm, t, tm = arrays
    rng = np.random.default_rng(seed)

    def key_order(p):
        v = np.floor(p / voxel).astype(np.int64)
        return np.lexsort((v[..., 2], v[..., 1], v[..., 0]))

    for b in range(q.shape[0]):
        o = key_order(t[b])
        t[b], tm[b] = t[b, o], tm[b, o]
        o = key_order(q[b])
        q[b], qm[b] = q[b, o], qm[b, o]
    a = np.deg2rad(yaw_deg) * rng.uniform(-1, 1, q.shape[0])
    c = q.mean(1, keepdims=True)
    x, y = q[..., 0] - c[..., 0], q[..., 1] - c[..., 1]
    q[..., 0] = c[..., 0] + np.cos(a)[:, None] * x - np.sin(a)[:, None] * y
    q[..., 1] = c[..., 1] + np.sin(a)[:, None] * x + np.cos(a)[:, None] * y
    return q, qm, t, tm


def nn_cases(dev):
    """Phase 2, K5b: ``nn_sqdist_argmin`` through its kernel against the
    plain version on the card (``compare_nn``): masked lanes, a km offset,
    duplicated targets (the lowest index must win), a lane without a valid
    target (index 0, 1e30), no valid query, the nearest target duplicated
    across a target-split boundary, ragged sizes, one lane without a lane
    axis, and the ICP farm's largest shape (32 lanes x 4 096 x 32 768) on a
    random cloud and in the farm's voxel order (``sorted_farm``), both
    timed."""
    import torch

    from ltm_torch.kernels import nn_argmin
    from ltm_torch.kernels.knn import nn_sqdist_argmin

    rng = np.random.default_rng(23)

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def cloud(lanes, n, m, offset=0.0, extent=20.0):
        t = (rng.uniform(-extent, extent, (lanes, m, 3)) + offset).astype(np.float32)
        q = (t[:, rng.integers(0, m, n)] + rng.normal(scale=0.05, size=(lanes, n, 3)))
        return q.astype(np.float32), rng.uniform(size=(lanes, n)) > 0.1, t, \
            rng.uniform(size=(lanes, m)) > 0.2

    cases = [("masked", cloud(3, 1800, 3000)), ("km_offset", cloud(3, 1800, 3000, 1000.0))]
    q, qm, t, tm = cloud(4, 700, 2000)
    t[:, 1::2] = t[:, 0::2]                      # every target twice: the first must win
    cases.append(("duplicates", (q, qm, t, np.ones_like(tm))))
    q, qm, t, tm = cloud(3, 500, 1500)
    tm[1] = False
    cases.append(("lane_without_target", (q, qm, t, tm)))
    cases.append(("no_valid_query", (q, np.zeros_like(qm), t, np.ones_like(tm))))
    q, qm, t, tm = cloud(2, 64, 200_000)
    tm[:] = True
    _, chunk = nn_argmin._device_plan(dev, 2, 64, 200_000)
    t[:, [chunk - 1, chunk]] = q[:, :1]          # the nearest at both sides of a split boundary
    cases.append(("split_boundary", (q, qm, t, tm)))
    cases.append(("ragged", cloud(5, 3 * nn_argmin._R * nn_argmin._THREADS + 17, 4096 + 3)))
    q, qm, t, tm = cloud(1, 2000, 5000)
    cases.append(("no_lane_axis", (q[0], qm[0], t[0], tm[0])))
    cases.append(("farm_largest", cloud(32, 4096, 32768, 50.0, 60.0)))
    cases.append(("farm_sorted", sorted_farm(cloud(32, 4096, 32768, 50.0, 60.0))))
    out = []
    for name, arrays in cases:
        args = on_card(*arrays)
        st = compare_nn(name, args, {"tile": 4096}, timed=name.startswith("farm_"))
        got_d, got_i = (x.cpu().numpy() for x in nn_sqdist_argmin(*args, tile=4096))
        if name == "duplicates" and (np.any(got_i % 2) or st["near_ties"]):
            raise AssertionError("duplicated targets: the lowest index must win")
        if name == "lane_without_target" and (np.any(got_i[1] != 0) or np.any(got_d[1] != 1e30)):
            raise AssertionError("a lane without a valid target: index 0 and 1e30")
        if name == "no_valid_query" and not np.all(got_d == np.float32(1e30)):
            raise AssertionError("invalid queries: 1e30")
        if name == "split_boundary" and not np.all(got_i[:, 0] == chunk - 1):
            raise AssertionError("a nearest target on both sides of a split: the first must win")
        log(f"[2] nn_sqdist_argmin {json.dumps(st)}")
        out.append(st)
    set_nn_counts()
    return out


# ---- K5a, the block-tridiagonal sweeps -----------------------------------------

# LTSlam's chain layout at phase 8's width (1 026 variables: two anchors, then
# 512 node slots a session, each session's first node pinned, 500 nodes used;
# slam/pipeline.py:199-214): phase 2's cases take it, phase 8 records the real one
SLAM_CHAIN_LENGTHS = (1, 1, 1, 499) + (1,) * 12 + (1, 499) + (1,) * 12


def tridiag_rule(got, plain, inputs):
    """``kernels.tridiag.card_rule`` on a factor's ``Cinv`` (6×6 blocks) or
    a solve's x (rows of 6): (the kernel's largest block error, the plain
    float32 route's, the kernel's largest absolute error); raises past the
    limit."""
    from ltm_torch.kernels.tridiag import card_rule

    return card_rule(got, plain, inputs, 2 if plain in (factor_out, factor_p) else 1)


def factor_out(D, L, pos):
    from ltm_torch.kernels.tridiag import tridiag_factor_plain

    return tridiag_factor_plain(D, L, pos)[0]


def factor_p(D, L, pos):
    from ltm_torch.kernels.tridiag import tridiag_factor_plain

    return tridiag_factor_plain(D, L, pos)[2]


def apply_out(Cinv, Lc, pos, r):
    from ltm_torch.kernels.tridiag import tridiag_apply_plain

    return tridiag_apply_plain(Cinv, Lc, pos, r)


def tridiag_counts():
    from ltm_torch.kernels import tridiag

    return tridiag.tridiag_factor.launches, tridiag.tridiag_apply.launches


def set_tridiag_counts(values=(0, 0)):
    from ltm_torch.kernels import tridiag

    tridiag.tridiag_factor.launches, tridiag.tridiag_apply.launches = values


def captured(fn):
    """The outputs of ``fn()`` (a tuple of tensors) from one replay of a
    CUDA graph that captured it (``capture``)."""
    return tuple(t.clone() for t in capture(fn)[1])


def tridiag_bound(which, args):
    """(bound_ms, bound_by) of one K5a call: the larger of its bytes at the
    HBM rate and its operations at the FP64 peak (both kernels compute in
    double for either input type), over the valid variables alone (a
    variable's blocks, row of ``r`` and entry of ``pos``; not the
    chain-major padding past a chain's end, which the function need not
    produce and the solve does not read).  The factor reads D and L and
    writes Cinv, Lc and P, five blocks a variable (two 6x6 products and an
    inverse, ~1 296 flops); the solve reads Cinv and P and writes x, a lane
    reading r (four 6x6 mat-vecs, 288 flops, a block a lane).  A
    throughput bound: the chains' dependent steps, not bytes or flops,
    bound these kernels (``ms_per_dependent_step`` against the
    register-only step floors)."""
    if which == "factor":
        D, L, pos = args
        V = D.shape[0]
        ops = 1296.0 * V
        nbytes = 5 * V * 36 * D.element_size() + V * 8
    else:
        Cinv, Lc, pos, r = args
        V = r.shape[-2]
        lanes = r.numel() // (V * 6)
        ops = 288.0 * lanes * V
        nbytes = (2 * V * 36 + 2 * r.numel()) * r.element_size() + V * 8
    t_ops, t_bytes = ops / H100_FP64_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def p64_solve(D, L, pos, r):
    """The float32 route's solve as it would run on a float64 P: the
    factor and the solve launched in float64 on the float32 inputs cast up,
    Cinv rounded to float32 and x rounded to float32.  Both kernels compute
    in double from their inputs cast up and round once at each store, so
    these are the bits a float32 solve staging a float64 P would give.
    (Cinv as float32, x): the caller checks that this Cinv is the float32
    factor's.  Counts restored."""
    from ltm_torch.kernels.tridiag import tridiag_apply, tridiag_factor

    saved = tridiag_counts()
    try:
        C64, _, P64 = tridiag_factor(D.double(), L.double(), pos)
        C32 = C64.float()
        return C32, tridiag_apply(C32.double(), P64, pos, r.double()).float()
    finally:
        set_tridiag_counts(saved)


def p64_trial(D, L, pos, r, Cinv, Lc):
    """The float64-P trial on one float32 solve call: the solve's block
    error under the card rule with P kept in double (``p64_solve``), its
    share of the rule's limit, and whether the trial's float32 Cinv is the
    float32 factor's ``Cinv`` bit for bit (the premise of ``p64_solve``)."""
    import torch

    from ltm_torch.kernels.tridiag import RULE_FLOOR, blockwise_rel_err

    C32, x = p64_solve(D, L, pos, r)
    ref = apply_out(Cinv.double(), Lc.double(), pos, r.double())
    p32 = apply_out(Cinv.float(), Lc.float(), pos, r.float())
    rel, plain_rel = blockwise_rel_err(x, ref, 1), blockwise_rel_err(p32, ref, 1)
    return {"max_rel_err": rel, "share_of_limit": rel / max(2 * plain_rel, RULE_FLOOR),
            "cinv_equal": torch.equal(C32, Cinv)}


def compare_tridiag(name, D, L, pos, r, timed=False):
    """K5a on one system: the factor and the solve through their kernels,
    each launched twice (the same bits), captured in a CUDA graph (the
    eager bits), held to the plain version under ``tridiag_rule`` (the
    factor's ``Cinv`` and ``P``; the solve, which reads ``Cinv`` and ``P``,
    against the plain solve on ``Cinv`` and ``Lc``), the kernel's ``Lc``
    bit-equal to the plain gather.  With ``timed``, for each: ms by CUDA
    events (median of 5), a call's ms in a CUDA graph (``graph_replay_ms``:
    50 calls; the plain version's, whose graph is thousands of nodes a
    call, 2 calls), the plain version's ms (once), the throughput bound,
    the longest chain, the device ms a dependent step (graph ms over
    max_len, or 2 max_len for the solve) and the dependent-step floor: its
    steps at the ms a step of the same recurrence with every operand in
    registers (``step_floor``, ``factor_step_floor``); for float32, the
    float64-P trial (``p64_trial``, ``p64_times``).  The launch counts are
    restored."""
    import torch

    from ltm_torch.kernels.tridiag import (tridiag_apply, tridiag_apply_plain, tridiag_factor,
                                          tridiag_factor_plain)

    saved = tridiag_counts()
    try:
        Cinv, Lc, P = tridiag_factor(D, L, pos)
        C2, L2, P2 = tridiag_factor(D, L, pos)
        x = tridiag_apply(Cinv, P, pos, r)
        x2 = tridiag_apply(Cinv, P, pos, r)
        Cg, Lg, Pg, xg = captured(lambda: (*tridiag_factor(D, L, pos),
                                           tridiag_apply(Cinv, P, pos, r)))
        repeat = int((C2 != Cinv).sum() + (L2 != Lc).sum() + (P2 != P).sum() + (x2 != x).sum())
        graph = int((Cg != Cinv).sum() + (Lg != Lc).sum() + (Pg != P).sum() + (xg != x).sum())
        lc_differ = int((Lc != tridiag_factor_plain(D, L, pos)[1]).sum())
        if repeat or graph or lc_differ:
            raise AssertionError(f"K5a {name}: {repeat} entries apart between launches, {graph} "
                                 f"between a captured and an eager call, {lc_differ} in Lc")
        V = D.shape[0]
        f_rel, f_plain, f_abs = tridiag_rule(Cinv, factor_out, (D, L, pos))
        p_rel, p_plain, _ = tridiag_rule(P, factor_p, (D, L, pos))
        a_rel, a_plain, a_abs = tridiag_rule(x, apply_out, (Cinv, Lc, pos, r))
        steps = int((pos < V).sum(1).max())        # the longest chain
        st = {"case": name, "dtype": str(D.dtype).split(".")[-1], "variables": V,
              "n_chains": pos.shape[0], "max_len": steps, "lanes": list(r.shape[:-2]),
              "factor": {"max_rel_err": f_rel, "plain_f32_rel_err": f_plain, "max_abs_err": f_abs,
                         "P_max_rel_err": p_rel, "P_plain_f32_rel_err": p_plain},
              "apply": {"max_rel_err": a_rel, "plain_f32_rel_err": a_plain, "max_abs_err": a_abs},
              "repeat_differ": repeat, "captured_differ": graph}
        if timed:
            calls = {"factor": ((D, L, pos), (D, L, pos), tridiag_factor, tridiag_factor_plain,
                                steps),
                     "apply": ((Cinv, P, pos, r), (Cinv, Lc, pos, r), tridiag_apply,
                               tridiag_apply_plain, 2 * steps)}
            for which, (args, plain_args, kernel, plain, dependent) in calls.items():
                graph_ms = graph_replay_ms(lambda: kernel(*args))
                bound_ms, bound_by = tridiag_bound(which, plain_args)
                st[which].update(
                    ms=cuda_ms(lambda: kernel(*args), reps=5),
                    graph_replay_ms=graph_ms,
                    plain_ms=cuda_ms(lambda: plain(*plain_args), reps=1),
                    plain_graph_replay_ms=graph_replay_ms(lambda: plain(*plain_args), calls=2,
                                                          reps=1),
                    bound_ms=bound_ms, bound_by=bound_by, dependent_steps=dependent,
                    ms_per_dependent_step=graph_ms / dependent)
            floor, f_floor = step_floor(), factor_step_floor()
            st["apply"].update(step_floor_ms=floor,
                               dependent_step_floor_ms=floor * 2 * steps)
            st["factor"].update(step_floor_ms=f_floor, dependent_step_floor_ms=f_floor * steps)
            if D.dtype == torch.float32:
                st["apply"]["p64"] = {**p64_trial(D, L, pos, r, Cinv, Lc),
                                      **p64_times(D, L, pos, r, Cinv, P)}
            torch.cuda.synchronize()
    finally:
        set_tridiag_counts(saved)
    return st


def step_floor(steps=100_000):
    """ms a dependent step of the solve's recurrence with every operand in
    registers (``kernels.tridiag.step_floor_ms``: one launch of ``steps``
    steps, the median of 3)."""
    from ltm_torch.kernels.tridiag import step_floor_ms

    return statistics.median(step_floor_ms(steps, "cuda") for _ in range(3)) / steps


def factor_step_floor(steps=20_000):
    """ms a dependent step of the factor's recurrence with every operand in
    registers (``kernels.tridiag.factor_step_floor_ms``: one launch of
    ``steps`` steps, the median of 3)."""
    from ltm_torch.kernels.tridiag import factor_step_floor_ms

    return statistics.median(factor_step_floor_ms(steps, "cuda") for _ in range(3)) / steps


def p64_times(D, L, pos, r, Cinv, P, turns=2):
    """The float64-P trial's time: a solve call in a CUDA graph
    (``graph_replay_ms``) on float32 operands (the shipped route) and the
    same call in float64 (Cinv, P, r and x all double: more bytes staged
    than a float32 solve on a float64 P would move, so an upper bound on
    it), in turns (float32, float64, float64, float32, ...); the medians
    and every turn.  Counts restored."""
    from ltm_torch.kernels.tridiag import tridiag_apply, tridiag_factor

    saved = tridiag_counts()
    try:
        P64 = tridiag_factor(D.double(), L.double(), pos)[2]
        sides = {"float32": (Cinv, P, pos, r), "float64": (Cinv.double(), P64, pos, r.double())}
        order = [k for t in range(turns) for k in (("float32", "float64") if t % 2 == 0
                                                   else ("float64", "float32"))]
        got = {k: [] for k in sides}
        for k in order:
            got[k].append(graph_replay_ms(lambda: tridiag_apply(*sides[k])))
    finally:
        set_tridiag_counts(saved)
    return {"graph_replay_ms_float32": statistics.median(got["float32"]),
            "graph_replay_ms_float64": statistics.median(got["float64"]),
            "turns_ms": got}


def recip_check(dev, n=1 << 22):
    """The factor's reciprocal on the card (``kernels.tridiag.recip_probe``)
    over ``n`` doubles, random significands at exponents from -100 to 100
    and both signs: the largest relative error of ``rcp.approx.ftz.f64``'s
    seed against IEEE ``1 / x`` (float64 division on the card) and of the
    reciprocal after its Newton step, and the reciprocal's largest distance
    in ulps from ``1 / x`` and its share of equal results.  Raises if any
    reciprocal is more than one ulp from ``1 / x``."""
    import torch

    from ltm_torch.kernels.tridiag import recip_probe

    rng = np.random.default_rng(31)
    x = rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-100, 101, n) * rng.choice([-1.0, 1.0], n)
    x[:4] = (1.0, 2.0 - 2.0 ** -52, 1.0 + 2.0 ** -52, 1.5)
    xt = torch.from_numpy(x).to(dev)
    seed, y = recip_probe(xt)
    ref = 1.0 / xt
    ulps = (y.view(torch.int64) - ref.view(torch.int64)).abs()
    st = {"inputs": n,
          "seed_max_rel_err": float(((seed - ref) / ref).abs().max()),
          "max_rel_err": float(((y - ref) / ref).abs().max()),
          "max_ulps_from_ieee": int(ulps.max()),
          "share_equal_to_ieee": float((ulps == 0).double().mean())}
    st["seed_max_rel_err_log2"] = float(np.log2(st["seed_max_rel_err"]))
    log(f"[2] the factor's reciprocal: {json.dumps(st)}")
    if st["max_ulps_from_ieee"] > 1:
        raise AssertionError(f"the factor's reciprocal: {st['max_ulps_from_ieee']} ulps from 1/x")
    return st


def tridiag_cases(dev):
    """Phase 2, K5a: random SPD systems (``random_chain_system``) on LTSlam's
    chain layout at phase 8's width (30 chains, two of 499 variables, 28 of
    one), float32 and float64, with no lane, 4 lanes and 120 lanes (the
    marginals' 6·M lanes of 20 variables; timed in float32), and on ragged
    chains (1 to 300 variables), each through ``compare_tridiag``."""
    import torch

    from ltm_torch.kernels.tridiag import random_chain_system

    rng = np.random.default_rng(29)
    out = []
    for dtype in (torch.float32, torch.float64):
        for lanes in ((), (4,), (120,)):
            D, L, pos = random_chain_system(rng, SLAM_CHAIN_LENGTHS, dtype, dev)
            r = torch.from_numpy(rng.normal(size=lanes + (D.shape[0], 6))).to(dev, dtype)
            timed = dtype == torch.float32 and lanes == (120,)
            out.append(compare_tridiag(f"slam_layout_{len(lanes) and lanes[0]}_lanes", D, L, pos,
                                       r, timed=timed))
    D, L, pos = random_chain_system(rng, (1, 300, 2, 1, 57, 140, 1, 33), torch.float32, dev)
    r = torch.from_numpy(rng.normal(size=(4, D.shape[0], 6))).to(dev, torch.float32)
    out.append(compare_tridiag("ragged_4_lanes", D, L, pos, r))
    for st in out:
        log(f"[2] tridiag (K5a) {json.dumps(st)}")
    return out


class TridiagCheck:
    """Holds every eager call of the solver's sweeps in a run
    (``graph.solver``'s ``_tridiag_factor`` and ``_tridiag_apply``,
    through K5a) to the plain version under ``tridiag_rule`` as it happens
    (the factor's ``Cinv`` and ``P``, its ``Lc`` bit-equal to the plain
    gather; the solve's x), runs the float64-P trial (``p64_trial``) on
    each float32 solve call against the last factor's inputs, and keeps the
    largest call of each (the solve's by lanes) and the chain layout; a
    call inside a CUDA graph's capture is counted and runs unchecked (its
    replays are that captured launch).  The comparisons restore the
    launch counts."""

    def __init__(self):
        from ltm_torch.graph import solver

        self.mod = solver
        self.fns = {"factor": solver._tridiag_factor, "apply": solver._tridiag_apply}
        self.stats = {w: {"calls": 0, "checked": 0, "captured": 0, "max_rel_err": 0.0,
                          "plain_f32_rel_err": 0.0, "max_abs_err": 0.0, "worst_share_of_limit": 0.0}
                      for w in self.fns}
        self.stats["factor"].update(P_max_rel_err=0.0, P_plain_f32_rel_err=0.0,
                                    P_worst_share_of_limit=0.0)
        self.stats["apply"]["p64"] = {"calls": 0, "max_rel_err": 0.0, "worst_share_of_limit": 0.0,
                                      "cinv_differ_calls": 0}
        self.largest = {}
        self.layout = None
        self.factor_args = None
        solver._tridiag_factor = lambda D, L, ch: self._checked("factor", (D, L, ch))
        solver._tridiag_apply = lambda Cinv, Lc, P, ch, r: self._checked("apply",
                                                                          (Cinv, Lc, P, ch, r))

    def _checked(self, which, args):
        import torch

        from ltm_torch.kernels.tridiag import RULE_FLOOR

        out = self.fns[which](*args)
        st = self.stats[which]
        st["calls"] += 1
        if torch.cuda.is_current_stream_capturing():
            st["captured"] += 1
            return out
        pos = args[-2].pos if which == "apply" else args[2].pos
        plain_args = (args[0], args[1], pos, args[4]) if which == "apply" else (*args[:2], pos)
        got = out[0] if which == "factor" else out
        rel, plain_rel, abs_err = tridiag_rule(got, factor_out if which == "factor" else apply_out,
                                               plain_args)
        st["checked"] += 1
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        st["plain_f32_rel_err"] = max(st["plain_f32_rel_err"], plain_rel)
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        st["worst_share_of_limit"] = max(st["worst_share_of_limit"],
                                         rel / max(2 * plain_rel, RULE_FLOOR))
        if which == "factor":
            D, L = args[0], args[1]
            p_rel, p_plain, _ = tridiag_rule(out[2], factor_p, plain_args)
            st["P_max_rel_err"] = max(st["P_max_rel_err"], p_rel)
            st["P_plain_f32_rel_err"] = max(st["P_plain_f32_rel_err"], p_plain)
            st["P_worst_share_of_limit"] = max(st["P_worst_share_of_limit"],
                                               p_rel / max(2 * p_plain, RULE_FLOOR))
            lc = torch.cat([L, L.new_zeros((1, 6, 6))])[pos]
            if not torch.equal(out[1], lc):
                raise AssertionError(f"K5a factor: {int((out[1] != lc).sum())} entries of Lc "
                                     "apart from the plain gather")
            self.factor_args = (D, L, pos)
        elif args[0].dtype == torch.float32 and self.factor_args is not None:
            trial = p64_trial(*self.factor_args, args[4], args[0], args[1])
            t = st["p64"]
            t["calls"] += 1
            t["max_rel_err"] = max(t["max_rel_err"], trial["max_rel_err"])
            t["worst_share_of_limit"] = max(t["worst_share_of_limit"], trial["share_of_limit"])
            t["cinv_differ_calls"] += not trial["cinv_equal"]
        size = plain_args[-1].numel()
        if which not in self.largest or size > self.largest[which][-1].numel():
            self.largest[which] = tuple(a.clone() for a in plain_args)
        if self.layout is None:
            lengths = pos < (args[0].shape[0] if which == "factor" else plain_args[3].shape[-2])
            lengths = lengths.sum(1).cpu().numpy()
            self.layout = {"n_chains": int(pos.shape[0]), "max_len": int(pos.shape[1]),
                           "variables": int(lengths.sum()),
                           "lengths_min_p50_max": [int(lengths.min()), float(np.median(lengths)),
                                                   int(lengths.max())],
                           "chains_of_one": int((lengths == 1).sum()),
                           "chains_over_100": int((lengths > 100).sum())}
        return out

    def restore(self):
        self.mod._tridiag_factor, self.mod._tridiag_apply = self.fns["factor"], self.fns["apply"]


@contextlib.contextmanager
def plain_sweeps():
    """The solver's sweeps through their plain versions on the card (the
    route before K5a), for a same-card comparison."""
    from ltm_torch.graph import solver
    from ltm_torch.kernels.tridiag import tridiag_apply_plain, tridiag_factor_plain

    saved = solver._tridiag_factor, solver._tridiag_apply
    solver._tridiag_factor = lambda D, L, ch: tridiag_factor_plain(D, L, ch.pos)
    solver._tridiag_apply = lambda Cinv, Lc, P, ch, r: tridiag_apply_plain(Cinv, Lc, ch.pos, r)
    try:
        yield
    finally:
        solver._tridiag_factor, solver._tridiag_apply = saved


class PcgRecorder:
    """Keeps the arguments of the last one-device PCG of a run
    (``graph.solver._pcg``: the Gauss-Newton product, the right-hand side,
    the preconditioner's solve and the graph), to replay its iteration."""

    def __init__(self):
        from ltm_torch.graph import solver

        self.mod, self.fn, self.args = solver, solver._pcg, None

        def recording(hvp, b, apply_prec, g, *rest, **kw):
            self.args = (hvp, b, apply_prec, g)
            return self.fn(hvp, b, apply_prec, g, *rest, **kw)
        solver._pcg = recording

    def restore(self):
        self.mod._pcg = self.fn


def pcg_iteration_profile(args, replays=20):
    """Device time of one graph-replayed PCG iteration by kernel: the
    recorded PCG (``PcgRecorder``) run for 1 + ``replays`` iterations (one
    eager, then the captured iteration replayed) and for 1, each under
    ``device_profile``, their difference over ``replays``; the wall a
    replayed iteration likewise (host clock, a sync at each end: the PCG's
    host read an iteration included).  The sweeps' share: the
    ``tridiag_apply`` kernel's device time over the iteration's."""
    import torch

    from ltm_torch.graph import solver

    hvp, b, apply_prec, g = args

    def run(iters):
        solver._pcg(hvp, b, apply_prec, g, iters, 0.0)

    def wall(iters):
        run(iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(iters)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1 + replays)
    st = {"replays": replays,
          "wall_ms_per_iteration": (wall(1 + replays) - wall(1)) * 1e3 / replays}
    one, many = device_profile(lambda: run(1), top=None), device_profile(lambda: run(1 + replays),
                                                                         top=None)
    per = {k: (v - one["top_device_ms"].get(k, 0.0)) / replays
           for k, v in many["top_device_ms"].items()}
    total = (many["device_busy_s"] - one["device_busy_s"]) * 1e3 / replays
    sweeps = sum(v for k, v in per.items() if "tridiag_apply" in k)
    st.update(device_ms_per_iteration=total, tridiag_apply_device_ms=sweeps,
              sweeps_share=sweeps / total if total > 0 else "not measured",
              top_device_ms=dict(sorted(per.items(), key=lambda kv: -kv[1])[:8]))
    return st


# ---- K5c, the solver's Gauss-Newton product ---------------------------------

def old_product(jac, plan, lam):
    """The Gauss-Newton product's route before K5c, on a product's plan
    (``kernels.gn_product.GnPlan``): ``torch.matmul`` a factor end for
    ``J v`` and for ``Jᵀ y`` (``J`` broadcast over the lanes), the per-end
    contributions concatenated, then one fixed-order scatter-sum and
    ``+ λ v`` (the solver's ``_hvp_from_jacobians`` as it was, for the
    comparisons)."""
    import torch

    from ltm_torch.kernels.scatter import fixed_order_sum

    idx = [i.long() for i in plan.idx]
    fixed = plan.fixed.bool()[:, None]

    def fj(J, v):
        return torch.matmul(J, v[..., None])[..., 0]

    def ftj(J, y):
        return torch.matmul(J.transpose(-1, -2), y[..., None])[..., 0]

    def hvp(v):
        vf = torch.where(fixed, 0.0, v)
        yp = fj(jac[0], vf[..., idx[0], :])
        yb = fj(jac[1], vf[..., idx[1], :]) + fj(jac[2], vf[..., idx[2], :])
        ya = torch.zeros(v.shape[:-2] + (jac[3].shape[0], 6), dtype=v.dtype, device=v.device)
        for k in range(3, 7):
            ya = ya + fj(jac[k], vf[..., idx[k], :])
        ys = (yp, yb, yb, ya, ya, ya, ya)
        ends = torch.cat([ftj(J, ys[k]) for k, J in enumerate(jac)], -2)
        return fixed_order_sum(ends, plan.ends) + lam * v

    return hvp


@contextlib.contextmanager
def old_gn_route():
    """The solver's Gauss-Newton products through ``old_product`` (the
    route before K5c), for a same-card comparison."""
    from ltm_torch.graph import solver

    saved = solver._hvp_from_jacobians
    solver._hvp_from_jacobians = lambda jac, g, lam: old_product(
        tuple(jac), solver._scatters(g).product, lam)
    try:
        yield
    finally:
        solver._hvp_from_jacobians = saved


def graph_shape(g):
    """A pose graph's factor counts: capacities and valid factors a family,
    factor ends, valid ends, variables, fixed variables, the largest row
    degree of the Gauss-Newton product's scatter plan."""
    from ltm_torch.graph import solver

    h = g.host
    plan = solver._scatters(g).ends
    deg = (plan.rowptr[1:] - plan.rowptr[:-1]).cpu().numpy()
    st = {"variables": g.num_vars, "fixed": int(h["fixed"].sum())}
    for fam in ("prior", "bet", "anc"):
        st[fam] = [int(h[f"{fam}_valid"].shape[0]), int(h[f"{fam}_valid"].sum())]
    st["ends"] = st["prior"][0] + 2 * st["bet"][0] + 4 * st["anc"][0]
    st["valid_ends"] = st["prior"][1] + 2 * st["bet"][1] + 4 * st["anc"][1]
    st["max_degree"], st["rows_of_degree_0"] = int(deg.max()), int((deg == 0).sum())
    return st


class MarginalsProbe:
    """Measures each call of LT-SLAM's ``marginal_covariance`` in a run (the
    RS loops' marginals, ``slam/pipeline.py``) by parts (``measure``); keeps
    the last call's arguments (``marginals_turns``)."""

    def __init__(self):
        import importlib

        self.pipeline = importlib.import_module("ltm_torch.slam.pipeline")
        self.fn = self.pipeline.marginal_covariance
        self.calls, self.args, self.pcg_args = [], None, None

        def probed(g, poses, var_indices, *rest, **kw):
            self.args = (g, poses, var_indices)
            out, st = self.measure(self.fn, g, poses, var_indices, *rest, **kw)
            self.calls.append(st)
            return out

        self.pipeline.marginal_covariance = probed

    def measure(self, fn, g, poses, var_indices, *rest, **kw):
        """``fn(g, poses, var_indices, ...)`` (a ``marginal_covariance``)
        and its parts: M and the lanes, the iterations each lane ran (max,
        median, min) and the lanes that reached the tolerance, the call's
        wall (a sync at each end) split into the set-up (Jacobians, the
        preconditioner's factor, the right-hand sides), the PCG's first eager
        iteration with its host read, the graph's capture, the replays (with
        their host reads) and what follows, the call's peak memory above its
        inputs, the graph's shape.  ``pcg_args`` keeps its PCG's arguments
        (``pcg_iteration_profile``)."""
        import torch

        from ltm_torch.graph import solver

        stamps, stats, real_pcg, real_graph = {}, {}, solver._pcg, torch.cuda.CUDAGraph
        replays = [0]

        def pcg(hvp, b, apply_prec, g, iters, tol, *rest, **kw):
            self.pcg_args = (hvp, b, apply_prec, g)
            stamps["pcg_start"] = time.perf_counter()
            x, res = real_pcg(hvp, b, apply_prec, g, iters, tol, *rest, stats=stats, **kw)
            stamps["pcg_end"] = time.perf_counter()
            stats.update(residual=res, tol=tol)
            return x, res

        def stamped_graph():
            graph = real_graph()
            stamps["graph_made"] = time.perf_counter()   # the first iteration's read is done
            replay = graph.replay

            def stamped():
                stamps.setdefault("first_replay", time.perf_counter())   # captured
                replays[0] += 1
                replay()
            graph.replay = stamped
            return graph

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        solver._pcg, torch.cuda.CUDAGraph = pcg, stamped_graph
        t0 = time.perf_counter()
        try:
            out = fn(g, poses, var_indices, *rest, **kw)
            torch.cuda.synchronize()
        finally:
            solver._pcg, torch.cuda.CUDAGraph = real_pcg, real_graph
        t1 = time.perf_counter()
        it = stats["iterations"].cpu().numpy()
        made, first = stamps.get("graph_made", t1), stamps.get("first_replay", t1)
        return out, {
            "M": len(var_indices), "lanes": 6 * len(var_indices),
            "iterations_max": int(it.max()), "iterations_median": float(np.median(it)),
            "iterations_min": int(it.min()),
            "lanes_reached_tol": int((stats["residual"] <= stats["tol"]).sum()),
            "wall_s": t1 - t0, "setup_s": stamps["pcg_start"] - t0,
            "first_eager_iteration_s": made - stamps["pcg_start"], "capture_s": first - made,
            "replays": replays[0], "replays_s": stamps["pcg_end"] - first,
            "after_pcg_s": t1 - stamps["pcg_end"],
            "peak_above_inputs_bytes": torch.cuda.max_memory_allocated() - base,
            "graph": graph_shape(g)}

    def restore(self):
        self.pipeline.marginal_covariance = self.fn


def marginals_turns(probe, order=("old", "kernel", "kernel", "old")):
    """The probe's last ``marginal_covariance`` call run again through each
    route in turns ("old": ``old_gn_route``, the product's route before
    K5c; "kernel": the solver as it is, K5c), each measured by parts
    (``MarginalsProbe.measure``); the largest difference between the
    routes' results over their largest entry; a graph-replayed PCG
    iteration of each route by kernel (``pcg_iteration_profile``, 5
    replays; every lane runs)."""
    from ltm_torch.graph import solver

    g, poses, var = probe.args
    turns, results, pcgs = [], {}, {}
    for route in order:
        with old_gn_route() if route == "old" else contextlib.nullcontext():
            out, st = probe.measure(solver.marginal_covariance, g, poses, var)
        pcgs.setdefault(route, probe.pcg_args)
        results.setdefault(route, out)
        st.pop("graph")
        turns.append(dict(route=route, **st))
    st = {"order": list(order), "turns": turns,
          "wall_s": {r: [t["wall_s"] for t in turns if t["route"] == r] for r in results},
          "pcg_iteration_profile": {}}
    if len(results) == 2:
        a, b = results.values()
        st["max_abs_diff_over_max"] = float((a - b).abs().max() / b.abs().max())
    for route, args in pcgs.items():        # each PCG's product is its route's
        st["pcg_iteration_profile"][route] = pcg_iteration_profile(args, replays=5)
    return st


def gn_counts():
    from ltm_torch.kernels import gn_product

    return gn_product.gn_product.launches


def set_gn_counts(value=0):
    from ltm_torch.kernels import gn_product

    gn_product.gn_product.launches = value


def gn_bound(jac, plan, v):
    """(bound_ms, bound_by, contract_floor_ms) of one Gauss-Newton product:
    the larger of its operations at the FP32 (FP64) peak, 144 a valid
    factor end and lane (72 for ``J v``, 72 for ``Jᵀ y``), and its bytes at
    the HBM rate: each valid end's block and index and plan entry, ``v`` and
    the output once, the plan's row pointers and the fixed flags; and the
    least ms under the kernel's own contract (every product and sum
    rounded, no FMA, no tensor cores): each operation one instruction, so
    the operations at half the FMA-counted peak.  Invalid factors (zero
    blocks, left out of the plan) count for nothing."""
    import torch

    ends = int(plan.ends.cols.shape[0])
    size = v.element_size()
    V = v.shape[-2]
    ops = 144.0 * ends * (v.numel() // (6 * V))
    nbytes = ends * (36 * size + 8) + 2 * v.numel() * size + 4 * (V + 1) + V
    rate = H100_FP32_FLOPS if v.dtype == torch.float32 else H100_FP64_FLOPS
    t_ops, t_bytes = ops / rate, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * ops / (rate / 2))


def gn_device_ms(fn, call_ms, calls=20):
    """Device ms a call of ``fn`` by kernel: one replay of a CUDA graph of
    ``calls`` calls (``capture``, as the PCG pays them) under
    ``device_profile``, over ``calls``.  The kernels of a call sum to about
    its ``call_ms`` in a graph, or past it where they overlap (the rows pass
    starts before the factors pass ends); a sum under nine tenths of it
    means the profiler lost kernels, as it did late in a full run, and
    reads "not measured"."""
    graph, _ = capture(fn, calls)
    prof = device_profile(graph.replay, top=None)
    per = {k: v / calls for k, v in prof["top_device_ms"].items()}
    return per if sum(per.values()) >= 0.9 * call_ms else "not measured"


def compare_gn(name, jac, plan, v, lam, timed=False):
    """K5c on one product: the kernel twice (the same bits) and captured in
    a CUDA graph (the eager bits), held to ``gn_product_plain`` on the same
    inputs bit for bit.  With ``timed``: the kernel's ms by CUDA events
    (median of 5, the wrapper's host work included), a call's ms in a CUDA
    graph (``graph_replay_ms``), each kernel's device ms (``gn_device_ms``),
    the plain version's ms (once), the route before K5c (``old_product``)
    eager and in a graph, the bound and the contract floor (``gn_bound``)
    and the peak memory above the inputs of a call of each route.  The
    launch count is restored."""
    import torch

    from ltm_torch.kernels.gn_product import gn_product, gn_product_plain

    saved = gn_counts()
    scratch = {}
    try:
        got = gn_product(jac, plan, v, lam, scratch)
        again = gn_product(jac, plan, v, lam, scratch)
        graphed = captured(lambda: (gn_product(jac, plan, v, lam, scratch),))[0]
        plain = gn_product_plain(jac, plan, v, lam)
        torch.cuda.synchronize()
        differ, repeat = int((got != plain).sum()), int((got != again).sum())
        graph = int((graphed != got).sum())
        err = float((got.double() - plain.double()).abs().max())
        if differ or repeat or graph:
            raise AssertionError(f"K5c {name}: {differ} entries differ from the plain version "
                                 f"(largest {err}), {repeat} between launches, {graph} between "
                                 "a captured and an eager call")
        lanes = v.numel() // (6 * v.shape[-2])
        st = {"case": name, "dtype": str(v.dtype).split(".")[-1], "lanes": lanes,
              "variables": v.shape[-2],
              "factors": [plan.idx[0].shape[0], plan.idx[1].shape[0], plan.idx[3].shape[0]],
              "ends": sum(i.shape[0] for i in plan.idx), "valid_ends": int(plan.ends.cols.shape[0]),
              "max_degree": plan.ends.table.shape[1], "differ": differ, "repeat_differ": repeat,
              "captured_differ": graph, "max_abs_err": err}
        if timed:
            old = old_product(jac, plan, lam)
            kernel = lambda: gn_product(jac, plan, v, lam, scratch)     # noqa: E731
            bound_ms, bound_by, floor_ms = gn_bound(jac, plan, v)

            def peak(fn):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                return torch.cuda.max_memory_allocated() - base

            st.update(ms=cuda_ms(kernel, reps=5), graph_replay_ms=graph_replay_ms(kernel))
            st.update(plain_ms=cuda_ms(lambda: gn_product_plain(jac, plan, v, lam), reps=1),
                      old_route_ms=cuda_ms(lambda: old(v), reps=5),
                      old_route_graph_replay_ms=graph_replay_ms(lambda: old(v), calls=5),
                      bound_ms=bound_ms, bound_by=bound_by,
                      contract_floor_ms=floor_ms,
                      device_ms=gn_device_ms(kernel, st["graph_replay_ms"]),
                      peak_above_inputs_bytes=peak(kernel),
                      old_route_peak_above_inputs_bytes=peak(lambda: old(v)),
                      scratch_bytes=gn_scratch_bytes(scratch))
    finally:
        set_gn_counts(saved)
    return st


def gn_scratch_bytes(scratch):
    """The bytes of the tensors a ``gn_product`` scratch dict holds."""
    import torch

    def size(t):
        if torch.is_tensor(t):
            return t.numel() * t.element_size()
        return sum(size(x) for x in t) if isinstance(t, (tuple, list)) else 0

    return sum(size(t) for t in scratch.values())


# phase 8's pose graph as the RS run's marginals see it (the probe's log,
# PERF.md §5): variables, (priors, between factors, anchored factors) and
# how many of each are valid, the marginals' lanes (6 M, M = 127)
SLAM_GRAPH = dict(n_vars=1026, n_fac=(4, 24812, 1016), valid=(1, 24804, 489), marginal_lanes=762)


# the heavy-row cases of gn_cases (tests/test_torch_gn_product.py's
# _RANDOM): (P, B, A) on 40 variables, every anchored factor valid, and the
# anchored factors whose anchors coincide; the anchor rows take A - c and
# A + c ends: at the heavy threshold (64), one either side, over two chunks
GN_HEAVY_CASES = {"threshold": ((3, 45, 64), 0), "threshold_pm1": ((3, 45, 64), 1),
                  "long_row": ((3, 45, 1524), 0)}


def gn_cases(dev):
    """Phase 2, K5c: random graphs (``kernels.gn_product.random_gn_case``) of
    phase 8's shape (``SLAM_GRAPH``) at 1, 4, 120 lanes, either side of the
    routes' threshold (``_WIDE`` - 1 and ``_WIDE``) and at the RS
    marginals' lanes (timed at 1 and at the marginals' lanes); small graphs
    with invalid factors, fixed variables, a row of degree 0 and anchored
    factors whose anchors coincide, at 1, 2, 3 and 7 lanes, float32 and
    float64; and small graphs whose anchor rows sit at the rows kernel's
    heavy threshold, one either side of it, and over two of a heavy row's
    chunks (``GN_HEAVY_CASES``) at 1, 4 and the marginals' lanes in float32
    and at 4 and 40 lanes in float64: each through ``compare_gn``."""
    import torch

    from ltm_torch.kernels.gn_product import _WIDE, random_gn_case

    rng = np.random.default_rng(43)
    out = []
    V, counts = SLAM_GRAPH["n_vars"], SLAM_GRAPH["n_fac"]
    valid = [v / max(n, 1) for v, n in zip(SLAM_GRAPH["valid"], counts)]
    for lanes in sorted({1, 4, _WIDE - 1, _WIDE, 120, SLAM_GRAPH["marginal_lanes"]}):
        case = random_gn_case(rng, V, counts, (lanes,), torch.float32, dev, valid=valid)
        out.append(compare_gn(f"slam_shape_{lanes}_lanes", *case,
                              timed=lanes in (1, SLAM_GRAPH["marginal_lanes"])))
    for dtype in (torch.float32, torch.float64):
        for lanes in ((), (2,), (3,), (7,)):
            case = random_gn_case(rng, 40, (3, 45, 30), lanes, dtype, dev, valid=0.7,
                                  coincide=5)
            out.append(compare_gn(f"edges_{len(lanes) and lanes[0]}_lanes", *case))
    for name, (fac, coincide) in GN_HEAVY_CASES.items():
        for lanes, dtype in (((), torch.float32), ((4,), torch.float32), ((4,), torch.float64),
                             ((40,), torch.float64), ((SLAM_GRAPH["marginal_lanes"],), torch.float32)):
            case = random_gn_case(rng, 40, fac, lanes, dtype, dev, valid=(0.9, 0.9, 1.0),
                                  coincide=coincide)
            out.append(compare_gn(f"{name}_{len(lanes) and lanes[0]}_lanes", *case))
    for st in out:
        log(f"[2] gn_product (K5c) {json.dumps(st)}")
    return out


def gn_shape_times(lanes=(1, SLAM_GRAPH["marginal_lanes"])):
    """K5c on phase 8's graph (``SLAM_GRAPH``'s random graph, float32) at
    each of ``lanes`` (by default the LM's one lane and the marginals'
    lanes) with whatever ``ltm_torch`` comes first on the path
    (``gn_turns`` and ``gn_crossover`` run it on two trees): held to the
    plain version bit for bit, a call's ms in a CUDA graph of 50
    (``graph_replay_ms``), eager (CUDA events, median of 5) and each
    kernel's device ms (``gn_device_ms``)."""
    import torch

    from ltm_torch.kernels import _build
    from ltm_torch.kernels.gn_product import gn_product, gn_product_plain, random_gn_case

    _build.build_all()
    dev = torch.device("cuda")
    V, counts = SLAM_GRAPH["n_vars"], SLAM_GRAPH["n_fac"]
    valid = [v / max(n, 1) for v, n in zip(SLAM_GRAPH["valid"], counts)]
    out = {}
    for n in lanes:
        jac, plan, v, lam = random_gn_case(np.random.default_rng(n), V, counts, (n,),
                                           torch.float32, dev, valid=valid)
        scratch = {}
        kernel = lambda: gn_product(jac, plan, v, lam, scratch)     # noqa: E731
        got = kernel()
        differ = int((got != gn_product_plain(jac, plan, v, lam)).sum())
        replay = graph_replay_ms(kernel)
        out[str(n)] = {"differ": differ, "graph_replay_ms": replay,
                       "ms": cuda_ms(kernel, reps=5), "device_ms": gn_device_ms(kernel, replay)}
    return out


def _gn_tree_turns(dirs, order, lanes, tag):
    """``gn_shape_times(lanes)`` on the trees ``dirs`` ({name: directory})
    in ``order``, each turn in a process of its own started in the tree's
    root, with this file's timing code: {name: [each turn's figures]}."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import importlib.util, json, os, sys; sys.path.insert(0, os.getcwd()); "
            f"spec = importlib.util.spec_from_file_location('smoke', {os.path.join(here, 'chip_smoke.py')!r}); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            f"print('GN_TURN ' + json.dumps(m.gn_shape_times({tuple(lanes)!r})))")
    turns = {}
    for tree in order:
        done = subprocess.run([sys.executable, "-c", code], cwd=os.path.abspath(dirs[tree]),
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in done.stdout.splitlines() if ln.startswith("GN_TURN ")]
        if done.returncode != 0 or not lines:
            raise RuntimeError(f"{tag} ({tree}): rc {done.returncode}\n{done.stderr[-4000:]}")
        turns.setdefault(tree, []).append(json.loads(lines[-1][len("GN_TURN "):]))
        log(f"[{tag}] {tree}: {lines[-1][len('GN_TURN '):]}")
    return turns


def gn_turns(parent):
    """``gn_shape_times`` at phase 8's two shapes on the parent (a directory
    holding another checkout, e.g. unpacked from ``git archive``) and on
    this tree, in turns: parent, change, change, parent."""
    here = os.path.dirname(os.path.abspath(__file__))
    return _gn_tree_turns({"parent": parent, "change": here},
                          ("parent", "change", "change", "parent"),
                          (1, SLAM_GRAPH["marginal_lanes"]), "gn_turns")


def gn_crossover(lanes=(4, 8, 12, 16, 24, 32, 64, 120), root="build/gn_crossover"):
    """Where K5c's two routes cross: this tree's ``ltm_torch`` copied twice
    under ``root``, with ``kWide`` (``csrc/gn_product.cu``) and ``_WIDE``
    (``kernels/gn_product.py``) set to 1 (every lane count takes the wide
    route) and to 1 << 20 (the narrow one), then ``gn_shape_times(lanes)``
    on the two copies in turns: narrow, wide, wide, narrow."""
    here = os.path.dirname(os.path.abspath(__file__))
    dirs = {}
    for route, wide in (("narrow", 1 << 20), ("wide", 1)):
        dst = os.path.join(here, root, route)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(here, "ltm_torch"), os.path.join(dst, "ltm_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for rel, pattern, new in (
                ("csrc/gn_product.cu", r"constexpr int kWide = \d+;", f"constexpr int kWide = {wide};"),
                ("kernels/gn_product.py", r"_THREADS, _WIDE, _HEAVY, _PER = 256, \d+, 64, 2",
                 f"_THREADS, _WIDE, _HEAVY, _PER = 256, {wide}, 64, 2")):
            path = os.path.join(dst, "ltm_torch", rel)
            text, n = re.subn(pattern, new, open(path).read())
            if n != 1:
                raise RuntimeError(f"gn_crossover: {rel} does not hold {pattern!r} once")
            with open(path, "w") as f:
                f.write(text)
        dirs[route] = dst
    return _gn_tree_turns(dirs, ("narrow", "wide", "wide", "narrow"), lanes, "gn_crossover")


class GnCheck:
    """Holds every eager call of the solver's Gauss-Newton product in a run
    (``graph.solver``'s ``gn_product``, K5c) to ``gn_product_plain`` on the
    same inputs bit for bit as it happens; a call inside a CUDA graph's
    capture is counted and runs unchecked (its replays are that captured
    launch).  Keeps the last one-lane call and the call with the most lanes
    (their inputs).  The comparisons launch nothing."""

    def __init__(self):
        from ltm_torch.graph import solver

        self.mod, self.fn = solver, solver.gn_product
        self.stats = {"calls": 0, "checked": 0, "captured": 0, "differ": 0, "max_abs_err": 0.0,
                      "lanes": {}}
        self.one_lane = self.widest = None
        solver.gn_product = self._checked

    def _checked(self, jac, plan, v, lam, scratch):
        import torch

        from ltm_torch.kernels.gn_product import gn_product_plain

        out = self.fn(jac, plan, v, lam, scratch)
        st = self.stats
        st["calls"] += 1
        if torch.cuda.is_current_stream_capturing():
            st["captured"] += 1
            return out
        plain = gn_product_plain(jac, plan, v, lam)
        differ = int((out != plain).sum())
        st["checked"] += 1
        st["differ"] += differ
        st["max_abs_err"] = max(st["max_abs_err"], float((out.double() - plain.double()).abs().max()))
        if differ:
            raise AssertionError(f"K5c call {st['calls']}: {differ} entries differ from the plain "
                                 "version")
        lanes = v.numel() // (6 * v.shape[-2])
        st["lanes"][str(lanes)] = st["lanes"].get(str(lanes), 0) + 1
        keep = (tuple(J.clone() for J in jac), plan, v.clone(), lam.clone())
        if lanes == 1:
            self.one_lane = keep
        if self.widest is None or lanes >= self.widest[2].numel() // (6 * v.shape[-2]):
            self.widest = keep
        return out

    def restore(self):
        self.mod.gn_product = self.fn


# ---- K2 and K3, the visibility sweeps --------------------------------------

SWEEP_FOV = (50.0, 360.0)
SWEEP_SCALE = float(2 ** 27) / 256.0
SWEEP_FUNCS = ("block_sweep_discrepancy", "block_sweep_discrepancy_vs_images",
               "block_sweep_discrepancy_vs_images_presel", "block_fused_visibility_images")
# Operations the pixel rule needs a point (sweep.cu): float64, the pose's 3
# rows (2 multiplies, 2 adds each), the two sums of squares, the two angles'
# degrees and offsets and the row (2 each), and two atan2 counted as 20
# each (a degree-~9 polynomial and its range reduction: an undercount,
# which keeps the bound a bound); float32, the pose's 6, the squares and
# roots 3, the row and column 6.  A scan point skips the pose.
SWEEP_FP64_POINT, SWEEP_FP32_POINT = 62, 15
SWEEP_FP64_SCAN, SWEEP_FP32_SCAN = 50, 9


def sweep_counts():
    """The launch sets of K2 and K3: (K2, K3) of the cluster variant, then
    (K2, K3) of the global variant."""
    from ltm_torch.kernels import sweep

    k2, k3 = sweep.discrepancy_sweep, sweep.winner_sweep
    return k2.launches, k3.launches, k2.global_launches, k3.global_launches


def set_sweep_counts(values=(0, 0, 0, 0)):
    from ltm_torch.kernels import sweep

    k2, k3 = sweep.discrepancy_sweep, sweep.winner_sweep
    k2.launches, k3.launches, k2.global_launches, k3.global_launches = values


def sweep_diff(name, got, want):
    """(entries that differ, largest absolute difference) between two
    results of a sweep on the card: masks as 0/1, images as their values;
    entries with the same bits count 0."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    differ, err = 0, 0.0
    for x, y in zip(got, want, strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}: {x.shape} {x.dtype} against {y.shape} {y.dtype}")
        ne = (x.view(torch.int32) != y.view(torch.int32)) if x.dtype == torch.float32 else x != y
        n = int(ne.sum())
        if n:
            differ += n
            err = max(err, float((x[ne].double() - y[ne].double()).abs().max()))
    return differ, err


def compare_sweep(name, fn, args, kwargs, launches=None):
    """``blocks.<fn>`` through its kernel on the card, a second launch on
    the same inputs, and ``blocks.<fn>_plain`` on them: every output the
    same bits.  ``launches``: the (K2, K3) launch sets the kernel call must
    make (the cluster variant's; four values, then the global variant's
    too; the variant not named must not launch).  The launch counts are
    restored.  Returns stats (with the entries
    that differ from plain and their largest absolute difference) and the
    result."""
    import torch

    from ltm_torch.kernels import blocks

    saved = sweep_counts()
    set_sweep_counts()
    try:
        got = getattr(blocks, fn)(*args, **kwargs)
        torch.cuda.synchronize()
        made = sweep_counts()
        again = getattr(blocks, fn)(*args, **kwargs)
        plain = getattr(blocks, fn + "_plain")(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        set_sweep_counts(saved)
    differ, err = sweep_diff(f"{name}, kernel against plain", got, plain)
    repeat, _ = sweep_diff(f"{name}, two launches", got, again)
    if differ or repeat:
        raise AssertionError(f"{name}: {differ} entries differ from the plain version (largest "
                             f"absolute difference {err}), {repeat} between two launches")
    want = None if launches is None else (tuple(launches) + (0, 0))[:4]
    if want is not None and made != want:
        raise AssertionError(f"{name}: (K2, K3, K2 global, K3 global) launch sets {made}, "
                             f"expected {want}")
    mask = got[0] if isinstance(got, tuple) else got
    st = {"case": name, "function": fn, "flagged": int(mask.sum()), "differ": differ,
          "max_abs_err": err, "repeat_differ": repeat, "k2_launches": made[0],
          "k3_launches": made[1], "k2_global_launches": made[2],
          "k3_global_launches": made[3]}
    return st, got


def rot_yaw_tilt(yaw, tilt):
    """A rotation: ``tilt`` about x, then ``yaw`` about z."""
    c, s = np.cos(yaw), np.sin(yaw)
    ct, st = np.cos(tilt), np.sin(tilt)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.array([[1, 0, 0], [0, ct, -st],
                                                                    [0, st, ct]])


def pixel_rule_points(rng, n, shape):
    """(n, 3) float32 points that reach the pixel rule's edges: azimuth
    ±180° (y = ±0 and ±1e-30 behind the sensor), elevations past the FOV
    (row clamps), azimuths and elevations on pixel edges (to float32
    rounding), points at range 0 and ranges past the packed clamp (the
    int32 cut), then random directions and ranges."""
    nrow, ncol = shape
    vfov, hfov = SWEEP_FOV
    q = n // 8
    r = rng.uniform(0.5, 120.0, n)
    az = np.radians(rng.uniform(-180.0, 180.0, n))
    el = np.radians(rng.uniform(-40.0, 40.0, n))           # past ±25°: row clamps
    c = rng.integers(0, ncol, q)
    az[:q] = np.radians((c + 0.5) * hfov / ncol - hfov / 2.0)                 # column edges
    rr = rng.integers(0, nrow, q)
    el[q:2 * q] = np.radians(vfov / 2.0 - (rr + 0.5) * vfov / nrow)           # row edges
    r[2 * q:2 * q + q // 4] = rng.uniform(256.0, 400.0, q // 4)               # packed clamp
    xyz = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)],
                   1).astype(np.float32)
    m = 3 * q
    xyz[m:m + 64, 0] = -rng.uniform(1.0, 50.0, 64).astype(np.float32)          # azimuth ±180°
    xyz[m:m + 64, 1] = np.tile(np.array([0.0, -0.0, 1e-30, -1e-30], np.float32), 16)
    xyz[m + 64:m + 72] = 0.0                                                  # range 0
    return xyz


def pixel_rule_case(dev):
    """The pixel rule of sweep.cu against ``projection.spherical_project``
    and ``_pack_points`` on ``apply_pose`` (the plain versions, on the
    card), on 2^20 edge-heavy points under the identity and 2^20 random
    points under a rotated pose: pixel ids, ranges, packed values and proj
    pixel ids, 0 differing."""
    import torch

    from ltm_torch.kernels import projection as tp
    from ltm_torch.kernels import sweep

    shape, proj = tp.rimg_shape(SWEEP_FOV, 2.5), tp.rimg_shape(SWEEP_FOV, 3.0)
    rng = np.random.default_rng(3)
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = rot_yaw_tilt(0.7, 0.05), [12.5, -3.25, 1.75]
    out = {}
    for tag, xyz, pinv in (
            ("identity", pixel_rule_points(rng, 1 << 20, shape), np.eye(4)),
            ("rotated", rng.uniform([-150, -150, -20], [150, 150, 20], (1 << 20, 3)),
             np.linalg.inv(pose))):
        x = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(dev)
        t = torch.from_numpy(pinv.astype(np.float32)).to(dev)
        pix, rng_k, packed, pix_p = sweep.pixel_rule(x, t, SWEEP_FOV, shape, proj, SWEEP_SCALE)
        local = tp.apply_pose(x, t)
        ppix, prng = tp.spherical_project(local, SWEEP_FOV, shape)
        ppacked, ppix_p = tp._pack_points(local, torch.ones_like(x[:, 0], dtype=torch.bool),
                                          SWEEP_FOV, proj, shape, SWEEP_SCALE)
        differ = {"pix": int((pix != ppix).sum()), "pix_p": int((pix_p != ppix_p).sum()),
                  "range": int((rng_k.view(torch.int32) != prng.view(torch.int32)).sum()),
                  "packed": int((packed != ppacked).sum())}
        azs = local[:, 1].double().atan2(local[:, 0].double()).cpu().numpy()
        col_f = (np.degrees(azs) + SWEEP_FOV[1] / 2) * shape[1] / SWEEP_FOV[1]
        out[tag] = {"points": int(x.shape[0]), "differ": differ,
                    "column_edges": int((np.abs(col_f - np.floor(col_f) - 0.5) < 1e-4).sum()),
                    "rows_clamped": int(((ppix // shape[1]) == 0).sum()
                                        + ((ppix // shape[1]) == shape[0] - 1).sum()),
                    "packed_negative": int((ppacked < 0).sum())}
        if any(differ.values()):
            raise AssertionError(f"pixel rule ({tag}): {differ} differ from the plain version")
    return out


def sweep_world(dev, n_map=400_000, K=12, S=30_000, seed=5):
    """A survey on the card for the sweep cases, from a NumPy seed: a
    400 000-point map (160 m x 160 m, 10 m cells of 256-slot blocks), 12
    keyframes with tilted, yawed poses (keyframe 0 unrotated, a map point at
    its origin: range 0), scans of 30 000 points (keyframe 1's all masked),
    a random target subset and, as source images, the other points' winner
    images (so the target lies in front of and behind them)."""
    import torch

    from ltm_torch.kernels import blocks
    from ltm_torch.kernels.projection import rimg_shape

    rng = np.random.default_rng(seed)
    xyz = rng.uniform([-80, -80, -3], [80, 80, 8], (n_map, 3)).astype(np.float32)
    poses = np.tile(np.eye(4), (K, 1, 1))
    for k in range(1, K):
        yaw, tilt = rng.uniform(0, 2 * np.pi), rng.normal(0, 0.03)
        poses[k, :3, :3] = rot_yaw_tilt(yaw, tilt)
    poses[:, :3, 3] = rng.uniform([-40, -40, 0], [40, 40, 2], (K, 3))
    poses = poses.astype(np.float32)
    xyz[0] = poses[0, :3, 3]
    mask = rng.uniform(size=n_map) > 0.05
    mask[0] = True
    pose_inv = np.linalg.inv(poses.astype(np.float64)).astype(np.float32)
    d = rng.normal(size=(K, S, 3))
    d[..., 2] *= 0.25
    scans = (d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(1, 90, (K, S, 1)))
    smask = rng.uniform(size=(K, S)) > 0.1
    smask[1] = False

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bm, ov, _ = blocks.build_block_map_with_slots(t(xyz), t(mask), 10.0, 4096, 256)
    if ov:
        raise AssertionError(f"sweep world: the block map overflowed ({ov})")
    shape, proj = rimg_shape(SWEEP_FOV, 2.5), rimg_shape(SWEEP_FOV, 3.0)
    kb = blocks.required_k_blocks(bm, poses[:, :3, 3], 60.0)
    if kb >= bm.num_blocks:
        raise AssertionError("sweep world: the range bound culls no block")
    extra = t(rng.uniform(size=bm.mask.numel()) > 0.3)
    pinv, pos = t(pose_inv), t(poses)
    _, imgs = blocks.block_fused_visibility_images_plain(bm, ~extra, pinv, pos, SWEEP_FOV, shape,
                                                         proj, k_blocks=bm.num_blocks,
                                                         max_range=400.0, scale=SWEEP_SCALE)
    return dict(bm=bm, pinv=pinv, poses=pos, scans=t(scans.astype(np.float32)), smask=t(smask),
                kb=kb, extra=extra, imgs=imgs, shape=shape, proj=proj)


def sweep_call(w, fn, K=None, k_blocks=None, max_range=60.0, reverse=False, sel=None):
    """(args, kwargs) of ``blocks.<fn>`` on the first K keyframes of a
    sweep world."""
    K = w["pinv"].shape[0] if K is None else K
    kb = w["kb"] if k_blocks is None else k_blocks
    bm, pinv, poses = w["bm"], w["pinv"][:K], w["poses"][:K]
    disc = dict(diff_threshold=0.1, reverse=reverse)
    if fn == "block_sweep_discrepancy":
        return ((bm, w["scans"][:K], w["smask"][:K], pinv, poses, SWEEP_FOV, w["shape"]),
                dict(disc, k_blocks=kb, max_range=max_range))
    if fn == "block_sweep_discrepancy_vs_images":
        return ((bm, w["extra"], w["imgs"][:K], pinv, poses, SWEEP_FOV, w["shape"]),
                dict(disc, k_blocks=kb, max_range=max_range))
    if fn == "block_sweep_discrepancy_vs_images_presel":
        return ((bm, w["extra"], w["imgs"][:K], pinv, sel[0][:K], sel[1][:K], SWEEP_FOV,
                 w["shape"]), disc)
    return ((bm, w["extra"], pinv, poses, SWEEP_FOV, w["shape"], w["proj"]),
            dict(k_blocks=kb, max_range=max_range, scale=SWEEP_SCALE))


def phase_sweep_cases(dev):
    """Phase 2, K2 and K3: the pixel rule on 2^21 points, then each of the
    four sweeps through its kernel against its plain version on the card,
    bit for bit, with a second launch equal to the first: both ``reverse``
    values, a ``presel`` list with padding entries, ``k_blocks ==
    n_blocks``, a point at range 0 (never flagged, winning its pixel), an
    all-masked keyframe, far-padded keyframes, K = 0 (nothing launched),
    keyframes forced into chunks, and at a finer resolution one case of
    each variant (global, and a cluster of 8); the cluster variant's peak
    device memory against its outputs; then the fixed-order scatter-sum's
    cases (``scatter_cases``).  Returns the cases' stats."""
    import torch

    from ltm_torch.dist.removert import _pad_poses_far
    from ltm_torch.kernels import blocks, sweep
    from ltm_torch.kernels.projection import NO_POINT, rimg_shape

    t0 = time.perf_counter()
    out = {"pixel_rule": pixel_rule_case(dev)}
    log(f"[2] sweep pixel rule: {json.dumps(out['pixel_rule'])}")
    w = sweep_world(dev)
    K, nb = w["pinv"].shape[0], w["bm"].num_blocks
    s, v = sweep.select_blocks(w["bm"], w["poses"][:, :3, 3], 60.0, w["kb"])
    presel = (torch.cat([s.flip(1), torch.zeros_like(s[:, :37])], 1),
              torch.cat([v.flip(1), torch.zeros_like(v[:, :37])], 1))
    fwd, vsi, pre, fus = SWEEP_FUNCS
    k2, k3 = (1, 0), (0, 1)
    cases = [(f"{fn.replace('block_', '')}_{'reverse' if r else 'forward'}", fn,
              dict(reverse=r), k2) for fn in (fwd, vsi, pre) for r in (False, True)]
    cases.append(("fused_visibility_images", fus, {}, k3))
    for fn, launch in ((fwd, k2), (vsi, k2), (fus, k3)):
        cases.append((f"{fn.replace('block_', '')}_all_blocks", fn,
                      dict(k_blocks=nb, max_range=400.0), launch))
    for fn in SWEEP_FUNCS:
        cases.append((f"{fn.replace('block_', '')}_no_keyframes", fn, dict(K=0), (0, 0)))
    stats = []
    for name, fn, kw, launch in cases:
        kw = dict(kw)
        if fn == pre:
            kw["sel"] = presel
            kw.pop("k_blocks", None)
        args, kwargs = sweep_call(w, fn, **kw)
        st, got = compare_sweep(name, fn, args, kwargs, launch)
        if kw.get("K") == 0:
            res = got if isinstance(got, tuple) else (got,)
            if res[0].shape != (w["bm"].mask.numel(),) or bool(res[0].any()):
                raise AssertionError(f"{name}: K = 0 must give an all-False mask")
            if len(res) > 1 and res[1].shape != (0, w["shape"][0] * w["shape"][1]):
                raise AssertionError(f"{name}: K = 0 must give (0, n_pix) images")
        elif st["flagged"] < 100:
            raise AssertionError(f"{name}: only {st['flagged']} points flagged")
        stats.append(st)
    # keyframes forced into chunks of 5: a launch set a chunk
    saved = sweep.MAX_KEYFRAMES
    sweep.MAX_KEYFRAMES = 5
    n = -(-K // 5)
    try:
        for fn, launch in ((fwd, (n, 0)), (vsi, (n, 0)), (fus, (0, n))):
            args, kwargs = sweep_call(w, fn)
            stats.append(compare_sweep(f"{fn.replace('block_', '')}_chunked", fn, args, kwargs,
                                       launch)[0])
    finally:
        sweep.MAX_KEYFRAMES = saved
    # far-padded keyframes (the mesh's padding): no block, nothing flagged
    pinv, poses = _pad_poses_far(w["pinv"], w["poses"], 16)
    pad = pinv.shape[0] - K
    wp = dict(w, pinv=pinv, poses=poses,
              scans=torch.cat([w["scans"], w["scans"].new_zeros((pad,) + w["scans"].shape[1:])]),
              smask=torch.cat([w["smask"], w["smask"].new_zeros((pad, w["smask"].shape[1]))]),
              imgs=torch.cat([w["imgs"], w["imgs"].new_full((pad, w["imgs"].shape[1]),
                                                            NO_POINT)]))
    for fn, launch in ((fwd, k2), (vsi, k2), (fus, k3)):
        args, kwargs = sweep_call(wp, fn)
        st, got = compare_sweep(f"{fn.replace('block_', '')}_far_padded", fn, args, kwargs,
                                launch)
        ref = compare_sweep("unpadded", fn, *sweep_call(w, fn), launch)[1]
        a, b = host_bits(got), host_bits(ref)
        if not np.array_equal(a[0], b[0]) or (len(a) > 1 and not (
                np.array_equal(a[1][:K], b[1])
                and (got[1][K:] == NO_POINT).all())):
            raise AssertionError(f"{fn} far-padded: the padding changed the result")
        stats.append(st)
    # a point at range 0 (keyframe 0's origin) under an image that flags
    # every pixel: never flagged, and it wins its proj pixel
    flat = w["bm"].xyz.reshape(-1, 3)
    slot = int(torch.nonzero((flat == w["poses"][0, :3, 3]).all(1)
                             & w["bm"].mask.reshape(-1))[0])
    w0 = dict(w, imgs=torch.full_like(w["imgs"], 50.0), extra=w["bm"].mask.reshape(-1))
    st, got = compare_sweep("range_zero", vsi, *sweep_call(w0, vsi, K=1), k2)
    win = compare_sweep("range_zero_winner", fus, *sweep_call(w0, fus, K=1), k3)[1][0]
    if bool(got[slot]) or not bool(win[slot]) or st["flagged"] < 100:
        raise AssertionError(f"range 0: flagged {bool(got[slot])}, wins {bool(win[slot])}")
    stats.append(st)
    # the cluster variant allocates its outputs and lists only: a call's
    # peak rise, less its outputs, stays under half of one image a keyframe
    out["device_memory"] = {}
    for fn in (fwd, vsi, fus):
        args, kwargs = sweep_call(w, fn)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = getattr(blocks, fn)(*args, **kwargs)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        outputs = sum(t.numel() * t.element_size()
                      for t in (res if isinstance(res, tuple) else (res,)))
        image = K * w["shape"][0] * w["shape"][1] * 4
        out["device_memory"][fn] = {"peak_rise_bytes": rise, "output_bytes": outputs,
                                    "one_image_a_keyframe_bytes": image}
        if rise - outputs >= image // 2:
            raise AssertionError(f"{fn}: the call's peak rose {rise} bytes for {outputs} "
                                 f"bytes of outputs: an image reached device memory")
        del res
    log(f"[2] sweep device memory: {json.dumps(out['device_memory'])}")
    # one case a variant past the default sizes: at a finer filter resolution
    # (250 x 1800, proj 300 x 2160) no cluster holds a forward sweep's two
    # images or K3's (the global variant); the vs-images image takes 8 CTAs
    fine, fine_p = rimg_shape(SWEEP_FOV, 5.0), rimg_shape(SWEEP_FOV, 6.0)
    if (sweep._cluster_plan([fine, fine]) is not None
            or sweep._cluster_plan([fine_p]) is not None
            or sweep._cluster_plan([fine])[0] != 8):
        raise AssertionError("the fine-resolution cases must take the global variant and a "
                             "cluster of 8")
    fine_imgs = blocks.block_fused_visibility_images_plain(
        w["bm"], ~w["extra"], w["pinv"], w["poses"], SWEEP_FOV, fine, fine_p,
        k_blocks=nb, max_range=400.0, scale=SWEEP_SCALE)[1]
    wf = dict(w, shape=fine, proj=fine_p, imgs=fine_imgs)
    for name, fn, launch in (("forward_global", fwd, (0, 0, 1, 0)),
                             ("vs_images_cluster8", vsi, (1, 0)),
                             ("fused_global", fus, (0, 0, 0, 1))):
        stats.append(compare_sweep(name, fn, *sweep_call(wf, fn), launch)[0])
    for st in stats:
        log(f"[2] {json.dumps(st)}")
    out["scatter"] = scatter_cases(dev)
    for st in out["scatter"]:
        log(f"[2] fixed_order_sum {json.dumps(st)}")
    out["cases"] = len(stats)
    out["per_case"] = stats
    out["seconds"] = time.perf_counter() - t0
    log(f"[2] sweep cases: {len(stats)} bit-equal to plain in {out['seconds']:.1f} s")
    return out


def sweep_recorder(calls):
    """Stand-ins for the four sweeps under the names
    ``ltm_torch.removert.pipeline`` imported: each runs the function and
    appends (name, args, kwargs, result) to ``calls``."""
    import ltm_torch.removert.pipeline as pipe

    def wrap(name, fn):
        def recording(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return recording

    return {name: wrap(name, getattr(pipe, name)) for name in SWEEP_FUNCS}


@contextlib.contextmanager
def pipeline_sweeps(route):
    """Within the block, ``ltm_torch.removert.pipeline`` calls the sweeps
    through ``route``: "kernel" (the public functions), "plain" (their
    ``*_plain`` loops) or a {name: function} dict; the names are restored
    after."""
    import ltm_torch.removert.pipeline as pipe
    from ltm_torch.kernels import blocks

    if route == "kernel":
        route = {name: getattr(blocks, name) for name in SWEEP_FUNCS}
    elif route == "plain":
        route = {name: getattr(blocks, name + "_plain") for name in SWEEP_FUNCS}
    saved = {name: getattr(pipe, name) for name in SWEEP_FUNCS}
    for name, fn in route.items():
        setattr(pipe, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(pipe, name, fn)


def sweep_work(fn, args, kwargs):
    """{"points", "scan_points", "fp64_ops", "fp32_ops", "bytes", "bound_ms",
    "bound_by"} of one sweep call: the live slots of every keyframe's selected blocks (and,
    forward, the valid scan points), each projected once; its FP64
    operations at the card's FP64 rate or its FP32 operations at the FP32
    rate, whichever takes longer (the two pipes issue side by side),
    against its bytes, each
    input read once (the selected blocks' slots, the scans or the images,
    the poses, a given list) and each output written once (the mask, K3's
    images), at the memory rate."""
    from ltm_torch.kernels import sweep

    fwd, vsi, pre, fus = SWEEP_FUNCS
    bm = args[0]
    extra = None if fn == fwd else args[1]
    if fn == pre:
        pose_inv, sel, val = args[3:6]
    else:
        pose_inv, poses = args[2:4] if fn == fus else args[3:5]
        valid = None
        if fn == vsi:
            valid = bm.block_valid & (bm.mask & extra.reshape(bm.mask.shape)).any(1)
        sel, val = sweep.select_blocks(bm, poses[:, :3, 3], kwargs["max_range"],
                                       kwargs["k_blocks"], valid=valid)
    live = bm.mask[sel] & val[..., None]
    if extra is not None:
        live &= extra.reshape(bm.mask.shape)[sel]
    points = int(live.sum())
    K, cap = pose_inv.shape[0], bm.block_capacity
    nbytes = (int(sel[val].unique().numel()) * cap * (13 + (extra is not None))
              + bm.mask.numel() + K * 64 + (sel.numel() * 9 if fn == pre else 0))
    fp64 = points * (SWEEP_FP64_POINT + 2 * (fn == fus))     # K3: a second row and column
    fp32 = points * (SWEEP_FP32_POINT + 3 * (fn == fus))
    scan_points = 0
    if fn == fwd:
        scans, smask = args[1:3]
        scan_points = int(smask.sum())
        fp64 += scan_points * SWEEP_FP64_SCAN
        fp32 += scan_points * SWEEP_FP32_SCAN
        nbytes += scans.numel() * 4 + smask.numel()
    elif fn == fus:
        shape = args[5]
        nbytes += K * shape[0] * shape[1] * 4                 # the images written
    else:
        nbytes += args[2].numel() * 4                         # the images read
    t_ops = max(fp64 / H100_FP64_FLOPS, fp32 / H100_FP32_FLOPS)    # separate pipes
    t_bytes = nbytes / H100_BYTES_PER_S
    return {"points": points, "scan_points": scan_points, "fp64_ops": fp64, "fp32_ops": fp32,
            "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


@contextlib.contextmanager
def global_variant():
    """Within the block the sweeps take the global variant at any size
    (the first design's passes: a kernel a pass, images in device memory),
    to measure it beside the cluster variant on the same calls."""
    from ltm_torch.kernels import sweep

    plan = sweep._cluster_plan
    sweep._cluster_plan = lambda images: None
    try:
        yield
    finally:
        sweep._cluster_plan = plan


def sweep_plans(fn, shape, proj=None):
    """(CTAs a cluster, rows a band of each image) of the cluster variant
    for a sweep at these image shapes, or None (the global variant)."""
    from ltm_torch.kernels import sweep

    fwd, vsi, pre, fus = SWEEP_FUNCS
    images = {fwd: [shape, shape], fus: [proj]}.get(fn, [shape])
    plan = sweep._cluster_plan(images)
    return None if plan is None else {"cluster": plan[0], "band_rows": list(plan[1]),
                                      "shared_bytes_a_cta": plan[2]}


def time_sweep(fn, args, kwargs, reps=5):
    """One sweep call through its kernel (the wrapper, by CUDA events,
    median of ``reps``), through the global variant (the same), and its
    plain version (once), with its work and bound, and the device time of
    each kernel of both variants (``device_profile``); the last result of
    each variant must have the plain result's bits (``differ``,
    ``max_abs_err``).  The timing launches leave the launch counts as they
    were."""
    from ltm_torch.kernels import blocks

    out = {}

    def run(route, f):
        out[route] = f(*args, **kwargs)

    saved = sweep_counts()
    kernels = {}
    try:
        ms = cuda_ms(lambda: run("kernel", getattr(blocks, fn)), reps=reps)
        kernels["cluster"] = device_profile(lambda: run("kernel", getattr(blocks, fn)))
        with global_variant():
            global_ms = cuda_ms(lambda: run("global", getattr(blocks, fn)), reps=reps)
            kernels["global"] = device_profile(lambda: run("global", getattr(blocks, fn)))
        plain_ms = cuda_ms(lambda: run("plain", getattr(blocks, fn + "_plain")), reps=1)
    finally:
        set_sweep_counts(saved)
    differ, err = sweep_diff(f"timed {fn}", out["kernel"], out["plain"])
    g_differ, g_err = sweep_diff(f"timed {fn}, global variant", out["global"], out["plain"])
    if differ or g_differ:
        raise AssertionError(f"timed {fn}: {differ} entries differ from the plain version "
                             f"(largest absolute difference {err}); global variant {g_differ}")
    shapes = args[5:7] if fn == SWEEP_FUNCS[3] else (args[6 if fn != SWEEP_FUNCS[2] else 7],)
    return dict(sweep_work(fn, args, kwargs), ms=ms, global_ms=global_ms, plain_ms=plain_ms,
                library_ms=None, differ=differ, max_abs_err=max(err, g_err),
                cluster_plan=sweep_plans(fn, shapes[0], shapes[-1]),
                device_ms={v: p["top_device_ms"] for v, p in kernels.items()})


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


def chunk_recorder(cfg, calls, prefix, run=None):
    """A stand-in for the pipeline's ``chunk_knn_sqdists`` that runs the
    kernel (or ``run``, taking the same arguments) and appends the call's
    (name, args, kwargs) to ``calls``.  The name is ``prefix`` and the
    call's role, read from the stage it runs in (ND, PD, the weak->strong
    promotion, the high-dynamic extraction), or an escalation of the call
    before it."""
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
    from ltm_torch.utils import current_stage

    run = chunk_knn_sqdists if run is None else run

    def recording(*args, **kwargs):
        stage = current_stage()
        if kwargs["k_blocks"] > cfg.chunk_knn_k_blocks:    # an escalation follows its main call
            name = calls[-1][0].replace("_escalated", "") + "_escalated"
        elif stage == "removert.knn_diff":
            name = f"{prefix}_pd" if calls else f"{prefix}_nd"
        else:
            name = prefix + {"removert.strong_weak.propagate": "_promotion",
                             "removert.save": "_high_dyn"}[stage]
        calls.append((name, args, kwargs))
        return run(*args, **kwargs)

    return recording


def phase_default_config(cfg, brute_masks):
    """Phase 5: the full-width workload on ``RemovertConfig()``'s defaults
    (the chunked kNN, K4), warm-up (recording its K4 calls) then three timed
    runs and one profiled run; K4 must launch in every timed run and the 14
    sets must equal phase 4's brute-force run.  Then the high-dynamic scan
    extraction of ``_save_artifacts`` (the largest kNN call) is recorded too,
    and each recorded call is held to the plain version and timed against
    its bound and the K1 yardstick.  K2 and K3 must launch in every timed
    run; the warm-up's sweep calls are recorded too, each held to its plain
    version bit for bit (and to what the run got), the largest call of each
    sweep timed against its bound and plain version, and one set of runs in
    turns (plain sweeps, kernels, kernels, plain) gives the stage walls of
    both.  Returns the per-call K4 stats, the last timed run and the sweep
    stats."""
    import torch

    import ltm_torch.removert.pipeline as pipe
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter
    from ltm_torch.removert.pipeline import MASK_NAMES
    from ltm_torch.utils import reset_slot_counts, reset_stage_times, stage_timer, stage_times

    os.environ["LTM_SYNC_STAGES"] = "1"
    full = workload(*FULL_WIDTH)
    rm = Removerter(cfg, device="cuda")
    calls, sweep_calls = [], []
    recording = chunk_recorder(cfg, calls, "full_width")
    runs = []
    for i in range(4):                     # run 0 warms up and records the calls
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_stage_times()
        reset_slot_counts()
        torch.cuda.synchronize()
        chunk_knn_sqdists.launches = chunk_knn_sqdists.merges = 0
        knn2_sqdists.launches = knn2_sqdists.merges = 0
        set_sweep_counts()
        pipe.chunk_knn_sqdists = recording if i == 0 else chunk_knn_sqdists
        try:
            with pipeline_sweeps(sweep_recorder(sweep_calls) if i == 0 else "kernel"):
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
        k2, k3, k2g, k3g = sweep_counts()
        if k2 <= 0 or k3 <= 0 or k2g or k3g:
            raise AssertionError(f"the default-configuration run launched K2 {k2} and K3 {k3} "
                                 f"times (global variant {k2g}, {k3g}); both must run as "
                                 "clusters")
        n_kf = result.central.num_keyframes + result.query.num_keyframes
        fb = rm.chunk_knn_fallbacks
        runs.append({"run": i, "wall_s": wall, "keyframes_per_s": n_kf / wall,
                     "k4_launches": chunk_knn_sqdists.launches,
                     "k4_merge_launches": chunk_knn_sqdists.merges,
                     "k2_launches": k2, "k3_launches": k3,
                     "k2_global_launches": k2g, "k3_global_launches": k3g,
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
        "k2_launches_per_run": [r["k2_launches"] for r in timed],
        "k3_launches_per_run": [r["k3_launches"] for r in timed],
        "escalated_queries_per_run": [r["escalated_queries"] for r in timed],
        "brute_forced_queries_per_run": [r["brute_forced_queries"] for r in timed],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_after_bytes": torch.cuda.memory_allocated(),
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
    return stats, timed[-1], phase5_sweeps(rm, full, sweep_calls, brute_masks)


def phase5_sweeps(rm, full, sweep_calls, brute_masks):
    """Phase 5's sweep checks: every sweep call of the warm-up run against
    its plain version (and the run's own result), the largest call of each
    sweep timed, and one set of runs in turns (plain, kernel, kernel,
    plain) with its stage walls; each turn's 14 sets must be phase 4's."""
    import torch

    from ltm_torch.utils import reset_stage_times, stage_times

    if {c[0] for c in sweep_calls} != set(SWEEP_FUNCS) - {SWEEP_FUNCS[2]}:
        raise AssertionError(f"phase 5 made sweep calls {sorted({c[0] for c in sweep_calls})}")
    per_call, largest = [], {}
    for i, (fn, args, kwargs, out) in enumerate(sweep_calls):
        st, got = compare_sweep(f"phase5_{i}", fn, args, kwargs)
        if any(not np.array_equal(x, y) for x, y in zip(host_bits(out), host_bits(got))):
            raise AssertionError(f"phase 5 sweep call {i} ({fn}): the run's result differs")
        K = args[2 if fn == SWEEP_FUNCS[3] else 3].shape[0]
        size = K * kwargs["k_blocks"]
        st.update(keyframes=K, k_blocks=kwargs["k_blocks"], reverse=kwargs.get("reverse"))
        per_call.append(st)
        if fn not in largest or size > largest[fn][0]:
            largest[fn] = (size, i, args, kwargs)
    timed = {}
    for fn, (_, i, args, kwargs) in largest.items():
        timed[fn] = dict(time_sweep(fn, args, kwargs), call=i, keyframes=per_call[i]["keyframes"],
                         k_blocks=kwargs["k_blocks"])
        log(f"[5] sweep {fn}, largest call: {json.dumps(timed[fn])}")
    turns = []
    from ltm_torch.removert.pipeline import MASK_NAMES

    for route in ("plain", "kernel", "kernel", "plain"):
        reset_stage_times()
        torch.cuda.synchronize()
        set_sweep_counts()
        with pipeline_sweeps(route):
            t0 = time.perf_counter()
            res = rm.run(*full)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k2, k3, k2g, k3g = sweep_counts()
        if ((route == "kernel") != (k2 > 0 and k3 > 0) or (route == "plain" and k2 + k3)
                or k2g or k3g):
            raise AssertionError(f"phase 5 {route} turn: K2 {k2}, K3 {k3} launch sets")
        diff = [n for n in MASK_NAMES
                if not np.array_equal(res.masks[n].cpu().numpy(), brute_masks[n])]
        if diff:
            raise AssertionError(f"phase 5 {route} turn: sets {diff} differ from phase 4's")
        stages = stage_times()
        turns.append({"route": route, "wall_s": wall, "k2_launches": k2, "k3_launches": k3,
                      "stages_s": {k: stages.get(k) for k in (
                          "removert.strong_weak", "removert.project_static",
                          "removert.high_dynamic")}})
        log(f"[5] sweep turn: {json.dumps(turns[-1])}")
    set_sweep_counts()
    log(f"[5] {len(per_call)} sweep calls of the warm-up run bit-equal to plain")
    return {"calls": len(per_call), "per_call": per_call, "largest": timed, "turns": turns}


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
               ("tridiag_apply", "ltm_torch.graph.solver", "_tridiag_apply"),
               ("gn_product", "ltm_torch.graph.solver", "gn_product"))

    def __init__(self, timed=False):
        import importlib

        self.timed = timed
        self.calls = {name: 0 for name, _, _ in self.TARGETS}
        self.captured = {name: 0 for name, _, _ in self.TARGETS}   # inside a graph's capture
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
                                      or args[0].numel() * args[2].shape[-2]
                                      > self.largest_1nn[0][0].numel()
                                      * self.largest_1nn[0][2].shape[-2]):
                self.largest_1nn = (args, kwargs)
            capturing = torch.cuda.is_current_stream_capturing()
            self.captured[name] += capturing
            if not self.timed or capturing:
                return fn(*args, **kwargs)       # a captured call runs in the graph's replays
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
    (the 1-NN: 8 flops a valid pair; the sweeps: ``tridiag_bound``; the
    Gauss-Newton product: ``gn_bound``)."""
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
    elif name == "tridiag_factor":                     # (D, L, chains)
        return tridiag_bound("factor", (*args[:2], args[2].pos))[0] / 1e3
    elif name == "gn_product":                         # (jac, plan, v, lam, scratch)
        return gn_bound(*args[:3])[0] / 1e3
    else:                                              # (Cinv, Lc, P, chains, r)
        return tridiag_bound("apply", (args[0], args[1], args[3].pos, args[4]))[0] / 1e3
    return max(ops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S)


class NnFarmCheck:
    """Holds every call of the ICP 1-NN in a run (``register.icp``'s
    ``nn_sqdist_argmin``, through K5b) to ``nn_sqdist_argmin_plain`` on the
    same inputs as it happens (``nn_diff``: indices equal except at counted
    near-ties, distances bit-equal where they agree), and the first and
    last lane of each call alone to the same lane in its batch
    (``nn_lane_alone``), and counts the scan's work a call (``nn_work``:
    tiles scored and culled, update branches).  The comparison launches
    leave the counts as they were."""

    def __init__(self):
        import importlib

        self.mod = importlib.import_module("ltm_torch.register.icp")
        self.fn = self.mod.nn_sqdist_argmin
        self.stats = {"calls": 0, "lanes_checked_alone": 0, "near_ties": 0,
                      "max_near_ties_a_call": 0, "differ_where_indices_agree": 0,
                      "lane_alone_differ": 0, "queries_compared": 0, "max_abs_err": 0.0,
                      "shapes": {}, "tiles_considered": 0, "tiles_scored": 0,
                      "tiles_culled": 0, "update_branches": 0, "min_cull_share": 1.0}
        self.mod.nn_sqdist_argmin = self._checked

    def _checked(self, *args, **kwargs):
        from ltm_torch.kernels.knn import nn_sqdist_argmin_plain

        got = self.fn(*args, **kwargs)
        saved = nn_counts()
        try:
            apart, bits, err = nn_diff(got, nn_sqdist_argmin_plain(*args, **kwargs), args)
            lanes = sorted({0, args[0].shape[0] - 1})
            alone = nn_lane_alone(args, kwargs, got, lanes)
            work = nn_work(args, got)
        finally:
            set_nn_counts(saved)
        st = self.stats
        for k in ("tiles_considered", "tiles_scored", "tiles_culled", "update_branches"):
            st[k] += work[k]
        if work["tiles_considered"]:
            st["min_cull_share"] = min(st["min_cull_share"], work["cull_share"])
        st["cull_share"] = st["tiles_culled"] / max(st["tiles_considered"], 1)
        st["calls"] += 1
        st["lanes_checked_alone"] += len(lanes)
        st["near_ties"] += apart
        st["max_near_ties_a_call"] = max(st["max_near_ties_a_call"], apart)
        st["differ_where_indices_agree"] += bits
        st["lane_alone_differ"] += alone
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["queries_compared"] += args[0].numel() // 3
        shape = "x".join(map(str, (args[0].shape[0], args[0].shape[-2], args[2].shape[-2])))
        st["shapes"][shape] = st["shapes"].get(shape, 0) + 1
        if bits or alone:
            raise AssertionError(f"ICP 1-NN call {st['calls']}: {bits} distances apart where the "
                                 f"indices agree, {alone} entries apart for a lane alone")
        return got

    def restore(self):
        self.mod.nn_sqdist_argmin = self.fn


def slam_run(cfg, b, hot=None, mesh=None):
    """One ``LTSlam.run`` of bundle ``b`` on the card (with ``mesh``
    assigned to ``LTSlam.mesh``): (slam, result, stats: wall, keyframes/s,
    ATE, loops, ICP iterations, host reads, synced stage walls)."""
    import torch

    from ltm_torch.slam import LTSlam
    from ltm_torch.utils import host_reads, reset_host_reads, reset_stage_times, stage_times

    n_kf = len(b["central"].site_poses) + len(b["query"].site_poses)
    reset_stage_times()
    reset_host_reads()
    torch.cuda.synchronize()
    slam = LTSlam(cfg, device="cuda")
    if mesh is not None:
        slam.mesh = mesh
    t0 = time.perf_counter()
    res = slam.run(b["central"].data, b["query"].data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    it = np.asarray(slam.icp_iterations)
    return slam, res, {
        "wall_s": wall, "keyframes_per_s": n_kf / wall, "ate_rmse_m": slam_ate(res, b),
        "sc_loops": res.num_sc_loops, "rs_loops": res.num_rs_loops, "icp_pairs": len(it),
        "icp_iterations_min_p50_p90_max": [int(it.min()), float(np.median(it)),
                                           float(np.percentile(it, 90)), int(it.max())]
        if len(it) else None,
        "host_reads": host_reads(), "stages_s": stage_times(),
        "hot_loop_calls": dict(hot.calls) if hot else None}


def phase_slam_full_width():
    """Phase 8: ``bench.py:_slam_bench``'s workload (500 keyframes a session,
    ~1 000 pose-graph nodes, ``LTSlamConfig()``): a warm-up (every 1-NN call
    and every eager sweep call held to its plain version, the last PCG
    recorded), one timed run (ATE ≤ 0.10 m; K5a's launches equal to the
    sweeps' calls), one run with the plain sweeps (the same card, before
    K5a), K5a at the warm-up's largest calls (``compare_tridiag``, timed),
    a graph-replayed PCG iteration by kernel with the kernel and with the
    plain sweeps (``pcg_iteration_profile``), an instrumented run that
    times each hot-loop call outside the PCG's graph replays with a sync on
    each side, one run with 10 RS loops (ATE ≤ 0.10 m) and one at
    ``odom_noise=4e-3`` (ATE ≤ 0.25 m).  Returns the summary and the last
    timed run (``slam``, ``res``, ``stats``: phase 14's reference)."""
    import torch

    from ltm_torch.core.config import LTSlamConfig
    from ltm_torch.graph import solver
    from ltm_torch.io.synthetic import make_two_sessions
    from ltm_torch.kernels.scatter import fixed_order_sum

    os.environ["LTM_SYNC_STAGES"] = "1"
    t0 = time.perf_counter()
    bundle = make_two_sessions(odom_noise=5e-4, **SLAM_WIDTH)
    n_kf = 2 * SLAM_WIDTH["num_keyframes"]
    log(f"[8] workload made in {time.perf_counter() - t0:.1f} s")

    runs = []
    scatter_calls = {}
    sweeps = pcg = gn = None
    for i in range(2):   # run 0 warms up, recording the scatter-sums and the last PCG and
        if i == 1:       # checking each 1-NN call, each eager sweep and each eager product
            torch.cuda.reset_peak_memory_stats()
        fixed_order_sum.launches = 0
        set_nn_counts()
        set_tridiag_counts()
        set_gn_counts()
        farm = NnFarmCheck() if i == 0 else None
        if i == 0:
            sweeps, pcg, gn = TridiagCheck(), PcgRecorder(), GnCheck()
        hot = HotLoops()
        solver.fixed_order_sum = scatter_recorder(scatter_calls) if i == 0 else fixed_order_sum
        try:
            slam, res, st = slam_run(LTSlamConfig(), bundle, hot)
        finally:
            hot.restore()
            if i == 0:
                for check in (gn, pcg, sweeps, farm):
                    check.restore()
            solver.fixed_order_sum = fixed_order_sum
        st["run"] = i
        st["scatter_launches"] = fixed_order_sum.launches
        st["nn_launches"], st["nn_merges"] = nn_counts()
        st["tridiag_launches"] = dict(zip(("factor", "apply"), tridiag_counts()))
        # the solve runs once more in each replay of a PCG's graph, uncounted:
        # a PCG reads the host once, then once an iteration (its first eager)
        replays = st["host_reads"]["pcg"] - 2 * st["tridiag_launches"]["factor"]
        st["tridiag_apply_runs"] = {
            "eager_launches": st["tridiag_launches"]["apply"],
            "captured": hot.captured["tridiag_apply"], "pcg_replays": replays,
            "executions": st["tridiag_launches"]["apply"] - hot.captured["tridiag_apply"] + replays}
        # the product runs once a PCG iteration: a PCG's iterations are its
        # host reads less one (each PCG factors its preconditioner once)
        st["gn_launches"] = gn_counts()
        st["gn_product_runs"] = {
            "eager_launches": st["gn_launches"], "captured": hot.captured["gn_product"],
            "pcg_replays": replays,
            "executions": st["gn_launches"] - hot.captured["gn_product"] + replays,
            "pcg_iterations": st["host_reads"]["pcg"] - st["tridiag_launches"]["factor"]}
        if (st["gn_launches"] != st["hot_loop_calls"]["gn_product"] or st["gn_launches"] <= 0
                or st["gn_product_runs"]["executions"] != st["gn_product_runs"]["pcg_iterations"]):
            raise AssertionError(f"K5c: {st['hot_loop_calls']['gn_product']} calls, "
                                 f"{json.dumps(st['gn_product_runs'])}")
        if fixed_order_sum.launches <= 0:
            raise AssertionError("LT-SLAM launched no fixed-order scatter-sum")
        if st["nn_launches"] != st["hot_loop_calls"]["icp_1nn"]:
            raise AssertionError(f"ICP 1-NN: {st['hot_loop_calls']['icp_1nn']} calls, "
                                 f"{st['nn_launches']} K5b launches")
        for which, n in st["tridiag_launches"].items():
            if n != st["hot_loop_calls"][f"tridiag_{which}"] or n <= 0:
                raise AssertionError(f"tridiag_{which}: {st['hot_loop_calls'][f'tridiag_{which}']} "
                                     f"calls, {n} K5a launches")
        if farm is not None:
            st["nn_farm_check"] = farm.stats
            if farm.stats["calls"] != st["nn_launches"] or not farm.stats["calls"]:
                raise AssertionError(f"the farm check saw {farm.stats['calls']} of "
                                     f"{st['nn_launches']} 1-NN calls")
        if i == 0:
            st["gn_check"] = gn.stats
            if gn.stats["calls"] != st["gn_launches"] or not gn.stats["checked"]:
                raise AssertionError(f"the product check saw {gn.stats['calls']} of "
                                     f"{st['gn_launches']} calls")
            st["tridiag_check"], st["tridiag_layout"] = sweeps.stats, sweeps.layout
            for which, cs in sweeps.stats.items():
                if cs["calls"] != st["tridiag_launches"][which] or not cs["checked"]:
                    raise AssertionError(f"the sweep check saw {cs['calls']} of "
                                         f"{st['tridiag_launches'][which]} {which} calls")
        runs.append(st)
        log(f"[8] {json.dumps(st)}")
        if st["ate_rmse_m"] > ATE_BOUND:
            raise AssertionError(f"full-width ATE {st['ate_rmse_m']} m > {ATE_BOUND} m")
        if res.num_sc_loops <= 0:
            raise AssertionError("full width: no SC loop accepted")
    peak = torch.cuda.max_memory_allocated()
    ref = {"slam": slam, "res": res, "stats": runs[-1], "bundle": bundle}

    with plain_sweeps():           # the same workload on the same card, the sweeps as before K5a
        _, _, plain_run = slam_run(LTSlamConfig(), bundle)
    if plain_run["ate_rmse_m"] > ATE_BOUND:
        raise AssertionError(f"plain-sweeps run: ATE {plain_run['ate_rmse_m']} m > {ATE_BOUND} m")
    optimize = {r: {k: v for k, v in st["stages_s"].items() if k.startswith("ltslam.optimize.")}
                for r, st in (("kernel", runs[1]), ("plain", plain_run))}
    same_card = {r: {"wall_s": st["wall_s"], "optimize_s": sum(optimize[r].values()),
                     "optimize_stages_s": optimize[r], "ate_rmse_m": st["ate_rmse_m"]}
                 for r, st in (("kernel", runs[1]), ("plain", plain_run))}
    log(f"[8] same card, the timed run (kernels) and one run with the plain sweeps: "
        f"{json.dumps(same_card)}")
    # the factor's call (all of a run's have its shape) and the solve's with the most lanes
    tridiag_largest = compare_tridiag("phase8_largest", *sweeps.largest["factor"],
                                      sweeps.largest["apply"][3], timed=True)
    log(f"[8] K5a at phase 8's largest calls: {json.dumps(tridiag_largest)}")
    gn_lm = compare_gn("phase8_lm", *gn.one_lane, timed=True)
    log(f"[8] K5c at the LM's call: {json.dumps(gn_lm)}")
    pcg_profile = {"kernel": pcg_iteration_profile(pcg.args)}
    with plain_sweeps():
        pcg_profile["plain"] = pcg_iteration_profile(pcg.args)
    # the same PCG with the product through the route before K5c
    pcg_profile["old_product"] = pcg_iteration_profile((old_product(*gn.one_lane[:2],
                                                                    gn.one_lane[3]),
                                                        *pcg.args[1:]))
    log(f"[8] a graph-replayed PCG iteration, by kernel: {json.dumps(pcg_profile)}")

    hot = HotLoops(timed=True)     # the PCG replays its graph: the sweeps run eagerly outside it
    try:
        _, _, inst = slam_run(LTSlamConfig(), bundle, hot)
    finally:
        hot.restore()
    optimize_s = sum(v for k, v in inst["stages_s"].items() if k.startswith("ltslam.optimize."))
    loops = {name: {"calls": hot.calls[name], "s": hot.seconds[name],
                    "ms_per_call": hot.seconds[name] / hot.calls[name] * 1e3 if hot.calls[name] else None,
                    "bound_ms_per_call": hot.bound_s[name] / hot.calls[name] * 1e3 if hot.calls[name] else None}
             for name in hot.calls}
    nn = compare_nn("phase8_largest", *hot.largest_1nn, timed=True)
    log(f"[8] instrumented run (a sync around each hot-loop call outside the PCG's graph "
        f"replays): wall {inst['wall_s']:.3f} s, optimize {optimize_s:.3f} s, {json.dumps(loops)}")
    log(f"[8] largest 1-NN call: {json.dumps(nn)}")

    cfg = LTSlamConfig()
    cfg.num_rs_loops_upper_bound = 10
    probe = MarginalsProbe()
    gn_rs = GnCheck()
    set_gn_counts()
    try:
        _, res, rs = slam_run(cfg, bundle)
    finally:
        gn_rs.restore()
        probe.restore()
    rs["gn_launches"], rs["gn_check"] = gn_counts(), gn_rs.stats
    log(f"[8] RS loops (num_rs_loops_upper_bound=10): {json.dumps(rs)}")
    if rs["ate_rmse_m"] > ATE_BOUND or res.num_rs_loops <= 0:
        raise AssertionError(f"RS run: ATE {rs['ate_rmse_m']} m, {res.num_rs_loops} RS loops")
    if not probe.calls:
        raise AssertionError("the RS run computed no marginals")
    marginals = {"calls": probe.calls, "turns": marginals_turns(probe),
                 "product": compare_gn("phase8_marginals", *gn_rs.widest, timed=True)}
    log(f"[8] the RS run's marginals by parts, and in turns: {json.dumps(marginals)}")
    noisy_b = make_two_sessions(odom_noise=4e-3, **SLAM_WIDTH)
    _, _, noisy = slam_run(LTSlamConfig(), noisy_b)
    log(f"[8] odom_noise=4e-3: {json.dumps(noisy)}")
    if noisy["ate_rmse_m"] > ATE_NOISY_BOUND:
        raise AssertionError(f"noisy run: ATE {noisy['ate_rmse_m']} m > {ATE_NOISY_BOUND} m")

    scatter = [compare_scatter(f"phase8_{name}", src_t, plan, timed=True)
               for name, (src_t, plan) in sorted(scatter_calls.items())]
    for st in scatter:
        log(f"[8] fixed_order_sum, largest call: {json.dumps(st)}")

    timed = runs[1:]
    summary = {
        "scatter_launches_per_run": [r["scatter_launches"] for r in timed],
        "nn_launches_per_run": [r["nn_launches"] for r in timed],
        "nn_merges_per_run": [r["nn_merges"] for r in timed],
        "nn_farm_check": runs[0]["nn_farm_check"],
        "scatter_largest_calls": scatter,
        "keyframes": n_kf,
        "median_keyframes_per_s": statistics.median(r["keyframes_per_s"] for r in timed),
        "median_wall_s": statistics.median(r["wall_s"] for r in timed),
        "ate_rmse_m": [r["ate_rmse_m"] for r in timed], "sc_loops": timed[-1]["sc_loops"],
        "rs_run": {k: rs[k] for k in ("ate_rmse_m", "rs_loops", "wall_s", "stages_s",
                                      "gn_launches", "gn_check")},
        "rs_marginals": marginals,
        "noisy_run": {k: noisy[k] for k in ("ate_rmse_m", "sc_loops", "wall_s")},
        "stages_s": timed[-1]["stages_s"],
        "icp_iterations_min_p50_p90_max": timed[-1]["icp_iterations_min_p50_p90_max"],
        "host_reads": timed[-1]["host_reads"],
        "hot_loop_calls_per_run": timed[-1]["hot_loop_calls"],
        "hot_loops_instrumented": loops,
        "instrumented_wall_s": inst["wall_s"],
        "instrumented_optimize_s": optimize_s,
        "largest_1nn_call": nn,
        "max_memory_allocated_bytes": peak,
        "tridiag_launches_per_run": {w: [r["tridiag_launches"][w] for r in timed]
                                     for w in ("factor", "apply")},
        "gn_launches_per_run": [r["gn_launches"] for r in timed],
        "gn_product_runs": timed[-1]["gn_product_runs"],
        "gn_check": runs[0]["gn_check"],
        "gn_lm_call": gn_lm,
        "tridiag_apply_runs": timed[-1]["tridiag_apply_runs"],
        "tridiag_check": runs[0]["tridiag_check"],
        "tridiag_layout": runs[0]["tridiag_layout"],
        "tridiag_largest_call": tridiag_largest,
        "pcg_iteration_profile": pcg_profile,
        "same_card_plain_sweeps": same_card,
    }
    log(f"[8] {json.dumps(summary)}")
    return summary, ref


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


LIFELONG_WIDTH = dict(n_sessions=6, num_keyframes=24, num_cars=10, max_scan_points=40_000,
                      scan_range=70.0, seed=29, point_noise=0.01)   # bench.py:_lifelong_bench
LIFELONG_CUT = (3, 6)      # phase 10, card vs CPU: sessions, keyframes a session


def lifelong_config():
    """``bench.py:_lifelong_bench``'s ``RemovertConfig``: scan capacity the
    pow-2 bucket of 40 000 points, 0.1 m voxels, 0.04 m² kNN threshold, no
    artifacts."""
    from ltm_torch.core.config import RemovertConfig

    cfg = RemovertConfig()
    cfg.scan_capacity = max(16384, 1 << (LIFELONG_WIDTH["max_scan_points"] - 1).bit_length())
    cfg.downsample_voxel_size = 0.1
    cfg.knn_avg_sqdist_threshold = 0.04
    cfg.save_map_pcd = False
    cfg.save_clean_scans_pcd = False
    cfg.save_high_dyn_maps = False
    return cfg


def lifelong_inputs():
    from ltm_torch.io.synthetic import make_n_sessions
    from ltm_torch.removert import RemovertInput

    bundle = make_n_sessions(**LIFELONG_WIDTH)
    return [RemovertInput(scans=list(s.data.scans), poses=s.site_poses) for s in bundle["sessions"]]


def check_sets(tag, res_a, res_b):
    """The 14 named sets of two runs agree within phase 3's rule; returns
    [|a|, |b|, symmetric difference] per set."""
    from ltm_torch.removert.pipeline import MASK_NAMES

    counts = {}
    for name in MASK_NAMES:
        a, b = res_a.points(name), res_b.points(name)
        diff = set_difference(a, b)
        counts[name] = [len(a), len(b), diff]
        if diff > max(2, 1e-4 * len(a)):
            raise AssertionError(f"{tag}: set {name} differs by {diff} points "
                                 f"({len(a)} against {len(b)})")
    return counts


def phase_lifelong():
    """Phase 10: the lifelong meta-map chain, ``bench.py:_lifelong_bench``'s
    workload (6 sessions x 24 keyframes x 40 000 points, seed 29) through
    ``lifelong_update`` on the card: one warm-up chain and two timed chains,
    with per-round walls, nd/pd/updated, the K4 and K1 launches of each
    round and the chain's peak device memory; the last round's keyframes/s
    is bench's metric (2 x 24 / ``lifelong.round_6``).  Then the chain cut
    to 3 sessions x 6 keyframes (full scan width) on the card and on the
    CPU: each round's 14 sets and the live map within phase 3's rule, and
    K4 launched on the card.  Each K4 call of the warm-up chain's last round
    (ND, PD, promotion, their escalations) is held to the plain version bit
    for bit, with its launch counts.  Returns the summary and the inputs
    (phase 11 reuses the first pair)."""
    import torch

    import ltm_torch.ltmap.lifelong as ll
    import ltm_torch.removert.pipeline as pipe
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter, RemovertInput
    from ltm_torch.utils import reset_stage_times, stage_times

    os.environ["LTM_SYNC_STAGES"] = "1"
    inputs = lifelong_inputs()
    cfg = lifelong_config()
    n_s, n_kf = LIFELONG_WIDTH["n_sessions"], LIFELONG_WIDTH["num_keyframes"]
    rounds, calls = [], []

    class Counted(Removerter):
        def run(self, *args, **kwargs):
            calls.clear()                  # the recorded calls are the last round's
            c0 = (chunk_knn_sqdists.launches, chunk_knn_sqdists.merges, knn2_sqdists.launches)
            torch.cuda.synchronize()
            before = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()   # the round's own peak
            out = super().run(*args, **kwargs)
            torch.cuda.synchronize()
            rounds.append({"allocated_before_bytes": before[0],
                           "peak_before_bytes": before[1],
                           "peak_bytes": torch.cuda.max_memory_allocated(),
                           "allocated_after_bytes": torch.cuda.memory_allocated(),
                           "k4_launches": chunk_knn_sqdists.launches - c0[0],
                           "k4_merge_launches": chunk_knn_sqdists.merges - c0[1],
                           "k1_launches": knn2_sqdists.launches - c0[2],
                           "escalated_queries": sum(len(f["escalated"])
                                                    for f in self.chunk_knn_fallbacks),
                           "brute_forced_queries": sum(len(f["brute"])
                                                       for f in self.chunk_knn_fallbacks)})
            return out

    chains = []
    ll.Removerter = Counted
    try:
        for i in range(3):                 # chain 0 warms up
            rounds.clear()
            reset_stage_times()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pipe.chunk_knn_sqdists = (chunk_recorder(cfg, calls, "lifelong") if i == 0
                                      else chunk_knn_sqdists)
            try:
                t0 = time.perf_counter()
                out = ll.lifelong_update(inputs, cfg, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                pipe.chunk_knn_sqdists = chunk_knn_sqdists
            walls = stage_times()
            if len(out.rounds) != n_s - 1:
                raise AssertionError(f"lifelong: {len(out.rounds)} rounds")
            per_round = [dict(st, wall_s=walls[f"lifelong.round_{st['round']}"], **counts)
                         for st, counts in zip(out.round_stats, rounds)]
            if any(r["k4_launches"] <= 0 for r in per_round):
                raise AssertionError(f"a lifelong round launched no K4 scan: {per_round}")
            if not (out.live_map.shape[0] and np.isfinite(out.live_map).all()):
                raise AssertionError("lifelong: empty or non-finite live map")
            chains.append({"chain": i, "wall_s": wall,
                           "capacity_estimate_s": walls["lifelong.capacity_estimate"],
                           "last_round_keyframes_per_s": 2 * n_kf / walls[f"lifelong.round_{n_s}"],
                           "live_map_points": int(out.live_map.shape[0]),
                           "max_memory_allocated_bytes": max(
                               [torch.cuda.max_memory_allocated()]
                               + [r[k] for r in rounds for k in ("peak_bytes",
                                                                  "peak_before_bytes")]),
                           "rounds": per_round})
            log(f"[10] {json.dumps(chains[-1])}")
            if i == 0:
                checked = [compare_chunk(name, *args, **kwargs) for name, args, kwargs in calls]
                if len(checked) != per_round[-1]["k4_launches"]:
                    raise AssertionError(f"lifelong: {len(checked)} K4 calls recorded in the "
                                         f"last round, {per_round[-1]['k4_launches']} launched")
                for st in checked:
                    log(f"[10] round {n_s}, K4 vs plain: {json.dumps(st)}")
                calls.clear()
    finally:
        ll.Removerter = Removerter
    counts = [[(r["nd"], r["pd"], r["updated"]) for r in c["rounds"]] for c in chains]
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"lifelong: the chains' round counts differ: {counts}")

    n_sess, kf = LIFELONG_CUT
    cut = [RemovertInput(scans=s.scans[:kf], poses=s.poses[:kf]) for s in inputs[:n_sess]]
    k4_before = chunk_knn_sqdists.launches
    t0 = time.perf_counter()
    gpu = ll.lifelong_update(cut, cfg, device="cuda")
    gpu_s = time.perf_counter() - t0
    cut_k4 = chunk_knn_sqdists.launches - k4_before
    if cut_k4 <= 0:
        raise AssertionError("lifelong cut: the card's chain launched no K4 scan")
    t0 = time.perf_counter()
    cpu = ll.lifelong_update(cut, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    cut_st = {"sessions": n_sess, "keyframes": kf, "card_s": gpu_s, "cpu_s": cpu_s,
              "card_k4_launches": cut_k4, "map_capacity": gpu.rounds[0].central.map_xyz.shape[0],
              "round_stats": [cpu.round_stats, gpu.round_stats], "rounds": []}
    for i, (rc, rg) in enumerate(zip(cpu.rounds, gpu.rounds), start=2):
        cut_st["rounds"].append(check_sets(f"lifelong cut round {i}, card vs CPU", rc, rg))
    diff = set_difference(cpu.live_map, gpu.live_map)
    if diff > max(2, 1e-4 * len(cpu.live_map)):
        raise AssertionError(f"lifelong cut: live maps differ by {diff} points")
    cut_st["live_map"] = [len(cpu.live_map), len(gpu.live_map), diff]
    log(f"[10] card vs CPU, cut chain: {json.dumps(cut_st)}")
    timed = chains[1:]
    summary = {
        "last_round_keyframes_per_s": [c["last_round_keyframes_per_s"] for c in timed],
        "chain_wall_s": [c["wall_s"] for c in timed],
        "round_walls_s": [[r["wall_s"] for r in c["rounds"]] for c in timed],
        "round_stats": [{k: r[k] for k in ("round", "nd", "pd", "updated")}
                        for r in timed[-1]["rounds"]],
        "k4_launches_per_round": [r["k4_launches"] for r in timed[-1]["rounds"]],
        "k1_launches_per_round": [r["k1_launches"] for r in timed[-1]["rounds"]],
        "max_memory_allocated_bytes": max(c["max_memory_allocated_bytes"] for c in timed),
        "round_memory_bytes": [{k: r[k] for k in ("round", "allocated_before_bytes",
                                                  "peak_bytes", "allocated_after_bytes")}
                               for r in timed[-1]["rounds"]],
        "k4_vs_plain_last_round": [{k: st[k] for k in ("case", "n_valid", "ulps",
                                                        "overflowed_chunks", "merge_launches")}
                                   for st in checked],
        "card_vs_cpu_cut": {k: cut_st[k] for k in ("sessions", "keyframes", "card_s", "cpu_s",
                                                   "card_k4_launches", "map_capacity",
                                                   "live_map")},
    }
    log(f"[10] {json.dumps(summary)}")
    return summary, inputs


class OptinLoops:
    """Counts the calls of the opt-in configurations' hot loops (torch ops)
    and keeps the largest call of each, by patching the names their callers
    read; ``time_all`` then times each kept call by CUDA events against its
    bound: its bytes (``optin_work``) or the operations it issues
    (``issued_ops``), whichever takes longer.  The presel sweep runs K2: it
    is timed as ``time_sweep`` times a sweep, and while ``recorded`` is a
    list each of its calls is appended there as (name, args, kwargs,
    result)."""

    TARGETS = (("cull_blocks_vs_images", "ltm_torch.removert.pipeline"),
               ("block_sweep_discrepancy_vs_images_presel", "ltm_torch.removert.pipeline"),
               ("block_fused_phase_a", "ltm_torch.removert.pipeline"),
               ("block_fused_phase_b", "ltm_torch.removert.pipeline"),
               ("grid_knn2_sqdists", "ltm_torch.removert.pipeline"),
               ("_prep_scans_device", "ltm_torch.removert.session"))

    def __init__(self):
        import importlib

        self.calls = {name: 0 for name, _ in self.TARGETS}
        self.largest = {}
        self.recorded = None
        self._saved = []
        for name, mod in self.TARGETS:
            m = importlib.import_module(mod)
            fn = getattr(m, name)
            self._saved.append((m, name, fn))
            setattr(m, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            self.calls[name] += 1
            out = fn(*args, **kwargs)
            if self.recorded is not None and name in SWEEP_FUNCS:
                self.recorded.append((name, args, kwargs, out))
            # the call's size from its shapes alone (no host sync in a run);
            # calls on the CPU (the card-vs-CPU checks) are not kept
            size = sum(a.numel() for a in args[:6] if hasattr(a, "numel") and a.is_cuda)
            if name not in self.largest or size > self.largest[name][3]:
                self.largest[name] = (fn, args, kwargs, size, out)
            return out
        return wrapped

    def reset_counts(self):
        self.calls = {k: 0 for k in self.calls}

    def restore(self):
        for m, name, fn in self._saved:
            setattr(m, name, fn)

    def time_all(self):
        rows = {}
        for name, (fn, args, kwargs, _, out) in self.largest.items():
            if name in SWEEP_FUNCS:     # K2: its own bound, and its plain loop
                rows[name] = time_sweep(name, args, kwargs, reps=3)
                continue
            work = optin_work(name, args, kwargs, out)
            ops = issued_ops(fn, args, kwargs)
            ms = cuda_ms(lambda: fn(*args, **kwargs), reps=3)
            t_ops = ops / H100_FP32_FLOPS
            t_bytes = work["bytes"] / H100_BYTES_PER_S
            rows[name] = {"ms": ms, "points": work["points"], "ops": ops,
                          "bytes": work["bytes"], "bound_ms": 1e3 * max(t_ops, t_bytes),
                          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                          "library_ms": None}
        return rows


_COPIES = ("clone", "copy", "_to_copy", "fill", "lift_fresh", "zero")


def aten_ops(func, args, out) -> int:
    """Operations one aten op issues: 2·M·N·K for a matrix product, an
    input element for a reduction, an output element for a pointwise op
    (in place or not; copies and fills aside), none for views, indexing,
    sorts and scans.  A transcendental counts as one."""
    import torch

    name = func.overloadpacket.__name__
    base = name.rstrip("_")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if base in ("mm", "bmm", "addmm", "baddbmm"):
        a, b = tensors[-2:]
        return 2 * a.numel() * b.shape[-1]
    if torch.Tag.reduction in func.tags:
        return tensors[0].numel() if tensors else 0
    if base in _COPIES:
        return 0
    pointwise = torch.Tag.pointwise in func.tags
    if not pointwise and name.endswith("_"):        # an in-place op: its functional twin's tag
        packet = getattr(torch.ops.aten, base, None)
        pointwise = packet is not None and any(
            torch.Tag.pointwise in getattr(packet, ov).tags for ov in packet.overloads())
    if not pointwise:
        return 0
    first = out[0] if isinstance(out, (tuple, list)) else out
    return first.numel() if isinstance(first, torch.Tensor) else 0


def issued_ops(fn, args, kwargs) -> int:
    """Operations one call of ``fn`` issues, summed over its aten op
    sequence (``aten_ops``) under a dispatch mode: the count of the torch
    ops the call really runs, padded slots included."""
    from torch.utils._python_dispatch import TorchDispatchMode

    total = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            total[0] += aten_ops(func, a, out)
            return out

    with Count():
        fn(*args, **kwargs)
    return total[0]


def optin_work(name, args, kwargs, out):
    """{"points", "bytes"} of one hot-loop call from its inputs: the points
    it projects (the valid queries for the grid kNN), and the bytes it must
    move, each input the call reads read once and each output written once
    (block maps: only the blocks some keyframe selects; grids: only their
    valid points and occupied cells)."""
    import torch

    def union_slots(bm, sel, val):
        return int(torch.unique(sel[val]).numel()) * bm.block_capacity

    if name == "cull_blocks_vs_images":
        bmin, _, _, pose_inv, imgs = args[:5]
        K, B, npix = pose_inv.shape[0], bmin.shape[0], imgs.shape[-1]
        return {"points": K * B, "bytes": B * 25 + K * 64 + K * npix * 4 + K * B}
    if name == "block_fused_phase_a":
        bm, _, pose_inv = args[:3]
        sel_a, sel_a_valid, packed, survive = out
        return {"points": int(sel_a_valid.sum()) * bm.block_capacity,
                "bytes": union_slots(bm, sel_a, sel_a_valid) * 14 + bm.num_blocks * 41
                + pose_inv.shape[0] * 128 + packed.numel() * 4 + survive.numel()}
    if name == "block_fused_phase_b":
        bm, _, pose_inv, packed, sel_b, sel_b_valid, sel_ab, sel_ab_valid = args[:8]
        win, imgs = out
        return {"points": int(sel_b_valid.sum() + sel_ab_valid.sum()) * bm.block_capacity,
                "bytes": union_slots(bm, sel_ab, sel_ab_valid) * 14 + packed.numel() * 4
                + sel_ab.numel() * 9 + imgs.numel() * 4 + win.numel()}
    if name == "grid_knn2_sqdists":
        from ltm_torch.kernels.grid_knn import _KEY_PAD

        qg, tg = args[:2]
        n_q, n_t = int(qg.mask.sum()), int(tg.mask.sum())
        cells = int((qg.keys != _KEY_PAD).sum() + (tg.keys != _KEY_PAD).sum())
        return {"points": n_q, "bytes": 13 * (n_q + n_t) + 8 * cells + out.numel() * 4}
    raw, rmask = args[:2]                                    # _prep_scans_device
    cap = args[5]
    return {"points": int(rmask.sum()),
            "bytes": raw.numel() * 4 + rmask.numel() + raw.shape[0] * cap * 13 + raw.shape[0] * 8}


def grid_config(cfg, maps):
    """``cfg`` with the grid kNN on and its capacities sized from the
    (xyz, mask) maps: cells the pow-2 bucket of the most occupied cells of
    either map, a cell the pow-2 bucket of the fullest cell (0.1 m voxels
    put hundreds of points in a 2 m cell; the default 64 overflows)."""
    import dataclasses

    import torch

    from ltm_torch.kernels.grid_knn import _cell_keys

    n_cells = cap = 1
    for xyz, mask in maps:
        keys = _cell_keys(xyz, mask, cfg.grid_cell_size)[mask]
        _, counts = torch.unique(keys, return_counts=True)
        n_cells = max(n_cells, counts.numel())
        cap = max(cap, int(counts.max()))
    return dataclasses.replace(cfg, use_grid_knn=True, use_chunk_knn=False,
                               grid_n_cells=1 << (n_cells - 1).bit_length(),
                               grid_cell_capacity=1 << (cap - 1).bit_length())


def grid_refusal(cfg, res):
    """The grid kNN on the 1 200 m corridor of ``res`` (phase 5's maps),
    with capacities sized from the points within ±2^9 cells of the origin:
    those bucket without overflow, and the points past x = 1 024 m, which
    ``_cell_keys`` clips into the edge cells, must make ``_grid_knn_stat``
    raise on an overflow.  Returns what the check saw."""
    import torch

    from ltm_torch.kernels.grid_knn import _COORD_OFF, build_grid_buckets
    from ltm_torch.kernels.projection import _div
    from ltm_torch.removert import Removerter

    maps = [(s.map_xyz, s.map_mask) for s in (res.central, res.query)]
    inside = []
    for xyz, mask in maps:
        c = torch.floor(_div(xyz, cfg.grid_cell_size))
        inside.append((xyz, mask & ((c >= -_COORD_OFF) & (c < _COORD_OFF)).all(1)))
    gcfg = grid_config(cfg, inside)
    past = [int((m & ~i).sum()) for (_, m), (_, i) in zip(maps, inside)]
    if min(past) <= 0:
        raise AssertionError(f"the corridor has no point past ±2^9 cells ({past})")
    for xyz, mask in inside:
        _, over = build_grid_buckets(xyz, mask, gcfg.grid_cell_size, gcfg.grid_n_cells,
                                     gcfg.grid_cell_capacity)
        if over:
            raise AssertionError(f"the in-range points overflow the grid sized for them ({over})")
    try:
        Removerter(gcfg, device="cuda")._grid_knn_stat(
            maps[0][0], maps[0][1], maps[1][0], maps[1][1])
    except ValueError as e:
        if "overflow" not in str(e):
            raise
        msg = str(e)
    else:
        raise AssertionError("the grid kNN accepted the 1 200 m corridor")
    return {"grid_n_cells": gcfg.grid_n_cells, "grid_cell_capacity": gcfg.grid_cell_capacity,
            "points_past_range": past, "in_range_overflow": 0, "raises": msg[:160]}


def presel_vs_plain(calls):
    """Every recorded presel sweep call of a culled run held to its plain
    version on the card by ``compare_sweep`` (kernel, a second launch and
    plain: the same bits; a launch set a chunk of keyframes) and to the
    run's own result.  Returns the calls' stats."""
    from ltm_torch.kernels import sweep

    rows = []
    for i, (fn, args, kwargs, out) in enumerate(calls):
        K, k_sel = args[4].shape
        n = -(-K // sweep.MAX_KEYFRAMES) if k_sel else 0
        st, got = compare_sweep(f"optin_presel_{i}", fn, args, kwargs, (n, 0))
        if sweep_diff(f"presel call {i}", out, got)[0]:
            raise AssertionError(f"presel call {i}: the culled run's result differs")
        st.update(keyframes=K, k_sel=k_sel, reverse=kwargs.get("reverse"))
        rows.append(st)
    if not any(st["k2_launches"] for st in rows):
        raise AssertionError(f"the culled run launched K2 in none of its {len(rows)} presel calls")
    return rows


def phase_optin(cfg, brute_masks, phase5_run, lifelong_pair):
    """Phase 11: the opt-in configurations on the card.  (a) occlusion
    culling on phase 5's workload: the 14 masks bit-equal to phase 5's (=
    phase 4's), every presel sweep call of the warm-up run held to its
    plain loop (``presel_vs_plain``), stage walls beside phase 5's, near
    and far survivor blocks a keyframe, and the grid kNN refused on that
    1 200 m corridor
    (``grid_refusal``); (b) the grid kNN on phase 10's first session pair
    at full width: the 14 masks equal the brute path's, each of whose K1
    calls is held to the plain version, the ND call timed through the
    grid, K1 and K4; (c) ``device_scan_prep`` on phase 5's workload: the
    prep wall beside phase 5's, the timed run's central map against the
    same session built on the CPU and the pipeline card against CPU on
    phase 3's workload (phase 3's rule), and the central map of both preps
    at full density equivalent under
    ``tests/test_removert.py::test_device_scan_prep_matches_host``'s rule;
    (d) ``use_self_removert``: card against CPU on phase 3's workload
    (phase 3's rule), one timed run at phase 5's width.  Each hot loop's
    largest call on the card is then timed against its bound.  Returns the
    summary."""
    import dataclasses

    import torch
    from scipy.spatial import cKDTree

    import ltm_torch.kernels.knn as knn_mod
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter
    from ltm_torch.removert.pipeline import MASK_NAMES
    from ltm_torch.removert.session import RemovertSession, parse_keyframe_indices
    from ltm_torch.utils import reset_stage_times, stage_times

    os.environ["LTM_SYNC_STAGES"] = "1"
    full = workload(*FULL_WIDTH)
    loops = OptinLoops()
    summary = {}
    try:
        # (a) occlusion culling
        rm = Removerter(dataclasses.replace(cfg, use_occlusion_culling=True), device="cuda")
        runs, presel_calls = [], []
        for i in range(2):                 # run 0 warms up; its presel calls are recorded
            loops.recorded = presel_calls if i == 0 else None
            loops.reset_counts()
            reset_stage_times()
            t0 = time.perf_counter()
            res = rm.run(*full)
            torch.cuda.synchronize()
            runs.append({"wall_s": time.perf_counter() - t0, "stages_s": stage_times(),
                         "calls": dict(loops.calls)})
        diff = [n for n in MASK_NAMES
                if not np.array_equal(res.masks[n].cpu().numpy(), brute_masks[n])]
        if diff:
            raise AssertionError(f"occlusion culling changed sets {diff}")
        presel = presel_vs_plain(presel_calls)
        del presel_calls
        for st in presel:
            log(f"[11a] presel vs plain: {json.dumps(st)}")
        summary["a_occlusion"] = {
            "wall_s": runs[1]["wall_s"], "stages_s": runs[1]["stages_s"],
            "phase5_wall_s": phase5_run["wall_s"], "phase5_stages_s": phase5_run["stages_s"],
            "calls_per_run": runs[1]["calls"], "masks_equal_phase5": True,
            "survivors": rm.occlusion_stats,
            "presel_vs_plain": {"calls": len(presel), "differ": sum(st["differ"] for st in presel),
                                "max_abs_err": max(st["max_abs_err"] for st in presel),
                                "k2_launches": sum(st["k2_launches"] for st in presel)}}
        log(f"[11a] {json.dumps(summary['a_occlusion'])}")
        summary["a_occlusion"]["grid_on_corridor"] = grid_refusal(cfg, res)
        log(f"[11a] grid kNN on the corridor: "
            f"{json.dumps(summary['a_occlusion']['grid_on_corridor'])}")
        del res

        # (b) grid kNN on phase 10's first session pair
        lcfg = lifelong_config()
        brute_cfg = dataclasses.replace(lcfg, use_chunk_knn=False)
        knn2_sqdists.launches = 0
        rm_b = Removerter(brute_cfg, device="cuda")
        k1_calls = []

        def recording(*args):
            k1_calls.append(args)
            return knn2_sqdists(*args)

        knn_mod.knn2_sqdists = recording
        try:
            res_b = rm_b.run(*lifelong_pair)
        finally:
            knn_mod.knn2_sqdists = knn2_sqdists
        k1_launches = knn2_sqdists.launches
        if k1_launches <= 0 or k1_launches != len(k1_calls):
            raise AssertionError(f"the brute pair run launched the K1 scan {k1_launches} times "
                                 f"in {len(k1_calls)} calls")
        k1_checked = [compare_knn2(f"pair_{KNN2_CALLS[i][11:] if i < 3 else i}", *args)
                      for i, args in enumerate(k1_calls)]
        for st in k1_checked:
            log(f"[11b] K1 vs plain: {json.dumps(st)}")
        gcfg = grid_config(lcfg, [(s.map_xyz, s.map_mask) for s in (res_b.central, res_b.query)])
        rm_g = Removerter(gcfg, device="cuda")
        rm_g.run(*lifelong_pair)                     # warm-up
        loops.reset_counts()
        reset_stage_times()
        t0 = time.perf_counter()
        res_g = rm_g.run(*lifelong_pair)
        torch.cuda.synchronize()
        grid_wall = time.perf_counter() - t0
        grid_stages = stage_times()
        diff = [n for n in MASK_NAMES if not torch.equal(res_g.masks[n], res_b.masks[n])]
        if diff:
            raise AssertionError(f"grid kNN and brute force differ in sets {diff}")
        c, q = res_b.central, res_b.query
        nd_args = (c.map_xyz, c.masks["static"] & c.masks["proj_static"], q.map_xyz,
                   q.masks["static"])
        k4 = Removerter(lcfg, device="cuda")
        k4_ms = cuda_ms(lambda: k4._knn_stat(*nd_args, target_base=q.map_mask), reps=3)
        summary["b_grid"] = {
            "grid_n_cells": gcfg.grid_n_cells, "grid_cell_capacity": gcfg.grid_cell_capacity,
            "wall_s": grid_wall, "stages_s": grid_stages, "calls_per_run": dict(loops.calls),
            "masks_equal_brute": True, "k1_launches_brute": k1_launches,
            "k1_vs_plain": [{k: st[k] for k in ("case", "n_valid", "m_valid", "ulps")}
                            for st in k1_checked],
            "nd_call_ms": {"grid": cuda_ms(lambda: rm_g._grid_knn_stat(*nd_args), reps=3),
                           "k1": cuda_ms(lambda: knn2_sqdists(*nd_args), reps=3),
                           "k4": k4_ms},
            "nd_queries": int(nd_args[1].sum()), "nd_targets": int(nd_args[3].sum())}
        log(f"[11b] {json.dumps(summary['b_grid'])}")
        del res_b, res_g, rm_b, rm_g, k4

        # (c) device scan prep
        rm_d = Removerter(dataclasses.replace(cfg, device_scan_prep=True), device="cuda")
        rm_d.run(*full)                              # warm-up
        loops.reset_counts()
        reset_stage_times()
        t0 = time.perf_counter()
        res_d = rm_d.run(*full)
        torch.cuda.synchronize()
        dev_wall = time.perf_counter() - t0
        dev_stages, dev_calls = stage_times(), dict(loops.calls)
        dcfg = dataclasses.replace(cfg, device_scan_prep=True)
        central_inp = full[0]
        idx = parse_keyframe_indices(len(central_inp.scans), cfg.start_idx, cfg.end_idx,
                                     cfg.keyframe_gap)
        # the timed run's central map against the same session built on the CPU
        cpu_sess = RemovertSession.build(central_inp, dcfg, "Central", idx, torch.device("cpu"))
        cpu_map = cpu_sess.map_xyz[cpu_sess.map_mask].numpy()
        card_map = res_d.central.map_xyz[res_d.central.map_mask].cpu().numpy()
        map_diff = set_difference(cpu_map, card_map)
        if map_diff > max(2, 1e-4 * len(cpu_map)):
            raise AssertionError(f"device prep: card and CPU central maps differ by {map_diff} "
                                 f"points ({len(cpu_map)} against {len(card_map)})")
        del cpu_sess
        small = workload(4, 6000, 300.0)
        small_counts = check_sets("device prep, card vs CPU",
                                  Removerter(dcfg, device="cpu").run(*small),
                                  Removerter(dcfg, device="cuda").run(*small))
        # the two preps compared as the test's rule compares them, at full
        # density (a scan capacity above every scan's voxel count: below it
        # the host subsamples and the device merges voxels, two different
        # valid reductions)
        dense = dataclasses.replace(cfg, scan_capacity=1 << (max(
            len(s) for s in central_inp.scans) - 1).bit_length())
        maps = []
        for on in (True, False):
            sess = RemovertSession.build(central_inp, dataclasses.replace(dense,
                                                                          device_scan_prep=on),
                                         "Central", idx, torch.device("cuda"))
            maps.append(sess.map_xyz[sess.map_mask].cpu().numpy())
            del sess
        a, b = maps
        if abs(len(a) - len(b)) > 0.02 * max(len(a), len(b)):
            raise AssertionError(f"device prep: {len(a)} map points against {len(b)}")
        q99 = [float(np.quantile(cKDTree(dst).query(src, workers=-1)[0], 0.99))
               for src, dst in ((a, b), (b, a))]
        if max(q99) >= 0.15:
            raise AssertionError(f"device prep: 99% nearest-neighbour distances {q99}")
        summary["c_device_prep"] = {
            "wall_s": dev_wall, "prep_s": dev_stages.get("removert.prep"),
            "phase5_prep_s": phase5_run["stages_s"].get("removert.prep"), "stages_s": dev_stages,
            "card_vs_cpu_central_map": [len(cpu_map), len(card_map), map_diff],
            "card_vs_cpu_small": small_counts,
            "dense_scan_capacity": dense.scan_capacity, "dense_map_points": [len(a), len(b)],
            "nn_q99_m": q99, "calls_per_run": dev_calls}
        log(f"[11c] {json.dumps(summary['c_device_prep'])}")
        del res_d, rm_d, maps, a, b, cpu_map, card_map

        # (d) self-removert
        scfg = dataclasses.replace(cfg, use_self_removert=True)
        counts = check_sets("self-removert, card vs CPU",
                            Removerter(scfg, device="cpu").run(*small),
                            Removerter(scfg, device="cuda").run(*small))
        rm_s = Removerter(scfg, device="cuda")
        reset_stage_times()
        t0 = time.perf_counter()
        res_s = rm_s.run(*full)
        torch.cuda.synchronize()
        summary["d_self_removert"] = {
            "card_vs_cpu": counts, "wall_s": time.perf_counter() - t0, "stages_s": stage_times(),
            "static_c": int(res_s.masks["static_c"].sum()),
            "dynamic_c": int(res_s.masks["dynamic_c"].sum()),
            "phase5_static_c": int(brute_masks["static_c"].sum())}
        log(f"[11d] {json.dumps(summary['d_self_removert'])}")
        del res_s, rm_s
        summary["hot_loops"] = loops.time_all()
        for name, row in summary["hot_loops"].items():
            log(f"[11] hot loop {name}: {json.dumps(row)}")
    finally:
        loops.restore()
    return summary


HEADLINE = dict(n_map=5_000_000, n_scan=65_536, k_frames=32, traj_len=2000.0,
                n_blocks=20480)    # bench.py:62-119


def phase_headline():
    """Phase 12: ``bench.py:62-119``'s headline workload through the port's
    ``block_sweep_discrepancy``: a 5 M-point corridor map (2 km, seed 0), 32
    keyframes x 65 536 points clamped at 120 m, a 20 480 x 256 block map at
    40 m cells, ``k_blocks`` exact at 120.2 m.  One warm-up and three timed
    sweeps (K2 must launch in each); ``removert_visibility_keyframes_per_s_5M_map``
    is 32 over the mean sweep, as bench computes it.  Then the sweep in
    turns through the plain loop and K2 (plain, kernel, kernel, plain), and
    K2's time by CUDA events against its bound."""
    import torch

    from ltm_torch.kernels.blocks import (
        block_sweep_discrepancy,
        block_sweep_discrepancy_plain,
        build_block_map,
        required_k_blocks_np,
    )
    from ltm_torch.kernels.projection import rimg_shape

    dev = torch.device("cuda")
    fov = (50.0, 360.0)
    shape = rimg_shape(fov, 2.5)
    n_map, n_scan, k_frames, traj_len = (HEADLINE[k] for k in ("n_map", "n_scan", "k_frames",
                                                                "traj_len"))
    rng = np.random.default_rng(0)
    along = rng.uniform(0.0, traj_len, n_map).astype(np.float32)
    lat = (rng.normal(size=n_map) * 30).astype(np.float32)
    z = (rng.normal(size=n_map) * 2).astype(np.float32)
    map_xyz = torch.from_numpy(np.stack([along, lat, z], axis=1)).to(dev)
    raw = rng.normal(size=(k_frames, n_scan, 3)).astype(np.float32) * np.array([40, 40, 3],
                                                                               np.float32)
    rr = np.linalg.norm(raw, axis=-1, keepdims=True)
    raw = np.where(rr > 120.0, raw * (120.0 / rr), raw)
    scans = torch.from_numpy(raw).to(dev)
    smask = torch.ones((k_frames, n_scan), dtype=torch.bool, device=dev)
    poses = np.tile(np.eye(4, dtype=np.float32), (k_frames, 1, 1))
    poses[:, 0, 3] = np.linspace(100, traj_len - 100, k_frames)
    pose_inv = torch.from_numpy(np.linalg.inv(poses)).to(dev)
    poses_t = torch.from_numpy(poses).to(dev)
    t0 = time.perf_counter()
    bm, overflow = build_block_map(map_xyz, torch.ones(n_map, dtype=torch.bool, device=dev),
                                   40.0, HEADLINE["n_blocks"], 256)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if overflow:
        raise AssertionError(f"headline block map overflow {overflow}")
    max_range = 120.0 + 0.1 + 0.1
    k_blocks = required_k_blocks_np(bm.centers.cpu().numpy(), bm.radius.cpu().numpy(),
                                    bm.block_valid.cpu().numpy(), poses[:, :3, 3], max_range)
    if k_blocks >= bm.num_blocks:
        raise AssertionError(f"headline k_blocks {k_blocks} culls nothing")

    args = (bm, scans, smask, pose_inv, poses_t, fov, shape)
    kwargs = dict(k_blocks=k_blocks, max_range=max_range, diff_threshold=0.1, reverse=False)

    first = block_sweep_discrepancy(*args, **kwargs)
    flagged = int(first.sum())

    def run(fn=block_sweep_discrepancy):
        """The sweep, synced, held bit for bit to the warm-up's mask:
        (entries that differ, largest absolute difference)."""
        out = fn(*args, **kwargs)
        diff = sweep_diff("headline sweep", out, first)
        torch.cuda.synchronize()
        return diff

    dts = []
    for _ in range(3):
        set_sweep_counts()
        t0 = time.perf_counter()
        if run()[0]:
            raise AssertionError("headline sweep: the mask changed between runs")
        dts.append(time.perf_counter() - t0)
        if sweep_counts()[0] <= 0 or sweep_counts()[2]:
            raise AssertionError(f"headline sweep: K2 launch sets {sweep_counts()} in a timed "
                                 "sweep (the cluster variant must launch)")
    turns = []
    for route in ("plain", "kernel", "kernel", "plain"):
        fn = block_sweep_discrepancy_plain if route == "plain" else block_sweep_discrepancy
        set_sweep_counts()
        t0 = time.perf_counter()
        differ, err = run(fn)
        wall = time.perf_counter() - t0
        if differ:
            raise AssertionError(f"headline sweep ({route}): {differ} entries differ from the "
                                 f"kernel's warm-up mask")
        if (route == "kernel") != (sweep_counts()[0] > 0):
            raise AssertionError(f"headline sweep ({route}): {sweep_counts()[0]} K2 launches")
        turns.append({"route": route, "sweep_s": wall, "keyframes_per_s": k_frames / wall,
                      "differ": differ, "max_abs_err": err})
    set_sweep_counts()
    st = {"removert_visibility_keyframes_per_s_5M_map": k_frames / statistics.mean(dts),
          "sweep_s": dts, "flagged": flagged, "k_blocks": k_blocks,
          "n_blocks": bm.num_blocks, "block_build_s": build_s, "turns": turns,
          "k2": time_sweep("block_sweep_discrepancy", args, kwargs)}
    if not 0 < flagged < n_map:
        raise AssertionError(f"headline sweep flagged {flagged} points")
    log(f"[12] {json.dumps(st)}")
    return st


MESH_SLOTS = 4      # phase 13: slots of the one card in a mesh


def counters():
    """The kernels' launch counters (K4 scans and merges, K1 scans and
    merges), to restore after comparison launches."""
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
    from ltm_torch.kernels.knn2 import knn2_sqdists

    return (chunk_knn_sqdists.launches, chunk_knn_sqdists.merges, knn2_sqdists.launches,
            knn2_sqdists.merges)


def set_counters(values):
    from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
    from ltm_torch.kernels.knn2 import knn2_sqdists

    (chunk_knn_sqdists.launches, chunk_knn_sqdists.merges, knn2_sqdists.launches,
     knn2_sqdists.merges) = values


def masks_equal(tag, masks, want):
    """The 14 named sets of a run equal ``want`` ({name: host array}) bit
    for bit."""
    from ltm_torch.removert.pipeline import MASK_NAMES

    diff = [n for n in MASK_NAMES if not np.array_equal(masks[n].cpu().numpy(), want[n])]
    if diff:
        raise AssertionError(f"{tag}: sets {diff} differ")


def counted_run(rm, inputs):
    """One ``rm.run`` (a main path) with the kernels' launch counts set to 0
    just before it and read just after: (result, stats with the wall and
    the synced stage walls)."""
    import torch

    from ltm_torch.utils import reset_stage_times, stage_times

    reset_stage_times()
    torch.cuda.synchronize()
    set_counters((0, 0, 0, 0))
    t0 = time.perf_counter()
    res = rm.run(*inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, k4m, k1, k1m = counters()
    return res, {"wall_s": wall, "k4_launches": k4, "k4_merge_launches": k4m,
                 "k1_launches": k1, "k1_merge_launches": k1m, "stages_s": stage_times()}


def host_bits(out):
    """The tensors of a result as host arrays, float32 as their bits (NaN
    rows compare)."""
    import torch

    outs = list(out) if isinstance(out, tuple) else [out]
    return [(o.view(torch.int32) if o.dtype == torch.float32 else o).cpu().numpy() for o in outs]


def compare_sharded(name, mesh, sharded, one_device, args, kwargs):
    """A sharded function on ``mesh`` against the one-device function on the
    same inputs on the card: every output the same bits.  Returns the
    shapes, both walls (CUDA events, one call each) and K1's scans in the
    sharded call."""
    import torch

    held = []
    one_ms = cuda_ms(lambda: held.append(one_device(*args, **kwargs)), reps=1)
    before = counters()
    sharded_ms = cuda_ms(lambda: held.append(sharded(mesh, *args, **kwargs)), reps=1)
    torch.cuda.synchronize()
    k1 = counters()[2] - before[2]
    want, got = host_bits(held[0]), host_bits(held[1])
    if len(want) != len(got) or any(w.shape != g.shape or w.dtype != g.dtype or
                                    not np.array_equal(w, g) for w, g in zip(want, got)):
        raise AssertionError(f"mesh {name}: the sharded result differs from the one-device one")
    if all(w.dtype == bool and not w.any() for w in want):
        raise AssertionError(f"mesh {name}: empty result")
    return {"function": name, "shapes": [list(w.shape) for w in want], "one_device_ms": one_ms,
            "sharded_ms": sharded_ms, "k1_launches": k1}


def compare_chunk_sharded(name, mesh, args, kwargs):
    """K4 on the mesh at a main-path call's inputs: the sharded call's rows,
    overflow and order the one-device call's bits; one scan launch a
    non-empty shard, the shards' chunk ranges covering every chunk once;
    the summed counts (work items, block tests, chunks culled; the most
    tests in a chunk the largest) the one-device scan's; and each shard's
    rows and overflow held to ``chunk_knn_sqdists_plain`` at 0 ulps."""
    import torch

    from ltm_torch.dist.removert import chunk_knn_sqdists_sharded
    from ltm_torch.kernels import chunk_knn as ck

    one = ck.chunk_knn_sqdists(*args, **kwargs)
    torch.cuda.synchronize()
    one_counts = kernel_counts()
    shards, scan_range = [], ck.chunk_knn_scan_range

    def recording(prep, c0, c1, *a, **k):
        ov, rows = scan_range(prep, c0, c1, *a, **k)
        shards.append((c0, c1, ov, rows))
        return ov, rows

    before = counters()
    ck.chunk_knn_scan_range = recording
    try:
        got = chunk_knn_sqdists_sharded(mesh, *args, **kwargs)
        torch.cuda.synchronize()
    finally:
        ck.chunk_knn_scan_range = scan_range
    scans = counters()[0] - before[0]
    if any(not np.array_equal(g, w) for g, w in zip(host_bits(tuple(got)), host_bits(tuple(one)))):
        raise AssertionError(f"mesh {name}: sharded K4 differs from the one-device call")
    n_chunks = one.chunk_overflow.shape[0]
    ranges = sorted((c0, c1) for c0, c1, _, _ in shards if c1 > c0)
    if [c0 for c0, _ in ranges] != [0] + [c1 for _, c1 in ranges[:-1]] or ranges[-1][1] != n_chunks:
        raise AssertionError(f"mesh {name}: shard ranges {ranges} do not cover {n_chunks} chunks")
    if scans != len(ranges):
        raise AssertionError(f"mesh {name}: {scans} scans for {len(ranges)} non-empty shards")
    if kernel_counts() != one_counts:
        raise AssertionError(f"mesh {name}: summed counts {kernel_counts()}, one scan's "
                             f"{one_counts}")
    plain = ck.chunk_knn_sqdists_plain(*args, **kwargs)
    sorted_rows = plain.sqdists[plain.order.long()].cpu().numpy()
    over = plain.chunk_overflow.cpu().numpy()
    chunk, n = kwargs["chunk"], args[0].shape[0]
    ulps = 0
    for c0, c1, ov, rows in shards:
        if c1 == c0:
            continue
        m = min(c1 * chunk, n) - c0 * chunk
        ulps = max(ulps, ulps_apart(rows[:m].cpu().numpy(), sorted_rows[c0 * chunk:c0 * chunk + m]))
        if not np.array_equal(ov.cpu().numpy(), over[c0:c1]):
            raise AssertionError(f"mesh {name}: shard [{c0}, {c1}) overflow differs from plain")
    if ulps:
        raise AssertionError(f"mesh {name}: a shard's rows are {ulps} ulps from the plain version")
    return {"case": name, "chunks": n_chunks, "shard_ranges": ranges, "scans": scans,
            "plain_ulps": ulps, "overflowed_chunks": int((over > 0).sum()), **one_counts}


def mesh_sharded_functions(mesh, rm, res, k4_calls):
    """Phase 13a: every sharded function of the slice on ``mesh`` at phase
    5's shapes (the sessions of the mesh run ``res``, the budgets ``rm``
    computed), each against its one-device function on the card; then
    each K4 call of the mesh run (``compare_chunk_sharded``).  Comparison
    launches do not count: the counters are restored."""
    from ltm_torch.dist import removert as dr
    from ltm_torch.dist import sharding as ds
    from ltm_torch.kernels import blocks as kb_mod
    from ltm_torch.kernels import knn
    from ltm_torch.kernels import projection as pj

    cfg = rm.cfg
    fov = (cfg.vfov, cfg.hfov)
    shape_r = pj.rimg_shape(fov, cfg.remove_resolution_list[0])
    shape_f = pj.rimg_shape(fov, cfg.nd_pd_filter_resolution)
    proj = pj.rimg_shape(fov, cfg.reprojection_alpha)
    c, q = res.central, res.query
    K = c.num_keyframes
    pinv, poses = c.poses_inv[:K], c.poses[:K]
    static = c.masks["static"]
    kb_f, mr_f = rm._kb(c.bm, rm._fwd_bound(c))
    kb_v, mr_v = rm._kb(c.bm, rm._vis_bound(c))
    kb_t, mr_t = rm._kb(q.bm, rm._vis_bound(c))
    scale = rm._pack_scale(c)
    imgs = pj.fused_visibility_images(c.map_xyz, static, pinv, fov, shape_f, proj, scale)[1]
    scans = (c.scans_xyz[:K], c.scans_mask[:K])
    bm_f = c.bm._replace(mask=c.map_mask.reshape(c.bm.mask.shape))
    cases = [
        ("block_sweep_discrepancy", dr.block_sweep_discrepancy_sharded,
         kb_mod.block_sweep_discrepancy, (bm_f, *scans, pinv, poses, fov, shape_r),
         dict(k_blocks=kb_f, max_range=mr_f, diff_threshold=cfg.diff_threshold)),
        ("block_sweep_visibility", dr.block_sweep_visibility_sharded,
         kb_mod.block_sweep_visibility, (c.bm, static, pinv, poses, fov, proj),
         dict(k_blocks=kb_v, max_range=mr_v)),
        ("block_projected_scan_images", dr.block_projected_scan_images_sharded,
         kb_mod.block_projected_scan_images, (c.bm, static, pinv, poses, fov, shape_f, proj),
         dict(k_blocks=kb_v, max_range=mr_v)),
        ("block_fused_visibility_images", dr.block_fused_visibility_images_sharded,
         kb_mod.block_fused_visibility_images, (c.bm, static, pinv, poses, fov, shape_f, proj),
         dict(k_blocks=kb_v, max_range=mr_v, scale=scale)),
        ("block_sweep_discrepancy_vs_images", dr.block_sweep_discrepancy_vs_images_sharded,
         kb_mod.block_sweep_discrepancy_vs_images,
         (q.bm, q.masks["static"], imgs, pinv, poses, fov, shape_f),
         dict(k_blocks=kb_t, max_range=mr_t, diff_threshold=cfg.diff_threshold)),
        ("sweep_visibility", dr.sweep_visibility_sharded, pj.sweep_visibility,
         (c.map_xyz, static, pinv, fov, proj), {}),
        ("projected_scan_images", dr.projected_scan_images_sharded, pj.projected_scan_images,
         (c.map_xyz, static, pinv, fov, shape_f, proj), {}),
        ("fused_visibility_images", dr.fused_visibility_images_sharded,
         pj.fused_visibility_images, (c.map_xyz, static, pinv, fov, shape_f, proj),
         dict(scale=scale)),
        ("sweep_discrepancy_vs_images", dr.sweep_discrepancy_vs_images_sharded,
         pj.sweep_discrepancy_vs_images, (q.map_xyz, q.masks["static"], imgs, pinv, fov, shape_f),
         dict(diff_threshold=cfg.diff_threshold, reverse=True)),
        ("sweep_discrepancy", ds.sweep_discrepancy_sharded, pj.sweep_discrepancy,
         (c.map_xyz, c.map_mask, *scans, pinv, fov, shape_r),
         dict(diff_threshold=cfg.diff_threshold)),
        ("sweep_discrepancy_map", ds.sweep_discrepancy_map_sharded, pj.sweep_discrepancy,
         (c.map_xyz, c.map_mask, *scans, pinv, fov, shape_r),
         dict(diff_threshold=cfg.diff_threshold)),
        ("knn_avg_sqdist", ds.knn_avg_sqdist_sharded, knn.knn_avg_sqdist,
         (c.map_xyz, static & c.masks["proj_static"], q.map_xyz, q.masks["static"]), {}),
    ]
    saved = counters()
    try:
        out = []
        for name, sharded, one_device, args, kwargs in cases:
            st = compare_sharded(name, mesh, sharded, one_device, args, kwargs)
            if name == "knn_avg_sqdist":
                qm = args[1]
                per = -(-qm.shape[0] // mesh.size)
                want = sum(bool(qm[i * per:(i + 1) * per].any()) for i in range(mesh.size))
                if st["k1_launches"] != want:
                    raise AssertionError(f"mesh knn_avg_sqdist: {st['k1_launches']} K1 scans, "
                                         f"{want} shards hold queries")
            out.append(st)
            log(f"[13a] {json.dumps(st)}")
        for name, args, kwargs in k4_calls:
            st = compare_chunk_sharded(name, mesh, args, kwargs)
            out.append(st)
            log(f"[13a] {json.dumps(st)}")
    finally:
        set_counters(saved)
    return out


def mesh_k1_shards(k1_calls):
    """Phase 13a: each K1 call of the brute mesh run (one a shard that holds
    queries, at the shard's queries and the whole target map) replayed
    against ``knn2_sqdists_plain`` on the same inputs: 0 ulps, and one scan
    launch where both sides hold a valid point.  The counters are restored."""
    saved = counters()
    try:
        out = []
        for i, (q, qm, t, tm) in enumerate(k1_calls):
            launches = int(bool(qm.any()) and bool(tm.any()))
            st = {**compare_knn2(f"mesh_brute_shard_{i}", q, qm, t, tm, launches=launches),
                  "launches": launches}
            out.append(st)
            log(f"[13a] K1 shard vs plain: {json.dumps(st)}")
    finally:
        set_counters(saved)
    return out


def phase_mesh(cfg=None, brute_masks=None, phase5_run=None, lifelong_in=None):
    """Phase 13: LT-removert on a mesh of ``MESH_SLOTS`` slots of the one
    card (``make_mesh([cuda:0] * 4)`` assigned to ``Removerter.mesh``).
    (b) ``Removerter.run`` on phase 5's workload on the mesh: a run that
    records its K4 calls, then a counted run (its 14 sets equal phase 4's,
    as phase 5's do; its wall and stage walls beside phase 5's), and a
    counted run with ``use_chunk_knn=False`` (K1 a shard; the same sets)
    that records each shard's K1 call.  (a) every sharded function at
    those shapes against its one-device function, bit for bit, each
    recorded K4 call shard by shard (scans counted, ranges covering every
    chunk once, counts summed, rows 0 ulps from the plain version), and
    each recorded K1 shard against ``knn2_sqdists_plain`` (0 ulps).  (c) the whole-map path on phase 3's workload:
    mesh against one device on the card, bit for bit, then card against CPU
    under phase 3's rule.  (d) a one-process NCCL group
    (``initialize_multihost``) and (b)'s default run on 2 slots through it.
    (e) phase 10's cut chain on a 2-slot mesh: each round's nd, pd and
    updated sets the one-device chain's, K4 launched.  Without phase 4's
    masks (a call of this phase alone) one one-device run of phase 5 gives
    them."""
    import socket

    import torch
    import torch.distributed as dist

    import ltm_torch.kernels.knn as knn_mod
    import ltm_torch.ltmap.lifelong as ll
    import ltm_torch.removert.pipeline as pipe
    from ltm_torch.core.config import RemovertConfig
    from ltm_torch.dist import initialize_multihost, make_mesh
    from ltm_torch.dist.removert import chunk_knn_sqdists_sharded
    from ltm_torch.kernels.knn2 import knn2_sqdists
    from ltm_torch.removert import Removerter, RemovertInput

    os.environ["LTM_SYNC_STAGES"] = "1"
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    if cfg is None:
        cfg = RemovertConfig(downsample_voxel_size=0.1)
    full = workload(*FULL_WIDTH)
    if brute_masks is None:
        res, phase5_run = counted_run(Removerter(cfg, device=dev), full)
        brute_masks = {n: m.cpu().numpy() for n, m in res.masks.items()}
    mesh = make_mesh([dev] * MESH_SLOTS)

    # (b) the driver on the mesh, recording its K4 calls in the first run
    rm = Removerter(cfg, device=dev)
    rm.mesh = mesh
    calls = []
    rec = chunk_recorder(cfg, calls, "mesh",
                         run=lambda *a, **k: chunk_knn_sqdists_sharded(mesh, *a, **k))
    pipe.chunk_knn_sqdists_sharded = lambda _mesh, *a, **k: rec(*a, **k)
    saved = counters()
    try:
        masks_equal("mesh, recording run", rm.run(*full).masks, brute_masks)
    finally:
        pipe.chunk_knn_sqdists_sharded = chunk_knn_sqdists_sharded
        set_counters(saved)
    res, run_b = counted_run(rm, full)
    masks_equal("mesh, default configuration", res.masks, brute_masks)
    brute = Removerter(dataclasses.replace(cfg, use_chunk_knn=False), device=dev)
    brute.mesh = mesh
    k1_calls = []

    def recording(*args):       # one call a shard: knn_avg_sqdist's K1 call
        k1_calls.append(args)
        return knn2_sqdists(*args)

    knn_mod.knn2_sqdists = recording
    try:
        res_k1, run_k1 = counted_run(brute, full)
    finally:
        knn_mod.knn2_sqdists = knn2_sqdists
    masks_equal("mesh, use_chunk_knn=False", res_k1.masks, brute_masks)
    if run_b["k4_launches"] <= 0 or run_k1["k1_launches"] <= 0:
        raise AssertionError(f"mesh runs launched K4 {run_b['k4_launches']} and K1 "
                             f"{run_k1['k1_launches']} times; both must run")

    # (a) the sharded functions, K4 shard by shard at the run's calls, and
    # each K1 shard of the brute run against the plain version
    functions = mesh_sharded_functions(mesh, rm, res, calls)
    want_k4 = sum(st["scans"] for st in functions if "scans" in st)
    if run_b["k4_launches"] != want_k4:
        raise AssertionError(f"mesh run: {run_b['k4_launches']} K4 scans, its calls' shards "
                             f"make {want_k4}")
    k1_shards = mesh_k1_shards(k1_calls)
    if sum(st["launches"] for st in k1_shards) != run_k1["k1_launches"]:
        raise AssertionError(f"mesh brute run: {run_k1['k1_launches']} K1 scans, its shards' "
                             f"calls make {sum(st['launches'] for st in k1_shards)}")
    del k1_calls

    # (c) the whole-map path on phase 3's workload
    small = workload(4, 6000, 300.0)
    flat = dataclasses.replace(cfg, use_block_map=False)
    one_flat = Removerter(flat, device=dev).run(*small)
    mesh_flat = Removerter(flat, device=dev)
    mesh_flat.mesh = mesh
    res_flat, run_c = counted_run(mesh_flat, small)
    masks_equal("mesh, whole-map path", res_flat.masks,
                {n: m.cpu().numpy() for n, m in one_flat.masks.items()})
    cpu_flat = Removerter(flat, device="cpu").run(*small)
    flat_vs_cpu = check_sets("mesh whole-map path, card vs CPU", cpu_flat, res_flat)

    # (d) a one-process NCCL group under the mesh's collectives
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if not initialize_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                                process_id=0, device=dev):
        raise AssertionError("initialize_multihost started no group")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the CUDA group runs {dist.get_backend()}, not nccl")
        rm.mesh = make_mesh([dev] * 2)
        if rm.mesh.group is None:
            raise AssertionError("a mesh built after initialize_multihost has no group")
        res_d, run_d = counted_run(rm, full)
        masks_equal("mesh through NCCL", res_d.masks, brute_masks)
    finally:
        dist.destroy_process_group()

    # (e) the lifelong chain, cut, on a 2-slot mesh
    inputs = lifelong_in if lifelong_in is not None else lifelong_inputs()
    n_sess, kf = LIFELONG_CUT
    cut = [RemovertInput(scans=s.scans[:kf], poses=s.poses[:kf]) for s in inputs[:n_sess]]
    cfg_l = lifelong_config()
    one_chain = ll.lifelong_update(cut, cfg_l, device=dev)

    class OnMesh(Removerter):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.mesh = make_mesh([dev] * 2)

    ll.Removerter = OnMesh
    set_counters((0, 0, 0, 0))
    try:
        t0 = time.perf_counter()
        mesh_chain = ll.lifelong_update(cut, cfg_l, device=dev)
        chain_s = time.perf_counter() - t0
    finally:
        ll.Removerter = Removerter
    chain_k4 = counters()[0]
    if chain_k4 <= 0:
        raise AssertionError("mesh chain: no K4 scan launched")
    for i, (a, b) in enumerate(zip(one_chain.rounds, mesh_chain.rounds, strict=True), start=2):
        for name in ("nd", "pd", "updated"):
            if not torch.equal(a.masks[name], b.masks[name]):
                raise AssertionError(f"mesh chain round {i}: set {name} differs")

    summary = {
        "slots": MESH_SLOTS, "card": card_line(),
        "default": {**run_b, "sets_equal_phase_4": True},
        "phase5": ({k: phase5_run[k] for k in ("wall_s", "stages_s")}
                   if phase5_run else "not run"),
        "brute": {**run_k1, "sets_equal_phase_4": True, "k1_shards_vs_plain": k1_shards},
        "sharded_functions": functions,
        "flat": {"mesh_wall_s": run_c["wall_s"], "k1_launches": run_c["k1_launches"],
                 "card_vs_cpu": flat_vs_cpu},
        "nccl": {"slots": 2, "wall_s": run_d["wall_s"], "k4_launches": run_d["k4_launches"]},
        "lifelong_cut": {"sessions": n_sess, "keyframes": kf, "slots": 2, "mesh_chain_s": chain_s,
                         "k4_launches": chain_k4, "round_stats": mesh_chain.round_stats},
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"[13] {json.dumps(summary)}")
    return summary


SOLVE_GATE = dict(pose_log=1e-3, cost_rtol=0.05)   # tests/test_dist.py:76-80 (ltm's mesh bounds)
ICP_FITNESS_RTOL = 1e-3                             # tests/test_dist.py:229


def counted_collectives(fn):
    """(fn's result, {collective: calls}) with the sharded solver's
    ``concat`` and ``reduce_sum`` counted."""
    from ltm_torch.dist import solver as dsolver

    counts = {"concat": 0, "reduce_sum": 0}
    saved = {name: getattr(dsolver, name) for name in counts}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in counts:
        setattr(dsolver, name, counting(name))
    try:
        return fn(), counts
    finally:
        for name, f in saved.items():
            setattr(dsolver, name, f)


def timed_solve(fn):
    """(poses, SolveInfo, seconds) of a solve on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, info = fn()
    torch.cuda.synchronize()
    return poses, info, time.perf_counter() - t0


def pose_log_gap(a, b) -> float:
    from ltm_torch.core import se3

    return float(se3.log(se3.between(a, b)).abs().max())


def fixed_step_pair(g, mesh, cfg, one):
    """The one-device solve and the schur-mode mesh solve of ``g``, each
    driven the one-device solve's number of LM steps (``one``'s
    ``iterations``) through its step function (``graph/solver.py::_lm_step``,
    ``dist/solver.py::_lm_step_schur``) in a loop of this script's own, so
    neither stops where its host stall exit would: the largest |se3
    log(between)| of the two and both costs; the one-device loop must give
    ``one``'s poses bit for bit (the same steps)."""
    import functools

    import torch

    from ltm_torch.dist import solver as dsolver
    from ltm_torch.graph import solver

    steps = one[1].iterations

    def drive(step, poses, cost):
        lam = torch.full((), cfg.lambda_init, dtype=poses.dtype, device=poses.device)
        for _ in range(steps):
            poses, lam, cost, _, _ = step(poses, lam, cost)
        return poses, cost

    chains = solver._chains(g)
    one_poses, one_cost = drive(lambda p, lam, c: solver._lm_step(g, p, lam, c, cfg, chains),
                                g.poses0, solver._cost(g, g.poses0, cfg.cauchy_k))
    gp = dsolver.pad_graph_for_mesh(g, mesh.size)
    lead = dsolver._on(gp, mesh.lead)
    slots = dsolver._slot_graphs(gp, mesh)
    step = functools.partial(dsolver._lm_step_schur, lead, slots, mesh, solver._chains(lead), cfg)
    mesh_poses, mesh_cost = drive(step, lead.poses0,
                                  dsolver._mesh_cost(slots, mesh, lead.poses0, cfg.cauchy_k))
    st = {"lm_steps": steps, "max_pose_log": pose_log_gap(one_poses, mesh_poses),
          "cost_final": [float(one_cost), float(mesh_cost)],
          "one_device_equals_solve": torch.equal(one_poses, one[0])}
    if not st["one_device_equals_solve"]:
        raise AssertionError(f"{steps} one-device LM steps differ from the solve's: {st}")
    return st


def solve_pair(tag, g, mesh, cfg, one, pose_gate=True):
    """``solve_sharded`` on ``mesh`` against ``one``, the one-device
    ``timed_solve`` of the same graph: both walls, LM steps and CG
    residuals, the largest |se3 log(between)|, held to ``SOLVE_GATE`` (the
    final cost only, with ``pose_gate=False``); the sharded run's
    collectives, the sharded solve once more against itself (its repeat)
    and, in schur mode, both at the one-device solve's number of LM steps
    (``fixed_step_pair``; logged, not gated)."""
    from ltm_torch.dist import solve_sharded

    (poses, info, secs), colls = counted_collectives(
        lambda: timed_solve(lambda: solve_sharded(g, mesh, cfg)))
    again = solve_sharded(g, mesh, cfg)[0]
    one_poses, info_one, one_s = one
    err = pose_log_gap(one_poses, poses)
    cost, cost_one = float(info.cost_final), float(info_one.cost_final)
    st = {"mode": cfg.dist_mode, "vars": g.num_vars, "one_device_s": one_s, "sharded_s": secs,
          "lm_steps": [info_one.iterations, info.iterations],
          "cg_residual": [float(info_one.cg_residual), float(info.cg_residual)],
          "cost_final": [cost_one, cost], "max_pose_log": err, "pose_gated": pose_gate,
          "repeat_max_pose_log": pose_log_gap(poses, again), "collectives": colls}
    if cfg.dist_mode == "schur":        # beside the gate, at one fixed number of LM steps
        st["fixed_steps"] = fixed_step_pair(g, mesh, cfg, one)
    log(f"[14a] solve_sharded {tag}: {json.dumps(st)}")
    if not ((err < SOLVE_GATE["pose_log"] or not pose_gate)
            and abs(cost - cost_one) <= SOLVE_GATE["cost_rtol"] * abs(cost_one)):
        raise AssertionError(f"mesh solve {tag}: {json.dumps(st)}")
    return st


def solver_pairs(tag, g, mesh, modes, pose_gate=("schur", "allreduce")):
    """The one-device solve run twice, which must give the same bits (its
    scatter-sums take a fixed order), then ``solve_pair`` in each mode
    ({mode: SolverConfig}) against it, the poses gated in the modes
    ``pose_gate`` names."""
    import torch

    from ltm_torch.graph import solve

    cfg = next(iter(modes.values()))
    one = timed_solve(lambda: solve(g, cfg))
    again = timed_solve(lambda: solve(g, cfg))
    rep = {"lm_steps": [one[1].iterations, again[1].iterations],
           "max_pose_log": pose_log_gap(one[0], again[0]),
           "bit_equal": torch.equal(one[0], again[0]), "walls_s": [one[2], again[2]]}
    log(f"[14a] one-device solve of {tag}, twice: {json.dumps(rep)}")
    if not rep["bit_equal"] or rep["lm_steps"][0] != rep["lm_steps"][1]:
        raise AssertionError(f"the one-device solve of {tag} does not repeat: {json.dumps(rep)}")
    out = {mode: solve_pair(f"{mode}, {tag}", g, mesh, m, one, mode in pose_gate)
           for mode, m in modes.items()}
    out["one_device_repeat"] = rep
    return out


def collectives_per_step(g, mesh, cfg, iterations=(5, 20)):
    """Collectives of one LM step (``cg_tol`` 0: CG runs every iteration
    it may; PCG eager, so each iteration's calls are seen, where a graph
    replay repeats the captured ones) at two ``cg_iterations``: the schur
    step's count must not grow, the all-reduce step's grows by one an
    iteration."""
    from ltm_torch.dist import solve_sharded
    from ltm_torch.graph import solver

    out = {}
    solver.CUDA_GRAPHS = False
    try:
        for it in iterations:
            one_step = dataclasses.replace(cfg, max_outer_iterations=1, cg_iterations=it,
                                           cg_tol=0.0)
            _, counts = counted_collectives(lambda: solve_sharded(g, mesh, one_step))
            counts["reduce_sum"] -= 1                        # the initial cost
            out[it] = counts
    finally:
        solver.CUDA_GRAPHS = True
    a, b = (out[it] for it in iterations)
    want = 0 if cfg.dist_mode == "schur" else iterations[1] - iterations[0]
    if b["reduce_sum"] - a["reduce_sum"] != want or a["concat"] != b["concat"]:
        raise AssertionError(f"{cfg.dist_mode}: collectives a step {out}")
    return out


def record_icp_chunk(bundle, mesh):
    """(slam, result, run stats, (args, kwargs) of the first ICP chunk)
    of ``LTSlam.run`` on ``mesh``: the chunk is the first call of the
    pipeline's ``icp_batch_sharded``."""
    import ltm_torch.slam.pipeline as pipe
    from ltm_torch.core.config import LTSlamConfig
    from ltm_torch.dist.sharding import icp_batch_sharded

    chunk = []

    def recording(m, *args, **kwargs):
        if not chunk:
            chunk.append((args, kwargs))
        return icp_batch_sharded(m, *args, **kwargs)

    pipe.icp_batch_sharded = recording
    try:
        slam, res, run = slam_run(LTSlamConfig(), bundle, mesh=mesh)
    finally:
        pipe.icp_batch_sharded = icp_batch_sharded
    return slam, res, run, chunk[0]


def icp_lane_ops(args, kwargs):
    """Which op of one ICP iteration gives lane 0 other bits inside its
    batch than alone: each op of ``register.icp._iterate`` (the pose
    transform, the 1-NN and its tile GEMM, the Umeyama sums and
    cross-covariance, the rotation, the MSE sums) and the fitness, fed the
    whole chunk's inputs at the first iteration, then the same inputs cut
    to lane 0 and to lanes 0-1 (a shard's batch).  {op: {"alone": entries
    of lane 0 that differ, "pair": ...}}."""
    import torch

    from ltm_torch.core import se3
    from ltm_torch.kernels.knn import _bbox_mid, nn_sqdist_argmin
    from ltm_torch.register import icp as I

    src, sm, tgt, tm, init = args[:5]
    tile = kwargs.get("tile", 4096)
    max_d2 = I._max_d2(kwargs["max_correspondence_distance"], kwargs.get("update_trim_distance"))
    moved = se3.transform_points(init, src)
    d2, idx = nn_sqdist_argmin(moved, sm, tgt, tm, tile=tile)
    w = (sm & (d2 <= max_d2)).to(src.dtype)
    dst = torch.gather(tgt, -2, idx[..., None].expand(idx.shape + (3,)))
    ws = w[..., None]
    wsum = torch.clamp(torch.sum(w, -1), min=1e-12)[..., None]
    cs = torch.sum(moved * ws, -2) / wsum
    cd = torch.sum(dst * ws, -2) / wsum
    a_c = (moved - cs[..., None, :]) * ws
    d_c = dst - cd[..., None, :]
    H = torch.matmul(a_c.transpose(-1, -2), d_c)

    def tile_gemm(q, t):
        mid = _bbox_mid(t, torch.ones_like(t[..., 0], dtype=torch.bool))[..., None, :]
        qc, tc = q - mid, t[..., :tile, :] - mid
        s2 = torch.sum(qc * qc, -1)[..., None] + torch.sum(tc * tc, -1)[..., None, :]
        return torch.baddbmm(s2, qc, tc.transpose(-1, -2), alpha=-2.0)

    ops = {
        "transform_points": (lambda T, p: se3.transform_points(T, p), (init, src)),
        "tile_gemm (baddbmm)": (tile_gemm, (moved, tgt)),
        "nn_sqdist_argmin": (lambda *a: torch.cat([x.float()[..., None] for x in
                                                    nn_sqdist_argmin(*a, tile=tile)], -1),
                             (moved, sm, tgt, tm)),
        "sum_w": (lambda x: torch.sum(x, -1), (w,)),
        "sum_src_w": (lambda x, y: torch.sum(x * y, -2), (moved, ws)),
        "sum_dst_w": (lambda x, y: torch.sum(x * y, -2), (dst, ws)),
        "cross_cov, one batched matmul": (lambda x, y: torch.matmul(x.transpose(-1, -2), y),
                                          (a_c, d_c)),
        "cross_cov (icp._cross_covariance)": (I._cross_covariance, (a_c, d_c)),
        "opt_rotation": (I._opt_rotation, (H,)),
        "umeyama": (I._umeyama_rigid, (moved, dst, w)),
        "pose update, one batched matmul": (torch.matmul, (init, init)),
        "pose update (icp._lane_matmul)": (I._lane_matmul, (init, init)),
        "mse_sums": (lambda x, y: torch.sum(x * y, -1), (w, d2)),
        "mse_sums (icp._lane_sum)": (lambda x, y: I._lane_sum(x * y, -1), (w, d2)),
        "fitness_score": (lambda *a: I.fitness_score(*a, tile=tile), (src, sm, tgt, tm, init)),
    }
    out = {}
    for name, (fn, xs) in ops.items():
        whole = fn(*xs)[0]
        row = {}
        for tag, n in (("alone", 1), ("pair", 2)):
            part = fn(*(x[:n] for x in xs))[0]
            ne = whole != part
            row[tag] = int(ne.sum())
            if row[tag]:
                row[tag + "_max_abs"] = float((whole.double() - part.double()).abs().max())
        out[name] = row
    torch.cuda.synchronize()
    return out


ICP_BATCH_GATE = 1e-4     # transform entries, one ICP lane in batches of other shapes


def icp_pair(mesh, args, kwargs):
    """``icp_batch_sharded`` on a chunk of ICP lanes against the one-device
    ``icp_batch``: on each shard's lanes bit for bit (what the sharding
    itself may change), and on the whole chunk with the fitness within
    ``ICP_FITNESS_RTOL``; a lane's result must not depend on its batch:
    the whole chunk, one lane a call and the shards give transforms within
    ``ICP_BATCH_GATE`` and the same iteration counts (bit-equal
    transforms are reported); both walls, and which op of an iteration
    gives a lane other bits alone than in the chunk (``icp_lane_ops``)."""
    import torch

    from ltm_torch.dist.mesh import local_shards
    from ltm_torch.dist.sharding import icp_batch_sharded
    from ltm_torch.register.icp import ICPResult, icp_batch

    held = []
    one_ms = cuda_ms(lambda: held.append(icp_batch(*args, **kwargs)), reps=1)
    ms = cuda_ms(lambda: held.append(icp_batch_sharded(mesh, *args, **kwargs)), reps=1)
    one, got = held
    b = args[0].shape[0]
    pad = (-b) % mesh.size
    lanes = [torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))]) for t in args]
    shards = [icp_batch(*(t[a:e] for t in lanes), **kwargs)
              for _, a, e in local_shards(mesh, b + pad)]
    per_shard = ICPResult(*(torch.cat(f)[:b] for f in zip(*shards)))
    singles = ICPResult(*(torch.cat(f) for f in zip(*(
        icp_batch(*(t[i:i + 1] for t in args), **kwargs) for i in range(b)))))
    st = {"lanes": b, "one_device_ms": one_ms, "sharded_ms": ms,
          "per_shard_bit_equal": all(torch.equal(x, y) for x, y in zip(got, per_shard)),
          "max_fitness_rel_err": float(((one.fitness - got.fitness).abs()
                                        / one.fitness.abs().clamp(min=1e-30)).max()),
          "max_transform_gap_whole_chunk": float((one.transform - got.transform).abs().max()),
          "one_device_lane_a_call_transform_gap":
              float((one.transform - singles.transform).abs().max()),
          "iterations": {"whole_chunk": one.iterations.tolist(), "sharded": got.iterations.tolist(),
                         "lane_a_call": singles.iterations.tolist()}}
    st["bit_equal"] = {"whole_chunk_vs_sharded": torch.equal(one.transform, got.transform),
                       "whole_chunk_vs_lane_a_call": torch.equal(one.transform,
                                                                 singles.transform)}
    st["lane_ops_alone_vs_chunk"] = icp_lane_ops(args, kwargs)
    log(f"[14a] icp_batch_sharded: {json.dumps(st)}")
    its = st["iterations"]
    if (not st["per_shard_bit_equal"] or st["max_fitness_rel_err"] > ICP_FITNESS_RTOL
            or st["max_transform_gap_whole_chunk"] > ICP_BATCH_GATE
            or st["one_device_lane_a_call_transform_gap"] > ICP_BATCH_GATE
            or its["whole_chunk"] != its["sharded"] or its["whole_chunk"] != its["lane_a_call"]):
        raise AssertionError(f"icp_batch_sharded: {json.dumps(st)}")
    return st


def phase_slam_mesh(full=None):
    """Phase 14: LT-SLAM on a mesh of ``MESH_SLOTS`` slots of the one card
    (``make_mesh([cuda:0] * 4)`` assigned to ``LTSlam.mesh``).  (b)
    ``LTSlam.run`` at phase 8's full width on the mesh (schur), one run
    that records its first ICP chunk: the accepted SC loop set of phase
    8's one-device run, central poses within 0.01 m of it, ATE ≤
    ``ATE_BOUND``; its wall and stage walls beside phase 8's.  (a) each
    sharded function at those shapes against its one-device function:
    ``sc_distance_sharded`` on the 500 × 500 descriptors (distance within
    1e-5, shifts equal), ``icp_batch_sharded`` on the recorded chunk
    (``icp_pair``: a lane's result independent of its batch),
    ``solve_sharded`` in both modes on phase 8's final graph and on phase
    7's ((c)'s card run), each against the one-device solve, which must
    repeat bit for bit (``solver_pairs``: the final cost on both graphs,
    the poses on both in schur mode and on phase 7's in all-reduce mode,
    whose reduced sums move phase 8's poses past the gate), and the
    collectives an LM step at two ``cg_iterations``.  (c) phase 7's cut workload on 4 slots, card
    against CPU under phase 7's rule.  (d) a one-process NCCL group:
    ``solve_sharded`` on 2 slots through it equals the same call without a
    group bit for bit on phase 7's graph.  ``full`` is
    phase 8's reference run; without it (a call of this phase alone) one
    one-device run gives it."""
    import socket

    import torch
    import torch.distributed as dist

    from ltm_torch.core.config import LTSlamConfig
    from ltm_torch.dist import Mesh, initialize_multihost, make_mesh, solve_sharded
    from ltm_torch.dist.sharding import sc_distance_sharded
    from ltm_torch.io.synthetic import make_two_sessions
    from ltm_torch.retrieval.scancontext import sc_distance_matrix
    from ltm_torch.slam import LTSlam

    os.environ["LTM_SYNC_STAGES"] = "1"
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    if full is None:
        bundle = make_two_sessions(odom_noise=5e-4, **SLAM_WIDTH)
        slam, res, stats = slam_run(LTSlamConfig(), bundle)
        full = {"slam": slam, "res": res, "stats": stats, "bundle": bundle}
    bundle = full["bundle"]
    mesh = make_mesh([dev] * MESH_SLOTS)

    # (b) LTSlam.run on the mesh, recording its first ICP chunk
    slam, res, run_b, chunk = record_icp_chunk(bundle, mesh)
    one_slam, one_res = full["slam"], full["res"]
    dmax = max(float(np.abs(res.central_poses[n][:, :3, 3]
                            - one_res.central_poses[n][:, :3, 3]).max()) for n in res.central_poses)
    log(f"[14b] {json.dumps(run_b)}; central poses {dmax} m from phase 8's")
    if loop_set(slam) != loop_set(one_slam) or not loop_set(slam):
        raise AssertionError(f"mesh run: {len(loop_set(slam))} loops, phase 8 "
                             f"{len(loop_set(one_slam))}; the sets differ")
    if dmax > 0.01 or run_b["ate_rmse_m"] > ATE_BOUND:
        raise AssertionError(f"mesh run: central poses {dmax} m from phase 8's, "
                             f"ATE {run_b['ate_rmse_m']} m")

    # (a) each sharded function against its one-device function
    sc_cfg = slam.cfg.scan_context
    sc_kw = dict(full_shift_search=sc_cfg.full_shift_search, search_ratio=sc_cfg.search_ratio)
    qd, td = slam.sessions[1].descriptors, slam.sessions[0].descriptors
    held = []
    sc_one_ms = cuda_ms(lambda: held.append(sc_distance_matrix(qd, td, **sc_kw)), reps=3)
    sc_ms = cuda_ms(lambda: held.append(sc_distance_sharded(mesh, qd, td, **sc_kw)), reps=3)
    (d1, s1), (d2, s2) = held[0], held[-1]
    sc = {"shape": [qd.shape[0], td.shape[0]], "one_device_ms": sc_one_ms, "sharded_ms": sc_ms,
          "max_abs_err": float((d1 - d2).abs().max()), "shifts_differ": int((s1 != s2).sum())}
    log(f"[14a] sc_distance_sharded: {json.dumps(sc)}")
    if sc["max_abs_err"] > 1e-5 or sc["shifts_differ"]:
        raise AssertionError(f"sc_distance_sharded: {json.dumps(sc)}")
    icp = icp_pair(mesh, *chunk)
    # the solver at full width: the one-device solve twice, then both modes
    # against it
    g = one_slam._last_graph
    solver_cfg = LTSlamConfig().solver
    modes = {mode: dataclasses.replace(solver_cfg, dist_mode=mode)
             for mode in ("schur", "allreduce")}
    # the all-reduce mode's sums (gradient, preconditioner, every CG
    # product) reduce over the slots in another order than one device's:
    # on phase 8's graph its poses land ~3e-3 from the one-device solve's
    # (an LM step more), so there its cost is gated, and its poses on phase
    # 7's graph
    solves = {"phase8_graph": solver_pairs("phase 8's graph", g, mesh, modes,
                                           pose_gate=("schur",))}
    for mode, cfg in modes.items():
        solves[mode + "_collectives_per_step"] = collectives_per_step(g, mesh, cfg)

    # (c) phase 7's cut workload on 4 slots, card against CPU
    cut = cut_bundle(bundle, *SLAM_CUT)
    cut_runs = {}
    for where in ("cpu", "cuda"):
        t0 = time.perf_counter()
        s_c = LTSlam(LTSlamConfig(), device=where)
        s_c.mesh = make_mesh([torch.device(where)] * MESH_SLOTS)
        r_c = s_c.run(cut["central"].data, cut["query"].data)
        cut_runs[where] = (s_c, r_c, time.perf_counter() - t0)
    (s_cpu, r_cpu, t_cpu), (s_gpu, r_gpu, t_gpu) = cut_runs["cpu"], cut_runs["cuda"]
    cut_d = max(float(np.abs(r_cpu.central_poses[n][:, :3, 3]
                             - r_gpu.central_poses[n][:, :3, 3]).max()) for n in r_cpu.central_poses)
    cut_st = {"keyframes": list(SLAM_CUT), "slots": MESH_SLOTS, "loops": len(loop_set(s_gpu)),
              "max_central_pose_diff_m": cut_d, "cpu_s": t_cpu, "cuda_s": t_gpu}
    log(f"[14c] {json.dumps(cut_st)}")
    if loop_set(s_cpu) != loop_set(s_gpu) or not loop_set(s_gpu) or cut_d > 0.01:
        raise AssertionError(f"mesh cut, card vs CPU: loops {len(loop_set(s_cpu))} / "
                             f"{len(loop_set(s_gpu))}, central poses {cut_d} m apart")
    # the solver on phase 7's graph (the card's cut run), poses gated
    solves["phase7_graph"] = solver_pairs("phase 7's graph", s_gpu._last_graph, mesh, modes)
    functions = {"sc_distance_sharded": sc, "icp_batch_sharded": icp, "solve_sharded": solves}

    # (d) a one-process NCCL group under the solver's collectives (phase 7's graph)
    g = s_gpu._last_graph
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    want, _ = solve_sharded(g, Mesh((dev, dev)), solver_cfg)
    if not initialize_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                                process_id=0, device=dev):
        raise AssertionError("initialize_multihost started no group")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the CUDA group runs {dist.get_backend()}, not nccl")
        grouped = make_mesh([dev] * 2)
        if grouped.group is None:
            raise AssertionError("a mesh built after initialize_multihost has no group")
        got, info, nccl_s = timed_solve(lambda: solve_sharded(g, grouped, solver_cfg))
    finally:
        dist.destroy_process_group()
    if not torch.equal(got, want):
        raise AssertionError(f"solve_sharded through NCCL differs from the same call without a "
                             f"group by {float((got - want).abs().max())}")

    summary = {
        "slots": MESH_SLOTS, "card": card_line(),
        "run": {k: run_b[k] for k in ("wall_s", "keyframes_per_s", "ate_rmse_m", "sc_loops",
                                      "icp_pairs", "icp_iterations_min_p50_p90_max", "host_reads",
                                      "stages_s")},
        "max_central_pose_diff_m": dmax,
        "phase8": {k: full["stats"][k] for k in ("wall_s", "stages_s")},
        "sharded_functions": functions, "cut_card_vs_cpu": cut_st,
        "nccl": {"slots": 2, "graph_vars": g.num_vars, "lm_steps": info.iterations,
                 "solve_s": nccl_s, "bit_equal": True},
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"[14] {json.dumps(summary)}")
    return summary


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
    sweep_cases = phase_sweep_cases(dev)
    nn_phase2 = nn_cases(dev)
    k5a_phase2 = tridiag_cases(dev)
    k5a_recip = recip_check(dev)
    gn_phase2 = gn_cases(dev)

    cfg = RemovertConfig()
    cfg.downsample_voxel_size = 0.1
    phase_card_vs_cpu(cfg)
    brute = RemovertConfig()
    brute.downsample_voxel_size = 0.1
    brute.use_chunk_knn = False    # phase 4 is the brute-force path (K1) by design
    calls, last_run, brute_masks = phase_full_width(brute)
    k4_calls, k4_run, sweeps5 = phase_default_config(cfg, brute_masks)
    phase_cli()
    slam = {"card_vs_cpu": phase_slam_card_vs_cpu()}
    slam["full_width"], slam_full = phase_slam_full_width()
    slam["ltmapper_cli"] = phase_slam_cli()
    lifelong, lifelong_in = phase_lifelong()
    optin = phase_optin(cfg, brute_masks, k4_run, lifelong_in[:2])
    headline = phase_headline()
    mesh = phase_mesh(cfg, brute_masks, k4_run, lifelong_in)
    slam_mesh = phase_slam_mesh(slam_full)
    del slam_full

    nd = calls[0]
    k4_nd = next(st for st in k4_calls if st["case"] == "full_width_nd")
    per_call = ("case", "n_valid", "scored_pairs", "listed_blocks", "overflowed_chunks",
                "k_blocks", "chunks_culled", "block_tests_per_chunk", "max_block_tests",
                "work_items", "merge_launches", "kernel_ms", "prep_ms", "scan_ms",
                "scan_ms_by_seg", "merge_ms", "plain_ms", "bound_ms", "bound_by", "gather_ms",
                "k1_yardstick_ms", "library_ms")
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
        "mesh_launches": mesh["brute"]["k1_launches"],
        "mesh_launches_path": f"phase 13 ({MESH_SLOTS} slots, use_chunk_knn=False)",
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
        "mesh_launches": mesh["default"]["k4_launches"],
        "mesh_launches_path": f"phase 13 ({MESH_SLOTS} slots, RemovertConfig() defaults)",
        "lifelong_launches_per_round": lifelong["k4_launches_per_round"],
        "merge_launches": k4_run["k4_merge_launches"],
        "max_abs_err": max(st["max_abs_err"] for st in k4_calls),
        "ms": k4_nd["kernel_ms"],
        "plain_ms": k4_nd["plain_ms"],
        "bound_ms": k4_nd["bound_ms"],
        "bound_by": k4_nd["bound_by"],
        "library_ms": k4_nd["library_ms"],
        "library": "torch.cdist + topk over the valid points, 1 024 queries a call (unclamped)",
        "k1_yardstick_ms": k4_nd["k1_yardstick_ms"],
        "per_launch": [{k: st.get(k) for k in per_call} for st in k4_calls],
        "scan_ms": k4_nd["scan_ms"],
        "km_offset_ms": km4["kernel_ms"],
        "km_offset_scan_ms": km4["scan_ms"],
        "km_offset_scan_ms_by_seg": km4["scan_ms_by_seg"],
        "km_offset_bound_ms": km4["bound_ms"],
        "km_offset_k1_yardstick_ms": km4["k1_yardstick_ms"],
        "km_offset_library_ms": km4["library_ms"],
    }]
    from ltm_torch.kernels import sweep

    fwd5 = sweeps5["largest"]["block_sweep_discrepancy"]
    vsi5 = sweeps5["largest"]["block_sweep_discrepancy_vs_images"]
    fus5 = sweeps5["largest"]["block_fused_visibility_images"]
    head = headline["k2"]
    # the largest absolute difference from the plain version that the run
    # measured: phase 2's cases, phase 5's calls and timed calls, phase 11a's
    # presel calls, phase 12's turns and timed call
    compared = sweep_cases["per_case"] + sweeps5["per_call"]
    errs = {fn: [st["max_abs_err"] for st in compared if st["function"] == fn]
            for fn in SWEEP_FUNCS}
    for fn, st in sweeps5["largest"].items():
        errs[fn].append(st["max_abs_err"])
    errs[SWEEP_FUNCS[2]].append(optin["a_occlusion"]["presel_vs_plain"]["max_abs_err"])
    errs[SWEEP_FUNCS[0]] += [t["max_abs_err"] for t in headline["turns"]] + [head["max_abs_err"]]
    k2_err = max(max(errs[fn]) for fn in SWEEP_FUNCS[:3])
    k3_err = max(errs[SWEEP_FUNCS[3]])
    variant_cases = {st["case"]: st for st in sweep_cases["per_case"]}

    def variants(fn, timed, cluster_key, global_key, global_case):
        plan, kernel = timed["cluster_plan"], "k3" if fn == SWEEP_FUNCS[3] else "k2"
        return {"cluster": dict(plan, launches=k4_run[cluster_key], kernel=kernel + "_cluster",
                                clusters_resident=sweep.cluster_occupancy(
                                    kernel, plan["cluster"], plan["shared_bytes_a_cta"])),
                "global": {"launches": k4_run[global_key], "ms": timed["global_ms"],
                           "phase2_case": global_case,
                           "phase2_max_abs_err": variant_cases[global_case]["max_abs_err"],
                           "taken_when": "no cluster of 8 CTAs holds the images"}}

    common = {"route": "cuda", "source": "ltm_torch/csrc/sweep.cu",
              "launches_path": "phase 5 (RemovertConfig() defaults): launch sets, one a chunk "
                               "of up to 64 keyframes",
              "library_ms": None}
    kernels += [dict(common, **{
        "name": "block_sweep_discrepancy (K2)",
        "route_kernels": ["k2_cluster (cluster variant, the default: a cluster a keyframe, "
                          "its images in the cluster's shared memory; scan min, map min, "
                          "flag in one launch)",
                          "global variant: k2_scan_min, k2_map_min, k2_flag (images in "
                          "device memory, global atomics)"],
        "replaces": "ltm/kernels/blocks.py:222",
        "also_replaces": ["ltm/kernels/blocks.py:330", "ltm/kernels/blocks.py:375"],
        "launches": k4_run["k2_launches"],
        "variants": variants(SWEEP_FUNCS[0], fwd5, "k2_launches", "k2_global_launches",
                             "forward_global"),
        "vs_images_cluster": vsi5["cluster_plan"],
        "max_abs_err": k2_err,
        "presel_calls_compared": optin["a_occlusion"]["presel_vs_plain"]["calls"],
        "ms": fwd5["ms"], "plain_ms": fwd5["plain_ms"], "bound_ms": fwd5["bound_ms"],
        "bound_by": fwd5["bound_by"], "global_ms": fwd5["global_ms"],
        "vs_images_ms": vsi5["ms"], "vs_images_global_ms": vsi5["global_ms"],
        "vs_images_plain_ms": vsi5["plain_ms"],
        "vs_images_bound_ms": vsi5["bound_ms"], "vs_images_bound_by": vsi5["bound_by"],
        "headline_ms": head["ms"], "headline_global_ms": head["global_ms"],
        "headline_plain_ms": head["plain_ms"],
        "headline_bound_ms": head["bound_ms"], "headline_bound_by": head["bound_by"],
        "phase5_calls": sweeps5["calls"], "cases": sweep_cases["cases"],
    }), dict(common, **{
        "name": "block_fused_visibility_images (K3)",
        "route_kernels": ["k3_cluster (cluster variant, the default: the packed image in "
                          "the cluster's shared memory; packed min, winners, decode into the "
                          "output image, one launch)",
                          "global variant: k3_packed<false>, k3_packed<true>, k3_decode"],
        "replaces": "ltm/kernels/blocks.py:537",
        "launches": k4_run["k3_launches"],
        "variants": variants(SWEEP_FUNCS[3], fus5, "k3_launches", "k3_global_launches",
                             "fused_global"),
        "max_abs_err": k3_err,
        "ms": fus5["ms"], "plain_ms": fus5["plain_ms"], "bound_ms": fus5["bound_ms"],
        "bound_by": fus5["bound_by"], "global_ms": fus5["global_ms"],
    })]
    sc8 = {st["case"]: st for st in slam["full_width"]["scatter_largest_calls"]}
    main8 = sc8.get("phase8_width_6", next(iter(sc8.values())))
    kernels.append({
        "name": "fixed_order_sum (the solver's scatter-sums)",
        "route": "cuda",
        "route_kernels": ["fixed_order_sum<float|double> (a warp a (lane, row), rows by "
                          "degree, highest first; the row's list read once and shuffled, "
                          "contribution rows loaded side by side, added in list order)"],
        "source": "ltm_torch/csrc/scatter.cu",
        "replaces": "ltm/graph/solver.py:157",
        "also_replaces": ["ltm/graph/solver.py:255"],
        "launches": slam["full_width"]["scatter_launches_per_run"][-1],
        "launches_path": "phase 8 (LTSlam.run, LTSlamConfig()): eager launches; the PCG's "
                         "CUDA-graph replays launch it without a count",
        "max_abs_err": max(st["max_abs_err"] for st in sweep_cases["scatter"]
                           + slam["full_width"]["scatter_largest_calls"]),
        "ms": main8["ms"], "plain_ms": main8["plain_ms"], "bound_ms": main8["bound_ms"],
        "bound_by": main8["bound_by"], "library_ms": main8["library_ms"],
        "library": "index_add_ (atomic: not a fixed order)",
        "device_ms": main8["device_ms"], "library_device_ms": main8["library_device_ms"],
        "graph_replay_ms": main8["graph_replay_ms"],
        "library_graph_replay_ms": main8["library_graph_replay_ms"],
        "per_call": [{k: st[k] for k in ("case", "src", "max_degree", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms", "device_ms",
                                         "library_device_ms", "graph_replay_ms",
                                         "library_graph_replay_ms", "back_to_back_ms",
                                         "library_back_to_back_ms")}
                     for st in slam["full_width"]["scatter_largest_calls"]],
        "cases": len(sweep_cases["scatter"]),
    })
    fw = slam["full_width"]
    nn8 = fw["largest_1nn_call"]
    kernels.append({
        "name": "nn_sqdist_argmin (K5b, the ICP 1-NN)",
        "route": "cuda",
        "route_kernels": ["nn_pack (a lane's targets as float4 (x, y, z, tag) and each "
                          "tile's box of valid targets)",
                          "nn_scan (lane x 512 queries x target split: the lane's midpoint "
                          "from its tile boxes, a warp's tiles nearest first, the exact box "
                          "cull, centring and t2 on the way into shared memory, a running "
                          "least (value, index) a query, the re-score when unsplit)",
                          "nn_merge (the splits' partial (value, index), in order, and the "
                          "re-score)"],
        "source": "ltm_torch/csrc/nn_argmin.cu",
        "replaces": "ltm/kernels/knn.py:177",
        "launches": fw["nn_launches_per_run"][-1],
        "merge_launches": fw["nn_merges_per_run"][-1],
        "launches_path": "phase 8 (LTSlam.run, LTSlamConfig()): every ICP iteration and "
                         "fitness of the farm",
        "max_abs_err": max([fw["nn_farm_check"]["max_abs_err"], nn8["max_abs_err"]]
                           + [st["max_abs_err"] for st in nn_phase2]),
        "max_abs_err_is": "distances, kernel route against the plain version: 0 where the "
                          "indices agree, the near-ties' gap elsewhere",
        "near_ties_phase8_warmup": fw["nn_farm_check"]["near_ties"],
        "farm_work_phase8_warmup": {k: fw["nn_farm_check"][k] for k in (
            "tiles_considered", "tiles_scored", "tiles_culled", "update_branches",
            "cull_share", "min_cull_share")},
        "work": nn8["work"],
        "calls_checked_phase8_warmup": fw["nn_farm_check"]["calls"],
        "ms": nn8["ms"], "device_ms": nn8["device_ms"], "unsplit_ms": nn8["unsplit_ms"],
        "plain_ms": nn8["plain_ms"], "bound_ms": nn8["bound_ms"], "bound_by": nn8["bound_by"],
        "library_ms": nn8["library_ms"], "library": nn8["library"],
        "call": nn8["shape"], "splits": nn8["splits"],
        "all_pairs_bound_ms": nn8["all_pairs_bound_ms"], "scored_pairs": nn8["scored_pairs"],
        "split_sweep_ms": nn8["split_sweep_ms"],
        "peak_above_inputs_bytes": nn8["peak_above_inputs_bytes"],
        "plain_peak_above_inputs_bytes": nn8["plain_peak_above_inputs_bytes"],
        **{f"phase2_{case}": next({k: st.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                                          "library_ms", "device_ms", "work")}
                                  for st in nn_phase2 if st["case"] == case)
           for case in ("farm_largest", "farm_sorted")},
        "cases": len(nn_phase2),
    })
    k5a = fw["tridiag_largest_call"]
    k5a_cases = k5a_phase2 + [k5a]
    marginals = next(st for st in k5a_phase2 if st["lanes"] == [120] and "ms" in st["apply"])
    route = {"factor": "tridiag_factor<float|double> (a warp a chain, no CTA barrier: lane "
                       "3k + g holds columns 2g, 2g + 1 of row k in registers; P's pairs and "
                       "the matrix before each Gauss-Jordan pivot exchanged through shared "
                       "memory after a __syncwarp; each pivot's reciprocal from "
                       "rcp.approx.ftz.f64 and one cubic Newton step, formed before the "
                       "previous pivot's update; all 32 lanes stage D and L a segment of 8 "
                       "steps ahead; writes Cinv, Lc and P = Cinv_{i-1} L_i^T)",
             "apply": "tridiag_apply<float|double> (a CTA of four warps a chain and up to "
                      "5 lanes: warp 0 runs y_i = r_i - P_i^T y_{i-1} and x_i = w_i - "
                      "P_{i+1} x_{i+1}, six threads a lane, one 6x6 mat-vec a dependent "
                      "step, operands from shared memory; warps 1-3 stage the blocks, r "
                      "and w by cp.async in segments of 32 steps, convert them to double, "
                      "form w_i = Cinv_i y_i and write w and x out)"}
    for which, line in (("factor", "ltm/graph/solver.py:198"), ("apply", "ltm/graph/solver.py:222")):
        st = k5a[which]
        check = fw["tridiag_check"][which]
        kernels.append({
            "name": f"tridiag_{which} (K5a)",
            "route": "cuda",
            "route_kernels": [route[which]],
            "source": "ltm_torch/csrc/tridiag.cu",
            "replaces": line,
            "launches": fw["tridiag_launches_per_run"][which][-1],
            "launches_path": "phase 8 (LTSlam.run, LTSlamConfig()): eager calls, the call each "
                             "PCG captures included; its CUDA-graph replays launch without a "
                             "count",
            **({"runs_with_pcg_replays": fw["tridiag_apply_runs"]} if which == "apply" else {}),
            "max_abs_err": max([check["max_abs_err"]]
                               + [c[which]["max_abs_err"] for c in k5a_cases]),
            "max_abs_err_is": "against the float64 plain version on the same inputs",
            "max_rel_err": max([check["max_rel_err"]]
                               + [c[which]["max_rel_err"] for c in k5a_cases]),
            "plain_f32_rel_err": max([check["plain_f32_rel_err"]]
                                     + [c[which]["plain_f32_rel_err"] for c in k5a_cases]),
            "rule": "max_rel_err <= max(2 x the plain float32 route's, 1e-6), each call; "
                    "both the largest block's error over that block's size (a 6x6 block of "
                    "Cinv or P, a row of x)",
            "calls_checked_phase8_warmup": check["checked"],
            "worst_share_of_limit_phase8_warmup": check["worst_share_of_limit"],
            **({"P_max_rel_err": max([check["P_max_rel_err"]]
                                     + [c["factor"]["P_max_rel_err"] for c in k5a_cases]),
                "P_worst_share_of_limit_phase8_warmup": check["P_worst_share_of_limit"],
                "reciprocal": k5a_recip} if which == "factor" else
               {"p64_trial_phase8_warmup": check["p64"],
                "p64_trial_phase8_largest": st.get("p64"),
                "p64_trial_120_lanes": marginals["apply"].get("p64")}),
            "ms": st["ms"], "graph_replay_ms": st["graph_replay_ms"], "plain_ms": st["plain_ms"],
            "plain_graph_replay_ms": st["plain_graph_replay_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "bound_is": "throughput (bytes or operations) over the valid variables; the "
                        "chains' dependent steps bind",
            "max_len": k5a["max_len"], "dependent_steps": st["dependent_steps"],
            "ms_per_dependent_step": st["ms_per_dependent_step"],
            "us_per_dependent_step": st["ms_per_dependent_step"] * 1e3,
            "step_floor_us": st["step_floor_ms"] * 1e3,
            "dependent_step_floor_ms": st["dependent_step_floor_ms"],
            "library_ms": None,
            "library": "none: no PyTorch call computes a block-tridiagonal factor or solve",
            "call": {"variables": k5a["variables"], "n_chains": k5a["n_chains"],
                     "lanes": k5a["lanes"], "dtype": k5a["dtype"]},
            "marginals_shape_ms": marginals[which]["ms"],
            "marginals_shape_graph_replay_ms": marginals[which]["graph_replay_ms"],
            "cases": len(k5a_phase2),
        })
    gn8, gn_rs = fw["gn_lm_call"], fw["rs_marginals"]["product"]
    gn_cases_all = gn_phase2 + [gn8, gn_rs]
    kernels.append({
        "name": "gn_product (K5c, the solver's Gauss-Newton product)",
        "route": "cuda",
        "route_kernels": ["below 24 lanes: gn_factors<float|double> (a thread a (factor, lane) "
                          "over the whole grid, y_f into a lane-fastest (factors, 6, lanes) "
                          "scratch; lets gn_rows launch at once) -> gn_rows<float|double> "
                          "(Programmatic Dependent Launch: blocks loaded before the wait on "
                          "y; a CTA a (row, lane) for rows of more than 64 ends, a warp a "
                          "(row, lane) for lighter ones; each chunk's products J_e^T y at "
                          "once into shared memory, added in list order, + lambda v)",
                          "from 24 lanes: gn_end_table<float|double> (once a plan and its "
                          "blocks: a 64-byte record a list entry) -> gn_transpose<float|"
                          "double> (v by 32-lane tile, with a row of zeros) -> "
                          "gn_rows_wide<float|double> (Programmatic Dependent Launch; a CTA "
                          "a (row, 32 lanes), records and blocks staged by cp.async a chunk "
                          "ahead, its warps forming each end's y_f afresh from vt and J_e^T "
                          "y_f at once, added in list order, + lambda v; no y in device "
                          "memory)"],
        "source": "ltm_torch/csrc/gn_product.cu",
        "replaces": "ltm/graph/solver.py:264",
        "launches": fw["gn_launches_per_run"][-1],
        "launches_path": "phase 8 (LTSlam.run, LTSlamConfig()): eager calls, the call each PCG "
                         "captures included; its CUDA-graph replays launch without a count",
        "runs_with_pcg_replays": fw["gn_product_runs"],
        "rs_run_launches": fw["rs_run"]["gn_launches"],
        "max_abs_err": max([fw["gn_check"]["max_abs_err"], fw["rs_run"]["gn_check"]["max_abs_err"]]
                           + [st["max_abs_err"] for st in gn_cases_all]),
        "max_abs_err_is": "against gn_product_plain on the same inputs (bit for bit: 0)",
        "calls_checked_phase8_warmup": fw["gn_check"]["checked"],
        "calls_checked_rs_run": fw["rs_run"]["gn_check"]["checked"],
        "ms": gn8["ms"], "graph_replay_ms": gn8["graph_replay_ms"],
        "plain_ms": gn8["plain_ms"], "bound_ms": gn8["bound_ms"], "bound_by": gn8["bound_by"],
        "contract_floor_ms": gn8["contract_floor_ms"], "device_ms": gn8["device_ms"],
        "device_ms_phase2": {st["case"]: st["device_ms"] for st in gn_phase2 if "device_ms" in st},
        "device_ms_pcg_iteration": {
            "lm": {k: v for k, v in fw["pcg_iteration_profile"]["kernel"]["top_device_ms"].items()
                   if "gn_" in k},
            "marginals": {k: v for k, v in fw["rs_marginals"]["turns"]["pcg_iteration_profile"]
                          ["kernel"]["top_device_ms"].items() if "gn_" in k}},
        "library_ms": None,
        "library": "none: no PyTorch call computes this product",
        "old_route_ms": gn8["old_route_ms"],
        "old_route_graph_replay_ms": gn8["old_route_graph_replay_ms"],
        "call": {k: gn8[k] for k in ("lanes", "variables", "factors", "ends", "valid_ends",
                                     "max_degree", "dtype")},
        "marginals_call": {k: gn_rs.get(k) for k in (
            "lanes", "ms", "graph_replay_ms", "device_ms", "plain_ms", "old_route_ms",
            "old_route_graph_replay_ms", "bound_ms", "bound_by", "contract_floor_ms",
            "peak_above_inputs_bytes", "old_route_peak_above_inputs_bytes", "scratch_bytes")},
        "cases": len(gn_phase2),
    })
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"slam": slam}))
    print(json.dumps({"lifelong": lifelong, "optin": optin, "headline": headline, "mesh": mesh,
                      "slam_mesh": slam_mesh}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
