"""Occupancy-adaptive chunked 2-NN over block-structured maps (port of
``ltm.kernels.chunk_knn``): the hand-written CUDA kernels
(``ltm_torch/csrc/chunk_knn.cu``, replacing the XLA-lowered
``ltm/kernels/chunk_knn.py::chunk_knn_sqdists`` with its scan
``_scan_chunks``), their wrapper and the plain PyTorch version.

Queries are Morton-sorted and cut into fixed chunks; per chunk, only the
target blocks whose tight AABB lies within ``radius + clamp_radius`` of the
chunk's center are scored.  Distances are CLAMPED at ``clamp_radius²``: a
true neighbour outside the scored blocks is provably farther than
``clamp_radius``, so per-distance decisions at thresholds ≤ r² and decisions
on the average of k distances at thresholds ≤ r²/k are exact (see
``ltm.kernels.chunk_knn`` for the argument).

Chunks whose intersecting-block count exceeds ``k_blocks`` are reported in
``ChunkKnnResult.chunk_overflow``; callers re-resolve their queries
(``Removerter._chunk_knn_finish``).  Unlike ``ltm``, which scores the
``k_blocks`` nearest blocks of such a chunk, the port writes NaN rows for
the valid queries of an overflowed chunk: those rows are replaced anyway,
and a NaN cannot be mistaken for a distance.  Every other row matches
``ltm`` bit for bit: distances are the FMA chain of ``projection.sumsq3``,
and the top 2 of a multiset does not depend on the order it is taken in.

``chunk_knn_sqdists`` takes :func:`chunk_knn_sqdists_plain` for CPU
tensors.  For CUDA tensors (k = 2) it launches the kernels in two C calls:
the prep (the Morton keys, their stable radix sort, the block and
super-block bounds) and the scan (a two-level cull a chunk, persistent
warps over (chunk, segment) work items, and a merge of the chunks split
over several items); a CUDA call launches them or raises.  The plain
versions of the cull and the work-item plan (:func:`_super_bounds`,
:func:`_cull_two_level`, :func:`_work_items`) are what the CPU tests and
``chip_smoke.py`` hold the kernels' own counts to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ltm_torch.kernels.blocks import BlockMap
from ltm_torch.kernels.projection import _recip, _sqrt, sumsq3

__all__ = ["ChunkKnnResult", "ChunkKnnPrep", "chunk_knn_sqdists", "chunk_knn_sqdists_plain",
           "chunk_knn_avg_sqdist", "chunk_knn_prep", "chunk_knn_scan_range"]

_BIG = 1e30
_PAIRS = 1 << 22          # plain version: pairs scored per step (bounds its memory)
_BLOCK_TESTS = 1 << 22    # plain version: chunk x block tests per batch

# kMaxChunk, kSlab, kSuper, kPrepCtas, kCounts of csrc/chunk_knn.cu,
# checked when it loads
_MAX_CHUNK = 1024   # queries a chunk
_SLAB = 256         # queries a work item (8 a lane of one warp)
_SUPER = 32         # blocks a super-block
_PREP_CTAS = 512    # CTAs of the cell minimum
_COUNTS = 5         # counts a scan writes (see chunk_knn_sqdists)
_SEG = 4            # listed blocks a work item, passed to the scan (chip_smoke.seg_sweep)


class ChunkKnnResult(NamedTuple):
    sqdists: torch.Tensor         # (N, k) clamped ascending; 1e30 for invalid queries,
                                  # NaN for valid queries of an overflowed chunk
    chunk_overflow: torch.Tensor  # (C,) int32: excess intersecting blocks per chunk
    order: torch.Tensor           # (N,) int32: original query index at each sorted
                                  # position (chunk c covers [c·chunk, (c+1)·chunk))


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 v so consecutive bits land 3 apart
    (Morton-code component; 10 bits an axis = 1024 sort cells)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _block_bounds(bm: BlockMap, target_extra):
    """(t_mask, bval, blo, bhi): the valid-subset mask and tight per-block
    AABBs (+inf/-inf for a block with no valid point)."""
    t_mask = bm.mask
    if target_extra is not None:
        t_mask = t_mask & target_extra.reshape(bm.num_blocks, bm.block_capacity)
    bval = torch.any(t_mask, dim=1)
    mfill = t_mask[..., None]
    blo = torch.where(mfill, bm.xyz, torch.inf).amin(1)
    bhi = torch.where(mfill, bm.xyz, -torch.inf).amax(1)
    return t_mask, bval, blo, bhi


def _prep_sorted_chunks(query_xyz, query_mask, chunk: int, sort_cell: float):
    """Morton-sort the queries (cells offset by the valid minimum, 10 bits
    an axis, invalid queries last) with a stable sort, as ``jnp.argsort``,
    and cut them into chunks.  The cell of a point is ``floor(x · (1/sort_cell))``
    with the float32 reciprocal, as XLA compiles ``ltm``'s division by the
    static ``sort_cell``.  Returns (qx (C, chunk, 3), qm (C, chunk), order
    (N,) int64)."""
    n = query_xyz.shape[0]
    coords = torch.floor(query_xyz * float(_recip(sort_cell))).int()
    cmin = torch.where(query_mask[:, None], coords, 2**30).amin(0)
    coords = torch.clamp(coords - cmin, 0, 1023)
    key = _spread3(coords[:, 0]) | (_spread3(coords[:, 1]) << 1) | (_spread3(coords[:, 2]) << 2)
    key = torch.where(query_mask, key, 2**31 - 1)
    order = torch.argsort(key, stable=True)
    n_pad = -(-n // chunk) * chunk
    qx = query_xyz.new_zeros((n_pad, 3))
    qx[:n] = query_xyz[order]
    qm = query_mask.new_zeros((n_pad,))
    qm[:n] = query_mask[order]
    return qx.reshape(-1, chunk, 3), qm.reshape(-1, chunk), order


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 as a pairwise tree over the next power of two (zero
    padded): ``x[:, :h] + x[:, h:]`` until one row is left.  The CUDA cull
    reduces its chunk's center in the same order, so both give the same bits."""
    p = 1 << (x.shape[1] - 1).bit_length()
    if p != x.shape[1]:
        x = torch.cat([x, x.new_zeros((x.shape[0], p - x.shape[1]) + x.shape[2:])], 1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def _chunk_balls(qx, qm, clamp_radius: float):
    """(count, center, radius + clamp_radius) of each chunk's valid queries."""
    cnt = qm.sum(1)
    center = _tree_sum(torch.where(qm[..., None], qx, 0.0)) / torch.clamp(cnt, min=1)[:, None].float()
    rad = torch.where(qm, _sqrt(sumsq3(qx - center[:, None])), 0.0).amax(1)
    return cnt, center, rad + torch.tensor(clamp_radius, dtype=torch.float32, device=qx.device)


def _block_hits(center, reach, bval, blo, bhi):
    """(A, B) bool: box b is valid and its point-to-AABB distance from
    center a is at most reach a."""
    c = center[:, None, :]
    gap = torch.clamp(torch.maximum(blo[None] - c, c - bhi[None]), min=0.0)
    return bval[None] & (_sqrt(sumsq3(gap)) <= reach[:, None])


def _scan_chunks_plain(qx, qm, bm_xyz, t_mask, bval, blo, bhi, clamp_radius: float,
                       k: int, k_blocks: int):
    """Plain PyTorch version of the scan.  Returns (chunk_overflow (C,)
    int32, d (C, chunk, k)).

    Chunks with a valid query are tested against every block in batches of
    ``_BLOCK_TESTS`` chunk x block tests; each chunk that did not overflow
    then scores its valid queries against the valid slots of its
    intersecting blocks, ``_PAIRS`` pairs a step, with a running
    ``topk(k, largest=False)`` (the k smallest of the multiset, so a
    duplicate counts twice, as ``ltm``'s k-fold argmin)."""
    C, chunk = qm.shape
    dev = qx.device
    d = torch.full((C, chunk, k), _BIG, dtype=torch.float32, device=dev)
    overflow = torch.zeros((C,), dtype=torch.int32, device=dev)
    cnt, center, reach = _chunk_balls(qx, qm, clamp_radius)
    active = torch.nonzero(cnt > 0).squeeze(1)
    r2 = torch.tensor(clamp_radius * clamp_radius, dtype=torch.float32, device=dev)
    nan = torch.tensor(torch.nan, dtype=torch.float32, device=dev)
    step = max(1, _BLOCK_TESTS // max(bval.shape[0], 1))
    for a0 in range(0, active.shape[0], step):
        cs = active[a0:a0 + step]
        hit = _block_hits(center[cs], reach[cs], bval, blo, bhi)
        n_int = hit.sum(1)
        overflow[cs] = torch.clamp(n_int - k_blocks, min=0).int()
        for j, (ci, n_hit) in enumerate(zip(cs.tolist(), n_int.tolist())):
            qv = qm[ci]
            if n_hit > k_blocks:
                d[ci] = torch.where(qv[:, None], nan, _BIG)
                continue
            blocks = torch.nonzero(hit[j]).squeeze(1)
            cand = bm_xyz[blocks][t_mask[blocks]]            # (M, 3) valid slots
            q = qx[ci][qv]
            best = torch.full((q.shape[0], k), _BIG, dtype=torch.float32, device=dev)
            t_step = max(1, _PAIRS // q.shape[0])
            for t0 in range(0, cand.shape[0], t_step):
                d2 = sumsq3(q[:, None, :] - cand[None, t0:t0 + t_step])
                best = torch.topk(torch.cat([best, d2], 1), k, dim=1, largest=False).values
            d[ci, qv] = torch.minimum(best, r2)
    return overflow, d


def chunk_knn_sqdists_plain(query_xyz, query_mask, bm: BlockMap, target_extra,
                            clamp_radius: float, k: int = 2, chunk: int = 512,
                            k_blocks: int = 64, sort_cell: float = 25.0) -> ChunkKnnResult:
    """:func:`chunk_knn_sqdists` through the plain scan, on either device:
    sort, chunk, scan and write back by ``order``."""
    prep = chunk_knn_prep(query_xyz, query_mask, bm, target_extra, chunk=chunk,
                          sort_cell=sort_cell, plain=True)
    overflow, rows = chunk_knn_scan_range(prep, 0, prep.n_chunks, clamp_radius, k=k,
                                          k_blocks=k_blocks)
    res = torch.empty((prep.n, k), dtype=torch.float32, device=query_xyz.device)
    res[prep.order] = rows[:prep.n]
    return ChunkKnnResult(res, overflow, prep.order.int())


class ChunkKnnPrep(NamedTuple):
    """What a scan of any range of a call's chunks reads, on one device:
    the Morton order and the chunking of the queries and the target
    blocks' bounds, computed once a call (``ltm``'s
    ``chunk_knn_sqdists_sharded`` sorts and bounds once and splits the
    scan).  ``scan`` holds the plain version's (sorted chunks (C, chunk,
    3) and (C, chunk), block xyz, target mask, block validity and AABBs)
    or the kernels' (queries, mask, order, target arrays, bounds)."""

    order: torch.Tensor     # (N,) original query index at each sorted position
    n: int
    chunk: int
    n_chunks: int
    plain: bool
    scan: tuple

    def to(self, device) -> "ChunkKnnPrep":
        def move(x):
            if isinstance(x, tuple):
                return tuple(move(v) for v in x)
            return x.to(device) if isinstance(x, torch.Tensor) else x

        return self._replace(order=self.order.to(device), scan=move(self.scan))


def chunk_knn_prep(query_xyz, query_mask, bm: BlockMap, target_extra, chunk: int = 512,
                   sort_cell: float = 25.0, plain=None) -> ChunkKnnPrep:
    """The sort, chunking and block bounds of a chunk kNN call: the plain
    steps for CPU tensors (or ``plain=True`` on either device), the prep
    kernels (keys, CUB's radix sort, bounds) for CUDA tensors."""
    dev = query_xyz.device
    plain = dev.type == "cpu" if plain is None else plain
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"chunk kNN runs on cuda or cpu, not {dev}")
    _check(query_xyz, query_mask, bm)
    n = query_xyz.shape[0]
    n_chunks = -(-n // chunk)
    if plain:
        t_mask, bval, blo, bhi = _block_bounds(bm, target_extra)
        qx, qm, order = _prep_sorted_chunks(query_xyz, query_mask, chunk, sort_cell)
        return ChunkKnnPrep(order, n, chunk, n_chunks, True, (qx, qm, bm.xyz, t_mask, bval, blo, bhi))
    if not 0 < n < 2**31:
        raise ValueError(f"chunk kNN kernel takes 1 to 2^31 - 1 queries, got {n}")
    q, qm = query_xyz.contiguous(), query_mask.contiguous()
    targets = _target_arrays(bm, target_extra)
    with torch.cuda.device(dev):
        order, bounds = _prep_cuda(q, qm, targets, sort_cell)
    return ChunkKnnPrep(order, n, chunk, n_chunks, False, (q, qm, targets, bounds))


def chunk_knn_scan_range(prep: ChunkKnnPrep, c0: int, c1: int, clamp_radius: float,
                         k: int = 2, k_blocks: int = 64):
    """(chunk_overflow (c1 - c0,) int32, rows ((c1 - c0)·chunk, k)): the scan
    of chunks ``[c0, c1)`` of a prepared call, its rows at the chunks'
    sorted positions (1e30 past the last query).  A chunk's rows do not
    depend on another chunk, so a range gives the whole call's bits in its
    rows.  On the card it launches K4's scan over the range (counted in
    ``chunk_knn_sqdists.launches``, its counts in ``.counts``); the plain
    version scans the same chunks."""
    if not 0 <= c0 <= c1 <= prep.n_chunks:
        raise ValueError(f"chunk range [{c0}, {c1}) outside the call's {prep.n_chunks} chunks")
    chunk = prep.chunk
    dev = prep.order.device
    if c0 == c1:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0, k), dtype=torch.float32, device=dev))
    if prep.plain:
        qx, qm, bm_xyz, t_mask, bval, blo, bhi = prep.scan
        overflow, d = _scan_chunks_plain(qx[c0:c1], qm[c0:c1], bm_xyz, t_mask, bval, blo, bhi,
                                         clamp_radius, k, k_blocks)
        return overflow, d.reshape(-1, k)
    if k != 2:
        raise ValueError(f"the chunk kNN kernel computes k=2, not k={k}")
    q, qm, targets, bounds = prep.scan
    with torch.cuda.device(q.device):
        out, overflow = _scan_cuda(q, qm, prep.order, targets, bounds, clamp_radius, chunk,
                                   k_blocks, c0=c0, c1=c1)
    rows = out.new_full(((c1 - c0) * chunk, 2), _BIG)
    pos = prep.order[c0 * chunk:min(c1 * chunk, prep.n)].long()
    rows[:pos.shape[0]] = out[pos]
    return overflow, rows


def _check(query_xyz, query_mask, bm: BlockMap):
    if query_xyz.dtype != torch.float32 or bm.xyz.dtype != torch.float32:
        raise ValueError("chunk kNN takes float32 points")
    if query_mask.dtype != torch.bool or query_mask.shape != query_xyz.shape[:1]:
        raise ValueError("chunk kNN takes a bool query mask, one entry a query")
    if bm.xyz.device != query_xyz.device or query_mask.device != query_xyz.device:
        raise ValueError("queries and the block map must be on one device")


def chunk_knn_sqdists(
    query_xyz: torch.Tensor,          # (N, 3) float32
    query_mask: torch.Tensor,         # (N,) bool
    bm: BlockMap,                     # target block layout
    target_extra,                     # (n_blocks*cap,) bool subset mask, or None
    clamp_radius: float,
    k: int = 2,
    chunk: int = 512,
    k_blocks: int = 64,
    sort_cell: float = 25.0,
) -> ChunkKnnResult:
    """(N, k) clamped ascending squared distances plus the per-chunk overflow
    and the sort order, as ``ltm.kernels.chunk_knn.chunk_knn_sqdists``.

    CUDA tensors launch ``csrc/chunk_knn.cu`` (k = 2 only; calls that
    launched the scan are counted in ``chunk_knn_sqdists.launches``, those
    that also launched the merge in ``chunk_knn_sqdists.merges``, and
    ``chunk_knn_sqdists.counts`` holds the last scan's own counts on the
    device: work items, work items taken, block and super-block tests,
    chunks culled, the most tests in one chunk); CPU tensors take the plain
    version."""
    dev = query_xyz.device
    if dev.type == "cpu":
        return chunk_knn_sqdists_plain(query_xyz, query_mask, bm, target_extra, clamp_radius,
                                       k=k, chunk=chunk, k_blocks=k_blocks, sort_cell=sort_cell)
    if dev.type != "cuda":
        raise ValueError(f"chunk_knn_sqdists runs on cuda or cpu, not {dev}")
    if k != 2:
        raise ValueError(f"the chunk kNN kernel computes k=2, not k={k}")
    _check(query_xyz, query_mask, bm)
    if query_xyz.shape[0] == 0:
        return ChunkKnnResult(query_xyz.new_empty((0, 2)),
                              torch.empty((0,), dtype=torch.int32, device=dev),
                              torch.empty((0,), dtype=torch.int32, device=dev))
    prep = chunk_knn_prep(query_xyz, query_mask, bm, target_extra, chunk=chunk,
                          sort_cell=sort_cell)
    q, qm, targets, bounds = prep.scan
    with torch.cuda.device(dev):
        out, overflow = _scan_cuda(q, qm, prep.order, targets, bounds, clamp_radius, chunk,
                                   k_blocks)
    return ChunkKnnResult(out, overflow, prep.order)


chunk_knn_sqdists.launches = 0   # calls that launched the scan (cull and scoring)
chunk_knn_sqdists.merges = 0     # calls that launched the merge of split chunks
chunk_knn_sqdists.counts = None  # (_COUNTS,) int64 on the card: the last scan's counts


def chunk_knn_avg_sqdist(query_xyz, query_mask, bm, target_extra, clamp_radius,
                         k: int = 2, chunk: int = 512, k_blocks: int = 64,
                         sort_cell: float = 25.0):
    """(average of the k clamped NN squared distances (N,), total overflow).
    Rows of overflowed chunks are NaN: callers that need them use
    :func:`chunk_knn_sqdists` and re-resolve those queries."""
    r = chunk_knn_sqdists(query_xyz, query_mask, bm, target_extra, clamp_radius,
                          k=k, chunk=chunk, k_blocks=k_blocks, sort_cell=sort_cell)
    return r.sqdists.mean(-1), r.chunk_overflow.sum()


# ---- plain versions of the kernels' own steps -------------------------------

def _super_bounds(bval, blo, bhi, group: int = _SUPER):
    """(sval, slo, shi): validity and AABB of each super-block of ``group``
    consecutive blocks (the last one may be short), over its valid blocks;
    what ``ck_bounds`` writes beside the blocks' own bounds."""
    nb = bval.shape[0]
    ns = -(-nb // group)
    pad = ns * group - nb
    lo = torch.where(bval[:, None], blo, torch.inf)
    hi = torch.where(bval[:, None], bhi, -torch.inf)
    lo = torch.cat([lo, lo.new_full((pad, 3), torch.inf)]).reshape(ns, group, 3)
    hi = torch.cat([hi, hi.new_full((pad, 3), -torch.inf)]).reshape(ns, group, 3)
    val = torch.cat([bval, bval.new_zeros(pad)]).reshape(ns, group)
    return val.any(1), lo.amin(1), hi.amax(1)


def _cull_two_level(center, reach, bval, blo, bhi, group: int = _SUPER):
    """(hit (A, n_blocks) bool, tests (A,) int64): ``ck_cull``'s two-level
    test.  A block is tested only inside a super-block that passes the same
    test; ``tests`` counts a chunk's tests as the kernel does, every
    super-block plus the blocks of each super-block hit.  Exact: ``hit`` is
    :func:`_block_hits` (a super-block's rounded gap is never above any of
    its blocks')."""
    sval, slo, shi = _super_bounds(bval, blo, bhi, group)
    shit = _block_hits(center, reach, sval, slo, shi)
    inside = shit.repeat_interleave(group, 1)[:, :bval.shape[0]]
    hit = inside & _block_hits(center, reach, bval, blo, bhi)
    return hit, sval.shape[0] + inside.sum(1)


def _work_items(listed: torch.Tensor, chunk: int, seg: int = _SEG, slab: int = _SLAB):
    """(I, 3) int64 rows (chunk, slab, segment): the work items ``ck_cull``
    appends for chunks that list ``listed`` blocks (0 for a chunk the
    scoring skips: empty, overflowed or with no hit), here in chunk order
    (on the card in any order).  Item (c, s, g) scores queries
    ``[s·slab, min((s+1)·slab, chunk))`` of chunk c against its listed
    blocks ``[g·seg, min((g+1)·seg, listed[c]))``."""
    listed = listed.long().cpu()
    nseg = (listed + seg - 1) // seg
    per = nseg * -(-chunk // slab)
    c = torch.repeat_interleave(torch.arange(listed.numel()), per)
    i = torch.arange(int(per.sum())) - (torch.cumsum(per, 0) - per)[c]
    return torch.stack([c, i // nseg[c], i % nseg[c]], 1)


# ---- the kernels' Python side ------------------------------------------------

def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"chunk kNN {what} launch failed: "
                           f"{_lib().ltm_chunk_knn_error_string(rc).decode()} ({rc})")


def _target_arrays(bm: BlockMap, target_extra):
    """(xyz, mask, extra or None) of the block map as the kernels read them:
    contiguous, checked (any capacity; the scoring stages the 16-byte units
    that cover a block's slots, wherever they start)."""
    n_blocks, cap = bm.num_blocks, bm.block_capacity
    if n_blocks * cap >= 2**31:
        raise ValueError(f"chunk kNN kernel takes fewer than 2^31 slots, got {n_blocks} x {cap}")
    if bm.mask.dtype != torch.bool or (target_extra is not None and (
            target_extra.dtype != torch.bool or target_extra.numel() != n_blocks * cap)):
        raise ValueError("chunk kNN kernel: the block mask and target_extra are bool, "
                         "target_extra one entry a slot")
    return (bm.xyz.contiguous(), bm.mask.contiguous(),
            None if target_extra is None else target_extra.contiguous())


def _prep_cuda(q, qm, targets, sort_cell: float):
    """(order (N,) int32, bounds): one C call launches ``ck_cell_min`` and
    ``ck_keys`` (the Morton keys of :func:`_prep_sorted_chunks`), CUB's
    stable radix sort of the keys (their order) and ``ck_bounds`` (the
    block and super-block AABBs, a float4 array)."""
    n, dev = q.shape[0], q.device
    xyz, mask, extra = targets
    n_blocks, cap = mask.shape
    nbytes = _lib().ltm_chunk_knn_prep_bytes(n)
    if nbytes < 0:
        raise RuntimeError(f"chunk kNN prep: no scratch size for {n} queries")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    order = torch.empty((n,), dtype=torch.int32, device=dev)
    bounds = torch.empty((2 * n_blocks + 2 * -(-n_blocks // _SUPER), 4), dtype=torch.float32,
                         device=dev)
    rc = _lib().ltm_chunk_knn_prep(q.data_ptr(), qm.data_ptr(), n,
                                   ctypes.c_float(float(_recip(sort_cell))), xyz.data_ptr(),
                                   mask.data_ptr(), _ptr(extra), n_blocks, cap,
                                   scratch.data_ptr(), nbytes, order.data_ptr(),
                                   bounds.data_ptr(), _stream())
    _raise_on(rc, "prep")
    return order, bounds


def _scan_scratch_bytes(n_range: int, chunk: int, n_blocks: int, k_blocks: int, seg: int) -> int:
    """Bytes of the scratch of a scan of ``n_range`` chunks: packed top-2
    words (when the merge runs), work items, hit lists and hit counts."""
    list_cap = min(k_blocks, n_blocks)
    items = n_range * -(-chunk // _SLAB) * -(-list_cap // seg)
    return 8 * n_range * chunk * (list_cap > seg) + 8 * items + 4 * n_range * (list_cap + 1)


def _scan_cuda(q, qm, order, targets, bounds, clamp_radius: float, chunk: int, k_blocks: int,
               seg: int = _SEG, c0: int = 0, c1=None):
    """(out (N, 2), chunk_overflow (c1 - c0,)): one C call launches
    ``ck_cull``, ``ck_score`` (work items of ``seg`` listed blocks) and,
    when a chunk can list more than ``seg`` blocks, ``ck_merge``, over the
    chunks ``[c0, c1)`` (all of them by default), with scratch sized from
    what the host knows (the range, ``k_blocks``): no host sync.  Only the
    range's queries get rows in ``out``.  The scan's counts go to
    ``chunk_knn_sqdists.counts``."""
    n, dev = q.shape[0], q.device
    xyz, mask, extra = targets
    n_blocks, cap = mask.shape
    if not 0 < chunk <= _MAX_CHUNK or k_blocks < 1 or seg < 1:
        raise ValueError(f"chunk kNN kernel takes 0 < chunk <= {_MAX_CHUNK}, k_blocks >= 1 and "
                         f"seg >= 1, got {chunk}, {k_blocks} and {seg}")
    if -(-n // chunk) * chunk >= 2**31:
        raise ValueError("chunk kNN kernel takes fewer than 2^31 padded queries")
    c1 = -(-n // chunk) if c1 is None else c1
    if not 0 <= c0 < c1 <= -(-n // chunk):
        raise ValueError(f"chunk range [{c0}, {c1}) outside the call's {-(-n // chunk)} chunks")
    nbytes = _scan_scratch_bytes(c1 - c0, chunk, n_blocks, k_blocks, seg)
    scratch = torch.empty((-(-nbytes // 8),), dtype=torch.int64, device=dev)
    counts = torch.empty((_COUNTS,), dtype=torch.int64, device=dev)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    overflow = torch.empty((c1 - c0,), dtype=torch.int32, device=dev)
    rc = _lib().ltm_chunk_knn_scan(
        q.data_ptr(), qm.data_ptr(), order.data_ptr(), n, chunk, c0, c1, xyz.data_ptr(),
        mask.data_ptr(), _ptr(extra), n_blocks, cap, bounds.data_ptr(),
        ctypes.c_float(clamp_radius), ctypes.c_float(clamp_radius * clamp_radius), k_blocks, seg,
        scratch.data_ptr(), 8 * scratch.numel(), counts.data_ptr(), out.data_ptr(),
        overflow.data_ptr(), _stream())
    _raise_on(rc, "scan")
    chunk_knn_sqdists.launches += 1
    if min(k_blocks, n_blocks) > seg:
        chunk_knn_sqdists.merges += 1
    chunk_knn_sqdists.counts = counts
    return out, overflow


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("chunk_knn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float   # pointers as c_void_p: no 32-bit cut
    ll = ctypes.c_longlong
    lib.ltm_chunk_knn_prep_bytes.argtypes = [i]
    lib.ltm_chunk_knn_prep_bytes.restype = ll
    lib.ltm_chunk_knn_prep.argtypes = [p, p, i, f, p, p, p, i, i, p, ll, p, p, p]
    lib.ltm_chunk_knn_prep.restype = i
    lib.ltm_chunk_knn_scan.argtypes = [p, p, p, i, i, i, i, p, p, p, i, i, p, f, f, i, i, p,
                                       ll, p, p, p, p]
    lib.ltm_chunk_knn_scan.restype = i
    lib.ltm_chunk_knn_config.argtypes = [ctypes.POINTER(i)] * 5
    lib.ltm_chunk_knn_config.restype = None
    lib.ltm_chunk_knn_error_string.argtypes = [i]
    lib.ltm_chunk_knn_error_string.restype = ctypes.c_char_p
    vals = [i() for _ in range(5)]
    lib.ltm_chunk_knn_config(*(ctypes.byref(v) for v in vals))
    got = tuple(v.value for v in vals)
    want = (_MAX_CHUNK, _SLAB, _SUPER, _PREP_CTAS, _COUNTS)
    if got != want:
        raise RuntimeError(f"csrc/chunk_knn.cu has (max chunk, slab, super, prep CTAs, "
                           f"counts) = {got}; the wrapper plans for {want}")
    return lib
