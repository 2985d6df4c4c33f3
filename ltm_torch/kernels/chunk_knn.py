"""Occupancy-adaptive chunked 2-NN over block-structured maps (port of
``ltm.kernels.chunk_knn``): the hand-written CUDA scan
(``ltm_torch/csrc/chunk_knn.cu``, replacing the XLA-lowered
``ltm/kernels/chunk_knn.py::_scan_chunks``), its wrapper and its plain
PyTorch version.

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

``chunk_knn_sqdists`` launches the kernel for CUDA tensors (k = 2) and
takes :func:`_scan_chunks_plain` for CPU tensors; a CUDA call launches the
kernel or raises.  Sorting, the block bounds and the write-back by
``order`` are torch ops on either device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ltm_torch.kernels.blocks import BlockMap
from ltm_torch.kernels.projection import _recip, _sqrt, sumsq3

__all__ = ["ChunkKnnResult", "chunk_knn_sqdists", "chunk_knn_sqdists_plain", "chunk_knn_avg_sqdist"]

_BIG = 1e30
_PAIRS = 1 << 22          # plain version: pairs scored per step (bounds its memory)
_BLOCK_TESTS = 1 << 22    # plain version: chunk x block tests per batch


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
    padded): ``x[:, :h] + x[:, h:]`` until one row is left.  The CUDA scan
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


def _scan_chunks_plain(qx, qm, bm_xyz, t_mask, bval, blo, bhi, clamp_radius: float,
                       k: int, k_blocks: int):
    """Plain PyTorch version of the CUDA scan.  Returns (chunk_overflow (C,)
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
        c = center[cs][:, None, :]
        gap = torch.clamp(torch.maximum(blo[None] - c, c - bhi[None]), min=0.0)
        hit = bval[None] & (_sqrt(sumsq3(gap)) <= reach[cs][:, None])
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


def _chunk_knn(scan, query_xyz, query_mask, bm: BlockMap, target_extra, clamp_radius: float,
               k: int, chunk: int, k_blocks: int, sort_cell: float) -> ChunkKnnResult:
    """Sort, chunk, ``scan`` and write back by ``order`` (either version)."""
    if query_xyz.dtype != torch.float32 or bm.xyz.dtype != torch.float32:
        raise ValueError("chunk kNN takes float32 points")
    if bm.xyz.device != query_xyz.device or query_mask.device != query_xyz.device:
        raise ValueError("queries and the block map must be on one device")
    n = query_xyz.shape[0]
    t_mask, bval, blo, bhi = _block_bounds(bm, target_extra)
    qx, qm, order = _prep_sorted_chunks(query_xyz, query_mask, chunk, sort_cell)
    overflow, d = scan(qx, qm, bm.xyz, t_mask, bval, blo, bhi, clamp_radius, k, k_blocks)
    res = torch.empty((n, k), dtype=torch.float32, device=query_xyz.device)
    res[order] = d.reshape(-1, k)[:n]
    return ChunkKnnResult(res, overflow, order.int())


def chunk_knn_sqdists_plain(query_xyz, query_mask, bm: BlockMap, target_extra,
                            clamp_radius: float, k: int = 2, chunk: int = 512,
                            k_blocks: int = 64, sort_cell: float = 25.0) -> ChunkKnnResult:
    """:func:`chunk_knn_sqdists` through the plain scan, on either device."""
    return _chunk_knn(_scan_chunks_plain, query_xyz, query_mask, bm, target_extra,
                      clamp_radius, k, chunk, k_blocks, sort_cell)


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

    CUDA tensors launch ``csrc/chunk_knn.cu`` once (k = 2 only; counted in
    ``chunk_knn_sqdists.launches``); CPU tensors take the plain version."""
    dev = query_xyz.device
    if dev.type == "cpu":
        return chunk_knn_sqdists_plain(query_xyz, query_mask, bm, target_extra, clamp_radius,
                                       k=k, chunk=chunk, k_blocks=k_blocks, sort_cell=sort_cell)
    if dev.type != "cuda":
        raise ValueError(f"chunk_knn_sqdists runs on cuda or cpu, not {dev}")
    if k != 2:
        raise ValueError(f"the chunk kNN kernel computes k=2, not k={k}")
    return _chunk_knn(_scan_chunks_cuda, query_xyz, query_mask, bm, target_extra,
                      clamp_radius, k, chunk, k_blocks, sort_cell)


chunk_knn_sqdists.launches = 0   # scan kernel launches


def chunk_knn_avg_sqdist(query_xyz, query_mask, bm, target_extra, clamp_radius,
                         k: int = 2, chunk: int = 512, k_blocks: int = 64,
                         sort_cell: float = 25.0):
    """(average of the k clamped NN squared distances (N,), total overflow).
    Rows of overflowed chunks are NaN: callers that need them use
    :func:`chunk_knn_sqdists` and re-resolve those queries."""
    r = chunk_knn_sqdists(query_xyz, query_mask, bm, target_extra, clamp_radius,
                          k=k, chunk=chunk, k_blocks=k_blocks, sort_cell=sort_cell)
    return r.sqdists.mean(-1), r.chunk_overflow.sum()


# ---- the kernel's Python side ---------------------------------------------

def _scan_chunks_cuda(qx, qm, bm_xyz, t_mask, bval, blo, bhi, clamp_radius: float,
                      k: int, k_blocks: int):
    """The kernel route of the scan (k = 2): one launch, one CTA a chunk."""
    C, chunk = qm.shape
    n_blocks, cap = t_mask.shape
    dev = qx.device
    lib = _lib()
    max_chunk, max_cap, max_list = _limits()
    if not (0 < chunk <= max_chunk and 0 < cap <= max_cap):
        raise ValueError(f"chunk kNN kernel takes chunk <= {max_chunk} and block capacity "
                         f"<= {max_cap}, got {chunk} and {cap}")
    if min(k_blocks, n_blocks) > max_list:
        raise ValueError(f"chunk kNN kernel lists at most {max_list} blocks a chunk, "
                         f"got k_blocks={k_blocks} over {n_blocks} blocks")
    if k_blocks < 1 or C * chunk >= 2**31 or n_blocks * cap >= 2**31:
        raise ValueError("chunk kNN kernel: k_blocks >= 1 and fewer than 2^31 slots a side")
    d = torch.empty((C, chunk, 2), dtype=torch.float32, device=dev)
    overflow = torch.empty((C,), dtype=torch.int32, device=dev)
    if C == 0:
        return overflow, d
    args = [x.contiguous() for x in (qx, qm, bm_xyz, t_mask, bval, blo, bhi)]
    with torch.cuda.device(dev):
        rc = lib.ltm_chunk_knn_scan(
            *(x.data_ptr() for x in args), C, chunk, n_blocks, cap,
            ctypes.c_float(clamp_radius), ctypes.c_float(clamp_radius * clamp_radius),
            k_blocks, d.data_ptr(), overflow.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chunk kNN kernel launch failed: "
                           f"{lib.ltm_chunk_knn_error_string(rc).decode()} ({rc})")
    chunk_knn_sqdists.launches += 1
    return overflow, d


@functools.lru_cache(maxsize=None)
def _limits():
    """(largest chunk, largest block capacity, longest block list) the
    kernel takes."""
    i = ctypes.c_int
    vals = i(), i(), i()
    _lib().ltm_chunk_knn_limits(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("chunk_knn")
    p, i = ctypes.c_void_p, ctypes.c_int   # pointers and the stream as c_void_p: no 32-bit cut
    lib.ltm_chunk_knn_scan.argtypes = [p] * 7 + [i] * 4 + [ctypes.c_float] * 2 + [i, p, p, p]
    lib.ltm_chunk_knn_scan.restype = i
    lib.ltm_chunk_knn_limits.argtypes = [ctypes.POINTER(i)] * 3
    lib.ltm_chunk_knn_limits.restype = None
    lib.ltm_chunk_knn_error_string.argtypes = [i]
    lib.ltm_chunk_knn_error_string.restype = ctypes.c_char_p
    return lib
