"""Brute-force 2-NN squared distances: the hand-written CUDA kernel
(``ltm_torch/csrc/knn2.cu``, replacing the TPU kernel
``ltm/kernels/pallas_knn.py::knn2_sqdists_pallas``), its wrapper and its
plain PyTorch version.

``knn2_sqdists`` runs the kernel for CUDA tensors and the plain version for
CPU tensors; a CUDA call launches the kernel or raises, it never falls back.
On the card the wrapper plans the launch (``_plan``: how many target
splits fill the card); a compaction kernel gathers the valid points, the
scan kernel scores only valid pairs and a merge kernel folds the splits'
partial top-2s.  Both compute every distance in the direct form ``(qx-tx)² + (qy-ty)² +
(qz-tz)²`` on the original coordinates, as the FMA chain of
``projection.sumsq3`` (the order of ``ltm``'s exact re-score on the CPU), so
they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ltm_torch.kernels.projection import sumsq3

__all__ = ["knn2_sqdists", "knn2_sqdists_plain"]

_BIG = 1e30
_SLACK = 4   # candidates per tile re-scored exactly by the plain version
_Q_CHUNK, _T_CHUNK = 2048, 8192   # plain version's tile: 64 MB of float32 pairs


def _check(query_xyz, query_mask, target_xyz, target_mask):
    dev = query_xyz.device
    for name, x, dtype, ndim in (("query_xyz", query_xyz, torch.float32, 2),
                                 ("query_mask", query_mask, torch.bool, 1),
                                 ("target_xyz", target_xyz, torch.float32, 2),
                                 ("target_mask", target_mask, torch.bool, 1)):
        if x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name}: expected {ndim}-d {dtype}, got {x.dim()}-d {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, query_xyz on {dev}")
    if query_xyz.shape[1] != 3 or target_xyz.shape[1] != 3:
        raise ValueError("point arrays must be (N, 3)")
    if query_mask.shape[0] != query_xyz.shape[0] or target_mask.shape[0] != target_xyz.shape[0]:
        raise ValueError("each mask must have one entry per point")


def knn2_sqdists_plain(query_xyz, query_mask, target_xyz, target_mask):
    """(N, 2) squared distances to the two nearest valid targets, ascending
    (plain PyTorch): the valid queries against the valid targets in
    (_Q_CHUNK, _T_CHUNK) tiles of direct-form distances, a
    ``topk(2, largest=False)`` per tile and a running top-2 merge.

    Each tile ranks its targets on float32 ``(dx·dx + dy·dy) + dz·dz``
    (cheap elementwise ops) and re-scores its best ``_SLACK`` in the FMA
    chain of ``sumsq3``, which takes float64 steps and would cost several
    times more over every pair.  The two orders differ by at most a couple
    of ulps, so the exact top 2 always lies within the top ``_SLACK``
    unless five targets tie within that band."""
    _check(query_xyz, query_mask, target_xyz, target_mask)
    out = torch.full((query_xyz.shape[0], 2), _BIG, dtype=torch.float32, device=query_xyz.device)
    q_idx = torch.nonzero(query_mask).squeeze(1)
    q = query_xyz[q_idx]
    t = target_xyz[target_mask]
    if q.shape[0] == 0 or t.shape[0] == 0:
        return out
    best_all = []
    for i0 in range(0, q.shape[0], _Q_CHUNK):
        qs = q[i0:i0 + _Q_CHUNK]
        best = torch.full((qs.shape[0], 2), _BIG, dtype=torch.float32, device=q.device)
        for j0 in range(0, t.shape[0], _T_CHUNK):
            ts = t[j0:j0 + _T_CHUNK]
            d = qs[:, 0:1] - ts[None, :, 0]
            d.mul_(d)
            e = qs[:, 1:2] - ts[None, :, 1]
            d.add_(e.mul_(e))
            torch.sub(qs[:, 2:3], ts[None, :, 2], out=e)
            d.add_(e.mul_(e))
            pick = torch.topk(d, min(_SLACK, d.shape[1]), dim=1, largest=False).indices
            cand = sumsq3(qs[:, None, :] - ts[pick])
            best = torch.topk(torch.cat([best, cand], 1), 2, dim=1, largest=False).values
        best_all.append(best)
    out[q_idx] = torch.sort(torch.cat(best_all), dim=1).values
    return out


# ---- launch plan (the kernel's Python side) -------------------------------

# kThreads, kTile, kR (queries a thread) of csrc/knn2.cu, checked when it loads
_THREADS, _TILE, _R = 128, 512, 8
_WAVES = 2                   # CTA waves the grid should reach before targets split


def _plan(n_valid: int, m_valid: int, sms: int = 132, ctas_per_sm: int = 4) -> int:
    """Target splits for ``n_valid`` valid queries against ``m_valid``
    valid targets (both > 0) on ``sms`` SMs that each hold ``ctas_per_sm``
    CTAs of the scan kernel.

    One CTA takes ``_R * _THREADS`` queries.  When those CTAs make fewer than
    ``_WAVES`` waves, the targets are cut into ``splits`` contiguous chunks
    of whole tiles (each CTA scans one chunk and a merge kernel folds the
    partial top-2s): the count in ``[s_min, 2 s_min]`` whose last wave is
    the fullest, the smallest on ties, rounded so that no chunk is empty."""
    q_ctas = -(-n_valid // (_R * _THREADS))
    wave = sms * ctas_per_sm
    tiles = -(-m_valid // _TILE)
    if q_ctas >= _WAVES * wave or tiles == 1:
        return 1

    def no_empty(s):        # chunks of ceil(tiles / s) tiles, and how many that makes
        return -(-tiles // -(-tiles // min(s, tiles)))

    def last_wave_fill(s):
        ctas = q_ctas * s
        return ctas / (-(-ctas // wave) * wave)

    s_min = -(-_WAVES * wave // q_ctas)
    return max(sorted({no_empty(s) for s in range(s_min, 2 * s_min + 1)}), key=last_wave_fill)


def _split_len(m_valid: int, splits: int, tile: int = _TILE) -> int:
    """Targets in each of ``splits`` chunks: whole tiles covering ``m_valid``."""
    tiles = -(-m_valid // tile)
    return -(-tiles // splits) * tile


def knn2_sqdists(query_xyz, query_mask, target_xyz, target_mask):
    """(N, 2) squared distances to the two nearest valid targets, ascending.

    CUDA tensors launch ``csrc/knn2.cu`` on the current stream (and count
    the scan in ``knn2_sqdists.launches``, the merge in
    ``knn2_sqdists.merges``); CPU tensors take :func:`knn2_sqdists_plain`."""
    if query_xyz.device.type == "cpu":
        return knn2_sqdists_plain(query_xyz, query_mask, target_xyz, target_mask)
    _check(query_xyz, query_mask, target_xyz, target_mask)
    if query_xyz.device.type != "cuda":
        raise ValueError(f"knn2_sqdists runs on cuda or cpu, not {query_xyz.device}")
    if max(query_xyz.shape[0], target_xyz.shape[0]) >= 2**31:
        raise ValueError("knn2 kernel takes fewer than 2^31 points a side")
    return _knn2_cuda(query_xyz, query_mask, target_xyz, target_mask)


knn2_sqdists.launches = 0   # scan kernel launches
knn2_sqdists.merges = 0     # merge kernel launches (calls whose targets split)


def _knn2_cuda(query_xyz, query_mask, target_xyz, target_mask):
    """The kernel route of :func:`knn2_sqdists` (inputs checked): the masks'
    prefix sums and one host sync for the two valid counts, then the
    compaction, the scan and, when the plan splits the targets, the merge
    kernel.  No launch when either side has no valid point."""
    dev = query_xyz.device
    n, m = query_xyz.shape[0], target_xyz.shape[0]
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    n_valid = m_valid = 0
    if n and m:
        q_rank, t_rank = torch.cumsum(query_mask, 0), torch.cumsum(target_mask, 0)
        n_valid, m_valid = torch.stack([q_rank[-1], t_rank[-1]]).tolist()
    if n_valid == 0 or m_valid == 0:
        return out.fill_(_BIG)
    lib = _lib()
    with torch.cuda.device(dev):
        splits, chunk = _device_plan(dev, n_valid, m_valid)
        if splits * chunk >= 2**31:
            raise ValueError("knn2 kernel: padded targets exceed 2^31")
        qidx = torch.empty(n_valid, dtype=torch.int32, device=dev)
        t4 = torch.empty((splits * chunk, 4), dtype=torch.float32, device=dev)
        part = torch.empty((splits, n_valid, 2), dtype=torch.float32, device=dev) if splits > 1 else None
        q, qm, t, tm = (x.contiguous() for x in (query_xyz, query_mask, target_xyz, target_mask))
        rc = lib.ltm_knn2_sqdists(
            q.data_ptr(), qm.data_ptr(), q_rank.data_ptr(), n, t.data_ptr(), tm.data_ptr(),
            t_rank.data_ptr(), m, n_valid, m_valid, chunk, splits, qidx.data_ptr(),
            t4.data_ptr(), None if part is None else part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"knn2 kernel launch failed: "
                           f"{lib.ltm_cuda_error_string(rc).decode()} ({rc})")
    knn2_sqdists.launches += 1
    if splits > 1:
        knn2_sqdists.merges += 1
    return out


def _device_plan(dev, n_valid: int, m_valid: int):
    """``(splits, chunk)``: :func:`_plan` on the CUDA device ``dev``, and
    the targets in each split."""
    splits = _plan(n_valid, m_valid, *_residency(dev.index))
    return splits, _split_len(m_valid, splits)


@functools.lru_cache(maxsize=None)
def _residency(dev_index):
    """(SMs, resident CTAs an SM) of the scan kernel on a CUDA device: what
    its registers and shared memory allow."""
    with torch.cuda.device(dev_index):
        ctas = _lib().ltm_knn2_ctas_per_sm()
    sms = torch.cuda.get_device_properties(dev_index).multi_processor_count
    if ctas <= 0:
        raise RuntimeError(f"knn2 kernel: no resident CTA ({ctas})")
    return sms, ctas


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("knn2")
    p, i = ctypes.c_void_p, ctypes.c_int   # pointers and the stream as c_void_p: no 32-bit cut
    lib.ltm_knn2_sqdists.argtypes = [p, p, p, i, p, p, p, i, i, i, i, i, p, p, p, p, p]
    lib.ltm_knn2_sqdists.restype = i
    lib.ltm_knn2_ctas_per_sm.argtypes = []
    lib.ltm_knn2_ctas_per_sm.restype = i
    lib.ltm_knn2_config.argtypes = [ctypes.POINTER(i)] * 3
    lib.ltm_knn2_config.restype = None
    lib.ltm_cuda_error_string.argtypes = [i]
    lib.ltm_cuda_error_string.restype = ctypes.c_char_p
    threads, tile, r = i(), i(), i()
    lib.ltm_knn2_config(ctypes.byref(threads), ctypes.byref(tile), ctypes.byref(r))
    if (threads.value, tile.value, r.value) != (_THREADS, _TILE, _R):
        raise RuntimeError(f"csrc/knn2.cu has threads={threads.value}, tile={tile.value}, "
                           f"R={r.value}; the wrapper plans for {_THREADS}, {_TILE}, {_R}")
    return lib
