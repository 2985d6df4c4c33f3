"""Brute-force 2-NN squared distances: the hand-written CUDA kernel
(``ltm_torch/csrc/knn2.cu``, replacing the TPU kernel
``ltm/kernels/pallas_knn.py::knn2_sqdists_pallas``), its wrapper and its
plain PyTorch version.

``knn2_sqdists`` runs the kernel for CUDA tensors and the plain version for
CPU tensors; a CUDA call launches the kernel or raises, it never falls back.
Both compute every distance in the direct form ``(qx-tx)² + (qy-ty)² +
(qz-tz)²`` on the original coordinates, as the FMA chain of
``projection.sumsq3`` (the order of ``ltm``'s exact re-score on the CPU), so
they agree bit for bit.
"""

from __future__ import annotations

import ctypes

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


def knn2_sqdists(query_xyz, query_mask, target_xyz, target_mask):
    """(N, 2) squared distances to the two nearest valid targets, ascending.

    CUDA tensors launch ``csrc/knn2.cu`` on the current stream (and count
    the launch in ``knn2_sqdists.launches``); CPU tensors take
    :func:`knn2_sqdists_plain`."""
    if query_xyz.device.type == "cpu":
        return knn2_sqdists_plain(query_xyz, query_mask, target_xyz, target_mask)
    _check(query_xyz, query_mask, target_xyz, target_mask)
    if query_xyz.device.type != "cuda":
        raise ValueError(f"knn2_sqdists runs on cuda or cpu, not {query_xyz.device}")
    n, m = query_xyz.shape[0], target_xyz.shape[0]
    if max(n, m) >= 2**31:
        raise ValueError("knn2 kernel takes fewer than 2^31 points a side")
    tensors = [x.contiguous() for x in (query_xyz, query_mask, target_xyz, target_mask)]
    out = torch.empty((n, 2), dtype=torch.float32, device=query_xyz.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(query_xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ltm_knn2_sqdists(*(x.data_ptr() for x in tensors), out.data_ptr(),
                                  n, m, stream)
    if rc != 0:
        raise RuntimeError(f"knn2 kernel launch failed: "
                           f"{lib.ltm_cuda_error_string(rc).decode()} ({rc})")
    knn2_sqdists.launches += 1
    return out


knn2_sqdists.launches = 0


def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("knn2")
    p = ctypes.c_void_p   # pointers and the stream as c_void_p: no 32-bit truncation
    lib.ltm_knn2_sqdists.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, p]
    lib.ltm_knn2_sqdists.restype = ctypes.c_int
    lib.ltm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ltm_cuda_error_string.restype = ctypes.c_char_p
    return lib
