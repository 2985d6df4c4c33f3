"""The ICP correspondence search (K5b): the hand-written CUDA kernel
``ltm_torch/csrc/nn_argmin.cu``, its launch plan, and a plain mirror of its
cull.

:func:`nn_argmin_select` computes what ``knn.nn_sqdist_argmin_plain``
computes, on CUDA tensors: for each lane and query, the nearest valid
target (the lowest index among equal selection values, whatever the plan
and the order in which the kernel visits the targets) and its exact
squared distance, with the plain version's centring and re-score inside the
launches.  ``knn.nn_sqdist_argmin`` calls it on CUDA tensors; its plain
version is the CPU route and the card's reference.  :func:`prunable` is
the kernel's cull written in float64 with the kernel's directed roundings,
for the CPU tests.  Nothing is built or imported when this module is
imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ltm_torch.kernels.knn2 import _split_len, split_count

__all__ = ["nn_argmin_select", "prunable", "GAMMA"]

# kThreads, kTile, kR (queries a thread), kMaxTiles (tiles a split) of
# csrc/nn_argmin.cu, checked when it loads
_THREADS, _TILE, _R, _MAX_TILES = 128, 256, 4, 256
GAMMA = 2.0 ** -21   # kGamma: the cull's bound on the selection value's relative rounding


def _plan(lanes: int, n: int, m: int, sms: int = 132) -> int:
    """Target splits for ``lanes`` lanes of ``n`` queries against ``m``
    targets each (all > 0) on ``sms`` SMs: K1's rule (``knn2.split_count``)
    on ``_R * _THREADS`` queries of one lane a CTA, tiles of ``_TILE``
    targets and a wave of half the SMs, so the targets split only while the
    query blocks leave SMs without a CTA; and at least enough splits that
    none holds more than ``_MAX_TILES`` tiles (a CTA keeps its split's tile
    boxes in shared memory).  With the cull, a query block's work on the
    farm's point order is the few tiles near it, and each split adds its
    own nearest tiles and its set-up: at the farm's largest call in that
    order one split ran 0.58 ms, ten 0.78 ms (an H100, PERF.md).  The
    splits share their picks exactly, so the result does not depend on
    it."""
    tiles = -(-m // _TILE)
    return max(split_count(lanes * -(-n // (_R * _THREADS)), tiles, max(sms // 2, 1)),
               -(-tiles // _MAX_TILES))


def nn_argmin_select(query_xyz, query_mask, target_xyz, target_mask, counts=None):
    """``(sq_dist, index)`` (..., N) of ``knn.nn_sqdist_argmin_plain`` by
    the kernel: ``query_xyz`` (..., N, 3), ``target_xyz`` (..., M, 3)
    float32, their masks bool, leading dimensions lanes.

    CUDA tensors only: it launches ``csrc/nn_argmin.cu`` on the current
    stream (``nn_argmin_select.launches`` counts the calls that launch the
    scan, ``.merges`` those whose targets split) and raises on any other
    device.  ``counts``, a CUDA int64 tensor of 4, gets the scan's work
    added to it: tiles its warps considered, scored and culled, and the
    update branches they took."""
    args = {"query_xyz": query_xyz, "query_mask": query_mask, "target_xyz": target_xyz,
            "target_mask": target_mask}
    for name, x in args.items():
        want = torch.bool if name.endswith("mask") else torch.float32
        if x.dtype != want:
            raise ValueError(f"{name}: expected {want}, got {x.dtype}")
        if x.device != query_xyz.device:
            raise ValueError(f"{name} is on {x.device}, query_xyz on {query_xyz.device}")
    if query_xyz.device.type != "cuda":
        raise RuntimeError(f"nn_argmin_select launches a CUDA kernel: {query_xyz.device} "
                           "tensors take knn.nn_sqdist_argmin_plain")
    q, t = query_xyz, target_xyz
    if (q.dim() < 2 or t.dim() != q.dim() or q.shape[-1] != 3 or t.shape[-1] != 3
            or query_mask.shape != q.shape[:-1] or t.shape[:-2] != q.shape[:-2]
            or target_mask.shape != t.shape[:-1]):
        raise ValueError(f"shapes query {tuple(q.shape)}, mask {tuple(query_mask.shape)}, "
                         f"target {tuple(t.shape)}, mask {tuple(target_mask.shape)} do not match")
    if counts is not None and (counts.dtype != torch.int64 or counts.shape != (4,)
                               or counts.device != q.device):
        raise ValueError("counts must be an int64 tensor of 4 on the points' device")
    lead, n, m = q.shape[:-2], q.shape[-2], t.shape[-2]
    if m == 0:
        raise ValueError("nn_argmin_select needs at least one target a lane")
    if max(n, m) >= 2**31:
        raise ValueError("nn_argmin kernel takes fewer than 2^31 points a lane")
    dev = q.device
    out_d = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    out_i = torch.empty(lead + (n,), dtype=torch.int64, device=dev)
    lanes = out_d.numel() // n if n else 0
    if lanes == 0:
        return out_d, out_i
    lib = _lib()
    with torch.cuda.device(dev):
        splits, chunk = _device_plan(dev, lanes, n, m)
        t4 = torch.empty((lanes, splits * chunk, 4), dtype=torch.float32, device=dev)
        boxes = torch.empty((lanes, splits * chunk // _TILE, 6), dtype=torch.float32, device=dev)
        keys = (torch.empty(lanes * n, dtype=torch.int64, device=dev) if splits > 1 else None)
        qc, qm, tc, tm = (x.contiguous() for x in (q, query_mask, t, target_mask))
        rc = lib.ltm_nn_argmin(qc.data_ptr(), qm.data_ptr(), tc.data_ptr(), tm.data_ptr(), lanes,
                               n, m, chunk, splits, t4.data_ptr(), boxes.data_ptr(),
                               None if keys is None else keys.data_ptr(), out_d.data_ptr(),
                               out_i.data_ptr(), None if counts is None else counts.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nn_argmin kernel launch failed: "
                           f"{lib.ltm_nn_argmin_error_string(rc).decode()} ({rc})")
    nn_argmin_select.launches += 1
    if splits > 1:
        nn_argmin_select.merges += 1
    return out_d, out_i


nn_argmin_select.launches = 0   # calls that launched the scan
nn_argmin_select.merges = 0     # of those, calls whose targets split (merge launched)


def _round(x: torch.Tensor, up: bool) -> torch.Tensor:
    """float64 ``x`` rounded to float32 toward +inf (``up``) or -inf."""
    f = x.float()
    off = f.double() < x if up else f.double() > x
    return torch.where(off, torch.nextafter(f, torch.full_like(f, torch.inf if up else -torch.inf)),
                       f)


def prunable(q_c: torch.Tensor, lo_c: torch.Tensor, hi_c: torch.Tensor, best: torch.Tensor):
    """The kernel's cull (``csrc/nn_argmin.cu::prunable``) on the CPU: for
    centred float32 queries ``q_c`` (..., 3), a tile's centred box
    ``lo_c``, ``hi_c`` (3,) (``+inf`` on every side for a tile without a
    valid target) and the queries' running bests ``best`` (...), whether
    the gap to the box, squared and rounded down, less ``GAMMA (|q_c|_1 +
    R)²`` rounded up (``R`` the box's corner bound on ``|t_c|_1``), lies
    strictly above the best.  Each float32 operation is taken in float64
    (exact for the products; for a sum, within a double's rounding) and
    rounded in the kernel's direction."""
    d = torch.float64
    q, lo, hi = q_c.to(d), lo_c.to(d), hi_c.to(d)
    empty = bool(torch.isinf(lo_c).all())
    r = torch.zeros((), dtype=torch.float32)
    if not empty:
        for a in range(3):
            r = _round(r.to(d) + torch.maximum(lo[a].abs(), hi[a].abs()), True)
    gap = torch.clamp(torch.maximum(_round(lo - q, False), _round(q - hi, False)), min=0.0)
    sq = _round(gap.double() ** 2, False)
    g2 = _round(_round(sq[..., 0].double() + sq[..., 1], False).double() + sq[..., 2], False)
    an = _round(_round(q[..., 0].abs() + q[..., 1].abs(), True).double() + q[..., 2].abs(), True)
    s = _round(an.double() + r.double(), True)
    slack = _round(GAMMA * _round(s.double() ** 2, True).double(), True)
    return _round(g2.double() - slack.double(), False) > best


def _device_plan(dev, lanes: int, n: int, m: int):
    """``(splits, chunk)``: :func:`_plan` on the CUDA device ``dev``, and
    the targets in each split."""
    splits = _plan(lanes, n, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    return splits, _split_len(m, splits, _TILE)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("nn_argmin")
    p, i = ctypes.c_void_p, ctypes.c_int   # pointers and the stream as c_void_p: no 32-bit cut
    lib.ltm_nn_argmin.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.ltm_nn_argmin.restype = i
    lib.ltm_nn_argmin_config.argtypes = [ctypes.POINTER(i)] * 4
    lib.ltm_nn_argmin_config.restype = None
    lib.ltm_nn_argmin_error_string.argtypes = [i]
    lib.ltm_nn_argmin_error_string.restype = ctypes.c_char_p
    got = (i(), i(), i(), i())
    lib.ltm_nn_argmin_config(*(ctypes.byref(v) for v in got))
    if tuple(v.value for v in got) != (_THREADS, _TILE, _R, _MAX_TILES):
        raise RuntimeError(f"csrc/nn_argmin.cu has threads, tile, R, max tiles = "
                           f"{tuple(v.value for v in got)}; the wrapper plans for "
                           f"{(_THREADS, _TILE, _R, _MAX_TILES)}")
    return lib
