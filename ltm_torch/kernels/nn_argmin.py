"""The ICP correspondence search's selection (K5b): the hand-written CUDA
kernel ``ltm_torch/csrc/nn_argmin.cu`` and its launch plan.

:func:`nn_argmin_select` takes what ``kernels/knn.py`` computes with the
plain version's own torch ops (the bbox-centred points and their squared
norms) and returns, for each lane and query, the selection's distance and
the index of the nearest valid target: the lowest index among equal
distances, whatever the plan.  ``knn.nn_sqdist_argmin`` calls it on CUDA
tensors and re-scores the pick exactly; its plain version,
``knn.nn_sqdist_argmin_plain``, is the CPU route and the card's reference.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ltm_torch.kernels.knn2 import _split_len, split_count

__all__ = ["nn_argmin_select"]

# kThreads, kTile, kR (queries a thread) of csrc/nn_argmin.cu, checked when it loads
_THREADS, _TILE, _R = 128, 512, 4


def _plan(lanes: int, n: int, m: int, sms: int = 132, ctas_per_sm: int = 4) -> int:
    """Target splits for ``lanes`` lanes of ``n`` queries against ``m``
    targets each (all > 0) on ``sms`` SMs that each hold ``ctas_per_sm``
    CTAs of the scan kernel: K1's rule (``knn2.split_count``) on
    ``_R * _THREADS`` queries of one lane a CTA and tiles of ``_TILE``
    targets.  The merge is exact, so the result does not depend on it."""
    return split_count(lanes * -(-n // (_R * _THREADS)), -(-m // _TILE), sms * ctas_per_sm)


def nn_argmin_select(q_c, q2, t_c, t2):
    """``(d, index)`` (..., N): for each lane (leading dimensions) and query
    of ``q_c`` (..., N, 3) with squared norms ``q2`` (..., N), the smallest
    ``max((q2 + t2) − 2 q·t, 0)`` over the targets ``t_c`` (..., M, 3) with
    ``t2`` (..., M) (1e30 at an invalid target), and its index (int64), the
    lowest among equal values; (1e30, 0) where no target beats 1e30.

    CUDA tensors only: it launches ``csrc/nn_argmin.cu`` on the current
    stream (``nn_argmin_select.launches`` counts the calls that launch the
    scan, ``.merges`` those whose targets split) and raises on any other
    device."""
    for name, x in (("q_c", q_c), ("q2", q2), ("t_c", t_c), ("t2", t2)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {x.dtype}")
        if x.device != q_c.device:
            raise ValueError(f"{name} is on {x.device}, q_c on {q_c.device}")
    if q_c.device.type != "cuda":
        raise RuntimeError(f"nn_argmin_select launches a CUDA kernel: {q_c.device} tensors "
                           "take knn.nn_sqdist_argmin_plain")
    if (q_c.dim() < 2 or t_c.dim() != q_c.dim() or q_c.shape[-1] != 3 or t_c.shape[-1] != 3
            or q2.shape != q_c.shape[:-1] or t_c.shape[:-2] != q_c.shape[:-2]
            or t2.shape != t_c.shape[:-1]):
        raise ValueError(f"shapes q_c {tuple(q_c.shape)}, q2 {tuple(q2.shape)}, "
                         f"t_c {tuple(t_c.shape)}, t2 {tuple(t2.shape)} do not match")
    lead, n, m = q_c.shape[:-2], q_c.shape[-2], t_c.shape[-2]
    if m == 0:
        raise ValueError("nn_argmin_select needs at least one target a lane")
    if max(n, m) >= 2**31:
        raise ValueError("nn_argmin kernel takes fewer than 2^31 points a lane")
    dev = q_c.device
    out_d = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    out_i = torch.empty(lead + (n,), dtype=torch.int64, device=dev)
    lanes = out_d.numel() // n if n else 0
    if lanes == 0:
        return out_d, out_i
    lib = _lib()
    with torch.cuda.device(dev):
        splits, chunk = _device_plan(dev, lanes, n, m)
        t4 = torch.empty((lanes, splits * chunk, 4), dtype=torch.float32, device=dev)
        part = (torch.empty((splits, lanes * n, 2), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        q, qq, t, tt = (x.contiguous() for x in (q_c, q2, t_c, t2))
        rc = lib.ltm_nn_argmin(q.data_ptr(), qq.data_ptr(), t.data_ptr(), tt.data_ptr(), lanes,
                               n, m, chunk, splits, t4.data_ptr(),
                               None if part is None else part.data_ptr(), out_d.data_ptr(),
                               out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nn_argmin kernel launch failed: "
                           f"{lib.ltm_nn_argmin_error_string(rc).decode()} ({rc})")
    nn_argmin_select.launches += 1
    if splits > 1:
        nn_argmin_select.merges += 1
    return out_d, out_i


nn_argmin_select.launches = 0   # calls that launched the scan
nn_argmin_select.merges = 0     # of those, calls whose targets split (merge launched)


def _device_plan(dev, lanes: int, n: int, m: int):
    """``(splits, chunk)``: :func:`_plan` on the CUDA device ``dev``, and
    the targets in each split."""
    splits = _plan(lanes, n, m, *_residency(dev.index))
    return splits, _split_len(m, splits, _TILE)


@functools.lru_cache(maxsize=None)
def _residency(dev_index):
    """(SMs, resident CTAs an SM) of the scan kernel on a CUDA device."""
    with torch.cuda.device(dev_index):
        ctas = _lib().ltm_nn_argmin_ctas_per_sm()
    sms = torch.cuda.get_device_properties(dev_index).multi_processor_count
    if ctas <= 0:
        raise RuntimeError(f"nn_argmin kernel: no resident CTA ({ctas})")
    return sms, ctas


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("nn_argmin")
    p, i = ctypes.c_void_p, ctypes.c_int   # pointers and the stream as c_void_p: no 32-bit cut
    lib.ltm_nn_argmin.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p, p]
    lib.ltm_nn_argmin.restype = i
    lib.ltm_nn_argmin_ctas_per_sm.argtypes = []
    lib.ltm_nn_argmin_ctas_per_sm.restype = i
    lib.ltm_nn_argmin_config.argtypes = [ctypes.POINTER(i)] * 3
    lib.ltm_nn_argmin_config.restype = None
    lib.ltm_nn_argmin_error_string.argtypes = [i]
    lib.ltm_nn_argmin_error_string.restype = ctypes.c_char_p
    threads, tile, r = i(), i(), i()
    lib.ltm_nn_argmin_config(ctypes.byref(threads), ctypes.byref(tile), ctypes.byref(r))
    if (threads.value, tile.value, r.value) != (_THREADS, _TILE, _R):
        raise RuntimeError(f"csrc/nn_argmin.cu has threads={threads.value}, tile={tile.value}, "
                           f"R={r.value}; the wrapper plans for {_THREADS}, {_TILE}, {_R}")
    return lib
