"""Scatter-sums in a fixed order: the pose-graph solver's sums of factor
contributions into variables (``ltm``'s ``.at[].add`` in
``ltm/graph/solver.py``), which ``index_add_`` on the card adds by atomics
in an order that changes from run to run.

A :class:`ScatterPlan` is built once for a graph on the host from its index
array: for each output row, the positions of its contributions, in the
order of the index array (a stable sort).  :func:`fixed_order_sum` adds
them in that order, starting from +0.0 — the order of ``index_add_`` on the
CPU, so it gives ``index_add_``'s CPU bits on every device.  CUDA tensors
launch the hand-written kernel ``ltm_torch/csrc/scatter.cu`` (a warp an
output row, the rows in the plan's order, highest degree first); CPU
tensors take the plain version, :func:`fixed_order_sum_plain` (the plan's
padded table, one column of elementwise adds at a time).  The module builds
and imports nothing when it is imported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["ScatterPlan", "plan_scatter", "fixed_order_sum", "fixed_order_sum_plain"]


class ScatterPlan(NamedTuple):
    """Where each of ``n_rows`` output rows takes its contributions from,
    in order: ``rowptr`` (n_rows + 1,) and ``cols`` (entries listed,) int32,
    the CSR form, and ``order`` (n_rows,) int32, the rows by degree,
    highest first (ties by row), the order the kernel starts them in (its
    layout); ``table`` (n_rows, max_degree) int64, the same lists padded
    with ``n_src`` (a zero row; the plain version's); ``n_src``, the rows of
    the contributions."""

    rowptr: torch.Tensor
    cols: torch.Tensor
    order: torch.Tensor
    table: torch.Tensor
    n_src: int


def plan_scatter(index: np.ndarray, n_rows: int, device, keep=None) -> ScatterPlan:
    """The plan of ``out[index[i]] += src[i]`` for i in order (host NumPy
    ``index`` of length n_src, every entry in [0, n_rows)); with ``keep``
    (bool, like ``index``) only the entries it marks, the others read by no
    row (contributions that are zero: leaving them out of a sum that
    starts at +0.0 leaves its bits as they are)."""
    index = np.asarray(index, np.int64).reshape(-1)
    n_src = index.shape[0]
    if n_src and (index.min() < 0 or index.max() >= n_rows):
        raise ValueError(f"scatter indices must lie in [0, {n_rows})")
    if n_src >= 2**31:
        raise ValueError(f"a scatter plan takes fewer than 2^31 entries, got {n_src}")
    kept = np.arange(n_src) if keep is None else np.flatnonzero(np.asarray(keep, bool))
    order = kept[np.argsort(index[kept], kind="stable")]
    counts = np.bincount(index[kept], minlength=n_rows)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    rows = index[order]
    table = np.full((n_rows, int(counts.max(initial=0))), n_src, np.int64)
    table[rows, np.arange(order.shape[0]) - rowptr[rows]] = order
    by_degree = np.argsort(-counts, kind="stable")
    dev = torch.device(device)
    return ScatterPlan(*(torch.from_numpy(a.astype(np.int32)).to(dev)
                         for a in (rowptr, order, by_degree)),
                       torch.from_numpy(table).to(dev), n_src)


def _check(src: torch.Tensor, plan: ScatterPlan):
    if src.dim() < 2 or src.shape[-2] != plan.n_src:
        raise ValueError(f"src must be (..., {plan.n_src}, width), got {tuple(src.shape)}")
    if src.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fixed_order_sum takes float32 or float64, not {src.dtype}")
    if plan.rowptr.device != src.device:
        raise ValueError("the plan must lie on the device of src")


def fixed_order_sum_plain(src: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """The plain version of :func:`fixed_order_sum`, on any device: the
    padded table one column at a time, each an elementwise add of the
    column's contributions (a padding entry adds +0.0, which leaves a sum
    that starts at +0.0 unchanged)."""
    _check(src, plan)
    padded = torch.cat([src, src.new_zeros(src.shape[:-2] + (1, src.shape[-1]))], -2)
    out = src.new_zeros(src.shape[:-2] + (plan.table.shape[0], src.shape[-1]))
    for c in range(plan.table.shape[1]):
        out = out + padded[..., plan.table[:, c], :]
    return out


def fixed_order_sum(src: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """(..., n_rows, width): each row the sum, in the plan's order from
    +0.0, of the rows of ``src`` (..., n_src, width) listed for it.  CUDA
    tensors launch the kernel (``fixed_order_sum.launches``); CPU tensors
    take :func:`fixed_order_sum_plain`.  The kernel route is called once a
    PCG iteration outside its CUDA graph and ~100 times a solve eagerly, so
    its host work is kept to the checks, the output and one C call."""
    if src.device.type == "cpu":
        return fixed_order_sum_plain(src, plan)
    _check(src, plan)
    if src.device.type != "cuda":
        raise ValueError(f"fixed_order_sum runs on cuda or cpu, not {src.device}")
    width = src.shape[-1]
    n_rows = plan.order.shape[0]
    out = src.new_empty(src.shape[:-2] + (n_rows, width))
    src = src.contiguous()
    dev = src.device.index
    rc = _lib().ltm_fixed_order_sum(src.data_ptr(), plan.rowptr.data_ptr(), plan.cols.data_ptr(),
                                    plan.order.data_ptr(), out.data_ptr(),
                                    int(src.dtype == torch.float64), math.prod(src.shape[:-2]),
                                    plan.n_src, n_rows, width, dev,
                                    torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"fixed_order_sum launch failed: "
                           f"{_lib().ltm_scatter_error_string(rc).decode()} ({rc})")
    fixed_order_sum.launches += 1
    return out


fixed_order_sum.launches = 0   # kernel launches (a CUDA graph's replays launch without a count)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("scatter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ltm_fixed_order_sum.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.ltm_fixed_order_sum.restype = i
    lib.ltm_scatter_error_string.argtypes = [i]
    lib.ltm_scatter_error_string.restype = ctypes.c_char_p
    return lib
