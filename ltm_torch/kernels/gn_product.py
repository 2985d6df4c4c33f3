"""The pose-graph solver's Gauss-Newton product (K5c): ``v ↦ (JᵀWJ + λI) v``
from the explicit 6×6 factor Jacobian blocks, on (..., V, 6) lanes of
vectors (``ltm/graph/solver.py``'s ``_hvp_from_jacobians``, which XLA
lowers to per-factor einsums and ``.at[].add`` scatters).

The factor ends come in ``ltm``'s order (``graph/solver.py::_FACTOR_ENDS``):
the priors; the between factors' ``i`` then ``j`` ends; the anchored
factors' ``i``, ``j``, ``ai``, ``aj`` ends.  With ``vf`` the vector with its
fixed variables zeroed, each factor's ``y_f`` is the sum over its ends of
``J_e vf[idx_e]`` in that order (a prior's one term; a between factor's two;
an anchored factor's four, from +0.0), and each variable's output row the
sum, in the scatter plan's order from +0.0, of ``J_eᵀ y_f(e)`` over the
ends that name it, plus ``λ v``.  Every 6-term product ``Σ_k J[i, k] x[k]``
is summed in k order with each product and each sum rounded (no FMA).

:func:`gn_product` launches the hand-written kernel ``csrc/gn_product.cu``
on CUDA tensors (two passes: the factors' ``y`` into a scratch, then a
warp a (row, lane tile) over the row's ends; the module docstring of the
source) and raises on any other device.  :func:`gn_product_plain` is the
plain version, elementwise torch ops in the same order: the CPU route and
the card's reference, which the kernel equals bit for bit.
:func:`random_gn_case` makes the random graphs on which ``chip_smoke.py``
and the tests hold them together.  The module builds and imports nothing
when it is imported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ltm_torch.kernels.scatter import ScatterPlan, fixed_order_sum_plain, plan_scatter

__all__ = ["GnPlan", "plan_gn_product", "gn_product", "gn_product_plain", "random_gn_case"]

# the factor families' ends, as positions in the seven end arrays: a prior's
# one end, a between factor's two, an anchored factor's four
_FAMILIES = ((0,), (1, 2), (3, 4, 5, 6))


class GnPlan(NamedTuple):
    """Where the product reads: ``ends``, the scatter plan of the factor
    ends into the variables' rows (``_FACTOR_ENDS`` order, invalid factors
    left out); ``idx``, the seven end index arrays (int32); ``fixed`` (V,)
    uint8, the variables whose entries of ``v`` the factors read as 0."""

    ends: ScatterPlan
    idx: Tuple[torch.Tensor, ...]
    fixed: torch.Tensor


def plan_gn_product(ends: ScatterPlan, idx: Sequence[np.ndarray], fixed: np.ndarray,
                    device) -> GnPlan:
    """The plan of a graph from its host index arrays (``idx``: prior_idx,
    bet_i, bet_j, anc_i, anc_j, anc_ai, anc_aj; ``fixed`` (V,) bool) and the
    scatter plan of its ends."""
    idx = [np.asarray(a, np.int64).reshape(-1) for a in idx]
    sizes = [a.shape[0] for a in idx]
    if len(idx) != 7 or sizes[1] != sizes[2] or len(set(sizes[3:])) != 1:
        raise ValueError(f"the end arrays must be a prior's, a between factor's two and an "
                         f"anchored factor's four, got sizes {sizes}")
    if sum(sizes) != ends.n_src:
        raise ValueError(f"the scatter plan takes {ends.n_src} ends, the arrays {sum(sizes)}")
    V = int(np.asarray(fixed).shape[0])
    if V != ends.order.shape[0]:
        raise ValueError(f"fixed has {V} variables, the scatter plan {ends.order.shape[0]} rows")
    if any(a.size and (a.min() < 0 or a.max() >= V) for a in idx):
        raise ValueError(f"end indices must lie in [0, {V})")
    dev = torch.device(device)
    return GnPlan(ends, tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in idx),
                  torch.from_numpy(np.asarray(fixed, np.uint8)).to(dev))


def _check(jac, plan: GnPlan, v: torch.Tensor):
    if len(jac) != 7:
        raise ValueError(f"jac must hold the seven end arrays' blocks, got {len(jac)}")
    for J, idx in zip(jac, plan.idx):
        if J.shape != (idx.shape[0], 6, 6) or J.dtype != v.dtype or J.device != v.device:
            raise ValueError(f"a block array must be ({idx.shape[0]}, 6, 6) {v.dtype} on "
                             f"{v.device}, got {tuple(J.shape)} {J.dtype} on {J.device}")
    V = plan.fixed.shape[0]
    if v.dim() < 2 or v.shape[-2:] != (V, 6):
        raise ValueError(f"v must be (..., {V}, 6), got {tuple(v.shape)}")
    if v.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the product takes float32 or float64, not {v.dtype}")
    if plan.fixed.device != v.device:
        raise ValueError("the plan must lie on the device of v")


def _mv(J: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``J x`` a factor, (n, 6, 6), (..., n, 6) -> (..., n, 6): ``Σ_k J[:, i, k]
    x[..., k]`` in k order, each product and sum rounded."""
    acc = J[:, :, 0] * x[..., 0:1]
    for k in range(1, 6):
        acc = acc + J[:, :, k] * x[..., k:k + 1]
    return acc


def _mtv(J: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``Jᵀ y`` a factor: ``Σ_i J[:, i, j] y[..., i]`` in i order."""
    acc = J[:, 0, :] * y[..., 0:1]
    for i in range(1, 6):
        acc = acc + J[:, i, :] * y[..., i:i + 1]
    return acc


def gn_product_plain(jac: Sequence[torch.Tensor], plan: GnPlan, v: torch.Tensor,
                     lam) -> torch.Tensor:
    """The plain version of :func:`gn_product`, on any device: each
    family's ``y`` from elementwise ops (:func:`_mv`), every end's
    ``J_eᵀ y_f(e)`` (:func:`_mtv`) concatenated, their fixed-order sum into
    the rows (``fixed_order_sum_plain``), then ``+ λ v``."""
    _check(jac, plan, v)
    vf = torch.where(plan.fixed.bool()[:, None], 0.0, v)
    terms = [_mv(J, vf[..., idx.long(), :]) for J, idx in zip(jac, plan.idx)]
    ys = []
    for fam, ends in enumerate(_FAMILIES):
        y = terms[ends[0]]
        if fam == 2:                       # an anchored factor's sum starts from +0.0
            y = torch.zeros_like(y) + y
        for k in ends[1:]:
            y = y + terms[k]
        ys += [y] * len(ends)
    contrib = torch.cat([_mtv(J, y) for J, y in zip(jac, ys)], -2)
    return fixed_order_sum_plain(contrib, plan.ends) + lam * v


def random_gn_case(rng: np.random.Generator, n_vars: int, n_fac, lanes=(),
                   dtype=torch.float32, device="cpu", valid=0.9, coincide: int = 0):
    """``(jac, plan, v, lam)`` on a random graph of a pose graph's layout:
    two sessions of odometry chains over variables ``[0, n_vars - 3)``
    (priors at each session's first node, fixed with the first anchor),
    ``n_fac = (P, B, A)`` priors, between factors ``(i, i + 1)`` and
    anchored factors from the first session's nodes to the second's
    through the anchors ``n_vars - 3`` and ``n_vars - 2`` (rows of degree
    about A); the last variable is named by no factor (a row of degree 0).
    About ``valid`` of each family is valid (one share, or one a family; the
    others zero blocks, left out of the plan); the first ``coincide`` anchored factors have both anchors
    at ``n_vars - 3``.  Blocks, ``v`` (lanes, n_vars, 6) and ``lam`` from
    ``rng``."""
    if n_vars < 5:
        raise ValueError("the layout needs at least 5 variables")
    P, B, A = n_fac
    nodes = n_vars - 3
    half = max(nodes // 2, 1)
    prior = rng.choice(np.array([0, half]), P)
    bi = rng.integers(0, nodes - 1, B)
    bj = bi + 1
    ai, aj = rng.integers(0, half, A), rng.integers(half, nodes, A)
    aai, aaj = np.full(A, n_vars - 3), np.full(A, n_vars - 2)
    aaj[:coincide] = n_vars - 3
    idx = [prior, bi, bj, ai, aj, aai, aaj]
    fixed = np.zeros(n_vars, bool)
    fixed[[0, n_vars - 3]] = True
    valid = np.broadcast_to(np.asarray(valid, float), (3,))
    ok = [rng.uniform(size=n) < f for n, f in zip((P, B, A), valid)]
    keep = np.concatenate([ok[0], ok[1], ok[1]] + [ok[2]] * 4)
    ends = plan_scatter(np.concatenate(idx), n_vars, device, keep)
    plan = plan_gn_product(ends, idx, fixed, device)
    jac = []
    for k, a in enumerate(idx):
        fam_ok = ok[0 if k == 0 else 1 if k < 3 else 2]
        J = rng.normal(size=(a.shape[0], 6, 6)) * fam_ok[:, None, None]
        jac.append(torch.from_numpy(J).to(device, dtype))
    v = torch.from_numpy(rng.normal(size=tuple(lanes) + (n_vars, 6))).to(device, dtype)
    lam = torch.tensor(float(rng.uniform(1e-4, 1.0)), dtype=dtype, device=device)
    return tuple(jac), plan, v, lam


class _Args(ctypes.Structure):
    """``GnArgs`` of ``csrc/gn_product.cu`` (size checked on load)."""

    _fields_ = [("J", ctypes.c_void_p * 7), ("idx", ctypes.c_void_p * 7),
                ("fixed", ctypes.c_void_p), ("rowptr", ctypes.c_void_p),
                ("cols", ctypes.c_void_p), ("order", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("lam", ctypes.c_void_p), ("y", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n_fac", ctypes.c_int * 3), ("n_vars", ctypes.c_int),
                ("n_lanes", ctypes.c_int), ("dtype", ctypes.c_int)]


def gn_product(jac: Sequence[torch.Tensor], plan: GnPlan, v: torch.Tensor, lam,
               scratch: dict) -> torch.Tensor:
    """(..., V, 6): ``(JᵀWJ + λI) v`` for the lanes of ``v`` (CUDA tensors
    only; ``jac`` the seven contiguous block arrays, ``lam`` a 0-d tensor of
    ``v``'s type on its device), by the kernel (``gn_product.launches``).
    The factors' ``y`` goes to a scratch of (factors, lanes, 6) kept in the
    dict ``scratch`` by lane count and type, made on the first call, so a
    CUDA graph that captures a later call holds the launches alone.  Gives
    :func:`gn_product_plain`'s bits."""
    if v.device.type != "cuda":
        raise RuntimeError(f"gn_product launches its kernel on CUDA tensors, not {v.device}; "
                           "the plain version is gn_product_plain")
    _check(jac, plan, v)
    if not all(J.is_contiguous() for J in jac):
        raise ValueError("the block arrays must be contiguous")
    if not (torch.is_tensor(lam) and lam.dim() == 0 and lam.dtype == v.dtype
            and lam.device == v.device):
        raise ValueError(f"lam must be a 0-d {v.dtype} tensor on {v.device}")
    lanes = math.prod(v.shape[:-2])
    v = v.contiguous()
    out = torch.empty_like(v)
    counts = (plan.idx[0].shape[0], plan.idx[1].shape[0], plan.idx[3].shape[0])
    key = (lanes, v.dtype)
    if key not in scratch:
        scratch[key] = v.new_empty((sum(counts), lanes, 6))
    y = scratch[key]
    a = _Args(n_fac=(ctypes.c_int * 3)(*counts), n_vars=v.shape[-2], n_lanes=lanes,
              dtype=int(v.dtype == torch.float64))
    a.J[:] = [J.data_ptr() for J in jac]
    a.idx[:] = [i.data_ptr() for i in plan.idx]
    e = plan.ends
    a.fixed, a.rowptr, a.cols, a.order = (plan.fixed.data_ptr(), e.rowptr.data_ptr(),
                                          e.cols.data_ptr(), e.order.data_ptr())
    a.v, a.lam, a.y, a.out = v.data_ptr(), lam.data_ptr(), y.data_ptr(), out.data_ptr()
    dev = v.device.index
    rc = _lib().ltm_gn_product(ctypes.byref(a), dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"gn_product launch failed: {_lib().ltm_gn_error_string(rc).decode()} "
                           f"({rc})")
    gn_product.launches += 1
    return out


gn_product.launches = 0   # calls that launched the kernel (a CUDA graph's replays: no count)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("gn_product")
    i = ctypes.c_int
    lib.ltm_gn_product.argtypes = [ctypes.POINTER(_Args), i, ctypes.c_void_p]
    lib.ltm_gn_product.restype = i
    lib.ltm_gn_args_size.restype = i
    lib.ltm_gn_error_string.argtypes = [i]
    lib.ltm_gn_error_string.restype = ctypes.c_char_p
    if lib.ltm_gn_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/gn_product.cu's GnArgs has {lib.ltm_gn_args_size()} bytes; "
                           f"the wrapper's _Args {ctypes.sizeof(_Args)}")
    return lib
