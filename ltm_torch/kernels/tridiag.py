"""The pose-graph solver's block-tridiagonal sweeps (K5a): the block-Thomas
factorization and solve of ``ltm``'s odometry-chain preconditioner
(``ltm/graph/solver.py``'s ``_tridiag_factor`` and ``_tridiag_apply``,
sequential scans of 6×6 ops), over the port's chain layout: ``pos``
(n_chains, max_len) variable indices, ``V`` past a chain's end
(``graph/solver.py::_chains``), the independent chains side by side.

:func:`tridiag_factor` and :func:`tridiag_apply` launch the hand-written
kernels of ``ltm_torch/csrc/tridiag.cu`` (a warp a chain for the factor,
two columns of a row of each 6×6 block a lane, no division on the chain;
a CTA a chain and a group of lanes for the solve, its operands staged in
shared memory, one dependent 6×6 mat-vec a step; each one launch) on
CUDA tensors and raise on any other device.  :func:`tridiag_factor_plain` and
:func:`tridiag_apply_plain` are the plain versions, a Python loop of
batched torch ops a step of the longest chain: the CPU route and the
card's reference.  The factor also returns ``P_i = Cinv_{i-1} L_iᵀ``, the
product both versions form on the way to ``C_i``: the kernel's solve runs
on ``P`` and ``Cinv`` (``y_i = r_i − P_iᵀ y_{i-1}``, ``x_i = Cinv_i y_i −
P_{i+1} x_{i+1}``), the plain solve on ``Cinv`` and ``Lc``.
``graph/solver.py``'s ``_tridiag_factor`` and ``_tridiag_apply`` choose
between them by device.  The kernels compute in double for both input
types, so on the card they agree with the plain version to within its own
float32 error, not bit for bit (its products and inverses go to cuBLAS
and a batched LU); each repeats bit for bit.  :func:`card_rule` is that
tolerance, block by block, and :func:`random_chain_system` the random SPD
systems on which ``chip_smoke.py`` and the tests apply it.  The module
builds and imports nothing when it is imported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["tridiag_factor", "tridiag_apply", "tridiag_factor_plain", "tridiag_apply_plain",
           "card_rule", "blockwise_rel_err", "random_chain_system", "step_floor_ms",
           "factor_step_floor_ms", "recip_probe", "RULE_FLOOR"]

RULE_FLOOR = 1e-6   # card_rule's floor on the largest block's relative error


def tridiag_factor_plain(D: torch.Tensor, L: torch.Tensor, pos: torch.Tensor):
    """Block-Thomas factorization of the SPD block-tridiagonal (D, L):
    ``(Cinv, Lc, P)``, ``(n_chains, max_len, 6, 6)`` chain-major blocks:
    ``Cinv`` with ``C_0 = D_0``, ``C_i = D_i − L_i P_i`` (identity past a
    chain's end), the chain-major ``L``, and ``P_i = C_{i-1}⁻¹ L_iᵀ`` (the
    inner product of ``C_i``, zero past a chain's end)."""
    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    Dc = torch.cat([D, eye[None]])[pos]
    Lc = torch.cat([L, torch.zeros_like(eye)[None]])[pos]
    prev = eye.expand(pos.shape[0], 6, 6)
    out, ps = [], []
    for i in range(pos.shape[1]):
        L_i = Lc[:, i]
        P_i = torch.matmul(prev, L_i.transpose(-1, -2))
        C = Dc[:, i] - torch.matmul(L_i, P_i)
        prev = torch.linalg.inv_ex(C).inverse
        out.append(prev)
        ps.append(P_i)
    return torch.stack(out, 1), Lc, torch.stack(ps, 1)


def tridiag_apply_plain(Cinv: torch.Tensor, Lc: torch.Tensor, pos: torch.Tensor,
                        r: torch.Tensor) -> torch.Tensor:
    """Solve M x = r (r: (..., V, 6)) from the factorization: forward
    elimination, then back substitution, over the chains side by side."""
    V = r.shape[-2]
    rc = torch.cat([r, torch.zeros_like(r[..., :1, :])], -2)[..., pos, :]   # (..., n, len, 6)
    n_steps = pos.shape[1]
    u = torch.zeros_like(rc[..., 0, :])
    ys = []
    for i in range(n_steps):
        y_i = rc[..., i, :] - torch.matmul(Lc[:, i], u[..., None])[..., 0]
        u = torch.matmul(Cinv[:, i], y_i[..., None])[..., 0]
        ys.append(y_i)
    x_next = torch.zeros_like(u)
    xs = [None] * n_steps
    for i in range(n_steps - 1, -1, -1):
        L_n = Lc[:, i + 1] if i + 1 < n_steps else torch.zeros_like(Lc[:, 0])
        x_next = torch.matmul(Cinv[:, i], (ys[i] - torch.matmul(L_n.transpose(-1, -2),
                                                                x_next[..., None])[..., 0])[..., None])[..., 0]
        xs[i] = x_next
    xc = torch.stack(xs, -2).flatten(-3, -2)                           # (..., n·len, 6)
    x = torch.zeros(r.shape[:-2] + (V + 1, 6), dtype=r.dtype, device=r.device)
    x.index_copy_(-2, pos.reshape(-1), xc)      # pads (all zero) land on row V
    return x[..., :V, :]


def blockwise_rel_err(got: torch.Tensor, ref: torch.Tensor, block_dims: int) -> float:
    """The largest ``‖got_b − ref_b‖ / ‖ref_b‖`` over the blocks ``b``, each
    the last ``block_dims`` dimensions (2 for ``Cinv``'s 6×6 blocks, 1 for
    the rows of x), in float64: 0 where both are zero, ``inf`` where only
    the reference is.  A block's own scale, so a chain whose entries are
    decades below the largest block's is held as tightly as that block."""
    g, r = got.double().flatten(-block_dims), ref.double().flatten(-block_dims)
    err, size = torch.linalg.vector_norm(g - r, dim=-1), torch.linalg.vector_norm(r, dim=-1)
    rel = torch.where(size > 0, err / torch.where(size > 0, size, 1.0),
                      torch.where(err > 0, torch.inf, 0.0))
    return float(rel.max()) if rel.numel() else 0.0


def card_rule(got: torch.Tensor, plain, inputs, block_dims: int):
    """K5a's tolerance on the card, where the plain version's cuBLAS and
    batched-LU orders cannot be reproduced: ``plain(*inputs)`` in float64
    (the floating inputs cast up) is the reference, and the kernel's
    :func:`blockwise_rel_err` against it must be at most twice the plain
    float32 route's (the inputs cast to float32) measured the same way, or
    :data:`RULE_FLOOR`, and every entry finite.  Returns (the kernel's
    error, the plain float32 route's, the kernel's largest absolute error);
    raises ``AssertionError`` past the limit."""
    ref = plain(*(x.double() if x.is_floating_point() else x for x in inputs))
    p32 = plain(*(x.float() if x.is_floating_point() else x for x in inputs))
    rel = blockwise_rel_err(got, ref, block_dims)
    plain_rel = blockwise_rel_err(p32, ref, block_dims)
    if not (bool(torch.isfinite(got).all()) and rel <= max(2 * plain_rel, RULE_FLOOR)):
        raise AssertionError(f"K5a: largest block's relative error {rel} against the float64 "
                             f"plain version, the plain float32 route's {plain_rel}")
    return rel, plain_rel, float((got.double() - ref).abs().max())


def random_chain_system(rng: np.random.Generator, lengths, dtype, device):
    """A random SPD block-tridiagonal system on chains of ``lengths`` laid
    end to end: ``L`` zero at each chain's start, each diagonal block's
    smallest eigenvalue above the norms of its row's two off-diagonal
    blocks (so SPD), the variables then scaled by factors spread over four
    decades (a pose graph's range); ``pos`` as ``graph/solver.py::_chains``
    lays it out.  (D, L, pos) on ``device``."""
    lengths = np.asarray(lengths, np.int64)
    V, starts = int(lengths.sum()), np.concatenate([[0], np.cumsum(lengths)[:-1]])
    steps = np.arange(int(lengths.max()))
    pos = np.where(steps[None, :] < lengths[:, None], starts[:, None] + steps[None, :], V)
    L = rng.normal(size=(V, 6, 6))
    L[starts] = 0.0
    A = rng.normal(size=(V, 6, 6))
    norm = np.linalg.norm(L, 2, axis=(1, 2))
    margin = norm + np.append(norm[1:], 0.0) + 0.05
    D = A @ A.transpose(0, 2, 1) / 6 + margin[:, None, None] * np.eye(6)
    s = 10.0 ** rng.uniform(-2, 2, V)
    D = D * (s[:, None, None] ** 2)
    L = L * (s[:, None, None] * np.roll(s, 1)[:, None, None])
    return (torch.from_numpy(D).to(device, dtype), torch.from_numpy(L).to(device, dtype),
            torch.from_numpy(pos).to(device))


def _check_pos(pos: torch.Tensor, dev):
    if pos.dim() != 2 or pos.dtype != torch.int64:
        raise ValueError(f"pos must be (n_chains, max_len) int64, got {tuple(pos.shape)} {pos.dtype}")
    if pos.device != dev:
        raise ValueError(f"pos is on {pos.device}, the blocks on {dev}")
    if not pos.is_contiguous():
        raise ValueError("pos must be contiguous")
    if pos.shape[0] >= 2**31 or pos.shape[1] >= 2**31:
        raise ValueError(f"pos {tuple(pos.shape)}: each side must be below 2^31")


def _check_blocks(name: str, x: torch.Tensor, like: torch.Tensor, shape):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64) or x.dtype != like.dtype:
        raise ValueError(f"{name}: float32 or float64 like the others, got {x.dtype}")
    if x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, the others on {like.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_cuda(name: str, x: torch.Tensor):
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} launches a CUDA kernel: {x.device} tensors take "
                           f"{name}_plain")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_lib().ltm_tridiag_error_string(rc).decode()} ({rc})")


def tridiag_factor(D: torch.Tensor, L: torch.Tensor, pos: torch.Tensor):
    """:func:`tridiag_factor_plain` by the kernel ``csrc/tridiag.cu``:
    ``(Cinv, Lc, P)``, each (n_chains, max_len, 6, 6), from ``D``, ``L``
    (V, 6, 6) float32 or float64 and ``pos`` (n_chains, max_len) int64, all
    contiguous on one CUDA device (raises on a CPU tensor).  One launch on
    the current stream, no sync (``tridiag_factor.launches``)."""
    V = D.shape[0] if D.dim() == 3 else -1
    _check_blocks("D", D, D, (V, 6, 6))
    _check_blocks("L", L, D, (V, 6, 6))
    _check_pos(pos, D.device)
    _require_cuda("tridiag_factor", D)
    n, max_len = pos.shape
    Cinv, Lc, P = (D.new_empty((n, max_len, 6, 6)) for _ in range(3))
    dev = D.device.index
    _raise_on(_lib().ltm_tridiag_factor(D.data_ptr(), L.data_ptr(), pos.data_ptr(),
                                        Cinv.data_ptr(), Lc.data_ptr(), P.data_ptr(),
                                        int(D.dtype == torch.float64), n, max_len, V, dev,
                                        torch._C._cuda_getCurrentRawStream(dev)),
              "tridiag_factor")
    tridiag_factor.launches += 1
    return Cinv, Lc, P


tridiag_factor.launches = 0   # kernel launches


def tridiag_apply(Cinv: torch.Tensor, P: torch.Tensor, pos: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
    """:func:`tridiag_apply_plain` by the kernel ``csrc/tridiag.cu``: x
    (..., V, 6) from r (..., V, 6), whose leading dimensions are lanes, and
    :func:`tridiag_factor`'s ``Cinv``, ``P`` and ``pos``, all contiguous on
    one CUDA device, ``Cinv`` and ``P`` 16-byte aligned (raises on a CPU
    tensor).  ``pos`` must place every variable in exactly one chain
    (``graph/solver.py::_chains`` does): the kernel writes each row of x
    once and nothing else.  One launch on the current stream, no sync, and
    no allocation but x and its float64 scratch, so a CUDA graph can capture
    it (``tridiag_apply.launches``: a graph's replays launch without a
    count)."""
    if r.dim() < 2 or r.shape[-1] != 6:
        raise ValueError(f"r must be (..., V, 6), got {tuple(r.shape)}")
    n, max_len = pos.shape if pos.dim() == 2 else (-1, -1)
    _check_blocks("Cinv", Cinv, r, (n, max_len, 6, 6))
    _check_blocks("P", P, r, (n, max_len, 6, 6))
    _check_blocks("r", r, r, r.shape)
    _check_pos(pos, r.device)
    _require_cuda("tridiag_apply", r)
    for name, t in (("Cinv", Cinv), ("P", P)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (its blocks are copied 16 bytes "
                             "at a time)")
    V = r.shape[-2]
    if V >= 2**31:
        raise ValueError(f"tridiag_apply takes fewer than 2^31 variables, got {V}")
    x = torch.empty_like(r)
    lanes = r.numel() // (6 * V) if V else 0
    w = torch.empty((lanes, V, 6), dtype=torch.float64, device=r.device)
    dev = r.device.index
    _raise_on(_lib().ltm_tridiag_apply(Cinv.data_ptr(), P.data_ptr(), pos.data_ptr(),
                                       r.data_ptr(), w.data_ptr(), x.data_ptr(),
                                       int(r.dtype == torch.float64), lanes, n, max_len, V, dev,
                                       torch._C._cuda_getCurrentRawStream(dev)),
              "tridiag_apply")
    tridiag_apply.launches += 1
    return x


tridiag_apply.launches = 0   # kernel launches (a CUDA graph's replays launch without a count)


def _floor_ms(entry: str, m: torch.Tensor, out_len: int, steps: int) -> float:
    """Device ms of one launch of a step-floor kernel (``entry``, one warp,
    ``steps`` steps on the operands ``m``), timed with CUDA events after one
    warm-up launch."""
    dev = m.device
    out = torch.empty(out_len, dtype=torch.float64, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def launch():
        _raise_on(getattr(_lib(), f"ltm_{entry}")(m.data_ptr(), steps, out.data_ptr(), dev.index,
                                                  stream), entry)
    launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def step_floor_ms(steps: int, device) -> float:
    """Device ms of ``steps`` dependent steps of the solve's recurrence with
    every operand in registers (``csrc/tridiag.cu::tridiag_step_floor``, one
    warp): the least time the recurrence takes on the card.  Measurement
    only; no count."""
    dev = _cuda_device(device)
    m = torch.eye(6, dtype=torch.float64, device=dev).flatten() * 0.5
    return _floor_ms("tridiag_step_floor", torch.cat([m, torch.ones(6, dtype=torch.float64,
                                                                     device=dev)]), 32, steps)


def factor_step_floor_ms(steps: int, device) -> float:
    """Device ms of ``steps`` dependent steps of the factor's recurrence
    with every operand in registers (``csrc/tridiag.cu::
    tridiag_factor_step_floor``: lanes 0-5 of one warp, the same SPD D and
    L each step, the products and the Gauss-Jordan inverse as
    ``tridiag_factor`` runs them): the least time the factor's recurrence
    takes on the card.  Measurement only; no count."""
    dev = _cuda_device(device)
    eye = torch.eye(6, dtype=torch.float64, device=dev)
    D = 3.0 * eye + 0.1
    L = 0.4 * eye + 0.05 * torch.arange(36, dtype=torch.float64, device=dev).reshape(6, 6) / 36
    return _floor_ms("tridiag_factor_step_floor", torch.cat([D.flatten(), L.flatten()]), 36, steps)


def recip_probe(x: torch.Tensor):
    """``(seed, y)`` for a contiguous float64 CUDA tensor ``x``: the seed
    ``rcp.approx.ftz.f64`` gives and the reciprocal ``tridiag_factor``
    forms from it (``csrc/tridiag.cu::recip``), so a script can hold them
    to ``1 / x``.  Measurement only; no count."""
    if x.dtype != torch.float64 or x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("recip_probe takes a contiguous float64 CUDA tensor")
    if x.numel() >= 2**31:
        raise ValueError("recip_probe takes fewer than 2^31 values")
    seed, y = torch.empty_like(x), torch.empty_like(x)
    dev = x.device.index
    _raise_on(_lib().ltm_tridiag_recip_probe(x.data_ptr(), seed.data_ptr(), y.data_ptr(),
                                             x.numel(), dev,
                                             torch._C._cuda_getCurrentRawStream(dev)),
              "tridiag_recip_probe")
    return seed, y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ltm_torch.kernels._build import load_kernel

    lib = load_kernel("tridiag")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ltm_tridiag_factor.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ltm_tridiag_factor.restype = i
    lib.ltm_tridiag_apply.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.ltm_tridiag_apply.restype = i
    lib.ltm_tridiag_step_floor.argtypes = [p, i, p, i, p]
    lib.ltm_tridiag_step_floor.restype = i
    lib.ltm_tridiag_factor_step_floor.argtypes = [p, i, p, i, p]
    lib.ltm_tridiag_factor_step_floor.restype = i
    lib.ltm_tridiag_recip_probe.argtypes = [p, p, p, i, i, p]
    lib.ltm_tridiag_recip_probe.restype = i
    lib.ltm_tridiag_error_string.argtypes = [i]
    lib.ltm_tridiag_error_string.restype = ctypes.c_char_p
    return lib
