"""The solver's block-tridiagonal sweeps (K5a, ``kernels/tridiag.py``) on
the CPU.

  * the plain versions (``tridiag_factor_plain``, ``tridiag_apply_plain``)
    against ``ltm``'s sequential sweeps under ``jit``, rtol 1e-4, on chain
    graphs with fixed-variable cuts, ragged chains, isolated variables and
    a graph of one variable, for right-hand sides with no lane, 3 lanes and
    2 × 6 lanes, in float32 and float64 (``ltm`` with 64-bit types on);
  * ``graph/solver.py``'s ``_tridiag_factor`` and ``_tridiag_apply`` give
    the plain versions' bits on CPU tensors;
  * the kernel wrappers raise on CPU tensors, and on wrong shapes, types
    and layouts before that;
  * ``_chains`` places every variable in exactly one chain (the kernel
    writes x through ``pos`` with no fill), as a prefix of its row;
  * ``tridiag_factor_plain``'s ``P`` is its own inner product
    ``Cinv_{i-1} L_iᵀ``, bit for bit;
  * the kernels' arithmetic written out in NumPy (``_factor_mirror``,
    ``_apply_mirror``: a chain's steps up to its last valid entry, padding
    steps as identity steps; the factor's step (``_factor_step``) with
    ``P`` and ``C`` in the kernel's two FMA chains, the Gauss-Jordan inverse
    with diagonal pivots, one FMA an entry (``_fma``, the card's fused
    rounding), each pivot's reciprocal from a model of
    ``rcp.approx.ftz.f64``'s seed and one cubic Newton step (``_recip``,
    within one ulp of ``1/x`` from any seed within 2^-19), double
    arithmetic rounded at each store; the solve on ``P`` and ``Cinv``, one
    mat-vec a dependent step, ``w`` kept in double between the passes) within the
    rule the card holds the kernels to (``tridiag.card_rule``): no further
    from the float64 plain version than twice the plain float32 route, or
    1e-6, block by block (a block's error over its own size); its solve in
    float64 against ``ltm``'s sequential sweep under ``jit`` and the port's
    plain version on random chain systems and phase 8's chain lengths; and
    that rule fails a planted fault of that arithmetic (the L·P term
    dropped, L transposed on one chain, ``C = D − L Pᵀ`` or a pivot taken
    before the previous pivot's update on one chain, P transposed on one
    chain, P_i for P_iᵀ in the forward pass, P_i for P_{i+1} in the back
    pass) on an
    LT-SLAM-like system, where a rule scaled by the largest entry would
    not.

The kernels themselves need the card: ``tests/test_torch_card.py`` and
``chip_smoke.py`` hold them to the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.graph import build_graph_data as j_build
from ltm.graph import solver as jsolver
from ltm_torch.graph import solver as tsolver
from ltm_torch.graph.factors import robust_weights, whitened_residuals
from ltm_torch.kernels import tridiag
from ltm_torch.slam.convert import graph_from_arrays, graph_to_arrays

from test_solver_oracle import _exp_se3
from test_torch_solver import _chain_graph

torch.set_num_threads(1)

LANES = [(), (3,), (2, 6)]
DTYPES = [torch.float32, torch.float64]


def _sessions_graph(seed, lengths, isolated=2):
    """Sessions laid end to end, each an odometry chain whose first
    variable is fixed, loop factors across them, and ``isolated`` variables
    held by a prior alone (chains of one variable)."""
    rng = np.random.default_rng(seed)
    V = sum(lengths) + isolated
    poses = [_exp_se3(rng.normal(scale=0.3, size=6)) for _ in range(V)]
    fixed = np.zeros(V, bool)
    betweens, priors = [], []
    start = 0
    for n in lengths:
        fixed[start] = True
        for i in range(start, start + n - 1):
            betweens.append((i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1]
                             @ _exp_se3(rng.normal(scale=0.01, size=6)), (1e-2,) * 6, False))
        start += n
    for _ in range(4):
        i, j = rng.choice(sum(lengths), 2, replace=False)
        if abs(int(i) - int(j)) > 1:
            betweens.append((int(i), int(j), np.linalg.inv(poses[i]) @ poses[j], (0.5,) * 6, True))
    for v in range(start, V):
        priors.append((v, poses[v], (1e-2,) * 6))
    init = [p @ _exp_se3(rng.normal(scale=0.02, size=6)) for p in poses]
    return j_build(np.asarray(init, np.float32), fixed, priors=priors, betweens=betweens)


def _single_graph():
    """One variable, one prior: one chain of length 1."""
    p = _exp_se3(np.full(6, 0.1))
    return j_build(np.asarray([p], np.float32), np.zeros(1, bool), priors=[(0, p, (1e-2,) * 6)])


GRAPHS = {"two_chains_cuts_loops": lambda: _chain_graph(),
          "ragged_sessions": lambda: _sessions_graph(3, (12, 7, 1, 20)),
          "one_variable": _single_graph}


def _system(name, dtype):
    """(graph, D, L, chains) of the preconditioner at the graph's initial
    poses (float32, as LT-SLAM's graph), cast to ``dtype``."""
    tg = graph_from_arrays(graph_to_arrays(GRAPHS[name]()), "cpu")
    rp, rb, ra = whitened_residuals(tg.poses0, tg)
    _, wb, wa = robust_weights(rp, rb, ra, tg)
    D, L = tsolver._precond_blocks(tg.poses0, tg, wb, wa, torch.tensor(1e-3), tridiag=True)
    return tg, D.to(dtype), L.to(dtype), tsolver._chains(tg)


def _rhs(seed, lanes, V, dtype):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=lanes + (V, 6))).to(dtype)


def _by_variable(blocks_chain, pos, V):
    """Chain-major (n, len, ...) blocks back in variable order (V, ...)."""
    p = pos.numpy()
    out = np.zeros((V,) + blocks_chain.shape[2:], blocks_chain.dtype)
    out[p[p < V]] = blocks_chain[p < V]
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_plain_matches_ltm(name, lanes, dtype):
    tg, D, L, ch = _system(name, dtype)
    V = tg.num_vars
    Cinv, Lc, P = tridiag.tridiag_factor_plain(D, L, ch.pos)
    r = _rhs(1, lanes, V, dtype)
    x = tridiag.tridiag_apply_plain(Cinv, Lc, ch.pos, r).numpy()
    assert x.shape == lanes + (V, 6) and Cinv.shape == ch.pos.shape + (6, 6)
    with jax.enable_x64(dtype == torch.float64):
        Cj = np.asarray(jax.jit(jsolver._tridiag_factor)(D.numpy(), L.numpy()))
        apply = jax.jit(jax.vmap(jsolver._tridiag_apply, in_axes=(None, None, 0)))
        xj = np.asarray(apply(jnp.asarray(Cj), L.numpy(), r.numpy().reshape(-1, V, 6)))
    assert Cj.dtype == D.numpy().dtype
    Cv = _by_variable(Cinv.numpy(), ch.pos, V)
    np.testing.assert_allclose(Cv, Cj, rtol=1e-4, atol=1e-5 * np.abs(Cj).max())
    np.testing.assert_allclose(x.reshape(-1, V, 6), xj, rtol=1e-4, atol=1e-5 * np.abs(xj).max())
    assert np.array_equal(_by_variable(Lc.numpy(), ch.pos, V), L.numpy())
    # past a chain's end: identity and zero
    pad = (ch.pos >= V).numpy()
    assert np.array_equal(Cinv.numpy()[pad], np.broadcast_to(np.eye(6), (pad.sum(), 6, 6)))
    assert not Lc.numpy()[pad].any() and not P.numpy()[pad].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_dispatch_gives_plain_bits_on_cpu(name, dtype):
    tg, D, L, ch = _system(name, dtype)
    r = _rhs(2, (4,), tg.num_vars, dtype)
    Cinv, Lc, P = tsolver._tridiag_factor(D, L, ch)
    Cp, Lp, Pp = tridiag.tridiag_factor_plain(D, L, ch.pos)
    assert torch.equal(Cinv, Cp) and torch.equal(Lc, Lp) and torch.equal(P, Pp)
    assert torch.equal(tsolver._tridiag_apply(Cinv, Lc, P, ch, r),
                       tridiag.tridiag_apply_plain(Cp, Lp, ch.pos, r))
    launches = tridiag.tridiag_factor.launches, tridiag.tridiag_apply.launches
    tsolver._preconditioner(D, L, ch)(r)
    assert (tridiag.tridiag_factor.launches, tridiag.tridiag_apply.launches) == launches


def test_kernel_wrappers_refuse():
    tg, D, L, ch = _system("ragged_sessions", torch.float32)
    Cinv, _, P = tridiag.tridiag_factor_plain(D, L, ch.pos)
    r = _rhs(0, (), tg.num_vars, torch.float32)
    launches = tridiag.tridiag_factor.launches, tridiag.tridiag_apply.launches
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tridiag.tridiag_factor(D, L, ch.pos)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        tridiag.tridiag_apply(Cinv, P, ch.pos, r)
    bad_factor = [(D[:-1], L, ch.pos), (D, L[..., :5], ch.pos), (D.double(), L, ch.pos),
                  (D.half(), L.half(), ch.pos), (D, L, ch.pos.int()), (D, L, ch.pos[0]),
                  (D.transpose(-1, -2), L, ch.pos), (D, L, ch.pos.t())]
    for args in bad_factor:
        with pytest.raises(ValueError):
            tridiag.tridiag_factor(*args)
    bad_apply = [(Cinv, P, ch.pos, r[:, :5]), (Cinv, P, ch.pos, r.double()),
                 (Cinv[:-1], P, ch.pos, r), (Cinv, P[:, :-1], ch.pos, r),
                 (Cinv, P, ch.pos.int(), r), (Cinv, P, ch.pos, r[None].expand(2, -1, -1)),
                 (Cinv, P, ch.pos, r[0])]
    for args in bad_apply:
        with pytest.raises(ValueError):
            tridiag.tridiag_apply(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tridiag.recip_probe(torch.ones(4, dtype=torch.float64))
    assert (tridiag.tridiag_factor.launches, tridiag.tridiag_apply.launches) == launches


@pytest.mark.parametrize("name", list(GRAPHS))
def test_chains_cover_every_variable_once(name):
    tg, _, _, ch = _system(name, torch.float32)
    pos, V = ch.pos.numpy(), tg.num_vars
    assert pos.dtype == np.int64 and pos.min() >= 0 and pos.max() <= V
    valid = pos < V
    assert np.array_equal(np.sort(pos[valid]), np.arange(V))
    assert np.all(valid[:, :-1] >= valid[:, 1:])               # each chain a prefix of its row
    assert valid[:, 0].all() and valid.sum(1).max() == pos.shape[1]


# ---- the kernels' arithmetic, in NumPy -------------------------------------------

def _chain_len(p, V):
    valid = np.flatnonzero((p >= 0) & (p < V))
    return int(valid[-1]) + 1 if len(valid) else 0


_SPLIT = 134217729.0   # 2^27 + 1 (Veltkamp's split of a double into two halves)


def _fma(a, b, c):
    """``a·b + c`` rounded once, as the card's FMA (elementwise, float64):
    the product split exactly into ``p + e`` (Dekker), ``p + c`` summed
    exactly (Knuth), then one rounding of the sum of the parts.  Correct
    to the last bit but for rare double-rounding ties, far inside the card
    rule."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    ah = a * _SPLIT
    ah = ah - (ah - a)
    bh = b * _SPLIT
    bh = bh - (bh - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    z = s - p
    t = (p - (s - z)) + (c - z)
    return s + (t + e)


def _seed(x):
    """A model of ``rcp.approx.ftz.f64``'s seed: ``1/x`` with the low 32
    bits of its pattern cleared, a relative error below 2^-20."""
    y = np.asarray(1.0 / np.asarray(x, np.float64))
    return (y.view(np.int64) & ~np.int64(0xFFFFFFFF)).view(np.float64)


def _recip(x, newton=1):
    """``csrc/tridiag.cu::recip``: the seed, then ``newton`` cubic Newton
    steps ``y (1 + e + e²)``, ``e = 1 − x y`` (one in the kernel)."""
    y = _seed(x)
    for _ in range(newton):
        e = _fma(-x, y, 1.0)
        y = _fma(y, _fma(e, e, e), y)
    return y


def _factor_step(a, d, l, fault=None):
    """``csrc/tridiag.cu::factor_step`` on the running inverse ``a``
    (6×6, row k lane k's), ``D_i`` and ``L_i`` (float64): ``P_i`` row by
    row from ``a`` and the whole ``L_i`` in two FMA chains of three, ``C_i
    = D_i − L_i P_i`` likewise from ``P_i``'s rows, then Gauss-Jordan with
    diagonal pivots, pivot q's row broadcast, its reciprocal ``_recip``,
    one FMA an entry; the kernel forms pivot q + 1 ahead, from the same
    operands as its own lane, so the values are these.  (P_i, Cinv_i).
    ``fault``: ``"seed_only"`` (no Newton step), ``"P_for_Pt"`` (``C = D −
    L Pᵀ``), ``"stale_pivot"`` (pivot q + 1 taken before pivot q's
    update)."""
    s0 = a[:, None, 0] * l[None, :, 0]                      # P[k][c] = sum_m a[k][m] L[c][m]
    s1 = a[:, None, 1] * l[None, :, 1]
    for m in range(2, 6):
        if m % 2 == 0:
            s0 = _fma(a[:, None, m], l[None, :, m], s0)
        else:
            s1 = _fma(a[:, None, m], l[None, :, m], s1)
    P = s0 + s1
    Pm = P.T if fault == "P_for_Pt" else P
    # C[k][c] = D[k][c] - sum_m L[k][m] P[m][c]
    s0 = l[:, 0, None] * Pm[None, 0, :]
    s1 = l[:, 1, None] * Pm[None, 1, :]
    for m in range(2, 6):
        if m % 2 == 0:
            s0 = _fma(l[:, m, None], Pm[None, m, :], s0)
        else:
            s1 = _fma(l[:, m, None], Pm[None, m, :], s1)
    a = d - (s0 + s1)
    stale = a[0, 0]
    for q in range(6):
        row = a[q].copy()
        ip = _recip(stale if fault == "stale_pivot" else row[q],
                    newton=0 if fault == "seed_only" else 1)
        stale = a[min(q + 1, 5), min(q + 1, 5)]
        m = -(a[:, q] * ip)
        m[q] = ip                                           # lane q scales its row by ip
        base = a.copy()
        base[q] = 0.0
        a = _fma(m[:, None], row[None, :], base)
        a[:, q] = m
    return P, a


def _factor_mirror(D, L, pos, fault=None, fault_chain=None):
    """The kernel's factor: a chain's steps up to its last valid entry
    (padding steps D = I, L = 0), ``_factor_step`` in double from the
    inputs cast up, each output rounded once; identity and zero past the
    end.  ``fault``
    (``_factor_step``'s) on chain ``fault_chain``, or every chain when
    None."""
    V, (n, max_len) = D.shape[0], pos.shape
    Cinv = np.broadcast_to(np.eye(6), (n, max_len, 6, 6)).astype(D.dtype)
    Lc = np.zeros((n, max_len, 6, 6), D.dtype)
    P = np.zeros((n, max_len, 6, 6), D.dtype)
    for c in range(n):
        a = np.eye(6)
        here = fault if fault_chain in (None, c) else None
        for i in range(_chain_len(pos[c], V)):
            v = pos[c, i]
            d, l = (D[v], L[v]) if 0 <= v < V else (np.eye(6, dtype=D.dtype), np.zeros((6, 6), D.dtype))
            Lc[c, i] = l
            p, a = _factor_step(a, d.astype(np.float64), l.astype(np.float64), here)
            P[c, i] = p
            Cinv[c, i] = a
    return Cinv, Lc, P


def _apply_mirror(Cinv, P, pos, r, fault=None, fault_chain=None):
    """The kernel's solve: forward ``y_i = r_i − P_iᵀ y_{i−1}``, ``w_i =
    Cinv_i y_i`` (double, kept), back ``x_i = w_i − P_{i+1} x_{i+1}``,
    rounded once at the store.  ``fault`` plants a wrong operand on chain
    ``fault_chain`` (every chain when None): ``"P_untransposed_forward"``
    (``P_i`` for ``P_iᵀ``), ``"P_i_back"`` (``P_i`` for ``P_{i+1}``),
    ``"P_transposed"`` (``P_iᵀ`` for ``P_i`` in both passes)."""
    V, (n, max_len) = r.shape[-2], pos.shape
    x = np.full(r.shape, np.nan, r.dtype)
    for lane in np.ndindex(r.shape[:-2]):
        rl, xl = r[lane], x[lane]
        for c in range(n):
            steps = _chain_len(pos[c], V)
            here = fault if fault_chain in (None, c) else None
            Pc = P[c].astype(np.float64)
            if here == "P_transposed":
                Pc = np.swapaxes(Pc, -1, -2)
            y, w = np.zeros(6), np.zeros((steps, 6))
            for i in range(steps):
                v = pos[c, i]
                Pf = Pc[i] if here == "P_untransposed_forward" else Pc[i].T
                y = (rl[v] if 0 <= v < V else 0.0) - Pf @ y
                w[i] = Cinv[c, i].astype(np.float64) @ y
            xn = np.zeros(6)
            for i in range(steps - 1, -1, -1):
                v = pos[c, i]
                Pb = Pc[i] if here == "P_i_back" else (Pc[i + 1] if i + 1 < steps else np.zeros((6, 6)))
                xn = w[i] - Pb @ xn
                if 0 <= v < V:
                    xl[v] = xn
    return x


def _factor_out(*args):
    return tridiag.tridiag_factor_plain(*args)[0]


def _ltm_factor(D, L, pos):
    """``ltm``'s ``_tridiag_factor`` under ``jit`` (64-bit types on for
    float64; every chain starts with a zero ``L``), chain-major like
    ``Cinv``: identity past a chain's end."""
    with jax.enable_x64(D.dtype == torch.float64):
        Cj = np.asarray(jax.jit(jsolver._tridiag_factor)(D.numpy(), L.numpy()))
    p = pos.numpy()
    out = np.broadcast_to(np.eye(6, dtype=Cj.dtype), p.shape + (6, 6)).copy()
    out[p < D.shape[0]] = Cj[p[p < D.shape[0]]]
    return torch.from_numpy(out)


def _factor_p(*args):
    return tridiag.tridiag_factor_plain(*args)[2]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes", [(), (3,)])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kernel_arithmetic_within_the_card_rule(name, lanes, dtype):
    tg, D, L, ch = _system(name, dtype)
    V = tg.num_vars
    r = _rhs(4, lanes, V, dtype)
    L32 = tridiag.tridiag_factor_plain(D.float(), L.float(), ch.pos)[1]
    Cm, Lm, Pm = _factor_mirror(D.numpy(), L.numpy(), ch.pos.numpy())
    assert np.array_equal(Lm, L32.numpy().astype(Lm.dtype))
    tridiag.card_rule(torch.from_numpy(Cm), _factor_out, (D, L, ch.pos), 2)   # raises past it
    tridiag.card_rule(torch.from_numpy(Cm), _ltm_factor, (D, L, ch.pos), 2)
    tridiag.card_rule(torch.from_numpy(Pm), _factor_p, (D, L, ch.pos), 2)

    Cin, Lin = torch.from_numpy(Cm), torch.from_numpy(Lm)
    xm = _apply_mirror(Cm, Pm, ch.pos.numpy(), r.numpy())
    assert not np.isnan(xm).any()
    tridiag.card_rule(torch.from_numpy(xm), tridiag.tridiag_apply_plain, (Cin, Lin, ch.pos, r), 1)


def _slam_like_system():
    """LT-SLAM's chain layout cut to 200 variables (two long chains, the
    rest chains of one), float32: the long chains' blocks an odometry
    information's size (Cinv up to ~1), the chains of one an unused node
    slot's ``λ·I`` (Cinv ~1e7), so the largest entry of Cinv is a decade
    count above every entry of the long chains."""
    lengths = (1, 1, 1, 80) + (1,) * 12 + (1, 80) + (1,) * 12
    D, L, pos = tridiag.random_chain_system(np.random.default_rng(13), lengths, torch.float64,
                                            "cpu")
    one = torch.from_numpy(np.repeat(np.asarray(lengths), lengths) == 1)
    D[~one], L[~one] = D[~one] * 1e4, L[~one] * 1e4
    D[one] = 1.3e-7 * torch.eye(6, dtype=D.dtype)
    return D.float(), L.float(), pos


def _transposed_on_chain(blocks, rows):
    out = blocks.copy()
    out[rows] = np.swapaxes(out[rows], -1, -2)
    return out


@pytest.mark.parametrize("fault", ["factor_drops_L_P", "factor_transposes_L_on_a_chain",
                                   "factor_P_for_Pt", "factor_stale_pivot",
                                   "apply_transposes_L_on_a_chain", "P_untransposed_forward",
                                   "P_i_back"])
def test_card_rule_catches_a_wrong_sweep(fault):
    """The rule, block by block, fails a planted fault of the kernels'
    arithmetic (in the NumPy mirror) on an LT-SLAM-like system, where a
    rule scaled by the largest entry (the unused slots' ``1/λ``) would pass
    it; the unbroken mirror passes.  The factor's step faults sit on the
    long chain: ``C = D − L Pᵀ`` (``factor_P_for_Pt``) or pivot q + 1 taken
    before pivot q's update (``factor_stale_pivot``), each failing the rule
    on ``Cinv`` and on ``P``.  (A step without its Newton step is within
    the rule, whose 1e-6 floor is above the seed's 2^-20:
    ``test_factor_reciprocal_reaches_double`` and
    ``chip_smoke.recip_check`` hold the reciprocal.)  The solve's faults
    sit on the long chain: its blocks transposed
    (``apply_transposes_L_on_a_chain``: the solve reads L through P),
    ``P_i`` for ``P_iᵀ`` in the forward pass, or ``P_i`` for ``P_{i+1}`` in
    the back pass."""
    D, L, pos = _slam_like_system()
    p, V = pos.numpy(), D.shape[0]
    long_chain = int(np.argmax((p < V).sum(1)))
    long_vars = p[long_chain][p[long_chain] < V]
    Cm, Lm, Pm = _factor_mirror(D.numpy(), L.numpy(), p)
    r = _rhs(6, (2,), V, torch.float32)
    if fault in ("factor_P_for_Pt", "factor_stale_pivot"):
        Cb, _, Pb = _factor_mirror(D.numpy(), L.numpy(), p, fault[len("factor_"):], long_chain)
        tridiag.card_rule(torch.from_numpy(Pm), _factor_p, (D, L, pos), 2)
        with pytest.raises(AssertionError, match="relative error"):
            tridiag.card_rule(torch.from_numpy(Pb), _factor_p, (D, L, pos), 2)
        good, bad = Cm, Cb
        plain, inputs, block_dims = _factor_out, (D, L, pos), 2
    elif fault.startswith("factor"):
        Lbad = np.zeros_like(L.numpy()) if fault == "factor_drops_L_P" else \
            _transposed_on_chain(L.numpy(), long_vars)
        good, bad = Cm, _factor_mirror(D.numpy(), Lbad, p)[0]
        plain, inputs, block_dims = _factor_out, (D, L, pos), 2
    else:
        mirror_fault = "P_transposed" if fault == "apply_transposes_L_on_a_chain" else fault
        good = _apply_mirror(Cm, Pm, p, r.numpy())
        bad = _apply_mirror(Cm, Pm, p, r.numpy(), mirror_fault, long_chain)
        plain, inputs, block_dims = (tridiag.tridiag_apply_plain,
                                     (torch.from_numpy(Cm), torch.from_numpy(Lm), pos, r), 1)
    tridiag.card_rule(torch.from_numpy(good), plain, inputs, block_dims)
    with pytest.raises(AssertionError, match="relative error"):
        tridiag.card_rule(torch.from_numpy(bad), plain, inputs, block_dims)
    # a rule scaled by the largest entry of the reference passes the fault
    ref = plain(*(x.double() if x.is_floating_point() else x for x in inputs)).numpy()
    p32 = plain(*(x.float() if x.is_floating_point() else x for x in inputs)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(bad - ref).max() / scale <= max(2 * np.abs(p32 - ref).max() / scale, 1e-6)


def test_factor_reciprocal_reaches_double():
    """``csrc/tridiag.cu::recip``, the pivots' reciprocal: from any seed
    within 2^-19 of ``1/x`` (``rcp.approx.ftz.f64``'s, below 2^-19.95 on
    the card by ``chip_smoke.recip_check``; the mirror's model ``_seed``),
    its one cubic Newton step lands within one ulp of ``1/x``; the seed
    alone is ~2^-20 off, ~2^32 ulps."""
    rng = np.random.default_rng(7)
    n = 20_000
    x = rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-300, 301, n) * rng.choice([-1.0, 1.0], n)
    ref = 1.0 / x

    def ulps(y):
        return np.abs(y.view(np.int64) - ref.view(np.int64))

    for eps in (2.0 ** -19, -2.0 ** -19, rng.uniform(-2.0 ** -19, 2.0 ** -19, n)):
        y0 = ref * (1.0 - eps)
        e = _fma(-x, y0, 1.0)
        assert ulps(_fma(y0, _fma(e, e, e), y0)).max() <= 1
    assert ulps(_recip(x)).max() <= 1
    assert ulps(_recip(x, newton=0)).max() > 2 ** 20


def test_kernel_arithmetic_padding_steps():
    """A padding entry inside a chain and a row of padding only: identity
    steps and no writes, as the plain versions' padded gathers give."""
    tg, D, L, ch = _system("ragged_sessions", torch.float64)
    V = tg.num_vars
    pos = ch.pos.numpy()
    holed = np.concatenate([pos[:, :1], np.full((pos.shape[0], 1), V), pos[:, 1:]], 1)
    holed = np.concatenate([holed, np.full((1, holed.shape[1]), V)])      # a row of padding
    hp = torch.from_numpy(holed)
    Cref, Lref, Pref = tridiag.tridiag_factor_plain(D, L, hp)
    Cm, Lm, Pm = _factor_mirror(D.numpy(), L.numpy(), holed)
    np.testing.assert_allclose(Cm, Cref.numpy(), rtol=1e-9, atol=1e-12 * np.abs(Cm).max())
    np.testing.assert_allclose(Pm, Pref.numpy(), rtol=1e-9, atol=1e-12 * np.abs(Pm).max())
    assert np.array_equal(Lm, Lref.numpy())
    r = _rhs(5, (2,), V, torch.float64)
    xref = tridiag.tridiag_apply_plain(Cref, Lref, hp, r).numpy()
    np.testing.assert_allclose(_apply_mirror(Cm, Pm, holed, r.numpy()), xref, rtol=1e-9,
                               atol=1e-12 * np.abs(xref).max())


def test_plain_factor_p_is_its_inner_product():
    """``P_i`` is the plain factor's own ``Cinv_{i−1} L_iᵀ`` (the identity
    before the first step), bit for bit, in both types."""
    for dtype in DTYPES:
        tg, D, L, ch = _system("ragged_sessions", dtype)
        Cinv, Lc, P = tridiag.tridiag_factor_plain(D, L, ch.pos)
        prev = torch.cat([torch.eye(6, dtype=dtype).expand(Cinv.shape[0], 1, 6, 6),
                          Cinv[:, :-1]], 1)
        for i in range(P.shape[1]):
            assert torch.equal(P[:, i], torch.matmul(prev[:, i], Lc[:, i].transpose(-1, -2)))


# phase 8's chain layout (chip_smoke.SLAM_CHAIN_LENGTHS): 1 026 variables,
# two chains of 499, 28 of one
PHASE8_LENGTHS = (1, 1, 1, 499) + (1,) * 12 + (1, 499) + (1,) * 12


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("lengths", [(1, 40, 2, 1, 17, 60), PHASE8_LENGTHS],
                         ids=["ragged", "phase8"])
def test_new_recurrence_matches_ltm_and_plain(lengths, lanes):
    """The kernel's factor (``_factor_mirror``, float64) and solve
    (``_apply_mirror`` on the mirror factor's ``P`` and ``Cinv``) against
    ``ltm``'s sequential sweeps under ``jit``
    (64-bit types on, over the variables in order: every chain starts with
    a zero ``L``) and the port's plain versions, on ``random_chain_system``:
    block by block within 1e-9 of each (float64 rounding over chains of up
    to 499 steps, the systems' blocks spread over eight decades)."""
    rng = np.random.default_rng(len(lengths) + lanes)
    D, L, pos = tridiag.random_chain_system(rng, lengths, torch.float64, "cpu")
    V = D.shape[0]
    r = torch.from_numpy(rng.normal(size=(lanes, V, 6)))
    Cm, Lm, Pm = _factor_mirror(D.numpy(), L.numpy(), pos.numpy())
    xm = torch.from_numpy(_apply_mirror(Cm, Pm, pos.numpy(), r.numpy()))
    Cp, Lp, _ = tridiag.tridiag_factor_plain(D, L, pos)
    xp = tridiag.tridiag_apply_plain(Cp, Lp, pos, r)
    with jax.enable_x64(True):
        Cj = jax.jit(jsolver._tridiag_factor)(D.numpy(), L.numpy())
        apply = jax.jit(jax.vmap(jsolver._tridiag_apply, in_axes=(None, None, 0)))
        xj = torch.from_numpy(np.asarray(apply(Cj, L.numpy(), r.numpy())))
    assert xj.dtype == torch.float64
    assert tridiag.blockwise_rel_err(xm, xj, 1) <= 1e-9
    assert tridiag.blockwise_rel_err(xm, xp, 1) <= 1e-9
    assert tridiag.blockwise_rel_err(torch.from_numpy(Cm), _ltm_factor(D, L, pos), 2) <= 1e-9
    assert tridiag.blockwise_rel_err(torch.from_numpy(Cm), Cp, 2) <= 1e-9
