"""``ltm_torch.core.se3`` against ``ltm.core.se3`` under ``jit``, on random
tangents (a third of them with θ < 1e-3, where the Taylor branches run) and
the poses they make, on the CPU.  Tolerance: rtol 1e-5, atol 1e-6."""

import jax
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from ltm.core import se3 as jse3
from ltm_torch.core import se3 as tse3

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def tangents(n=60, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    scale = np.concatenate([np.full(n // 3, 1e-4), np.full(n // 3, 0.05),
                            np.full(n - 2 * (n // 3), 1.0)]).astype(np.float32)
    xi[:, :3] *= scale[:, None]
    xi[:, 3:] *= 5.0
    return xi


def pose_pair():
    a = np.array(jax.jit(jse3.exp)(tangents(seed=1)))
    b = np.array(jax.jit(jse3.exp)(tangents(seed=2)))
    return a, b


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_small_angles_present():
    th = np.linalg.norm(tangents()[:, :3], axis=1)
    assert (th < 1e-3).sum() >= 10


CASES = {
    "exp": lambda lib, a, b, xi: lib.exp(xi),
    "log": lambda lib, a, b, xi: lib.log(a),
    "exp_so3": lambda lib, a, b, xi: lib.exp_so3(xi[:, :3]),
    "log_so3": lambda lib, a, b, xi: lib.log_so3(a[:, :3, :3]),
    "compose": lambda lib, a, b, xi: lib.compose(a, b),
    "inverse": lambda lib, a, b, xi: lib.inverse(a),
    "between": lambda lib, a, b, xi: lib.between(a, b),
    "local": lambda lib, a, b, xi: lib.local(a, b),
    "retract": lambda lib, a, b, xi: lib.retract(a, xi * 0.01),
    "mat_to_quat": lambda lib, a, b, xi: lib.mat_to_quat(a[:, :3, :3]),
    "quat_to_mat": lambda lib, a, b, xi: lib.quat_to_mat(lib.mat_to_quat(a[:, :3, :3])),
    "to_quat_trans": lambda lib, a, b, xi: lib.from_quat_trans(*lib.to_quat_trans(a)),
    "transform_points": lambda lib, a, b, xi: lib.transform_points(a[:, None], xi[:, None, :3]),
    "to_rpy": lambda lib, a, b, xi: lib.from_rpy(*lib.to_rpy(a)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_ltm(name):
    a, b = pose_pair()
    xi = tangents(seed=3)
    ref = jax.jit(lambda a_, b_, x_: CASES[name](jse3, a_, b_, x_))(a, b, xi)
    got = CASES[name](tse3, *(torch.from_numpy(v) for v in (a, b, xi)))
    close(got, ref)


def test_log_inverts_exp():
    """A float32 round trip, not a comparison with ltm: 1e-4 relative."""
    xi = torch.from_numpy(tangents())
    np.testing.assert_allclose(tse3.log(tse3.exp(xi)).numpy(), xi.numpy(), rtol=1e-4, atol=1e-5)


def test_jacobian_of_local_matches_ltm():
    """Forward-mode Jacobians of the between residual at δ=0 (the solver's
    factor blocks) agree with ``jax.jacfwd``."""
    a, b = pose_pair()

    def jr(d, x, y):
        return jse3.local(y, jse3.retract(x, d))

    ref = jax.jit(jax.vmap(jax.jacfwd(jr)))(np.zeros((len(a), 6), np.float32), a, b)
    got = vmap(jacfwd(lambda d, x, y: tse3.local(y, tse3.retract(x, d))))(
        torch.zeros(len(a), 6), torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
