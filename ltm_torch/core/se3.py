"""Batched SO(3)/SE(3) Lie-group operations (port of ``ltm.core.se3``).

Poses are homogeneous ``(..., 4, 4)`` float32 matrices acting on column
vectors; tangent vectors follow the GTSAM order ``[wx, wy, wz, vx, vy, vz]``
(rotation first).  Every function broadcasts over leading batch dimensions
(``ltm`` maps the same bodies with ``vmap``) and is written without
in-place updates, so ``torch.func`` (``jacfwd``, ``jvp``, ``vmap``) can
trace it.  Matrix products are plain float32 ``torch.matmul``: the TF32
pins of ``ltm_torch.device`` keep them at full precision on the card, as
``precision=HIGHEST`` does on the TPU.  Per-pose scalars (θ², quaternion
parts) keep a trailing axis of one: under ``vmap(jacfwd(...))`` an
arithmetic op between a Python float and a 0-d tensor promotes to float64.

The float32-stable forms of ``ltm`` are kept: the half-angle identity for
(1-cos)/θ², Taylor branches below θ = 0.1 with the double-``where``
pattern (finite derivatives at θ = 0), and the quaternion route for the
SO(3) logarithm.
"""

from __future__ import annotations

import torch

__all__ = [
    "hat",
    "vee",
    "exp_so3",
    "log_so3",
    "quat_to_mat",
    "mat_to_quat",
    "from_rot_trans",
    "rotation",
    "translation",
    "identity",
    "compose",
    "inverse",
    "between",
    "exp",
    "log",
    "local",
    "retract",
    "from_rpy",
    "to_rpy",
    "from_quat_trans",
    "to_quat_trans",
    "transform_points",
    "pose_distance",
]

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], -1),
        torch.stack([wz, zeros, -wx], -1),
        torch.stack([-wy, wx, zeros], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sinc_coeffs(theta2: torch.Tensor):
    """Float32-stable A = sin(t)/t, B = (1-cos(t))/t², C = (1-A)/t².

    B uses 1-cos(t) = 2 sin²(t/2); A and C switch to Taylor below t = 0.1,
    from theta² with the double-where pattern."""
    small = theta2 < 1e-2
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0, torch.sin(theta) / theta)
    half_sinc = torch.sin(theta / 2.0) / (theta / 2.0)
    b = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    0.5 * half_sinc * half_sinc)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (1.0 - a) / t2_safe)
    return a, b, c


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map (Rodrigues), (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, -1, keepdim=True)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = torch.matmul(W, W)
    return _eye3_like(W) + a[..., None] * W + b[..., None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm, (..., 3, 3) -> (..., 3), by the quaternion route
    (accurate in float32 near π, where the trace formula is not)."""
    q = mat_to_quat(R)
    qw = q[..., 0:1]
    xyz = q[..., 1:]
    n2 = torch.sum(xyz * xyz, -1, keepdim=True)
    small = n2 < 1e-10
    n2_safe = torch.where(small, torch.ones_like(n2), n2)
    n_safe = torch.sqrt(n2_safe)
    f_large = 2.0 * torch.atan2(n_safe, qw) / n_safe
    qw_safe = torch.clamp(qw, min=_EPS)
    f_small = 2.0 / qw_safe - 2.0 * n2 / (3.0 * qw_safe ** 3)
    return torch.where(small, f_small, f_large) * xyz


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] -> rotation matrix, (..., 4) -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    return torch.stack([
        torch.cat([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.cat([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.cat([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z], branch-free
    (Shepperd): all four pivot candidates, selected by the largest pivot."""
    m00, m01, m02 = R[..., 0, 0:1], R[..., 0, 1:2], R[..., 0, 2:3]
    m10, m11, m12 = R[..., 1, 0:1], R[..., 1, 1:2], R[..., 1, 2:3]
    m20, m21, m22 = R[..., 2, 0:1], R[..., 2, 1:2], R[..., 2, 2:3]
    tr = m00 + m11 + m22
    qw = torch.cat([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.cat([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.cat([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.cat([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    pivots = torch.cat([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], -1)
    case = torch.argmax(pivots, -1)
    cands = torch.stack([qw, qx, qy, qz], -2)                  # (..., component, case)
    idx = case[..., None, None].expand(cands.shape[:-1] + (1,))
    q = torch.gather(cands, -1, idx)[..., 0]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)                  # canonical sign: w >= 0


# ---------------------------------------------------------------------------
# SE(3) as homogeneous 4x4 matrices
# ---------------------------------------------------------------------------

def from_rot_trans(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], -1)
    # built on the device: no host copy, so the sharded solver's products
    # can be captured as a CUDA graph
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]
    return torch.cat([top, bottom.expand(batch + (1, 4))], -2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4))


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group composition a∘b (matmul)."""
    return torch.matmul(a, b)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (no linear solve)."""
    Rt = rotation(T).transpose(-1, -2)
    return from_rot_trans(Rt, -torch.matmul(Rt, translation(T)[..., None])[..., 0])


def between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gtsam traits Between: a^{-1} ∘ b."""
    return compose(inverse(a), b)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map; xi = [w, v] (..., 6) -> (..., 4, 4)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    theta2 = torch.sum(w * w, -1, keepdim=True)
    a, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = torch.matmul(W, W)
    eye = _eye3_like(W)
    R = eye + a[..., None] * W + b[..., None] * W2
    V = eye + b[..., None] * W + c[..., None] * W2
    return from_rot_trans(R, torch.matmul(V, v[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm -> [w, v] (..., 6); inverse of :func:`exp`."""
    R = rotation(T)
    t = translation(T)
    w = log_so3(R)
    theta2 = torch.sum(w * w, -1, keepdim=True)
    W = hat(w)
    W2 = torch.matmul(W, W)
    # V^{-1} = I - W/2 + coeff * W², coeff = (1 - (t/2)·cot(t/2)) / t², with
    # its Taylor form below t = 0.1 (the direct form cancels in float32)
    small = theta2 < 1e-2
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    half = torch.sqrt(t2_safe) / 2.0
    coeff_large = (1.0 - half * torch.cos(half) / torch.sin(half)) / t2_safe
    coeff_small = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    coeff = torch.where(small, coeff_small, coeff_large)
    Vinv = _eye3_like(W) - 0.5 * W + coeff[..., None] * W2
    v = torch.matmul(Vinv, t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def local(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gtsam traits Local(a, b) = Logmap(a^{-1} b): the residual form of every
    factor of the reference graph."""
    return log(between(a, b))


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction T * Exp(xi) (GTSAM Pose3::retract)."""
    return compose(T, exp(xi))


def from_rpy(roll, pitch, yaw, t=None, dtype=torch.float32, device=None) -> torch.Tensor:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll) (gtsam Rot3::RzRyRx)."""
    roll, pitch, yaw = (torch.as_tensor(v, dtype=dtype, device=device) for v in (roll, pitch, yaw))
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    R = torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)
    if t is None:
        t = torch.zeros(R.shape[:-2] + (3,), dtype=dtype, device=R.device)
    return from_rot_trans(R, torch.as_tensor(t, dtype=dtype, device=R.device))


def to_rpy(T: torch.Tensor):
    """Matrix -> (roll, pitch, yaw) with the :func:`from_rpy` convention."""
    R = rotation(T)
    pitch = -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def from_quat_trans(q_xyzw: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """g2o VERTEX_SE3:QUAT order [x, y, z, w] + translation -> 4x4."""
    q_wxyz = torch.cat([q_xyzw[..., 3:4], q_xyzw[..., 0:3]], -1)
    return from_rot_trans(quat_to_mat(q_wxyz), t)


def to_quat_trans(T: torch.Tensor):
    """4x4 -> (q_xyzw, t)."""
    q_wxyz = mat_to_quat(rotation(T))
    return torch.cat([q_wxyz[..., 1:4], q_wxyz[..., 0:1]], -1), translation(T)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) points: R @ p + t (one matmul)."""
    return torch.matmul(pts, rotation(T).transpose(-1, -2)) + translation(T)[..., None, :]


def pose_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean translation distance (reference ``poseDistance``)."""
    return torch.linalg.norm(translation(a) - translation(b), dim=-1)
