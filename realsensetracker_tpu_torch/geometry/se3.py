"""SE(3) Lie-group utilities on torch tensors.

Port of realsensetracker_tpu/geometry/se3.py. Canonical pose: a 4x4 float
matrix ``T`` with ``T[:3,:3]=R``, ``T[:3,3]=t``; points are (..., N, 3) or
lane-major (..., 3, N). All functions broadcast over leading batch dims.
Matrix products are plain f32 ``torch.matmul`` (TF32 stays off: callers
must not enable it, millimetre geometry cannot afford ~1e-3 rounding).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build 4x4 pose(s) from rotation(s) (...,3,3) and translation(s) (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta @ Tb (apply Tb first, then Ta)."""
    return torch.matmul(Ta, Tb)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = rotation(T)
    t = translation(T)
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -torch.matmul(Rt, t[..., :, None])[..., 0])


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply pose(s) to points (..., N, 3)."""
    return torch.matmul(points, rotation(T).transpose(-1, -2)) + translation(T)[..., None, :]


def transform_points_t(T: torch.Tensor, points_t: torch.Tensor) -> torch.Tensor:
    """Apply pose(s) (..., 4, 4) to LANE-MAJOR points (..., 3, N)."""
    return torch.matmul(rotation(T), points_t) + T[..., :3, 3:4]


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project an accumulated pose back onto SE(3) (nearest rotation by SVD).

    Pose-feedback loops amplify rotation denormalization; one 3x3 SVD at
    each accumulation point removes it. Like the reference, a reflection
    (det < 0) is fixed by flipping the third column of the composed R.
    """
    R = rotation(T)
    u, _, vt = torch.linalg.svd(R)
    Rn = torch.matmul(u, vt)
    sign = torch.where(torch.linalg.det(Rn) < 0, -1.0, 1.0)
    Rn = torch.cat([Rn[..., :, :2], Rn[..., :, 2:] * sign[..., None, None]], dim=-1)
    return from_rt(Rn, translation(T))


def accumulate(T_prev: torch.Tensor, T_delta: torch.Tensor) -> torch.Tensor:
    """orthonormalize(compose(T_prev, T_delta))."""
    return orthonormalize(compose(T_prev, T_delta))


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with Taylor branches near zero."""
    theta2 = (w * w).sum(-1)
    W = hat(w)
    W2 = torch.matmul(W, W)
    small = theta2 < 1e-4
    t2s = torch.where(small, 1.0, theta2)  # safe denominator
    ts = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ts)) / t2s)
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse of exp_so3. Valid for theta in [0, pi); stable near zero."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-2
    theta_safe = torch.where(small, 1.0, theta)
    scale = torch.where(
        small, 0.5 + theta**2 / 12.0, theta_safe / (2.0 * torch.sin(theta_safe))
    )
    return scale[..., None] * vee


def exp(twist: torch.Tensor) -> torch.Tensor:
    """se(3) exponential map. twist = (..., 6) as [v (trans), w (rot)]."""
    v = twist[..., :3]
    w = twist[..., 3:]
    theta2 = (w * w).sum(-1)
    W = hat(w)
    W2 = torch.matmul(W, W)
    small = theta2 < 1e-4
    t2s = torch.where(small, 1.0, theta2)
    ts = torch.sqrt(t2s)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(ts)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (ts - torch.sin(ts)) / (t2s * ts))
    V = _eye3_like(W) + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.matmul(V, v[..., :, None])[..., 0]
    return from_rt(exp_so3(w), t)


def log(T: torch.Tensor) -> torch.Tensor:
    """se(3) logarithm map: 4x4 pose -> (..., 6) twist [v, w]."""
    t = translation(T)
    w = log_so3(rotation(T))
    theta2 = (w * w).sum(-1)
    W = hat(w)
    W2 = torch.matmul(W, W)
    small = theta2 < 1e-4
    t2s = torch.where(small, 1.0, theta2)
    ts = torch.sqrt(t2s)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) W^2
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - ts * torch.sin(ts) / (2.0 * (1.0 - torch.cos(ts)))) / t2s,
    )
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * W2
    v = torch.matmul(Vinv, t[..., :, None])[..., 0]
    return torch.cat([v, w], dim=-1)


def quaternion_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), Eigen coeffs() order,
    by branch-free Shepperd-style selection of the largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_root(x):
        return torch.sqrt(torch.clamp(x, min=0.0) + _EPS) * 0.5

    qw0 = half_root(1.0 + tr)
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0], -1) / (4.0 * qw0[..., None])
    qx1 = half_root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], -1) / (4.0 * qx1[..., None])
    qy2 = half_root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20], -1) / (4.0 * qy2[..., None])
    qz3 = half_root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01], -1) / (4.0 * qz3[..., None])
    cand = torch.stack([q0, q1, q2, q3], dim=-2)
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    # Normalize; canonicalize sign (w >= 0) for deterministic output.
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
