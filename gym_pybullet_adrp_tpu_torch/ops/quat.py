"""Quaternion and rotation ops, xyzw convention (PyBullet-compatible).

Counterpart of gym_pybullet_adrp_tpu/ops/quat.py, function for function:
the PyBullet quaternion utilities the reference calls every tick
(``getMatrixFromQuaternion``, ``getEulerFromQuaternion``,
``getQuaternionFromEuler``) and the scipy ``Rotation`` uses of its
controllers. Plain PyTorch: the JAX package computes these in XLA,
outside any Pallas kernel.

Every function broadcasts over leading batch axes; the trailing axis is
the vector or quaternion.
"""

import torch

from ..utils.device_consts import const


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# conversions


def from_euler_xyz(rpy):
    """Euler XYZ (roll, pitch, yaw; extrinsic x-y-z, PyBullet convention)
    -> quat xyzw (``p.getQuaternionFromEuler``)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    qw = cr * cp * cy + sr * sp * sy
    return torch.stack([qx, qy, qz, qw], dim=-1)


def to_euler_xyz(q):
    """Quat xyzw -> Euler XYZ (roll, pitch, yaw), PyBullet convention
    (``p.getEulerFromQuaternion``)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    # pitch, clamped for numerical safety at the poles
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return torch.stack([roll, pitch, yaw], dim=-1)


def to_matrix(q):
    """Quat xyzw -> 3x3 rotation matrix (``p.getMatrixFromQuaternion``)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m):
    """3x3 rotation matrix -> quat xyzw (Shepperd's method, branchless:
    all four candidates are computed and the best is selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-20))

    q_w = torch.stack(
        [m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1
    ) / (2.0 * safe_sqrt(1.0 + tr))[..., None]
    q_x = torch.stack(
        [1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1
    ) / (2.0 * safe_sqrt(1.0 + m00 - m11 - m22))[..., None]
    q_y = torch.stack(
        [m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1
    ) / (2.0 * safe_sqrt(1.0 - m00 + m11 - m22))[..., None]
    q_z = torch.stack(
        [m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], dim=-1
    ) / (2.0 * safe_sqrt(1.0 - m00 - m11 + m22))[..., None]

    use_w = (tr > m00) & (tr > m11) & (tr > m22)
    use_x = (m00 >= m11) & (m00 >= m22) & ~use_w
    use_y = (m11 > m22) & ~use_w & ~use_x
    q = torch.where(
        use_w[..., None], q_w,
        torch.where(use_x[..., None], q_x,
                    torch.where(use_y[..., None], q_y, q_z)),
    )
    return normalize(q)


def from_euler_intrinsic_xyz(rpy):
    """Intrinsic-XYZ Euler -> quat xyzw (scipy ``from_euler('XYZ')``):
    q = qx ⊗ qy ⊗ qz."""
    half = rpy * 0.5
    cx, sx = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cy, sy = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cz, sz = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    qw = cx * cy * cz - sx * sy * sz
    qx = sx * cy * cz + cx * sy * sz
    qy = cx * sy * cz - sx * cy * sz
    qz = cx * cy * sz + sx * sy * cz
    return torch.stack([qx, qy, qz, qw], dim=-1)


def to_euler_intrinsic_xyz(q):
    """Quat xyzw -> intrinsic-XYZ Euler angles (scipy ``as_euler('XYZ')``).
    For R = Rx(a)Ry(b)Rz(c): b = asin(R02), a = atan2(-R12, R22),
    c = atan2(-R01, R00)."""
    m = to_matrix(q)
    b = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


# ---------------------------------------------------------------------------
# algebra


def multiply(q1, q2):
    """Hamilton product q1 ⊗ q2, xyzw."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def conjugate(q):
    return q * const((-1.0, -1.0, -1.0, 1.0), q.dtype, q.device)


def normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q (apply R(q) @ v), xyzw."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def rotate_inv(q, v):
    """Rotate v by the inverse of q (apply R(q)^T @ v)."""
    return rotate(conjugate(q), v)


# ---------------------------------------------------------------------------
# integration


def integrate_body(q, omega_body, dt):
    """Integrate quat with body-frame angular velocity over dt: the exact
    axis-angle update of the reference's ``BaseAviary._integrateQ``
    (right multiply). The norm is clamped before the sqrt and the
    division, so the branch discarded at omega = 0 keeps finite
    gradients; q is returned unchanged where ||omega|| <= 1e-8."""
    norm2 = torch.sum(omega_body * omega_body, dim=-1, keepdim=True)
    small = norm2 <= 1e-16
    norm = torch.sqrt(torch.where(small, 1.0, norm2))
    theta = torch.where(small, 0.0, norm) * dt * 0.5
    axis = omega_body / norm
    dq = torch.cat([axis * torch.sin(theta), torch.cos(theta)], dim=-1)
    out = multiply(q, dq)
    return torch.where(small, q, out)


def integrate_world(q, omega_world, dt):
    """Integrate quat with world-frame angular velocity over dt (left
    multiply): the PyBullet-style update of the PYB pipeline."""
    norm2 = torch.sum(omega_world * omega_world, dim=-1, keepdim=True)
    small = norm2 <= 1e-16
    norm = torch.sqrt(torch.where(small, 1.0, norm2))
    theta = torch.where(small, 0.0, norm) * dt * 0.5
    axis = omega_world / norm
    dq = torch.cat([axis * torch.sin(theta), torch.cos(theta)], dim=-1)
    out = multiply(dq, q)
    return torch.where(small, q, out)
