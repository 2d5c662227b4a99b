"""Quaternion and rotation math (MuJoCo conventions).

Quaternions are ``[w, x, y, z]``, rotation matrices 3x3 row-major, Euler
angles intrinsic XYZ (MuJoCo's ``eulerseq="xyz"``) unless a name says
otherwise. Every function broadcasts over leading dimensions and has no
data-dependent control flow. Counterpart of ``myosuite_mjx_tpu/ops/quat.py``,
function for function.
"""
from __future__ import annotations

import math

import torch

from myosuite_mjx_tpu_torch.ops.vec import cross as _cross

_EPS = 1e-12


def _unit(like: torch.Tensor, k: int) -> torch.Tensor:
  """The k-th world axis, shaped and typed like ``like`` [..., 3]."""
  e = torch.zeros_like(like)
  e[..., k] = 1.0
  return e


def normalize(v: torch.Tensor) -> torch.Tensor:
  """Safe unit-normalization along the last axis (zero maps to zero)."""
  n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
  return v / torch.clamp(n, min=_EPS)


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
  q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
  q[..., 0] = 1.0
  return q


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product ``u * v``."""
  uw, ux, uy, uz = u.unbind(-1)
  vw, vx, vy, vz = v.unbind(-1)
  return torch.stack([
      uw * vw - ux * vx - uy * vy - uz * vz,
      uw * vx + ux * vw + uy * vz - uz * vy,
      uw * vy - ux * vz + uy * vw + uz * vx,
      uw * vz + ux * vy - uy * vx + uz * vw,
  ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  """Conjugate (the inverse of a unit quaternion)."""
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vectors ``v`` by unit quaternions ``q``."""
  w = q[..., :1]
  u = q[..., 1:]
  u, v = torch.broadcast_tensors(u, v)
  uv = torch.linalg.cross(u, v, dim=-1)
  return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate ``v`` by the inverse of ``q``."""
  return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> 3x3 rotation matrix."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  wx, wy, wz = w * x, w * y, w * z
  xy, xz, yz = x * y, x * z, y * z
  m = torch.stack([
      1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
      2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
      2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
  ], dim=-1)
  return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix -> unit quaternion with w >= 0.

  All four Shepperd candidates are built and the one keyed to the largest
  of (trace, m00, m11, m22) is kept, so every divisor is well conditioned.
  """
  m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
  m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
  m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
  tr = m00 + m11 + m22
  k0 = 1.0 + tr
  k1 = 1.0 + m00 - m11 - m22
  k2 = 1.0 - m00 + m11 - m22
  k3 = 1.0 - m00 - m11 + m22
  best = torch.argmax(torch.stack([k0, k1, k2, k3], dim=-1), dim=-1)
  s0, s1, s2, s3 = (torch.sqrt(torch.clamp(k, min=_EPS))
                    for k in (k0, k1, k2, k3))
  cands = torch.stack([
      torch.stack([s0, (m21 - m12) / s0, (m02 - m20) / s0,
                   (m10 - m01) / s0], dim=-1),
      torch.stack([(m21 - m12) / s1, s1, (m10 + m01) / s1,
                   (m02 + m20) / s1], dim=-1),
      torch.stack([(m02 - m20) / s2, (m10 + m01) / s2, s2,
                   (m21 + m12) / s2], dim=-1),
      torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m21 + m12) / s3,
                   s3], dim=-1),
  ], dim=-2)                                                  # [..., 4, 4]
  idx = best[..., None, None].expand(best.shape + (1, 4))
  q = normalize(torch.gather(cands, -2, idx)[..., 0, :])
  return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """Unit ``axis`` and ``angle`` (rad) -> quaternion."""
  half = 0.5 * angle
  s = torch.sin(half)
  axis, s = torch.broadcast_tensors(axis, s[..., None])
  c = torch.cos(half)[..., None].expand(s.shape[:-1] + (1,))
  return torch.cat([c, axis * s], dim=-1)


def quat_to_axis_angle(q: torch.Tensor):
  """Quaternion -> (unit axis, angle in [0, 2 pi)); the identity rotation
  takes the x axis."""
  sin_half = torch.linalg.vector_norm(q[..., 1:], dim=-1)
  angle = 2.0 * torch.atan2(sin_half, q[..., 0])
  axis = q[..., 1:] / torch.clamp(sin_half, min=_EPS)[..., None]
  axis = torch.where(sin_half[..., None] < 1e-9, _unit(axis, 0), axis)
  return axis, angle


def quat_to_vel(q: torch.Tensor, dt=1.0) -> torch.Tensor:
  """The rotation as an angular velocity over ``dt`` (mju_quat2Vel): angles
  past pi wrap to the shorter way round."""
  axis, angle = quat_to_axis_angle(q)
  angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
  return axis * (angle / dt)[..., None]


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """The 3D rotation taking ``qb`` to ``qa`` (mju_subQuat)."""
  return quat_to_vel(quat_mul(quat_conj(qb), qa))


def quat_diff(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """The quaternion taking ``qa`` into ``qb``: qa^-1 * qb."""
  return quat_mul(quat_conj(qa), qb)


def quat_diff_vel(qa: torch.Tensor, qb: torch.Tensor, dt=1.0) -> torch.Tensor:
  """The angular velocity that carries ``qa`` to ``qb`` over ``dt``."""
  return quat_to_vel(quat_diff(qa, qb), dt)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
  """q * exp(omega dt / 2), normalized: ``omega`` is in the local frame, as
  for ball joints and a free joint's orientation (mju_quatIntegrate)."""
  angle = torch.linalg.vector_norm(omega, dim=-1) * dt
  dq = axis_angle_to_quat(normalize(omega), angle)
  return normalize(quat_mul(q, dq))


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
  """Intrinsic XYZ Euler angles (rad) -> quaternion: qx * qy * qz."""
  c = torch.cos(0.5 * euler)
  s = torch.sin(0.5 * euler)
  cx, cy, cz = c.unbind(-1)
  sx, sy, sz = s.unbind(-1)
  return torch.stack([
      cx * cy * cz - sx * sy * sz,
      sx * cy * cz + cx * sy * sz,
      cx * sy * cz - sx * cy * sz,
      cx * cy * sz + sx * sy * cz,
  ], dim=-1)


def euler_to_mat(euler: torch.Tensor) -> torch.Tensor:
  """Intrinsic XYZ Euler angles -> rotation matrix."""
  return quat_to_mat(euler_to_quat(euler))


def mat_to_euler(m: torch.Tensor) -> torch.Tensor:
  """Rotation matrix R = Rx(ex) Ry(ey) Rz(ez) -> (ex, ey, ez); at gimbal
  lock (|cos ey| <= 1e-6) ez is 0."""
  ey = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
  safe = torch.abs(torch.cos(ey)) > 1e-6
  ex = torch.where(safe, torch.atan2(-m[..., 1, 2], m[..., 2, 2]),
                   torch.atan2(m[..., 2, 1], m[..., 1, 1]))
  ez = torch.where(safe, torch.atan2(-m[..., 0, 1], m[..., 0, 0]),
                   torch.zeros_like(ey))
  return torch.stack([ex, ey, ez], dim=-1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
  return mat_to_euler(quat_to_mat(q))


def euler_intrinsic_to_quat(euler: torch.Tensor) -> torch.Tensor:
  """Roll, pitch, yaw -> quaternion (MyoSuite's intrinsic_euler2quat)."""
  hr, hp, hy = (0.5 * euler).unbind(-1)
  sr, cr = torch.sin(hr), torch.cos(hr)
  sp, cp = torch.sin(hp), torch.cos(hp)
  sy, cy = torch.sin(hy), torch.cos(hy)
  return torch.stack([
      cr * cp * cy + sr * sp * sy,
      sr * cp * cy - cr * sp * sy,
      cr * sp * cy + sr * cp * sy,
      cr * cp * sy - sr * sp * cy,
  ], dim=-1)


def quat_to_euler_intrinsic(q: torch.Tensor) -> torch.Tensor:
  """Quaternion -> roll, pitch, yaw (MyoSuite's quat2euler_intrinsic); the
  pitch saturates at +-pi/2."""
  w, x, y, z = q.unbind(-1)
  roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
  pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
  yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
  return torch.stack([roll, pitch, yaw], dim=-1)


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
  """The skew-symmetric [v]x with [v]x @ u = v x u."""
  x, y, z = v.unbind(-1)
  zero = torch.zeros_like(x)
  m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
  return m.reshape(m.shape[:-1] + (3, 3))


def orthogonals(a: torch.Tensor):
  """Two unit vectors orthogonal to the unit vector ``a``: the world axis
  least aligned with it (y, or z where |a_y| >= 0.9), Gram-Schmidt."""
  ref = torch.where(torch.abs(a[..., 1:2]) < 0.9, _unit(a, 1), _unit(a, 2))
  b = normalize(_cross(a, ref))
  return b, _cross(a, b)
