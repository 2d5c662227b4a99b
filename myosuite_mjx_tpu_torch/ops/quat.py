"""Quaternion math for kinematics and integration (MuJoCo conventions).

Quaternions are ``[w, x, y, z]``, rotation matrices 3x3 row-major. Every
function broadcasts over leading dimensions. Only what the ported engine
stages use is here; counterpart of ``myosuite_mjx_tpu/ops/quat.py``.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


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


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vectors ``v`` by unit quaternions ``q``."""
  w = q[..., :1]
  u = q[..., 1:]
  u, v = torch.broadcast_tensors(u, v)
  uv = torch.linalg.cross(u, v, dim=-1)
  return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


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


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """Unit ``axis`` and ``angle`` (rad) -> quaternion."""
  half = 0.5 * angle
  s = torch.sin(half)
  axis, s = torch.broadcast_tensors(axis, s[..., None])
  return torch.cat([torch.cos(half)[..., None], axis * s], dim=-1)
