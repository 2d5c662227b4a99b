"""Inverse kinematics: damped-least-squares ``qpos_from_site_pose``.

Counterpart of ``myosuite_mjx_tpu/utils/ik.py``: joint positions that bring
a named site to a target position and / or orientation, with L2
regularization while the error is large, a clamp on the update's norm and
a halt when the progress stalls. Batch-first: one target per env, targets
[B, 3] and / or [B, 4], an optional start qpos0 [B, nq], on the model's
device.

The JAX solver is one ``lax.while_loop``; under ``vmap`` every lane runs
until all are done and a finished lane keeps its state. The port keeps the
same per-env state (qpos, err_norm, steps, halt) on the device with a live
mask, and updates only the live envs (``torch.where``), so each env's
result equals JAX's single-target one. It checks ``live.any()`` on the
host once every ``CHECK_EVERY`` iterations only.

The damped normal equations J^T J + reg I are SPD (reg is at least the
dtype's floor), so they go through ``ops/linalg.spd_solve``: on the card
the SPD kernels, float64 included. JAX solves them with
``jnp.linalg.solve`` (LU), so the two differ by rounding.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import data as data_mod
from myosuite_mjx_tpu_torch.engine import forward as forward_mod
from myosuite_mjx_tpu_torch.engine import smooth
from myosuite_mjx_tpu_torch.engine.model import DeviceModel, JointType
from myosuite_mjx_tpu_torch.ops import linalg
from myosuite_mjx_tpu_torch.ops import quat as qmath

_REG_FLOOR = 1e-10
# iterations between host checks of "is any env still live"
CHECK_EVERY = 8


class IKResult(NamedTuple):
  qpos: torch.Tensor      # [B, nq]
  err_norm: torch.Tensor  # [B]: |err_pos| + rot_weight * |err_rot|
  steps: torch.Tensor     # [B] int32: iterations performed
  success: torch.Tensor   # [B] bool: err_norm < tol


def _dof_mask(m: DeviceModel, joint_names: Sequence[str] | None) -> np.ndarray:
  """0/1 mask over nv selecting the dofs of ``joint_names`` (all without)."""
  h = m.host
  if joint_names is None:
    return np.ones((h.nv,), np.float64)
  mask = np.zeros((h.nv,), np.float64)
  ndofs = {JointType.FREE: 6, JointType.BALL: 3, JointType.SLIDE: 1,
           JointType.HINGE: 1}
  for name in joint_names:
    j = h.name2id("joint", name)
    adr = int(h.jnt_dofadr[j])
    mask[adr:adr + ndofs[JointType(int(h.jnt_type[j]))]] = 1.0
  return mask


def qpos_from_site_pose(
    m: DeviceModel,
    site_name: str,
    target_pos: torch.Tensor | None = None,
    target_quat: torch.Tensor | None = None,
    qpos0: torch.Tensor | None = None,
    joint_names: Sequence[str] | None = None,
    tol: float = 1e-10,
    rot_weight: float = 1.0,
    regularization_threshold: float = 0.1,
    regularization_strength: float = 3e-2,
    max_update_norm: float = 2.0,
    progress_thresh: float = 20.0,
    max_steps: int = 100,
) -> IKResult:
  """Solve IK for one site of ``m`` (its device and dtype) for a batch of
  targets: ``target_pos`` [B, 3] and / or ``target_quat`` [B, 4]; ``qpos0``
  [B, nq] seeds the iteration (default: the model's qpos0)."""
  if target_pos is None and target_quat is None:
    raise ValueError(
        "At least one of `target_pos` or `target_quat` must be specified.")
  h = m.host
  dtype, device = m.dtype, m.device
  as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
  tp = None if target_pos is None else as_t(target_pos)
  tq = None if target_quat is None else as_t(target_quat)
  batch = (tp if tp is not None else tq).shape[0]
  sid = h.name2id("site", site_name)
  sbody = int(h.site_bodyid[sid])
  q = (as_t(h.qpos0).expand(batch, -1).clone() if qpos0 is None
       else as_t(qpos0).clone())
  mask = as_t(_dof_mask(m, joint_names))
  # mocap bodies at the Data default
  d0 = data_mod.make_data(m, batch, dtype, device)
  floor = max(float(torch.finfo(dtype).eps) * 1e3, _REG_FLOOR)
  eye = torch.eye(h.nv, dtype=dtype, device=device)

  def residual(qpos):
    kin = smooth.kinematics(m, qpos, mocap_pos=d0.mocap_pos,
                            mocap_quat=d0.mocap_quat)
    _, _, cdof = smooth.com_pos(m, kin)
    sp = kin["site_xpos"][:, sid]
    jacp, jacr = smooth.point_jacobian(m, cdof, sp, sbody)
    rows, errs = [], []
    norm = torch.zeros(batch, dtype=dtype, device=device)
    if tp is not None:
      err_pos = tp - sp
      rows.append(jacp)
      errs.append(err_pos)
      norm = norm + torch.linalg.vector_norm(err_pos, dim=-1)
    if tq is not None:
      site_quat = qmath.mat_to_quat(kin["site_xmat"][:, sid])
      err_rot = qmath.quat_to_vel(
          qmath.quat_mul(tq, qmath.quat_conj(site_quat)))
      rows.append(jacr)
      errs.append(err_rot)
      norm = norm + rot_weight * torch.linalg.vector_norm(err_rot, dim=-1)
    return torch.cat(rows, dim=1), torch.cat(errs, dim=1), norm

  err_norm = torch.full((batch,), float("inf"), dtype=dtype, device=device)
  steps = torch.zeros(batch, dtype=torch.int32, device=device)
  halt = torch.zeros(batch, dtype=torch.bool, device=device)
  for it in range(max_steps):
    live = (steps < max_steps) & (err_norm >= tol) & ~halt
    if it % CHECK_EVERY == 0 and not bool(live.any()):
      break
    jac, err, norm = residual(q)
    jac = jac * mask
    # damped least squares on the normal equations (Buss 2004); the floor
    # scales with the dtype: 1e-10 in float64, ~1e-4 in float32
    reg = torch.where(norm > regularization_threshold,
                      torch.full_like(norm, regularization_strength),
                      torch.full_like(norm, floor))
    jt = jac.transpose(-1, -2)
    hess = jt @ jac + reg[:, None, None] * eye
    dq = linalg.spd_solve(hess, (jt @ err[..., None])[..., 0]) * mask
    update_norm = torch.linalg.vector_norm(dq, dim=-1)
    safe = torch.clamp(update_norm, min=1e-30)
    stalled = norm / safe > progress_thresh
    scale = torch.clamp(max_update_norm / safe, max=1.0)
    qnew = forward_mod._integrate_pos(m, q, dq * scale[:, None], 1.0)
    q = torch.where((live & ~stalled)[:, None], qnew, q)
    err_norm = torch.where(live, norm, err_norm)
    steps = steps + live.to(torch.int32)
    halt = torch.where(live, stalled, halt)
  _, _, err_norm = residual(q)
  return IKResult(qpos=q, err_norm=err_norm, steps=steps,
                  success=err_norm < tol)


def nullspace_method(jac_joints: torch.Tensor, delta: torch.Tensor,
                     regularization_strength: float = 0.0) -> torch.Tensor:
  """Damped least-squares joint update for a batch: jac_joints [B, k, nv],
  delta [B, k] -> [B, nv]; reg is floored at 1e-10 whatever the dtype."""
  jt = jac_joints.transpose(-1, -2)
  hess = jt @ jac_joints
  rhs = (jt @ delta[..., None])[..., 0]
  reg = max(regularization_strength, _REG_FLOOR)
  eye = torch.eye(hess.shape[-1], dtype=hess.dtype, device=hess.device)
  return linalg.spd_solve((hess + reg * eye).contiguous(), rhs)
