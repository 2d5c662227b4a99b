"""Muscle actuator model: FLV force curves and activation dynamics.

Counterpart of ``myosuite_mjx_tpu/engine/muscle.py`` (MuJoCo's
mju_muscleGain / mju_muscleBias / mju_muscleDynamics), elementwise over
any leading shape. gainprm/biasprm layout: [range0, range1, force, scale,
lmin, lmax, vmax, fpmax, fvmax]; dynprm: [tau_act, tau_deact, width].
"""
from __future__ import annotations

import torch

_MINVAL = 1e-15


def _clampmin(x: torch.Tensor, lo: float = _MINVAL) -> torch.Tensor:
  return torch.clamp(x, min=lo)


def _bump(L, A, mid, B):
  """Skewed C1 bump: 0 at A and B, 1 at mid (MuJoCo FL curve shape)."""
  left = 0.5 * (A + mid)
  right = 0.5 * (mid + B)
  xl = (L - A) / _clampmin(left - A)
  yl = 0.5 * xl * xl
  xml = (mid - L) / _clampmin(mid - left)
  yml = 1.0 - 0.5 * xml * xml
  xmr = (L - mid) / _clampmin(right - mid)
  ymr = 1.0 - 0.5 * xmr * xmr
  xr = (B - L) / _clampmin(B - right)
  yr = 0.5 * xr * xr
  out = torch.where(L < left, yl,
                    torch.where(L < mid, yml, torch.where(L < right, ymr, yr)))
  return torch.where((L <= A) | (L >= B), torch.zeros_like(out), out)


def _norm_length_vel(length, vel, lengthrange, prm):
  range0, range1 = prm[..., 0], prm[..., 1]
  vmax = prm[..., 6]
  L0 = (lengthrange[..., 1] - lengthrange[..., 0]) / _clampmin(range1 - range0)
  L = range0 + (length - lengthrange[..., 0]) / _clampmin(L0)
  V = vel / _clampmin(L0 * vmax)
  return L, V


def _effective_force(prm, acc0):
  force = prm[..., 2]
  return torch.where(force < 0, prm[..., 3] / _clampmin(acc0), force)


def muscle_gain(length, vel, lengthrange, acc0, prm) -> torch.Tensor:
  """Active force gain: -force * FL(L) * FV(V)."""
  lmin, lmax = prm[..., 4], prm[..., 5]
  fvmax = prm[..., 8]
  L, V = _norm_length_vel(length, vel, lengthrange, prm)
  force = _effective_force(prm, acc0)
  FL = _bump(L, lmin, torch.ones_like(L), lmax)
  y = fvmax - 1.0
  zero = torch.zeros_like(V)
  FV = torch.where(
      V <= -1.0, zero,
      torch.where(V <= 0.0, (V + 1.0) * (V + 1.0),
                  torch.where(V <= y, fvmax - (y - V) * (y - V) / _clampmin(y),
                              fvmax + zero)))
  return -force * FL * FV


def muscle_bias(length, lengthrange, acc0, prm) -> torch.Tensor:
  """Passive force: -force * FP(L)."""
  lmax = prm[..., 5]
  fpmax = prm[..., 7]
  L, _ = _norm_length_vel(length, torch.zeros_like(length), lengthrange, prm)
  force = _effective_force(prm, acc0)
  b = 0.5 * (1.0 + lmax)
  x = (L - 1.0) / _clampmin(b - 1.0)
  FP = torch.where(L <= 1.0, torch.zeros_like(L),
                   torch.where(L <= b, 0.5 * fpmax * x * x, fpmax * (x - 0.5)))
  return -force * FP


def muscle_dynamics(ctrl, act, prm) -> torch.Tensor:
  """Activation rate act_dot (tau_act, tau_deact and the smoothing width)."""
  tau_act, tau_deact, width = prm[..., 0], prm[..., 1], prm[..., 2]
  c = torch.clamp(ctrl, 0.0, 1.0)
  a = torch.clamp(act, 0.0, 1.0)
  dctrl = c - act
  tau_a = tau_act * (0.5 + 1.5 * a)
  tau_d = tau_deact / (0.5 + 1.5 * a)
  sig = _smooth_step(0.5 + dctrl / _clampmin(width))
  blend = torch.where(width <= 0, (dctrl > 0).to(c.dtype), sig)
  tau = tau_d + (tau_a - tau_d) * blend
  return dctrl / _clampmin(tau)


def _smooth_step(x):
  """Quintic smoothstep on [0, 1], clamped outside (mju_sigmoid)."""
  xc = torch.clamp(x, 0.0, 1.0)
  return xc * xc * xc * (3.0 * xc * (2.0 * xc - 5.0) + 10.0)
