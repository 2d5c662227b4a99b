"""Constraint solver: primal Newton with an exact piecewise-quadratic line
search, on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/engine/solver.py``. It minimises

  0.5 ||qacc - qacc_smooth||^2_M + 0.5 sum_i D_i [active_i] (J_i qacc - aref_i)^2

warm-started from the cheaper of the previous solution and qacc_smooth.

The reference runs its Newton loop as a ``lax.while_loop`` whose body is a
block of two iterations; under ``vmap`` each env keeps its carry once its
own test fails at a block boundary, and the batch leaves the loop when no
env is live. Here that is a Python loop over blocks of two with a per-env
live mask updated only at block ends, capped by ``opt.solver_iterations``.
Each block costs one host sync (``live.any()``); ``newton_host_syncs``
counts them.
"""
from __future__ import annotations

import torch

from myosuite_mjx_tpu_torch.engine import collision, constraint
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import DSBL_CONTACT, DeviceModel
from myosuite_mjx_tpu_torch.ops import linalg
from myosuite_mjx_tpu_torch.utils import spans

_BLOCK = 2   # Newton iterations between two batch-wide exit tests


def _mv(A, x):
  return (A @ x[..., None])[..., 0]


def _dot(a, b):
  return (a * b).sum(-1)


def _newton_solve(m: DeviceModel, d: Data, J, aref, D, is_eq,
                  iterations: int, ls_iterations: int):
  """Returns (qacc [B, nv], force [B, R], iterations run [B])."""
  qM = d.qM
  x0 = d.qacc_smooth
  B = x0.shape[0]
  tol = m.opt.tolerance * max(m.opt.meaninertia, 1e-12) * max(m.nv, 1)
  ls_tol = m.opt.ls_tolerance
  Jt = J.transpose(-1, -2)

  def weights(jar):
    return D * (is_eq | (jar < 0))

  def cost(qacc):
    jar = _mv(J, qacc) - aref
    dx = qacc - x0
    return 0.5 * (_dot(dx, _mv(qM, dx)) + (weights(jar) * jar * jar).sum(-1))

  def linesearch(p, jar, qMdx, mp):
    jp = _mv(J, p)
    pmx = _dot(p, qMdx)
    pmp = torch.clamp(_dot(p, mp), min=1e-15)

    def dphi_ddphi(alpha):
      jar_a = jar + alpha[:, None] * jp
      wjp = weights(jar_a) * jp
      return (pmx + alpha * pmp + (wjp * jar_a).sum(-1),
              pmp + (wjp * jp).sum(-1))

    d0, dd0 = dphi_ddphi(torch.zeros_like(pmx))
    a0 = torch.clamp(-d0 / dd0, min=1e-10)
    df0, ddf0 = dphi_ddphi(a0)
    # bracket [lo, hi] with dphi(lo) <= 0 <= dphi(hi), growing hi by 16x
    hi, dfh = a0, df0
    for _ in range(4):
      grow = dfh < 0
      hi = torch.where(grow, hi * 16.0, hi)
      dfh = torch.where(grow, dphi_ddphi(hi)[0], dfh)
    lo = torch.where(df0 < 0, a0, torch.zeros_like(a0))
    hi = torch.where(df0 < 0, hi, a0)
    # safeguarded 1D Newton on phi' (piecewise linear), bisection fallback
    alpha, df, ddf = a0, df0, ddf0
    for _ in range(min(ls_iterations, 6)):
      live = df.abs() > ls_tol * pmp
      step = alpha - df / torch.clamp(ddf, min=1e-15)
      mid = 0.5 * (lo + hi)
      nxt = torch.where((step > lo) & (step < hi), step, mid)
      nxt = torch.where(live, nxt, alpha)
      dfn, ddfn = dphi_ddphi(nxt)
      dfn = torch.where(live, dfn, df)
      ddf = torch.where(live, ddfn, ddf)
      lo = torch.where(live & (dfn < 0), nxt, lo)
      hi = torch.where(live & (dfn >= 0), nxt, hi)
      alpha, df = nxt, dfn
    return alpha, jp

  def nt_iter(carry):
    qacc, jar, qMdx, prev_cost, _, it = carry
    w = weights(jar)
    grad = qMdx + _mv(Jt, w * jar)
    H = qM + (Jt * w[:, None, :]) @ J
    p = -linalg.spd_solve(H, grad)
    mp = _mv(qM, p)
    alpha, jp = linesearch(p, jar, qMdx, mp)
    alpha = torch.where(_dot(grad, p) < -1e-16, alpha, torch.zeros_like(alpha))
    qacc_new = qacc + alpha[:, None] * p
    jar_new = jar + alpha[:, None] * jp
    qMdx_new = qMdx + alpha[:, None] * mp
    new_cost = 0.5 * (_dot(qacc_new - x0, qMdx_new)
                      + (weights(jar_new) * jar_new * jar_new).sum(-1))
    improvement = prev_cost - new_cost
    take = improvement > 0
    return (torch.where(take[:, None], qacc_new, qacc),
            torch.where(take[:, None], jar_new, jar),
            torch.where(take[:, None], qMdx_new, qMdx),
            torch.where(take, new_cost, prev_cost),
            improvement, it + 1)

  ws = d.qacc_warmstart
  start = torch.where((cost(ws) < cost(x0))[:, None], ws, x0)
  jar0 = _mv(J, start) - aref
  qMdx0 = _mv(qM, start - x0)
  c0 = 0.5 * (_dot(start - x0, qMdx0) + (weights(jar0) * jar0 * jar0).sum(-1))
  carry = (start, jar0, qMdx0, c0, torch.full_like(c0, float("inf")),
           torch.zeros((B,), dtype=torch.int32, device=x0.device))

  def is_live(c):
    return (c[5] < iterations) & (c[4] > tol)

  live = is_live(carry)
  while True:
    newton_host_syncs.count += 1
    if not bool(live.any()):
      break
    new = carry
    for _ in range(_BLOCK):
      new = nt_iter(new)
    carry = tuple(torch.where(live.view((B,) + (1,) * (n.ndim - 1)), n, c)
                  for n, c in zip(new, carry))
    live = is_live(carry)
  qacc, jar = carry[0], carry[1]
  return qacc, -weights(jar) * jar, carry[5]


class _SyncCounter:
  """Host syncs made by the Newton loop (one per block, plus the exit)."""
  count = 0


newton_host_syncs = _SyncCounter()


def smooth_only(m: DeviceModel, d: Data) -> Data:
  """Constraint-free acceleration: qacc = qacc_smooth."""
  return d.replace(qfrc_constraint=torch.zeros_like(d.qfrc_smooth),
                   qacc=d.qacc_smooth, qacc_warmstart=d.qacc_smooth)


def fwd_constraint(m: DeviceModel, d: Data, full_data: bool = True) -> Data:
  """Constraint forces and the constrained acceleration.

  ``full_data`` also fills the contact set, contact forces and limit-force
  diagnostics (see ``forward``). Contacts, the constraint rows and the
  solve each run in their span, and the solve's per-env iterations feed
  the Newton counter (``utils/spans.py``).
  """
  with spans.span(spans.CONTACTS):
    contact_blocks, contact_info = collision.contacts(m, d)
  with spans.span(spans.MAKE_EFC):
    efc = constraint.make_efc(m, d, contact_blocks)
  with spans.span(spans.NEWTON):
    if efc is None:
      return smooth_only(m, d)
    return _solve(m, d, efc, contact_blocks, contact_info, full_data)


def _solve(m: DeviceModel, d: Data, efc, contact_blocks, contact_info,
           full_data: bool) -> Data:
  """The Newton solve on the rows ``efc``, then its forces scattered into
  Data."""
  J, aref, D, is_eq, _pos, meta = efc
  qacc, force, iterations = _newton_solve(m, d, J, aref, D, is_eq,
                                          int(m.opt.solver_iterations),
                                          int(m.opt.ls_iterations))
  spans.newton_solved(iterations)
  out = d.replace(qfrc_constraint=_mv(J.transpose(-1, -2), force), qacc=qacc,
                  qacc_warmstart=qacc)
  if not full_data:
    return out
  nl = meta["jl_dadr"].numel()
  if nl:
    off = meta["jl_offset"]
    out = out.replace(efc_force_limit=meta["jl_sign"]
                      * force[:, off:off + nl])
  if contact_info is not None and not (m.opt.disableflags & DSBL_CONTACT):
    B, ncon = contact_info.dist.shape
    nrows = contact_blocks["J"].shape[1]
    rows_per = nrows // max(ncon, 1)
    lam = force[:, -nrows:].reshape(B, ncon, rows_per)
    cforce = lam.sum(-1)
    # world-frame force on body2: pyramid rows jn +- mu jf recombine to
    # f_n = sum lam and f_ti = mu_i (lam_i+ - lam_i-)
    f_local = [cforce]
    for i in range(min(rows_per // 2, 2)):
      f_local.append(contact_info.friction[..., i]
                     * (lam[..., 2 * i] - lam[..., 2 * i + 1]))
    while len(f_local) < 3:
      f_local.append(torch.zeros_like(cforce))
    fvec = torch.stack(f_local, dim=-1)                    # [B, ncon, 3]
    force_world = (fvec[..., None] * contact_info.frame).sum(-2)
    out = out.replace(
        contact=contact_info, contact_force=cforce,
        contact_force_vec=force_world,
        ne_active=(contact_info.dist < 0).sum(-1).to(torch.int32),
        ncon_dropped=contact_blocks["dropped"])
  return out
