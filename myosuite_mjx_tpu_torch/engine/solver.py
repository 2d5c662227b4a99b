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

``route`` picks how a solve runs from what its inputs show: device, dtype,
nv, grad, and a capture under way.

- On the card, float32 or float64 with nv <= 64: one launch of the fused
  kernel (``csrc/newton_solve.cu``, ``cuda_linalg.newton_solve_cuda``),
  a warp per env running ``_steps``' arithmetic from the warm start to
  that env's own exit. No block runs on the host and nothing syncs.
- On the card otherwise (nv > 64): each block is one replay of a CUDA
  graph (``_Staged``): the solve's inputs are copied into static buffers
  kept per shape, and the warm-start prologue (part 0) and one block
  (part 1: ``_BLOCK`` iterations, the per-env merge, the new live mask
  and its ``any``) are captured once each (``engine/graphs.py``). The
  host loop replays the block and reads the flag, one sync a block. The
  graphs hold the eager code's kernels, so each env's exit and every
  result are the eager loop's bit for bit.
- The CPU, inputs that require grad and a capture already under way take
  the eager loop, the reference of the other two.
"""
from __future__ import annotations

import torch

from myosuite_mjx_tpu_torch.engine import graphs
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import DSBL_CONTACT, DeviceModel
from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
from myosuite_mjx_tpu_torch.ops.vec import dot as _dot, mv as _mv
from myosuite_mjx_tpu_torch.utils import spans

_BLOCK = 2   # Newton iterations between two exit tests (the kernel's kBlock)


def _steps(inputs, iterations: int, ls_iterations: int, tol: float,
           ls_tol: float):
  """The solve's arithmetic over its inputs (qM, qacc_smooth,
  qacc_warmstart, J, aref, D, is_eq): (start, nt_iter, is_live, weights).

  ``start()`` is the warm-start prologue's carry (qacc, jar, M dx, cost,
  last improvement, iterations); ``is_live(carry, out)`` the per-env test
  made at block ends.
  """
  qM, x0, ws, J, aref, D, is_eq = inputs
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

  def start():
    st = torch.where((cost(ws) < cost(x0))[:, None], ws, x0)
    jar0 = _mv(J, st) - aref
    qMdx0 = _mv(qM, st - x0)
    c0 = 0.5 * (_dot(st - x0, qMdx0) + (weights(jar0) * jar0 * jar0).sum(-1))
    return (st, jar0, qMdx0, c0, torch.full_like(c0, float("inf")),
            torch.zeros((x0.shape[0],), dtype=torch.int32, device=x0.device))

  def is_live(c, out=None):
    return torch.bitwise_and(c[5] < iterations, c[4] > tol, out=out)

  return start, nt_iter, is_live, weights


def _merge(live, new, carry, out=None):
  """``torch.where(live, new, carry)`` on each leaf: an env that was live
  at the block's start takes the block's carry."""
  B = live.shape[0]
  if out is None:
    out = (None,) * len(carry)
  return tuple(torch.where(live.view((B,) + (1,) * (n.ndim - 1)), n, c, out=o)
               for n, c, o in zip(new, carry, out))


def _problem(m: DeviceModel, d: Data, J, aref, D, is_eq, iterations: int,
             ls_iterations: int):
  """(inputs, args) of one solve, as ``_steps`` and ``_Staged`` take them:
  the tensors, then the iteration caps and the two tolerances."""
  tol = m.opt.tolerance * max(m.opt.meaninertia, 1e-12) * max(m.nv, 1)
  return ((d.qM, d.qacc_smooth, d.qacc_warmstart, J, aref, D, is_eq),
          (iterations, ls_iterations, tol, m.opt.ls_tolerance))


KERNEL, STAGED, EAGER = "kernel", "staged", "eager"


def route(device_type: str, dtype: torch.dtype, nv: int, grad: bool,
          capturing: bool = False) -> str:
  """How a solve runs (see the module's docstring): ``EAGER`` off the
  card, where an input requires grad, or while a capture is under way;
  ``KERNEL`` on the card for float32 or float64 with nv <= 64; ``STAGED``
  for the rest on the card."""
  if device_type != "cuda" or grad or capturing:
    return EAGER
  if (dtype in (torch.float32, torch.float64)
      and nv <= cuda_linalg.NEWTON_MAX_NV):
    return KERNEL
  return STAGED


def _newton_solve(m: DeviceModel, d: Data, J, aref, D, is_eq,
                  iterations: int, ls_iterations: int):
  """Returns (qacc [B, nv], force [B, R], iterations run [B]), fresh
  tensors on every route."""
  inputs, args = _problem(m, d, J, aref, D, is_eq, iterations, ls_iterations)
  how = route(J.device.type, J.dtype, J.shape[-1],
              any(t.requires_grad for t in inputs),
              J.is_cuda and torch.cuda.is_current_stream_capturing())
  if J.is_cuda:
    spans.newton_fused(how == KERNEL)
  if how == KERNEL:
    return cuda_linalg.newton_solve_cuda(
        *(t.contiguous() for t in inputs), *args)
  if how == STAGED:
    st = staged.get(_key(inputs, args), lambda: _Staged(inputs, args))
    st.stage(inputs)
    blocks, graphed = st.run(st.parts.run)
    spans.newton_blocks(blocks, graphed)
    return st.outputs()
  start, nt_iter, is_live, weights = _steps(inputs, *args)
  carry = start()
  live = is_live(carry)
  blocks = 0
  while True:
    newton_host_syncs.count += 1
    if not bool(live.any()):
      break
    new = carry
    for _ in range(_BLOCK):
      new = nt_iter(new)
    carry = _merge(live, new, carry)
    live = is_live(carry)
    blocks += 1
  spans.newton_blocks(blocks, graphed=False)
  qacc, jar = carry[0], carry[1]
  return qacc, -weights(jar) * jar, carry[5]


class _Staged:
  """Static buffers of one key: a copy of the solve's inputs, the carry,
  the live mask and its ``any`` (the flag the host reads).

  ``prologue`` and ``block`` read and write only these buffers, so a CUDA
  graph captured from each replays on whatever ``stage`` copied in. They
  launch the eager loop's kernels, the carry's merge written in place.
  """

  def __init__(self, inputs, args):
    self.inputs = tuple(torch.empty_like(x) for x in inputs)
    x0, J = self.inputs[1], self.inputs[3]
    B, R = J.shape[:2]
    self._start, self._nt_iter, self._is_live, self._weights = _steps(
        self.inputs, *args)
    self.carry = (torch.empty_like(x0), x0.new_empty((B, R)),
                  torch.empty_like(x0), x0.new_empty((B,)),
                  x0.new_empty((B,)), x0.new_empty((B,), dtype=torch.int32))
    self.live = x0.new_empty((B,), dtype=torch.bool)
    self.flag = x0.new_empty((), dtype=torch.bool)
    self.parts = graphs.Parts(x0.device, 2)

  def stage(self, inputs) -> None:
    for s, x in zip(self.inputs, inputs):
      s.copy_(x)

  def _test(self) -> None:
    self._is_live(self.carry, out=self.live)
    torch.any(self.live, out=self.flag)

  def prologue(self) -> None:
    for s, v in zip(self.carry, self._start()):
      s.copy_(v)
    self._test()

  def block(self) -> None:
    new = self.carry
    for _ in range(_BLOCK):
      new = self._nt_iter(new)
    _merge(self.live, new, self.carry, out=self.carry)
    self._test()

  def run(self, run) -> tuple[int, bool]:
    """The host loop on the staged inputs: ``run(part, fn)`` runs the
    prologue (part 0) or a block (part 1), whose code is ``fn``
    (``parts.run``, or a plain call), and says whether it replayed a
    graph. One sync a block plus the exit, as the eager loop; returns the
    blocks run and whether every part run replayed a graph."""
    graphed = run(0, self.prologue)
    blocks = 0
    while True:
      newton_host_syncs.count += 1
      if not bool(self.flag):
        return blocks, graphed
      graphed = run(1, self.block) and graphed
      blocks += 1

  def outputs(self):
    """(qacc, force, iterations), none of them a static buffer: qacc is
    the next substep's warm start, which the next ``stage`` overwrites."""
    qacc, jar, it = self.carry[0], self.carry[1], self.carry[5]
    return qacc.clone(), -self._weights(jar) * jar, it.clone()


def _key(inputs, args) -> tuple:
  """What a graph bakes in: device, dtype, B, R, nv, the solver's scalars
  and the float32 matmul precision."""
  J = inputs[3]
  return ((J.device, J.dtype) + tuple(J.shape) + tuple(args)
          + (torch.get_float32_matmul_precision(),))


# _Staged by _key
staged = graphs.Cache()


class _SyncCounter:
  """Host syncs made by the Newton loop (one per block, plus the exit)."""
  count = 0


newton_host_syncs = _SyncCounter()


def smooth_only(m: DeviceModel, d: Data) -> Data:
  """Constraint-free acceleration: qacc = qacc_smooth."""
  return d.replace(qfrc_constraint=torch.zeros_like(d.qfrc_smooth),
                   qacc=d.qacc_smooth, qacc_warmstart=d.qacc_smooth)


def solve_rows(m: DeviceModel, d: Data, efc, contact_blocks, contact_info,
               full_data: bool = True) -> Data:
  """The constraint forces on the rows ``efc`` (``make_efc``'s; None: the
  smooth acceleration), in the Newton span."""
  with spans.span(spans.NEWTON):
    if efc is None:
      return smooth_only(m, d)
    return _solve(m, d, efc, contact_blocks, contact_info, full_data)


def _solve(m: DeviceModel, d: Data, efc, contact_blocks, contact_info,
           full_data: bool) -> Data:
  """The Newton solve on the rows ``efc``, then its forces scattered into
  Data. The solve feeds the Newton and row-use counters
  (``utils/spans.py``)."""
  J, aref, D, is_eq, _pos, meta = efc
  qacc, force, iterations = _newton_solve(m, d, J, aref, D, is_eq,
                                          int(m.opt.solver_iterations),
                                          int(m.opt.ls_iterations))
  spans.newton_solved(iterations)
  spans.efc_rows_used(force)
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
