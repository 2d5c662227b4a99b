"""Forward dynamics pipeline and integration on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/engine/forward.py``: position, velocity,
actuation, passive, acceleration, constraint, then semi-implicit Euler,
each stage a function of (DeviceModel, Data) -> Data.

PyTorch runs eagerly and drops no dead code, whereas XLA drops every
derived field a substep's carry does not read. So each stage that makes
such fields takes ``full_data``: with ``full_data=False`` the returned Data
keeps the input's ``xmat``, ``site_xmat``, ``qLD``, contact set, contact
forces, ``efc_force_limit``, ``ne_active`` and ``ncon_dropped``, which must
then not be read. The frame-skip loop passes False for every substep but
the last.

The stage order is written once: ``_smooth`` runs ``fwd_position``
through ``fwd_acceleration`` and ``_rows`` contacts and the constraint
rows, each stage in its span. The eager ``forward`` calls both, then the
Newton solve. On the card ``forward`` replays them as two CUDA graphs per
key (``_Staged``, ``engine/graphs.py``): graph A is ``_smooth``, graph B
``_rows``. The caller's inputs are copied into static buffers, and what
the graphs write is copied out into fresh tensors, so no returned tensor
is a graph's. The graphs hold the eager stages' kernels, so every field is
the same bit for bit. The CPU, inputs that require grad and a capture
already under way run the stages eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import collision, constraint
from myosuite_mjx_tpu_torch.engine import muscle as muscle_mod
from myosuite_mjx_tpu_torch.engine import graphs, smooth, solver
from myosuite_mjx_tpu_torch.engine import tendon as tendon_mod
from myosuite_mjx_tpu_torch.engine.data import Contact, Data
from myosuite_mjx_tpu_torch.engine.model import (
    DSBL_ACTUATION, DSBL_CLAMPCTRL, DSBL_PASSIVE, BiasType, DeviceModel,
    DynType, GainType, JointType, TrnType)
from myosuite_mjx_tpu_torch.ops import linalg
from myosuite_mjx_tpu_torch.ops import quat as qmath
from myosuite_mjx_tpu_torch.ops.vec import mv as _mv
from myosuite_mjx_tpu_torch.utils import spans


# ---------------------------------------------------------------------------
# position stage
# ---------------------------------------------------------------------------


def fwd_position(m: DeviceModel, d: Data, full_data: bool = True) -> Data:
  kin = smooth.kinematics(m, d.qpos, full_data=full_data, overlay=d.overlay,
                          mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat)
  subtree_com, cinert, cdof = smooth.com_pos(m, kin, d.overlay)
  ten_length, ten_J = tendon_mod.tendon(m, kin, cdof)
  if m.ntendon:
    ten_length = ten_length + tendon_mod.fixed_tendon_length(m, d.qpos)
  qM = smooth.crb(m, cinert, cdof)
  act_length, act_moment = _transmission(m, d.qpos, ten_length, ten_J)
  return d.replace(
      subtree_com=subtree_com, cinert=cinert, cdof=cdof,
      ten_length=ten_length, ten_J=ten_J, qM=qM,
      actuator_length=act_length, actuator_moment=act_moment, **kin)


@dataclasses.dataclass(frozen=True)
class _TrnSpec:
  joint_u: torch.Tensor      # actuators with joint transmission
  joint_qadr: torch.Tensor
  joint_dadr: torch.Tensor
  tendon_u: torch.Tensor     # actuators with tendon transmission
  tendon_id: torch.Tensor
  gear: torch.Tensor         # [nu]


def _build_trn_spec(m: DeviceModel) -> _TrnSpec:
  h = m.host
  trn = np.asarray(h.actuator_trntype)
  bad = set(np.unique(trn).tolist()) - {int(TrnType.JOINT),
                                        int(TrnType.TENDON)}
  if bad:
    raise NotImplementedError(f"transmission types {sorted(bad)}")
  tid = np.asarray(h.actuator_trnid[:, 0])
  ju = np.where(trn == TrnType.JOINT)[0]
  tu = np.where(trn == TrnType.TENDON)[0]
  t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
  return _TrnSpec(
      joint_u=t(ju), joint_qadr=t(h.jnt_qposadr[tid[ju]]),
      joint_dadr=t(h.jnt_dofadr[tid[ju]]), tendon_u=t(tu),
      tendon_id=t(tid[tu]), gear=m.tensor(h.actuator_gear[:, 0]))


def _transmission(m: DeviceModel, qpos, ten_length, ten_J):
  """Actuator lengths [B, nu] and moments [B, nu, nv]."""
  B = qpos.shape[0]
  lengths = qpos.new_zeros((B, m.nu))
  moments = qpos.new_zeros((B, m.nu, m.nv))
  if m.nu == 0:
    return lengths, moments
  s = m.spec("transmission", _build_trn_spec)
  if s.joint_u.numel():
    g = s.gear[s.joint_u]
    lengths[:, s.joint_u] = g * qpos[:, s.joint_qadr]
    moments[:, s.joint_u, s.joint_dadr] = g
  if s.tendon_u.numel():
    g = s.gear[s.tendon_u]
    lengths[:, s.tendon_u] = g * ten_length[:, s.tendon_id]
    moments[:, s.tendon_u] = g[:, None] * ten_J[:, s.tendon_id]
  return lengths, moments


# ---------------------------------------------------------------------------
# velocity stage
# ---------------------------------------------------------------------------


def fwd_velocity(m: DeviceModel, d: Data) -> Data:
  cvel, cdof_dot = smooth.com_vel(m, d.cdof, d.qvel)
  qfrc_bias = smooth.rne(m, d.cinert, d.cdof, cdof_dot, cvel, d.qvel)
  ten_velocity = _mv(d.ten_J, d.qvel) if m.ntendon else d.ten_velocity
  return d.replace(cvel=cvel, cdof_dot=cdof_dot, qfrc_bias=qfrc_bias,
                   ten_velocity=ten_velocity,
                   actuator_velocity=_mv(d.actuator_moment, d.qvel))


# ---------------------------------------------------------------------------
# actuation
# ---------------------------------------------------------------------------


class _ActSpec:
  """Actuators grouped by static (dyntype, gaintype, biastype)."""

  def __init__(self, m: DeviceModel):
    h = m.host
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
    dyn = np.asarray(h.actuator_dyntype)
    known = {int(DynType.NONE), int(DynType.MUSCLE), int(DynType.INTEGRATOR),
             int(DynType.FILTER), int(DynType.FILTEREXACT)}
    bad = set(np.unique(dyn).tolist()) - known
    if bad:
      raise NotImplementedError(f"dyntype {sorted(bad)}")
    gt = np.asarray(h.actuator_gaintype)
    bt = np.asarray(h.actuator_biastype)
    bad = set(np.unique(gt).tolist()) - {0, 1, 2}
    if bad:
      raise NotImplementedError(f"gaintype {sorted(bad)}")
    bad = set(np.unique(bt).tolist()) - {0, 1, 2}
    if bad:
      raise NotImplementedError(f"biastype {sorted(bad)}")
    aadr = np.asarray(h.actuator_actadr)
    self.act_of_u = t(np.where(aadr >= 0, aadr, 0))
    self.dyn_none = torch.as_tensor(dyn == DynType.NONE, device=m.device)
    self.mus = t(np.where(dyn == DynType.MUSCLE)[0])
    self.integ = t(np.where(dyn == DynType.INTEGRATOR)[0])
    filt = np.where((dyn == DynType.FILTER) | (dyn == DynType.FILTEREXACT))[0]
    self.filt = t(filt)
    self.filt_tau = m.tensor(np.maximum(h.actuator_dynprm[filt, 0], 1e-15))
    has = np.where(aadr >= 0)[0]
    self.has_act = t(has)
    self.act_slot = t(aadr[has])
    self.gain_fixed = t(np.where(gt == GainType.FIXED)[0])
    self.gain_affine = t(np.where(gt == GainType.AFFINE)[0])
    self.gain_muscle = t(np.where(gt == GainType.MUSCLE)[0])
    self.bias_affine = t(np.where(bt == BiasType.AFFINE)[0])
    self.bias_muscle = t(np.where(bt == BiasType.MUSCLE)[0])
    self.gainprm = m.tensor(h.actuator_gainprm[:, :9])
    self.biasprm = m.tensor(h.actuator_biasprm[:, :9])
    self.dynprm = m.tensor(h.actuator_dynprm[:, :3])
    self.ctrl_lo = m.tensor(h.actuator_ctrlrange[:, 0])
    self.ctrl_hi = m.tensor(h.actuator_ctrlrange[:, 1])
    self.force_lo = m.tensor(h.actuator_forcerange[:, 0])
    self.force_hi = m.tensor(h.actuator_forcerange[:, 1])


def fwd_actuation(m: DeviceModel, d: Data) -> Data:
  """Actuator forces, activation rates and generalized actuator forces."""
  B = d.qpos.shape[0]
  if m.nu == 0 or (m.opt.disableflags & DSBL_ACTUATION):
    return d.replace(actuator_force=d.qpos.new_zeros((B, m.nu)),
                     qfrc_actuator=d.qpos.new_zeros((B, m.nv)),
                     act_dot=d.qpos.new_zeros((B, m.na)))
  s = m.spec("actuation", _ActSpec)
  ctrl = d.ctrl
  if not (m.opt.disableflags & DSBL_CLAMPCTRL):
    ctrl = torch.where(m.actuator_ctrllimited,
                       torch.clamp(ctrl, s.ctrl_lo, s.ctrl_hi), ctrl)

  a_u = d.act[:, s.act_of_u] if m.na else torch.zeros_like(ctrl)
  act_input = torch.where(s.dyn_none, ctrl, a_u)

  act_dot = d.qpos.new_zeros((B, m.na))
  if m.na:
    ad = torch.zeros_like(ctrl)
    if s.mus.numel():
      ad[:, s.mus] = muscle_mod.muscle_dynamics(
          ctrl[:, s.mus], a_u[:, s.mus], s.dynprm[s.mus])
    if s.integ.numel():
      ad[:, s.integ] = ctrl[:, s.integ]
    if s.filt.numel():
      ad[:, s.filt] = (ctrl[:, s.filt] - a_u[:, s.filt]) / s.filt_tau
    act_dot[:, s.act_slot] = ad[:, s.has_act]

  length = d.actuator_length
  vel = d.actuator_velocity
  # the gain DR overlay gives per-env prm [B, nu, 9]; the static ones are
  # [nu, 9], hence the leading ellipsis on every index below
  gp = d.overlay.get("actuator_gainprm", s.gainprm)[..., :9]
  bp = d.overlay.get("actuator_biasprm", s.biasprm)[..., :9]
  gain = torch.zeros_like(ctrl)
  g = s.gain_fixed
  if g.numel():
    gain[:, g] = gp[..., g, 0].expand(B, -1)
  g = s.gain_affine
  if g.numel():
    gain[:, g] = (gp[..., g, 0] + gp[..., g, 1] * length[:, g]
                  + gp[..., g, 2] * vel[:, g])
  g = s.gain_muscle
  if g.numel():
    gain[:, g] = muscle_mod.muscle_gain(
        length[:, g], vel[:, g], m.actuator_lengthrange[g],
        m.actuator_acc0[g], gp[..., g, :])
  bias = torch.zeros_like(ctrl)
  b = s.bias_affine
  if b.numel():
    bias[:, b] = (bp[..., b, 0] + bp[..., b, 1] * length[:, b]
                  + bp[..., b, 2] * vel[:, b])
  b = s.bias_muscle
  if b.numel():
    bias[:, b] = muscle_mod.muscle_bias(
        length[:, b], m.actuator_lengthrange[b], m.actuator_acc0[b],
        bp[..., b, :])

  force = gain * act_input + bias
  force = torch.where(m.actuator_forcelimited,
                      torch.clamp(force, s.force_lo, s.force_hi), force)
  qfrc_actuator = _mv(d.actuator_moment.transpose(-1, -2), force)
  return d.replace(actuator_force=force, qfrc_actuator=qfrc_actuator,
                   act_dot=act_dot)


# ---------------------------------------------------------------------------
# passive forces
# ---------------------------------------------------------------------------


class _PassiveSpec:

  def __init__(self, m: DeviceModel):
    h = m.host
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
    # hinge and slide only: DeviceModel refuses springs on ball and free
    sprung = np.where(np.asarray(h.jnt_stiffness) != 0.0)[0]
    qadr = np.asarray(h.jnt_qposadr)[sprung]
    self.spring_qadr = t(qadr)
    self.spring_dadr = t(np.asarray(h.jnt_dofadr)[sprung])
    self.spring_k = m.tensor(np.asarray(h.jnt_stiffness)[sprung])
    self.spring_q0 = m.tensor(np.asarray(h.qpos_spring)[qadr])
    # tendon springs and dampers only where some tendon has one; with
    # zero stiffness and damping their force is exactly zero
    self.tendon = bool(h.ntendon) and bool(
        np.any(h.tendon_stiffness) or np.any(h.tendon_damping))


def fwd_passive(m: DeviceModel, d: Data) -> Data:
  if m.opt.disableflags & DSBL_PASSIVE:
    return d.replace(qfrc_passive=torch.zeros_like(d.qvel))
  s = m.spec("passive", _PassiveSpec)
  qfrc = -d.overlay.get("dof_damping", m.dof_damping) * d.qvel
  if s.spring_qadr.numel():
    qfrc = qfrc.index_add(1, s.spring_dadr, -s.spring_k * (
        d.qpos[:, s.spring_qadr] - s.spring_q0))
  if s.tendon:
    lo = m.tendon_lengthspring[:, 0]
    hi = m.tendon_lengthspring[:, 1]
    L = d.ten_length
    zero = torch.zeros_like(L)
    stretch = torch.where(L > hi, L - hi, torch.where(L < lo, L - lo, zero))
    frc = -m.tendon_stiffness * stretch - m.tendon_damping * d.ten_velocity
    qfrc = qfrc + _mv(d.ten_J.transpose(-1, -2), frc)
  return d.replace(qfrc_passive=qfrc)


# ---------------------------------------------------------------------------
# acceleration + constraint
# ---------------------------------------------------------------------------


def fwd_acceleration(m: DeviceModel, d: Data, full_data: bool = True) -> Data:
  """qfrc_smooth and qacc_smooth = M^-1 qfrc_smooth (the SPD kernel).

  With ``full_data`` the same kernel call returns the factor ``qLD``.
  """
  qfrc_applied = d.qfrc_applied
  if m.nbody > 1:
    bodies = smooth.tree_spec(m).moving_bodies
    xfrc = d.xfrc_applied[:, 1:]
    lin_rows = smooth.point_jac_dir(m, d.cdof, d.xipos[:, 1:], bodies,
                                    xfrc[..., :3])
    mask = smooth.body_dof_mask(m)[bodies]
    rot_rows = (xfrc[..., 3:] @ d.cdof[..., :3].transpose(-1, -2)) * mask
    qfrc_applied = qfrc_applied + (lin_rows + rot_rows).sum(1)
  qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + qfrc_applied
  if full_data:
    qacc_smooth, qLD = linalg.spd_solve(d.qM, qfrc_smooth, factor=True)
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth,
                     qLD=qLD)
  return d.replace(qfrc_smooth=qfrc_smooth,
                   qacc_smooth=linalg.spd_solve(d.qM, qfrc_smooth))


def _smooth(m: DeviceModel, d: Data, full_data: bool) -> Data:
  """``fwd_position`` through ``fwd_acceleration``, each in its span."""
  with spans.span(spans.FWD_POSITION):
    d = fwd_position(m, d, full_data)
  with spans.span(spans.FWD_VELOCITY):
    d = fwd_velocity(m, d)
  with spans.span(spans.FWD_ACTUATION):
    d = fwd_actuation(m, d)
  with spans.span(spans.FWD_PASSIVE):
    d = fwd_passive(m, d)
  with spans.span(spans.FWD_ACCELERATION):
    return fwd_acceleration(m, d, full_data)


def _rows(m: DeviceModel, d: Data):
  """Contacts and the constraint rows on them, each in its span:
  (contact blocks, contact set, rows), as ``solver.solve_rows`` takes
  them."""
  with spans.span(spans.CONTACTS):
    blocks, info = collision.contacts(m, d)
  with spans.span(spans.MAKE_EFC):
    return blocks, info, constraint.make_efc(m, d, blocks)


def forward(m: DeviceModel, d: Data, constraint: bool = True,
            full_data: bool = True) -> Data:
  """Full forward dynamics at the current state.

  ``constraint=False`` skips collision and the Newton solve and takes the
  smooth acceleration (the pose tasks' reset path). Each stage runs in
  its span (``utils/spans.py``); on the card the stages up to the Newton
  solve replay CUDA graphs (``_Staged``), graph A in the span of
  ``fwd_position`` and graph B in that of contacts. Each pass on the card
  feeds the forward graph counter.
  """
  inputs = tuple(getattr(d, k) for k in _INPUTS) + tuple(d.overlay.values())
  if graphs.graphable(inputs):
    st = staged.get(_key(m, d, full_data), lambda: _Staged(m, d, full_data))
    d, graphed = st.forward(d, constraint, st.parts.run)
    spans.forward_pass(graphed)
    return d
  if d.qpos.is_cuda:
    spans.forward_pass(False)
  d = _smooth(m, d, full_data)
  if not constraint:
    return solver.smooth_only(m, d)
  blocks, info, efc = _rows(m, d)
  return solver.solve_rows(m, d, efc, blocks, info, full_data)


# what the stages read of the caller's Data besides its overlay; every other
# field they read, they write first
_INPUTS = ("qpos", "qvel", "act", "ctrl", "qfrc_applied", "xfrc_applied",
           "mocap_pos", "mocap_quat")
_FIELDS = tuple(f.name for f in dataclasses.fields(Data)
                if f.name not in ("contact", "overlay"))
_CONTACT = tuple(f.name for f in dataclasses.fields(Contact))


class _Staged:
  """Static buffers of one key and the two graphs replayed on them.

  ``stage`` copies what the stages read of the caller's Data into
  ``inputs`` and ``overlay``. ``smooth`` (graph A, part 0) runs ``_smooth``
  on them and keeps the result as ``after``; ``constraint_rows`` (graph B,
  part 1) runs ``_rows`` on ``after`` and keeps ``rows``. The staged Data's
  other fields are None, so a stage that read one would fail at its first
  run rather than bake a caller's tensor into a graph. The two graphs
  share one memory pool: what A writes is copied out before B runs, and
  what B writes is read before A runs again. Until a graph is captured,
  what its warm-up wrote is let go after the pass.
  """

  def __init__(self, m: DeviceModel, d: Data, full_data: bool):
    self.m, self.full_data = m, full_data
    self.inputs = {k: torch.empty_like(getattr(d, k)) for k in _INPUTS}
    self.overlay = {k: torch.empty_like(v) for k, v in d.overlay.items()}
    self.data = Data(overlay=self.overlay, **{
        f.name: self.inputs.get(f.name) for f in dataclasses.fields(Data)
        if f.name != "overlay"})
    self.after = self.rows = None
    self.parts = graphs.Parts(d.qpos.device, 2)

  def stage(self, d: Data) -> None:
    for k, s in self.inputs.items():
      s.copy_(getattr(d, k))
    for k, s in self.overlay.items():
      s.copy_(d.overlay[k])

  def smooth(self) -> None:
    self.after = _smooth(self.m, self.data, self.full_data)

  def constraint_rows(self) -> None:
    blocks, info, efc = _rows(self.m, self.after)
    if self.full_data and info is not None:
      # the contact set goes into Data: laid out for ``graphs.copy_out``
      info = Contact(**{k: getattr(info, k).contiguous() for k in _CONTACT})
    self.rows = (blocks, info, efc)

  def forward(self, d: Data, constraint: bool, run) -> tuple[Data, bool]:
    """``forward(m, d, constraint, full_data)`` on the staged buffers:
    ``run(part, fn)`` runs graph ``part``'s code ``fn`` (``parts.run``, or
    a plain call) and says whether it replayed a graph. Returns the Data
    and whether every part it ran replayed one."""
    m = self.m
    with spans.span(spans.FWD_POSITION):
      self.stage(d)
      graphed = run(0, self.smooth)
      after = self.after
      names = [k for k in _FIELDS if getattr(after, k) is not None
               and getattr(after, k) is not self.inputs.get(k)]
      d = d.replace(**dict(zip(names, graphs.copy_out(
          [getattr(after, k) for k in names]))))
    if not constraint:
      self._let_go()
      return solver.smooth_only(m, d), graphed
    with spans.span(spans.CONTACTS):
      graphed = run(1, self.constraint_rows) and graphed
      # the rows are read by the solve below, before A runs again; only the
      # contact set and the count dropped reach Data
      blocks, info, efc = self.rows
      if self.full_data and info is not None:
        fresh = graphs.copy_out([getattr(info, k) for k in _CONTACT]
                                + [blocks["dropped"]])
        info = Contact(**dict(zip(_CONTACT, fresh)))
        blocks = {**blocks, "dropped": fresh[-1]}
      self._let_go()
    return solver.solve_rows(m, d, efc, blocks, info, self.full_data), graphed

  def _let_go(self) -> None:
    """Drop what a graph's warm-up wrote: only a captured graph's own
    buffers are kept."""
    if self.parts.graphs[0] is None:
      self.after = None
    if self.parts.graphs[1] is None:
      self.rows = None


def _key(m: DeviceModel, d: Data, full_data: bool) -> tuple:
  """What the graphs bake in: the model, ``full_data``, the float32 matmul
  precision, the contact cap, and the device, dtype and shape (so B) of
  each staged input and overlay entry."""
  meta = lambda t: (t.device, t.dtype, tuple(t.shape))
  return ((m, full_data, torch.get_float32_matmul_precision(),
           collision.DEFAULT_MAX_CONTACTS)
          + tuple(meta(getattr(d, k)) for k in _INPUTS)
          + tuple((k,) + meta(v) for k, v in sorted(d.overlay.items())))


# _Staged by _key
staged = graphs.Cache()


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


def _integrate_pos(m: DeviceModel, qpos, qvel, dt) -> torch.Tensor:
  """qpos += dt * qvel: hinge, slide and free-joint positions in one
  vectorized add; ball and free-joint quaternions by ``quat_integrate``
  (local-frame angular velocity, then normalize), all at once."""
  s = m.spec("integrate", _IntegrateSpec)
  out = qpos.index_add(1, s.qadr, dt * qvel[:, s.vadr])
  if s.quat_qadr.numel():
    out[:, s.quat_qadr] = qmath.quat_integrate(
        qpos[:, s.quat_qadr], qvel[:, s.quat_vadr], dt)
  return out


class _IntegrateSpec:

  def __init__(self, m: DeviceModel):
    h = m.host
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
    jt = np.asarray(h.jnt_type)
    hs = np.where(np.isin(jt, (JointType.HINGE, JointType.SLIDE)))[0]
    free = np.where(jt == JointType.FREE)[0]
    ball = np.where(jt == JointType.BALL)[0]
    three, four = np.arange(3), np.arange(4)
    qa, va = np.asarray(h.jnt_qposadr), np.asarray(h.jnt_dofadr)
    self.qadr = t(np.concatenate([qa[hs], (qa[free, None] + three).ravel()]))
    self.vadr = t(np.concatenate([va[hs], (va[free, None] + three).ravel()]))
    # [K, 4] quaternions in qpos and [K, 3] their angular velocities
    self.quat_qadr = t(np.concatenate([qa[ball, None] + four,
                                       qa[free, None] + 3 + four]))
    self.quat_vadr = t(np.concatenate([va[ball, None] + three,
                                       va[free, None] + 3 + three]))
    lo = np.full(h.na, -np.inf)
    hi = np.full(h.na, np.inf)
    for u in range(h.nu):
      aadr = int(h.actuator_actadr[u])
      if aadr < 0:
        continue
      if int(h.actuator_dyntype[u]) == DynType.MUSCLE:
        lo[aadr], hi[aadr] = 0.0, 1.0
      elif bool(h.actuator_actlimited[u]):
        lo[aadr] = h.actuator_actrange[u, 0]
        hi[aadr] = h.actuator_actrange[u, 1]
    self.clamp_act = not (np.isneginf(lo).all() and np.isposinf(hi).all())
    self.act_lo = m.tensor(lo)
    self.act_hi = m.tensor(hi)
    self.damping = (m.dof_damping if float(np.abs(h.dof_damping).sum()) > 0
                    else None)


def _clamp_act(m: DeviceModel, act: torch.Tensor) -> torch.Tensor:
  s = m.spec("integrate", _IntegrateSpec)
  if m.na == 0 or not s.clamp_act:
    return act
  return torch.clamp(act, s.act_lo, s.act_hi)


def euler(m: DeviceModel, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping:
  (M + h D) qacc = qfrc_smooth + qfrc_constraint.

  A damping overlay [B, nv] always takes the implicit solve, even where the
  model's own damping is zero (so does the reference).
  """
  dt = m.opt.timestep
  s = m.spec("integrate", _IntegrateSpec)
  damping = d.overlay.get("dof_damping", s.damping)
  if damping is not None:
    qfrc = d.qfrc_smooth + d.qfrc_constraint
    qacc = linalg.spd_solve(d.qM + dt * torch.diag_embed(damping), qfrc)
  else:
    qacc = d.qacc
  qvel = d.qvel + dt * qacc
  act = _clamp_act(m, d.act + dt * d.act_dot)
  qpos = _integrate_pos(m, d.qpos, qvel, dt)
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + dt)


def step(m: DeviceModel, d: Data, full_data: bool = True) -> Data:
  """One physics step: forward dynamics, then Euler integration."""
  d = forward(m, d, full_data=full_data)
  with spans.span(spans.EULER):
    return euler(m, d)
