"""Plain reference, frozen from the port's ``engine/data.py`` and
importing nothing of it.

Dynamic simulation state of a batch of environments.

Counterpart of ``myosuite_mjx_tpu/engine/data.py`` with a written-out
batch: every field is ``[B, ...]`` where the JAX ``Data`` is one env's
state under ``vmap``. Field names are the reference's. ``overlay`` holds
per-env overrides of model constants (domain randomization, see
``envs/randomize.py``), each ``[B, ...]``; the engine reads ``body_pos``,
``body_mass``, ``actuator_gainprm``, ``actuator_biasprm``, ``dof_damping``,
``geom_size`` and ``geom_friction`` from it in place of the model's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Contact:
  """Fixed-size contact set (``dist > includemargin`` slots are inactive)."""
  dist: torch.Tensor           # [B, ncon]
  pos: torch.Tensor            # [B, ncon, 3]
  frame: torch.Tensor          # [B, ncon, 3, 3] rows: normal, t1, t2
  friction: torch.Tensor       # [B, ncon, 5]
  solref: torch.Tensor         # [B, ncon, 2]
  solimp: torch.Tensor         # [B, ncon, 5]
  geom1: torch.Tensor          # [B, ncon] int
  geom2: torch.Tensor          # [B, ncon] int
  includemargin: torch.Tensor  # [B, ncon]

  def replace(self, **kw) -> "Contact":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Data:
  # ---- state ----
  time: torch.Tensor           # [B]
  qpos: torch.Tensor           # [B, nq]
  qvel: torch.Tensor           # [B, nv]
  act: torch.Tensor            # [B, na]
  ctrl: torch.Tensor           # [B, nu]
  qacc: torch.Tensor           # [B, nv]
  qacc_warmstart: torch.Tensor  # [B, nv]
  act_dot: torch.Tensor        # [B, na]
  qfrc_applied: torch.Tensor   # [B, nv]
  xfrc_applied: torch.Tensor   # [B, nbody, 6]
  mocap_pos: torch.Tensor      # [B, nmocap, 3]
  mocap_quat: torch.Tensor     # [B, nmocap, 4]
  # ---- position-dependent ----
  xpos: torch.Tensor           # [B, nbody, 3]
  xquat: torch.Tensor          # [B, nbody, 4]
  xmat: torch.Tensor           # [B, nbody, 3, 3]
  xipos: torch.Tensor          # [B, nbody, 3]
  ximat: torch.Tensor          # [B, nbody, 3, 3]
  xanchor: torch.Tensor        # [B, njnt, 3]
  xaxis: torch.Tensor          # [B, njnt, 3]
  site_xpos: torch.Tensor      # [B, nsite, 3]
  site_xmat: torch.Tensor      # [B, nsite, 3, 3]
  geom_xpos: torch.Tensor      # [B, ngeom, 3]
  geom_xmat: torch.Tensor      # [B, ngeom, 3, 3]
  subtree_com: torch.Tensor    # [B, nbody, 3]
  cinert: torch.Tensor         # [B, nbody, 10]
  cdof: torch.Tensor           # [B, nv, 6]
  ten_length: torch.Tensor     # [B, ntendon]
  ten_J: torch.Tensor          # [B, ntendon, nv]
  actuator_length: torch.Tensor  # [B, nu]
  actuator_moment: torch.Tensor  # [B, nu, nv]
  qM: torch.Tensor             # [B, nv, nv]
  qLD: torch.Tensor            # [B, nv, nv]
  # ---- velocity-dependent ----
  cvel: torch.Tensor           # [B, nbody, 6]
  cdof_dot: torch.Tensor       # [B, nv, 6]
  ten_velocity: torch.Tensor   # [B, ntendon]
  actuator_velocity: torch.Tensor  # [B, nu]
  qfrc_bias: torch.Tensor      # [B, nv]
  # ---- forces ----
  actuator_force: torch.Tensor  # [B, nu]
  qfrc_actuator: torch.Tensor  # [B, nv]
  qfrc_passive: torch.Tensor   # [B, nv]
  qfrc_smooth: torch.Tensor    # [B, nv]
  qacc_smooth: torch.Tensor    # [B, nv]
  qfrc_constraint: torch.Tensor  # [B, nv]
  # ---- constraints ----
  contact: Contact
  contact_force: torch.Tensor  # [B, ncon]
  contact_force_vec: torch.Tensor  # [B, ncon, 3]
  efc_force_limit: torch.Tensor  # [B, nlimit]
  ne_active: torch.Tensor      # [B] int
  ncon_dropped: torch.Tensor   # [B] int
  # ---- sensors ----
  sensordata: torch.Tensor     # [B, nsensordata]
  # ---- model overlay (per-env domain randomization) ----
  overlay: dict = dataclasses.field(default_factory=dict)

  def replace(self, **kw) -> "Data":
    return dataclasses.replace(self, **kw)


def make_data(m, batch: int, dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda") -> Data:
  """Fresh Data of ``batch`` envs at qpos0 (run ``forward`` to fill it).

  ``m`` is a host ``Model`` or a ``DeviceModel`` (only sizes and host
  arrays are read).
  """
  from . import collision
  host = getattr(m, "host", m)
  ncon = collision.contact_slot_count(host)
  B = batch
  kw = dict(dtype=dtype, device=device)

  def z(*shape):
    return torch.zeros((B,) + shape, **kw)

  def eye(n):
    return torch.eye(3, **kw).expand(B, n, 3, 3).clone()

  def tiled(row, n):
    return torch.tensor(row, **kw).expand(B, n, len(row)).clone()

  contact = Contact(
      dist=torch.full((B, ncon), 1e10, **kw),
      pos=z(ncon, 3),
      frame=eye(ncon),
      friction=torch.ones((B, ncon, 5), **kw),
      solref=tiled([0.02, 1.0], ncon),
      solimp=tiled([0.9, 0.95, 0.001, 0.5, 2.0], ncon),
      geom1=torch.zeros((B, ncon), dtype=torch.int32, device=device),
      geom2=torch.zeros((B, ncon), dtype=torch.int32, device=device),
      includemargin=z(ncon),
  )
  nb = host.nbody
  return Data(
      time=z(),
      qpos=torch.as_tensor(np.asarray(host.qpos0, np.float64),
                           device=device).to(dtype).expand(B, -1).clone(),
      qvel=z(host.nv), act=z(host.na), ctrl=z(host.nu), qacc=z(host.nv),
      qacc_warmstart=z(host.nv), act_dot=z(host.na),
      qfrc_applied=z(host.nv), xfrc_applied=z(nb, 6),
      mocap_pos=z(host.nmocap, 3),
      mocap_quat=tiled([1.0, 0.0, 0.0, 0.0], host.nmocap),
      xpos=z(nb, 3), xquat=tiled([1.0, 0.0, 0.0, 0.0], nb), xmat=eye(nb),
      xipos=z(nb, 3), ximat=eye(nb),
      xanchor=z(host.njnt, 3), xaxis=z(host.njnt, 3),
      site_xpos=z(host.nsite, 3), site_xmat=eye(host.nsite),
      geom_xpos=z(host.ngeom, 3), geom_xmat=eye(host.ngeom),
      subtree_com=z(nb, 3), cinert=z(nb, 10), cdof=z(host.nv, 6),
      ten_length=z(host.ntendon), ten_J=z(host.ntendon, host.nv),
      actuator_length=z(host.nu), actuator_moment=z(host.nu, host.nv),
      qM=z(host.nv, host.nv), qLD=z(host.nv, host.nv),
      cvel=z(nb, 6), cdof_dot=z(host.nv, 6), ten_velocity=z(host.ntendon),
      actuator_velocity=z(host.nu), qfrc_bias=z(host.nv),
      actuator_force=z(host.nu), qfrc_actuator=z(host.nv),
      qfrc_passive=z(host.nv), qfrc_smooth=z(host.nv),
      qacc_smooth=z(host.nv), qfrc_constraint=z(host.nv),
      contact=contact, contact_force=z(ncon), contact_force_vec=z(ncon, 3),
      efc_force_limit=z(int(np.sum(host.jnt_limited))),
      ne_active=torch.zeros((B,), dtype=torch.int32, device=device),
      ncon_dropped=torch.zeros((B,), dtype=torch.int32, device=device),
      sensordata=z(host.nsensordata),
  )
