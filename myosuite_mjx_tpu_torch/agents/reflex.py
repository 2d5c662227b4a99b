"""Reflex walking controller (Song & Geyer 2015) on a batch of walkers.

Counterpart of ``myosuite_mjx_tpu/agents/reflex.py``: the spinal-feedback
circuitry of MyoSuite's reflex baseline (11 muscle groups a leg, the 9
stance and swing phase flags with their touch and lift edges, the brain
layer's target leg angle and swing-leg choice, the M1-M10 stimulation
laws) wired to a two-leg model with MyoLeg's names. Where the JAX package
writes one walker and ``vmap``s it, everything here is batch-first: the
phase state is ``ReflexState`` with ``[P, 2]`` flags (row 0 the right
leg), the sensors are ``[P, ...]`` and the physics a ``Data`` of P
envs, one walker each (a population of gain vectors, say).

Kept from the reference for parity: ``BFSH_8_PG`` reads ``BFSH_8_DG``'s
parameter, the pelvis Euler offsets of ``_sensor_data``, the force
feedback as a group mean of ``actuator_force / fmax`` (``biasprm[:, 2]``),
and ``reset``'s pure-pitch root quaternion, which replaces the model's.
The default params, ``ones(46)``, are the nominal Song & Geyer gains;
``baseline_params()`` is the reference's tuned set.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import data as data_mod
from myosuite_mjx_tpu_torch.engine import forward as forward_mod
from myosuite_mjx_tpu_torch.engine import model as model_mod
from myosuite_mjx_tpu_torch.engine import sensors
from myosuite_mjx_tpu_torch.ops import quat as quat_ops

D2R = np.pi / 180.0

# muscle groups -> MyoLeg actuator names (without the _r / _l side)
MUSCLE_GROUPS = {
    "HAB": ["piri", "sart", "glmed1", "glmed2", "glmin1", "glmin2",
            "glmin3"],
    "HAD": ["addbrev", "addlong", "addmagDist", "addmagIsch", "addmagMid",
            "addmagProx", "grac"],
    "HFL": ["psoas", "iliacus"],
    "GLU": ["glmax1", "glmax2", "glmax3", "glmed3"],
    "HAM": ["semimem", "semiten", "bflh"],
    "RF": ["recfem"],
    "VAS": ["vasint", "vaslat", "vasmed"],
    "BFSH": ["bfsh"],
    "GAS": ["gaslat", "gasmed"],
    "SOL": ["soleus", "perbrev", "perlong", "tibpost"],
    "TA": ["tibant"],
}
M_KEYS = ["HAB", "HAD", "HFL", "GLU", "HAM", "RF", "VAS", "BFSH", "GAS",
          "SOL", "TA"]
# the groups whose force feeds back
FORCE_KEYS = ("RF", "VAS", "GAS", "SOL")

# control parameter scalings: cp = p * scale + offset
CP_SPEC = [
    ("theta_tgt", 10 * D2R, 0.0),
    ("c0", 20 * D2R, 55 * D2R),
    ("cv", 2 * D2R, 0.0),
    ("alpha_delta", 5 * D2R, 0.0),
    ("knee_sw_tgt", 20 * D2R, 120 * D2R),
    ("knee_tgt", 15 * D2R, 160 * D2R),
    ("knee_off_st", 10 * D2R, 165 * D2R),
    ("ankle_tgt", 20 * D2R, 60 * D2R),
    ("HFL_3_PG", 2.0, 0.0), ("HFL_3_DG", 1.0, 0.0),
    ("HFL_6_PG", 1.0, 0.0), ("HFL_6_DG", 0.1, 0.0),
    ("HFL_10_PG", 1.0, 0.0),
    ("GLU_3_PG", 2.0, 0.0), ("GLU_3_DG", 0.5, 0.0),
    ("GLU_6_PG", 1.0, 0.0), ("GLU_6_DG", 0.1, 0.0),
    ("GLU_10_PG", 0.5, 0.0),
    ("HAM_3_GLU", 1.0, 0.0), ("HAM_9_PG", 2.0, 0.0),
    ("RF_1_FG", 0.3, 0.0), ("RF_8_DG_knee", 0.1, 0.0),
    ("VAS_1_FG", 1.0, 0.0), ("VAS_2_PG", 2.0, 0.0),
    ("VAS_10_PG", 0.3, 0.0),
    ("BFSH_2_PG", 2.0, 0.0), ("BFSH_7_DG_alpha", 0.2, 0.0),
    ("BFSH_7_PG", 2.0, 0.0), ("BFSH_8_DG", 1.0, 0.0),
    ("BFSH_8_PG", 1.0, 0.0),  # filled from BFSH_8_DG's param (the quirk)
    ("BFSH_9_G_HAM", 2.0, 0.0), ("BFSH_9_HAM0", 0.3, 0.0),
    ("BFSH_10_PG", 2.0, 0.0),
    ("GAS_2_FG", 1.2, 0.0), ("SOL_1_FG", 1.2, 0.0),
    ("TA_5_PG", 2.0, 0.0), ("TA_5_G_SOL", 0.5, 0.0),
    ("theta_tgt_f", 5 * D2R, 0.0),
    ("c0_f", 20 * D2R, 60 * D2R),
    ("cv_f", 10 * D2R, 0.0),
    ("HAB_3_PG", 10.0, 0.0), ("HAB_3_DG", 1.0, 0.0),
    ("HAB_6_PG", 2.0, 0.0),
    ("HAD_3_PG", 2.0, 0.0), ("HAD_3_DG", 0.3, 0.0),
    ("HAD_6_PG", 2.0, 0.0),
]
N_PARAMS = 46
CP_IDX = {name: i for i, (name, _, _) in enumerate(CP_SPEC)}

# the quirk: cp["BFSH_8_PG"] is filled from params[BFSH_8_DG]
_PARAM_SOURCE = np.arange(len(CP_SPEC))
_PARAM_SOURCE[CP_IDX["BFSH_8_PG"]] = CP_IDX["BFSH_8_DG"]

DEFAULT_INIT_POSE = {
    "pitch": 15 * D2R,
    "height": 0.92,
    "joint_angles": {
        "hip_flexion_r": (180 - 190) * D2R,
        "hip_flexion_l": (180 - 155) * D2R,
        "knee_angle_r": (180 - 165) * D2R,
        "knee_angle_l": (180 - 180) * D2R,
        "ankle_angle_r": (90 - 90) * D2R,
        "ankle_angle_l": (90 - 100) * D2R,
    },
    "forward_velocity": 1.5,
}

DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "legs80_reflex.npz")


def baseline_params() -> np.ndarray:
  """The reference's tuned 46-gain walking set (the port's copy of its
  ``reflex_baseline_params.txt``)."""
  return np.loadtxt(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "reflex_baseline_params.txt"))


def expand_params(params, dtype: torch.dtype = torch.float32,
                  device="cuda") -> torch.Tensor:
  """Normalized params [..., 46] -> control parameters [..., 46]
  (scale + offset), in ``dtype`` on ``device``."""
  p = torch.as_tensor(np.asarray(params, np.float64), device=device).to(dtype)
  scale = torch.tensor([s for _, s, _ in CP_SPEC], dtype=dtype, device=device)
  off = torch.tensor([o for _, _, o in CP_SPEC], dtype=dtype, device=device)
  src = torch.as_tensor(_PARAM_SOURCE, device=device)
  return p[..., src] * scale + off


@dataclasses.dataclass
class ReflexState:
  """Per-leg phase flags [P, 2] bool, column 0 the right leg."""
  in_contact: torch.Tensor
  ph_st: torch.Tensor         # stance
  ph_st_csw: torch.Tensor     # stance and contralateral swing
  ph_st_sw0: torch.Tensor     # stance, initiate swing
  ph_st_st: torch.Tensor      # stance, keep stance
  ph_sw: torch.Tensor         # swing
  ph_sw_flex_k: torch.Tensor  # swing: flex knee
  ph_sw_hold_k: torch.Tensor  # swing: hold knee
  ph_sw_stop_l: torch.Tensor  # swing: stop leg
  ph_sw_hold_l: torch.Tensor  # swing: hold leg


def init_state(batch: int, device="cuda") -> ReflexState:
  """The reference's reset: the right leg swinging, the left in stance."""
  f = torch.zeros((batch, 2), dtype=torch.bool, device=device)
  right = torch.tensor([True, False], device=device).expand(batch, 2)
  return ReflexState(
      in_contact=~right, ph_st=~right, ph_st_csw=f, ph_st_sw0=f, ph_st_st=f,
      ph_sw=right.clone(), ph_sw_flex_k=right.clone(), ph_sw_hold_k=f,
      ph_sw_stop_l=f, ph_sw_hold_l=f)


def reflex_update(cp: torch.Tensor, state: ReflexState, sens: dict):
  """One control tick: sensors -> (new phase state, stim [P, 2, 11]).

  ``cp`` is [P, 46] (or [46], shared by every walker); ``sens`` holds
  per-leg [P, 2] tensors and the body's [P, 2] pairs ``theta`` (roll,
  pitch), ``d_pos`` (dx, dy) and ``dtheta``; see
  ``ReflexWalker._sensor_data``. A branchless transcription of the
  reference's phase logic and stimulation laws.
  """
  ci = sens["contact_ipsi"]
  P, dt, dev = ci.shape[0], sens["alpha"].dtype, ci.device
  cp = cp.to(dt).expand(P, len(CP_SPEC))
  c = lambda name: cp[:, CP_IDX[name], None]            # [P, 1]
  sign_f = torch.tensor([1.0, -1.0], dtype=dt, device=dev)
  flip = lambda x: x.flip(-1)                           # contra leg

  # ---- brain control ----
  theta_roll = sens["theta"][:, 0:1]
  theta_pitch = sens["theta"][:, 1:2]
  alpha_tgt_f = (c("c0_f") + sign_f * c("cv_f") * sens["d_pos"][:, 1:2]
                 - sign_f * theta_roll)
  alpha_tgt = ((c("c0") - c("cv") * sens["d_pos"][:, 0:1])
               - theta_pitch).expand(P, 2)
  alpha_delta = c("alpha_delta")
  knee_sw_tgt = c("knee_sw_tgt")
  knee_tgt = c("knee_tgt")
  hip_tgt = alpha_tgt + 0.5 * knee_tgt

  both = ci[:, 0:1] & ci[:, 1:2]
  delta = sens["alpha"] - alpha_tgt
  r_first = delta[:, 0:1] > delta[:, 1:2]
  is_right = torch.tensor([True, False], device=dev)
  swing_init = both & (is_right == r_first)

  # ---- phase transitions ----
  touch = ~state.in_contact & ci
  lift = state.in_contact & ~ci
  st = state.ph_st | touch
  sw = state.ph_sw & ~touch
  flex = state.ph_sw_flex_k & ~touch
  holdk = state.ph_sw_hold_k & ~touch
  stop = state.ph_sw_stop_l & ~touch
  holdl = state.ph_sw_hold_l & ~touch

  st_csw = torch.where(st, ~flip(ci), state.ph_st_csw)
  st_sw0 = torch.where(st, swing_init, state.ph_st_sw0)
  st_st = torch.where(st, ~st_sw0, state.ph_st_st)

  st, st_csw, st_sw0, st_st = (x & ~lift for x in (st, st_csw, st_sw0,
                                                   st_st))
  sw = sw | lift
  flex = flex | lift

  in_flex = sw & flex
  knee_done = sens["phi_knee"] < knee_sw_tgt
  else_br = sw & ~flex                      # on the entry value of flex
  flex = flex & ~(in_flex & knee_done)
  holdk = holdk | (in_flex & knee_done)
  holdk = holdk & ~(else_br & holdk & (sens["alpha"] < alpha_tgt))
  stop = stop | (else_br & (sens["alpha"] < alpha_tgt + alpha_delta))
  holdl = holdl | (else_br & stop & (sens["dalpha"] > 0))

  new_state = ReflexState(
      in_contact=ci, ph_st=st, ph_st_csw=st_csw, ph_st_sw0=st_sw0,
      ph_st_st=st_st, ph_sw=sw, ph_sw_flex_k=flex, ph_sw_hold_k=holdk,
      ph_sw_stop_l=stop, ph_sw_hold_l=holdl)

  # ---- stimulation laws ----
  f = lambda b: b.to(dt)
  ph_st, ph_st_sw0, ph_st_st = f(st), f(st_sw0), f(st_st)
  ph_sw, ph_sw_flex_k = f(sw), f(flex)
  ph_sw_hold_k, ph_sw_stop_l, ph_sw_hold_l = f(holdk), f(stop), f(holdl)

  load_i, load_c = sens["load_ipsi"], sens["load_contra"]
  alpha, dalpha, alpha_f = sens["alpha"], sens["dalpha"], sens["alpha_f"]
  phi_hip, phi_knee = sens["phi_hip"], sens["phi_knee"]
  phi_ankle, dphi_knee = sens["phi_ankle"], sens["dphi_knee"]
  theta = theta_pitch
  dtheta = sens["dtheta"][:, 1:2]
  theta_f = sign_f * theta_roll
  dtheta_f = sign_f * sens["dtheta"][:, 0:1]
  theta_tgt = c("theta_tgt")
  theta_tgt_f = c("theta_tgt_f")
  knee_off_st = c("knee_off_st")
  ankle_tgt = c("ankle_tgt")
  pre = 0.01
  relu = lambda x: torch.clamp(x, min=0.0)

  S_HAB_3 = ph_st * load_i * relu(
      -c("HAB_3_PG") * (theta_f - theta_tgt_f) - c("HAB_3_DG") * dtheta_f)
  S_HAB_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      c("HAB_6_PG") * (alpha_f - alpha_tgt_f))
  HAB = S_HAB_3 + S_HAB_6

  S_HAD_3 = ph_st * load_i * relu(
      c("HAD_3_PG") * (theta_f - theta_tgt_f) + c("HAD_3_DG") * dtheta_f)
  S_HAD_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      -c("HAD_6_PG") * (alpha_f - alpha_tgt_f))
  HAD = S_HAD_3 + S_HAD_6

  S_HFL_3 = ph_st * load_i * relu(
      -c("HFL_3_PG") * (theta - theta_tgt) - c("HFL_3_DG") * dtheta)
  S_HFL_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      c("HFL_6_PG") * (alpha - alpha_tgt) + c("HFL_6_DG") * dalpha)
  S_HFL_10 = ph_sw_hold_l * relu(c("HFL_10_PG") * (phi_hip - hip_tgt))
  HFL = pre + S_HFL_3 + S_HFL_6 + S_HFL_10

  S_GLU_3 = ph_st * load_i * relu(
      c("GLU_3_PG") * (theta - theta_tgt) + c("GLU_3_DG") * dtheta)
  S_GLU_6 = (ph_st_sw0 * load_c + ph_sw) * relu(
      -c("GLU_6_PG") * (alpha - alpha_tgt) - c("GLU_6_DG") * dalpha)
  S_GLU_10 = ph_sw_hold_l * relu(-c("GLU_10_PG") * (phi_hip - hip_tgt))
  GLU = pre + S_GLU_3 + S_GLU_6 + S_GLU_10

  S_HAM_3 = c("HAM_3_GLU") * S_GLU_3
  S_HAM_9 = ph_sw_stop_l * relu(
      -c("HAM_9_PG") * (alpha - (alpha_tgt + alpha_delta)))
  HAM = pre + S_HAM_3 + S_HAM_9

  st_load = ph_st_st + ph_st_sw0 * (1.0 - load_c)
  S_RF_1 = st_load * relu(c("RF_1_FG") * sens["F_RF"])
  S_RF_8 = ph_sw_hold_k * relu(-c("RF_8_DG_knee") * dphi_knee)
  RF = pre + S_RF_1 + S_RF_8

  S_VAS_1 = st_load * relu(c("VAS_1_FG") * sens["F_VAS"])
  S_VAS_2 = -st_load * relu(c("VAS_2_PG") * (phi_knee - knee_off_st))
  S_VAS_10 = ph_sw_hold_l * relu(-c("VAS_10_PG") * (phi_knee - knee_tgt))
  VAS = pre + S_VAS_1 + S_VAS_2 + S_VAS_10

  S_BFSH_2 = st_load * relu(c("BFSH_2_PG") * (phi_knee - knee_off_st))
  S_BFSH_7 = (ph_st_sw0 * load_c + ph_sw_flex_k) * relu(
      -c("BFSH_7_DG_alpha") * dalpha
      + c("BFSH_7_PG") * (phi_knee - knee_sw_tgt))
  S_BFSH_8 = ph_sw_hold_k * relu(
      c("BFSH_8_DG") * dphi_knee * c("BFSH_8_PG") * (alpha - alpha_tgt))
  S_BFSH_9 = relu(c("BFSH_9_G_HAM") * (S_HAM_9 - c("BFSH_9_HAM0")))
  S_BFSH_10 = ph_sw_hold_l * relu(c("BFSH_10_PG") * (phi_knee - knee_tgt))
  BFSH = pre + S_BFSH_2 + S_BFSH_7 + S_BFSH_8 + S_BFSH_9 + S_BFSH_10

  GAS = pre + ph_st * relu(c("GAS_2_FG") * sens["F_GAS"])
  S_SOL_1 = ph_st * relu(c("SOL_1_FG") * sens["F_SOL"])
  SOL = pre + S_SOL_1
  S_TA_5 = relu(c("TA_5_PG") * (phi_ankle - ankle_tgt))
  TA = pre + S_TA_5 - ph_st * relu(c("TA_5_G_SOL") * S_SOL_1)

  stim = torch.stack(
      [HAB, HAD, HFL, GLU, HAM, RF, VAS, BFSH, GAS, SOL, TA], dim=-1)
  return new_state, stim.clamp(0.01, 1.0)


class _WalkerSpec:
  """The walker's index and constant tensors on one device."""

  def __init__(self, w: "ReflexWalker", dm: model_mod.DeviceModel):
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dm.device)
    self.qadr = {k: t([a[0] for a in w.joints[k]]) for k in w.joints}
    self.dadr = {k: t([a[1] for a in w.joints[k]]) for k in w.joints}
    # ctrl[:, act] = stim.reshape(P, 22)[:, src]
    act, src, avg = [], [], np.zeros((w.model.nu, 2 * len(FORCE_KEYS)))
    for li in range(2):
      for ki, key in enumerate(M_KEYS):
        idx = w.groups[li, key]
        act += list(idx)
        src += [li * len(M_KEYS) + ki] * len(idx)
        if key in FORCE_KEYS:
          # -mean over the group of actuator_force / fmax, as one matmul
          col = FORCE_KEYS.index(key) * 2 + li
          avg[idx, col] = -1.0 / (len(idx) * w.fmax[li, key])
    self.act, self.src = t(act), t(src)
    self.force_avg = dm.tensor(avg)


class ReflexWalker:
  """The reflex controller wired to a two-leg model with MyoLeg's names
  (default: the ``legs80_reflex`` fixture), P walkers at once.

  ``step(d, state, cp)`` advances one control tick (``control_dt``, 10 ms:
  5 physics substeps at the model's 2 ms); ``rollout`` runs ``n`` ticks.
  Building a walker pins float32 matmul precision, as a ``MyoEnv`` does.
  """

  def __init__(self, model_path: str = DEFAULT_MODEL,
               control_dt: float = 0.01, dtype: torch.dtype = torch.float32):
    from myosuite_mjx_tpu_torch.envs.base import pin_float32_precision
    pin_float32_precision()
    self.model = m = model_mod.load_npz(model_path)
    self.dtype = dtype
    self.substeps = max(1, int(round(control_dt / float(m.opt.timestep))))
    self.pelvis_bid = m.name2id("body", "pelvis")
    self.touch = {s: int(m.sensor_objid[m.name2id("sensor", s)])
                  for s in ("r_foot", "r_toes", "l_foot", "l_toes")}
    self.total_weight = float(np.sum(m.body_mass) * 9.8)

    def jadr(name):
      j = m.name2id("joint", name)
      return int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])

    # (qpos, dof) address per side, right first
    self.joints = {k: [jadr(f"{name}_r"), jadr(f"{name}_l")]
                   for k, name in (("hip", "hip_flexion"),
                                   ("knee", "knee_angle"),
                                   ("ankle", "ankle_angle"),
                                   ("abd", "hip_adduction"))}
    self.groups, self.fmax = {}, {}     # (leg, key) -> actuators, F_max
    for li, leg in enumerate("rl"):
      for key, names in MUSCLE_GROUPS.items():
        idx = np.array([m.name2id("actuator", f"{n}_{leg}") for n in names])
        self.groups[li, key] = idx
        self.fmax[li, key] = np.asarray(m.actuator_biasprm[idx, 2],
                                        np.float64)
    self._device_models: dict = {}

  def device_model(self, device) -> model_mod.DeviceModel:
    """The model's constants on ``device`` in this walker's dtype."""
    device = torch.device(device)
    if device not in self._device_models:
      self._device_models[device] = model_mod.DeviceModel(
          self.model, self.dtype, device)
    return self._device_models[device]

  def _spec(self, dm: model_mod.DeviceModel) -> _WalkerSpec:
    return dm.spec("reflex_walker", lambda dm: _WalkerSpec(self, dm))

  # ---- sensor translation -------------------------------------------------

  def _sensor_data(self, d: data_mod.Data) -> dict:
    dm = self.device_model(d.qpos.device)
    s = self._spec(dm)
    b = self.pelvis_bid
    e = quat_ops.quat_to_euler(d.xquat[:, b])
    roll = e[:, 0] - 0.5 * math.pi
    pitch = -e[:, 2]
    yaw = -e[:, 1]
    cv = d.cvel[:, b]
    vel = cv[:, 3:] + torch.cross(cv[:, :3], d.xpos[:, b], dim=-1)
    dx = torch.cos(yaw) * vel[:, 0] - torch.sin(yaw) * vel[:, 1]
    dy = torch.sin(yaw) * vel[:, 0] + torch.cos(yaw) * vel[:, 1]

    def grf(leg):
      return (sensors.touch_sensor(dm, d, self.touch[f"{leg}_foot"])
              + sensors.touch_sensor(dm, d, self.touch[f"{leg}_toes"]))

    load = torch.stack([grf("r"), grf("l")], dim=-1) / self.total_weight
    qp = lambda k: d.qpos[:, s.qadr[k]]
    qv = lambda k: d.qvel[:, s.dadr[k]]
    phi_hip = math.pi - qp("hip")
    phi_knee = math.pi - qp("knee")
    phi_ankle = 0.5 * math.pi - qp("ankle")
    dphi_knee = -qv("knee")
    dphi_hip = -qv("hip")
    force = d.actuator_force @ s.force_avg     # [P, 2 * len(FORCE_KEYS)]
    contact = load > 0.1
    out = {
        "theta": torch.stack([roll, pitch], dim=-1),
        "d_pos": torch.stack([dx, dy], dim=-1),
        "dtheta": cv[:, :2],
        "contact_ipsi": contact,
        "contact_contra": contact.flip(-1),
        "load_ipsi": load,
        "load_contra": load.flip(-1),
        "alpha": phi_hip - 0.5 * phi_knee,
        "dalpha": dphi_hip - 0.5 * dphi_knee,
        "alpha_f": qp("abd") + 0.5 * math.pi,
        "phi_hip": phi_hip, "phi_knee": phi_knee, "phi_ankle": phi_ankle,
        "dphi_knee": dphi_knee,
    }
    for i, key in enumerate(FORCE_KEYS):
      out[f"F_{key}"] = force[:, 2 * i:2 * i + 2]
    return out

  def _stim_to_ctrl(self, stim: torch.Tensor) -> torch.Tensor:
    """stim [P, 2, 11] -> ctrl [P, nu]; muscles in no group get 0."""
    s = self._spec(self.device_model(stim.device))
    P = stim.shape[0]
    ctrl = stim.new_zeros((P, self.model.nu))
    ctrl[:, s.act] = stim.reshape(P, -1)[:, s.src]
    return ctrl

  # ---- rollout surface ----------------------------------------------------

  def reset(self, batch: int = 1, device="cuda", init: dict | None = None):
    """(Data, ReflexState) of ``batch`` walkers at the reference's walking
    start pose (pitched trunk, bent right leg, 1.5 m/s forward), on
    ``device`` (the card unless the caller asks for the CPU)."""
    init = dict(DEFAULT_INIT_POSE, **(init or {}))
    m = self.model
    qpos = np.array(m.qpos0, np.float64)
    # a +y rotation by +pitch (the reference's euler2quat([0, pitch, 0]))
    half = init["pitch"] / 2
    qpos[3:7] = [np.cos(half), 0.0, np.sin(half), 0.0]
    for name, val in init["joint_angles"].items():
      qpos[int(m.jnt_qposadr[m.name2id("joint", name)])] = val
    qpos[0:2] = 0.0
    qpos[2] = init["height"]
    qvel = np.zeros(m.nv)
    qvel[0] = init["forward_velocity"]
    dm = self.device_model(device)
    t = lambda x: torch.as_tensor(x, device=dm.device).to(
        self.dtype).expand(batch, -1).clone()
    d = data_mod.make_data(dm, batch, self.dtype, dm.device)
    d = forward_mod.forward(dm, d.replace(qpos=t(qpos), qvel=t(qvel)))
    return d, init_state(batch, dm.device)

  def step(self, d: data_mod.Data, state: ReflexState, cp: torch.Tensor):
    """One control tick: sense, stimulate, then the physics substeps (the
    ones before the last skip the diagnostics nothing reads)."""
    dm = self.device_model(d.qpos.device)
    state, stim = reflex_update(cp, state, self._sensor_data(d))
    d = d.replace(ctrl=self._stim_to_ctrl(stim).to(self.dtype))
    for _ in range(self.substeps - 1):
      d = forward_mod.step(dm, d, full_data=False)
    return forward_mod.step(dm, d), state

  def rollout(self, n_steps: int, params=None, init: dict | None = None,
              batch: int | None = None, device="cuda"):
    """``n_steps`` control ticks of ``batch`` walkers (default: one per row
    of ``params`` [P, 46], or one); returns (final Data, trajectory dict
    of tensors: pelvis ``height`` and ``x`` [T, P], ``footsteps`` [P],
    the rising edges of the contact flags over the run)."""
    params = np.ones(N_PARAMS) if params is None else np.asarray(params)
    if batch is None:
      batch = params.shape[0] if params.ndim == 2 else 1
    cp = expand_params(params, self.dtype, device)
    d, s = self.reset(batch, device, init)
    height, x, contact = [], [], []
    for _ in range(n_steps):
      d, s = self.step(d, s, cp)
      height.append(d.xpos[:, self.pelvis_bid, 2])
      x.append(d.xpos[:, self.pelvis_bid, 0])
      contact.append(s.in_contact)
    c = torch.stack(contact)
    steps = (c[1:] & ~c[:-1]).sum(dim=(0, 2))
    return d, {"height": torch.stack(height), "x": torch.stack(x),
               "footsteps": steps}
