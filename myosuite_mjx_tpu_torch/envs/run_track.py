"""MyoChallenge RunTrack: a trans-femoral leg with the OSL prosthesis, on a
batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/run_track.py``: the 54 muscles are
the action (``action_dim = na``); the prosthesis's knee and ankle motors
are driven by the OSL impedance machine (``envs/osl.py``), which reads its
sensors from the physics before the step (the joints, and the load as -y
of the ``r_osl_load`` force sensor); a track terrain per episode
(``ChallengeTrackField``: flat, random or random_mixed) as an
``hfield_data`` overlay; keyframe or gait-cycle resets with a height
adjustment; the win, lose and pain rules.

Resets (``reset_type``):

- ``random``: keyframe 0, 1 or 2 (OSL in early stance for 0 and 2, early
  swing for 1), x drawn within 0.8 of the track's half width, y at
  ``start_pos + 1``, the heading drawn in [-125, -60] degrees and the
  planar speed turned onto it;
- ``osl_init``: a row of the gait table at ``init_pose_path`` (joint
  columns, pelvis Euler angles and velocity, and the row's OSL state);
- ``init``: keyframe 0 as it is, early stance.

Every reset but ``init`` lifts the body so that the lowest of the four
heel and toe sites is 5 mm over the floor. The reference draws the
terrain and the state from two keys split from one; here they come from
the generator one after the other, through ``draw_terrain`` and
``draw_reset_state``, which a parity test overrides to hand in JAX's.
"""
from __future__ import annotations

import csv
import math

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import sensors, smooth
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs import osl
from myosuite_mjx_tpu_torch.envs.base import EnvState, MyoEnv
from myosuite_mjx_tpu_torch.envs.heightfields import (ChallengeTrackField,
                                                      local_heightmap)
from myosuite_mjx_tpu_torch.envs.randomize import uniform
from myosuite_mjx_tpu_torch.ops import quat as qmath

# the joints whose limit forces make the pain signal
PAIN_JNT = [
    "hip_adduction_l", "hip_adduction_r", "hip_flexion_l", "hip_flexion_r",
    "hip_rotation_l", "hip_rotation_r", "knee_angle_l",
    "knee_angle_l_rotation2", "knee_angle_l_rotation3", "mtp_angle_l",
    "ankle_angle_l", "subtalar_angle_l",
]
BIOLOGICAL_JNT = [
    "hip_adduction_l", "hip_flexion_l", "hip_rotation_l", "hip_adduction_r",
    "hip_flexion_r", "hip_rotation_r", "knee_angle_l",
    "knee_angle_l_beta_rotation1", "knee_angle_l_beta_translation1",
    "knee_angle_l_beta_translation2", "knee_angle_l_rotation2",
    "knee_angle_l_rotation3", "knee_angle_l_translation1",
    "knee_angle_l_translation2", "mtp_angle_l", "ankle_angle_l",
    "subtalar_angle_l",
]
# the muscles, in the order of the muscle observations
BIOLOGICAL_ACT = [
    "addbrev_l", "addbrev_r", "addlong_l", "addlong_r", "addmagDist_l",
    "addmagIsch_l", "addmagMid_l", "addmagProx_l", "bflh_l", "bfsh_l",
    "edl_l", "ehl_l", "fdl_l", "fhl_l", "gaslat_l", "gasmed_l", "glmax1_l",
    "glmax1_r", "glmax2_l", "glmax2_r", "glmax3_l", "glmax3_r", "glmed1_l",
    "glmed1_r", "glmed2_l", "glmed2_r", "glmed3_l", "glmed3_r", "glmin1_l",
    "glmin1_r", "glmin2_l", "glmin2_r", "glmin3_l", "glmin3_r", "grac_l",
    "iliacus_l", "iliacus_r", "perbrev_l", "perlong_l", "piri_l", "piri_r",
    "psoas_l", "psoas_r", "recfem_l", "sart_l", "semimem_l", "semiten_l",
    "soleus_l", "tfl_l", "tibant_l", "tibpost_l", "vasint_l", "vaslat_l",
    "vasmed_l",
]
# gait-table rows -> OSL state (0 early stance, 1 late stance, 2 early
# swing, 3 late swing): [lo, hi) and the state
GAIT_STATE_BOUNDS = [(0, 48, 2), (48, 99, 3), (99, 183, 0), (183, 247, 1)]
# gait-table columns that are not joints
_GAIT_SKIP = {"pelvis_euler_roll", "pelvis_euler_pitch", "pelvis_euler_yaw",
              "l_foot_relative_X", "l_foot_relative_Y", "l_foot_relative_Z",
              "r_foot_relative_X", "r_foot_relative_Y", "r_foot_relative_Z",
              "pelvis_vel_X", "pelvis_vel_Y", "pelvis_vel_Z"}


class RunTrackEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "internal_qpos", "internal_qvel", "grf", "torso_angle",
      "model_root_pos", "model_root_vel", "muscle_length",
      "muscle_velocity", "muscle_force",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "sparse": 1,
      "solved": +10,
  }

  def _setup(self, reset_type="random", terrain="flat",
             hills_difficulties=(0, 0), rough_difficulties=(0, 0),
             stairs_difficulties=(0, 0), real_width=1.0, end_pos=-15,
             start_pos=14, init_pose_path=None, osl_param_set=4,
             max_episode_steps=1000, **kwargs):
    # osl_param_set and max_episode_steps are the reference's kwargs,
    # accepted and unused, as there (the horizon comes from the registry)
    super()._setup(**kwargs)
    m = self.model
    self.action_dim = int(m.na)  # the OSL motors are driven internally
    self.reset_type = reset_type
    self.real_width = float(real_width)
    self.end_pos = float(end_pos)
    self.start_pos = float(start_pos)

    sensor_site = lambda n: int(m.sensor_objid[m.name2id("sensor", n)])
    self.pelvis_bid = m.name2id("body", "pelvis")
    self.head_sid = m.name2id("site", "head")
    self.talus_l_bid = m.name2id("body", "talus_l")
    self.osl_foot_bid = m.name2id("body", "osl_foot_assembly")
    self.grf_sites = [sensor_site(n) for n in ("l_foot", "l_toes")]
    # the load cell and the socket's load (site force sensors)
    self.osl_load_site = sensor_site("r_osl_load")
    self.socket_site = sensor_site("r_socket_load")
    self.btm_sites = [m.name2id("site", s) for s in
                      ("r_heel_btm", "r_toe_btm", "l_heel_btm", "l_toe_btm")]

    jnt = lambda n: m.name2id("joint", n)
    self._bio_qadr = np.array([m.jnt_qposadr[jnt(j)] for j in BIOLOGICAL_JNT])
    self._bio_dadr = np.array([m.jnt_dofadr[jnt(j)] for j in BIOLOGICAL_JNT])
    self._bio_act = np.array([m.name2id("actuator", a)
                              for a in BIOLOGICAL_ACT])
    self._osl_qadr = [int(m.jnt_qposadr[jnt(j)])
                      for j in ("osl_knee_angle_r", "osl_ankle_angle_r")]
    self._osl_dadr = [int(m.jnt_dofadr[jnt(j)])
                      for j in ("osl_knee_angle_r", "osl_ankle_angle_r")]
    self._osl_act = [m.name2id("actuator", f"osl_{j}_torque_actuator")
                     for j in ("knee", "ankle")]
    self._osl_gear = np.array([m.actuator_gear[a][0] for a in self._osl_act])
    self._osl_ctrlrange = np.array([m.actuator_ctrlrange[a]
                                    for a in self._osl_act])
    self._osl_params = osl.OSLParams(
        body_weight=float(np.sum(m.body_mass)) * 9.81)

    # pain joints -> their slot among the limited joints (the columns of
    # Data.efc_force_limit, in joint order); unlimited ones have none
    limited = [j for j in range(m.njnt) if bool(m.jnt_limited[j])]
    dadr_to_slot = {int(m.jnt_dofadr[j]): i for i, j in enumerate(limited)}
    self._pain_slots = np.array([
        dadr_to_slot[int(m.jnt_dofadr[jnt(j)])] for j in PAIN_JNT
        if int(m.jnt_dofadr[jnt(j)]) in dadr_to_slot], np.int64)
    self._pain_n = len(PAIN_JNT)

    self.nrow, self.ncol = int(m.hfield_nrow[0]), int(m.hfield_ncol[0])
    self.trackfield = ChallengeTrackField(
        self.nrow, self.ncol, rough_difficulties, hills_difficulties,
        stairs_difficulties, reset_type=terrain)
    self._hf_size = (float(m.hfield_size[0][0]), float(m.hfield_size[0][1]))

    if init_pose_path is not None:
      self._init_data = np.loadtxt(init_pose_path, skiprows=1,
                                   delimiter=",")
      with open(init_pose_path) as f:
        headers = next(csv.reader(f))
      self._gait_cols = {h: i for i, h in enumerate(headers)}
      self._gait_states = np.zeros(self._init_data.shape[0], np.int32)
      for lo, hi, s in GAIT_STATE_BOUNDS:
        self._gait_states[lo:min(hi, len(self._gait_states))] = s
      joints = [h for h in headers if h not in _GAIT_SKIP]
      self._gait_qadr = np.array([m.jnt_qposadr[jnt(h)] for h in joints],
                                 np.int64)
      self._gait_jcols = np.array([self._gait_cols[h] for h in joints],
                                  np.int64)
    else:
      self._init_data = None

    self.init_qpos[:] = m.key_qpos[0]
    self.init_qvel[:] = 0.0
    self._on_device: dict[torch.device, dict] = {}

  def _tables(self, device) -> dict:
    """The step's index and actuator tables as tensors on ``device``
    (cached)."""
    device = torch.device(device)
    if device not in self._on_device:
      idx = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
      val = lambda x: torch.as_tensor(x, device=device).to(self.dtype)
      self._on_device[device] = {
          "osl_act": idx(self._osl_act), "osl_gear": val(self._osl_gear),
          "osl_ctrlrange": val(self._osl_ctrlrange),
          "bio_qadr": idx(self._bio_qadr), "bio_dadr": idx(self._bio_dadr),
          "bio_act": idx(self._bio_act), "pain_slots": idx(self._pain_slots)}
    return self._on_device[device]

  # ---- draws (a parity test overrides these to hand in JAX's) -------------

  def draw_terrain(self, batch: int, device, generator) -> dict:
    """The track's draws (``ChallengeTrackField.draw``)."""
    return self.trackfield.draw(batch, generator, device, self.dtype)

  def draw_reset_state(self, batch: int, device, generator) -> dict:
    """``random``: the keyframe ``key`` [B] in {0, 1, 2}, ``x`` [B] within
    0.8 of the half width and ``yaw`` [B] in [-125, -60] degrees;
    ``osl_init``: the gait-table ``row`` [B]; nothing otherwise."""
    if self.reset_type == "random":
      w = 0.8 * self.real_width
      return dict(
          key=torch.floor(uniform((batch,), generator, device,
                                  torch.float64, 0, 3)).long(),
          x=uniform((batch,), generator, device, self.dtype, -w, w),
          yaw=uniform((batch,), generator, device, self.dtype,
                      math.radians(-125.0), math.radians(-60.0)))
    if self.reset_type == "osl_init" and self._init_data is not None:
      n = self._init_data.shape[0]
      return dict(row=torch.floor(uniform((batch,), generator, device,
                                          torch.float64, 0, n)).long())
    return {}

  # ---- reset ----------------------------------------------------------------

  def reset_aux(self, batch: int, device, generator) -> dict:
    hfield, terrain_type = self.trackfield.from_draws(
        self.draw_terrain(batch, device, generator), batch, device,
        self.dtype)
    qpos, qvel, osl_state = self._reset_state(
        batch, device, self.draw_reset_state(batch, device, generator))
    return {"hfield": hfield, "terrain_type": terrain_type,
            "osl_state": osl_state, "qpos0": qpos, "qvel0": qvel}

  def _keys(self, device):
    t = lambda x: torch.as_tensor(np.asarray(x), device=device).to(self.dtype)
    return t(self.model.key_qpos), t(self.model.key_qvel)

  def _reset_state(self, batch: int, device, draws: dict):
    """(qpos [B, nq], qvel [B, nv], osl_state [B] int32) before the height
    adjustment."""
    key_qpos, key_qvel = self._keys(device)
    if self.reset_type == "random":
      idx = draws["key"].to(device)
      qpos, qvel = key_qpos[idx].clone(), key_qvel[idx].clone()
      osl_state = torch.where((idx == 0) | (idx == 2), 0, 2).to(torch.int32)
      yaw = draws["yaw"]
      eul = qmath.quat_to_euler_intrinsic(qpos[:, 3:7])
      quat = qmath.euler_intrinsic_to_quat(
          torch.stack([eul[:, 0], eul[:, 1], yaw], -1))
      speed = torch.linalg.vector_norm(qvel[:, :2], dim=-1)
      qpos[:, 0] = draws["x"]
      qpos[:, 1] = self.start_pos + 1
      qpos[:, 3:7] = quat
      qvel[:, 0] = speed * torch.cos(yaw)
      qvel[:, 1] = speed * torch.sin(yaw)
      return qpos, qvel, osl_state
    if self.reset_type == "osl_init" and self._init_data is not None:
      return self._init_from_gait_data(batch, device, draws["row"])
    return (key_qpos[0].expand(batch, -1).clone(),
            key_qvel[0].expand(batch, -1).clone(),
            torch.zeros((batch,), dtype=torch.int32, device=device))

  def _init_from_gait_data(self, batch: int, device, row: torch.Tensor):
    """A gait-table row per env: its joints over keyframe 0, the pelvis's
    Euler angles, and its velocity turned by keyframe 0's heading."""
    key_qpos, _ = self._keys(device)
    cols = self._gait_cols
    data = torch.as_tensor(self._init_data, device=device).to(
        self.dtype)[row.to(device)]
    qpos = key_qpos[0].expand(batch, -1).clone()
    qvel = torch.zeros((batch, self.model.nv), dtype=self.dtype,
                       device=device)
    qpos[:, torch.as_tensor(self._gait_qadr, device=device)] = data[
        :, torch.as_tensor(self._gait_jcols, device=device)]
    default_yaw = qmath.quat_to_euler_intrinsic(qpos[:, 3:7])[:, 2]
    qpos[:, 3:7] = qmath.euler_intrinsic_to_quat(torch.stack([
        data[:, cols["pelvis_euler_roll"]],
        data[:, cols["pelvis_euler_pitch"]],
        data[:, cols["pelvis_euler_yaw"]]], -1))
    vx, vy = data[:, cols["pelvis_vel_X"]], data[:, cols["pelvis_vel_Y"]]
    c, s = torch.cos(default_yaw), torch.sin(default_yaw)
    qvel[:, 0] = c * vx - s * vy
    qvel[:, 1] = s * vx + c * vy
    qvel[:, 2] = data[:, cols["pelvis_vel_Z"]]
    osl_state = torch.as_tensor(self._gait_states, device=device)[
        row.to(device)]
    return qpos, qvel, osl_state

  def reset_qpos_qvel(self, batch: int, device, aux: dict, generator):
    qpos, qvel = aux["qpos0"].clone(), aux["qvel0"].clone()
    if self.reset_type != "init":
      # the lowest heel or toe site to 5 mm, from a kinematics pass
      dm = self.device_model(device)
      nmocap = self.model.nmocap
      kin = smooth.kinematics(
          dm, qpos, full_data=False,
          mocap_pos=qpos.new_zeros((batch, nmocap, 3)),
          mocap_quat=qpos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(
              batch, nmocap, 4))
      lows = kin["site_xpos"][:, self.btm_sites, 2]
      qpos[:, 2] = qpos[:, 2] + (0.005 - lows.amin(-1))
    return qpos, qvel

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    return {"hfield_data": aux["hfield"]}

  # ---- the OSL in the loop --------------------------------------------------

  def _osl_sens(self, data: Data) -> torch.Tensor:
    """[B, 5]: knee angle and velocity, ankle angle and velocity, and the
    load (-y of the load cell's force sensor)."""
    dm = self.device_model(data.qpos.device)
    load = -sensors.force_sensor(dm, data, self.osl_load_site)[:, 1]
    return torch.stack([
        data.qpos[:, self._osl_qadr[0]], data.qvel[:, self._osl_dadr[0]],
        data.qpos[:, self._osl_qadr[1]], data.qvel[:, self._osl_dadr[1]],
        load], -1).to(self.dtype)

  def control(self, state: EnvState, action: torch.Tensor):
    """The muscles from the action (sigmoid); the OSL motors from the
    machine's torques (raw ctrl, torque over gear, clipped to the ctrl
    range), on the sensors before the step; then the muscle condition."""
    aux = dict(state.aux)
    sens = self._osl_sens(state.data)
    aux["osl_state"], torque = osl.step(aux["osl_state"], sens,
                                        self._osl_params)
    action = action.to(self.dtype)
    full = torch.cat([action, action.new_zeros((action.shape[0], 2))], -1)
    ctrl = self._action_to_ctrl(full)
    tab = self._tables(ctrl.device)
    cr = tab["osl_ctrlrange"]
    osl_ctrl = torch.clamp(torque / tab["osl_gear"], cr[:, 0], cr[:, 1])
    ctrl = ctrl.index_copy(1, tab["osl_act"], osl_ctrl)
    return self._apply_muscle_condition(ctrl, aux)

  # ---- obs / reward ---------------------------------------------------------

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    dm = self.device_model(data.qpos.device)
    B = data.qpos.shape[0]
    grf = torch.stack([sensors.touch_sensor(dm, data, s)
                       for s in self.grf_sites], -1)
    hmap = local_heightmap(data.overlay["hfield_data"], self.nrow, self.ncol,
                           self._hf_size, data.qpos[:, :2])
    tab = self._tables(data.qpos.device)
    act = tab["bio_act"]
    return {
        "time": data.time[:, None],
        "terrain": aux["terrain_type"][:, None].to(self.dtype),
        "internal_qpos": data.qpos[:, tab["bio_qadr"]],
        "internal_qvel": data.qvel[:, tab["bio_dadr"]] * self.dt,
        "grf": grf,
        "socket_force": sensors.force_sensor(dm, data, self.socket_site).to(
            self.dtype),
        "torso_angle": data.xquat[:, self.pelvis_bid],
        "muscle_length": data.actuator_length[:, act],
        "muscle_velocity": torch.clamp(data.actuator_velocity[:, act],
                                       -100, 100),
        "muscle_force": torch.clamp(data.actuator_force[:, act] / 1000,
                                    -100, 100),
        "model_root_pos": data.qpos[:, :2],
        "model_root_vel": data.qvel[:, :2],
        "hfield": hmap.reshape(B, -1),
        "act": data.act,
    }

  def _fallen(self, data: Data) -> torch.Tensor:
    head = data.site_xpos[:, self.head_sid]
    feet = 0.5 * (data.xpos[:, self.talus_l_bid]
                  + data.xpos[:, self.osl_foot_bid])
    return (head[:, 2] - feet[:, 2] < 0.2) | (head[:, 2] < 1.5)

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    x = obs_dict["model_root_pos"][:, 0]
    y = obs_dict["model_root_pos"][:, 1]
    vel_y = obs_dict["model_root_vel"][:, 1]
    win = y < self.end_pos
    lose = ((x.abs() > self.real_width) | (y > self.start_pos + 2)
            | self._fallen(data))
    act_mag = torch.square(obs_dict["act"]).mean(-1)
    pain_f = data.efc_force_limit[
        :, self._tables(data.qpos.device)["pain_slots"]]
    pain = (torch.clamp(pain_f.abs(), 0, 1000) / 1000).sum(-1) / self._pain_n
    return {
        "act_reg": act_mag,
        "pain": pain,
        "sparse": -vel_y,
        "solved": win,
        "done": win | lose,
    }
