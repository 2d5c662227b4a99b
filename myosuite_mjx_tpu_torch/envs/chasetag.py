"""Chase-tag: the legs against a scripted opponent, on a batch of envs.

Counterpart of ``myosuite_mjx_tpu/envs/chasetag.py``: CHASE and EVADE
tasks; the opponent's policies (static, stationary, colored-noise random,
chasing the player), its pose written to the scene's mocap body in every
``step``; the colored-noise drive (a 1/f^2 spectrum through an inverse
FFT at reset); ground reaction forces from the four touch sensors; the
quadrant terrain (``ChaseTagField``) as an ``hfield_data`` overlay; the
reference's win, lose and score rules.

Draws go through hooks that a parity test overrides to hand in JAX's:
``draw_opponent`` (task, policy, spawn, noise and chase speed) and
``draw_terrain`` (the quadrant field's draws).
"""
from __future__ import annotations

import math

import torch

from myosuite_mjx_tpu_torch.engine import sensors
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import EnvState, MyoEnv
from myosuite_mjx_tpu_torch.envs.heightfields import ChaseTagField
from myosuite_mjx_tpu_torch.envs.randomize import normal, uniform
from myosuite_mjx_tpu_torch.ops import quat as qmath

_NOISE_LEN = 2048


def colored_noise(re: torch.Tensor, im: torch.Tensor, beta: float = 2.0,
                  scale: float = 10.0) -> torch.Tensor:
  """Gaussian 1/f^beta noise rows [..., n] from the standard normal real
  and imaginary parts [..., n // 2 + 1] of its spectrum (shaped, inverse
  FFT, scaled to standard deviation ``scale``)."""
  n = 2 * (re.shape[-1] - 1)
  freqs = torch.fft.rfftfreq(n, dtype=torch.float64, device=re.device)
  amp = torch.where(freqs > 0, freqs.clamp(min=1e-300) ** (-beta / 2.0),
                    torch.zeros_like(freqs))
  spec = torch.complex(re.double(), im.double()) * amp
  x = torch.fft.irfft(spec, n=n, dim=-1)
  x = x / torch.clamp(x.std(dim=-1, correction=0, keepdim=True),
                      min=1e-8) * scale
  return x.to(re.dtype)


class ChaseTagEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "internal_qpos", "internal_qvel", "grf", "torso_angle",
      "opponent_pose", "opponent_vel", "model_root_pos", "model_root_vel",
      "muscle_length", "muscle_velocity", "muscle_force",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "distance": -0.1,
      "lose": -1000,
  }

  def _setup(self, reset_type="none", win_distance=0.5,
             min_spawn_distance=2.0, task_choice="CHASE", terrain="FLAT",
             hills_range=(0, 0), rough_range=(0, 0), relief_range=(0, 0),
             chase_vel_range=(1.0, 1.0), random_vel_range=(1.0, 1.0),
             opponent_probabilities=(0.1, 0.45, 0.45),
             repeller_opponent=False, repeller_vel_range=(1.0, 1.0),
             **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.reset_type = reset_type
    self.win_distance = win_distance
    self.min_spawn_distance = min_spawn_distance
    self.task_choice = task_choice
    self.terrain = terrain
    self.max_time = 20.0
    self.chase_vel_range = tuple(chase_vel_range)
    self.random_vel_range = tuple(random_vel_range)
    self.opponent_probabilities = tuple(opponent_probabilities)
    self.pelvis_bid = m.name2id("body", "pelvis")
    self.grf_sensors = ["r_foot", "r_toes", "l_foot", "l_toes"]
    self.grf_sites = [int(m.sensor_objid[m.name2id("sensor", n)])
                      for n in self.grf_sensors]
    self.init_qpos[:] = m.key_qpos[0]
    self.init_qvel[:] = 0.0
    if terrain != "FLAT" and m.nhfield:
      nrow, ncol = int(m.hfield_nrow[0]), int(m.hfield_ncol[0])
      self.field = ChaseTagField(
          nrow, ncol,
          rough_amplitude=rough_range[1],
          hills_amplitude=hills_range[1],
          relief_amplitude=relief_range[1])
    else:
      self.field = None

  # ---- draws --------------------------------------------------------------

  def draw_opponent(self, batch: int, device, generator) -> dict:
    """The episode's opponent: ``task`` [B] (0 CHASE, 1 EVADE), the policy
    draw ``policy_u`` [B] in U(0, 1), the spawn's angle draw ``spawn_u``
    [B] in U(0, 1) (the angle is 2 pi u and the heading 4 pi u - 2 pi:
    the reference draws both from one key), its radius ``spawn_r`` [B] in
    U(min_spawn_distance, 5), the noise spectrum's standard normal parts
    ``noise_re`` and ``noise_im`` [B, 2, 1025], and ``chase_vel`` [B]."""
    u = lambda lo=0.0, hi=1.0: uniform((batch,), generator, device,
                                       self.dtype, lo, hi)
    if self.task_choice == "random":
      task = (uniform((batch,), generator, device, torch.float64)
              < 0.5).to(torch.int32)
    else:
      task = torch.full((batch,), 0 if self.task_choice == "CHASE" else 1,
                        dtype=torch.int32, device=device)
    nf = _NOISE_LEN // 2 + 1
    return dict(
        task=task, policy_u=u(), spawn_u=u(),
        spawn_r=u(self.min_spawn_distance, 5.0),
        noise_re=normal((batch, 2, nf), generator, device, self.dtype),
        noise_im=normal((batch, 2, nf), generator, device, self.dtype),
        chase_vel=u(*self.chase_vel_range))

  def draw_terrain(self, batch: int, device, generator) -> dict:
    """The quadrant field's draws (``ChaseTagField.draw``)."""
    return self.field.draw(batch, generator, device, self.dtype)

  # ---- opponent -----------------------------------------------------------

  def reset_aux(self, batch: int, device, generator) -> dict:
    dr = self.draw_opponent(batch, device, generator)
    task = dr["task"].to(torch.int32)
    # policy: 0 static, 1 stationary, 2 random; 3 chases the player when
    # the player evades
    p = self.opponent_probabilities
    pu = dr["policy_u"]
    policy = torch.where(pu < p[0], 0, torch.where(pu < p[0] + p[1], 1, 2))
    policy = torch.where(task == 1, 3, policy).to(torch.int32)
    ang = dr["spawn_u"] * (2 * math.pi)
    heading = dr["spawn_u"] * (4 * math.pi) + (-2 * math.pi)
    rad = dr["spawn_r"]
    pose = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang), heading],
                       -1)
    return {
        "task": task,
        "policy": policy,
        "opp_pose": pose,
        "opp_vel": torch.zeros((batch, 2), dtype=self.dtype, device=device),
        "noise": colored_noise(dr["noise_re"], dr["noise_im"]),
        "chase_vel": dr["chase_vel"],
    }

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    if self.field is None:
      return {}
    field = self.field.from_draws(self.draw_terrain(batch, device, generator))
    return {"hfield_data": field.to(self.dtype)}

  def _opponent_step(self, aux: dict, data: Data, steps) -> dict:
    pose = aux["opp_pose"]
    B = pose.shape[0]
    pel = data.xpos[:, self.pelvis_bid, :2]
    idx = torch.remainder(steps.long(), _NOISE_LEN)
    noise = aux["noise"][torch.arange(B, device=pose.device), :, idx]
    noise_vel = torch.clamp(noise, *self.random_vel_range)
    # chase_player: toward the pelvis
    theta = pose[:, 2]
    heading = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    to_player = pel - pose[:, :2]
    chase_vel = torch.stack([aux["chase_vel"],
                             (heading * to_player).sum(-1)], -1)
    policy = aux["policy"][:, None]
    zero = torch.zeros_like(noise_vel)
    vel = torch.where(policy == 0, zero,
                      torch.where(policy == 1, zero,
                                  torch.where(policy == 2, noise_vel,
                                              chase_vel)))
    vel = torch.clamp(torch.cat([vel[:, :1].abs(), vel[:, 1:]], -1), -2, 2)
    x_vel = vel[:, 0] * torch.cos(pose[:, 2] + 0.5 * math.pi)
    y_vel = vel[:, 0] * torch.sin(pose[:, 2] + 0.5 * math.pi)
    new_pose = torch.stack([
        torch.clamp(pose[:, 0] - self.dt * x_vel, -5.5, 5.5),
        torch.clamp(pose[:, 1] - self.dt * y_vel, -5.5, 5.5),
        pose[:, 2] + self.dt * vel[:, 1]], -1)
    return {**aux, "opp_pose": new_pose, "opp_vel": vel}

  def step(self, state: EnvState, action: torch.Tensor,
           generator: torch.Generator | None = None) -> EnvState:
    """Advance the opponent and write its pose to the mocap body, then
    the control step."""
    aux = self._opponent_step(state.aux, state.data, state.steps)
    pose = aux["opp_pose"]
    zero = torch.zeros_like(pose[:, 2])
    quat = qmath.euler_to_quat(torch.stack([zero, zero, pose[:, 2]], -1))
    mocap_pos = state.data.mocap_pos.clone()
    mocap_pos[:, 0, :2] = pose[:, :2]
    mocap_quat = state.data.mocap_quat.clone()
    mocap_quat[:, 0] = quat
    data = state.data.replace(mocap_pos=mocap_pos, mocap_quat=mocap_quat)
    return super().step(state.replace(data=data, aux=aux), action, generator)

  # ---- obs / reward -------------------------------------------------------

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    dm = self.device_model(data.qpos.device)
    grf = torch.stack([sensors.touch_sensor(dm, data, s)
                       for s in self.grf_sites], -1)
    return {
        "time": data.time[:, None],
        "internal_qpos": data.qpos[:, 7:35],
        "internal_qvel": data.qvel[:, 6:34] * self.dt,
        "grf": grf,
        "torso_angle": data.xquat[:, self.pelvis_bid],
        "opponent_pose": aux["opp_pose"],
        "opponent_vel": aux["opp_vel"],
        "model_root_pos": data.qpos[:, :2],
        "model_root_vel": data.qvel[:, :2],
        "muscle_length": data.actuator_length,
        "muscle_velocity": torch.clamp(data.actuator_velocity, -100, 100),
        "muscle_force": torch.clamp(data.actuator_force / 1000, -100, 100),
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    root = data.xpos[:, self.pelvis_bid, :2]
    opp = aux["opp_pose"][:, :2]
    dist = torch.linalg.vector_norm(root - opp, dim=-1)
    t = data.time
    tagged = dist <= self.win_distance
    oob = (root[:, 0].abs() > 6.5) | (root[:, 1].abs() > 6.5)
    fallen = data.xpos[:, self.pelvis_bid, 2] < 0.5
    timeout = t >= self.max_time
    is_chase = aux["task"] == 0
    win = torch.where(is_chase, tagged, timeout)
    lose = torch.where(is_chase, fallen | timeout | oob, tagged | oob)
    zero = torch.zeros_like(t)
    score = torch.where(
        is_chase, torch.where(win, 1.0 - t / self.max_time, zero),
        torch.where(win | lose, t / self.max_time, zero))
    return {
        "act_reg": self.act_magnitude(obs_dict["act"]),
        "distance": dist,
        "lose": lose,
        "sparse": score,
        "solved": win,
        "done": win | lose,
    }
