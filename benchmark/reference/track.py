"""Plain reference, frozen from the port's ``envs/track.py`` (``TrackEnv``)
and importing nothing of it.

MyoDM motion tracking on a batch of environments: a hand on a 6-dof base
and an object on 3 slides and 3 hinges follow a reference clip
(``reference_motion.py``: FIXED, RANDOM or TRACK). The rewards are
MyoDM's: the object's position and rotation errors and the wrist-object
distance as exponentials, the hand's joint position and velocity errors,
a lift bonus once the target and the object are both 2 cm above the
object's start; the episode ends when the object strays 25 cm from its
target or from the wrist (and, with ``terminate_pose_fail``, when the
hand's pose strays).

Counterpart of MyoSuite's ``TrackEnv`` (``myosuite/envs/myo/myodm/
myodm_v0.py``) and of the MJX branch's (``mjx/myodm_v0.py``). The
departures the port has, kept here:

- the scene is the ``model_path`` given, not one derived from the
  object's name through MyoSuite's asset tree; the robot's dofs come first
  in qpos (the clip's robot width), then the object's six;
- a relative ``reference`` path is read against the checkout's root;
- the action goes through ``MyoEnv``'s normalisation: the sigmoid for the
  muscles, a linear map onto the control range for the base's position
  actuators;
- the lift height is the object's centre of mass at the init pose, from a
  float64 kinematics pass once at set-up, plus the 2 cm threshold;
- the rotation error is ``quat_diff_vel``'s angle; the terminations
  compare squared distances with squared thresholds;
- a RANDOM reference is drawn once per episode at reset and kept in aux
  under ``ref_draw``.

``termination_margins`` gives the object and base terminations' signed
distances for the benchmark's margin rule.
"""
from __future__ import annotations

import math
import os

import torch

from . import data as data_mod
from . import model as model_mod
from . import quat as qmath
from . import smooth
from .base import MyoEnv
from .data import Data
from .reference_motion import ReferenceMotion, ReferenceType

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class TrackEnv(MyoEnv):
  DEFAULT_OBS_KEYS = ["qp", "qv", "hand_qpos_err", "hand_qvel_err",
                      "obj_com_err"]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pose": 0.0,
      "object": 1.0,
      "bonus": 1.0,
      "penalty": -2,
  }

  def __init__(self, model_path, object_name: str, reference, **kwargs):
    self.object_name = object_name
    if isinstance(reference, str) and not os.path.isabs(reference):
      reference = os.path.join(ROOT, reference)
    self._reference_data = reference
    super().__init__(model_path=model_path, **kwargs)

  def _setup(self, motion_start_time: float = 0.0,
             motion_extrapolation: bool = True,
             terminate_obj_fail: bool = True,
             terminate_pose_fail: bool = False, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.ref = ReferenceMotion(
        self._reference_data, motion_extrapolation=motion_extrapolation,
        dtype=self.dtype)
    self.motion_start_time = motion_start_time
    self.term_obj = terminate_obj_fail
    self.term_pose = terminate_pose_fail

    # MyoDM's task constants
    self.lift_bonus_thresh = 0.02
    self.obj_err_scale = 50.0
    self.base_err_scale = 40.0
    self.lift_bonus_mag = 1.0
    self.qpos_reward_weight = 0.35
    self.qpos_err_scale = 5.0
    self.qvel_reward_weight = 0.05
    self.qvel_err_scale = 0.1
    self.obj_fail_thresh = 0.25
    self.base_fail_thresh = 0.25
    self.qpos_fail_thresh = 0.75

    self.object_bid = m.name2id("body", self.object_name)
    self.wrist_bid = m.name2id("body", "lunate")

    # the init pose from the clip: the robot, the object's position on its
    # slides and its Euler angles on its hinges
    robot_init, object_init = self.ref.get_init()
    rd = self.ref.robot_dim
    if robot_init is not None:
      self.init_qpos[:rd] = robot_init
    if object_init is not None:
      self.init_qpos[rd:rd + 3] = object_init[:3]
      self.init_qpos[-3:] = qmath.quat_to_euler(
          torch.as_tensor(object_init[3:7], dtype=torch.float64)).numpy()

    # the lift height: the object's centre of mass at the init pose, a
    # float64 kinematics pass
    dm = model_mod.DeviceModel(m, torch.float64, "cpu")
    d0 = data_mod.make_data(dm, 1, torch.float64, "cpu")
    kin = smooth.kinematics(dm, torch.as_tensor(self.init_qpos)[None],
                            mocap_pos=d0.mocap_pos, mocap_quat=d0.mocap_quat)
    self._lift_z = (float(kin["xipos"][0, self.object_bid, 2])
                    + self.lift_bonus_thresh)

  def draw_reference(self, batch: int, device, generator) -> dict:
    """A RANDOM reference's draw for each new episode (``ref.draw``)."""
    return self.ref.draw(batch, generator, device)

  def reset_aux(self, batch: int, device, generator) -> dict:
    if self.ref.type == ReferenceType.RANDOM:
      return {"ref_draw": self.draw_reference(batch, device, generator)}
    return {}

  def _curr_ref(self, data: Data, aux: dict) -> dict:
    return self.ref.get_reference(data.time + self.motion_start_time,
                                  aux.get("ref_draw"))

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    ref = self._curr_ref(data, aux)
    rd = self.ref.robot_dim
    B = data.qpos.shape[0]
    obj_com = data.xipos[:, self.object_bid]
    obj_rot = qmath.mat_to_quat(data.ximat[:, self.object_bid])
    wrist = data.xipos[:, self.wrist_bid]
    hand_qpos = data.qpos[:, :rd]
    hand_qvel = data.qvel[:, :rd]
    targ_qpos = ref["robot"]
    zero1 = data.qpos.new_zeros((B, 1))
    has_vel = ref["robot_vel"] is not None
    targ_qvel = ref["robot_vel"] if has_vel else zero1
    return {
        "time": data.time[:, None],
        "qp": data.qpos,
        "qv": data.qvel,
        "curr_hand_qpos": hand_qpos,
        "curr_hand_qvel": hand_qvel,
        "targ_hand_qpos": targ_qpos,
        "targ_hand_qvel": targ_qvel,
        "curr_obj_com": obj_com,
        "curr_obj_rot": obj_rot,
        "wrist_err": wrist,
        "base_error": obj_com - wrist,
        "targ_obj_com": ref["object"][:, :3],
        "targ_obj_rot": ref["object"][:, 3:7],
        "hand_qpos_err": hand_qpos - targ_qpos,
        "hand_qvel_err": hand_qvel - targ_qvel if has_vel else zero1,
        "obj_com_err": obj_com - ref["object"][:, :3],
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def _rotation_distance(self, q1, q2):
    """|angle| [B] between quaternions (MyoDM's rotation_distance)."""
    return qmath.quat_diff_vel(q2, q1, 1.0)[:, 0].abs()

  def termination_margins(self, data: Data) -> dict:
    """The object and base terminations' signed distances [B], negative
    where the episode ends under ``terminate_obj_fail``: 25 cm less the
    object's distance from its target at the data's time, and 25 cm less
    its distance from the wrist."""
    obs = self.get_obs_dict(data, {})
    dist = lambda x: torch.sqrt(torch.square(x).sum(-1))
    return {"object": self.obj_fail_thresh - dist(obs["obj_com_err"]),
            "base": self.base_fail_thresh - dist(obs["base_error"])}

  def _check_termination(self, obs_dict: dict) -> torch.Tensor:
    norm2 = lambda x: torch.square(x).sum(-1)
    term = torch.zeros_like(obs_dict["time"][:, 0], dtype=torch.bool)
    if self.term_obj:
      obj_term = norm2(obs_dict["obj_com_err"]) >= self.obj_fail_thresh ** 2
      base_term = norm2(obs_dict["base_error"]) >= self.base_fail_thresh ** 2
      term = term | obj_term | base_term
    if self.term_pose:
      term = term | (norm2(obs_dict["hand_qpos_err"])
                     >= self.qpos_fail_thresh)
    return term

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    norm2 = lambda x: torch.square(x).sum(-1)
    obj_com_err = torch.sqrt(norm2(
        obs_dict["targ_obj_com"] - obs_dict["curr_obj_com"]))
    obj_rot_err = self._rotation_distance(
        obs_dict["curr_obj_rot"], obs_dict["targ_obj_rot"]) / math.pi
    obj_reward = torch.exp(
        -self.obj_err_scale * (obj_com_err + 0.1 * obj_rot_err))
    lift_bonus = ((obs_dict["targ_obj_com"][:, 2] >= self._lift_z)
                  & (obs_dict["curr_obj_com"][:, 2] >= self._lift_z))
    qpos_reward = torch.exp(
        -self.qpos_err_scale * norm2(obs_dict["hand_qpos_err"]))
    qvel_reward = torch.exp(
        -self.qvel_err_scale * norm2(obs_dict["hand_qvel_err"]))
    base_reward = torch.exp(
        -self.base_err_scale * torch.sqrt(norm2(obs_dict["base_error"])))
    term = self._check_termination(obs_dict)
    dtype = obj_reward.dtype
    return {
        "pose": (self.qpos_reward_weight * qpos_reward
                 + self.qvel_reward_weight * qvel_reward),
        "object": obj_reward + base_reward,
        "bonus": self.lift_bonus_mag * lift_bonus.to(dtype),
        "penalty": term.to(dtype),
        "sparse": torch.zeros_like(obj_reward),
        "solved": torch.zeros_like(term),
        "done": term,
    }
