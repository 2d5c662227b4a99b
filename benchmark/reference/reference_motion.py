"""Plain reference, frozen from the port's ``logger/reference_motion.py``
and importing nothing of it.

Reference motions (FIXED, RANDOM, TRACK) for a batch of environments.

Counterpart of ``myosuite_mjx_tpu/logger/reference_motion.py`` and of
MyoSuite's ``myosuite/logger/reference_motion.py``. A clip
holds ``time`` and any of ``robot`` [H, robot_dim], ``robot_vel``,
``object`` [H, 7] (position, quaternion), ``robot_init`` and
``object_init``. Its horizon, the larger of the robot's and the object's,
sets its type: 1 FIXED, 2 RANDOM (the two rows are a range), more TRACK.

- TRACK: ``get_reference(time [B])`` interpolates linearly between the
  two frames around each env's time (a ``searchsorted`` over the clip's
  times, rounded to 4 decimals at load); past the end it holds the last
  frame when ``motion_extrapolation`` is on. A part whose horizon is above
  1 but below the clip's takes its frame indices clamped to its last row,
  as the reference's gather does. Without ``robot_vel`` a clip takes the
  robot's time gradient.
- RANDOM: ``draw(batch, generator, device)`` draws one uniform value per
  env within each part's range; a task draws once per episode and keeps
  the draw, and ``get_reference(time, draws)`` returns it, as the
  reference returns the same draw for the whole episode.
- FIXED: the one frame, for every env.

``*_init`` defaults to the first frame (the mean of the range for RANDOM).
"""
from __future__ import annotations

import enum
import pickle

import numpy as np
import torch

_TIME_PRECISION = 4
_PARTS = ("robot", "robot_vel", "object")


class ReferenceType(enum.Enum):
  FIXED = 0
  RANDOM = 1
  TRACK = 2


class ReferenceMotion:
  """A clip loaded from ``.npz``, ``.pkl`` or a dict; batched queries."""

  def __init__(self, reference_data, motion_extrapolation: bool = True,
               dtype: torch.dtype = torch.float32):
    self.dtype = dtype
    self.motion_extrapolation = motion_extrapolation
    ref = self._load(reference_data)

    time = np.around(np.asarray(ref["time"], np.float64), _TIME_PRECISION)
    robot = ref.get("robot")
    obj = ref.get("object")
    robot = None if robot is None else np.asarray(robot, np.float64)
    obj = None if obj is None else np.asarray(obj, np.float64)
    robot_shape = robot.shape if robot is not None else (0, 0)
    object_shape = obj.shape if obj is not None else (0, 0)
    self.robot_dim = robot_shape[1]
    self.object_dim = object_shape[1]
    self.robot_horizon = robot_shape[0]
    self.object_horizon = object_shape[0]
    self.horizon = max(robot_shape[0], object_shape[0])

    if self.horizon > 2:
      self.type = ReferenceType.TRACK
    elif self.horizon == 2:
      self.type = ReferenceType.RANDOM
    elif self.horizon == 1:
      self.type = ReferenceType.FIXED
    else:
      raise ValueError("reference values not per spec")

    robot_vel = ref.get("robot_vel")
    if robot_vel is None and robot is not None and self.horizon > 2:
      robot_vel = np.gradient(robot, time, axis=0)

    if self.type == ReferenceType.RANDOM:
      robot_init = ref.get("robot_init",
                           None if robot is None else robot.mean(0))
      object_init = ref.get("object_init",
                            None if obj is None else obj.mean(0))
    else:
      robot_init = ref.get("robot_init",
                           None if robot is None else robot[0])
      object_init = ref.get("object_init",
                            None if obj is None else obj[0])

    as64 = lambda x: None if x is None else np.asarray(x, np.float64)
    # host float64 copies; tensors in ``dtype`` are made per device
    self.time = time
    self.robot = robot
    self.robot_vel = as64(robot_vel)
    self.object = obj
    self.robot_init = as64(robot_init)
    self.object_init = as64(object_init)
    self._on_device: dict = {}

  @staticmethod
  def _load(reference_data) -> dict:
    """A clip from a path (``.npz``, or ``.pkl``/``.pickle``: pickle runs
    code from the file, so load only clips you trust) or a dict."""
    if isinstance(reference_data, str):
      if reference_data.endswith("npz"):
        with np.load(reference_data, allow_pickle=True) as f:
          ref = {k: f[k] for k in f.files}
      elif reference_data.endswith((".pkl", ".pickle")):
        with open(reference_data, "rb") as f:
          ref = pickle.load(f)
      else:
        raise TypeError(f"unknown reference file {reference_data}")
    elif isinstance(reference_data, dict):
      ref = dict(reference_data)
    else:
      raise TypeError("unknown reference type")
    assert "time" in ref, "missing key (time) in reference"
    return ref

  def _tensors(self, device) -> dict:
    """The clip's arrays as tensors in ``dtype`` on ``device`` (cached)."""
    device = torch.device(device)
    if device not in self._on_device:
      t = lambda x: (None if x is None else torch.as_tensor(
          x, device=device).to(self.dtype))
      self._on_device[device] = {
          "time": t(self.time), "robot": t(self.robot),
          "robot_vel": t(self.robot_vel), "object": t(self.object)}
    return self._on_device[device]

  # ---- queries ------------------------------------------------------------

  def get_init(self):
    """(robot_init, object_init) as float64 numpy, or None."""
    return self.robot_init, self.object_init

  def draw(self, batch: int, generator, device) -> dict:
    """RANDOM: a draw [B, dim] within each present part's range (rows 0
    and 1), from ``generator``."""
    arrs = self._tensors(device)
    # U(0, 1) in float64 where the generator lives, as envs/randomize.py
    # draws: a CPU generator gives the card and the CPU the same numbers
    where = generator.device if generator is not None else device
    out = {}
    for k in _PARTS:
      arr = arrs[k]
      if arr is not None:
        u = torch.rand((batch,) + tuple(arr.shape[1:]), generator=generator,
                       device=where, dtype=torch.float64)
        out[k] = arr[0] + (arr[1] - arr[0]) * u.to(device=device,
                                                   dtype=self.dtype)
    return out

  def get_reference(self, time: torch.Tensor, draws: dict | None = None):
    """The reference at each env's ``time`` [B]: a dict of robot,
    robot_vel and object, each [B, dim] or None. RANDOM references need
    the episode's ``draws`` (``draw``)."""
    arrs = self._tensors(time.device)
    B = time.shape[0]
    if self.type == ReferenceType.FIXED:
      return {k: (None if arrs[k] is None else arrs[k][0].expand(B, -1))
              for k in _PARTS}

    if self.type == ReferenceType.RANDOM:
      assert draws is not None, "a RANDOM reference needs the episode's draws"
      return {k: draws.get(k) for k in _PARTS}

    clip_t = arrs["time"]
    t = time.to(self.dtype)
    if self.motion_extrapolation:
      t = torch.minimum(t, clip_t[-1])
    idx = torch.clamp(
        torch.searchsorted(clip_t, t.contiguous(), right=True) - 1,
        0, self.horizon - 2)
    last = clip_t.shape[0] - 1
    t0 = clip_t[torch.clamp(idx, max=last)]
    t1 = clip_t[torch.clamp(idx + 1, max=last)]
    blend = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-12),
                        0.0, 1.0)[:, None]

    def lerp(arr, horizon):
      if arr is None:
        return None
      if horizon <= 1:
        return arr[0].expand(B, -1)
      # past the part's last row the index clamps, as the reference's
      # gather does
      n = arr.shape[0] - 1
      return ((1.0 - blend) * arr[torch.clamp(idx, max=n)]
              + blend * arr[torch.clamp(idx + 1, max=n)])

    return {"robot": lerp(arrs["robot"], self.robot_horizon),
            "robot_vel": lerp(arrs["robot_vel"], self.robot_horizon),
            "object": lerp(arrs["object"], self.object_horizon)}
