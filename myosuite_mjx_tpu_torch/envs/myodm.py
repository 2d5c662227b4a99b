"""MyoDM task ids on the port's tracking scenes.

Counterpart of ``myosuite_mjx_tpu/envs/myodm.py``, on the synthetic
tracking scenes of ``assets/fixtures.py`` (``track29``: MyoDM's 29 robot
dofs; ``track17`` for the CPU tests) with the object ``cubesmall``:

- ``<scene>CubesmallFixed-v0`` and ``Random-v0``: the reference's object
  tasks, a FIXED and a RANDOM reference (the reference's dicts, the robot
  as wide as the scene's robot dofs), 50 steps;
- ``<scene>CubesmallLift-v0`` and ``Inspect-v0``: TRACK clips
  ``<scene>_lift_clip.npz`` and ``<scene>_inspect_clip.npz``
  (``fixtures.track_clips``: ``lift`` carries ``robot_vel``, ``inspect``
  does not), 75 steps, as the reference's tracking ids.

The reference's clip table (its 97 clips and their names) is read from
the MyoSuite registry source and clip files, which are not in the
repository; the port registers the synthetic clips in their place.
"""
from __future__ import annotations

import numpy as np

from myosuite_mjx_tpu_torch.envs.registry import asset, register
from myosuite_mjx_tpu_torch.envs.track import TrackEnv

SCENES = {"track29": 29, "track17": 17}   # scene -> robot dofs
OBJECT = "cubesmall"
CLIPS = ("lift", "inspect")


def object_references(dof_robot: int) -> dict[str, dict]:
  """The reference's Fixed and Random references at a robot width."""
  return {
      "Fixed": {
          "time": np.array((0.0, 4.0)),
          "robot": np.zeros((1, dof_robot)),
          "robot_vel": np.zeros((1, dof_robot)),
          "object_init": np.array((-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, 0.0)),
          "object": np.reshape(
              np.array((0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 0.1)), (1, 7)),
      },
      "Random": {
          "time": np.array((0.0, 4.0)),
          "robot": np.zeros((2, dof_robot)),
          "robot_vel": np.zeros((2, dof_robot)),
          "object_init": np.array((0.0, 0.0, 0.1, 1.0, 0.0, 0.0, 0.0)),
          "object": np.array([
              [-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, -1.0],
              [0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 1.0],
          ]),
      },
  }


for _scene, _dof in SCENES.items():
  _obj = OBJECT.title()
  for _name, _ref in object_references(_dof).items():
    register(f"{_scene}{_obj}{_name}-v0", TrackEnv, max_episode_steps=50,
             kwargs=dict(model_path=asset(f"{_scene}.npz"),
                         object_name=OBJECT, reference=_ref,
                         normalize_act=True))
  for _clip in CLIPS:
    register(f"{_scene}{_obj}{_clip.title()}-v0", TrackEnv,
             max_episode_steps=75,
             kwargs=dict(model_path=asset(f"{_scene}.npz"),
                         object_name=OBJECT,
                         reference=asset(f"{_scene}_{_clip}_clip.npz"),
                         normalize_act=True))
