"""MyoChallenge task ids on the port's fixture scenes.

Counterpart of ``myosuite_mjx_tpu/envs/myochallenge.py``, with the
reference's kwargs on the synthetic scenes of ``assets/fixtures.py`` in
place of MyoSuite's (not in the repository):

- ``<hand>BaodingP1-v1`` and ``P2-v1`` on the baoding hand
  (``<hand>_baoding.npz``) in place of myohand_baoding.xml;
- ``<hand>DieReorientDemo-v0``, ``P1-v0`` and ``P2-v0`` on the die scene
  (``<hand>_die.npz``) in place of myohand_die.xml;
- ``<arm>RelocateP1-v0`` and ``P2-v0`` on the relocate scene
  (``<arm>_relocate.npz``: ``arm27`` at MyoArm's width, ``arm15`` for the
  CPU tests) in place of myoarm_relocate.xml;
- ``<arm>Bimanual-v0`` on the bimanual scene (``<arm>_bimanual.npz``) in
  place of myoarm_bionic_bimanual.xml;
- ``<legs>ChaseTagP1-v0`` and ``P2-v0`` on the two-leg scene with its
  opponent (``<legs>_chasetag.npz``) in place of myolegs_chasetag.xml;
- ``osl54OslRunFixed-v0`` and ``osl54OslRunRandom-v0`` on the OSL scene
  (``osl54.npz``, at the OSL model's width: no narrower variant, since the
  task looks up its 54 muscles by name) in place of myoosl_runtrack.xml,
  with the synthetic gait table ``osl54_gait_cycle.csv`` in place of
  sample_gait_cycle.csv.

They take no muscle-condition variants: the reference registers
MyoChallenge after the variant loop.
"""
from __future__ import annotations

import numpy as np

from myosuite_mjx_tpu_torch.envs.baoding import BaodingEnv
from myosuite_mjx_tpu_torch.envs.bimanual import BimanualEnv
from myosuite_mjx_tpu_torch.envs.chasetag import ChaseTagEnv
from myosuite_mjx_tpu_torch.envs.registry import asset, register
from myosuite_mjx_tpu_torch.envs.relocate import RelocateEnv
from myosuite_mjx_tpu_torch.envs.reorient import ReorientEnv

HANDS = ("hand23", "hand11")
ARMS = ("arm27", "arm15")

BAODING = {
    "P1": dict(goal_time_period=(5, 5), goal_xrange=(0.025, 0.025),
               goal_yrange=(0.028, 0.028)),
    "P2": dict(goal_time_period=(4, 6), goal_xrange=(0.020, 0.030),
               goal_yrange=(0.022, 0.032), obj_size_range=(0.018, 0.024),
               obj_mass_range=(0.030, 0.300),
               obj_friction_change=(0.2, 0.001, 0.00002),
               task_choice="random"),
}

for _hand in HANDS:
  for _name, _kw in BAODING.items():
    register(f"{_hand}Baoding{_name}-v1", BaodingEnv, max_episode_steps=200,
             kwargs=dict(model_path=asset(f"{_hand}_baoding.npz"),
                         normalize_act=True, **_kw))

DIE_REORIENT = {
    "Demo": dict(pos_th=np.inf, goal_pos=(0, 0), goal_rot=(-0.785, 0.785)),
    "P1": dict(goal_pos=(-0.010, 0.010), goal_rot=(-1.57, 1.57)),
    "P2": dict(goal_pos=(-0.020, 0.020), goal_rot=(-3.14, 3.14)),
}

for _hand in HANDS:
  for _name, _kw in DIE_REORIENT.items():
    register(f"{_hand}DieReorient{_name}-v0", ReorientEnv,
             max_episode_steps=150,
             kwargs=dict(model_path=asset(f"{_hand}_die.npz"),
                         normalize_act=True, frame_skip=5, **_kw))

RELOCATE = {
    "P1": dict(target_xyz_range={"high": [0.2, -0.1, 0.9],
                                 "low": [0.0, -0.35, 0.9]},
               target_rxryrz_range={"high": [0.0, 0.0, 0.0],
                                    "low": [0.0, 0.0, 0.0]}),
    "P2": dict(qpos_noise_range=0.01,
               target_xyz_range={"high": [0.3, -0.1, 1.05],
                                 "low": [0.0, -0.45, 0.9]},
               target_rxryrz_range={"high": [0.2, 0.2, 0.2],
                                    "low": [-0.2, -0.2, -0.2]},
               obj_xyz_range={"high": [0.1, -0.15, 1.0],
                              "low": [-0.1, -0.35, 1.0]}),
}

for _arm in ARMS:
  for _name, _kw in RELOCATE.items():
    register(f"{_arm}Relocate{_name}-v0", RelocateEnv, max_episode_steps=150,
             kwargs=dict(model_path=asset(f"{_arm}_relocate.npz"),
                         normalize_act=True, frame_skip=5, pos_th=0.1,
                         rot_th=np.inf, **_kw))
  register(f"{_arm}Bimanual-v0", BimanualEnv, max_episode_steps=1000,
           kwargs=dict(model_path=asset(f"{_arm}_bimanual.npz"),
                       normalize_act=True, frame_skip=5,
                       obj_scale_change=[0.1, 0.05, 0.1],
                       obj_mass_change=(-0.050, 0.050),
                       obj_friction_change=(0.1, 0.001, 0.00002)))

CHASE_TAG = {
    "P1": dict(reset_type="init", terrain="FLAT", task_choice="CHASE"),
    "P2": dict(reset_type="random", terrain="random", task_choice="random",
               hills_range=(0.03, 0.23), rough_range=(0.05, 0.1),
               relief_range=(0.1, 0.3), chase_vel_range=(1.0, 1.0),
               random_vel_range=(-2, 2)),
}

for _legs in ("legs80", "legs16"):
  for _name, _kw in CHASE_TAG.items():
    register(f"{_legs}ChaseTag{_name}-v0", ChaseTagEnv,
             max_episode_steps=2000,
             kwargs=dict(model_path=asset(f"{_legs}_chasetag.npz"),
                         normalize_act=True, win_distance=0.5,
                         min_spawn_distance=2,
                         opponent_probabilities=(0.1, 0.45, 0.45), **_kw))

# ---- OSL RunTrack on the osl54 scene, its gait table as init_pose_path ----

from myosuite_mjx_tpu_torch.envs.run_track import RunTrackEnv  # noqa: E402

# the Random track's 24-patch difficulty ramp
_ramp = ((0.0,) * 5
         + tuple(x for i in range(8) for x in (0.03 * (i + 1), 0.0))[:-1]
         + (0.0,) * 4)

OSL_RUN = {
    "Fixed": dict(
        terrain="flat",
        hills_difficulties=(0.0, 0.1, 0.0, 0.5, 0.0, 0.8, 0.0, 1.0),
        rough_difficulties=(0.0, 0.1, 0.0, 0.15, 0.0, 0.2, 0.0, 0.3),
        stairs_difficulties=(0.0, 0.05, 0.0, 0.1, 0.0, 0.2, 0.0, 0.3),
        end_pos=-15, start_pos=14, max_episode_steps=1000),
    "Random": dict(
        terrain="random", hills_difficulties=_ramp,
        rough_difficulties=_ramp, stairs_difficulties=_ramp, end_pos=-45,
        start_pos=58, max_episode_steps=60000),
}

for _name, _kw in OSL_RUN.items():
  register(f"osl54OslRun{_name}-v0", RunTrackEnv,
           max_episode_steps=_kw["max_episode_steps"],
           kwargs=dict(model_path=asset("osl54.npz"), normalize_act=True,
                       reset_type="random", frame_skip=5,
                       init_pose_path=asset("osl54_gait_cycle.csv"), **_kw))
