"""MyoChallenge task ids on the port's fixture scenes.

Counterpart of ``myosuite_mjx_tpu/envs/myochallenge.py``: the die
reorientation ids ``<hand>DieReorientDemo-v0``, ``P1-v0`` and ``P2-v0``
with the reference's kwargs, on the die scene of ``assets/fixtures.py``
(``<hand>_die.npz``) in place of MyoSuite's myohand_die.xml; and the
chase-tag ids ``<legs>ChaseTagP1-v0`` and ``P2-v0`` with the kwargs of
myoChallengeChaseTagP1/P2-v0, on the two-leg scene with its opponent
(``<legs>_chasetag.npz``) in place of myolegs_chasetag.xml. They take no
muscle-condition variants: the reference registers MyoChallenge after the
variant loop.
"""
from __future__ import annotations

import numpy as np

from myosuite_mjx_tpu_torch.envs.chasetag import ChaseTagEnv
from myosuite_mjx_tpu_torch.envs.registry import asset, register
from myosuite_mjx_tpu_torch.envs.reorient import ReorientEnv

DIE_REORIENT = {
    "Demo": dict(pos_th=np.inf, goal_pos=(0, 0), goal_rot=(-0.785, 0.785)),
    "P1": dict(goal_pos=(-0.010, 0.010), goal_rot=(-1.57, 1.57)),
    "P2": dict(goal_pos=(-0.020, 0.020), goal_rot=(-3.14, 3.14)),
}

for _hand in ("hand23", "hand11"):
  for _name, _kw in DIE_REORIENT.items():
    register(f"{_hand}DieReorient{_name}-v0", ReorientEnv,
             max_episode_steps=150,
             kwargs=dict(model_path=asset(f"{_hand}_die.npz"),
                         normalize_act=True, frame_skip=5, **_kw))

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
