"""MyoChallenge task ids on the port's fixture scenes.

Counterpart of ``myosuite_mjx_tpu/envs/myochallenge.py``: the die
reorientation ids ``<hand>DieReorientDemo-v0``, ``P1-v0`` and ``P2-v0``
with the reference's kwargs, on the die scene of ``assets/fixtures.py``
(``<hand>_die.npz``) in place of MyoSuite's myohand_die.xml. They take no
muscle-condition variants: the reference registers MyoChallenge after the
variant loop.
"""
from __future__ import annotations

import numpy as np

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
