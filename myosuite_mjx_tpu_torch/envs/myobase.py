"""Task ids on the port's fixture scenes.

Counterpart of ``myosuite_mjx_tpu/envs/myobase.py``. MyoSuite's own ids
(``myoHandPoseFixed-v0`` and the rest) point into the MyoSuite asset tree,
which this repository does not hold; they wait for it. Until then the ids
below run the same task classes on the synthetic hands of
``assets/fixtures.py``: ``hand23`` (MyoHand's 23 dofs and 39 muscles) and
``hand11`` (a thumb and an index finger, for the CPU tests).

- ``<hand>PoseFixed-v0``: ``PoseEnv`` with myoHandPoseFixed-v0's task
  (``pose.HAND_POSE_FIXED``; hand11 takes its first 11 joint targets).
- ``<hand>ReachFixed-v0`` / ``<hand>ReachRandom-v0``: ``ReachEnv`` on the
  fixture's fingertip sites (THtip ... LFtip, five on hand23, THtip and
  IFtip on hand11). MyoHand's target boxes are in its own world frame and
  do not fit the fixture, so the targets come from the fixture itself:
  ``TIPS_AT_INIT`` are the tip positions at the init pose (qpos0: no
  actuator has a joint transmission, so the init pose is qpos0), computed
  with the port's kinematics in float64 and rounded to 0.01 mm
  (``tests/test_torch_registry.py`` recomputes them). Fixed: those points
  (a point box, as MyoHand's Fixed boxes are). Random: a box of +-3 cm in
  x and +-2 cm in y and z around each (MyoHand's Random boxes span 2-8 cm
  per axis). ``far_th``: MyoHand's 0.044 (Fixed) and 0.034 (Random) scaled
  by the fixture's size relative to MyoHand, which is 1: the fixture's
  phalanges have an adult hand's lengths, as MyoHand's do.
- ``<hand>KeyTurnFixed-v0`` / ``KeyTurnRandom-v0``,
  ``<hand>ObjHoldFixed-v0`` / ``ObjHoldRandom-v0`` and
  ``<hand>PenTwirlFixed-v0`` / ``PenTwirlRandom-v0``: the reference's task
  classes and kwargs (horizons 200, 75 and 50, frame_skip 5 for the pen,
  the Random key's start range and goal) on the hand-object scenes of
  ``assets/fixtures.py`` (``<hand>_key.npz``, ``_hold``, ``_pen``), in
  place of MyoSuite's myohand_keyturn/hold/pen.xml.
- ``<hand>Reorient8-v0``, ``Reorient100-v0``, ``ReorientID-v0`` and
  ``ReorientOOD-v0``: the SAR reorientation family (max_episode_steps 50,
  frame_skip 5) on the SAR hand (``<hand>_sar.npz``, condim 4, for 8 and
  100; ``<hand>_sar_c3.npz``, condim 3, for ID and OOD), in place of
  MyoSuite's myohand_sar.xml.
- Variants: ``<hand>Sarc...`` (sarcopenia) and ``<hand>Fati...`` (fatigue)
  of every base id, by the reference's rule (``register_env_variant`` with
  ``muscle_condition``), e.g. ``hand23SarcPoseFixed-v0``. There are no
  ``Reaf`` (reafferentation) variants: no fixture has the EIP and EPL
  muscles that condition reroutes.
- The leg ids, on the two-leg scene of ``assets/fixtures.py`` in place of
  MyoSuite's myolegs.xml (``legs80``: 80 muscles, MyoLeg's width;
  ``legs16`` for the CPU tests), with the kwargs of the reference's
  myoLegStandRandom-v0, myoLegWalk-v0 and the rough, hilly and stair
  terrain walks: ``<legs>StandRandom-v0``, ``<legs>Walk-v0``,
  ``<legs>RoughTerrainWalk-v0``, ``<legs>HillyTerrainWalk-v0`` and
  ``<legs>StairTerrainWalk-v0``, each with its ``Sarc`` and ``Fati``
  variants (``legs80SarcWalk-v0``), as the reference registers them.
"""
from __future__ import annotations

import numpy as np

from myosuite_mjx_tpu_torch.envs.key_turn import KeyTurnEnv
from myosuite_mjx_tpu_torch.envs.obj_hold import ObjHoldEnv, ObjHoldRandomEnv
from myosuite_mjx_tpu_torch.envs.pen import PenTwirlFixedEnv, PenTwirlRandomEnv
from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
from myosuite_mjx_tpu_torch.envs.reach import ReachEnv
from myosuite_mjx_tpu_torch.envs.registry import (asset, register,
                                                  register_env_variant)
from myosuite_mjx_tpu_torch.envs.reorient_sar import (Geometries8Env,
                                                      Geometries100Env,
                                                      InDistributionEnv,
                                                      OutOfDistributionEnv)
from myosuite_mjx_tpu_torch.envs.walk import (LegReachEnv, TerrainWalkEnv,
                                              WalkEnv)

HANDS = {"hand23": ("hand23.npz", ("THtip", "IFtip", "MFtip", "RFtip",
                                   "LFtip")),
         "hand11": ("hand11.npz", ("THtip", "IFtip"))}
# fingertip sites at the init pose (qpos0), the same on both hands
TIPS_AT_INIT = {
    "THtip": (0.20386, 0.07308, 0.03228),
    "IFtip": (0.286, 0.0185, 0.052),
    "MFtip": (0.292, -0.0012, 0.052),
    "RFtip": (0.2865, -0.0207, 0.052),
    "LFtip": (0.273, -0.0398, 0.052),
}
RANDOM_HALF_WIDTH = (0.03, 0.02, 0.02)


def _box(site: str, half: tuple) -> tuple:
  c = TIPS_AT_INIT[site]
  return (tuple(round(x - h, 5) for x, h in zip(c, half)),
          tuple(round(x + h, 5) for x, h in zip(c, half)))


BASE_IDS = []
for _hand, (_npz, _tips) in HANDS.items():
  _pose = dict(HAND_POSE_FIXED, model_path=asset(_npz))
  _pose["target_jnt_value"] = _pose["target_jnt_value"][:3 + 4 * len(_tips)]
  register(f"{_hand}PoseFixed-v0", PoseEnv, max_episode_steps=100,
           kwargs=_pose)
  register(f"{_hand}ReachFixed-v0", ReachEnv, max_episode_steps=100,
           kwargs=dict(model_path=asset(_npz), normalize_act=True,
                       target_reach_range={s: _box(s, (0.0, 0.0, 0.0))
                                           for s in _tips},
                       far_th=0.044))
  register(f"{_hand}ReachRandom-v0", ReachEnv, max_episode_steps=100,
           kwargs=dict(model_path=asset(_npz), normalize_act=True,
                       target_reach_range={s: _box(s, RANDOM_HALF_WIDTH)
                                           for s in _tips},
                       far_th=0.034))
  BASE_IDS += [f"{_hand}{task}-v0"
               for task in ("PoseFixed", "ReachFixed", "ReachRandom")]
  for _task, _cls, _obj, _steps, _kw in (
      ("KeyTurnFixed", KeyTurnEnv, "key", 200, {}),
      ("KeyTurnRandom", KeyTurnEnv, "key", 200,
       dict(key_init_range=(-np.pi / 2, np.pi / 2), goal_th=2 * np.pi)),
      ("ObjHoldFixed", ObjHoldEnv, "hold", 75, {}),
      ("ObjHoldRandom", ObjHoldRandomEnv, "hold", 75, {}),
      ("PenTwirlFixed", PenTwirlFixedEnv, "pen", 50, dict(frame_skip=5)),
      ("PenTwirlRandom", PenTwirlRandomEnv, "pen", 50, dict(frame_skip=5))):
    register(f"{_hand}{_task}-v0", _cls, max_episode_steps=_steps,
             kwargs=dict(model_path=asset(f"{_hand}_{_obj}.npz"),
                         normalize_act=True, **_kw))
    BASE_IDS.append(f"{_hand}{_task}-v0")
  for _task, _cls, _scene in (("8", Geometries8Env, "sar"),
                              ("100", Geometries100Env, "sar"),
                              ("ID", InDistributionEnv, "sar_c3"),
                              ("OOD", OutOfDistributionEnv, "sar_c3")):
    register(f"{_hand}Reorient{_task}-v0", _cls, max_episode_steps=50,
             kwargs=dict(model_path=asset(f"{_hand}_{_scene}.npz"),
                         normalize_act=True, frame_skip=5))
    BASE_IDS.append(f"{_hand}Reorient{_task}-v0")

# muscle-condition variants (the reference's rule)
for _id in BASE_IDS:
  _hand, _task = _id[:6], _id[6:]
  register_env_variant(_id, f"{_hand}Sarc{_task}",
                       {"muscle_condition": "sarcopenia"})
  register_env_variant(_id, f"{_hand}Fati{_task}",
                       {"muscle_condition": "fatigue"})

# ---- the legs ---------------------------------------------------------------

LEGS = ("legs80", "legs16")
_WALK = dict(normalize_act=True, min_height=0.8, max_rot=0.8, hip_period=100,
             reset_type="random", target_x_vel=0.0, target_y_vel=1.2)
LEG_IDS = []
for _legs in LEGS:
  _path = asset(f"{_legs}.npz")
  register(f"{_legs}StandRandom-v0", LegReachEnv, max_episode_steps=150,
           kwargs=dict(model_path=_path, joint_random_range=(-0.2, 0.2),
                       target_reach_range={
                           "pelvis": ((-0.05, -0.05, 0), (0.05, 0.05, 0))},
                       normalize_act=True, far_th=0.44))
  register(f"{_legs}Walk-v0", WalkEnv, max_episode_steps=1000,
           kwargs=dict(model_path=_path, **_WALK))
  LEG_IDS += [f"{_legs}StandRandom-v0", f"{_legs}Walk-v0"]
  for _name, _terrain, _variant in (("Rough", "rough", None),
                                    ("Hilly", "hilly", "fixed"),
                                    ("Stair", "stairs", "fixed")):
    register(f"{_legs}{_name}TerrainWalk-v0", TerrainWalkEnv,
             max_episode_steps=1000,
             kwargs=dict(model_path=_path, terrain=_terrain,
                         variant=_variant, **_WALK))
    LEG_IDS.append(f"{_legs}{_name}TerrainWalk-v0")

for _id in LEG_IDS:
  _legs, _task = _id[:6], _id[6:]
  register_env_variant(_id, f"{_legs}Sarc{_task}",
                       {"muscle_condition": "sarcopenia"})
  register_env_variant(_id, f"{_legs}Fati{_task}",
                       {"muscle_condition": "fatigue"})
