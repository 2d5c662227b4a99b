"""The task registry: its mechanics against the JAX package's
``envs/registry.py``, and every registered id of the port.

The JAX registry module reads no asset; it is imported inside
``torch_parity.bare_envs_package()`` (the JAX ``envs`` package registers
asset-backed ids on import), so it starts empty there.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from torch_parity import bare_envs_package
from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.envs import myobase, registry
from myosuite_mjx_tpu_torch.envs.key_turn import KeyTurnEnv
from myosuite_mjx_tpu_torch.envs.obj_hold import ObjHoldEnv, ObjHoldRandomEnv
from myosuite_mjx_tpu_torch.envs.pen import PenTwirlFixedEnv, PenTwirlRandomEnv
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv
from myosuite_mjx_tpu_torch.envs.reach import ReachEnv
from myosuite_mjx_tpu_torch.envs.reorient import ReorientEnv
from myosuite_mjx_tpu_torch.envs.baoding import BaodingEnv
from myosuite_mjx_tpu_torch.envs.bimanual import BimanualEnv
from myosuite_mjx_tpu_torch.envs.chasetag import ChaseTagEnv
from myosuite_mjx_tpu_torch.envs.relocate import RelocateEnv
from myosuite_mjx_tpu_torch.envs.reorient_sar import (
    Geometries8Env, Geometries100Env, InDistributionEnv, OutOfDistributionEnv)
from myosuite_mjx_tpu_torch.envs.walk import (LegReachEnv, TerrainWalkEnv,
                                              WalkEnv)
from myosuite_mjx_tpu_torch.envs.run_track import RunTrackEnv
from myosuite_mjx_tpu_torch.envs.track import TrackEnv

BASE = {"model_path": "x.npz", "frame_skip": 10,
        "target_reach_range": {"THtip": ((0, 0, 0), (1, 1, 1)),
                               "IFtip": ((0, 0, 0), (1, 1, 1))},
        "weighted_reward_keys": {"reach": 1.0, "bonus": 4.0},
        "obs_keys": ["qpos", "qvel"]}
OVERLAYS = [
    {"muscle_condition": "sarcopenia"},
    {"weighted_reward_keys": {"bonus": 0.0, "penalty": 50}},
    {"target_reach_range": {"IFtip": ((1, 1, 1), (2, 2, 2))},
     "obs_keys": ["qpos"]},
    {"frame_skip": {"nested": 1}, "weighted_reward_keys": 3},
]


@pytest.fixture
def jax_registry():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import registry as jreg
    yield jreg


class _Task:
  """A stand-in env class that records its kwargs."""

  def __init__(self, **kwargs):
    self.kwargs = kwargs


@pytest.mark.parametrize("overlay", OVERLAYS, ids=range(len(OVERLAYS)))
def test_deep_update_matches_jax(jax_registry, overlay):
  base = copy.deepcopy(BASE)
  out = registry.deep_update(base, overlay)
  assert out == jax_registry.deep_update(BASE, overlay)
  assert base == BASE, "deep_update must not touch its input"
  # no aliasing into the overlay either
  if "target_reach_range" in overlay:
    assert out["target_reach_range"] is not overlay["target_reach_range"]


def test_register_env_variant_matches_jax(jax_registry, monkeypatch):
  monkeypatch.setattr(registry, "_REGISTRY", {})
  monkeypatch.setattr(jax_registry, "_REGISTRY", {})
  for reg in (registry, jax_registry):
    reg.register("taskA-v0", _Task, dict(BASE), max_episode_steps=75)
    reg.register("taskB-v0", _Task, dict(BASE, horizon=20))
    for i, ov in enumerate(OVERLAYS):
      assert reg.register_env_variant("taskA-v0", f"taskA{i}-v0",
                                      ov) == f"taskA{i}-v0"
  assert registry.registry_ids() == jax_registry.registry_ids()
  for env_id in registry.registry_ids():
    assert registry._REGISTRY[env_id] == jax_registry._REGISTRY[env_id]
  assert registry._REGISTRY["taskA-v0"][1]["horizon"] == 75
  assert registry._REGISTRY["taskB-v0"][1]["horizon"] == 20


def test_duplicate_ids_raise(monkeypatch):
  n = len(registry.registry_ids())
  with pytest.raises(ValueError, match="duplicate"):
    registry.register("hand11PoseFixed-v0", PoseEnv, {})
  with pytest.raises(ValueError, match="duplicate"):
    registry.register_env_variant("hand11PoseFixed-v0",
                                  "hand11SarcPoseFixed-v0", {})
  assert len(registry.registry_ids()) == n
  monkeypatch.setattr(registry, "_REGISTRY", {})
  registry.register("taskA-v0", _Task, {})
  with pytest.raises(ValueError, match="duplicate"):
    registry.register("taskA-v0", _Task, {"frame_skip": 5})
  assert registry._REGISTRY["taskA-v0"] == (_Task, {"horizon": 100})


def test_make_caches_and_overrides(monkeypatch):
  monkeypatch.setattr(registry, "_REGISTRY", {})
  monkeypatch.setattr(registry, "_env_cache", {})
  registry.register("taskA-v0", _Task, dict(BASE))
  a = registry.make("taskA-v0")
  assert registry.make("taskA-v0") is a
  assert registry.make("taskA-v0", cache=False) is not a
  b = registry.make("taskA-v0", frame_skip=5,
                    target_reach_range={"IFtip": ((2, 2, 2), (3, 3, 3))})
  assert b is not a and registry.make("taskA-v0") is a
  assert b.kwargs["frame_skip"] == 5 and a.kwargs["frame_skip"] == 10
  assert b.kwargs["target_reach_range"] == {
      "THtip": ((0, 0, 0), (1, 1, 1)), "IFtip": ((2, 2, 2), (3, 3, 3))}
  assert a.kwargs["horizon"] == 100
  with pytest.raises(KeyError):
    registry.make("nosuch-v0")


# task -> (class, horizon, frame_skip, hand23's nv)
TASKS = {
    "PoseFixed": (PoseEnv, 100, 10, 23),
    "ReachFixed": (ReachEnv, 100, 10, 23),
    "ReachRandom": (ReachEnv, 100, 10, 23),
    "KeyTurnFixed": (KeyTurnEnv, 200, 10, 24),
    "KeyTurnRandom": (KeyTurnEnv, 200, 10, 24),
    "ObjHoldFixed": (ObjHoldEnv, 75, 10, 29),
    "ObjHoldRandom": (ObjHoldRandomEnv, 75, 10, 29),
    "PenTwirlFixed": (PenTwirlFixedEnv, 50, 5, 29),
    "PenTwirlRandom": (PenTwirlRandomEnv, 50, 5, 29),
    "DieReorientDemo": (ReorientEnv, 150, 5, 29),
    "DieReorientP1": (ReorientEnv, 150, 5, 29),
    "DieReorientP2": (ReorientEnv, 150, 5, 29),
    "BaodingP1": (BaodingEnv, 200, 10, 35),
    "BaodingP2": (BaodingEnv, 200, 10, 35),
    "Reorient8": (Geometries8Env, 50, 5, 29),
    "Reorient100": (Geometries100Env, 50, 5, 29),
    "ReorientID": (InDistributionEnv, 50, 5, 29),
    "ReorientOOD": (OutOfDistributionEnv, 50, 5, 29),
}
# the MyoChallenge hand tasks: no condition variants
CHALLENGE = ("Die", "Baoding")
# the arm tasks -> (class, horizon, frame_skip, arm27's nv); on arm27 and
# arm15
ARM_TASKS = {
    "RelocateP1": (RelocateEnv, 150, 5, 33),
    "RelocateP2": (RelocateEnv, 150, 5, 33),
    "Bimanual": (BimanualEnv, 1000, 5, 50),
}


# the leg tasks -> (class, horizon, frame_skip, nv); on legs80 and legs16
LEG_TASKS = {
    "StandRandom": (LegReachEnv, 150, 10, 22),
    "Walk": (WalkEnv, 1000, 10, 22),
    "RoughTerrainWalk": (TerrainWalkEnv, 1000, 10, 22),
    "HillyTerrainWalk": (TerrainWalkEnv, 1000, 10, 22),
    "StairTerrainWalk": (TerrainWalkEnv, 1000, 10, 22),
    "ChaseTagP1": (ChaseTagEnv, 2000, 10, 22),
    "ChaseTagP2": (ChaseTagEnv, 2000, 10, 22),
}
# the OSL RunTrack tasks -> (class, horizon, frame_skip, nv); on osl54
OSL_TASKS = {
    "OslRunFixed": (RunTrackEnv, 1000, 5, 25),
    "OslRunRandom": (RunTrackEnv, 60000, 5, 25),
}
# the MyoDM tasks -> (class, horizon, frame_skip, track29's nv); on
# track29 and track17
TRACK_TASKS = {
    "CubesmallFixed": (TrackEnv, 50, 10, 35),
    "CubesmallRandom": (TrackEnv, 50, 10, 35),
    "CubesmallLift": (TrackEnv, 75, 10, 35),
    "CubesmallInspect": (TrackEnv, 75, 10, 35),
}
ALL_TASKS = {**TASKS, **LEG_TASKS, **ARM_TASKS, **OSL_TASKS, **TRACK_TASKS}


def _task(env_id: str) -> str:
  """The task of an id: hand23SarcObjHoldFixed-v0 -> ObjHoldFixed,
  arm27RelocateP1-v0 -> RelocateP1, track29CubesmallLift-v0 ->
  CubesmallLift."""
  prefix = (5 if env_id.startswith(("arm", "osl"))
            else 7 if env_id.startswith("track") else 6)
  task = env_id[prefix:-3]
  return task[4:] if task.startswith(("Sarc", "Fati")) else task


def test_the_registered_ids():
  ids = envs.registry_ids()
  bases = [f"{h}{t}-v0" for h in ("hand11", "hand23") for t in TASKS
           if not t.startswith(CHALLENGE)]
  want = {f"{b[:6]}{c}{b[6:]}" for b in bases for c in ("", "Sarc", "Fati")}
  # the die reorientation and baoding ids take no condition variants
  # (MyoChallenge); baoding is v1, as the reference's
  want |= {f"{h}{t}-v{1 if t.startswith('Baoding') else 0}"
           for h in ("hand11", "hand23") for t in TASKS
           if t.startswith(CHALLENGE)}
  # the arm ids (MyoChallenge), no variants
  want |= {f"{a}{t}-v0" for a in ("arm15", "arm27") for t in ARM_TASKS}
  # the leg ids: Sarc and Fati variants of the stand and walk tasks, as the
  # reference registers them; chase-tag (MyoChallenge) without
  legs = [f"{g}{t}-v0" for g in ("legs16", "legs80") for t in LEG_TASKS
          if not t.startswith("Chase")]
  want |= {f"{b[:6]}{c}{b[6:]}" for b in legs for c in ("", "Sarc", "Fati")}
  want |= {f"{g}{t}-v0" for g in ("legs16", "legs80") for t in LEG_TASKS
           if t.startswith("Chase")}
  # the OSL RunTrack ids (MyoChallenge) and the MyoDM ids, no variants
  want |= {f"osl54{t}-v0" for t in OSL_TASKS}
  want |= {f"{s}{t}-v0" for s in ("track17", "track29") for t in TRACK_TASKS}
  assert set(ids) == want and len(ids) == (18 + 36 + 6 + 30 + 4 + 24 + 4 + 6
                                           + 2 + 8)
  assert not [i for i in ids if "Reaf" in i]
  assert registry.asset("hand23.npz").endswith(
      "myosuite_mjx_tpu_torch/assets/hand23.npz")
  for i in ids:
    cls, kw = registry._REGISTRY[i]
    assert cls is ALL_TASKS[_task(i)][0], i
    assert kw["horizon"] == ALL_TASKS[_task(i)][1], i
    assert kw.get("frame_skip", 10) == ALL_TASKS[_task(i)][2], i
    if "Sarc" in i or "Fati" in i:
      assert kw["muscle_condition"] in ("sarcopenia", "fatigue"), i
  for name in ("make", "register", "register_env_variant", "registry_ids",
               "MyoEnv", "BatchedEnv", "EnvState"):
    assert hasattr(envs, name), name


def test_the_object_ids_take_the_references_kwargs():
  _, kw = registry._REGISTRY["hand23KeyTurnRandom-v0"]
  assert kw["key_init_range"] == (-np.pi / 2, np.pi / 2)
  assert kw["goal_th"] == 2 * np.pi
  assert "key_init_range" not in registry._REGISTRY[
      "hand23KeyTurnFixed-v0"][1]
  for name, want in (("Demo", dict(pos_th=np.inf, goal_pos=(0, 0),
                                   goal_rot=(-0.785, 0.785))),
                     ("P1", dict(goal_pos=(-0.010, 0.010),
                                 goal_rot=(-1.57, 1.57))),
                     ("P2", dict(goal_pos=(-0.020, 0.020),
                                 goal_rot=(-3.14, 3.14)))):
    _, kw = registry._REGISTRY[f"hand11DieReorient{name}-v0"]
    for k, v in want.items():
      assert kw[k] == v, (name, k)
    assert kw["model_path"].endswith("hand11_die.npz")


def test_reach_targets_and_thresholds():
  _, kw = registry._REGISTRY["hand23ReachFixed-v0"]
  _, kr = registry._REGISTRY["hand23ReachRandom-v0"]
  assert (kw["far_th"], kr["far_th"]) == (0.044, 0.034)
  for s, (lo, hi) in kw["target_reach_range"].items():
    assert lo == hi == tuple(myobase.TIPS_AT_INIT[s])
    rlo, rhi = kr["target_reach_range"][s]
    np.testing.assert_allclose(np.subtract(rhi, rlo),
                               2 * np.asarray(myobase.RANDOM_HALF_WIDTH),
                               atol=1e-12)
    np.testing.assert_allclose(np.add(rhi, rlo) / 2, lo, atol=1e-12)


@pytest.mark.parametrize("env_id", [i for i in sorted(
    registry._REGISTRY) if i.startswith(("hand11", "hand23"))])
def test_every_id_constructs_and_hand11_ids_step(env_id):
  env = envs.make(env_id, cache=False, dtype=torch.float64)
  assert env.horizon == TASKS[_task(env_id)][1]
  assert env.frame_skip == TASKS[_task(env_id)][2]
  if env_id.startswith("hand23"):
    assert env.model.nv == TASKS[_task(env_id)][3]
    return
  g = torch.Generator().manual_seed(0)
  st = env.reset(2, "cpu", g)
  for _ in range(2):
    st = env.autoreset_step(st, torch.full((2, env.action_dim), 0.5,
                                           dtype=torch.float64), g)
  assert st.obs.shape[0] == 2 and bool(torch.isfinite(st.obs).all())
  if "Fati" in env_id:
    assert "fatigue" in st.aux


def test_the_leg_ids_take_the_references_kwargs():
  _, kw = registry._REGISTRY["legs80StandRandom-v0"]
  assert kw["joint_random_range"] == (-0.2, 0.2) and kw["far_th"] == 0.44
  assert kw["target_reach_range"] == {
      "pelvis": ((-0.05, -0.05, 0), (0.05, 0.05, 0))}
  for tid, terrain, variant in (("Walk", None, None),
                                ("RoughTerrainWalk", "rough", None),
                                ("HillyTerrainWalk", "hilly", "fixed"),
                                ("StairTerrainWalk", "stairs", "fixed")):
    _, kw = registry._REGISTRY[f"legs80{tid}-v0"]
    assert (kw["min_height"], kw["max_rot"], kw["hip_period"]) == (
        0.8, 0.8, 100)
    assert kw["reset_type"] == "random" and kw["target_y_vel"] == 1.2
    assert kw.get("terrain") == terrain and kw.get("variant") == variant
    assert kw["model_path"].endswith("legs80.npz")
  _, p1 = registry._REGISTRY["legs16ChaseTagP1-v0"]
  _, p2 = registry._REGISTRY["legs16ChaseTagP2-v0"]
  assert (p1["terrain"], p1["task_choice"]) == ("FLAT", "CHASE")
  assert (p2["terrain"], p2["task_choice"]) == ("random", "random")
  assert (p2["hills_range"], p2["rough_range"], p2["relief_range"]) == (
      (0.03, 0.23), (0.05, 0.1), (0.1, 0.3))
  assert p2["random_vel_range"] == (-2, 2)
  assert p1["model_path"].endswith("legs16_chasetag.npz")


@pytest.mark.parametrize("env_id", [i for i in sorted(
    registry._REGISTRY) if i.startswith(("legs16", "legs80"))])
def test_every_leg_id_constructs_and_legs16_ids_step(env_id):
  env = envs.make(env_id, cache=False, dtype=torch.float64)
  assert env.horizon == LEG_TASKS[_task(env_id)][1]
  assert env.model.nv == 22
  assert env.action_dim == (80 if env_id.startswith("legs80") else 16)
  if env_id.startswith("legs80"):
    return
  g = torch.Generator().manual_seed(0)
  st = env.reset(2, "cpu", g)
  for _ in range(2):
    st = env.autoreset_step(st, torch.full((2, env.action_dim), 0.5,
                                           dtype=torch.float64), g)
  assert st.obs.shape[0] == 2 and bool(torch.isfinite(st.obs).all())
  if "Fati" in env_id:
    assert "fatigue" in st.aux


def test_the_new_hand_and_arm_ids_take_the_references_kwargs():
  _, p1 = registry._REGISTRY["hand23BaodingP1-v1"]
  _, p2 = registry._REGISTRY["hand23BaodingP2-v1"]
  assert p1["goal_time_period"] == (5, 5) and "task_choice" not in p1
  assert (p2["goal_time_period"], p2["goal_xrange"], p2["goal_yrange"]) == (
      (4, 6), (0.020, 0.030), (0.022, 0.032))
  assert (p2["obj_size_range"], p2["obj_mass_range"]) == ((0.018, 0.024),
                                                          (0.030, 0.300))
  assert p2["obj_friction_change"] == (0.2, 0.001, 0.00002)
  assert p2["task_choice"] == "random"
  assert p1["model_path"].endswith("hand23_baoding.npz")
  _, r1 = registry._REGISTRY["arm15RelocateP1-v0"]
  _, r2 = registry._REGISTRY["arm27RelocateP2-v0"]
  assert (r1["pos_th"], r1["rot_th"]) == (0.1, np.inf)
  assert r1["target_xyz_range"] == {"high": [0.2, -0.1, 0.9],
                                    "low": [0.0, -0.35, 0.9]}
  assert r2["qpos_noise_range"] == 0.01
  assert r2["obj_xyz_range"] == {"high": [0.1, -0.15, 1.0],
                                 "low": [-0.1, -0.35, 1.0]}
  assert r2["model_path"].endswith("arm27_relocate.npz")
  _, bm = registry._REGISTRY["arm27Bimanual-v0"]
  assert bm["obj_mass_change"] == (-0.050, 0.050)
  assert bm["obj_friction_change"] == (0.1, 0.001, 0.00002)
  for name, scene in (("8", "sar"), ("100", "sar"), ("ID", "sar_c3"),
                      ("OOD", "sar_c3")):
    _, kw = registry._REGISTRY[f"hand11Reorient{name}-v0"]
    assert kw["model_path"].endswith(f"hand11_{scene}.npz")
    assert kw["frame_skip"] == 5 and kw["horizon"] == 50


@pytest.mark.parametrize("env_id", [i for i in sorted(
    registry._REGISTRY) if i.startswith(("arm15", "arm27"))])
def test_every_arm_id_constructs_and_arm15_ids_step(env_id):
  env = envs.make(env_id, cache=False, dtype=torch.float64)
  cls, horizon, frame_skip, nv27 = ARM_TASKS[_task(env_id)]
  assert type(env) is cls and env.horizon == horizon
  assert env.frame_skip == frame_skip
  if env_id.startswith("arm27"):
    assert env.model.nv == nv27
    return
  g = torch.Generator().manual_seed(0)
  st = env.reset(2, "cpu", g)
  for _ in range(2):
    st = env.autoreset_step(st, torch.full((2, env.action_dim), 0.5,
                                           dtype=torch.float64), g)
  assert st.obs.shape[0] == 2 and bool(torch.isfinite(st.obs).all())


def test_the_osl_and_track_ids_take_the_references_kwargs():
  ramp = ((0.0,) * 5 + (0.03, 0.0, 0.06, 0.0, 0.09, 0.0, 0.12, 0.0, 0.15,
                        0.0, 0.18, 0.0, 0.21, 0.0, 0.24) + (0.0,) * 4)
  _, fx = registry._REGISTRY["osl54OslRunFixed-v0"]
  _, rd = registry._REGISTRY["osl54OslRunRandom-v0"]
  for kw in (fx, rd):
    assert (kw["reset_type"], kw["frame_skip"], kw["normalize_act"]) == (
        "random", 5, True)
    assert kw["model_path"].endswith("osl54.npz")
    assert kw["init_pose_path"].endswith("osl54_gait_cycle.csv")
  assert (fx["terrain"], fx["end_pos"], fx["start_pos"]) == ("flat", -15, 14)
  assert fx["hills_difficulties"] == (0.0, 0.1, 0.0, 0.5, 0.0, 0.8, 0.0, 1.0)
  assert fx["rough_difficulties"] == (0.0, 0.1, 0.0, 0.15, 0.0, 0.2, 0.0,
                                      0.3)
  assert fx["stairs_difficulties"] == (0.0, 0.05, 0.0, 0.1, 0.0, 0.2, 0.0,
                                       0.3)
  assert (rd["terrain"], rd["end_pos"], rd["start_pos"]) == ("random", -45,
                                                              58)
  assert len(rd["hills_difficulties"]) == 24
  for k in ("hills_difficulties", "rough_difficulties",
            "stairs_difficulties"):
    np.testing.assert_allclose(rd[k], ramp, atol=1e-15)
  for scene, dof in (("track29", 29), ("track17", 17)):
    _, f = registry._REGISTRY[f"{scene}CubesmallFixed-v0"]
    _, r = registry._REGISTRY[f"{scene}CubesmallRandom-v0"]
    assert f["object_name"] == r["object_name"] == "cubesmall"
    assert f["model_path"].endswith(f"{scene}.npz")
    np.testing.assert_array_equal(f["reference"]["time"], (0.0, 4.0))
    assert f["reference"]["robot"].shape == (1, dof)
    np.testing.assert_array_equal(f["reference"]["object_init"],
                                  (-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, 0.0))
    np.testing.assert_array_equal(f["reference"]["object"],
                                  [(0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 0.1)])
    assert r["reference"]["robot_vel"].shape == (2, dof)
    np.testing.assert_array_equal(r["reference"]["object"], [
        (-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, -1.0),
        (0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 1.0)])
    np.testing.assert_array_equal(r["reference"]["object_init"],
                                  (0.0, 0.0, 0.1, 1.0, 0.0, 0.0, 0.0))
    for clip in ("Lift", "Inspect"):
      _, kw = registry._REGISTRY[f"{scene}Cubesmall{clip}-v0"]
      assert kw["reference"].endswith(f"{scene}_{clip.lower()}_clip.npz")
      assert kw["normalize_act"] is True


@pytest.mark.parametrize("env_id", [i for i in sorted(
    registry._REGISTRY) if i.startswith(("osl54", "track17", "track29"))])
def test_every_osl_and_track_id_constructs_and_steps(env_id):
  env = envs.make(env_id, cache=False, dtype=torch.float64)
  cls, horizon, frame_skip, nv = ALL_TASKS[_task(env_id)]
  assert type(env) is cls and env.horizon == horizon
  assert env.frame_skip == frame_skip
  if env_id.startswith("osl54"):
    assert env.model.nv == nv and env.action_dim == 54
  elif env_id.startswith("track29"):
    assert env.model.nv == nv and env.ref.robot_dim == 29
    return
  else:
    assert env.ref.robot_dim == 17
  g = torch.Generator().manual_seed(0)
  st = env.reset(2, "cpu", g)
  for _ in range(2):
    st = env.autoreset_step(st, torch.full((2, env.action_dim), 0.5,
                                           dtype=torch.float64), g)
  assert st.obs.shape[0] == 2 and bool(torch.isfinite(st.obs).all())
