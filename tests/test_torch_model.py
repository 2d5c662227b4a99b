"""The port's model files: the checked-in fixtures, the npz round trip, the
enums, the rule that the port imports no jax, flax, mujoco or JAX package,
and the card as the entry points' default device."""
from __future__ import annotations

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import (FIXTURE_NPZ, HAND_TARGET, LEGS, NPZ, OBJECTS, SAR,
                          TASK_SCENES, TRACK, export_model, fixture_xml,
                          jax_model)
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.agents import reflex
from myosuite_mjx_tpu_torch.engine import api, collision
from myosuite_mjx_tpu_torch.engine import data as tdata
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.envs import (base, fatigue, gym_adapter,
                                         randomize, visual)
from myosuite_mjx_tpu_torch.parallel import mesh as pmesh
from myosuite_mjx_tpu_torch.tools import tune_reflex
from myosuite_mjx_tpu_torch.train import sac
from myosuite_mjx_tpu_torch.utils import curriculum, min_jerk
from myosuite_mjx_tpu_torch.utils import paths as path_utils

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
# top-level packages the port and chip_smoke.py must not import
BANNED_IMPORTS = ("jax", "flax", "mujoco", "myosuite_mjx_tpu")


def _assert_models_equal(a: tmodel.Model, b: tmodel.Model):
  assert sorted(a.field_names()) == sorted(b.field_names())
  for name in a.field_names():
    x, y = getattr(a, name), getattr(b, name)
    if name == "opt":
      for f in dataclasses.fields(x):
        np.testing.assert_array_equal(getattr(x, f.name), getattr(y, f.name))
    elif isinstance(x, dict) and name != "names":
      assert sorted(x) == sorted(y), name
      for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name}[{k}]")
    elif isinstance(x, np.ndarray):
      assert x.dtype == y.dtype, name
      np.testing.assert_array_equal(x, y, err_msg=name)
    else:
      assert x == y, name


@pytest.mark.parametrize("digits", [2, 5, "free", "prims", *(
    f"{obj}{d}" for obj in OBJECTS for d in (2, 5)), *LEGS, "plate",
    "hulls", *(f"{s}{d}" for s in TASK_SCENES for d in (2, 5)), *SAR,
    "osl54", *TRACK, "chain72"])
def test_checked_in_npz_equals_fresh_export(digits):
  fresh = export_model(fixture_xml(digits))
  with np.load(FIXTURE_NPZ[digits]) as z:
    assert sorted(z.files) == sorted(fresh)
    for k in z.files:
      np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)


@pytest.mark.parametrize("digits", [2, 5])
def test_from_reference_equals_load_npz(digits):
  ref = jax_model(digits)
  carried = tmodel.from_reference(ref)
  assert sorted(carried.field_names()) == sorted(
      f.name for f in dataclasses.fields(ref))
  _assert_models_equal(carried, tmodel.load_npz(NPZ[digits]))


def test_enums_and_disable_bits_match_the_reference():
  for name in ("JointType", "GeomType", "TrnType", "DynType", "GainType",
               "BiasType", "WrapType", "IntegratorType", "ConeType", "EqType",
               "SensorType"):
    ours = {k: int(v) for k, v in getattr(tmodel, name).__members__.items()}
    ref = {k: int(v) for k, v in getattr(jmodel, name).__members__.items()}
    assert ours == ref, name
  for name in dir(jmodel):
    if name.startswith("DSBL_"):
      assert getattr(tmodel, name) == getattr(jmodel, name), name


def test_load_npz_missing_path_raises():
  with pytest.raises(FileNotFoundError):
    tmodel.load_npz(os.path.join(REPO, "no_such_model.npz"))


def test_port_imports_no_jax_flax_or_mujoco():
  code = (
      "import pkgutil, sys, importlib\n"
      "import myosuite_mjx_tpu_torch as p\n"
      "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
      "for m in mods: importlib.import_module(m)\n"
      "bad = [k for k in ('jax', 'flax', 'mujoco') if k in sys.modules]\n"
      "assert len(mods) >= 15, mods\n"
      "assert not bad, bad\n")
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr


def _banned_imports(source: str, filename: str) -> list[str]:
  """Every import statement, at any depth, of a banned top-level package."""
  found = []
  for node in ast.walk(ast.parse(source, filename)):
    if isinstance(node, ast.Import):
      names = [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names = [node.module]
    else:
      continue
    found += [(node.lineno, name) for name in names
              if name.split(".")[0] in BANNED_IMPORTS]
  return [f"{filename}:{line} {name}" for line, name in sorted(found)]


def test_import_guard_sees_nested_imports():
  source = ("import myosuite_mjx_tpu_torch.ops\n"
            "from myosuite_mjx_tpu_torch import envs\n"
            "def f():\n"
            "  if True:\n"
            "    from myosuite_mjx_tpu.engine.model import load_model\n"
            "  import jax.numpy as jnp, numpy\n"
            "class C:\n"
            "  def g(self):\n"
            "    import mujoco\n")
  assert _banned_imports(source, "x.py") == [
      "x.py:5 myosuite_mjx_tpu.engine.model", "x.py:6 jax.numpy",
      "x.py:9 mujoco"]


def test_port_sources_import_no_jax_flax_mujoco_or_jax_package():
  pkg = os.path.join(REPO, "myosuite_mjx_tpu_torch")
  paths = sorted(os.path.join(root, f) for root, _, files in os.walk(pkg)
                 for f in files if f.endswith(".py"))
  paths.append(os.path.join(REPO, "chip_smoke.py"))
  assert len(paths) >= 20, paths
  # the walk reaches the utilities, the trace logger, the reflex
  # controller, the gym adapter, the encoders, the data-parallel learners
  # and the tools
  for sub in (("utils", "ik.py"), ("utils", "xml_utils.py"),
              ("utils", "examine_sim.py"), ("logger", "trace.py"),
              ("agents", "reflex.py"), ("envs", "gym_adapter.py"),
              ("envs", "visual.py"), ("parallel", "mesh.py"),
              ("tools", "tune_reflex.py"), ("tools", "scaling_efficiency.py"),
              ("tools", "train_zoo_baseline.py"),
              ("tools", "convergence_study.py")):
    assert os.path.join(pkg, *sub) in paths, sub
  found = []
  for path in paths:
    with open(path) as f:
      found += _banned_imports(f.read(), os.path.relpath(path, REPO))
  assert not found, found


@pytest.mark.parametrize("fn", [
    base.MyoEnv.reset, base.BatchedEnv.__init__, base.state_from_numpy,
    tmodel.DeviceModel.__init__, tdata.make_data, tdata.data_from_numpy,
    sac.SAC.__init__, randomize.sample_overlay, fatigue.init_state,
    api.Physics.__init__, api.load, path_utils.obs_layout,
    path_utils.compute_path_rewards, min_jerk.generate_joint_space_min_jerk,
    curriculum.init, reflex.expand_params, reflex.init_state,
    reflex.ReflexWalker.reset, reflex.ReflexWalker.rollout,
    tune_reflex.score, gym_adapter.GymEnv.__init__,
    gym_adapter.GymVecEnv.__init__, gym_adapter.gym_make,
    visual.FlaxCNNEncoder.__init__, visual.encoder_from_flax, visual.encoder,
    pmesh.init_distributed],
                         ids=lambda fn: fn.__qualname__)
def test_entry_points_default_to_the_card(fn):
  assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_hand23_has_myohand_width():
  m = tmodel.load_npz(NPZ[5])
  assert (m.nq, m.nv, m.nu, m.na) == (23, 23, 39, 39)
  names = sorted(m.names["joint"], key=m.names["joint"].get)
  assert names[:7] == ["pro_sup", "deviation", "flexion", "cmc_abduction",
                       "cmc_flexion", "mp_flexion", "ip_flexion"]
  for k in range(2, 6):
    i = 7 + 4 * (k - 2)
    assert names[i:i + 4] == [f"mcp{k}_flexion", f"mcp{k}_abduction",
                              f"pm{k}_flexion", f"md{k}_flexion"]
  tgt = np.asarray(HAND_TARGET)
  assert ((tgt >= m.jnt_range[:, 0]) & (tgt <= m.jnt_range[:, 1])).all()
  types = {(int(m.geom_type[p.g1]), int(m.geom_type[p.g2]))
           for p in collision.candidate_pairs(m)}
  assert types == {(0, 3), (3, 3)}           # plane-capsule, capsule-capsule
  # more slots than the top-k keeps: the cull is on the main path
  assert sum(collision._npoints(m, p) for p in collision.candidate_pairs(m)) > 24


@pytest.mark.parametrize("name", sorted(LEGS))
def test_legs_fixture_has_myoleg_names_and_width(name):
  m = tmodel.load_npz(FIXTURE_NPZ[name])
  knee = name.endswith("_knee")
  # one coupled slide a knee, or MyoLeg's seven coupled joints
  n_eq = 14 if knee else 2
  assert (m.nq, m.nv) == (23 + n_eq - 2, 22 + n_eq - 2)
  assert m.nu == m.na == (80 if name.startswith("legs80") else 16)
  for side in "lr":
    for j in ("hip_flexion", "hip_adduction", "hip_rotation", "knee_angle",
              "ankle_angle", "subtalar_angle", "mtp_angle"):
      m.name2id("joint", f"{j}_{side}")
    coupled = ([f"knee_angle_{side}_{j}" for j in (
        "translation1", "translation2", "rotation2", "rotation3",
        "beta_translation1", "beta_translation2", "beta_rotation1")]
               if knee else [f"knee_angle_translation_{side}"])
    for j in coupled:
      m.name2id("joint", j)
    for b in ("femur", "tibia", "talus", "calcn", "toes") + (
        ("patella",) if knee else ()):
      m.name2id("body", f"{b}_{side}")
  for b in ("pelvis", "torso"):
    m.name2id("body", b)
  # the knee couplings, four touch sensors, a 100 x 100 field, four keys
  assert m.neq == n_eq and list(m.eq_type) == [tmodel.EqType.JOINT] * n_eq
  assert sorted(m.names["sensor"]) == ["l_foot", "l_toes", "r_foot",
                                       "r_toes"]
  assert (m.nhfield, int(m.hfield_nrow[0]), int(m.hfield_ncol[0])) == (
      1, 100, 100)
  assert len(m.hfield_data) == 10000 and len(m.key_qpos) == 4
  assert m.nmocap == (1 if name.endswith("chasetag") else 0)
  # the equality rows and the hfield pairs build
  dm = tmodel.DeviceModel(m, torch.float64, "cpu")
  assert collision.collision_spec(dm) is not None


# scene -> (nv, nu, na) at the card's width and at the CPU tests' width
TASK_WIDTHS = {"baoding": ((35, 39, 39), (23, 21, 21)),
               "sar": ((29, 39, 39), (17, 21, 21)),
               "sar_c3": ((29, 39, 39), (17, 21, 21)),
               "relocate": ((33, 63, 63), (21, 45, 45)),
               "bimanual": ((50, 80, 63), (32, 56, 45))}


@pytest.mark.parametrize("scene", sorted(TASK_WIDTHS))
@pytest.mark.parametrize("digits", [5, 2])
def test_task_scenes_have_their_widths(scene, digits):
  """The hand and arm task scenes: nv, nu and na (the arm adds 24
  muscles over the shoulder and elbow to the hand's, MyoArm's 63 at five
  digits), nv within the SPD kernel's 64, and the collision layout
  builds (the relocate object's mesh pairs among it)."""
  key = (f"{scene}{digits}" if scene != "sar_c3" else f"sar{digits}_c3")
  m = tmodel.load_npz(FIXTURE_NPZ[key])
  assert (m.nv, m.nu, m.na) == TASK_WIDTHS[scene][digits == 2]
  assert m.nv <= 64
  spec = collision.collision_spec(tmodel.DeviceModel(m, torch.float64, "cpu"))
  meshes = [g for g in spec.groups if g.hull is not None]
  assert bool(meshes) == (scene == "relocate")
  if scene in ("relocate", "bimanual"):
    for j in ("elv_angle", "shoulder_elv", "shoulder_rot", "elbow_flexion"):
      m.name2id("joint", j)


@pytest.mark.parametrize("digits", [5, 2])
def test_arm_fixture_has_myoarm_width(digits):
  """arm27 (arm15 at two digits): the hand under three shoulder hinges
  and an elbow, 24 muscles over the shoulder and elbow before the hand's
  (MyoArm's 63 at five digits), the arm's joints first in qpos."""
  from myosuite_mjx_tpu_torch.assets.fixtures import arm_fixture_xml
  m = tmodel.from_reference(jmodel.load_model(arm_fixture_xml(digits),
                                              dtype=np.float64))
  nhand = 3 + 4 * digits
  assert (m.nv, m.nu, m.na) == (4 + nhand, 24 + (39 if digits == 5 else 21),
                                24 + (39 if digits == 5 else 21))
  joints = sorted(m.names["joint"], key=m.names["joint"].get)
  assert joints[:5] == ["elv_angle", "shoulder_elv", "shoulder_rot",
                        "elbow_flexion", "pro_sup"]
  actuators = sorted(m.names["actuator"], key=m.names["actuator"].get)
  assert actuators[0] == "DELT1" and actuators[24] == "FCR"
