"""Shared helpers for the PyTorch port's parity tests, and the fixture export.

Each test makes its inputs with numpy from a seed, feeds them to the JAX
reference (``myosuite_mjx_tpu``, float64 on the CPU) and to the port
(``myosuite_mjx_tpu_torch``), and compares field by field.

This module also bridges the two packages outside the tests: the port's
``.npz`` models are compiled from MJCF with the JAX package's host compiler
(``myosuite_mjx_tpu.engine.model.load_model``: numpy and mujoco, no jax),
since the GPU machine has no ``mujoco``. After editing
``myosuite_mjx_tpu_torch/assets/fixtures.py``, refresh the checked-in
fixtures from the repo root with

    python tests/torch_parity.py --export
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import types

if __name__ == "__main__":  # run as a script: put the repo root on the path
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

# the lane runs several xdist workers; one intra-op thread each
torch.set_num_threads(1)

from myosuite_mjx_tpu.engine import data as jdata  # noqa: E402
from myosuite_mjx_tpu.engine import model as jmodel  # noqa: E402
from myosuite_mjx_tpu_torch.assets import fixtures  # noqa: E402
from myosuite_mjx_tpu_torch.assets.fixtures import (  # noqa: E402
    free_fixture_xml, hand_fixture_xml)
from myosuite_mjx_tpu_torch.engine import data as tdata  # noqa: E402
from myosuite_mjx_tpu_torch.engine import model as tmodel  # noqa: E402
from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED  # noqa: E402

ASSETS = os.path.join(os.path.dirname(tmodel.__file__), os.pardir, "assets")
NPZ = {2: os.path.join(ASSETS, "hand11.npz"), 5: os.path.join(ASSETS,
                                                              "hand23.npz")}
# the ball/free/mocap scene
FREE_NPZ = os.path.join(ASSETS, "free10.npz")
# the primitive-pairs scene
PRIMS_NPZ = os.path.join(ASSETS, "prims36.npz")
# the hand-object scenes by object, then digit count: hand11_key.npz ...
OBJECTS = ("key", "hold", "pen", "die")
OBJECT_NPZ = {(obj, digits): os.path.join(
    ASSETS, f"hand{11 if digits == 2 else 23}_{obj}.npz")
              for obj in OBJECTS for digits in (2, 5)}
# the two-leg scenes by name: legs80 / legs16, plain and with the
# chase-tag opponent, legs80 with MyoLeg's muscle names (the reflex
# walker's scene), and both widths with MyoLeg's seven-joint knees (the
# benchmark's legs80 configuration)
LEGS = {"legs80": (40, False), "legs80_chasetag": (40, True),
        "legs16": (8, False), "legs16_chasetag": (8, True),
        "legs80_reflex": (40, False, True),
        "legs80_knee": (40, False, False, True),
        "legs16_knee": (8, False, False, True)}
LEGS_NPZ = {name: os.path.join(ASSETS, f"{name}.npz") for name in LEGS}
# the sensor tests' plate scene
PLATE_NPZ = os.path.join(ASSETS, "plate.npz")
# the mesh-hull scene
HULLS_NPZ = os.path.join(ASSETS, "hulls.npz")
# the baoding hands and the arm scenes by digit count: hand11_baoding.npz,
# arm27_relocate.npz, ...
TASK_SCENES = ("baoding", "relocate", "bimanual")
SCENE_NPZ = {(scene, digits): os.path.join(ASSETS, "{}{}_{}.npz".format(
    "hand" if scene == "baoding" else "arm",
    {2: 11, 5: 23}[digits] + (0 if scene == "baoding" else 4), scene))
             for scene in TASK_SCENES for digits in (2, 5)}
# the SAR hands by key: digits, condim (4 for Geometries8/100, 3 for the
# in- and out-of-distribution tasks)
SAR = {"sar2": (2, 4), "sar5": (5, 4), "sar2_c3": (2, 3), "sar5_c3": (5, 3)}
SAR_NPZ = {key: os.path.join(ASSETS, "hand{}_sar{}.npz".format(
    {2: 11, 5: 23}[d], "" if c == 4 else "_c3")) for key, (d, c) in SAR.items()}
# the OSL RunTrack scene, and the tracking scenes by name (digits)
OSL_NPZ = os.path.join(ASSETS, "osl54.npz")
TRACK = {"track29": 5, "track17": 2}
TRACK_NPZ = {name: os.path.join(ASSETS, f"{name}.npz") for name in TRACK}
# the hanging and lying chain of 72 hinges, the scene with nv > 64
CHAIN_NPZ = os.path.join(ASSETS, "chain72.npz")
# every checked-in fixture: the hands by digit count, "free", "prims", the
# object scenes as "<object><digits>" (e.g. "key2"), the leg scenes,
# "plate", "hulls", the task scenes as "<scene><digits>" (e.g.
# "relocate5"), the SAR hands, "osl54", the tracking scenes and "chain72"
FIXTURE_NPZ = {**NPZ, "free": FREE_NPZ, "prims": PRIMS_NPZ,
               **{f"{obj}{digits}": path
                  for (obj, digits), path in OBJECT_NPZ.items()},
               **LEGS_NPZ, "plate": PLATE_NPZ, "hulls": HULLS_NPZ,
               **{f"{scene}{digits}": path
                  for (scene, digits), path in SCENE_NPZ.items()},
               **SAR_NPZ, "osl54": OSL_NPZ, **TRACK_NPZ,
               "chain72": CHAIN_NPZ}
# the OSL scene's gait table, and the tracking scenes' clips by (scene,
# clip name): track29_lift_clip.npz ...
OSL_GAIT_CSV = os.path.join(ASSETS, "osl54_gait_cycle.csv")
TRACK_CLIP_NPZ = {(name, clip): os.path.join(ASSETS, f"{name}_{clip}_clip.npz")
                  for name in TRACK for clip in ("lift", "inspect")}


# the SAR tasks' geometry tables, exported from the JAX package's
# ``envs/sar_geometries.py`` (numpy only)
SAR_GEOMETRIES_NPZ = os.path.join(ASSETS, "sar_geometries.npz")


def sar_geometry_tables() -> dict[str, np.ndarray]:
  """The JAX package's SAR size tables as ``<table>_<TYPE>`` arrays
  (``G8_CAPS`` ... ``OOD_BOX``), the keys of ``sar_geometries.npz``."""
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import sar_geometries as geo
    return {f"{table}_{kind.upper()}": np.asarray(arr)
            for table in ("G8", "G100", "ID", "OOD")
            for kind, arr in zip(geo.TYPE_NAMES, getattr(geo, table))}


def fixture_xml(key) -> str:
  """The MJCF text of a ``FIXTURE_NPZ`` key."""
  if key in LEGS:
    return fixtures.legs_fixture_xml(*LEGS[key])
  if key in SAR:
    return fixtures.sar_fixture_xml(*SAR[key])
  if key == "free":
    return free_fixture_xml()
  if key == "prims":
    return fixtures.prims_fixture_xml()
  if key == "plate":
    return fixtures.plate_fixture_xml()
  if key == "hulls":
    return fixtures.hulls_fixture_xml()
  if key == "osl54":
    return fixtures.osl_fixture_xml()
  if key in TRACK:
    return fixtures.track_fixture_xml(TRACK[key])
  if key == "chain72":
    return fixtures.chain_fixture_xml()
  if isinstance(key, str):
    return getattr(fixtures, f"{key[:-1]}_fixture_xml")(int(key[-1]))
  return hand_fixture_xml(key)

# myoHandPoseFixed-v0's target joint values (MyoHand joint order)
HAND_TARGET = HAND_POSE_FIXED["target_jnt_value"]


def jax_model(digits: int):
  """The reference Model of the fixture, compiled from its XML."""
  return jmodel.load_model(hand_fixture_xml(digits), dtype=np.float64)


def port_model(digits: int, dtype=torch.float64) -> tmodel.DeviceModel:
  return tmodel.DeviceModel(tmodel.load_npz(NPZ[digits]), dtype, "cpu")


def export_model(xml: str) -> dict[str, np.ndarray]:
  """Compile MJCF text (or a path) into the port's ``.npz`` payload."""
  return tmodel.to_npz_payload(
      tmodel.from_reference(jmodel.load_model(xml, dtype=np.float64)))


def to_np(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def assert_close(port, ref, rtol: float, atol: float, what: str = ""):
  np.testing.assert_allclose(to_np(port), to_np(ref), rtol=rtol, atol=atol,
                             err_msg=what)


def assert_tree_close(port, ref, what: str, rtol: float):
  """Nested dicts with the same keys; each array within ``rtol`` of its
  reference's largest entry. (Element-wise relative error means nothing on
  entries that are zero up to rounding: rotation matrices, the moments of
  a weight whose gradient is near zero.)"""
  if isinstance(ref, dict):
    assert sorted(port) == sorted(ref), what
    for k in ref:
      assert_tree_close(port[k], ref[k], f"{what}.{k}", rtol)
  else:
    scale = float(np.abs(to_np(ref)).max(initial=0.0))
    assert_close(port, ref, what=what, rtol=0, atol=rtol * scale)


def tree_tensors(tree, prefix=""):
  """(dotted path, tensor) for every tensor in nested dicts."""
  if isinstance(tree, torch.Tensor):
    yield prefix, tree
  elif isinstance(tree, dict):
    for k, v in tree.items():
      yield from tree_tensors(v, f"{prefix}.{k}")


def as_float64(tree):
  """A float64 copy of a JAX learner state. flax keeps Dense params in
  float32 (its default param_dtype) even with x64 on, which rounds the
  reference's gradients and steps to float32; given float64 params it
  computes in float64 throughout."""
  return jax.tree.map(
      lambda x: x.astype(jnp.float64)
      if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def random_states(m, batch: int, seed: int):
  """Joint states over the whole range, a little past the limits at times
  (limit rows active), which drives fingertips into the floor and digits
  into each other (contacts active)."""
  rng = np.random.default_rng(seed)
  lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
  span = hi - lo
  qpos = rng.uniform(lo - 0.05 * span, hi + 0.05 * span, (batch, m.nq))
  qvel = rng.normal(0.0, 2.0, (batch, m.nv))
  act = rng.uniform(0.0, 1.0, (batch, m.na))
  ctrl = rng.uniform(-0.1, 1.1, (batch, m.nu))
  warm = rng.normal(0.0, 5.0, (batch, m.nv))
  return qpos, qvel, act, ctrl, warm


def jax_batch(m, qpos, qvel, act, ctrl, warm):
  """A batched JAX Data (float64) holding the given state."""
  B = qpos.shape[0]
  d0 = jdata.make_data(m, dtype=jnp.float64)
  d = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
  return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                   act=jnp.asarray(act), ctrl=jnp.asarray(ctrl),
                   qacc_warmstart=jnp.asarray(warm), overlay={})


def port_batch(jd) -> tdata.Data:
  """The port's Data holding exactly the JAX Data's values."""
  return tdata.data_from_numpy(jax.tree.map(np.asarray, jd), "cpu")


def _bare_imported(name: str) -> bool:
  return name.startswith(("myosuite_mjx_tpu.envs", "myosuite_mjx_tpu.train"))


@contextlib.contextmanager
def bare_envs_package():
  """Import the JAX ``envs.pose`` and ``train.*`` modules without the env
  registry.

  ``myosuite_mjx_tpu.envs/__init__`` registers every task and needs the
  MyoSuite asset tree. A bare package module with the same ``__path__``
  lets ``envs.base``, ``envs.pose`` and the learners (which import
  ``envs.base``) import. On exit every ``envs`` and ``train`` module
  imported inside is dropped and sys.modules is restored.
  """
  import myosuite_mjx_tpu
  with pytest.MonkeyPatch.context() as mp:
    before = set(sys.modules)
    for n in [n for n in sys.modules if _bare_imported(n)]:
      mp.delitem(sys.modules, n)
    pkg = types.ModuleType("myosuite_mjx_tpu.envs")
    pkg.__path__ = [os.path.join(os.path.dirname(myosuite_mjx_tpu.__file__),
                                 "envs")]
    mp.setitem(sys.modules, "myosuite_mjx_tpu.envs", pkg)
    mp.setattr(myosuite_mjx_tpu, "envs", pkg, raising=False)
    try:
      yield
    finally:
      for n in set(sys.modules) - before:
        if _bare_imported(n):
          sys.modules.pop(n)


@pytest.fixture
def jax_pose_env():
  """The JAX ``PoseEnv`` class (see ``bare_envs_package``)."""
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pose import PoseEnv
    yield PoseEnv


# ---------------------------------------------------------------------------
# task parity: a JAX task class and the port's on the same MJCF
# ---------------------------------------------------------------------------

# obs, reward and every reward key after a reset and autoreset steps:
# Newton on stiff contact rows amplifies rounding
TASK_TOL = dict(rtol=1e-8, atol=1e-9)


def task_kwargs(env_id: str, **overrides) -> dict:
  """A registered id's kwargs without its model path, with overrides."""
  from myosuite_mjx_tpu_torch.envs import registry
  kw = dict(registry._REGISTRY[env_id][1], **overrides)
  kw.pop("model_path")
  return kw


def reset_keys(state_rng):
  """The key each env's fresh reset inside ``autoreset_step`` gets."""
  return jax.vmap(lambda r: jax.random.split(r)[1])(state_rng)


def reset_split(keys):
  """(k_aux, k_state) of JAX's ``reset`` for each env key."""
  ks = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
  return ks[:, 1], ks[:, 2]


class QueuedDraws:
  """Mixin for a port task whose draw hooks return ``self.next_draw(hook,
  device)``: the next entry of ``self.draws[hook]``, JAX's draws queued
  by the test (a tuple of arrays for a hook that returns several)."""
  HOOKS: tuple = ()

  def __init__(self, *args, **kwargs):
    self.draws = {h: [] for h in self.HOOKS}
    super().__init__(*args, **kwargs)

  def next_draw(self, hook: str, device):
    out = self.draws[hook].pop(0)
    if isinstance(out, tuple):
      return tuple(torch.as_tensor(np.array(x), device=device) for x in out)
    return torch.as_tensor(np.array(out), device=device)


def compare_task_states(jenv, jst, penv, pst, what: str,
                        compare_aux: bool = True):
  """obs, reward, done, info and every reward key of a batched JAX state
  against the port's, and aux unless ``compare_aux`` is off (a task whose
  aux holds a JAX key where the port keeps the key's draw)."""
  assert_close(pst.obs, jst.obs, what=f"{what} obs", **TASK_TOL)
  assert_close(pst.reward, jst.reward, what=f"{what} reward", **TASK_TOL)
  np.testing.assert_array_equal(to_np(pst.done), to_np(jst.done))
  jr = jax.vmap(lambda d, aux: jenv.get_reward_dict(
      jenv.get_obs_dict(d, aux), d, aux))(jst.data, jst.aux)
  pr = penv.get_reward_dict(penv.get_obs_dict(pst.data, pst.aux), pst.data,
                            pst.aux)
  assert sorted(pr) == sorted(jr)
  for k in jr:
    if k in ("solved", "done"):
      np.testing.assert_array_equal(to_np(pr[k]), to_np(jr[k]), err_msg=k)
    else:
      assert_close(pr[k], jr[k], what=f"{what} {k}", **TASK_TOL)
  for k, v in jst.info.items():
    assert_close(pst.info[k], v, what=f"{what} info {k}", **TASK_TOL)
  if not compare_aux:
    return
  assert sorted(pst.aux) == sorted(jst.aux)
  for k, v in jst.aux.items():
    assert_close(pst.aux[k], v, what=f"{what} aux {k}", **TASK_TOL)


def task_rollout(jenv, penv, queue_draws, batch: int, steps: int,
                 seed: int = 0, compare_aux: bool = True):
  """Reset and ``steps`` autoreset steps of ``batch`` envs in both
  packages with the same actions, comparing after each
  (``compare_task_states``); JAX's draws go to the port through
  ``queue_draws(keys)``, called with the env keys of each reset before
  the port draws. Returns (JAX state, port state, episode ends)."""
  assert penv.obs_keys == jenv.obs_keys
  assert penv.rwd_keys_wt == jenv.rwd_keys_wt
  actions = np.random.default_rng(seed).uniform(
      -0.2, 1.2, (steps, batch, penv.action_dim))
  keys = jax.random.split(jax.random.PRNGKey(seed), batch)
  jst = jax.jit(jax.vmap(jenv.reset))(keys)
  queue_draws(keys)
  pst = penv.reset(batch, "cpu")
  compare_task_states(jenv, jst, penv, pst, "reset", compare_aux)
  jstep = jax.jit(jax.vmap(jenv.autoreset_step))
  ends = 0
  for t in range(steps):
    queue_draws(reset_keys(jst.rng))
    jst = jstep(jst, jnp.asarray(actions[t]))
    pst = penv.autoreset_step(pst, torch.as_tensor(actions[t]))
    compare_task_states(jenv, jst, penv, pst, f"step {t}", compare_aux)
    ends += int(to_np(pst.info["terminated"] | pst.info["truncated"]).sum())
  assert not any(penv.draws.values()), "draws left in the queue"
  return jst, pst, ends


def main(argv=None) -> None:
  ap = argparse.ArgumentParser(description="Write the port's fixture models.")
  ap.add_argument("--export", action="store_true",
                  help="compile every fixture (hand11, hand23, free10, "
                       "prims36, the hand-object scenes, the leg scenes, "
                       "the plate, hulls, the baoding, SAR, relocate, "
                       "bimanual, OSL, tracking and chain72 scenes) and "
                       "write its "
                       ".npz file, the SAR geometry tables, the OSL gait "
                       "table and the tracking clips")
  ap.add_argument("--out-dir", default=os.path.normpath(ASSETS))
  args = ap.parse_args(argv)
  if not args.export:
    ap.error("nothing to do: pass --export")
  for key, fixture in FIXTURE_NPZ.items():
    path = os.path.join(args.out_dir, os.path.basename(fixture))
    np.savez_compressed(path, **export_model(fixture_xml(key)))
    print(path)
  path = os.path.join(args.out_dir, os.path.basename(SAR_GEOMETRIES_NPZ))
  np.savez_compressed(path, **sar_geometry_tables())
  print(path)
  path = os.path.join(args.out_dir, os.path.basename(OSL_GAIT_CSV))
  with open(path, "w") as f:
    f.write(fixtures.osl_gait_csv())
  print(path)
  for (name, clip), dest in TRACK_CLIP_NPZ.items():
    path = os.path.join(args.out_dir, os.path.basename(dest))
    np.savez_compressed(path, **fixtures.track_clips(TRACK[name])[clip])
    print(path)


if __name__ == "__main__":
  main()
