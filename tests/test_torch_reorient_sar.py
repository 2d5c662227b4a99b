"""The SAR reorientation family: the port against the JAX package,
float64, on the hand11 SAR scene (``hand11Reorient100-v0``'s task on the
condim 4 scene; the condim 3 scene of the ID and OOD tasks is checked
without a second JAX compile, which would take the file past its time),
and the geometry tables against the JAX module's.

The JAX classes are built on the same MJCF (``sar_fixture_xml``) and run
under ``jax.vmap``. Their draws are rebuilt from the key schedule (reset
splits its key in 4; the second, split in 3, gives the type, the table
row and the desired angles, the second angle from a ``fold_in`` of the
third; ``autoreset_step`` resets from the second half of a split of the
state's key) and handed to the port through ``draw_object``. frame_skip 2
keeps the JAX compile short; horizon 3 makes autoreset fire inside the
rollout. B = 4.

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward, every
reward key, info and aux, as the other tasks' rollouts; the overlays and
tables are the same numbers (exact); the per-env cosine to rtol 1e-14.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import (FIXTURE_NPZ, QueuedDraws, SAR_GEOMETRIES_NPZ,
                          assert_close, bare_envs_package, reset_split,
                          sar_geometry_tables, task_kwargs, task_rollout,
                          to_np)
from myosuite_mjx_tpu_torch.assets.fixtures import sar_fixture_xml
from myosuite_mjx_tpu_torch.envs import reorient_sar

B = 4
STEPS = 5
# task id -> (port class, JAX class name, fixture key, condim)
TASKS = {
    "hand11Reorient100-v0": (reorient_sar.Geometries100Env,
                             "Geometries100Env", "sar2", 4),
    "hand11ReorientOOD-v0": (reorient_sar.OutOfDistributionEnv,
                             "OutOfDistributionEnv", "sar2_c3", 3),
}


def _kwargs(task_id):
  return task_kwargs(task_id, frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env(task_id):
  _, name, _, condim = TASKS[task_id]
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import reorient_sar as J
    return getattr(J, name)(sar_fixture_xml(2, condim), dtype=jnp.float64,
                            **_kwargs(task_id))


def _port(task_id):
  cls = TASKS[task_id][0]

  class Port(QueuedDraws, cls):
    HOOKS = ("draw_object",)

    def draw_object(self, batch, device, generator):
      return self.next_draw("draw_object", device)

  return Port(FIXTURE_NPZ[TASKS[task_id][2]], dtype=torch.float64,
              **_kwargs(task_id))


def _queue(jenv, penv):
  counts = jnp.asarray(jenv._counts)

  def draw(k):
    k_type, k_idx, k_eul = jax.random.split(k, 3)
    type_idx = jax.random.randint(k_type, (), 0, 4)
    idx = jax.random.randint(k_idx, (), 0, counts[type_idx])
    e = jnp.stack([
        jax.random.uniform(k_eul, (), jnp.float64, -1.0, 1.0),
        jax.random.uniform(jax.random.fold_in(k_eul, 1), (), jnp.float64,
                           -0.8, 1.2)])
    return type_idx, idx, e

  def queue(keys):
    k_aux, _ = reset_split(keys)
    penv.draws["draw_object"].append(jax.vmap(draw)(k_aux))
  return queue


def test_geometry_tables_equal_the_jax_module():
  with np.load(SAR_GEOMETRIES_NPZ) as z:
    fresh = sar_geometry_tables()
    assert sorted(z.files) == sorted(fresh) and len(fresh) == 16
    for k in fresh:
      np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import sar_geometries as geo
    for name in ("G8", "G100", "ID", "OOD"):
      for ours, ref in zip(reorient_sar.geometry_table(name),
                           getattr(geo, name)):
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def test_autoreset_rollout_matches_jax():
  task_id = "hand11Reorient100-v0"
  jenv = _jax_env(task_id)
  penv = _port(task_id)
  np.testing.assert_array_equal(penv._sizes, jenv._sizes)
  np.testing.assert_array_equal(penv._counts, jenv._counts)
  assert_close(penv.init_qpos, jenv.init_qpos, rtol=0, atol=0)
  jst, pst, ends = task_rollout(jenv, penv, _queue(jenv, penv), B, STEPS)
  assert ends > 0
  for k in ("geom_size", "body_mass"):
    assert_close(pst.data.overlay[k], jst.data.overlay[k], rtol=0, atol=0,
                 what=k)


def test_the_condim3_scene_steps():
  """The ID and OOD tasks' scene: every object geom has condim 3 (the
  JAX package's scene for them), and the OOD task steps through its
  table."""
  env = _port("hand11ReorientOOD-v0")
  assert (env.model.geom_condim[env.obj_gids] == 3).all()
  condim4 = _port("hand11Reorient100-v0").model.geom_condim[env.obj_gids]
  assert (condim4 == 4).all()
  draw = (np.array([0, 1, 2, 3]), np.array([249, 0, 5, 7]), np.zeros((4, 2)))
  env.draws["draw_object"] = [draw] * 3
  st = env.reset(4, "cpu")
  for _ in range(2):
    st = env.autoreset_step(st, torch.full((4, env.action_dim), 0.5,
                                           dtype=torch.float64))
  assert bool(torch.isfinite(st.obs).all())
  sizes = to_np(st.data.overlay["geom_size"])[:, env.obj_gids]
  tables = reorient_sar.geometry_table("OOD")
  for b, (t, i) in enumerate(((0, 249), (1, 0), (2, 5), (3, 7))):
    np.testing.assert_array_equal(sizes[b, t], tables[t][i])


def test_one_active_geom_per_env():
  """The overlay sizes exactly one object geom, the drawn type, from its
  table row; the other three shrink to 1e-5; the mass is 1.2 kg."""
  env = reorient_sar.Geometries8Env(FIXTURE_NPZ["sar2"], dtype=torch.float64,
                                    **task_kwargs("hand11Reorient8-v0"))
  st = env.reset(64, "cpu", torch.Generator().manual_seed(3))
  sizes = to_np(st.data.overlay["geom_size"])[:, env.obj_gids]   # [B, 4, 3]
  t = to_np(st.aux["type_idx"])
  assert sorted(set(t.tolist())) == [0, 1, 2, 3]
  tables = reorient_sar.geometry_table("G8")
  for b in range(64):
    active = (sizes[b] > 1e-5).any(-1)
    assert active.tolist() == [i == t[b] for i in range(4)]
    assert any((sizes[b, t[b]] == row).all() for row in tables[t[b]])
    assert (sizes[b, ~active] == 1e-5).all()
  assert (to_np(st.data.overlay["body_mass"])[:, env.obj_bid] == 1.2).all()
  # the object's x is zeroed with the hand (the reference's quirk)
  assert env.init_qpos[-7] == 0.0 and env.init_qpos[0] == -1.5
  assert not to_np(st.done).any()


def test_rot_align_norms_are_per_env():
  """Envs whose vectors have different norms: each env's cosine, as the
  reference's under ``vmap`` (a norm over the whole batch would differ)."""
  env = reorient_sar.Geometries8Env(FIXTURE_NPZ["sar2"], dtype=torch.float64,
                                    **task_kwargs("hand11Reorient8-v0"))
  jenv = _jax_env("hand11Reorient100-v0")
  rng = np.random.default_rng(0)
  a = rng.normal(size=(6, 3)) * rng.uniform(0.2, 3.0, (6, 1))
  b = rng.normal(size=(6, 3)) * rng.uniform(0.2, 3.0, (6, 1))
  obs = {"obj_err_pos": np.zeros((6, 3)), "obj_rot": a, "obj_des_rot": b,
         "act": rng.uniform(size=(6, env.model.na))}
  rwd = env.get_reward_dict({k: torch.as_tensor(v) for k, v in obs.items()},
                            None, {})
  want = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                            * np.linalg.norm(b, axis=-1))
  assert_close(rwd["rot_align"], want, rtol=1e-14, atol=0)
  ref = jax.vmap(lambda o: jenv.get_reward_dict(o, None, {}))(
      {k: jnp.asarray(v) for k, v in obs.items()})
  for k in ("rot_align", "act_reg", "bonus", "sparse"):
    assert_close(rwd[k], ref[k], rtol=1e-14, atol=1e-15, what=k)
  whole_batch = (a * b).sum(-1) / (np.linalg.norm(a) * np.linalg.norm(b))
  assert np.abs(want - whole_batch).max() > 0.1
