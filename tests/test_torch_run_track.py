"""RunTrackEnv (the OSL RunTrack ids): the port against the JAX package,
float64, on the osl54 scene (``assets/fixtures.py``; the ids' width, 54
muscles).

The JAX class is built on the same MJCF with a registered id's kwargs
and runs under ``jax.vmap``. Its draws are rebuilt from its key schedule
(reset splits its key in 4 and gives the second part to ``reset_aux``,
which splits it into the terrain's key and the state's key; the state key
splits in 3 for the random reset's keyframe, x and heading, or gives the
gait row directly) and handed to the port through ``draw_terrain`` (the
track's draws, rebuilt as in ``tests/test_torch_heightfields.py``) and
``draw_reset_state``.

- The reset's task part (aux and the adjusted qpos and qvel) in the
  ``random`` mode on the Random id's random track, and in the
  ``osl_init`` and ``init`` modes;
- 3 autoreset steps of 4 envs of ``osl54OslRunFixed-v0`` with horizon 2
  (autoreset fires inside), obs, reward, done, every reward key, info,
  aux and ctrl compared after each (``torch_parity.TASK_TOL``, rtol 1e-8).

The JAX env's compile of the 54-muscle scene's ``autoreset_step`` is most
of this file's time.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (OSL_GAIT_CSV, OSL_NPZ, QueuedDraws, TASK_TOL,
                          assert_close, bare_envs_package, fixture_xml,
                          reset_split, task_kwargs, task_rollout, to_np)
from myosuite_mjx_tpu_torch.assets import fixtures
from myosuite_mjx_tpu_torch.envs import osl
from myosuite_mjx_tpu_torch.envs.run_track import RunTrackEnv

B = 4
STEPS = 3
F64 = jnp.float64
FIXED = "osl54OslRunFixed-v0"
RANDOM = "osl54OslRunRandom-v0"
# reset mode -> (id, kwargs overrides)
MODES = {"random": (RANDOM, {}),
         "osl_init": (FIXED, dict(reset_type="osl_init")),
         "init": (FIXED, dict(reset_type="init"))}


@functools.lru_cache(maxsize=None)
def _jax_env(env_id: str, **over):
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.run_track import RunTrackEnv as J
    return J(fixture_xml("osl54"), dtype=F64, **task_kwargs(env_id, **over))


class _Port(QueuedDraws, RunTrackEnv):
  HOOKS = ("draw_terrain", "draw_reset_state")

  def draw_terrain(self, batch, device, generator):
    return self.next_draw("draw_terrain", device)

  def draw_reset_state(self, batch, device, generator):
    return self.next_draw("draw_reset_state", device)

  def next_draw(self, hook, device):
    out = self.draws[hook].pop(0)
    return jax.tree.map(lambda x: torch.as_tensor(np.array(x),
                                                  device=device), out)


def _port_env(env_id: str, **over) -> _Port:
  return _Port(OSL_NPZ, dtype=torch.float64, **task_kwargs(env_id, **over))


def _terrain_draws(jenv, k):
  """The track's draws from the terrain key (the rough patches' fill and
  scale from the third generator's key, the type pick)."""
  f = jenv.trackfield
  if f.reset_type == "flat":
    return {}
  k_type, k_gen = jax.random.split(k)
  key = jax.random.fold_in(k_gen, 2)
  fill, scale = [], []
  for i, (lo, hi) in enumerate(f._patch_bounds(len(f.rough_d))):
    k1, k2 = jax.random.split(jax.random.fold_in(key, i))
    fill.append(jax.random.uniform(k1, (hi - lo, f.shape[1]), F64, -1.0,
                                   1.0))
    scale.append(jax.random.uniform(k2, (), F64, 0.0, float(f.rough_d[i])))
  n = len(f._patch_bounds(len(f.stairs_d)))
  pick = jax.random.randint(
      k_type, (n,) if f.reset_type == "random_mixed" else (), 0, 3)
  return dict(pick=pick, rough_fill=fill, rough_scale=scale)


def _state_draws(jenv, k):
  if jenv.reset_type == "random":
    k_key, k_x, k_yaw = jax.random.split(k, 3)
    w = 0.8 * jenv.real_width
    return dict(key=jax.random.randint(k_key, (), 0, 3),
                x=jax.random.uniform(k_x, (), F64, -w, w),
                yaw=jax.random.uniform(k_yaw, (), F64,
                                       jnp.deg2rad(-125.0),
                                       jnp.deg2rad(-60.0)))
  if jenv.reset_type == "osl_init":
    return dict(row=jax.random.randint(k, (), 0, jenv._init_data.shape[0]))
  return {}


def _queue(penv, jenv):
  def queue(keys):
    k_aux, _ = reset_split(keys)
    ks = jax.vmap(jax.random.split)(k_aux)
    terrain = jax.vmap(lambda k: _terrain_draws(jenv, k))(ks[:, 0])
    if "pick" in terrain:
      terrain["pick"] = np.asarray(terrain["pick"]).astype(np.int64)
    state = {k: np.asarray(v) for k, v in jax.vmap(
        lambda k: _state_draws(jenv, k))(ks[:, 1]).items()}
    for k in ("key", "row"):
      if k in state:
        state[k] = state[k].astype(np.int64)
    penv.draws["draw_terrain"].append(terrain)
    penv.draws["draw_reset_state"].append(state)
  return queue


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reset_task_part_matches_jax(mode):
  """aux and the adjusted qpos, qvel of JAX's reset (its first three
  stages, jitted without the forward pass) against the port's."""
  env_id, over = MODES[mode]
  jenv = _jax_env(env_id, **over)
  penv = _port_env(env_id, **over)
  assert penv.reset_type == jenv.reset_type == mode

  def parts(k):
    _, k_aux, k_state, _ = jax.random.split(k, 4)
    aux = jenv.reset_aux(k_aux)
    return aux, jenv.reset_qpos_qvel(k_state, aux)

  keys = jax.random.split(jax.random.PRNGKey(7), B)
  jaux, (jq, jv) = jax.jit(jax.vmap(parts))(keys)
  _queue(penv, jenv)(keys)
  paux = penv._reset_aux(B, "cpu", None)
  pq, pv = penv.reset_qpos_qvel(B, "cpu", paux, None)
  assert sorted(paux) == sorted(jaux)
  for k, v in jaux.items():
    if k in ("osl_state", "terrain_type"):
      np.testing.assert_array_equal(to_np(paux[k]), np.asarray(v), k)
    else:
      assert_close(paux[k], v, what=k, **TASK_TOL)
  assert_close(pq, jq, what="qpos", **TASK_TOL)
  assert_close(pv, jv, what="qvel", **TASK_TOL)
  assert not any(penv.draws.values())

  q = to_np(pq)
  if mode == "random":
    np.testing.assert_allclose(q[:, 1], penv.start_pos + 1)
    assert (np.abs(q[:, 0]) <= 0.8 * penv.real_width).all()
    assert len(set(to_np(paux["terrain_type"]).tolist()) - {1, 2, 3}) == 0
    assert np.ptp(to_np(paux["hfield"])) > 0
  if mode != "init":
    # the lowest heel or toe site 5 mm over the floor
    st = penv.reset_to(pq, pv, aux=paux)
    lows = to_np(st.data.site_xpos[:, penv.btm_sites, 2]).min(-1)
    np.testing.assert_allclose(lows, 0.005, atol=1e-9)
  else:
    np.testing.assert_array_equal(q, np.broadcast_to(
        penv.model.key_qpos[0], q.shape))


def test_autoreset_rollout_matches_jax():
  over = dict(horizon=2)
  jenv = _jax_env(FIXED, **over)
  penv = _port_env(FIXED, **over)
  assert penv.action_dim == penv.model.na == 54 and penv.model.nu == 56
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv, jenv), B, STEPS)
  assert ends > 0
  assert_close(pst.data.ctrl, jst.data.ctrl, what="ctrl", **TASK_TOL)
  assert_close(pst.data.efc_force_limit, jst.data.efc_force_limit,
               what="efc_force_limit", **TASK_TOL)


def test_osl_ctrl_comes_from_the_pre_step_sensors():
  """The two OSL ctrls are the machine's torques over the gears, clipped,
  from the sensors of the state before the step; the muscles take the
  action's sigmoid."""
  env = RunTrackEnv(OSL_NPZ, dtype=torch.float64,
                    **task_kwargs(FIXED, reset_type="init"))
  g = torch.Generator().manual_seed(0)
  st = env.reset(3, "cpu", g)
  for _ in range(2):
    st = env.step(st, torch.full((3, 54), 0.5, dtype=torch.float64), g)
  sens = env._osl_sens(st.data)
  state, torque = osl.step(st.aux["osl_state"], sens, env._osl_params)
  action = torch.rand((3, 54), generator=g, dtype=torch.float64)
  ctrl, aux = env.control(st, action)
  gear = torch.as_tensor(fixtures.OSL_GEAR, dtype=torch.float64)
  np.testing.assert_allclose(to_np(ctrl[:, 54:]), to_np(torch.clamp(
      torque / gear, -1.0, 1.0)), rtol=1e-12)
  np.testing.assert_array_equal(to_np(aux["osl_state"]), to_np(state))
  np.testing.assert_allclose(to_np(ctrl[:, :54]), to_np(
      1.0 / (1.0 + torch.exp(-5.0 * (action - 0.5)))), rtol=1e-12)


def test_gait_table_equals_fresh_export():
  with open(OSL_GAIT_CSV) as f:
    assert f.read() == fixtures.osl_gait_csv()
  header, rows = fixtures.osl_gait_table()
  assert rows.shape[0] >= 247
  env = RunTrackEnv(OSL_NPZ, dtype=torch.float64,
                    **task_kwargs(FIXED, reset_type="osl_init"))
  np.testing.assert_allclose(env._init_data, rows, atol=1e-6)
  # every row's OSL state per the row map; the machine's four states
  assert sorted(set(env._gait_states.tolist())) == [0, 1, 2, 3]
  assert abs(rows[0, header.index("pelvis_euler_yaw")] + math.pi / 2) < 0.1
