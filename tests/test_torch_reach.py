"""ReachEnv, ``reset_to`` and ``post_reset_aux``: the port against the JAX
package, float64, on hand11 (``hand11ReachRandom-v0``'s task).

The JAX ``ReachEnv`` is built on the same MJCF (``hand_fixture_xml(2)``)
and runs under ``jax.vmap``. Its target draws are rebuilt from its key
schedule (``envs/base.py``: reset splits its key in 4 and draws the
target from the second; ``autoreset_step`` resets from the second half of
a split of the state's key; ``reset_to`` splits its key in 2) and handed
to the port through ``ReachEnv.draw_target``. frame_skip 2 keeps the JAX
compile short; horizon 3 makes autoreset fire inside the rollout.

Tolerance: rtol 1e-8 for obs, reward and every reward key, as the pose
env's rollout (Newton on stiff contact rows amplifies rounding).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import NPZ, assert_close, bare_envs_package, to_np
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.engine import smooth
from myosuite_mjx_tpu_torch.envs import myobase, registry
from myosuite_mjx_tpu_torch.envs.reach import ReachEnv

B = 4
STEPS = 5
TOL = dict(rtol=1e-8, atol=1e-9)
KWARGS = dict(registry._REGISTRY["hand11ReachRandom-v0"][1], frame_skip=2,
              horizon=3)
KWARGS.pop("model_path")


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.reach import ReachEnv as JaxReachEnv
    return JaxReachEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)


def _keys(seed: int = 0):
  return jax.random.split(jax.random.PRNGKey(seed), B)


def _reset_targets(jenv, keys):
  """The targets JAX's reset draws from each env's key."""
  return jax.vmap(lambda k: jenv.reset_aux(jax.random.split(k, 4)[1])[
      "target_pos"])(keys)


class _JaxTargets(ReachEnv):
  """The port's ReachEnv taking its target draws, in order, from a list."""

  def __init__(self, *args, **kwargs):
    self.targets: list = []
    super().__init__(*args, **kwargs)

  def draw_target(self, batch, device, generator):
    return torch.as_tensor(np.array(self.targets.pop(0)), device=device)


def _port_env(cls=_JaxTargets):
  return cls(NPZ[2], dtype=torch.float64, **KWARGS)


def _reward_dicts(jenv, jst, penv, pst):
  jr = jax.vmap(lambda d, aux: jenv.get_reward_dict(
      jenv.get_obs_dict(d, aux), d, aux))(jst.data, jst.aux)
  pr = penv.get_reward_dict(penv.get_obs_dict(pst.data, pst.aux), pst.data,
                            pst.aux)
  return jr, pr


def _compare(jenv, jst, penv, pst, what):
  assert_close(pst.obs, jst.obs, what=f"{what} obs", **TOL)
  assert_close(pst.reward, jst.reward, what=f"{what} reward", **TOL)
  np.testing.assert_array_equal(to_np(pst.done), to_np(jst.done))
  jr, pr = _reward_dicts(jenv, jst, penv, pst)
  assert sorted(pr) == sorted(jr)
  for k in jr:
    if k in ("solved", "done"):
      np.testing.assert_array_equal(to_np(pr[k]), to_np(jr[k]), err_msg=k)
    else:
      assert_close(pr[k], jr[k], what=f"{what} {k}", **TOL)
  for k, v in jst.info.items():
    assert_close(pst.info[k], v, what=f"{what} info {k}", **TOL)


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _port_env()
  assert penv.obs_keys == jenv.obs_keys
  assert penv.rwd_keys_wt == jenv.rwd_keys_wt
  assert penv.RESET_CONSTRAINT is False
  actions = np.random.default_rng(0).uniform(-0.2, 1.2,
                                             (STEPS, B, penv.action_dim))
  keys = _keys()
  jst = jax.jit(jax.vmap(jenv.reset))(keys)
  penv.targets.append(_reset_targets(jenv, keys))
  pst = penv.reset(B, "cpu")
  _compare(jenv, jst, penv, pst, "reset")
  jstep = jax.jit(jax.vmap(jenv.autoreset_step))
  ends = {"terminated": 0, "truncated": 0}
  for t in range(STEPS):
    fresh_keys = jax.vmap(lambda r: jax.random.split(r)[1])(jst.rng)
    penv.targets.append(_reset_targets(jenv, fresh_keys))
    jst = jstep(jst, jnp.asarray(actions[t]))
    pst = penv.autoreset_step(pst, torch.as_tensor(actions[t]))
    _compare(jenv, jst, penv, pst, f"step {t}")
    assert_close(pst.aux["target_pos"], jst.aux["target_pos"], rtol=0,
                 atol=0)
    for k in ends:
      ends[k] += int(to_np(pst.info[k]).sum())
  assert not penv.targets
  assert ends["truncated"] > 0, ends


def _states(jenv):
  rng = np.random.default_rng(3)
  m = jenv.model
  qpos = rng.uniform(m.jnt_range[:, 0], m.jnt_range[:, 1], (B, m.nq))
  return qpos, rng.normal(0.0, 1.0, (B, m.nv))


def test_reset_to_matches_jax():
  jenv = _jax_env()
  penv = _port_env()
  qpos, qvel = _states(jenv)
  keys = _keys(5)
  # one compile for both calls: the aux is always given, drawn here as
  # reset_to draws it
  reset_to = jax.jit(jax.vmap(jenv.reset_to))
  draw = jax.vmap(lambda k: jenv.reset_aux(jax.random.split(k)[1]))
  jst = reset_to(jnp.asarray(qpos), jnp.asarray(qvel), keys, draw(keys))
  penv.targets.append(jax.vmap(lambda k: jenv.reset_aux(
      jax.random.split(k)[1])["target_pos"])(keys))
  pst = penv.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel))
  _compare(jenv, jst, penv, pst, "reset_to")
  assert_close(pst.data.qpos, qpos, rtol=0, atol=0)
  assert_close(pst.data.qvel, qvel, rtol=0, atol=0)
  # with an aux given, nothing is drawn
  aux = {"target_pos": jnp.asarray(np.array(jst.aux["target_pos"]) + 0.01)}
  jst = reset_to(jnp.asarray(qpos), jnp.asarray(qvel), keys, aux)
  pst = penv.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel),
                      aux={"target_pos": torch.as_tensor(
                          np.array(aux["target_pos"]))})
  _compare(jenv, jst, penv, pst, "reset_to with aux")
  assert not penv.targets


class _TipsAtReset(ReachEnv):
  """Records the tips right after the reset's forward pass."""

  def post_reset_aux(self, data, aux, generator):
    self.calls = getattr(self, "calls", 0) + 1
    return {**aux, "tips_at_reset": data.site_xpos[:, self.tip_sids]}


def test_post_reset_aux_runs_in_reset_and_reset_to():
  env = _port_env(_TipsAtReset)
  g = torch.Generator().manual_seed(0)
  st = env.reset(B, "cpu", g)
  assert env.calls == 1
  tips = st.obs[:, 22:28].reshape(B, 2, 3)     # after qpos and qvel
  assert_close(st.aux["tips_at_reset"], tips, rtol=0, atol=0)
  qpos, qvel = _states(_jax_env())
  st2 = env.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel), g)
  assert env.calls == 2
  assert_close(st2.aux["tips_at_reset"],
               st2.data.site_xpos[:, env.tip_sids], rtol=0, atol=0)
  # the fresh reset inside autoreset_step calls it too, and the aux of an
  # env that did not reset is kept
  st3 = env.autoreset_step(st2, torch.zeros((B, env.action_dim),
                                            dtype=torch.float64), g)
  assert env.calls == 3
  assert_close(st3.aux["tips_at_reset"], st2.aux["tips_at_reset"], rtol=0,
               atol=0)
  # the base class leaves aux as it is
  plain = _port_env(ReachEnv)
  aux = {"target_pos": torch.zeros((B, 2, 3), dtype=torch.float64)}
  assert plain.post_reset_aux(st.data, aux, g) is aux


@pytest.mark.parametrize("digits", [2, 5])
def test_tip_sites_sit_at_the_distal_ends_at_the_init_pose(digits):
  m = tmodel.load_npz(NPZ[digits])
  dm = tmodel.DeviceModel(m, torch.float64, "cpu")
  kin = smooth.kinematics(dm, torch.as_tensor(m.qpos0)[None])
  tips = myobase.HANDS[f"hand{11 if digits == 2 else 23}"][1]
  for s in tips:
    sid = m.name2id("site", s)
    assert m.site_bodyid[sid] == m.name2id(
        "body", "thumb_dist" if s == "THtip" else
        f"f{'IMRL'.index(s[0]) + 2}_dist")
    assert_close(kin["site_xpos"][0, sid], myobase.TIPS_AT_INIT[s], rtol=0,
                 atol=5e-6, what=s)
