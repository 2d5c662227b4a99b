"""Env parity: batched ``PoseEnv.autoreset_step`` against the JAX PoseEnv.

hand11 with the myoHandPoseFixed-v0 task kwargs, B = 4 envs, frame_skip 2
(keeps the JAX compile short) and horizon 3, so that autoreset fires
inside the rollout. The JAX env runs under ``jax.vmap`` in float64.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HAND_TARGET, NPZ, assert_close, jax_pose_env,  # noqa: F401
                          to_np)
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.engine.data import Contact, Data, data_from_numpy
from myosuite_mjx_tpu_torch.envs import base
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv

B = 4
STEPS = 5
KWARGS = dict(frame_skip=2, horizon=3, normalize_act=True, pose_thd=0.7,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])
# the state fields carried from one control step to the next
CARRIED = ("qpos", "qvel", "act", "time", "qacc", "qacc_warmstart", "ctrl")


def _actions(seed: int, nu: int) -> np.ndarray:
  return np.random.default_rng(seed).uniform(-0.2, 1.2, (STEPS, B, nu))


def test_autoreset_rollout_matches_jax(jax_pose_env):
  jenv = jax_pose_env(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
  penv = PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)
  assert penv.action_dim == jenv.action_dim == 21
  actions = _actions(0, penv.action_dim)

  jstate = jax.jit(jax.vmap(jenv.reset))(
      jax.random.split(jax.random.PRNGKey(0), B))
  jstep = jax.jit(jax.vmap(jenv.autoreset_step))
  benv = base.BatchedEnv(penv, B, "cpu", seed=0)
  pstate = benv.init()
  # float64 end to end; Newton on stiff contact rows amplifies rounding
  tol = dict(rtol=1e-7, atol=1e-8)
  assert_close(pstate.obs, jstate.obs, what="reset obs", **tol)
  restarts = 0
  for t in range(STEPS):
    jstate = jstep(jstate, jnp.asarray(actions[t]))
    pstate = benv.step(pstate, torch.as_tensor(actions[t]))
    what = f"step {t}"
    assert_close(pstate.obs, jstate.obs, what=f"{what} obs", **tol)
    assert_close(pstate.reward, jstate.reward, what=f"{what} reward", **tol)
    np.testing.assert_array_equal(to_np(pstate.done), to_np(jstate.done))
    np.testing.assert_array_equal(to_np(pstate.steps), to_np(jstate.steps))
    for k, v in jstate.info.items():
      assert_close(pstate.info[k], v, what=f"{what} info {k}", **tol)
    assert_close(pstate.aux["target_jnt_value"],
                 jstate.aux["target_jnt_value"], rtol=0, atol=0)
    for f in CARRIED:
      assert_close(getattr(pstate.data, f), getattr(jstate.data, f),
                   what=f"{what} {f}", **tol)
    restarts += int(to_np(pstate.info["truncated"]).sum())
  assert restarts == B, "every env crosses horizon=3 once in 5 steps"

  # the JAX state carried into the port holds the same values and steps on
  # like the port's own state
  carried = data_from_numpy(jax.tree.map(np.asarray, jstate))
  assert isinstance(carried, base.EnvState)
  for f in CARRIED:
    assert_close(getattr(carried.data, f), getattr(jstate.data, f), rtol=0,
                 atol=0, what=f"carried {f}")
  action = torch.as_tensor(actions[0])
  assert_close(benv.step(carried, action).obs, benv.step(pstate, action).obs,
               what="step from the carried state", **tol)


def _all_tensors(obj, prefix=""):
  if isinstance(obj, torch.Tensor):
    yield prefix, obj
  elif isinstance(obj, dict):
    for k, v in obj.items():
      yield from _all_tensors(v, f"{prefix}.{k}")
  elif dataclasses.is_dataclass(obj):
    for f in dataclasses.fields(obj):
      yield from _all_tensors(getattr(obj, f.name), f"{prefix}.{f.name}")


_INT_FIELDS = {".steps", ".data.ne_active", ".data.ncon_dropped",
               ".data.contact.geom1", ".data.contact.geom2"}
_BOOL_FIELDS = {".done", ".info.solved", ".info.terminated",
                ".info.truncated"}


def test_float32_rollout_keeps_every_dtype():
  """No float64 constant promotes the float32 state over a rollout."""
  env = PoseEnv(NPZ[2], dtype=torch.float32, **KWARGS)
  benv = base.BatchedEnv(env, B, "cpu", seed=0)
  state = benv.init()
  actions = _actions(1, env.action_dim)
  for t in range(STEPS):
    state = benv.step(state, torch.as_tensor(actions[t], dtype=torch.float32))
  assert np.isfinite(to_np(state.obs)).all()
  seen = set()
  for name, x in _all_tensors(state):
    seen.add(name)
    want = (torch.int32 if name in _INT_FIELDS
            else torch.bool if name in _BOOL_FIELDS else torch.float32)
    assert x.dtype == want, f"{name}: {x.dtype}"
    assert x.shape[0] == B, name
  n_data = len(dataclasses.fields(Data)) - 1 + len(dataclasses.fields(Contact))
  assert len(seen) == n_data + 4 + 5 + 1   # obs, reward, done, steps; info; aux


def test_env_shapes_at_hand23_width():
  env = PoseEnv(NPZ[5], dtype=torch.float32, frame_skip=1,
                target_jnt_value=HAND_TARGET, reset_type="init",
                target_type="fixed", pose_thd=0.7)
  state = env.reset(2)
  assert env.action_dim == 39
  assert state.obs.shape == (2, 108)    # qpos 23, qvel 23, pose_err 23, act 39
  assert env.obs_keys == ["qpos", "qvel", "pose_err", "act"]


def test_generated_targets_and_random_resets_use_the_generator():
  m_rng = {"mcp2_flexion": (-0.2, 1.2), "pm2_flexion": (0.0, 1.0)}
  env = PoseEnv(NPZ[2], dtype=torch.float64, frame_skip=1,
                target_jnt_range=m_rng, reset_type="random",
                target_type="generate")
  draws = []
  for _ in range(2):
    g = torch.Generator().manual_seed(3)
    st = env.reset(16, "cpu", g)
    draws.append(st.aux["target_jnt_value"])
  assert torch.equal(draws[0], draws[1])
  tgt = to_np(draws[0])
  qadr = env.target_jnt_qposadr
  lo, hi = env.target_jnt_range[:, 0], env.target_jnt_range[:, 1]
  assert ((tgt[:, qadr] >= lo) & (tgt[:, qadr] <= hi)).all()
  assert np.ptp(tgt[:, qadr], axis=0).min() > 0.1
  rng = env.model.jnt_range
  qpos = to_np(st.data.qpos)
  # reset_type="random" draws each joint inside its range (one substep of
  # forward() leaves qpos unchanged)
  assert ((qpos >= rng[:, 0]) & (qpos <= rng[:, 1])).all()


def test_unported_options_raise():
  with pytest.raises(NotImplementedError):
    PoseEnv(NPZ[2], muscle_condition="sarcopenia",
            target_jnt_value=HAND_TARGET[:11])
  with pytest.raises(NotImplementedError):
    PoseEnv(NPZ[2], obs_noise=0.01, target_jnt_value=HAND_TARGET[:11])
  with pytest.raises(FileNotFoundError):
    PoseEnv("no/such/model.npz", target_jnt_value=HAND_TARGET[:11])
