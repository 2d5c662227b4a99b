"""Muscle conditions and observation noise: the port against the JAX
package, float64, hand11.

- ``fatigue.compute_act`` over random compartments that reach every branch
  and both clip bounds, and ``random_state`` from JAX's draws;
- 3 control steps (frame_skip 1, which keeps JAX's compiles short) of a
  batch of hand11 pose envs under fatigue (both reset
  modes), sarcopenia and reafferentation (hand11 compiled with its EDC2
  muscle renamed EIP: it has EPL but no EIP), against JAX's ``vmap``ped
  ``reset``/``step``;
- ``obs_noise``: reset and steps with JAX's per-env noise draws; obs and
  reward come from the observed Data, ``state.data`` is the ground truth,
  and the observed forward pass solves constraints although the pose task's
  reset does not.

Draws are rebuilt from JAX's key schedule (``envs/base.py:209-214``,
``:302-309``; ``fatigue.py:35-39``) and handed to the port through the
env's ``draw_fatigue`` and ``draw_obs_noise`` hooks.

Tolerances: the fatigue update 1e-14 (same elementwise formulas); after 3
control steps 1e-8 relative for state, obs and reward.
"""
from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HAND_TARGET, NPZ, assert_close, bare_envs_package,
                          export_model, to_np)
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.envs import fatigue
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv

B = 6
STEPS = 3
KWARGS = dict(frame_skip=1, horizon=100, normalize_act=True, pose_thd=0.35,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])
FN_TOL = dict(rtol=1e-14, atol=1e-14)
STATE_TOL = dict(rtol=1e-8, atol=1e-10)
NOISE = 0.01
REAFF_XML = hand_fixture_xml(2).replace('<muscle name="EDC2"',
                                        '<muscle name="EIP"')


@functools.lru_cache(maxsize=None)
def _jax_modules():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import fatigue as jfatigue
    from myosuite_mjx_tpu.envs.pose import PoseEnv as JaxPoseEnv
    return types.SimpleNamespace(fatigue=jfatigue, PoseEnv=JaxPoseEnv)


def _actions(seed: int, nu: int) -> np.ndarray:
  return np.random.default_rng(seed).uniform(-0.5, 1.5, (STEPS, B, nu))


def _keys():
  return jax.random.split(jax.random.PRNGKey(0), B)


def _jax_rollout(xml: str, init_fatigue: bool = False, **kwargs):
  """JAX's batched reset and STEPS steps; returns (env, [states]).

  ``init_fatigue`` replaces the random fatigue state of the reset by the
  rested one, which is what JAX's reset gives without
  ``fatigue_reset_random`` (nothing else in the state depends on it), so
  both modes share one compiled step."""
  # the JAX env imports envs.fatigue while it traces
  with bare_envs_package():
    env = _jax_modules().PoseEnv(xml, dtype=jnp.float64, **KWARGS, **kwargs)
    st = jax.jit(jax.vmap(env.reset))(_keys())
    if init_fatigue:
      ma = st.aux["fatigue"]["MA"]
      st = st.replace(aux={**st.aux, "fatigue": {
          "MA": jnp.zeros_like(ma), "MR": jnp.ones_like(ma),
          "MF": jnp.zeros_like(ma)}})
    step = jax.jit(jax.vmap(env.step))
    states = [st]
    for a in _actions(1, env.model.nu):
      states.append(step(states[-1], jnp.asarray(a)))
  return env, [jax.tree.map(np.asarray, s) for s in states]


class _JaxDraws(PoseEnv):
  """The port's pose env taking its fatigue draws and, in order, its noise
  draws from the ones given (JAX's)."""

  def __init__(self, *args, fatigue_draws=None, noise_draws=(), **kwargs):
    self.fatigue_draws = fatigue_draws
    self.noise_draws = list(noise_draws)
    super().__init__(*args, **kwargs)

  def draw_fatigue(self, batch, device, generator):
    return self.fatigue_draws

  def draw_obs_noise(self, data, generator):
    return self.noise_draws.pop(0)


def _port_rollout(path, **kwargs):
  """The port's reset and STEPS steps; returns (env, [states])."""
  env = _JaxDraws(path, dtype=torch.float64, **KWARGS, **kwargs)
  st = env.reset(B, "cpu")
  states = [st]
  for a in _actions(1, env.model.nu):
    states.append(env.step(states[-1], torch.as_tensor(a)))
  return env, states


def _compare(port, ref):
  """Physics, obs, reward and the fatigue compartments."""
  for f in ("qpos", "qvel", "act"):
    assert_close(getattr(port.data, f), getattr(ref.data, f), what=f,
                 **STATE_TOL)
  assert_close(port.obs, ref.obs, what="obs", **STATE_TOL)
  assert_close(port.reward, ref.reward, what="reward", **STATE_TOL)
  for k in ref.aux.get("fatigue", {}):
    assert_close(port.aux["fatigue"][k], ref.aux["fatigue"][k],
                 what=f"fatigue.{k}", **STATE_TOL)


def _fatigue_draws(na: int):
  """JAX's reset draws for random_state: k_fat = split(key, 4)[3]."""
  def one(key):
    k_fat = jax.random.split(key, 4)[3]
    k1, k2 = jax.random.split(k_fat)
    return (jax.random.uniform(k1, (na,), jnp.float64),
            jax.random.uniform(k2, (na,), jnp.float64))
  u1, u2 = jax.vmap(one)(_keys())
  return torch.as_tensor(np.array(u1)), torch.as_tensor(np.array(u2))


# ---- fatigue model --------------------------------------------------------

def test_compute_act_matches_jax_on_every_branch():
  rng = np.random.default_rng(0)
  n = 4096
  MA, MR = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
  MF = rng.uniform(0, 1, n)
  TL = rng.uniform(0, 1, n)
  tauact, taudeact = rng.uniform(0.005, 0.05, n), rng.uniform(0.02, 0.2, n)
  dt = 0.02
  st = {"MA": MA, "MR": MR, "MF": MF}
  eff, new = _jax_modules().fatigue.compute_act(
      {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(TL),
      jnp.asarray(tauact), jnp.asarray(taudeact), dt)
  t = torch.as_tensor
  peff, pnew = fatigue.compute_act({k: t(v) for k, v in st.items()}, t(TL),
                                   t(tauact), t(taudeact), dt)
  assert_close(peff, eff, what="effective act", **FN_TOL)
  for k in new:
    assert_close(pnew[k], new[k], what=k, **FN_TOL)
  # the branches and clip bounds these compartments reach
  below, rest = MA < TL, MR > TL - MA
  assert (below & rest).any() and (below & ~rest).any() and (~below).any()
  p = fatigue.FatigueParams()
  rR = np.where(MA >= TL, p.r * p.R, p.R)
  LD, LR = (0.5 + 1.5 * MA) / tauact, (0.5 + 1.5 * MA) / taudeact
  C = np.where(below, np.where(rest, LD * (TL - MA), LD * MR), LR * (TL - MA))
  lo = np.maximum(-MA / dt + p.F * MA, (MR - 1) / dt + rR * MF)
  hi = np.minimum((1 - MA) / dt + p.F * MA, MR / dt + rR * MF)
  assert (C < lo).any() and (C > hi).any() and ((C > lo) & (C < hi)).any()


def test_random_state_matches_jax_from_its_draws():
  key = jax.random.PRNGKey(7)
  ref = _jax_modules().fatigue.random_state(key, 21, jnp.float64)
  k1, k2 = jax.random.split(key)
  u1 = np.array(jax.random.uniform(k1, (21,), jnp.float64))
  u2 = np.array(jax.random.uniform(k2, (21,), jnp.float64))
  out = fatigue.random_state(torch.as_tensor(u1), torch.as_tensor(u2))
  for k in ref:
    assert_close(out[k], ref[k], what=k, rtol=0, atol=0)
  tot = sum(to_np(v) for v in out.values())
  assert_close(tot, np.ones(21), rtol=0, atol=1e-15)


# ---- conditions over env steps ---------------------------------------------

@pytest.mark.parametrize("condition,random_reset", [
    ("fatigue", False), ("fatigue", True), ("sarcopenia", False)],
                         ids=["fatigue", "fatigue_reset_random", "sarcopenia"])
def test_condition_steps_match_jax(condition, random_reset):
  fat = condition == "fatigue"
  jenv, jstates = _jax_rollout(
      hand_fixture_xml(2), init_fatigue=fat and not random_reset,
      muscle_condition=condition, fatigue_reset_random=fat)
  env, states = _port_rollout(NPZ[2], muscle_condition=condition,
                              fatigue_reset_random=random_reset,
                              fatigue_draws=_fatigue_draws(jenv.model.na))
  for port, ref in zip(states, jstates):
    _compare(port, ref)
  if condition == "sarcopenia":
    assert_close(env.model.actuator_gainprm[:, 2],
                 0.5 * PoseEnv(NPZ[2], **KWARGS).model.actuator_gainprm[:, 2],
                 rtol=0, atol=0)
  else:
    ma = to_np(states[-1].aux["fatigue"]["MA"])
    assert not np.allclose(ma, to_np(states[0].aux["fatigue"]["MA"]))


def test_reafferentation_steps_match_jax(tmp_path):
  path = str(tmp_path / "hand11_eip.npz")
  np.savez(path, **export_model(REAFF_XML))
  _, jstates = _jax_rollout(REAFF_XML, muscle_condition="reafferentation")
  env, states = _port_rollout(path, muscle_condition="reafferentation")
  for port, ref in zip(states, jstates):
    _compare(port, ref)
  ctrl = torch.rand(B, env.model.nu, dtype=torch.float64)
  out, _ = env._apply_muscle_condition(ctrl, {})
  eip, epl = env.model.name2id("actuator", "EIP"), env.model.name2id(
      "actuator", "EPL")
  assert torch.equal(out[:, epl], ctrl[:, eip])
  assert (out[:, eip] == 0).all()
  assert torch.equal(out[:, [i for i in range(env.model.nu)
                             if i not in (eip, epl)]],
                     ctrl[:, [i for i in range(env.model.nu)
                              if i not in (eip, epl)]])


# ---- observation noise ------------------------------------------------------

def _noise_draws(model, n_states: int):
  """JAX's per-env noise keys and draws for the reset and each step after
  it: the state's key splits into (next key, noise key) at every state
  built."""
  def draws(k):
    kq, kv, ka = jax.random.split(k, 3)
    u = lambda kk, n: jax.random.uniform(kk, (n,), jnp.float64, -1.0, 1.0)
    return {"qpos": u(kq, model.nq), "qvel": u(kv, model.nv),
            "act": u(ka, model.na)}

  rng = jax.vmap(lambda k: jax.random.split(k, 4)[0])(_keys())
  keys, out = [], []
  for _ in range(n_states):
    pair = jax.vmap(jax.random.split)(rng)
    rng, k_noise = pair[:, 0], pair[:, 1]
    keys.append(k_noise)
    out.append({k: torch.as_tensor(np.array(v))
                for k, v in jax.vmap(draws)(k_noise).items()})
  return keys, out


@pytest.fixture(scope="module")
def noisy():
  jenv, jstates = _jax_rollout(hand_fixture_xml(2), obs_noise=NOISE)
  keys, draws = _noise_draws(jenv.model, STEPS + 1)
  env, states = _port_rollout(NPZ[2], obs_noise=NOISE, noise_draws=draws)
  return types.SimpleNamespace(jenv=jenv, jstates=jstates, env=env,
                               states=states, keys=keys, draws=draws)


def test_obs_noise_reset_and_steps_match_jax(noisy):
  for port, ref in zip(noisy.states, noisy.jstates):
    _compare(port, ref)


def test_obs_and_reward_come_from_the_observed_data(noisy):
  env = noisy.env
  for st, d in zip(noisy.states, noisy.draws):
    nq, nv = env.model.nq, env.model.nv
    # the pose obs are [qpos, qvel * dt, pose_err, act]: noisy qpos, and
    # state.data keeps the ground truth
    assert_close(st.obs[:, :nq], st.data.qpos + NOISE * d["qpos"],
                 rtol=0, atol=1e-15)
    assert_close(st.obs[:, nq:nq + nv],
                 (st.data.qvel + NOISE * d["qvel"]) * env.dt, rtol=0,
                 atol=1e-15)
    obsd = env.observed_data(st.data, d)
    rwd = env.get_reward_dict(env.get_obs_dict(obsd, st.aux), obsd, st.aux)
    dense = sum(w * rwd[k] for k, w in env.rwd_keys_wt.items())
    assert torch.equal(st.reward, dense)
    assert torch.equal(st.done, rwd["done"])
    clean = env.get_reward_dict(env.get_obs_dict(st.data, st.aux), st.data,
                                st.aux)
    assert not torch.equal(rwd["pose"], clean["pose"])


def test_observed_forward_solves_constraints_at_reset(noisy):
  """The pose task's reset skips collision and the Newton solve; the
  observed twin's forward pass takes them, as JAX's ``_observed_data``
  (called here with the same noise key) does."""
  env, jenv = noisy.env, noisy.jenv
  st = noisy.states[0]
  assert (to_np(st.data.contact.dist) == 1e10).all()
  obsd = env.observed_data(st.data, noisy.draws[0])
  jd = jax.tree.map(jnp.asarray, noisy.jstates[0].data)
  jobs = jax.jit(jax.vmap(jenv._observed_data))(jd, noisy.keys[0])
  for f in ("qpos", "qvel", "act", "qacc", "qfrc_constraint",
            "qacc_warmstart"):
    assert_close(getattr(obsd, f), getattr(jobs, f), what=f, **STATE_TOL)
  assert_close(obsd.contact.dist, jobs.contact.dist, what="dist",
               **STATE_TOL)
  assert (to_np(obsd.contact.dist) < 1e9).all()
