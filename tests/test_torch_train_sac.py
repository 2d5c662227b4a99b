"""SAC parity: the port's learner against the JAX package's, float64, hand11.

hand11 with the myoHandPoseFixed-v0 task kwargs, frame_skip 2, horizon 3
and the termination threshold next to hand11's initial pose distance (as
the PPO test), so that some envs terminate and every env autoresets. SAC at
N = 8 envs, buffer 20 (not a multiple of N, so the third insert wraps mid
batch), batch 16, hidden (32, 32), 2 updates per step and learning_starts
8: the first step is before it (updates computed and thrown away), the
second and third after it.

The tests rebuild JAX's draws from its key schedule (``sac.py:160-161``,
``:65``, ``:166-168``, ``:184-187``, ``:237``) and hand them to
``SAC.train_step_from``; JAX states are carried into the port with
``sac_state_from_numpy``. The JAX trainer is given a float64 copy of its
init state (flax keeps Dense params in float32 even with x64 on).

Tolerances: after a train step, 1e-6 of each array's largest entry for
state (``assert_tree_close``) and 1e-6 relative for metrics; 1e-12 for the
nets' outputs and the sampled actions, 1e-10 for the log-prob at tanh's
saturation; the carry is exact.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HAND_TARGET, NPZ, as_float64, assert_close,
                          assert_tree_close, bare_envs_package, to_np)
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv
from myosuite_mjx_tpu_torch.train.common import _flax_leaves, flax_params
from myosuite_mjx_tpu_torch.train.sac import (SAC, SACConfig, sample_tanh,
                                              sac_state_from_numpy)

FAR_TH = 0.8645
KWARGS = dict(frame_skip=2, horizon=3, normalize_act=True, pose_thd=0.8641,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])
CFG = dict(num_envs=8, buffer_size=20, batch_size=16, hidden=(32, 32),
           updates_per_step=2, learning_starts=8)
STATE_RTOL = 1e-6
STEP_TOL = dict(rtol=1e-6, atol=0)
FN_TOL = dict(rtol=1e-12, atol=1e-12)
# the sampler near tanh's saturation: one ulp of a (1e-16) over 1 - a^2
# (down to its 1e-6 floor) is up to ~1e-10 in each dim's log term
SAMPLER_TOL = dict(rtol=1e-10, atol=1e-10)
PARTS = ("actor_params", "q_params", "q_target", "log_alpha", "actor_opt",
         "q_opt", "alpha_opt", "buffer", "cursor", "env_state")
METRICS = ("reward_mean", "q_loss", "a_loss", "alpha", "buffer_size")


def jax_draws(ts, cfg, act_dim: int) -> dict:
  """The draws JAX's train_step makes from ``ts.key``."""
  N, U, M = cfg.num_envs, cfg.updates_per_step, cfg.batch_size
  pos = int(ts.buf_pos)
  full = bool(ts.buf_full) or pos + N >= cfg.buffer_size
  size = cfg.buffer_size if full else (pos + N) % cfg.buffer_size
  _, k_act, k_samp = jax.random.split(ts.key, 3)
  mb, eps_next, eps_pi = [], [], []
  for k in jax.random.split(k_samp, U):
    k1, k2, k3 = jax.random.split(k, 3)
    mb.append(jax.random.randint(k1, (M,), 0,
                                 jnp.maximum(jnp.int32(size), 1)))
    eps_next.append(jax.random.normal(k2, (M, act_dim)))
    eps_pi.append(jax.random.normal(k3, (M, act_dim)))
  t = lambda x: torch.as_tensor(np.array(x))
  return dict(
      eps_act=t(jax.random.normal(k_act, (N, act_dim))),
      uniform_act=t(jax.random.uniform(k_act, (N, act_dim), jnp.float64,
                                       -1, 1)),
      mb_idx=t(np.stack(mb)), eps_next=t(np.stack(eps_next)),
      eps_pi=t(np.stack(eps_pi)))


def _np_tree(x):
  return jax.tree.map(np.asarray, x)


def _adam_jax(opt_state) -> dict:
  st = opt_state[0]
  return {"mu": st.mu, "nu": st.nu, "count": np.asarray(st.count, float)}


def jax_parts(ts) -> dict:
  """A JAX SACState (leaves as numpy) as the parts the tests compare."""
  es = ts.env_state
  return dict(
      actor_params=ts.actor_params, q_params=ts.q_params,
      q_target=ts.q_target, log_alpha=ts.log_alpha,
      actor_opt=_adam_jax(ts.actor_opt), q_opt=_adam_jax(ts.q_opt),
      alpha_opt=_adam_jax(ts.alpha_opt), buffer=dict(ts.buffer),
      cursor=dict(buf_pos=np.asarray(ts.buf_pos, float),
                  buf_full=np.asarray(ts.buf_full, float),
                  steps=np.asarray(ts.steps, float)),
      env_state=dict(obs=es.obs, reward=es.reward,
                     done=np.asarray(es.done, float), qpos=es.data.qpos,
                     qvel=es.data.qvel, act=es.data.act))


def _adam_port(opt, net) -> dict:
  out = {"mu": {}, "nu": {}}
  count = None
  for p, path, transposed in _flax_leaves(net):
    st = opt.state[p]
    count = float(st["step"])
    for key, leaf in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
      node = out[key].setdefault("params", {})
      for k in path[:-1]:
        node = node.setdefault(k, {})
      x = to_np(st[leaf])
      node[path[-1]] = x.T if transposed else x
  out["count"] = np.asarray(count)
  return out


def port_parts(ts) -> dict:
  """The port's SACState in the layout of ``jax_parts``, copied (the nets
  and the buffer are updated in place by later steps)."""
  st = ts.alpha_opt.state[ts.log_alpha]
  es = ts.env_state
  f = lambda x: to_np(x).astype(float)
  return jax.tree.map(np.array, dict(
      actor_params=flax_params(ts.actor_params),
      q_params=flax_params(ts.q_params), q_target=flax_params(ts.q_target),
      log_alpha=to_np(ts.log_alpha),
      actor_opt=_adam_port(ts.actor_opt, ts.actor_params),
      q_opt=_adam_port(ts.q_opt, ts.q_params),
      alpha_opt={"mu": to_np(st["exp_avg"]), "nu": to_np(st["exp_avg_sq"]),
                 "count": np.asarray(float(st["step"]))},
      buffer={k: to_np(v) for k, v in ts.buffer.items()},
      cursor=dict(buf_pos=np.asarray(ts.buf_pos, float),
                  buf_full=np.asarray(ts.buf_full, float),
                  steps=np.asarray(ts.steps, float)),
      env_state=dict(obs=to_np(es.obs), reward=to_np(es.reward),
                     done=f(es.done), qpos=to_np(es.data.qpos),
                     qvel=to_np(es.data.qvel), act=to_np(es.data.act))))


def make_sac(dtype=torch.float64) -> SAC:
  env = PoseEnv(NPZ[2], dtype=dtype, **KWARGS)
  env.far_th = FAR_TH
  return SAC(env, SACConfig(**CFG), device="cpu")


@pytest.fixture(scope="module")
def run():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pose import PoseEnv as JaxPoseEnv
    from myosuite_mjx_tpu.train import sac as jsac_mod
    jenv = JaxPoseEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
    jenv.far_th = FAR_TH
    jcfg = jsac_mod.SACConfig(**CFG)
    jsac = jsac_mod.SAC(jenv, jcfg)
    step = jax.jit(jsac.train_step)
    ts = [as_float64(jax.jit(jsac.init, static_argnums=0)(0))]
    metrics = []
    for _ in range(3):
      nxt, m = step(ts[-1])
      ts.append(nxt)
      metrics.append(m)
    sac = make_sac()
    yield types.SimpleNamespace(
        jmod=jsac_mod, jsac=jsac, sac=sac, ts=[_np_tree(t) for t in ts],
        metrics=[_np_tree(m) for m in metrics],
        draws=[jax_draws(t, jcfg, sac.act_dim) for t in ts[:3]])


@pytest.fixture(scope="module")
def stepped(run):
  """The port's step from each carried JAX state, and its own second step
  from its first."""
  sac = run.sac
  out, metrics = [], []
  for i in range(3):
    st, m = sac.train_step_from(sac_state_from_numpy(sac, run.ts[i]),
                                run.draws[i])
    out.append(port_parts(st))
    metrics.append(m)
    if i == 0:
      own, _ = sac.train_step_from(st, run.draws[1])
      own = port_parts(own)
  return types.SimpleNamespace(parts=out, metrics=metrics, own=own)


def test_carry_of_the_init_state_is_exact(run):
  """sac_state_from_numpy round trip: the carried state, written back in
  the JAX layout, is the JAX state."""
  ts = run.ts[0]
  assert_tree_close(port_parts(sac_state_from_numpy(run.sac, ts)),
                    jax_parts(ts), "init", 0.0)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("i", [0, 1, 2], ids=["before_learning_starts",
                                              "after", "buffer_wraps"])
def test_train_step_matches_jax(run, stepped, i, part):
  assert_tree_close(stepped.parts[i][part], jax_parts(run.ts[i + 1])[part],
                    part, STATE_RTOL)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("i", [0, 1, 2], ids=["before_learning_starts",
                                              "after", "buffer_wraps"])
def test_train_step_metrics_match_jax(run, stepped, i, name):
  assert_close(stepped.metrics[i][name], run.metrics[i][name], what=name,
               **STEP_TOL)


def test_ports_own_second_step_matches_jax(run, stepped):
  assert_tree_close(stepped.own, jax_parts(run.ts[2]), "state", STATE_RTOL)


def test_the_steps_reach_what_they_are_for(run, stepped):
  """Some transitions are terminal; the third insert wraps the ring."""
  assert 0 < to_np(run.ts[3].buffer["done"]).sum() < CFG["buffer_size"]
  cur = stepped.parts[2]["cursor"]
  assert (cur["buf_pos"], cur["buf_full"]) == (4.0, 1.0)
  assert float(stepped.metrics[2]["buffer_size"]) == CFG["buffer_size"]


def test_updates_are_gated_before_learning_starts(run):
  """Before learning_starts, nets, target and all three Adam states stay
  as they were while the discarded updates' metrics are reported; from
  learning_starts on they move."""
  sac = run.sac
  st = sac_state_from_numpy(sac, run.ts[0])
  before = port_parts(st)
  st1, m = sac.train_step_from(st, run.draws[0])
  after = port_parts(st1)
  for part in ("actor_params", "q_params", "q_target", "log_alpha",
               "actor_opt", "q_opt", "alpha_opt"):
    assert_tree_close(after[part], before[part], part, 0.0)
  assert float(m["alpha"]) != 1.0          # the discarded temperature step
  st2, _ = sac.train_step_from(st1, run.draws[1])
  moved = port_parts(st2)
  for part in ("actor_params", "q_params", "q_target", "log_alpha"):
    with pytest.raises(AssertionError):
      assert_tree_close(moved[part], before[part], part, 0.0)


def test_nets_match_flax(run):
  ts = run.ts[2]
  st = sac_state_from_numpy(run.sac, ts)
  rng = np.random.default_rng(0)
  obs = rng.normal(0.0, 2.0, (64, st.env_state.obs.shape[-1]))
  act = rng.uniform(-1.0, 1.0, (64, run.sac.act_dim))
  mean, log_std = run.jsac.actor.apply(ts.actor_params, jnp.asarray(obs))
  pm, pls = st.actor_params(torch.as_tensor(obs))
  assert_close(pm, mean, what="mean", **FN_TOL)
  assert_close(pls, log_std, what="log_std", **FN_TOL)
  ref = run.jsac.q.apply(ts.q_params, jnp.asarray(obs), jnp.asarray(act))
  out = st.q_params(torch.as_tensor(obs), torch.as_tensor(act))
  for a, b in zip(out, ref):
    assert_close(a, b, what="q", **FN_TOL)


def test_tanh_sampler_logp_matches_jax(run):
  """Means large enough that 1 - a^2 hits its 1e-6 floor, and log-stds at
  and past the actor's clip."""
  rng = np.random.default_rng(1)
  mean = rng.normal(0.0, 4.0, (256, 5))
  log_std = rng.uniform(-21.0, 3.0, (256, 5))
  key = jax.random.PRNGKey(3)
  act, logp = run.jmod._sample_tanh(jnp.asarray(mean), jnp.asarray(log_std),
                                    key)
  eps = torch.as_tensor(np.array(jax.random.normal(key, mean.shape)))
  pa, plogp = sample_tanh(torch.as_tensor(mean), torch.as_tensor(log_std),
                          eps)
  assert (1.0 - to_np(pa) ** 2 < 1e-6).any()
  assert_close(pa, act, what="action", **FN_TOL)
  assert_close(plogp, logp, what="logp", **SAMPLER_TOL)


def test_draws_have_the_shapes_and_ranges_of_jax():
  sac = make_sac()
  g = torch.Generator().manual_seed(0)
  ts = sac.init(generator=g)
  d = sac.draw(ts, g)
  N, U, M, A = 8, 2, 16, sac.act_dim
  assert d["eps_act"].shape == d["uniform_act"].shape == (N, A)
  assert d["mb_idx"].shape == (U, M)
  assert d["eps_next"].shape == d["eps_pi"].shape == (U, M, A)
  assert int(d["mb_idx"].max()) < N        # size after the first insert
  assert float(d["uniform_act"].abs().max()) <= 1.0


def test_float32_train_keeps_dtypes_and_host_cursor():
  sac = make_sac(torch.float32)
  seen = []
  ts, history = sac.train(3 * 8, seed=0, check_every=2,
                          progress=lambda it, m: seen.append(it))
  assert seen == [0, 1, 2] and len(history) == 3
  assert (ts.buf_pos, ts.buf_full, ts.steps) == (4, True, 24)
  assert all(v.dtype == torch.float32 for v in ts.buffer.values())
  assert ts.log_alpha.dtype == torch.float32
  for rec in history:
    assert all(np.isfinite(v) for v in rec.values())
