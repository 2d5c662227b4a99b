"""PPO parity: the port's learner against the JAX package's, float64, hand11,
and the port's checkpoint round trip.

hand11 with the myoHandPoseFixed-v0 task kwargs, N = 8 envs, unroll 3,
data_groups 2, num_minibatches 2, update_epochs 2, hidden (16,), frame_skip
2 and horizon 3: every env autoresets at the horizon inside the first
rollout, and the termination threshold sits next to hand11's initial pose
distance (0.8642), so that some envs also terminate early. Reward
normalization is on.

The tests reproduce JAX's draws from its key schedule (``ppo.py:213``,
``:191``, ``:184``, ``:296-299``) and hand them to ``PPO.train_step_from``;
JAX states are carried into the port with ``train_state_from_numpy``.

Tolerances: after a train step, 1e-6 relative for metrics and, for state,
1e-6 of each array's largest entry (``assert_tree_close``); 1e-12 for the
actor-critic's outputs. The JAX trainer is given a float64 copy of
its init state (flax keeps Dense params in float32 even with x64 on).
"""
from __future__ import annotations

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HAND_TARGET, NPZ, as_float64, assert_close,
                          assert_tree_close, bare_envs_package, to_np,
                          tree_tensors)
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv
from myosuite_mjx_tpu_torch.train import checkpoint
from myosuite_mjx_tpu_torch.train.ppo import (PPO, PPOConfig, flax_params,
                                              train_state_from_numpy)

FAR_TH = 0.8645
KWARGS = dict(frame_skip=2, horizon=3, normalize_act=True, pose_thd=0.8641,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])
CFG = dict(num_envs=8, unroll_length=3, data_groups=2, num_minibatches=2,
           update_epochs=2, hidden=(16,))
STEP_TOL = dict(rtol=1e-6, atol=0)       # metrics, element-wise
STATE_RTOL = 1e-6                         # state, of each array's largest
FN_TOL = dict(rtol=1e-12, atol=1e-12)
PARTS = ("params", "opt_state", "env_state", "steps", "obs_norm", "ret_norm",
         "ret_accum")
METRICS = ("loss", "reward_mean", "solved_frac")
EVAL_STEPS = 4


def jax_draws(key, cfg, act_dim: int) -> dict:
  """The noise and group-local permutations JAX's train_step draws."""
  G = min(cfg.data_groups, cfg.num_envs)
  ng = cfg.num_envs // G * cfg.unroll_length
  key, k_roll = jax.random.split(key)
  noise = []
  for _ in range(cfg.unroll_length):
    k_roll, k_act = jax.random.split(k_roll)
    noise.append(jax.random.normal(k_act, (cfg.num_envs, act_dim)))
  perms = []
  for _ in range(cfg.update_epochs):
    key, k_perm = jax.random.split(key)
    perms.append(jax.vmap(lambda k: jax.random.permutation(k, ng))(
        jax.random.split(k_perm, G)))
  return dict(noise=torch.as_tensor(np.stack(noise)),
              perms=torch.as_tensor(np.stack(perms)))


def _np_tree(x):
  return jax.tree.map(np.asarray, x)


def make_ppo(dtype=torch.float64) -> PPO:
  env = PoseEnv(NPZ[2], dtype=dtype, **KWARGS)
  env.far_th = FAR_TH
  return PPO(env, PPOConfig(**CFG), device="cpu")


@pytest.fixture(scope="module")
def run():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pose import PoseEnv as JaxPoseEnv
    from myosuite_mjx_tpu.train import ppo as jppo_mod
    jenv = JaxPoseEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
    jenv.far_th = FAR_TH
    jcfg = jppo_mod.PPOConfig(**CFG)
    jppo = jppo_mod.PPO(jenv, jcfg)
    step = jax.jit(jppo.train_step)
    # init's vmapped reset runs op by op unless jitted
    ts0 = as_float64(jax.jit(jppo.init, static_argnums=0)(0))
    ts1, m1 = step(ts0)
    ts2, m2 = step(ts1)
    e1 = jax.jit(lambda t: jppo.eval_step(t, num_episodes_steps=EVAL_STEPS,
                                          num_envs=4))(ts1)
    ppo = make_ppo()
    A = ppo.act_dim
    yield types.SimpleNamespace(
        jax_ppo=jppo, ppo=ppo, ts=[_np_tree(t) for t in (ts0, ts1, ts2)],
        metrics=[_np_tree(m) for m in (m1, m2)], eval=_np_tree(e1),
        draws=[jax_draws(t.key, jcfg, A) for t in (ts0, ts1)])


def _carried(run, i: int) -> dict:
  return checkpoint._to_tree(train_state_from_numpy(run.ppo, run.ts[i]))


@pytest.fixture(scope="module")
def stepped(run):
  ppo = run.ppo
  p1, pm1 = ppo.train_step_from(train_state_from_numpy(ppo, run.ts[0]),
                                **run.draws[0])
  own = [checkpoint._to_tree(p1)]
  p2, pm2 = ppo.train_step_from(p1, **run.draws[1])
  own.append(checkpoint._to_tree(p2))
  q2, qm2 = ppo.train_step_from(train_state_from_numpy(ppo, run.ts[1]),
                                **run.draws[1])
  _, _, traj = ppo.rollout(train_state_from_numpy(ppo, run.ts[0]),
                           run.draws[0]["noise"])
  return types.SimpleNamespace(own=own, metrics=[pm1, pm2],
                               carried=(checkpoint._to_tree(q2), qm2),
                               traj=traj)


def test_rollout_autoresets_and_terminates(stepped):
  done = to_np(stepped.traj["done"])           # [T, N]
  assert done.any(axis=0).all(), "every env ends an episode (horizon 3)"
  assert done[:-1].any(), "some env terminates before the horizon"


def test_carry_of_the_init_state_is_exact(run):
  ts = run.ts[0]
  st = train_state_from_numpy(run.ppo, ts)
  assert_tree_close(flax_params(st.params), ts.params, "params", 0.0)
  assert_close(st.env_state.obs, ts.env_state.obs, rtol=0, atol=0)
  for f in ("mean", "var", "count"):
    assert_close(getattr(st.ret_norm, f), getattr(ts.ret_norm, f), rtol=0,
                 atol=0)


def test_actor_critic_layer_order_matches_flax(run):
  """flax names the policy's Dense_0..Dense_L before the value's."""
  ts = run.ts[1]
  st = train_state_from_numpy(run.ppo, ts)
  obs = np.random.default_rng(0).normal(0.0, 2.0, (64, 54))
  ref = run.jax_ppo.net.apply(ts.params, jnp.asarray(obs))
  out = st.params(torch.as_tensor(obs))
  for name, a, b in zip(("mean", "log_std", "value"), out, ref):
    assert_close(a, b, what=name, **FN_TOL)


@pytest.mark.parametrize("part", PARTS)
def test_train_step_matches_jax(run, stepped, part):
  assert_tree_close(stepped.own[0][part], _carried(run, 1)[part], part,
                    STATE_RTOL)


@pytest.mark.parametrize("name", METRICS)
def test_train_step_metrics_match_jax(run, stepped, name):
  assert_close(stepped.metrics[0][name], run.metrics[0][name], what=name,
               **STEP_TOL)


@pytest.mark.parametrize("part", PARTS)
def test_second_step_from_carried_jax_state_matches_jax(run, stepped, part):
  """Checks the carry of Adam, both running norms, ret_accum and the env
  state mid-episode."""
  assert_tree_close(stepped.carried[0][part], _carried(run, 2)[part], part,
                    STATE_RTOL)


@pytest.mark.parametrize("name", METRICS)
def test_second_step_metrics_match_jax(run, stepped, name):
  for metrics in (stepped.carried[1], stepped.metrics[1]):
    assert_close(metrics[name], run.metrics[1][name], what=name, **STEP_TOL)


def test_ports_own_second_step_matches_jax(run, stepped):
  assert_tree_close(stepped.own[1], _carried(run, 2), "state", STATE_RTOL)


def test_eval_step_matches_jax(run):
  out = run.ppo.eval_step(train_state_from_numpy(run.ppo, run.ts[1]),
                          num_episodes_steps=EVAL_STEPS, num_envs=4)
  assert sorted(out) == sorted(run.eval)
  for k, v in run.eval.items():
    assert_close(out[k], v, what=k, **STEP_TOL)
  assert float(out["eval_episodes"]) >= 4


def test_minibatch_count_is_the_gcd_with_a_warning():
  env = PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)
  ppo = PPO(env, PPOConfig(**{**CFG, "num_minibatches": 8}), device="cpu")
  assert ppo.layout() == (2, 12, 4)
  g = torch.Generator().manual_seed(0)
  with pytest.warns(UserWarning, match="num_minibatches adjusted 8 -> 4"):
    ppo.train_step(ppo.init(generator=g), g)
  with pytest.raises(ValueError):
    PPO(env, PPOConfig(**{**CFG, "num_envs": 6, "data_groups": 4}),
        device="cpu").layout()


def test_draws_are_group_local_permutations():
  ppo = make_ppo()
  d = ppo.draw(torch.Generator().manual_seed(5))
  assert d["noise"].shape == (3, 8, 21)
  assert d["perms"].shape == (2, 2, 12)      # epochs, groups, group size
  sorted_perms = d["perms"].sort(dim=-1).values
  assert torch.equal(sorted_perms, torch.arange(12).expand(2, 2, 12))
  assert not torch.equal(d["perms"][0, 0], d["perms"][0, 1])


def test_global_norm_clip_is_optax_without_epsilon(run):
  import optax
  from myosuite_mjx_tpu_torch.train.ppo import clip_by_global_norm
  rng = np.random.default_rng(3)
  grads = [rng.normal(size=(4, 3)), rng.normal(size=3)]
  for max_norm in (0.5, 100.0):
    params = [torch.zeros(g.shape, dtype=torch.float64, requires_grad=True)
              for g in grads]
    for p, g in zip(params, grads):
      p.grad = torch.as_tensor(g.copy())
    clip_by_global_norm(params, max_norm)
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    for p, r in zip(params, ref):
      assert_close(p.grad, r, **FN_TOL)


_INT_FIELDS = {".env_state.steps", ".env_state.data.ne_active",
               ".env_state.data.ncon_dropped",
               ".env_state.data.contact.geom1",
               ".env_state.data.contact.geom2", ".steps"}
_BOOL_FIELDS = {".env_state.done", ".env_state.info.solved",
                ".env_state.info.terminated", ".env_state.info.truncated"}


def test_float32_step_keeps_every_dtype():
  """No float64 constant promotes the float32 learner state."""
  ppo = make_ppo(torch.float32)
  g = torch.Generator().manual_seed(0)
  st, metrics = ppo.train_step(ppo.init(generator=g), g)
  for name, x in tree_tensors(checkpoint._to_tree(st)):
    want = (torch.int64 if name == ".steps" else
            torch.int32 if name in _INT_FIELDS else
            torch.bool if name in _BOOL_FIELDS else torch.float32)
    assert x.dtype == want, f"{name}: {x.dtype}"
  for k, v in metrics.items():
    assert v.dtype == torch.float32 and math.isfinite(float(v)), k


# ---- checkpoint ----------------------------------------------------------

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
  """A PPO state after one step, with its generator, saved to disk."""
  ppo = make_ppo()
  g = torch.Generator().manual_seed(0)
  st, _ = ppo.train_step(ppo.init(generator=g), g)
  path = str(tmp_path_factory.mktemp("ckpt") / "ppo.pt")
  checkpoint.save(path, {"state": st, "generator": g})
  return ppo, path, checkpoint._to_tree({"state": st, "generator": g})


def _template(ppo):
  g = torch.Generator().manual_seed(99)
  return {"state": ppo.init(generator=g), "generator": g}


def test_restore_then_step_equals_the_uninterrupted_run(saved):
  ppo, path, tree = saved
  restored = checkpoint.restore(path, _template(ppo))
  assert_tree_close(checkpoint._to_tree(restored), tree, "restored", 0.0)
  # the uninterrupted run, from the saved tree loaded a second time
  again = checkpoint.restore(path, _template(ppo))
  a, ma = ppo.train_step(restored["state"], restored["generator"])
  b, mb = ppo.train_step(again["state"], again["generator"])
  assert_tree_close(checkpoint._to_tree(a), checkpoint._to_tree(b), "next",
                    0.0)
  for k in ma:
    assert float(ma[k]) == float(mb[k]), k


def _save_without(tree, drop: tuple, tmp_path):
  node = tree
  for k in drop[:-1]:
    node = node[k]
  del node[drop[-1]]
  out = str(tmp_path / "partial.pt")
  torch.save(tree, out)
  return out


@pytest.mark.parametrize("drop", [
    ("state", "params", "pi.0.weight"), ("state", "params", "log_std"),
    ("state", "opt_state", "state", "1", "exp_avg")],
                         ids=lambda d: ".".join(d))
def test_a_missing_parameter_leaf_raises(saved, tmp_path, drop):
  ppo, path, _ = saved
  partial = _save_without(torch.load(path, weights_only=True), drop, tmp_path)
  with pytest.raises(RuntimeError, match="missing parameter leaves"):
    checkpoint.restore(partial, _template(ppo))


def test_a_missing_state_leaf_keeps_its_template_value(saved, tmp_path):
  ppo, path, tree = saved
  partial = _save_without(torch.load(path, weights_only=True),
                          ("state", "ret_accum"), tmp_path)
  template = _template(ppo)
  restored = checkpoint.restore(partial, template)
  assert restored["state"].ret_accum is template["state"].ret_accum
  assert_close(restored["state"].obs_norm.mean,
               tree["state"]["obs_norm"]["mean"], rtol=0, atol=0)


def test_restore_checks_shape_and_dtype(saved):
  ppo, path, _ = saved
  other = PPO(ppo.env, PPOConfig(**{**CFG, "num_envs": 4}), device="cpu")
  with pytest.raises(ValueError, match="template"):
    checkpoint.restore(path, _template(other))
  f32 = make_ppo(torch.float32)
  with pytest.raises(ValueError, match="float32"):
    checkpoint.restore(path, _template(f32))
