"""NPG parity: the port's learner against the JAX package's, float64, hand11.

hand11 with the myoHandPoseFixed-v0 task kwargs, N = 4 trajectories of
horizon 3, frame_skip 2 (keeps the JAX compile short), hidden (16,),
vf_hidden (16,), vf_batch_size 4. The termination and success thresholds
are set next to hand11's initial pose distance (0.8642), so that some
episodes end inside the rollout and the live mask, the dead steps in the
advantage statistics and the solved counts are all exercised.

The JAX trainer draws from its key; the port takes draws as tensors. The
tests reproduce JAX's draws from its key schedule (``npg.py:162``, ``:146``,
``:150``, ``:293-296``) and hand them to ``NPG.train_step_from``. A JAX state
is carried into the port with ``npg_state_from_numpy``, and the port's state
after a step is compared with the JAX state after the same step, carried.

Tolerances: after a train step (the rollouts agree to ~1e-9, which CG and
Adam carry into the step), 1e-6 relative for metrics and, for state, 1e-6
of each array's largest entry (``assert_tree_close``); 1e-12 for
the MLP, log-density and normalization functions. flax keeps Dense params
in float32 even with x64 on, so the JAX trainer is given a float64 copy of
its init state (``as_float64``).
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
from myosuite_mjx_tpu_torch.train.npg import (NPG, GaussianMLP, NPGConfig,
                                              npg_state_from_numpy)
from myosuite_mjx_tpu_torch.train.ppo import (RunningNorm, _flax_leaves,
                                              dense, flax_params,
                                              gaussian_logp, load_flax_params)

# hand11's initial pose distance is 0.8642; an episode ends past FAR_TH and
# a step is solved below POSE_THD
FAR_TH = 0.8645
KWARGS = dict(frame_skip=2, horizon=3, normalize_act=True, pose_thd=0.8641,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])
CFG = dict(num_envs=4, hidden=(16,), vf_hidden=(16,), vf_batch_size=4)
STEP_TOL = dict(rtol=1e-6, atol=0)       # metrics, element-wise
STATE_RTOL = 1e-6                         # state, of each array's largest
FN_TOL = dict(rtol=1e-12, atol=1e-12)
PARTS = ("params", "vf_params", "vf_opt", "obs_norm", "steps")
METRICS = ("stoc_pol_mean", "reward_mean", "solved_frac", "kl_step_alpha",
           "vf_loss", "grad_norm")


def jax_draws(key, cfg, T: int, act_dim: int) -> dict:
  """The noise and permutations JAX's train_step draws from ``key``."""
  N = cfg.num_envs
  key, _, k_roll = jax.random.split(key, 3)
  noise = []
  for _ in range(T):
    k_roll, k_act = jax.random.split(k_roll)
    noise.append(jax.random.normal(k_act, (N, act_dim)))
  key, k_vf = jax.random.split(key)
  perms = [jax.random.permutation(k, N * T)
           for k in jax.random.split(k_vf, cfg.vf_epochs)]
  return dict(noise=torch.as_tensor(np.stack(noise)),
              perms=torch.as_tensor(np.stack(perms)))


def _np_tree(x):
  return jax.tree.map(np.asarray, x)




@pytest.fixture(scope="module")
def run():
  """Both learners on the same carried states and draws: two JAX train
  steps and an eval, compiled once for the file."""
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pose import PoseEnv as JaxPoseEnv
    from myosuite_mjx_tpu.train import npg as jnpg_mod
    from myosuite_mjx_tpu.train import ppo as jppo_mod
    jenv = JaxPoseEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
    jenv.far_th = FAR_TH
    jcfg = jnpg_mod.NPGConfig(**CFG)
    jnpg = jnpg_mod.NPG(jenv, jcfg)
    step = jax.jit(jnpg.train_step)
    ts0 = as_float64(jnpg.init(seed=0))
    ts1, m1 = step(ts0)
    ts2, m2 = step(ts1)
    e1 = jax.jit(lambda t: jnpg.eval_step(t, num_envs=4))(ts1)
    penv = PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)
    penv.far_th = FAR_TH
    pnpg = NPG(penv, NPGConfig(**CFG), device="cpu")
    T, A = jnpg.horizon, penv.action_dim
    yield types.SimpleNamespace(
        jax_npg=jnpg, jax_ppo=jppo_mod, npg=pnpg,
        ts=[_np_tree(t) for t in (ts0, ts1, ts2)],
        metrics=[_np_tree(m) for m in (m1, m2)], eval=_np_tree(e1),
        draws=[jax_draws(t.key, jcfg, T, A) for t in (ts0, ts1)])


@pytest.fixture(scope="module")
def stepped(run):
  """The port's states: its own two steps from the carried init state, and
  one step from the carried JAX state after step 1."""
  npg = run.npg
  p1, pm1 = npg.train_step_from(npg_state_from_numpy(npg, run.ts[0]),
                                **run.draws[0])
  own = [checkpoint._to_tree(p1)]
  p2, pm2 = npg.train_step_from(p1, **run.draws[1])
  own.append(checkpoint._to_tree(p2))
  q2, qm2 = npg.train_step_from(npg_state_from_numpy(npg, run.ts[1]),
                                **run.draws[1])
  traj = npg.rollout(npg_state_from_numpy(npg, run.ts[0]),
                     run.draws[0]["noise"])
  return types.SimpleNamespace(own=own, metrics=[pm1, pm2],
                               carried=(checkpoint._to_tree(q2), qm2),
                               traj=traj)


def _carried(run, i: int) -> dict:
  return checkpoint._to_tree(npg_state_from_numpy(run.npg, run.ts[i]))


def test_rollout_has_live_and_dead_steps(run, stepped):
  live = to_np(stepped.traj["live"])
  assert 0 < live.sum() < live.size, live
  assert (live[-1] == 0).any() and (live[-1] == 1).any(), live
  assert to_np(stepped.traj["solved"]).sum() > 0


def test_carry_of_the_init_state_is_exact(run):
  ts = run.ts[0]
  st = npg_state_from_numpy(run.npg, ts)
  for port, ref in ((st.params, ts.params), (st.vf_params, ts.vf_params)):
    assert_tree_close(flax_params(port), ref, "params", 0.0)
  adam = ts.vf_opt[0]
  for p, path, transposed in _flax_leaves(st.vf_params):
    s = st.vf_opt.state[p]
    for mine, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
      ref = np.asarray(theirs["params"][path[0]][path[1]])
      assert_close(s[mine], ref.T if transposed else ref, rtol=0, atol=0)
    assert float(s["step"]) == float(adam.count) == 0
  for f in ("mean", "var", "count"):
    assert_close(getattr(st.obs_norm, f), getattr(ts.obs_norm, f), rtol=0,
                 atol=0)
  assert int(st.steps) == int(ts.steps) == 0


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
  """Checks the carry of Adam's moments and count and of the obs norm."""
  assert_tree_close(stepped.carried[0][part], _carried(run, 2)[part], part,
                    STATE_RTOL)


@pytest.mark.parametrize("name", METRICS)
def test_second_step_metrics_match_jax(run, stepped, name):
  assert_close(stepped.carried[1][name], run.metrics[1][name], what=name,
               **STEP_TOL)
  assert_close(stepped.metrics[1][name], run.metrics[1][name], what=name,
               **STEP_TOL)


def test_ports_own_second_step_matches_jax(run, stepped):
  assert_tree_close(stepped.own[1], _carried(run, 2), "state", STATE_RTOL)


def test_eval_step_matches_jax(run):
  out = run.npg.eval_step(npg_state_from_numpy(run.npg, run.ts[1]),
                          num_envs=4)
  assert sorted(out) == sorted(run.eval)
  for k, v in run.eval.items():
    assert_close(out[k], v, what=k, **STEP_TOL)


def test_mlps_match_flax(run):
  ts = run.ts[1]
  st = npg_state_from_numpy(run.npg, ts)
  rng = np.random.default_rng(0)
  obs = rng.normal(0.0, 2.0, (64, 11 * 3 + 21))
  tfrac = rng.uniform(0.0, 1.0, 64)
  mean, log_std = run.jax_npg.net.apply(ts.params, jnp.asarray(obs))
  pmean, plog_std = st.params(torch.as_tensor(obs))
  assert_close(pmean, mean, **FN_TOL)
  assert_close(plog_std, log_std, **FN_TOL)
  v = run.jax_npg.vf.apply(ts.vf_params, jnp.asarray(obs),
                           jnp.asarray(tfrac))
  assert_close(st.vf_params(torch.as_tensor(obs), torch.as_tensor(tfrac)), v,
               **FN_TOL)


def test_log_std_floor_matches_flax(run):
  """A log_std below min_log_std is floored in both packages."""
  ts = run.ts[0]
  params = jax.tree.map(np.array, ts.params)
  params["params"]["log_std"][:5] = -3.0
  policy = GaussianMLP(54, 21, (16,), dtype=torch.float64, device="cpu",
                       generator=torch.Generator())
  load_flax_params(policy, params)
  _, ref = run.jax_npg.net.apply(params, jnp.zeros(54))
  _, log_std = policy(torch.zeros(54, dtype=torch.float64))
  assert_close(log_std, ref, rtol=0, atol=0)
  assert float(log_std.detach().min()) == -1.0


def test_gaussian_logp_matches_jax(run):
  rng = np.random.default_rng(1)
  mean, act = rng.normal(size=(2, 32, 21))
  log_std = rng.normal(-0.5, 0.3, 21)
  ref = run.jax_ppo._gaussian_logp(jnp.asarray(mean), jnp.asarray(log_std),
                                   jnp.asarray(act))
  out = gaussian_logp(*(torch.as_tensor(x) for x in (mean, log_std, act)))
  assert_close(out, ref, **FN_TOL)


@pytest.mark.parametrize("shape", [(54,), ()])
def test_running_norm_matches_jax(run, shape):
  """Welford merge with ddof-0 batch variance, count from 1e-4, clip."""
  rng = np.random.default_rng(2)
  JNorm = run.jax_ppo.RunningNorm
  ref = JNorm.create(shape[0] if shape else ())
  ours = RunningNorm.create(shape[0] if shape else (), torch.float64, "cpu")
  for scale in (1.0, 30.0):
    batch = rng.normal(3.0, scale, (3, 4) + shape)
    ref = ref.update(jnp.asarray(batch))
    ours = ours.update(torch.as_tensor(batch))
    for f in ("mean", "var", "count"):
      assert_close(getattr(ours, f), getattr(ref, f), what=f, **FN_TOL)
  x = rng.normal(3.0, 100.0, (16,) + shape)
  assert_close(ours.apply(torch.as_tensor(x), 2.0),
               ref.apply(jnp.asarray(x), 2.0), **FN_TOL)


def test_dense_init_is_flax_lecun_normal():
  """A truncated normal of std sqrt(1/fan_in)/0.8796 cut at +-2 std, which
  keeps std sqrt(1/fan_in); zero bias. Torch's default init differs."""
  fan_in = 1000
  layer = dense(fan_in, 1000, torch.Generator().manual_seed(0),
                torch.float64, "cpu")
  w = to_np(layer.weight)
  target = math.sqrt(1.0 / fan_in)
  assert abs(w.std() / target - 1.0) < 0.01, w.std()
  assert abs(w.mean()) < 0.01 * target
  assert np.abs(w).max() <= 2.0 * target / 0.87962566103423978
  assert (to_np(layer.bias) == 0).all()
  # the same statistics as flax's own Dense init at this width
  import flax.linen as fnn
  kernel = np.asarray(fnn.Dense(1000).init(
      jax.random.PRNGKey(0), jnp.zeros(fan_in))["params"]["kernel"])
  assert abs(w.std() / kernel.std() - 1.0) < 0.01
  ref_layer = torch.nn.Linear(fan_in, 1000)
  assert abs(ref_layer.weight.std().item() / target - 1.0) > 0.3


def test_init_draws_only_from_the_generator():
  env = PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)
  npg = NPG(env, NPGConfig(**CFG), device="cpu")
  a = npg.init(seed=3)
  torch.manual_seed(123)
  b = npg.init(seed=3)
  c = npg.init(seed=4)
  for x, y, z in zip(a.params.parameters(), b.params.parameters(),
                     c.params.parameters()):
    assert torch.equal(x, y)
  assert not torch.equal(a.params.layers[0].weight, c.params.layers[0].weight)


def test_draws_come_from_the_generator():
  env = PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)
  npg = NPG(env, NPGConfig(**CFG), device="cpu")
  a, b = (npg.draw(torch.Generator().manual_seed(5)) for _ in range(2))
  assert a["noise"].shape == (3, 4, 21) and a["noise"].dtype == torch.float64
  assert torch.equal(a["noise"], b["noise"])
  assert torch.equal(a["perms"], b["perms"])
  assert a["perms"].shape == (2, 12)
  for perm in a["perms"]:
    assert torch.equal(perm.sort().values, torch.arange(12))


def test_float32_step_keeps_every_dtype():
  """No float64 constant promotes the float32 learner state."""
  env = PoseEnv(NPZ[2], dtype=torch.float32, **KWARGS)
  npg = NPG(env, NPGConfig(**CFG), device="cpu")
  g = torch.Generator().manual_seed(0)
  st = npg.init(generator=g)
  st, metrics = npg.train_step(st, g)
  tree = checkpoint._to_tree(st)
  names = []
  for name, x in tree_tensors(tree):
    names.append(name)
    want = torch.int64 if name == ".steps" else torch.float32
    assert x.dtype == want, f"{name}: {x.dtype}"
  assert len(names) == 5 + 4 + 3 * 4 + 3 + 1, names
  for k, v in metrics.items():
    assert v.dtype == torch.float32, k
    assert math.isfinite(float(v)), k


def test_train_returns_history_per_iteration(tmp_path):
  from myosuite_mjx_tpu_torch.train.metrics import MetricsWriter
  env = PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)
  npg = NPG(env, NPGConfig(**CFG), device="cpu")
  with MetricsWriter(str(tmp_path), tensorboard=False) as w:
    st, hist = npg.train(2 * 4 * 3, seed=0, eval_every=2, writer=w)
  assert len(hist) == 2 and int(st.steps) == 24
  assert set(METRICS) <= set(hist[0]) and "eval_success" in hist[1]
  assert "eval_success" not in hist[0]
  lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
  assert len(lines) == 2
