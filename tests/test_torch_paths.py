"""Offline path evaluation (``utils/paths.py``): the port against the JAX
module on hand11 under myoHandPoseFixed-v0's task, float64.

The observations come from a port rollout on the CPU (seeded actions); the
JAX module scores the same arrays through its own env (no compile: its
reward is eager numpy). Checked: the obs layout, the obs codec round trip,
the re-scored rewards and done flags (dense and sparse, one path and a
batch of paths) within 1e-12 of JAX's, agreement with the online reward,
``truncate_paths``, ``evaluate_success`` with a logger, and
``paths2dataset``, all as in ``tests/test_pickle_and_paths.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import HAND_TARGET, NPZ, bare_envs_package
from myosuite_mjx_tpu.utils import paths as jpaths
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv
from myosuite_mjx_tpu_torch.utils import paths

KWARGS = dict(frame_skip=2, horizon=10, normalize_act=True, pose_thd=0.7,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])
TOL = dict(rtol=1e-12, atol=1e-12)
STEPS = 8


@pytest.fixture(scope="module")
def envs():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pose import PoseEnv as JPoseEnv
    jenv = JPoseEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
  return jenv, PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)


@pytest.fixture(scope="module")
def rollout(envs):
  """obs [3, T, obs_dim] and the online infos of 3 envs over STEPS steps."""
  penv = envs[1]
  g = torch.Generator().manual_seed(0)
  st = penv.reset(3, "cpu", g)
  acts = np.random.default_rng(1).uniform(0, 1, (STEPS, 3, penv.action_dim))
  obs, infos = [], {"solved": [], "rwd_dense": [], "rwd_sparse": []}
  for a in acts:
    st = penv.step(st, torch.as_tensor(a), g)
    obs.append(st.obs.numpy())
    for k in infos:
      infos[k].append(st.info[k].numpy())
  return (np.stack(obs, 1),
          {k: np.stack(v, 1) for k, v in infos.items()})


def test_obs_layout_and_codec_match_jax(envs, rollout):
  jenv, penv = envs
  layout = paths.obs_layout(penv, "cpu")
  assert layout == jpaths.obs_layout(jenv)
  obs = rollout[0]
  od = paths.obsvec2obsdict(penv, obs, "cpu")
  jod = jpaths.obsvec2obsdict(jenv, obs)
  assert list(od) == list(jod) == penv.obs_keys
  for k in od:
    np.testing.assert_array_equal(od[k], jod[k])
  rebuilt = np.concatenate([od[k] for k in penv.obs_keys], -1)
  np.testing.assert_array_equal(rebuilt, obs)
  tod = paths.obsvec2obsdict(penv, torch.as_tensor(obs), "cpu")
  for k in od:
    np.testing.assert_array_equal(tod[k].numpy(), od[k])


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("trajs", [1, 3])
def test_compute_path_rewards_matches_jax(envs, rollout, mode, trajs):
  jenv, penv = envs
  obs = rollout[0][:trajs]
  mine = paths.compute_path_rewards(penv, {"observations": obs}, mode,
                                    device="cpu")
  ref = jpaths.compute_path_rewards(jenv, {"observations": obs}, mode)
  assert mine["rewards"].shape == ref["rewards"].shape
  np.testing.assert_allclose(mine["rewards"], ref["rewards"], **TOL)
  np.testing.assert_array_equal(mine["done"], ref["done"])


def test_rescored_rewards_agree_with_online_reward(envs, rollout):
  penv = envs[1]
  obs, infos = rollout
  out = paths.compute_path_rewards(penv, {"observations": obs[:1]},
                                   device="cpu")
  assert out["rewards"].shape == (STEPS,)
  assert np.isfinite(out["rewards"]).all()
  # reward t describes the transition into t + 1
  np.testing.assert_allclose(out["rewards"][:-1], infos["rwd_dense"][0, 1:],
                             **TOL)


class _Logger:
  def __init__(self):
    self.kv = {}

  def log_kv(self, k, v):
    self.kv[k] = v


def test_success_truncate_and_dataset_match_jax():
  rng = np.random.default_rng(2)
  ps = [{"env_infos": {"solved": rng.integers(0, 2, 10).astype(float),
                       "rwd_dense": rng.normal(size=10),
                       "rwd_sparse": rng.normal(size=10)},
         "done": np.zeros(10, bool), "rewards": rng.normal(size=10)}
        for _ in range(5)]
  lp, lj = _Logger(), _Logger()
  assert paths.evaluate_success(ps, lp) == jpaths.evaluate_success(ps, lj)
  assert lp.kv == lj.kv and len(lp.kv) == 3
  p = {"env_infos": {"solved": np.zeros(10), "rwd_dense": np.zeros(10),
                     "rwd_sparse": np.zeros(10)}, "done": np.zeros(10, bool)}
  p2 = {"env_infos": {"solved": np.ones(10), "rwd_dense": np.ones(10),
                      "rwd_sparse": np.ones(10)}, "done": np.zeros(10, bool)}
  assert paths.evaluate_success([p, p2]) == 50.0
  ds, dj = paths.paths2dataset(ps), jpaths.paths2dataset(ps)
  assert sorted(ds) == sorted(dj)
  np.testing.assert_array_equal(ds["rewards"], dj["rewards"])
  np.testing.assert_array_equal(ds["env_infos"]["solved"],
                                dj["env_infos"]["solved"])
  for done in ([False] * 6 + [True] * 4, [False] * 10, [True] * 10):
    mk = lambda: {"done": np.array(done), "rewards": np.arange(10.0)}
    a, b = paths.truncate_paths([mk()])[0], jpaths.truncate_paths([mk()])[0]
    assert a.get("terminated") == b.get("terminated")
    np.testing.assert_array_equal(a["rewards"], b["rewards"])
  p3 = {"done": np.array([False] * 6 + [True] * 4),
        "rewards": np.arange(10.0)}
  out3 = paths.truncate_paths([p3])[0]
  assert out3["terminated"] is True
  assert len(out3["rewards"]) == 8
