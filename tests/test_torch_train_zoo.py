"""Zoo, metrics and policy-export parity: the port against the JAX package.

The checked-in zoo pickles load in both packages unchanged and act alike
on the same observations (made with numpy from a seed, float64). Snapshots
written by the port from carried JAX states equal the JAX package's and
load in both. The metrics writer's jsonl records equal the JAX writer's
apart from ``wall``, and a non-finite metric stops training.

Tolerances: 1e-12 on actions (float64 on both sides; the pickles hold
float32 weights, which both promote).
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HAND_TARGET, NPZ, as_float64, assert_close,
                          bare_envs_package)
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv
from myosuite_mjx_tpu_torch.train import checkpoint, metrics, zoo
from myosuite_mjx_tpu_torch.train.npg import (NPG, NPGConfig,
                                              npg_state_from_numpy)
from myosuite_mjx_tpu_torch.train.ppo import (PPO, PPOConfig,
                                              train_state_from_numpy)

BASELINES = ("myoElbowPose1D6MFixed-v0", "myoElbowPose1D6MRandom-v0",
             "myoFingerPoseFixed-v0", "myoFingerReachFixed-v0",
             "myoHandKeyTurnFixed-v0", "myoHandObjHoldFixed-v0",
             "myoHandPoseFixed-v0", "myoHandReachFixed-v0",
             "myoLegStandRandom-v0")
ACT_TOL = dict(rtol=1e-12, atol=1e-12)
KWARGS = dict(frame_skip=2, horizon=3, normalize_act=True, pose_thd=0.7,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])


@pytest.fixture(scope="module")
def jax_train():
  """The JAX zoo, metrics, checkpoint and learners, and carried NPG and PPO
  states (hand11, float64) with some training statistics filled in."""
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pose import PoseEnv as JaxPoseEnv
    from myosuite_mjx_tpu.train import checkpoint as jckpt
    from myosuite_mjx_tpu.train import metrics as jmetrics
    from myosuite_mjx_tpu.train import npg as jnpg_mod
    from myosuite_mjx_tpu.train import ppo as jppo_mod
    from myosuite_mjx_tpu.train import zoo as jzoo
    jenv = JaxPoseEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
    npg_cfg = dict(num_envs=4, hidden=(16,), vf_hidden=(16,))
    ppo_cfg = dict(num_envs=2, data_groups=2, hidden=(16, 8))
    jnpg = jnpg_mod.NPG(jenv, jnpg_mod.NPGConfig(**npg_cfg))
    jppo = jppo_mod.PPO(jenv, jppo_mod.PPOConfig(**ppo_cfg))
    rng = np.random.default_rng(0)

    def with_stats(ts):
      obs_dim = ts.obs_norm.mean.shape[0]
      norm = ts.obs_norm.replace(
          mean=jnp.asarray(rng.normal(size=obs_dim)),
          var=jnp.asarray(rng.uniform(0.5, 2.0, obs_dim)))
      return ts.replace(obs_norm=norm, steps=ts.steps + 1200)

    nts = with_stats(as_float64(jnpg.init(seed=1)))
    pts = with_stats(as_float64(jax.jit(jppo.init, static_argnums=0)(2)))
    yield types.SimpleNamespace(
        zoo=jzoo, metrics=jmetrics, ckpt=jckpt, npg=jnpg, ppo=jppo,
        nts=nts, pts=pts,
        port_npg=NPG(PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS),
                     NPGConfig(**npg_cfg), device="cpu"),
        port_ppo=PPO(PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS),
                     PPOConfig(**ppo_cfg), device="cpu"))


def _obs(obs_dim: int, seed: int = 0) -> np.ndarray:
  return np.random.default_rng(seed).normal(0.0, 1.0, (64, obs_dim))


@pytest.mark.parametrize("env_id", BASELINES)
def test_checked_in_baseline_acts_as_in_jax(jax_train, env_id):
  ours = zoo.load_baseline(env_id, device="cpu", dtype=torch.float64)
  ref = jax_train.zoo.load_baseline(env_id)
  assert ours.env_id == ref.env_id == env_id
  snap = ours.snap
  obs_dim = (snap["layers"][0][0] if "layers" in snap
             else snap["params"]["params"]["Dense_0"]["kernel"]).shape[0]
  obs = _obs(obs_dim)
  act = ours.act(torch.as_tensor(obs))
  assert act.dtype == torch.float64 and act.shape[0] == 64
  assert_close(act, ref.act(jnp.asarray(obs)), **ACT_TOL)


def test_hand_pose_baseline_has_the_hand23_width():
  pol = zoo.load_baseline("myoHandPoseFixed-v0", device="cpu")
  assert pol.snap["format"] == "myosuite_mjx_tpu/policy-mlp-v1"
  assert [w.shape for w, _ in pol.snap["layers"]] == [(108, 32), (32, 32),
                                                     (32, 39)]
  assert pol.snap["in_clip"] == 10.0
  act = pol(torch.zeros(3, 108))
  assert act.shape == (3, 39) and act.dtype == torch.float32


def test_zoo_dir_is_the_jax_packages(jax_train, monkeypatch, tmp_path):
  assert os.path.samefile(zoo.ZOO_DIR, jax_train.zoo.ZOO_DIR)
  assert zoo.list_baselines() == jax_train.zoo.list_baselines()
  assert set(BASELINES) <= set(zoo.list_baselines())
  monkeypatch.setenv("MYOSUITE_TPU_ZOO", str(tmp_path))
  try:
    assert importlib.reload(zoo).ZOO_DIR == str(tmp_path)
    assert zoo.list_baselines() == []
    with pytest.raises(FileNotFoundError, match="no zoo baseline"):
      zoo.load_baseline("myoHandPoseFixed-v0")
  finally:
    monkeypatch.delenv("MYOSUITE_TPU_ZOO")
    importlib.reload(zoo)


def test_load_policy_rejects_a_non_snapshot(tmp_path):
  path = tmp_path / "x.pkl"
  path.write_bytes(pickle.dumps({"weights": 1}))
  with pytest.raises(ValueError, match="not a policy snapshot"):
    zoo.load_policy(str(path), device="cpu")


def _assert_snapshots_equal(a: dict, b: dict):
  assert sorted(a) == sorted(b)
  for k in a:
    x, y = a[k], b[k]
    if k == "params":
      jax.tree.map(np.testing.assert_array_equal, x, y)
    elif k == "layers":
      assert len(x) == len(y)
      for (w, c), (v, d) in zip(x, y):
        np.testing.assert_array_equal(w, v)
        np.testing.assert_array_equal(c, d)
    elif isinstance(y, np.ndarray):
      assert x.dtype == y.dtype, k
      np.testing.assert_array_equal(x, y, err_msg=k)
    else:
      assert x == y, k


def _round_trip(jax_train, tmp_path, kind: str):
  if kind == "npg":
    save, ours_ts = zoo.save_npg_snapshot, npg_state_from_numpy(
        jax_train.port_npg, jax.tree.map(np.asarray, jax_train.nts))
    ours = save(str(tmp_path / "ours.pkl"), jax_train.port_npg, ours_ts,
                "hand11")
    ref = jax_train.zoo.save_npg_snapshot(str(tmp_path / "ref.pkl"),
                                          jax_train.npg, jax_train.nts,
                                          "hand11")
  else:
    ours_ts = train_state_from_numpy(jax_train.port_ppo,
                                     jax.tree.map(np.asarray, jax_train.pts))
    ours = zoo.save_snapshot(str(tmp_path / "ours.pkl"), jax_train.port_ppo,
                             ours_ts, "hand11")
    ref = jax_train.zoo.save_snapshot(str(tmp_path / "ref.pkl"),
                                      jax_train.ppo, jax_train.pts, "hand11")
  return ours, ref


@pytest.mark.parametrize("kind", ["npg", "ppo"])
def test_snapshot_from_carried_state_equals_jax(jax_train, tmp_path, kind):
  ours, ref = _round_trip(jax_train, tmp_path, kind)
  _assert_snapshots_equal(ours, ref)
  with open(tmp_path / "ours.pkl", "rb") as f:
    _assert_snapshots_equal(pickle.load(f), ref)


@pytest.mark.parametrize("kind", ["npg", "ppo"])
def test_snapshot_acts_alike_in_both_packages(jax_train, tmp_path, kind):
  _round_trip(jax_train, tmp_path, kind)
  obs = _obs(54, seed=1) * 3.0
  ref = jax_train.zoo.load_policy(str(tmp_path / "ours.pkl"))
  ours = zoo.load_policy(str(tmp_path / "ref.pkl"), device="cpu",
                         dtype=torch.float64)
  assert_close(ours.act(torch.as_tensor(obs)), ref.act(jnp.asarray(obs)),
               **ACT_TOL)


def test_npg_snapshot_acts_as_the_live_policy(jax_train, tmp_path):
  """The folded normalization and clip reproduce the trainer's mean
  action."""
  npg = jax_train.port_npg
  ts = npg_state_from_numpy(npg, jax.tree.map(np.asarray, jax_train.nts))
  zoo.save_npg_snapshot(str(tmp_path / "s.pkl"), npg, ts, "hand11")
  pol = zoo.load_policy(str(tmp_path / "s.pkl"), device="cpu",
                        dtype=torch.float64)
  obs = torch.as_tensor(_obs(54, seed=2) * 5.0)
  with torch.no_grad():
    mean, _ = ts.params(ts.obs_norm.apply(obs, npg.cfg.norm_clip))
  # the snapshot stores float32 weights and normalization
  assert_close(pol.act(obs), mean.clamp(-1, 1), rtol=0, atol=1e-5)


def test_save_params_writes_the_jax_packages_tree(jax_train, tmp_path):
  ts = npg_state_from_numpy(jax_train.port_npg,
                            jax.tree.map(np.asarray, jax_train.nts))
  checkpoint.save_params(str(tmp_path / "ours.pkl"), ts.params)
  jax_train.ckpt.save_params(str(tmp_path / "ref.pkl"), jax_train.nts.params)
  with open(tmp_path / "ours.pkl", "rb") as f, \
      open(tmp_path / "ref.pkl", "rb") as g:
    jax.tree.map(np.testing.assert_array_equal, pickle.load(f),
                 pickle.load(g))


# ---- metrics -------------------------------------------------------------

RECORDS = [(100, {"loss": 0.5, "reward_mean": -3.25, "iter": 1}),
           (200, {"loss": np.float32(0.25), "note": "resumed"}),
           (300, {"loss": torch.tensor(0.125), "solved_frac": 1}),
           (400, {"loss": 0.0625})]


def _records(path) -> list:
  with open(os.path.join(path, "metrics.jsonl")) as f:
    out = [json.loads(ln) for ln in f]
  for rec in out:
    assert isinstance(rec.pop("wall"), float)
  return out


def _write(writer_cls, logdir, records, **kw):
  with writer_cls(str(logdir), tensorboard=False, **kw) as w:
    for step, m in records:
      w.write(step, m)


def test_jsonl_records_equal_the_jax_writers(jax_train, tmp_path):
  _write(metrics.MetricsWriter, tmp_path / "ours", RECORDS)
  _write(jax_train.metrics.MetricsWriter, tmp_path / "ref", RECORDS)
  assert _records(tmp_path / "ours") == _records(tmp_path / "ref")
  assert len(_records(tmp_path / "ours")) == 4


def test_truncate_after_keeps_one_monotonic_history(jax_train, tmp_path):
  for cls, d in ((metrics.MetricsWriter, "ours"),
                 (jax_train.metrics.MetricsWriter, "ref")):
    _write(cls, tmp_path / d, RECORDS)
    _write(cls, tmp_path / d, RECORDS[2:], truncate_after=200)
  ours = _records(tmp_path / "ours")
  assert ours == _records(tmp_path / "ref")
  assert [r["step"] for r in ours] == [100, 200, 300, 400]


def test_tensorboard_events_when_the_package_imports(tmp_path):
  try:
    import torch.utils.tensorboard  # noqa: F401
  except ImportError:
    has_tb = False
  else:
    has_tb = True
  with metrics.MetricsWriter(str(tmp_path), tensorboard=True) as w:
    w.write(1, {"loss": 1.0})
  events = [f for f in os.listdir(tmp_path) if f.startswith("events.")]
  assert bool(events) == has_tb
  assert len(_records(tmp_path)) == 1


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_non_finite_metric_raises_divergence(bad):
  metrics.check_finite({"loss": 1.0, "note": "x"})
  with pytest.raises(metrics.DivergenceError, match="loss"):
    metrics.check_finite({"loss": bad, "ok": 2.0}, where="iter 3")


def test_training_stops_on_a_non_finite_metric(jax_train, monkeypatch):
  npg = jax_train.port_npg
  real = npg.train_step

  def nan_step(ts, generator):
    ts, m = real(ts, generator)
    return ts, {**m, "vf_loss": m["vf_loss"] * float("nan")}

  monkeypatch.setattr(npg, "train_step", nan_step)
  with pytest.raises(metrics.DivergenceError, match="NPG iter 0"):
    npg.train(4 * 3, seed=0)
