"""The examine command lines (``utils/examine_sim``, ``examine_env``,
``examine_logs``, ``examine_reference``): the port against the JAX
modules, float64 on the CPU.

- examine_sim: free10 (no actuators, so the random ctrl is empty on both
  sides) through ``main(argv)``, the port from its ``.npz``, JAX from the
  MJCF: the printed model and state lines are the same (4 decimals);
- examine_env: a pickled ``ActorCritic`` params tree drives JAX's
  ``rollout`` and the port's on hand11 under myoHandPoseFixed-v0's task:
  the traces agree within ``TASK_TOL`` (rtol 1e-8);
- examine_logs: the port's record -> playback round trip is exact; JAX's
  ``playback`` of the port's trace gives the same returns (1e-8) and no
  drift beyond 1e-9;
- examine_reference: ``playback_qpos`` of track17's lift clip equals JAX's
  frames (1e-12); the CLI runs the random and lift ids.
"""
from __future__ import annotations

import contextlib
import io
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (FREE_NPZ, HAND_TARGET, NPZ, TASK_TOL,
                          bare_envs_package, fixture_xml, task_kwargs)
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv
from myosuite_mjx_tpu_torch.envs.track import TrackEnv
from myosuite_mjx_tpu_torch.logger.trace import Trace
from myosuite_mjx_tpu_torch.utils import (examine_env, examine_logs,
                                          examine_reference, examine_sim)

KWARGS = dict(frame_skip=2, horizon=4, normalize_act=True, pose_thd=0.7,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])


def _printed(fn, *args) -> list[str]:
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    fn(*args)
  return buf.getvalue().splitlines()


def test_examine_sim_matches_jax(tmp_path):
  from myosuite_mjx_tpu.utils import examine_sim as jsim
  xml = tmp_path / "free10.xml"
  xml.write_text(fixture_xml("free"))
  argv = ["--horizon", "20", "--seed", "3"]
  mine = _printed(examine_sim.main, ["--model_path", FREE_NPZ,
                                     "--device", "cpu", *argv])
  ref = _printed(jsim.main, ["--model_path", str(xml), *argv])
  assert mine[0] == ref[0] and mine[2] == ref[2], (mine, ref)
  assert mine[1].startswith("stepped 20 x 2 ms")
  out = examine_sim.main(["--model_path", FREE_NPZ, "--device", "cpu",
                          "--ctrl", "zero", "--horizon", "5"])
  assert np.isfinite(out["qpos"]).all() and out["qpos"].shape == (12,)


@pytest.fixture(scope="module")
def pose_envs():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pose import PoseEnv as JPoseEnv
    jenv = JPoseEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
  return jenv, PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)


@pytest.fixture(scope="module")
def params_file(tmp_path_factory, pose_envs):
  """A flax ActorCritic params tree (numpy leaves) of JAX's default width,
  as examine_env's ``--policy_path`` takes it."""
  jenv, penv = pose_envs
  obs_dim = penv.reset(1, "cpu").obs.shape[1]
  with bare_envs_package():
    from myosuite_mjx_tpu.train.ppo import ActorCritic
    net = ActorCritic(act_dim=jenv.model.nu)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, obs_dim), jnp.float64))
  path = tmp_path_factory.mktemp("policy") / "params.pkl"
  with open(path, "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, params), f)
  return str(path)


def test_examine_env_rollout_matches_jax(pose_envs, params_file):
  jenv, penv = pose_envs
  with bare_envs_package():
    from myosuite_mjx_tpu.utils import examine_env as jexam
    jtrace, _ = jexam.rollout(jenv, jexam.params_policy(jenv, params_file),
                              num_episodes=2, seed=0)
  trace = examine_env.rollout(
      penv, examine_env.params_policy(penv, params_file, "cpu"),
      num_episodes=2, seed=0, device="cpu")
  assert sorted(trace.trace) == sorted(jtrace.trace) == ["Trial0", "Trial1"]
  for g in trace.trace:
    assert sorted(trace.trace[g]) == sorted(jtrace.trace[g])
    for k, v in jtrace.trace[g].items():
      np.testing.assert_allclose(trace.trace[g][k], np.asarray(v),
                                 err_msg=f"{g}/{k}", **TASK_TOL)


def test_examine_env_cli_random_policy(tmp_path):
  out = examine_env.main(["-e", "hand11PoseFixed-v0", "-n", "2", "-o",
                          str(tmp_path), "-f", "pickle", "--device", "cpu"])
  trace = Trace.load(out)
  assert sorted(trace.trace) == ["Trial0", "Trial1"]
  acts = trace.trace["Trial0"]["actions"]
  assert acts.shape[1] == 21 and np.abs(acts).max() <= 1.0
  assert trace.trace["Trial0"]["observations"].shape[0] > 1


def test_examine_logs_round_trip_and_jax_playback(pose_envs, tmp_path):
  jenv, penv = pose_envs
  trace = examine_logs.record(penv, horizon=5, num_repeat=3, seed=1,
                              device="cpu")
  path = str(tmp_path / "rollout.h5")
  trace.save(path)
  mine = examine_logs.playback(penv, Trace.load(path), seed=0, device="cpu")
  assert sorted(mine) == ["Trial0", "Trial1", "Trial2"]
  for r in mine.values():
    assert r["obs_err"] == 0.0 and r["qpos_drift"] == 0.0
  with bare_envs_package():
    from myosuite_mjx_tpu.utils import examine_logs as jlogs
    ref = jlogs.playback(jenv, Trace.load(path), seed=0)
  for g, r in ref.items():
    assert mine[g]["ret"] == pytest.approx(r["ret"], rel=1e-8)
    assert r["qpos_drift"] < 1e-9


def test_examine_logs_cli(tmp_path):
  out = examine_logs.main(["-e", "hand11PoseFixed-v0", "-m", "record",
                           "--horizon", "3", "--num_repeat", "2", "-o",
                           str(tmp_path), "-f", "pickle", "--device", "cpu"])
  res = examine_logs.main(["-e", "hand11PoseFixed-v0", "-m", "playback",
                           "-p", out, "--device", "cpu"])
  assert all(r["obs_err"] == 0.0 for r in res.values())
  with pytest.raises(SystemExit):
    examine_logs.main(["-e", "hand11PoseFixed-v0", "-m", "playback"])


def test_examine_reference_matches_jax():
  kw = task_kwargs("track17CubesmallLift-v0")
  with bare_envs_package(), pytest.MonkeyPatch.context() as mp:
    from myosuite_mjx_tpu.envs import track as jtrack
    from myosuite_mjx_tpu.utils import examine_reference as jref
    mp.setattr(jtrack.assets, "object_scene_xml",
               lambda object_name: fixture_xml("track17"))
    jenv = jtrack.TrackEnv(dtype=jnp.float64, **kw)
    horizon = int(jenv.ref.horizon)
    ref = jref.playback_qpos(jenv, horizon)
  from myosuite_mjx_tpu_torch.envs import registry
  penv = TrackEnv(registry._REGISTRY["track17CubesmallLift-v0"][1][
      "model_path"], dtype=torch.float64, **kw)
  mine = examine_reference.playback_qpos(penv, horizon, "cpu")
  np.testing.assert_allclose(mine, ref, rtol=1e-12, atol=1e-12)
  frames = examine_reference.main(["-e", "track17CubesmallRandom-v0",
                                   "--horizon", "4", "--device", "cpu"])
  assert frames.shape == (4, penv.model.nq) and np.isfinite(frames).all()
